"""OBJ / MTL scene loading into structure-of-arrays numpy buffers.

Re-derivation of the reference's host-side parsers
(`src/input/read_file_util.h`, `src/input/read_image_util.h`): two-pass OBJ
scan with fan triangulation and `usemtl` object segmentation, MTL parsing
with the reference's custom extensions (`path_length`, `scattering_coef`,
`absorption_coef`, `g`, `priority`), and a packed global texture atlas whose
slot 0 is a 1x1 white default.

Everything here is host code producing flat numpy arrays; the device-side
scene (`models/scene.py`) is built from these.  A native C++ fast path for
large OBJ files lives in `csrc/` (loaded via ctypes when built).
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from gpu_pathtracer_tpu_torch.constants import MAX_PHONG_N_S

# Material-table default values (read_file_util.h:302-359: newmtl defaults).
_MTL_DEFAULTS = dict(
    ka=(0.0, 0.0, 0.0),
    kd=(0.9, 0.9, 0.9),
    ks=(0.0, 0.0, 0.0),
    ke=(0.0, 0.0, 0.0),
    tf=(1.0, 1.0, 1.0),
    path_length=0.0,
    n_s=0.0,
    n_i=0.0,
    t_r=1.0,
    bm=1.0,
    scattering_coef=0.0,
    absorption_coef=0.0,
    g=0.0,
    priority=-1,
)

_TEX_CHANNELS = ("diffuse", "specular", "emission", "n_s", "bump")


@dataclasses.dataclass
class TextureAtlas:
    """One packed RGB atlas; per-image (offset, height, width) records.

    Matches the reference's single global float R/G/B texture arrays
    (read_image_util.h:99-178).  Offset indexes pixels, not floats.
    """

    rgb: np.ndarray  # (total_pixels, 3) float32
    names: list[str]
    offsets: np.ndarray  # (num_images,) int32
    heights: np.ndarray
    widths: np.ndarray

    @staticmethod
    def build(folder: str | pathlib.Path, filenames: list[str]) -> "TextureAtlas":
        """Pack slot 0 = 1x1 white plus each image, rows flipped bottom-up
        (read_image_util.h:47-72 reverses row order), values / 255."""
        chunks = [np.ones((1, 3), np.float32)]
        names = ["__white__"]
        offsets = [0]
        heights = [1]
        widths = [1]
        cursor = 1
        for fn in filenames:
            if fn in names:
                continue
            img = _load_image_rgb(pathlib.Path(folder) / fn)
            img = img[::-1]  # bottom-up row order like the reference decoder
            h, w = img.shape[:2]
            names.append(fn)
            offsets.append(cursor)
            heights.append(h)
            widths.append(w)
            chunks.append(img.reshape(-1, 3).astype(np.float32))
            cursor += h * w
        return TextureAtlas(
            rgb=np.concatenate(chunks, axis=0),
            names=names,
            offsets=np.asarray(offsets, np.int32),
            heights=np.asarray(heights, np.int32),
            widths=np.asarray(widths, np.int32),
        )

    def slot(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            return 0


def _load_image_rgb(path: pathlib.Path) -> np.ndarray:
    if path.suffix.lower() in (".jpg", ".jpeg"):
        from gpu_pathtracer_tpu_torch.utils import native

        img = native.decode_jpeg_native(path)
        if img is not None:
            return img
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


@dataclasses.dataclass
class HostMaterials:
    """SoA material table (reference Material fields, material.h:41-114)."""

    name: list[str]
    ka: np.ndarray  # (M, 3)
    kd: np.ndarray
    ks: np.ndarray
    ke: np.ndarray
    tf: np.ndarray
    path_length: np.ndarray  # (M,)
    t_r: np.ndarray
    n_s: np.ndarray
    n_i: np.ndarray
    bm: np.ndarray
    scattering_coef: np.ndarray
    absorption_coef: np.ndarray
    g: np.ndarray
    priority: np.ndarray  # (M,) int32
    # per-channel texture slot index into the atlas: (M, 5) for
    # (diffuse, specular, emission, n_s, bump)
    tex_slot: np.ndarray

    @property
    def num(self) -> int:
        return len(self.name)


@dataclasses.dataclass
class HostScene:
    """Flat SoA scene ready to ship to device."""

    tri_p: np.ndarray  # (N, 3, 3) vertex positions
    tri_n: np.ndarray  # (N, 3, 3) vertex normals (zeros if absent)
    tri_uv: np.ndarray  # (N, 3, 2) texture coords
    tri_tangent: np.ndarray  # (N, 3, 3) per-vertex tangents (NaN if degenerate)
    mat_idx: np.ndarray  # (N,) int32
    object_idx: np.ndarray  # (N,) int32
    num_objects: int
    materials: HostMaterials
    atlas: TextureAtlas


def parse_mtl(
    folder: str | pathlib.Path,
    mtl_filenames: list[str],
    atlas: TextureAtlas,
) -> HostMaterials:
    """Parse MTL files (read_file_util.h:202-472).

    Injects the reference's implicit default material at index 0
    ("Default_123": kd=0.9 grey, opaque) and applies the reference's
    per-key clamps (d/Tr -> t_r in [0,1], Ns in [0, MAX], Ni in [1, 1000],
    priority in [-count, count]).
    """
    rows: list[dict] = []
    names: list[str] = []

    def new_row(defaults_tr_zero=False):
        row = {k: (list(v) if isinstance(v, tuple) else v) for k, v in _MTL_DEFAULTS.items()}
        row["tex"] = {c: 0 for c in _TEX_CHANNELS}
        if defaults_tr_zero:
            # the injected default material is opaque and non-scattering
            row["t_r"] = 0.0
            row["scattering_coef"] = -1.0
            row["absorption_coef"] = -1.0
        return row

    names.append("Default_123")
    rows.append(new_row(defaults_tr_zero=True))

    for mtl_fn in mtl_filenames:
        path = pathlib.Path(folder) / mtl_fn
        if not path.exists():
            continue
        for raw in path.read_text(errors="replace").splitlines():
            line = " ".join(raw.split())
            if not line or line.startswith("#"):
                continue
            chunks = line.split(" ")
            key = chunks[0]
            row = rows[-1]
            if key == "newmtl":
                names.append(chunks[1])
                rows.append(new_row())
            elif key in ("Ka", "Kd", "Ks", "Ke", "Tf"):
                row[key.lower()] = [float(c) for c in chunks[1:4]]
            elif key == "path_length":
                row["path_length"] = float(chunks[1])
            elif key == "d":
                row["t_r"] = 1.0 - float(np.clip(float(chunks[1]), 0, 1))
            elif key == "Tr":
                row["t_r"] = float(np.clip(float(chunks[1]), 0, 1))
            elif key == "Ns":
                row["n_s"] = float(np.clip(float(chunks[1]), 0, MAX_PHONG_N_S))
            elif key == "Ni":
                row["n_i"] = float(np.clip(float(chunks[1]), 1, 1000))
            elif key == "scattering_coef":
                row["scattering_coef"] = float(chunks[1])
            elif key == "absorption_coef":
                row["absorption_coef"] = float(chunks[1])
            elif key == "g":
                row["g"] = float(chunks[1])
            elif key == "priority":
                cap = len(names)
                row["priority"] = int(np.clip(int(chunks[1]), -cap, cap))
            elif key == "map_Kd":
                row["tex"]["diffuse"] = atlas.slot(chunks[1])
            elif key == "map_Ks":
                row["tex"]["specular"] = atlas.slot(chunks[1])
            elif key == "map_Ke":
                row["tex"]["emission"] = atlas.slot(chunks[1])
            elif key == "map_Ns":
                row["tex"]["n_s"] = atlas.slot(chunks[1])
            elif key == "map_Bump":
                # optional "-bm <mult>" pairs; filename is the last token
                # (read_file_util.h:448-464)
                for i in range(1, len(chunks) - 1, 2):
                    if chunks[i] == "-bm":
                        row["bm"] = float(chunks[i + 1])
                row["tex"]["bump"] = atlas.slot(chunks[-1])

    def col(k):
        return np.asarray([r[k] for r in rows], np.float32)

    return HostMaterials(
        name=names,
        ka=col("ka"),
        kd=col("kd"),
        ks=col("ks"),
        ke=col("ke"),
        tf=col("tf"),
        path_length=col("path_length"),
        t_r=col("t_r"),
        n_s=col("n_s"),
        n_i=col("n_i"),
        bm=col("bm"),
        scattering_coef=col("scattering_coef"),
        absorption_coef=col("absorption_coef"),
        g=col("g"),
        priority=np.asarray([r["priority"] for r in rows], np.int32),
        tex_slot=np.asarray(
            [[r["tex"][c] for c in _TEX_CHANNELS] for r in rows], np.int32
        ),
    )


def collect_mtllib_and_textures(
    folder: str | pathlib.Path, obj_filename: str
) -> tuple[list[str], list[str]]:
    """Scan the OBJ for mtllib lines, then the MTLs for map_* filenames
    (read_file_util.h:168-200, read_image_util.h:99-140)."""
    mtls: list[str] = []
    obj_path = pathlib.Path(folder) / obj_filename
    for raw in obj_path.read_text(errors="replace").splitlines():
        chunks = " ".join(raw.split()).split(" ")
        if chunks and chunks[0] == "mtllib":
            for fn in chunks[1:]:
                if fn not in mtls:
                    mtls.append(fn)
    textures: list[str] = []
    for mtl_fn in mtls:
        path = pathlib.Path(folder) / mtl_fn
        if not path.exists():
            continue
        for raw in path.read_text(errors="replace").splitlines():
            chunks = " ".join(raw.split()).split(" ")
            if not chunks:
                continue
            if chunks[0] in ("map_Kd", "map_Ks", "map_Ke", "map_Ns"):
                if chunks[1] not in textures:
                    textures.append(chunks[1])
            elif chunks[0] == "map_Bump":
                fn = chunks[-1]
                if fn not in textures:
                    textures.append(fn)
    return mtls, textures


def parse_obj(
    folder: str | pathlib.Path,
    obj_filename: str,
    materials: HostMaterials,
) -> tuple[np.ndarray, ...]:
    """Parse geometry (read_file_util.h:536-655).

    Fan-triangulates polygons; `usemtl` starts a new object group; missing
    vt/vn indices resolve to a zero entry at index 0.  Returns
    (tri_vidx, tri_tidx, tri_nidx, mat_idx, object_idx, verts, uvs, norms).

    Uses the native C++ tokenizer (csrc/obj_parser.cpp) when built; the
    Python path below is the fallback and oracle.
    """
    from gpu_pathtracer_tpu_torch.utils import native

    path = pathlib.Path(folder) / obj_filename
    raw = native.parse_obj_native(path, materials.name)
    if raw is None:
        raw = _parse_obj_python(path, materials)
    tri_vidx, tri_tidx, tri_nidx, mat_idx, object_idx, verts, uvs, norms = raw

    # slot for "absent" vt/vn: a zero row appended at the end; -1 remaps to it
    norms = np.concatenate([norms, np.zeros((1, 3), np.float32)])
    uvs = np.concatenate([uvs, np.zeros((1, 2), np.float32)])
    tri_tidx = np.where(tri_tidx < 0, len(uvs) - 1, tri_tidx).astype(np.int32)
    tri_nidx = np.where(tri_nidx < 0, len(norms) - 1, tri_nidx).astype(np.int32)
    return (
        tri_vidx.astype(np.int32),
        tri_tidx,
        tri_nidx,
        mat_idx.astype(np.int32),
        object_idx.astype(np.int32),
        verts.astype(np.float32),
        uvs.astype(np.float32),
        norms.astype(np.float32),
    )


def _parse_obj_python(
    path: pathlib.Path, materials: HostMaterials
) -> tuple[np.ndarray, ...]:
    """Pure-Python OBJ tokenizer (same raw contract as the native parser:
    absent vt/vn indices are -1; no fallback rows appended)."""
    verts: list[list[float]] = []
    uvs: list[list[float]] = []
    norms: list[list[float]] = []
    tri_vidx: list[list[int]] = []
    tri_tidx: list[list[int]] = []
    tri_nidx: list[list[int]] = []
    mat_idx: list[int] = []
    object_idx: list[int] = []
    current_mat = 0
    cur_object = -1

    name_to_idx = {n: i for i, n in enumerate(materials.name)}
    for raw in path.read_text(errors="replace").splitlines():
        line = " ".join(raw.split())
        if not line:
            continue
        chunks = line.split(" ")
        key = chunks[0]
        if key == "usemtl":
            if materials.num > 1:
                current_mat = name_to_idx.get(chunks[1], 0)
            else:
                current_mat = 0
            cur_object += 1
        elif key == "v":
            verts.append([float(c) for c in chunks[1:4]])
        elif key == "vt":
            uvs.append([float(c) for c in chunks[1:3]])
        elif key == "vn":
            norms.append([float(c) for c in chunks[1:4]])
        elif key == "f":
            def split_ref(tok):
                parts = tok.split("/")
                v = int(parts[0]) - 1
                t = int(parts[1]) - 1 if len(parts) > 1 and parts[1] else -1
                n = int(parts[2]) - 1 if len(parts) > 2 and parts[2] else -1
                return v, t, n

            refs = [split_ref(tok) for tok in chunks[1:]]
            for i in range(len(refs) - 2):
                a, b, c = refs[0], refs[1 + i], refs[2 + i]
                tri_vidx.append([a[0], b[0], c[0]])
                # Reference maps absent vt/vn to slot 0 (read_file_util.h:
                # 614-628), which aliases a real entry when a *later* object
                # does carry vt/vn.  We instead encode "absent" as -1 so the
                # scene build can apply the geometric-normal / zero-uv
                # fallback — matching the reference on all-or-nothing scenes
                # and fixing its aliasing bug on mixed ones.
                tri_tidx.append([a[1], b[1], c[1]])
                tri_nidx.append([a[2], b[2], c[2]])
                mat_idx.append(current_mat)
                object_idx.append(max(cur_object, 0))

    return (
        np.asarray(tri_vidx, np.int32).reshape(-1, 3),
        np.asarray(tri_tidx, np.int32).reshape(-1, 3),
        np.asarray(tri_nidx, np.int32).reshape(-1, 3),
        np.asarray(mat_idx, np.int32),
        np.asarray(object_idx, np.int32),
        np.asarray(verts, np.float32).reshape(-1, 3),
        np.asarray(uvs, np.float32).reshape(-1, 2),
        np.asarray(norms, np.float32).reshape(-1, 3),
    )


def _compute_vertex_tangents(
    tri_vidx: np.ndarray,
    tri_p: np.ndarray,
    tri_uv: np.ndarray,
    tri_n: np.ndarray,
    num_verts: int,
) -> np.ndarray:
    """Per-vertex tangent accumulation + Gram-Schmidt.

    Vectorized version of the reference's serial tangent kernels
    (triangle_operations.h:34-61 accumulate, triangle.h:160-172 assign):
    per-face (t, b) from the uv parameterization, summed per shared vertex
    index, then orthogonalized against each vertex normal.  Degenerate uv
    parameterizations yield NaN tangents, which downstream shading treats as
    "fall back to the default ONB" exactly like the reference
    (triangle.h:427-431).
    """
    e1 = tri_p[:, 1] - tri_p[:, 0]
    e2 = tri_p[:, 2] - tri_p[:, 0]
    x1 = tri_uv[:, 1, 0] - tri_uv[:, 0, 0]
    x2 = tri_uv[:, 2, 0] - tri_uv[:, 0, 0]
    y1 = tri_uv[:, 1, 1] - tri_uv[:, 0, 1]
    y2 = tri_uv[:, 2, 1] - tri_uv[:, 0, 1]
    denom = x1 * y2 - x2 * y1
    with np.errstate(divide="ignore", invalid="ignore"):
        r = 1.0 / denom
        t_face = (e1 * y2[:, None] - e2 * y1[:, None]) * r[:, None]

    acc = np.zeros((num_verts, 3), np.float64)
    finite = np.isfinite(t_face).all(axis=1)
    for corner in range(3):
        np.add.at(acc, tri_vidx[finite, corner], t_face[finite])

    t_vert = acc[tri_vidx]  # (N, 3, 3)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_vert = t_vert / np.linalg.norm(t_vert, axis=-1, keepdims=True)
        proj = np.sum(tri_n * t_vert, axis=-1, keepdims=True)
        t_orth = t_vert - proj * tri_n
        t_orth = t_orth / np.linalg.norm(t_orth, axis=-1, keepdims=True)
    return t_orth.astype(np.float32)


def load_scene(folder: str | pathlib.Path, obj_filename: str) -> HostScene:
    """Full host-side scene build: MTL + textures + OBJ -> flat SoA."""
    mtls, tex_names = collect_mtllib_and_textures(folder, obj_filename)
    atlas = TextureAtlas.build(folder, tex_names)
    materials = parse_mtl(folder, mtls, atlas)
    (tri_vidx, tri_tidx, tri_nidx, mat_idx, object_idx,
     verts, uvs_arr, norms_arr) = parse_obj(folder, obj_filename, materials)

    tri_p = verts[tri_vidx]  # (N, 3, 3)
    tri_uv = uvs_arr[tri_tidx]  # (N, 3, 2)
    tri_n = norms_arr[tri_nidx]  # (N, 3, 3)

    # Reference: if any vertex normal is ~zero, use the geometric normal for
    # all three corners (triangle.h:292-300).
    geom_n = np.cross(tri_p[:, 1] - tri_p[:, 0], tri_p[:, 2] - tri_p[:, 0])
    with np.errstate(divide="ignore", invalid="ignore"):
        geom_n = geom_n / np.linalg.norm(geom_n, axis=-1, keepdims=True)
        norm_len = np.linalg.norm(tri_n, axis=-1)
        tri_n_unit = tri_n / np.linalg.norm(tri_n, axis=-1, keepdims=True)
    edge = np.minimum(
        np.minimum(
            np.linalg.norm(tri_p[:, 0] - tri_p[:, 1], axis=-1),
            np.linalg.norm(tri_p[:, 0] - tri_p[:, 2], axis=-1),
        ),
        np.linalg.norm(tri_p[:, 1] - tri_p[:, 2], axis=-1),
    )
    tol = np.minimum(1e-5, edge / 100.0)
    any_zero = (norm_len < tol[:, None]).any(axis=1)
    tri_n_final = np.where(
        any_zero[:, None, None], geom_n[:, None, :], np.nan_to_num(tri_n_unit)
    ).astype(np.float32)

    tangents = _compute_vertex_tangents(
        tri_vidx, tri_p, tri_uv, tri_n_final, len(verts)
    )

    return HostScene(
        tri_p=tri_p.astype(np.float32),
        tri_n=tri_n_final,
        tri_uv=tri_uv.astype(np.float32),
        tri_tangent=tangents,
        mat_idx=mat_idx,
        object_idx=object_idx,
        num_objects=int(object_idx.max()) + 1 if len(object_idx) else 0,
        materials=materials,
        atlas=atlas,
    )
