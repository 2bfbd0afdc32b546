"""The reference's own reading of a scene's input: OBJ/MTL files -> one
dict of host arrays (float32 triangles, vertex normals,
material ids and a material table).

It follows the MTL/OBJ reading rules of the renderer the port reproduces
(an implicit opaque "Default_123" material at index 0, `d` -> t_r = 1 - d,
Ns clipped to [0, 1e6], Ni to [1, 1000], priority to [-count, count]; a
face without vertex normals, or with one of length below the triangle's
tolerance, takes its geometric normal at all three corners).  Textures are
not read: a scene that names a texture map is refused.  It imports nothing of
the program.
"""

from __future__ import annotations

import pathlib

import numpy as np

MAX_PHONG_N_S = 1.0e6

# newmtl defaults
_DEFAULTS = dict(kd=(0.9, 0.9, 0.9), ks=(0.0, 0.0, 0.0), ke=(0.0, 0.0, 0.0),
                 tf=(1.0, 1.0, 1.0), n_s=0.0, n_i=0.0, t_r=1.0, priority=-1,
                 path_length=0.0)


def read_mtl(path: pathlib.Path) -> dict:
    """Material table of one MTL file, the implicit default first."""
    rows = [dict(_DEFAULTS, t_r=0.0)]
    names = ["Default_123"]
    for raw in path.read_text().splitlines():
        chunks = raw.split()
        if not chunks or chunks[0].startswith("#"):
            continue
        key, row = chunks[0], rows[-1]
        if key == "newmtl":
            names.append(chunks[1])
            rows.append(dict(_DEFAULTS))
        elif key in ("Kd", "Ks", "Ke", "Tf"):
            row[key.lower()] = tuple(float(c) for c in chunks[1:4])
        elif key == "d":
            row["t_r"] = 1.0 - float(np.clip(float(chunks[1]), 0, 1))
        elif key == "Tr":
            row["t_r"] = float(np.clip(float(chunks[1]), 0, 1))
        elif key == "Ns":
            row["n_s"] = float(np.clip(float(chunks[1]), 0, MAX_PHONG_N_S))
        elif key == "Ni":
            row["n_i"] = float(np.clip(float(chunks[1]), 1, 1000))
        elif key == "priority":
            cap = len(names)
            row["priority"] = int(np.clip(int(chunks[1]), -cap, cap))
        elif key == "path_length":
            row["path_length"] = float(chunks[1])
        elif key.startswith("map_"):
            raise ValueError(f"the reference reads no textures ({key} in {path.name})")
    table = {k: np.asarray([r[k] for r in rows], np.float32)
             for k in ("kd", "ks", "ke", "tf", "n_s", "n_i", "t_r", "path_length")}
    table["priority"] = np.asarray([r["priority"] for r in rows], np.int32)
    table["name"] = names
    return table


def read_obj(folder, obj_name: str) -> dict:
    """Triangles of an OBJ file (polygons fanned from their first corner)
    and the material table of its `mtllib`."""
    folder = pathlib.Path(folder)
    lines = (folder / obj_name).read_text().splitlines()
    mtl = next(l.split()[1] for l in lines if l.startswith("mtllib "))
    materials = read_mtl(folder / mtl)
    ids = {n: i for i, n in enumerate(materials["name"])}
    verts, norms, faces, mats = [], [], [], []
    current = 0
    for raw in lines:
        chunks = raw.split()
        if not chunks:
            continue
        if chunks[0] == "usemtl":
            current = ids.get(chunks[1], 0)
        elif chunks[0] == "v":
            verts.append([float(c) for c in chunks[1:4]])
        elif chunks[0] == "vn":
            norms.append([float(c) for c in chunks[1:4]])
        elif chunks[0] == "f":
            refs = []
            for tok in chunks[1:]:
                parts = tok.split("/")
                n = int(parts[2]) - 1 if len(parts) > 2 and parts[2] else -1
                refs.append((int(parts[0]) - 1, n))
            for i in range(len(refs) - 2):
                faces.append((refs[0], refs[1 + i], refs[2 + i]))
                mats.append(current)
    verts = np.asarray(verts, np.float32)
    norms = np.concatenate([np.asarray(norms, np.float32).reshape(-1, 3),
                            np.zeros((1, 3), np.float32)])  # row -1: absent
    vidx = np.asarray([[c[0] for c in f] for f in faces], np.int64)
    nidx = np.asarray([[c[1] for c in f] for f in faces], np.int64)
    tri_p = verts[vidx]
    tri_n = norms[nidx]
    geom = np.cross(tri_p[:, 1] - tri_p[:, 0], tri_p[:, 2] - tri_p[:, 0])
    with np.errstate(divide="ignore", invalid="ignore"):
        geom = geom / np.linalg.norm(geom, axis=-1, keepdims=True)
        n_len = np.linalg.norm(tri_n, axis=-1)
        n_unit = tri_n / n_len[..., None]
    edge = np.minimum(np.minimum(np.linalg.norm(tri_p[:, 0] - tri_p[:, 1], axis=-1),
                                 np.linalg.norm(tri_p[:, 0] - tri_p[:, 2], axis=-1)),
                      np.linalg.norm(tri_p[:, 1] - tri_p[:, 2], axis=-1))
    tol = np.minimum(1e-5, edge / 100.0)
    flat = (n_len < tol[:, None]).any(axis=1)
    tri_n = np.where(flat[:, None, None], geom[:, None, :], np.nan_to_num(n_unit))
    return dict(tri_p=tri_p.astype(np.float32), tri_n=tri_n.astype(np.float32),
                mat_idx=np.asarray(mats, np.int32), materials=materials)


def read_scene(inputs: dict) -> dict:
    """The scene dict of a scene module's `make` output."""
    if inputs["kind"] == "obj":
        return read_obj(inputs["folder"], inputs["obj"])
    raise ValueError(f"unknown scene input kind {inputs['kind']!r}")
