"""Procedural test scenes written as OBJ/MTL files.

The reference repo ships no scene assets, so benchmark configs
(BASELINE.json: Cornell-box spheres, glass+DoF, fog, neon-sign SPPM) are
synthesized here as valid OBJ/MTL inputs for the full I/O pipeline.
"""

from __future__ import annotations

import math
import pathlib


def _icosphere(center, radius, subdiv=2):
    """Vertices/faces of a subdivided icosahedron."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = [
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
    ]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]

    def norm(v):
        l = math.sqrt(sum(c * c for c in v))
        return tuple(c / l for c in v)

    verts = [norm(v) for v in verts]
    cache = {}

    def midpoint(i, j):
        key = (min(i, j), max(i, j))
        if key not in cache:
            a, b = verts[i], verts[j]
            m = norm(tuple((a[k] + b[k]) / 2 for k in range(3)))
            verts.append(m)
            cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdiv):
        new_faces = []
        for (a, b, c) in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces

    world_verts = [
        (center[0] + radius * v[0], center[1] + radius * v[1], center[2] + radius * v[2])
        for v in verts
    ]
    normals = verts
    return world_verts, normals, faces


def _quad(obj_lines, base, p1, p2, p3, p4, flip=False):
    """Two triangles for a quad (returns next vertex base)."""
    for p in (p1, p2, p3, p4):
        obj_lines.append(f"v {p[0]} {p[1]} {p[2]}")
    a, b, c, d = base + 1, base + 2, base + 3, base + 4
    if flip:
        obj_lines.append(f"f {a} {c} {b}")
        obj_lines.append(f"f {a} {d} {c}")
    else:
        obj_lines.append(f"f {a} {b} {c}")
        obj_lines.append(f"f {a} {c} {d}")
    return base + 4


def make_cornell_box(
    folder: str | pathlib.Path,
    spheres: bool = True,
    sphere_subdiv: int = 1,
    glass_priority: bool = False,
    fog: bool = False,
) -> tuple[str, str]:
    """Cornell box with optional diffuse/metal/glass spheres.

    Box spans [0,1]^3, opening towards +z; light quad near the ceiling.
    Returns (obj_filename, mtl_filename) inside `folder`.
    """
    folder = pathlib.Path(folder)
    folder.mkdir(parents=True, exist_ok=True)

    mtl = [
        "newmtl white", "Kd 0.73 0.73 0.73", "Ks 0 0 0", "d 1.0", "Ns 1",
        "newmtl red", "Kd 0.65 0.05 0.05", "Ks 0 0 0", "d 1.0", "Ns 1",
        "newmtl green", "Kd 0.12 0.45 0.15", "Ks 0 0 0", "d 1.0", "Ns 1",
        "newmtl light", "Kd 0 0 0", "Ke 15 15 15", "d 1.0", "Ns 1",
        "newmtl metal", "Kd 0.05 0.05 0.05", "Ks 0.9 0.9 0.9", "Ns 1000", "d 1.0",
        "newmtl glass", "Kd 0 0 0", "Ks 0 0 0", "Ns 1000000", "Ni 1.5",
        "Tf 1 1 1", "d 0.0",
    ]
    if glass_priority:
        mtl.append("priority 1")
    if fog:
        mtl += [
            "newmtl fog", "Kd 0 0 0", "Ns 1000000", "Ni 1.0", "Tf 1 1 1",
            "d 0.0", "scattering_coef 0.5", "absorption_coef 0.1", "g 0.0",
            "priority 2",
        ]

    # windings chosen so geometric normals face the box interior
    obj = ["mtllib box.mtl"]
    base = 0
    obj.append("usemtl white")  # floor (normal +y)
    base = _quad(obj, base, (0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 0, 0))
    obj.append("usemtl white")  # ceiling (normal -y)
    base = _quad(obj, base, (0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1))
    obj.append("usemtl white")  # back wall z=0 (normal +z)
    base = _quad(obj, base, (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))
    obj.append("usemtl red")  # left wall x=0 (normal +x)
    base = _quad(obj, base, (0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1))
    obj.append("usemtl green")  # right wall x=1 (normal -x)
    base = _quad(obj, base, (1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0))
    obj.append("usemtl light")  # light quad just below ceiling (normal -y)
    base = _quad(
        obj, base, (0.35, 0.999, 0.35), (0.65, 0.999, 0.35),
        (0.65, 0.999, 0.65), (0.35, 0.999, 0.65),
    )

    def add_sphere(center, radius, material):
        nonlocal base
        verts, normals, faces = _icosphere(center, radius, sphere_subdiv)
        obj.append(f"usemtl {material}")
        for v in verts:
            obj.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")
        for n in normals:
            obj.append(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}")
        nbase = sum(1 for l in obj if l.startswith("vn ")) - len(normals)
        for (a, b, c) in faces:
            obj.append(
                f"f {base + a + 1}//{nbase + a + 1} "
                f"{base + b + 1}//{nbase + b + 1} "
                f"{base + c + 1}//{nbase + c + 1}"
            )
        base += len(verts)

    if spheres:
        add_sphere((0.3, 0.2, 0.4), 0.2, "white")
        add_sphere((0.72, 0.18, 0.6), 0.18, "metal")
        add_sphere((0.5, 0.15, 0.75), 0.15, "glass")
    if fog:
        add_sphere((0.5, 0.5, 0.5), 0.45, "fog")

    (folder / "box.mtl").write_text("\n".join(mtl) + "\n")
    (folder / "box.obj").write_text("\n".join(obj) + "\n")
    return "box.obj", "box.mtl"


def make_neon_sign(
    folder: str | pathlib.Path,
    segs_per_tube: int = 24,
    tube_width: float = 0.02,
    emission: float = 25.0,
) -> tuple[str, str]:
    """Neon-sign scene (BASELINE config 5): a Cornell-style box whose ONLY
    lights are thin emissive tube segments spelling "TPU" on the back wall —
    many small colored emitters, the many-lights + SPPM + differentiable
    emitter-optimization workload.

    Emitter triangle count = 2 * 3 * segs_per_tube (two tris per segment).
    Returns (obj_filename, mtl_filename).
    """
    folder = pathlib.Path(folder)
    folder.mkdir(parents=True, exist_ok=True)

    # neon tubes carry a small Kd so the direct-radiance chain records their
    # emission (diffuse hits only, ray_tracing_pass.h:112-118; kd=ks=0 pure
    # emitters fall into the specular 0/0 branch, material.h:598-602)
    e = emission
    mtl = [
        "newmtl white", "Kd 0.73 0.73 0.73", "Ks 0 0 0", "d 1.0", "Ns 1",
        "newmtl neon_r", "Kd 0.6 0.1 0.15", f"Ke {e} {e * 0.12} {e * 0.2}",
        "d 1.0", "Ns 1",
        "newmtl neon_g", "Kd 0.1 0.6 0.2", f"Ke {e * 0.15} {e} {e * 0.3}",
        "d 1.0", "Ns 1",
        "newmtl neon_b", "Kd 0.15 0.25 0.6", f"Ke {e * 0.2} {e * 0.4} {e}",
        "d 1.0", "Ns 1",
    ]

    obj = ["mtllib sign.mtl"]
    base = 0
    obj.append("usemtl white")  # floor / ceiling / back / side walls
    base = _quad(obj, base, (0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 0, 0))
    base = _quad(obj, base, (0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1))
    base = _quad(obj, base, (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))
    base = _quad(obj, base, (0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1))
    base = _quad(obj, base, (1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0))

    # letter strokes as 2-D polylines on the z=0.05 plane
    letters = {
        "neon_r": [[(0.08, 0.72), (0.32, 0.72)], [(0.20, 0.72), (0.20, 0.30)]],
        "neon_g": [[(0.42, 0.30), (0.42, 0.72), (0.58, 0.72), (0.58, 0.52),
                    (0.42, 0.52)]],
        "neon_b": [[(0.68, 0.72), (0.68, 0.36), (0.73, 0.30), (0.87, 0.30),
                    (0.92, 0.36), (0.92, 0.72)]],
    }
    z = 0.05
    hw = tube_width / 2.0
    for mat, strokes in letters.items():
        # distribute segs_per_tube segments over the letter's strokes by length
        pts_all = []
        for stroke in strokes:
            lens = [
                math.dist(stroke[i], stroke[i + 1])
                for i in range(len(stroke) - 1)
            ]
            total = sum(lens)
            for i, l in enumerate(lens):
                n = max(1, round(segs_per_tube * l / total))
                a, b = stroke[i], stroke[i + 1]
                for k in range(n):
                    t0, t1 = k / n, (k + 1) / n
                    pts_all.append((
                        (a[0] + (b[0] - a[0]) * t0, a[1] + (b[1] - a[1]) * t0),
                        (a[0] + (b[0] - a[0]) * t1, a[1] + (b[1] - a[1]) * t1),
                    ))
        obj.append(f"usemtl {mat}")
        for (p0, p1) in pts_all:
            dx, dy = p1[0] - p0[0], p1[1] - p0[1]
            l = math.hypot(dx, dy) or 1.0
            px, py = -dy / l * hw, dx / l * hw  # in-plane perpendicular
            base = _quad(
                obj, base,
                (p0[0] - px, p0[1] - py, z), (p1[0] - px, p1[1] - py, z),
                (p1[0] + px, p1[1] + py, z), (p0[0] + px, p0[1] + py, z),
            )

    (folder / "sign.mtl").write_text("\n".join(mtl) + "\n")
    (folder / "sign.obj").write_text("\n".join(obj) + "\n")
    return "sign.obj", "sign.mtl"


def make_emitter_panel(
    folder: str | pathlib.Path,
    nx: int = 16,
    ny: int = 16,
    emission: float = 15.0,
) -> tuple[str, str]:
    """Cornell-style box whose ceiling is a grid of nx*ny SEPARATE emissive
    quads (2*nx*ny emitter triangles) — the many-lights scalability stress
    (exercises the sparse light-tree path once 2*nx*ny > LIGHT_TREE_DENSE_MAX).
    """
    folder = pathlib.Path(folder)
    folder.mkdir(parents=True, exist_ok=True)

    mtl = [
        "newmtl white", "Kd 0.73 0.73 0.73", "Ks 0 0 0", "d 1.0", "Ns 1",
        "newmtl led", "Kd 0 0 0", f"Ke {emission} {emission} {emission}",
        "d 1.0", "Ns 1",
    ]
    obj = ["mtllib panel.mtl"]
    base = 0
    obj.append("usemtl white")
    base = _quad(obj, base, (0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 0, 0))
    base = _quad(obj, base, (0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1))
    base = _quad(obj, base, (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))
    base = _quad(obj, base, (0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1))
    base = _quad(obj, base, (1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0))

    obj.append("usemtl led")
    y = 0.999
    margin = 0.08
    cell_x = (1.0 - 2 * margin) / nx
    cell_z = (1.0 - 2 * margin) / ny
    shrink = 0.35  # gap between LEDs
    for i in range(nx):
        for j in range(ny):
            x0 = margin + i * cell_x + cell_x * shrink / 2
            z0 = margin + j * cell_z + cell_z * shrink / 2
            x1 = x0 + cell_x * (1 - shrink)
            z1 = z0 + cell_z * (1 - shrink)
            # winding -> normal -y (down into the box)
            base = _quad(
                obj, base, (x0, y, z0), (x1, y, z0), (x1, y, z1), (x0, y, z1)
            )

    (folder / "panel.mtl").write_text("\n".join(mtl) + "\n")
    (folder / "panel.obj").write_text("\n".join(obj) + "\n")
    return "panel.obj", "panel.mtl"


def make_mesh_scene_host(subdiv: int = 7, displace: float = 0.12):
    """Large-mesh scene as a ready HostScene (BASELINE config 2 analog at
    stress scale): a displaced icosphere with 20 * 4^subdiv triangles
    (subdiv=7 -> 327,680) over a ground plane, lit by an emissive quad.

    Built directly as numpy SoA — the OBJ round-trip at 300k faces is pure
    I/O overhead for a procedural stress scene.  Exercises the
    double-buffered closest-hit kernel above PALLAS_MAX.
    """
    import numpy as np

    from gpu_pathtracer_tpu_torch.utils.obj_io import (
        HostMaterials,
        HostScene,
        TextureAtlas,
    )

    # icosahedron faces as (F, 3, 3) vertex positions, unit sphere
    t = (1.0 + math.sqrt(5.0)) / 2.0
    v = np.array(
        [
            (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
            (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
            (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
        ],
        np.float64,
    )
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    f = np.array(
        [
            (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
            (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
            (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
            (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
        ]
    )
    tri = v[f]  # (20, 3, 3)

    def norm(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    for _ in range(subdiv):  # vectorized 1->4 split (vertices duplicated)
        a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
        ab, bc, ca = norm(a + b), norm(b + c), norm(c + a)
        tri = np.concatenate(
            [
                np.stack([a, ab, ca], axis=1),
                np.stack([b, bc, ab], axis=1),
                np.stack([c, ca, bc], axis=1),
                np.stack([ab, bc, ca], axis=1),
            ]
        )

    # smooth displacement field (sum of sines) along the sphere normal
    n = tri  # unit normals == positions on the unit sphere
    disp = (
        np.sin(7.0 * n[..., 0])
        + np.sin(9.0 * n[..., 1] + 1.3)
        + np.sin(11.0 * n[..., 2] + 2.1)
    ) * (displace / 3.0)
    pos = n * (1.0 + disp)[..., None]
    pos = pos * 0.35
    pos[..., 1] += 0.45
    pos[..., 0] += 0.5
    pos[..., 2] += 0.5

    f_count = tri.shape[0]
    tri_p = [pos.astype(np.float32)]
    tri_n = [n.astype(np.float32)]
    # equirect uv from the sphere normal
    uv = np.stack(
        [
            0.5 + np.arctan2(n[..., 2], n[..., 0]) / (2 * np.pi),
            0.5 - np.arcsin(np.clip(n[..., 1], -1, 1)) / np.pi,
        ],
        axis=-1,
    )
    tri_uv = [uv.astype(np.float32)]
    mat_idx = [np.full((f_count,), 1, np.int32)]
    obj_idx = [np.zeros((f_count,), np.int32)]

    def add_quad(p1, p2, p3, p4, nrm, mat, obj):
        quad = np.array([[p1, p2, p3], [p1, p3, p4]], np.float32)
        tri_p.append(quad)
        tri_n.append(np.tile(np.asarray(nrm, np.float32), (2, 3, 1)))
        tri_uv.append(np.zeros((2, 3, 2), np.float32))
        mat_idx.append(np.full((2,), mat, np.int32))
        obj_idx.append(np.full((2,), obj, np.int32))

    add_quad((-3, 0, -3), (-3, 0, 3), (3, 0, 3), (3, 0, -3), (0, 1, 0), 1, 1)
    add_quad(
        (0.2, 1.6, 0.2), (0.8, 1.6, 0.2), (0.8, 1.6, 0.8), (0.2, 1.6, 0.8),
        (0, -1, 0), 2, 2,
    )

    tri_p = np.concatenate(tri_p)
    total = tri_p.shape[0]
    mats = HostMaterials(
        name=["Default_123", "white", "light"],
        ka=np.zeros((3, 3), np.float32),
        kd=np.array([[0.9, 0.9, 0.9], [0.73, 0.73, 0.73], [0.0, 0.0, 0.0]],
                    np.float32),
        ks=np.zeros((3, 3), np.float32),
        ke=np.array([[0, 0, 0], [0, 0, 0], [15, 15, 15]], np.float32),
        tf=np.zeros((3, 3), np.float32),
        path_length=np.zeros((3,), np.float32),
        t_r=np.zeros((3,), np.float32),
        n_s=np.ones((3,), np.float32),
        n_i=np.ones((3,), np.float32),
        bm=np.ones((3,), np.float32),
        scattering_coef=np.zeros((3,), np.float32),
        absorption_coef=np.zeros((3,), np.float32),
        g=np.zeros((3,), np.float32),
        priority=np.zeros((3,), np.int32),
        tex_slot=np.zeros((3, 5), np.int32),
    )
    atlas = TextureAtlas(
        rgb=np.ones((1, 3), np.float32),
        names=["__white__"],
        offsets=np.zeros((1,), np.int32),
        heights=np.ones((1,), np.int32),
        widths=np.ones((1,), np.int32),
    )
    return HostScene(
        tri_p=tri_p,
        tri_n=np.concatenate(tri_n),
        tri_uv=np.concatenate(tri_uv),
        tri_tangent=np.full((total, 3, 3), np.nan, np.float32),
        mat_idx=np.concatenate(mat_idx),
        object_idx=np.concatenate(obj_idx),
        num_objects=3,
        materials=mats,
        atlas=atlas,
    )


def cornell_master_file(
    folder: str | pathlib.Path,
    width: int = 256,
    height: int = 256,
    spp: int = 64,
    level: int = 8,
    render_mode: int = 1,
    hittable_pdf_weight: float = 0.5,
    aperture: float = 0.0,
) -> pathlib.Path:
    """Write a reference-format master file for the Cornell scene."""
    folder = pathlib.Path(folder)
    lines = [
        f"input_folder_path\t{folder}/",
        "obj_filename\tbox.obj",
        f"image_output_path\t{folder}/out.ppm",
        f"image_width\t{width}",
        f"image_height\t{height}",
        f"render_mode\t{render_mode}",
        f"pathtracing_sample_size\t{spp}",
        f"pathtracing_level\t{level}",
        "dof_sample_size\t4",
        f"aperture\t{aperture}",
        "focus_dist\t2.1",
        f"hittable_pdf_weight\t{hittable_pdf_weight}",
        "eye_x\t0.5", "eye_y\t0.5", "eye_z\t2.4",
        "center_x\t0.5", "center_y\t0.5", "center_z\t0.0",
        "up_x\t0.0", "up_y\t1.0", "up_z\t0.0",
        "fovy\t40.0",
        "sky_emission_r\t0.0", "sky_emission_g\t0.0", "sky_emission_b\t0.0",
        "sss_pts_per_object\t0",
        "ppm_num_photon_per_pass\t20000",
        "ppm_num_pass\t8",
        "ppm_max_bounce\t8",
        "ppm_alpha\t0.7",
        "ppm_radius_scaling_factor\t1.0",
        "ppm_image_output_iteration\t8",
    ]
    path = folder / "master.txt"
    path.write_text("\n".join(lines) + "\n")
    return path
