"""The Cornell box with spheres, written as OBJ/MTL files.

Frozen copy of `make_cornell_box`, `_icosphere` and `_quad` from
`gpu_pathtracer_tpu_torch/utils/testscenes.py` at commit 7741317 (the file
last changed in 70bdd69), kept here so that a change to the port's test
scenes cannot move the benchmark's inputs.  The port reads the files with its
own loader; the reference reads them with `benchmark/reference/scene_input.py`.
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


def make(folder, **params) -> dict:
    """The scene's input as the harness takes it: the OBJ file's folder and
    name (the MTL beside it)."""
    obj, _ = make_cornell_box(folder, **params)
    return {"kind": "obj", "folder": str(folder), "obj": obj}
