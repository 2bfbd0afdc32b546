"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
objects cross over as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import functools
import tempfile

import numpy as np


def flatten(obj, prefix: str = "") -> dict[str, np.ndarray]:
    """A reference-package dataclass tree (e.g. its Scene) as
    {dotted field name: numpy array}; static fields become 0-d arrays and
    None fields are left out."""
    out: dict[str, np.ndarray] = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = f"{prefix}{f.name}"
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            out.update(flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


@functools.cache
def cornell_scenes():
    """The bench's Cornell box with spheres (972 triangles): (host arrays,
    JAX scene, port scene on the CPU built from the same host arrays).
    Built once per process; callers must not modify it."""
    from gpu_pathtracer_tpu.models.scene import build_scene as jax_build_scene
    from gpu_pathtracer_tpu.utils import obj_io, testscenes
    from gpu_pathtracer_tpu_torch.models.scene import build_scene

    with tempfile.TemporaryDirectory() as tmp:
        testscenes.make_cornell_box(tmp, spheres=True, sphere_subdiv=2)
        host = obj_io.load_scene(tmp, "box.obj")
    return host, jax_build_scene(host), build_scene(host, "cpu")


def random_tris(rng: np.random.Generator, n: int, lo=-2.0, hi=2.0) -> np.ndarray:
    """(n, 3, 3) float32 triangle soup (same shape law as tests/test_pallas.py)."""
    base = rng.uniform(lo, hi, (n, 1, 3))
    edge = rng.uniform(-0.7, 0.7, (n, 2, 3))
    return np.concatenate([base, base + edge], axis=1).astype(np.float32)


def random_rays(rng: np.random.Generator, r: int, spread: float = 3.0):
    o = rng.uniform(-spread, spread, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def uniforms_from_key(key, level: int, r: int) -> np.ndarray:
    """(level, 8, R): per bounce i, fold_in(key, i); BSDF uniforms from
    fold_in(., 17) sub-keys 0-3, NEE uniforms from fold_in(., 23) sub-keys
    0-3 with sub-key 1 drawn as (R, 1) (integrator.py, materials.py,
    lights.py)."""
    import jax

    out = np.empty((level, 8, r), np.float32)
    for i in range(level):
        bkey = jax.random.fold_in(key, i)
        for base, row0 in ((17, 0), (23, 4)):
            skey = jax.random.fold_in(bkey, base)
            for j in range(4):
                shape = (r, 1) if (base == 23 and j == 1) else (r,)
                u = jax.random.uniform(jax.random.fold_in(skey, j), shape)
                out[i, row0 + j] = np.asarray(u).reshape(r)
    return out


# ---------------------------------------------------------------------------
# SPPM: scenes, and the port's uniforms derived from a JAX key the way
# gpu_pathtracer_tpu.render.sppm folds it
# ---------------------------------------------------------------------------

@functools.cache
def sppm_scenes(fog: bool = False):
    """The SPPM test box of tests/test_sppm.py (Cornell box with octahedron
    spheres, 72 triangles, a light with a diffuse component; `fog` adds the
    participating medium): (JAX scene, port scene on the CPU made from the
    JAX scene's own arrays).  Built once per process; do not modify."""
    import pathlib

    from gpu_pathtracer_tpu.models.scene import build_scene as jax_build_scene
    from gpu_pathtracer_tpu.utils import obj_io, testscenes
    from gpu_pathtracer_tpu_torch.models.convert import scene_from_numpy

    with tempfile.TemporaryDirectory() as tmp:
        testscenes.make_cornell_box(tmp, spheres=True, sphere_subdiv=0, fog=fog)
        mtl = pathlib.Path(tmp) / "box.mtl"
        mtl.write_text(mtl.read_text().replace(
            "newmtl light\nKd 0 0 0", "newmtl light\nKd 0.78 0.78 0.78"))
        jscene = jax_build_scene(obj_io.load_scene(tmp, "box.obj"))
    return jscene, scene_from_numpy(flatten(jscene), "cpu")


def _uniform(key, shape) -> np.ndarray:
    import jax

    return np.asarray(jax.random.uniform(key, shape)).reshape(shape[0])


def bsdf_uniforms_from_key(key, r: int) -> np.ndarray:
    """(4, R): `materials.sample_bsdf`'s sub-keys 0-3."""
    import jax

    return np.stack([_uniform(jax.random.fold_in(key, j), (r,)) for j in range(4)])


def stack_uniforms_from_key(key, r: int, steps: int = 8) -> np.ndarray:
    """(steps, 4, R): `init_material_stack` folds its key per step."""
    import jax

    return np.stack([bsdf_uniforms_from_key(jax.random.fold_in(key, i), r) for i in range(steps)])


def photon_uniforms_from_key(key, n_photons: int, max_bounce: int, steps: int | None = None):
    """The uniforms dict of the port's `photon_pass` (sppm.py: emitter draws
    at sub-keys 0-4, the stack probe at 5, step s at 100 + s with sub-keys 0
    BSDF, 1 distance, 2 roulette, 3 scatter, 4 the HG pair, 5 new distance).
    Distances are handed over as raw [0, 1) uniforms of the same bits."""
    import jax

    p = n_photons
    steps = 4 * max_bounce + 32 if steps is None else steps
    rows = np.empty((steps, 10, p), np.float32)
    for s in range(steps):
        skey = jax.random.fold_in(key, 100 + s)
        rows[s, 0:4] = bsdf_uniforms_from_key(jax.random.fold_in(skey, 0), p)
        for row, sub in ((4, 1), (5, 2), (6, 3), (9, 5)):
            rows[s, row] = _uniform(jax.random.fold_in(skey, sub), (p,))
        hkey = jax.random.fold_in(skey, 4)
        rows[s, 7] = _uniform(jax.random.fold_in(hkey, 0), (p,))
        rows[s, 8] = _uniform(jax.random.fold_in(hkey, 1), (p,))
    return {
        "emit": np.stack([_uniform(jax.random.fold_in(key, j), (p,)) for j in range(5)]),
        "stack": stack_uniforms_from_key(jax.random.fold_in(key, 5), p),
        "steps": rows,
    }


def eye_uniforms_from_key(key, r: int, max_bounce: int):
    """The uniforms dict of the port's `eye_pass` (sppm.py: lens at sub-keys
    0-1, the stack probe at 2, bounce s at 50 + s, the direct chain under 90
    with its BSDF at 0, the light pick at 1 drawn as (R, 1), the light point
    at 2-3 and chain step i at 10 + i)."""
    import jax

    k90 = jax.random.fold_in(key, 90)
    return {
        "lens": np.stack([_uniform(jax.random.fold_in(key, j), (r,)) for j in range(2)]),
        "stack": stack_uniforms_from_key(jax.random.fold_in(key, 2), r),
        "bounce": np.stack([
            bsdf_uniforms_from_key(jax.random.fold_in(jax.random.fold_in(key, 50 + s), 0), r)
            for s in range(max_bounce)]),
        "direct_bsdf": bsdf_uniforms_from_key(jax.random.fold_in(k90, 0), r),
        "direct_pick": _uniform(jax.random.fold_in(k90, 1), (r, 1)),
        "direct_light": np.stack([_uniform(jax.random.fold_in(k90, j), (r,)) for j in (2, 3)]),
        "direct_chain": np.stack([
            bsdf_uniforms_from_key(jax.random.fold_in(k90, 10 + i), r) for i in range(8)]),
    }


def as_tensors(uniforms: dict):
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in uniforms.items()}


def sppm_diff_uniforms_from_key(key, r: int, n_photons: int, num_pass: int, max_bounce: int,
                                eye_bounce: int):
    """The `uniforms` of the port's `render_sppm_differentiable`, folded from
    the key as the reference's render folds it: the init eye pass from
    fold_in(fold_in(key, 0), 0), corner c from fold_in(fold_in(key, 0), 1 + c);
    pass i's photon pass from pkey = fold_in(key, 1000 + i), its eye pass from
    fold_in(pkey, 1), its row and column jitters from fold_in(pkey, 2 / 3)."""
    import jax
    import torch

    key_init = jax.random.fold_in(key, 0)

    def eye(k):
        return as_tensors(eye_uniforms_from_key(k, r, eye_bounce))

    passes = []
    for it in range(num_pass):
        pkey = jax.random.fold_in(key, 1000 + it)
        jitter = np.stack([_uniform(jax.random.fold_in(pkey, j), (r,)) for j in (2, 3)])
        passes.append({
            "photon": as_tensors(photon_uniforms_from_key(pkey, n_photons, max_bounce)),
            "eye": eye(jax.random.fold_in(pkey, 1)),
            "jitter": torch.from_numpy(jitter),
        })
    return {"init": eye(jax.random.fold_in(key_init, 0)),
            "corners": [eye(jax.random.fold_in(key_init, 1 + c)) for c in range(4)],
            "passes": passes}
