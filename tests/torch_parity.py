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
