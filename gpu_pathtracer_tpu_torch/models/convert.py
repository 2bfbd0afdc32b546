"""Carry a reference-package scene across as numpy arrays.

`scene_from_numpy` takes the reference `Scene` flattened to numpy arrays
under dotted field names ("geom.p", "light_tree.anc", "materials.kd", ...;
static fields such as "sky_h" or "geom.bvh.num_leaves" as 0-d arrays) and
builds the port's `Scene` from exactly those arrays, so both packages can be
driven with the identical scene.  The tiles are the port's own packing and
are rebuilt from "geom.p", "geom.tol" and "geom.valid" (likewise for the
"transparent." subset, when the scene has one); fields the port does not
hold (the reference's TPU tile columns) are ignored.  `scene_to_numpy`
flattens a port scene the same way.  Every tensor made here is a leaf, so a
material or atlas field can be asked for gradients (`requires_grad_`);
`params_from_numpy` / `params_to_numpy` carry the optimizer's parameter dict
(`optim.optimize`) across both ways, `photons_*` and `hit_points_*` the SPPM
photon map and per-pixel state (dicts of numpy arrays under the dataclasses'
field names).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpu_pathtracer_tpu_torch.ops import bvh as bvh_mod
from gpu_pathtracer_tpu_torch.ops import closest_hit, lights, materials, texture
from gpu_pathtracer_tpu_torch.models.scene import GeometrySet, Scene


def _t(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: torch shares memory with numpy
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.as_tensor(a, device=device)


def _bvh(flat, prefix, device) -> bvh_mod.BVH:
    amin = flat[f"{prefix}.aabb_min"]
    order = flat[f"{prefix}.order"]
    m = int(flat.get(f"{prefix}.num_leaves", (amin.shape[0] + 1) // 2))
    return bvh_mod.BVH(
        aabb_min=_t(amin, device),
        aabb_max=_t(flat[f"{prefix}.aabb_max"], device),
        escape=_t(flat[f"{prefix}.escape"], device),
        left=_t(flat[f"{prefix}.left"], device),
        parent=_t(flat[f"{prefix}.parent"], device),
        order=_t(order, device),
        num_leaves=m,
        leaf_size=int(flat.get(f"{prefix}.leaf_size", order.shape[0] // m)),
    )


def _geometry(flat, device, prefix: str = "geom") -> GeometrySet:
    g = {f: _t(flat[f"{prefix}.{f}"], device)
         for f in ("p", "n", "uv", "tangent", "tol", "mat_id", "obj_id", "valid", "attr")}
    tiles, tile_aabb = closest_hit.pack_tiles(g["p"], g["tol"], g["valid"])
    return GeometrySet(
        bvh=_bvh(flat, f"{prefix}.bvh", device),
        tiles=tiles,
        tile_aabb=tile_aabb,
        num_tris=int(flat.get(f"{prefix}.num_tris", int(np.sum(flat[f"{prefix}.valid"])))),
        **g,
    )


def _light_tree(flat, device) -> lights.LightTree:
    names = [f.name for f in dataclasses.fields(lights.LightTree)]
    arrays = {n: _t(flat[f"light_tree.{n}"], device)
              for n in names if n not in ("tree", "num_lights", "depth", "dense")}
    tree = _bvh(flat, "light_tree.tree", device)
    e = int(flat.get("light_tree.num_lights", arrays["tri_p"].shape[0]))
    if "light_tree.depth" in flat:
        depth = int(flat["light_tree.depth"])
    else:
        depth = lights.topology_tables(
            tree.parent.cpu().numpy(), tree.left.cpu().numpy(), tree.escape.cpu().numpy(), e
        )[2]
    if not bool(flat.get("light_tree.dense", True)):
        raise NotImplementedError("the sparse light-tree regime is not ported yet")
    return lights.LightTree(tree=tree, num_lights=e, depth=depth, dense=True, **arrays)


def _materials(flat, device) -> materials.MaterialTable:
    names = [f.name for f in dataclasses.fields(materials.MaterialTable) if f.name != "atlas"]
    atlas = texture.Atlas(**{
        f.name: _t(flat[f"materials.atlas.{f.name}"], device)
        for f in dataclasses.fields(texture.Atlas)
    })
    return materials.MaterialTable(
        atlas=atlas, **{n: _t(flat[f"materials.{n}"], device) for n in names}
    )


def scene_from_numpy(flat: dict[str, np.ndarray], device) -> Scene:
    """The port's Scene from a reference Scene flattened to numpy arrays."""
    if any(k.startswith("sss.") for k in flat):
        raise NotImplementedError("SSS point clouds are not ported yet")
    has_lights = "light_tree.tri_p" in flat
    sky_rgb = flat["sky_rgb"]
    return Scene(
        geom=_geometry(flat, device),
        transparent=_geometry(flat, device, "transparent") if "transparent.p" in flat else None,
        light_tree=_light_tree(flat, device) if has_lights else None,
        materials=_materials(flat, device),
        sky_emission=_t(flat["sky_emission"], device),
        sky_rgb=_t(sky_rgb, device),
        num_lights=int(flat.get("num_lights", 0)),
        has_sky_tex=bool(flat.get("has_sky_tex", sky_rgb.shape[0] > 1)),
        sky_h=int(flat.get("sky_h", 1)),
        sky_w=int(flat.get("sky_w", 1)),
    )


def scene_to_numpy(obj, prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten a port dataclass tree to {dotted name: numpy array}; None
    fields are left out."""
    out: dict[str, np.ndarray] = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = f"{prefix}{f.name}"
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            out.update(scene_to_numpy(v, key + "."))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().cpu().numpy()
        else:
            out[key] = np.asarray(v)
    return out


def params_from_numpy(params: dict[str, np.ndarray], device, requires_grad: bool = False):
    """An optimizer parameter dict ({"ke": ..., "atlas_rgb": ...}) as leaf
    tensors on `device`."""
    return {k: _t(v, device).requires_grad_(requires_grad) for k, v in params.items()}


def params_to_numpy(params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The way back: detached copies on the host."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def _dataclass_from_numpy(cls, arrays, device):
    return cls(**{f.name: _t(arrays[f.name], device) for f in dataclasses.fields(cls)})


def photons_from_numpy(arrays: dict[str, np.ndarray], device):
    """A photon map (`render.sppm.Photons`) from its fields as numpy arrays."""
    from gpu_pathtracer_tpu_torch.render.sppm import Photons

    return _dataclass_from_numpy(Photons, arrays, device)


def hit_points_from_numpy(arrays: dict[str, np.ndarray], device):
    """Per-pixel SPPM state (`render.sppm.HitPoints`) from numpy arrays."""
    from gpu_pathtracer_tpu_torch.render.sppm import HitPoints

    return _dataclass_from_numpy(HitPoints, arrays, device)


# a photon map or the hit points back as {field name: numpy array}
photons_to_numpy = scene_to_numpy
hit_points_to_numpy = scene_to_numpy
