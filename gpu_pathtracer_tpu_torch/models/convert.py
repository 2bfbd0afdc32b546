"""Carry a reference-package scene across as numpy arrays.

`scene_from_numpy` takes the reference `Scene` flattened to numpy arrays
under dotted field names ("geom.p", "light_tree.anc", "materials.kd", ...;
static fields such as "sky_h" or "geom.bvh.num_leaves" as 0-d arrays) and
builds the port's `Scene` from exactly those arrays, so both packages can be
driven with the identical scene.  The tiles are the port's own packing and
are rebuilt from "geom.p", "geom.tol" and "geom.valid" (likewise for the
"transparent." subset, when the scene has one); fields the port does not
hold (the reference's TPU tile columns) are ignored.  The prefilter's edge
weights are carried across when present: the reference's "geom.edge_cols"
(its (NT, 16, 3 * tile) layout, any float type) is re-laid-out to the port's
tile width (`edge_cols_to_tiles`), the port's own "geom.edge_tiles" /
"geom.edge_wsum" are taken as they are.  `scene_to_numpy` flattens a port
scene the same way (bfloat16 tensors as float32 arrays: numpy has no
bfloat16).  Every tensor made here is a leaf, so a
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
from gpu_pathtracer_tpu_torch.models.scene import GeometrySet, Scene, SSSPoints


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


def edge_cols_to_tiles(edge_cols: np.ndarray, n_tiles: int):
    """The reference's (NT', 16, 3 * tile') edge columns (rows 0-5 the
    Pluecker weights of column m * tile' + t, row 6 the margin scale) as the
    port's ((n_tiles, 3 * TILE, EDGE_K), (n_tiles, 3, TILE)) float32 arrays.
    Both packings pad the same sorted triangle rows, to different tile
    widths; rows past the port's padding are padding in the reference too."""
    tile, k = closest_hit.TILE, closest_hit.EDGE_K
    cols = np.asarray(edge_cols, dtype=np.float32)
    nt_ref, _, w3 = cols.shape
    per_tri = cols.reshape(nt_ref, 16, 3, w3 // 3).transpose(0, 3, 2, 1).reshape(-1, 3, 16)
    rows = n_tiles * tile
    if per_tri.shape[0] < rows:
        filler = np.zeros((rows - per_tri.shape[0], 3, 16), np.float32)
        filler[:, :, 6] = -1.0
        per_tri = np.concatenate([per_tri, filler])
    per_tri = per_tri[:rows].reshape(n_tiles, tile, 3, 16).transpose(0, 2, 1, 3)
    edge = np.zeros((n_tiles, 3, tile, k), np.float32)
    edge[..., 0:6] = per_tri[..., 0:6]
    return edge.reshape(n_tiles, 3 * tile, k), np.ascontiguousarray(per_tri[..., 6])


def _geometry(flat, device, prefix: str = "geom") -> GeometrySet:
    g = {f: _t(flat[f"{prefix}.{f}"], device)
         for f in ("p", "n", "uv", "tangent", "tol", "mat_id", "obj_id", "valid", "attr")}
    tiles, tile_aabb = closest_hit.pack_tiles(g["p"], g["tol"], g["valid"])
    edge = None
    if f"{prefix}.edge_tiles" in flat:
        edge = flat[f"{prefix}.edge_tiles"], flat[f"{prefix}.edge_wsum"]
    elif flat.get(f"{prefix}.edge_cols") is not None:
        edge = edge_cols_to_tiles(flat[f"{prefix}.edge_cols"], tiles.shape[0])
    return GeometrySet(
        bvh=_bvh(flat, f"{prefix}.bvh", device),
        tiles=tiles,
        tile_aabb=tile_aabb,
        num_tris=int(flat.get(f"{prefix}.num_tris", int(np.sum(flat[f"{prefix}.valid"])))),
        edge_tiles=None if edge is None else _t(edge[0], device).to(torch.bfloat16),
        edge_wsum=None if edge is None else _t(edge[1], device),
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
    dense = bool(flat.get("light_tree.dense", True))
    return lights.LightTree(tree=tree, num_lights=e, depth=depth, dense=dense, **arrays)


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
    has_lights = "light_tree.tri_p" in flat
    sky_rgb = flat["sky_rgb"]
    return Scene(
        geom=_geometry(flat, device),
        transparent=_geometry(flat, device, "transparent") if "transparent.p" in flat else None,
        light_tree=_light_tree(flat, device) if has_lights else None,
        materials=_materials(flat, device),
        sky_emission=_t(flat["sky_emission"], device),
        sky_rgb=_t(sky_rgb, device),
        sss=_dataclass_from_numpy(SSSPoints, {k[4:]: v for k, v in flat.items()
                                              if k.startswith("sss.")}, device)
        if "sss.pos" in flat else None,
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
            v = v.detach().cpu()
            out[key] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
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
