"""Texture atlas lookups (port of `gpu_pathtracer_tpu.ops.texture`).

Nearest-texel with wrap: ``idx_u = floor(frac(u) * (W - 1))``, row-major
``idx = W * idx_v + idx_u`` into one packed (P, 3) RGB atlas.  A NaN
coordinate (a NaN direction or uv, which a path can carry) reads index 0
along its axis, as XLA's float-to-int conversion makes the reference's
lookups do; torch's conversion would index out of bounds.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class Atlas:
    rgb: torch.Tensor  # (P, 3) packed pixels; slot 0 = 1x1 white
    offsets: torch.Tensor  # (K,) int32 pixel offset of each image
    heights: torch.Tensor  # (K,) int32
    widths: torch.Tensor  # (K,) int32


def lookup(atlas: Atlas, slot: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest-texel fetch.  slot (...,) int, uv (..., 2) -> (..., 3).

    An atlas holding only the 1x1 white default makes every fetch white, so
    no gather runs for untextured scenes.  When autograd records it, the
    gather goes through float64 (the values are the same): its backward
    sums every ray's gradient onto the texels it read, once rounded, so a
    gradient summed in two halves (two ranks) is the one summed whole, as
    `materials._take`'s."""
    if atlas.rgb.shape[0] <= 1:
        return torch.ones(slot.shape + (3,), dtype=atlas.rgb.dtype, device=atlas.rgb.device)
    idx = texel_index(atlas, slot, uv)
    if torch.is_grad_enabled() and atlas.rgb.requires_grad:
        return atlas.rgb.double()[idx].to(atlas.rgb.dtype)
    return atlas.rgb[idx]


def texel_index(atlas: Atlas, slot: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """The atlas row that `lookup` reads (int64)."""
    slot = slot.long()
    w = atlas.widths[slot]
    h = atlas.heights[slot]
    off = atlas.offsets[slot]
    u = uv[..., 0]
    v = uv[..., 1]
    iu = _index((u - torch.floor(u)) * (w - 1).to(u.dtype))
    iv = _index((v - torch.floor(v)) * (h - 1).to(v.dtype))
    return off.long() + w.long() * iv + iu


def _index(x: torch.Tensor) -> torch.Tensor:
    """floor(x) as an int64 index, NaN to 0."""
    return torch.nan_to_num(torch.floor(x), nan=0.0).to(torch.int64)


def lookup_sky(atlas_rgb, height: int, width: int, look_dir, sky_emission) -> torch.Tensor:
    """Equirectangular environment lookup."""
    u = 0.5 + torch.atan2(look_dir[..., 2], look_dir[..., 0]) / (2.0 * math.pi)
    v = 0.5 - torch.asin(torch.clamp(look_dir[..., 1], -1.0, 1.0)) / math.pi
    iu = _index((u - torch.floor(u)) * (width - 1))
    iv = _index((v - torch.floor(v)) * (height - 1))
    return sky_emission * atlas_rgb[width * iv + iu]
