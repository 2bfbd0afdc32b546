"""Bounding-sphere predicates (port of `gpu_pathtracer_tpu.ops.bounding_sphere`).

The gathers run on a spatial hash grid (`ops/hashgrid.py`), so there is no
sphere tree; the sphere-level predicates are still the core of every gather
test, as batched functions broadcastable over any leading shape:
`is_inside` (distance <= r), `is_inside_sq` (its squared form, which the SPPM
gathers' selection uses), `is_inside_disc` (also |dot(p - c, n)| <= 0.1 r),
`sphere_union` (the reference's axis-projection union, kept for parity) and
`sphere_box_intersect` (the reference's conservative box-expansion test).
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch.ops import linalg


def is_inside(center, r, pts, d=None) -> torch.Tensor:
    """distance(center, p) <= r; pass `d` when the distance is already known."""
    if d is None:
        d = linalg.length(pts - center)
    return d <= r


def is_inside_sq(center, r, pts, d2=None) -> torch.Tensor:
    """`is_inside` in squared-distance form (d^2 <= r^2): no sqrt to perturb
    ulp-edge verdicts."""
    if d2 is None:
        d2 = torch.sum((pts - center) ** 2, dim=-1)
    return d2 <= r * r


def is_inside_disc(center, r, pts, normal, d=None) -> torch.Tensor:
    """Inside the sphere and within the thin disc |dot(p - center, normal)|
    <= 0.1 r about the tangent plane."""
    rel = pts - center
    if d is None:
        d = linalg.length(rel)
    parallel = torch.sum(rel * normal, dim=-1)
    return (d <= r) & (torch.abs(parallel) <= 0.1 * r)


def sphere_union(c1, r1, c2, r2):
    """The reference's union of two spheres: both spheres' extreme points
    projected onto the c1->c2 axis as distances from c1, spanning
    [t_min, t_max].  Returns (center, r); coincident centres fall back to the
    larger sphere."""
    axis = c2 - c1
    alen = linalg.length(axis)
    degenerate = alen < 1e-20
    u = axis / torch.where(degenerate, 1.0, alen)[..., None]
    d_p3 = torch.abs(alen - r2)
    d_p4 = alen + r2
    t_min = -torch.minimum(r1, d_p3)
    t_max = torch.maximum(r1, d_p4)
    r = (t_max - t_min) / 2.0
    center = c1 + ((t_min + t_max) / 2.0)[..., None] * u
    fallback_c = torch.where((r1 >= r2)[..., None], c1, c2)
    return (
        torch.where(degenerate[..., None], fallback_c, center),
        torch.where(degenerate, torch.maximum(r1, r2), r),
    )


def sphere_box_intersect(box_lo, box_hi, center, r) -> torch.Tensor:
    """Per-axis |box_center - c| <= half_extent + r: the box expanded by r, a
    superset of true sphere/box overlap near corners, as the reference has it."""
    box_c = (box_lo + box_hi) * 0.5
    half = box_hi - box_c
    return torch.all(torch.abs(box_c - center) <= half + r[..., None], dim=-1)
