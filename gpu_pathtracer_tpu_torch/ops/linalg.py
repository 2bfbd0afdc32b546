"""Vector math on batched (..., 3) tensors (port of `gpu_pathtracer_tpu.ops.linalg`).

Branch-free and differentiable; the expressions keep the reference's
evaluation order so float32 results agree to the last few ulps.
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch.constants import SMALL_EPS


def dot(a: torch.Tensor, b: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    """Batched 3-vector dot product over the last axis."""
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def length(v: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdims))


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Unit vector; with eps > 0 degenerate inputs map to 0 instead of NaN."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    if eps > 0.0:
        inv = torch.where(
            n2 > eps * eps,
            1.0 / torch.sqrt(torch.clamp(n2, min=eps * eps)),
            torch.zeros_like(n2),
        )
        return v * inv
    return v / torch.sqrt(n2)


def de_nan(v: torch.Tensor) -> torch.Tensor:
    """NaN/Inf scrub to zero."""
    return torch.where(torch.isfinite(v), v, torch.zeros_like(v))


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return v - 2.0 * dot(v, n, keepdims=True) * n


def onb_from_z(z: torch.Tensor):
    """Orthonormal basis (x, y, z) from a z axis (branch-free dominant-axis
    tangent pick)."""
    zu = normalize(z)
    zx, zy, zz = zu[..., 0], zu[..., 1], zu[..., 2]
    use_x = torch.abs(zx) > torch.abs(zy)
    inv_a = 1.0 / torch.sqrt(torch.where(use_x, zx * zx + zz * zz, zy * zy + zz * zz))
    zero = torch.zeros_like(zx)
    x = torch.where(
        use_x[..., None],
        torch.stack([zz, zero, -zx], dim=-1),
        torch.stack([zero, -zz, zy], dim=-1),
    ) * inv_a[..., None]
    y = normalize(cross(zu, x))
    return x, y, zu


def onb_from_z_tangent(z: torch.Tensor, x_draft: torch.Tensor):
    """ONB from a z axis plus a tangent draft."""
    zu = normalize(z)
    xd = normalize(x_draft)
    y = normalize(cross(zu, xd))
    x = normalize(cross(y, zu))
    return x, y, zu


def to_world(x, y, z, v: torch.Tensor) -> torch.Tensor:
    """Rotate a local-frame vector into the world frame and renormalize."""
    w = v[..., 0:1] * x + v[..., 1:2] * y + v[..., 2:3] * z
    return normalize(w)


def rodrigues_rotate(v, axis, angle) -> torch.Tensor:
    k = normalize(axis)
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    return v * c + cross(k, v) * s + k * dot(k, v, keepdims=True) * (1.0 - c)


def mat3_from_rows(r0, r1, r2) -> torch.Tensor:
    return torch.stack([r0, r1, r2], dim=-2)


def mat3_vec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.sum(m * v[..., None, :], dim=-1)


def max_dimension(v: torch.Tensor) -> torch.Tensor:
    """Index of the largest-magnitude component (first on ties)."""
    return torch.argmax(torch.abs(v), dim=-1)


def safe_rsqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.where(
        x > SMALL_EPS * SMALL_EPS,
        1.0 / torch.sqrt(torch.clamp(x, min=1e-30)),
        torch.zeros_like(x),
    )


_TINY = 1e-12


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt with a finite gradient at x == 0."""
    return torch.where(x > _TINY, torch.sqrt(torch.clamp(x, min=_TINY)), torch.zeros_like(x))


def safe_pow(base: torch.Tensor, exp) -> torch.Tensor:
    """pow(base, exp) for base >= 0 with NaN-free gradients at base == 0:
    0^0 = 1, 0^e = 0 (e > 0)."""
    exp = torch.as_tensor(exp, dtype=base.dtype, device=base.device)
    out = torch.pow(torch.clamp(base, min=_TINY), exp)
    at_zero = torch.where(exp == 0.0, torch.ones_like(out), torch.zeros_like(out))
    return torch.where(base > _TINY, out, at_zero)
