"""Samplers, PDFs and Phong weighting filters (port of
`gpu_pathtracer_tpu.ops.sampling`).

Every sampler takes explicit uniforms, so the same numbers can drive both
packages.
"""

from __future__ import annotations

import math

import torch

from gpu_pathtracer_tpu_torch.constants import MAX_PHONG_N_S, SMALL_EPS
from gpu_pathtracer_tpu_torch.ops import linalg

_PI = math.pi


def n_s_too_large(n: torch.Tensor) -> torch.Tensor:
    """Mirror-limit test for the Phong exponent."""
    return (torch.abs(n - MAX_PHONG_N_S) < SMALL_EPS) | (n >= MAX_PHONG_N_S)


def silverman_biweight(x: torch.Tensor) -> torch.Tensor:
    """Silverman biweight kernel 3/pi (1-x^2)^2."""
    t = 1.0 - x * x
    return (3.0 / _PI) * t * t


# ---------------------------------------------------------------------------
# Henyey-Greenstein phase function
# ---------------------------------------------------------------------------

def henyey_greenstein_pdf(g: torch.Tensor, dir_1: torch.Tensor, dir_2: torch.Tensor) -> torch.Tensor:
    """HG phase function value between two directions."""
    cos_theta = linalg.dot(linalg.normalize(dir_1, SMALL_EPS), linalg.normalize(dir_2, SMALL_EPS))
    cos_theta = torch.where(torch.isnan(cos_theta), 0.0, cos_theta)
    denom = linalg.safe_pow(torch.clamp(1.0 + g * g - 2.0 * g * cos_theta, min=1e-6), 1.5)
    return (1.0 / (4.0 * _PI)) * (1.0 - g * g) / denom


def henyey_greenstein_cos_theta(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF sample of the HG scattering angle, with the reference's
    sign quirk kept: -1/|2g| where the textbook inversion has +1/(2g), so for
    g > 0 the sampled distribution is HG(-g)."""
    iso = 1.0 - 2.0 * u
    small = torch.abs(g) < SMALL_EPS
    g_safe = torch.where(small, 1.0, g)
    frac = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe * u)
    aniso = (-1.0 / torch.abs(2.0 * g_safe)) * (1.0 + g_safe * g_safe - frac * frac)
    return torch.where(small, iso, aniso)


# ---------------------------------------------------------------------------
# Local-frame direction samplers (frame: +z = main axis)
# ---------------------------------------------------------------------------

def sample_hemisphere_cos(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere sample, pdf = cos(theta)/pi."""
    z = torch.sqrt(torch.clamp(1.0 - u2, min=0.0))
    phi = 2.0 * _PI * u1
    r = torch.sqrt(torch.clamp(u2, min=0.0))
    v = torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, z], dim=-1)
    return linalg.normalize(v, SMALL_EPS)


def sample_hemisphere_ref(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """The reference's "uniform hemisphere" sampler (sin(theta) uniform)."""
    sin_theta = u1
    cos_theta = torch.sqrt(torch.clamp(1.0 - sin_theta * sin_theta, min=0.0))
    phi = u2 * 2.0 * _PI
    v = torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )
    return linalg.normalize(v, SMALL_EPS)


def sample_phong_lobe(n: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """(n+1)-power cosine lobe about +z; mirror-limit exponents return +z."""
    mirror = n_s_too_large(n)
    n_safe = torch.where(mirror, torch.ones_like(n), n)
    r1 = torch.clamp(u1, min=1e-12)
    z = torch.pow(r1, 1.0 / (n_safe + 1.0))
    s = torch.sqrt(torch.clamp(1.0 - torch.pow(r1, 2.0 / (n_safe + 1.0)), min=0.0))
    phi = 2.0 * _PI * u2
    v = torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], dim=-1)
    v = linalg.normalize(v, SMALL_EPS)
    mirror_v = torch.tensor([0.0, 0.0, 1.0], dtype=v.dtype, device=v.device).expand_as(v)
    return torch.where(mirror[..., None], mirror_v, v)


def sample_unit_circle(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Point on the unit circle rim in the z=0 plane (the reference's
    thin-lens sampler, reproduced with its sign flip from u2)."""
    sin_theta = 2.0 * u1 - 1.0
    cos_theta = torch.sqrt(torch.clamp(1.0 - sin_theta * sin_theta, min=0.0))
    cos_theta = torch.where(u2 <= 0.5, -cos_theta, cos_theta)
    v = torch.stack([cos_theta, sin_theta, torch.zeros_like(sin_theta)], dim=-1)
    return linalg.normalize(v, SMALL_EPS)


# ---------------------------------------------------------------------------
# PDFs
# ---------------------------------------------------------------------------

def diffuse_sampling_pdf(normal: torch.Tensor, out_dir: torch.Tensor) -> torch.Tensor:
    """cos(theta)/pi clamped at 0."""
    return torch.clamp(linalg.dot(normal, out_dir) / _PI, min=0.0)


def _same_side(d1, d2):
    return ((d1 >= 0) & (d2 >= 0)) | ((d1 <= 0) & (d2 <= 0))


def _opposite_side(d1, d2):
    return ((d1 >= 0) & (d2 <= 0)) | ((d1 <= 0) & (d2 >= 0))


def specular_sampling_pdf(in_dir, out_dir, normal, perfect_out, n, refracted):
    """Phong-lobe solid-angle pdf (n+1) cos^n / 2pi with hemisphere gating;
    mirror limit -> MAX_N_S/2pi."""
    d1 = linalg.dot(in_dir, normal)
    d2 = linalg.dot(normal, out_dir)
    valid = torch.where(refracted, _same_side(d1, d2), _opposite_side(d1, d2))
    mirror = n_s_too_large(n)
    n_safe = torch.where(mirror, torch.ones_like(n), n)
    cos_a = torch.clamp(linalg.dot(perfect_out, out_dir), min=0.0)
    lobe = (n_safe + 1.0) * linalg.safe_pow(cos_a, n_safe) / (2.0 * _PI)
    pdf = torch.where(mirror, torch.full_like(lobe, MAX_PHONG_N_S / (2.0 * _PI)), lobe)
    return torch.where(valid, pdf, torch.zeros_like(pdf))


def specular_sampling_pdf_2(in_dir, out_dir, normal, perfect_out, n, refracted):
    """Unnormalized variant cos^n / 2pi; mirror limit -> 1/2pi."""
    d1 = linalg.dot(in_dir, normal)
    d2 = linalg.dot(normal, out_dir)
    valid = torch.where(refracted, _same_side(d1, d2), _opposite_side(d1, d2))
    mirror = n_s_too_large(n)
    n_safe = torch.where(mirror, torch.ones_like(n), n)
    cos_a = torch.clamp(linalg.dot(perfect_out, out_dir), min=0.0)
    lobe = linalg.safe_pow(cos_a, n_safe) / (2.0 * _PI)
    pdf = torch.where(mirror, torch.full_like(lobe, 1.0 / (2.0 * _PI)), lobe)
    return torch.where(valid, pdf, torch.zeros_like(pdf))


def scattering_pdf(normal, next_dir, diffuse, coming_dir, refracted):
    """The reference's "scattering pdf": cos term for diffuse, 0/1
    side-consistency indicator for specular lobes."""
    diff_val = torch.clamp(linalg.dot(normal, next_dir), min=0.0)
    d1 = linalg.dot(coming_dir, normal)
    d2 = linalg.dot(next_dir, normal)
    spec_ok = torch.where(refracted, _same_side(d1, d2), _opposite_side(d1, d2))
    return torch.where(diffuse, diff_val, spec_ok.to(diff_val.dtype))


def sampling_pdf_2(normal, next_dir, diffuse, n, coming_dir, perfect_next_dir, refracted):
    """Mixture dispatcher: diffuse pdf or the unnormalized specular pdf."""
    return torch.where(
        diffuse,
        diffuse_sampling_pdf(normal, next_dir),
        specular_sampling_pdf_2(coming_dir, next_dir, normal, perfect_next_dir, n, refracted),
    )


def schlick_reflectance(cos_theta, n_1, n_2) -> torch.Tensor:
    """Schlick Fresnel approximation."""
    r0 = torch.square((n_1 - n_2) / (n_1 + n_2))
    m = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    return r0 + (1.0 - r0) * m * m * m * m * m


# ---------------------------------------------------------------------------
# Modified-Phong BRDF weighting filters
# ---------------------------------------------------------------------------

def phong_filter(k, n, ideal_dir, out_dir) -> torch.Tensor:
    """k (n+2)/2 cos^n; mirror limit -> k * MAX_N_S / 2."""
    mirror = n_s_too_large(n)
    n_safe = torch.where(mirror, torch.ones_like(n), n)
    cos_a = torch.clamp(linalg.dot(ideal_dir, out_dir, keepdims=True), min=0.0)
    w = (n_safe[..., None] + 2.0) * linalg.safe_pow(cos_a, n_safe[..., None]) / 2.0
    w = torch.where(mirror[..., None], torch.full_like(w, MAX_PHONG_N_S / 2.0), w)
    return k * w


def phong_filter_2(k, n, ideal_dir, out_dir) -> torch.Tensor:
    """Unnormalized k cos^n; mirror limit -> k."""
    mirror = n_s_too_large(n)
    n_safe = torch.where(mirror, torch.ones_like(n), n)
    cos_a = torch.clamp(linalg.dot(ideal_dir, out_dir, keepdims=True), min=0.0)
    w = linalg.safe_pow(cos_a, n_safe[..., None])
    w = torch.where(mirror[..., None], torch.ones_like(w), w)
    return k * w


# ---------------------------------------------------------------------------
# World-frame ray direction generation
# ---------------------------------------------------------------------------

def generate_direction(main_dir, normal, mode, n, u1, u2) -> torch.Tensor:
    """Sample an outgoing world-space direction.

    mode 0: cosine hemisphere about `normal`;
    mode 1: Phong lobe about `main_dir`;
    mode 2: reference-"uniform" hemisphere about `normal`.
    """
    local_cos = sample_hemisphere_cos(u1, u2)
    local_phong = sample_phong_lobe(n, u1, u2)
    local_uni = sample_hemisphere_ref(u1, u2)
    local = torch.where(
        (mode == 0)[..., None],
        local_cos,
        torch.where((mode == 1)[..., None], local_phong, local_uni),
    )
    axis = torch.where((mode == 1)[..., None], main_dir, normal)
    x, y, z = linalg.onb_from_z(axis)
    return linalg.to_world(x, y, z, local)
