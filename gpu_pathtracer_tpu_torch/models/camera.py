"""Thin-lens / pinhole camera (port of `gpu_pathtracer_tpu.models.camera`).

Look-at basis, per-pixel primary rays with a focus-plane target and a
lens-circle offset for depth of field, and the inverse projection used by
the point-cloud splat images.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gpu_pathtracer_tpu_torch.ops import linalg, sampling


@dataclasses.dataclass
class Camera:
    eye: torch.Tensor  # (3,)
    u: torch.Tensor  # (3,) right
    v: torch.Tensor  # (3,) up
    w: torch.Tensor  # (3,) backward (eye - center)
    tan_half_fovx: float
    tan_half_fovy: float
    lens_radius: float
    focus_dist: float
    width: int = 256
    height: int = 256

    @staticmethod
    def create(eye, center, up, fovy_deg: float, width: int, height: int,
               aperture: float = 0.0, focus_dist: float = 1.0, device=None) -> "Camera":
        """Look-at construction; fovx follows fovy through the aspect ratio."""
        eye = torch.as_tensor(eye, dtype=torch.float32, device=device)
        center = torch.as_tensor(center, dtype=torch.float32, device=device)
        up = torch.as_tensor(up, dtype=torch.float32, device=device)
        w = linalg.normalize(eye - center)
        u = linalg.normalize(linalg.cross(up, w))
        v = linalg.cross(w, u)
        tan_half_fovy = math.tan(math.pi * fovy_deg / 180.0 / 2.0)
        tan_half_fovx = (width / height) * tan_half_fovy
        # scalars are rounded to float32 as the reference stores them
        f32 = lambda x: float(torch.tensor(x, dtype=torch.float32))  # noqa: E731
        return Camera(
            eye=eye, u=u, v=v, w=w,
            tan_half_fovx=f32(tan_half_fovx),
            tan_half_fovy=f32(tan_half_fovy),
            lens_radius=f32(aperture / 2.0),
            focus_dist=f32(focus_dist),
            width=width,
            height=height,
        )

    def generate_rays(self, i, j, u1, u2):
        """Primary rays for pixel coordinates (i=row, j=col; pass +0.5 for
        centers); u1/u2 drive the thin-lens sample.  Returns (origins,
        directions), each (..., 3)."""
        alpha = self.tan_half_fovx * (j - self.width / 2.0) / (self.width / 2.0)
        beta = self.tan_half_fovy * (self.height / 2.0 - i) / (self.height / 2.0)
        d = alpha[..., None] * self.u + beta[..., None] * self.v - self.w
        d = linalg.normalize(d)
        point = self.eye + self.focus_dist * d
        rd = self.lens_radius * sampling.sample_unit_circle(u1, u2)
        offset = rd[..., 0:1] * self.u + rd[..., 1:2] * self.v
        origin = self.eye + offset
        direction = linalg.normalize(point - origin)
        return torch.broadcast_to(origin, d.shape), direction

    def project(self, direction):
        """Inverse projection of a view direction to integer pixel (i, j),
        each int32; used by the point-cloud splat images."""
        j = torch.floor(
            self.width / 2.0
            + self.width / 2.0 / self.tan_half_fovx * linalg.dot(direction + self.w, self.u)
        ).to(torch.int32)
        i = torch.floor(
            self.height / 2.0
            - self.height / 2.0 / self.tan_half_fovy * linalg.dot(direction + self.w, self.v)
        ).to(torch.int32)
        return i, j
