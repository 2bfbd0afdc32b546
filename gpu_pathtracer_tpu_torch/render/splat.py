"""Point-cloud splat debug images (port of `gpu_pathtracer_tpu.render.splat`).

Project every point of a cloud through the camera's inverse projection and
write its colour into the frame buffer: the SPPM hit points and photon maps.
Where several points land on a pixel one of them wins, as in the reference.
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch.ops import linalg


def splat_points(camera, locations, colors, width: int, height: int, valid=None) -> torch.Tensor:
    """Project (N, 3) points to pixels and write their (N, 3) colours; returns
    (H, W, 3).  Non-finite locations, points behind the eye and out-of-frame
    projections are dropped."""
    finite = torch.all(torch.isfinite(locations), dim=-1)
    if valid is not None:
        finite = finite & valid
    direction = linalg.normalize(torch.where(finite[..., None], locations, 0.0) - camera.eye, 1e-12)
    i, j = camera.project(direction)
    front = linalg.dot(direction, -camera.w) > 0
    ok = finite & front & (i >= 0) & (j >= 0) & (i < height) & (j < width)
    # dropped points go to a scratch row past the frame
    idx = torch.where(ok, i * width + j, height * width).long()
    fb = torch.zeros((height * width + 1, 3), dtype=torch.float32, device=locations.device)
    fb[idx] = torch.where(ok[..., None], colors, 0.0)
    return fb[: height * width].reshape(height, width, 3)
