"""Device helpers.

The port runs on a CUDA device.  The CPU is used only when a caller asks for
it explicitly (the tests, and `--device cpu` on the CLI); nothing here falls
back to it on its own.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch


def require_cuda() -> torch.device:
    """This process's CUDA device (the current one: `cuda:0`, or the one
    that `parallel.dist.init_distributed` set under NCCL, `cuda:LOCAL_RANK`);
    raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port renders on an NVIDIA GPU "
            "(pass an explicit CPU device only for tests)"
        )
    return torch.device("cuda", torch.cuda.current_device())


def as_f32(a, device) -> torch.Tensor:
    """Host array -> float32 tensor on `device` (numpy float64 would
    otherwise carry into the render)."""
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def as_i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int32), device=device)


def resolve_device(name: str | torch.device | None) -> torch.device:
    """`None` means the CUDA device (required); anything else is taken as
    given, so the CPU is used only when asked for by name."""
    if name is None:
        return require_cuda()
    dev = torch.device(name)
    if dev.type == "cuda":
        require_cuda()
    return dev


def nvidia_smi() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` prints them (its first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]
