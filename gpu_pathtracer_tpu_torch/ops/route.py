"""When a stage of the wavefront step may take its kernel, which has no
backward: where autograd records nothing for its inputs (`records_nothing`).
Each dispatcher then launches it for CUDA tensors, its plain version else."""

from __future__ import annotations

import dataclasses

import torch


def requires_grad(*objs) -> bool:
    """Whether a tensor among `objs` or their dataclass fields requires grad."""
    for obj in objs:
        if isinstance(obj, torch.Tensor):
            if obj.requires_grad:
                return True
        elif dataclasses.is_dataclass(obj):
            if requires_grad(*(getattr(obj, f.name) for f in dataclasses.fields(obj))):
                return True
    return False


def records_nothing(*inputs) -> bool:
    """Grad mode is off, or none of `inputs` requires grad."""
    return not (torch.is_grad_enabled() and requires_grad(*inputs))
