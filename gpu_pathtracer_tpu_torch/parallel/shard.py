"""Sharded rendering and the distributed differentiable train step (port of
`gpu_pathtracer_tpu.parallel.shard` on `torch.distributed`).

One process drives one device, and a process group stands in for the JAX
package's device mesh: `make_mesh` wraps the group in a `Mesh`, whose
collectives are the only ones the port calls (each counted as
`collective.<op>` by the port's tracer, `tracing`).  Everything here takes any mesh size, one included.

* `render_image_distributed` is the GSPMD counterpart: every rank walks the
  same pixel chunks and draws every chunk's numbers at the chunk's full width
  from the replicated generator, in `render_image`'s order, then traces only
  its own columns; one all-gather assembles the image.  The image is
  `render_image`'s bit for bit, whatever the mesh size.
* `render_image_shard_map` is the counterpart of the `shard_map` render:
  pixels dealt round robin over the ranks, each rank with a generator of its
  own derived from (seed, rank), no collective until the image is assembled.
* `train_step_distributed`: each rank renders its columns with path replay,
  every rank computes the same loss from the all-gathered image, each
  backpropagates its own columns, and the parameter gradients are summed
  over the ranks once; then the SGD step with the non-negativity clamp.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from gpu_pathtracer_tpu_torch import tracing
from gpu_pathtracer_tpu_torch.constants import MATERIAL_STACK_SIZE
from gpu_pathtracer_tpu_torch.device import resolve_device
from gpu_pathtracer_tpu_torch.render.integrator import (
    _chunk_sample,
    render_image,
    render_image_value_and_grad,
)

AXIS = "rays"

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def shard_seed(base: int, rank: int, tag: int) -> int:
    """Seed of rank `rank`'s stream under `base` in the namespace `tag`.  Bit
    63 is set: the seeds of `render.sppm.pass_generator` and
    `optim.step_generator`, (seed << 20) + index with seeds below 2^43, never
    have it, so no rank stream is one of theirs.  Distinct ranks of one base
    get distinct seeds."""
    x = (base ^ (tag << 32)) & 0xFFFFFFFFFFFFFFFF
    # splitmix64's finalizer: nearby bases land far apart
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    return (1 << 63) | ((x + rank) & ((1 << 63) - 1))


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The ranks that share a batch of rays: the process group `group`
    (None: this process alone, and no collective is issued), this process's
    `rank` in it, the group's `size`, and the device this process renders
    on.  Both NCCL and gloo take CUDA tensors (gloo copies them through host
    memory itself)."""

    group: object
    rank: int
    size: int
    device: torch.device

    def bounds(self, n: int) -> list[tuple[int, int]]:
        """Each rank's [lo, hi) of `n` items split contiguously in rank
        order; the shares differ by at most one."""
        return [(n * r // self.size, n * (r + 1) // self.size) for r in range(self.size)]

    def columns(self, n: int) -> slice:
        """This rank's share of `n` items (`bounds`)."""
        return slice(*self.bounds(n)[self.rank])

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise `op` ("sum" or "max") of `t` over the ranks; a
        new tensor (`t` itself without a group)."""
        if self.group is None:
            return t
        tracing.count(f"collective.all_reduce_{op}")
        x = t.clone()
        dist.all_reduce(x, op=_REDUCE_OPS[op], group=self.group)
        return x

    def all_gather(self, t: torch.Tensor, sizes: list[int] | None = None) -> torch.Tensor:
        """Every rank's `t` concatenated along dim 0 in rank order.  `sizes`
        gives each rank's row count when they differ (all equal to this
        rank's by default)."""
        if self.group is None:
            return t
        tracing.count("collective.all_gather")
        n = t.shape[0]
        sizes = [n] * self.size if sizes is None else sizes
        width = max(sizes)
        x = t.to(torch.uint8) if t.dtype == torch.bool else t.detach()
        if n < width:
            x = torch.cat([x, x.new_zeros((width - n,) + tuple(x.shape[1:]))])
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat([p[:s] for p, s in zip(parts, sizes)]).to(t.dtype)

    def gather_map(self, t: torch.Tensor) -> torch.Tensor:
        """`all_gather` of equal shares that every rank then reads whole (the
        photon map), differentiable: a rank's share enters every rank's
        loss, so its gradient is the sum over the ranks of their gradients
        for it (an all-reduce of the gathered gradient, then this rank's
        slice; gloo has no reduce-scatter).  Every rank must reach the
        backward: the tensor must be in every rank's graph."""
        return t if self.group is None else _GatherMap.apply(self, t)

    def gather_image(self, t: torch.Tensor) -> torch.Tensor:
        """`all_gather` of equal shares of pixels, differentiable for a loss
        that every rank computes alike from the whole image: the gradient of
        this rank's pixels is its slice of the image's, with no collective."""
        return t if self.group is None else _GatherImage.apply(self, t)


class _GatherMap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, t):
        ctx.mesh, ctx.rows = mesh, t.shape[0]
        return mesh.all_gather(t)

    @staticmethod
    def backward(ctx, grad):
        total = ctx.mesh.all_reduce(grad.contiguous())
        lo = ctx.mesh.rank * ctx.rows
        return None, total[lo:lo + ctx.rows]


class _GatherImage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, t):
        ctx.rank, ctx.rows = mesh.rank, t.shape[0]
        return mesh.all_gather(t)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.rows
        return None, grad[lo:lo + ctx.rows]


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of `group`, or of the default process group when
    torch.distributed is initialized; else this process alone (size 1, no
    collectives), which is what `shard_rays` means on one device.  `device`
    is the device this process renders on (None: its CUDA device).  Raises
    ValueError when this process is not a member of `group`."""
    dev = resolve_device(device)
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return Mesh(None, 0, 1, dev)
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError(f"this process (rank {dist.get_rank()} of the job) is not a member of "
                         "the group: only its members may build its mesh")
    return Mesh(group, rank, dist.get_world_size(group), dev)


def _pad_to(x: torch.Tensor, multiple: int):
    """`x` padded along dim 0 with zeros (pixel (0, 0)) to a multiple of
    `multiple`, and its length before."""
    n = x.shape[0]
    pad = (-n) % multiple
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x, n


# ---------------------------------------------------------------------------
# GSPMD counterpart: same numbers, sharded columns, bit-identical image
# ---------------------------------------------------------------------------

def render_image_distributed(
    scene,
    camera,
    width: int,
    height: int,
    mesh: Mesh | None = None,
    sample_size: int = 16,
    dof_sample_size: int = 1,
    level: int = 8,
    hittable_pdf_weight: float = 0.0,
    stack_size: int = MATERIAL_STACK_SIZE,
    ray_chunk: int = 65536,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """`render_image` with each chunk's columns split over `mesh` (None:
    `make_mesh()`): the same draws from `generator` (replicated: every rank
    passes one seeded alike), so the (H, W, 3) image on every rank is
    `render_image`'s from the same generator state, bit for bit."""
    mesh = mesh or make_mesh(device=scene.geom.p.device)
    return render_image(scene, camera, width, height, sample_size=sample_size,
                        dof_sample_size=dof_sample_size, level=level,
                        hittable_pdf_weight=hittable_pdf_weight, stack_size=stack_size,
                        ray_chunk=ray_chunk, generator=generator, mesh=mesh)


# ---------------------------------------------------------------------------
# shard_map counterpart: per-rank streams, no collective per bounce
# ---------------------------------------------------------------------------

SHARD_MAP_TAG = 0x5BBE  # namespace of `render_image_shard_map`'s rank streams


def render_image_shard_map(
    scene,
    camera,
    seed: int,
    width: int,
    height: int,
    mesh: Mesh,
    sample_size: int = 16,
    level: int = 8,
    hittable_pdf_weight: float = 0.0,
    stack_size: int = MATERIAL_STACK_SIZE,
    ray_chunk: int = 65536,
) -> torch.Tensor:
    """Each rank renders the pixels dealt to it round robin (rank d: pixels
    d, d + size, ...; spatially clustered slices would load the ranks
    unevenly) from a generator of its own, seeded from (seed, rank), with no
    collective per bounce; one all-gather assembles the (H, W, 3) image.
    Deterministic for a fixed (seed, mesh size)."""
    dev = scene.geom.p.device
    ii, jj = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    pix_i, n_pix = _pad_to(ii.reshape(-1) + 0.5, mesh.size)
    pix_j, _ = _pad_to(jj.reshape(-1) + 0.5, mesh.size)
    mine_i, mine_j = pix_i[mesh.rank::mesh.size], pix_j[mesh.rank::mesh.size]
    generator = torch.Generator(device=dev).manual_seed(
        shard_seed(seed, mesh.rank, SHARD_MAP_TAG))
    acc = torch.zeros((mine_i.shape[0], 3), dtype=torch.float32, device=dev)
    for _ in range(sample_size):
        for c0 in range(0, mine_i.shape[0], ray_chunk):
            sl = slice(c0, c0 + ray_chunk)
            acc[sl] += _chunk_sample(scene, camera, mine_i[sl], mine_j[sl], level,
                                     hittable_pdf_weight, stack_size, generator)
    out = mesh.all_gather(acc / sample_size)  # rank-major: (size, pixels / size)
    img = out.reshape(mesh.size, -1, 3).transpose(0, 1).reshape(-1, 3)[:n_pix]
    return img.reshape(height, width, 3)


# ---------------------------------------------------------------------------
# distributed differentiable train step
# ---------------------------------------------------------------------------

def train_step_distributed(
    scene,
    camera,
    params: dict,
    target: torch.Tensor,  # (H, W, 3)
    generator: torch.Generator,
    mesh: Mesh | None = None,
    width: int = 64,
    height: int = 64,
    sample_size: int = 4,
    level: int = 4,
    hittable_pdf_weight: float = 0.5,
    lr: float = 0.05,
):
    """One SGD step on material parameters against a target image.

    `params` maps MaterialTable field names (e.g. 'kd', 'ke') to tensors.
    The L2 loss of the render with those fields substituted and its
    gradient come from `render_image_value_and_grad` over `mesh` (each rank
    replays its own columns; the gradients are summed over the ranks once),
    so every rank takes the same step.  Returns (loss, new_params)."""
    from gpu_pathtracer_tpu_torch.optim import _substitute

    mesh = mesh or make_mesh(device=scene.geom.p.device)
    names = list(params)
    leaves = [params[n].detach().requires_grad_(True) for n in names]
    target = target.detach()
    loss, _, grads = render_image_value_and_grad(
        _substitute(scene, dict(zip(names, leaves))), camera, width, height,
        lambda img: torch.mean((img - target) ** 2), leaves, sample_size=sample_size,
        level=level, hittable_pdf_weight=hittable_pdf_weight, generator=generator, mesh=mesh)
    new_params = {n: torch.clamp(p.detach() - lr * g, min=0.0)
                  for n, p, g in zip(names, leaves, grads)}
    return loss, new_params
