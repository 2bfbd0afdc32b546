"""Distributed SPPM: sharded photon tracing and the photon-map all-gather
(port of `gpu_pathtracer_tpu.parallel.sppm_shard` on `torch.distributed`).

* photon pass: each rank traces `n_photons / size` photons from a stream of
  its own, then the per-rank maps are all-gathered so that every rank holds
  the whole map, tiled in rank order;
* eye pass and gathers: the pixels are sharded over the same ranks
  (`render_sppm(pixel_sharding=mesh)`); the map is whole on every rank, so
  the gathers need no further communication;
* the per-pixel state is sharded with the pixels and assembled only for the
  image, the debug images and the checkpoints.

The rank streams are seeded from one draw of the pass's generator, so the
sharded pass and `photon_pass_local`, which traces the same streams in one
process, leave that generator in the same state and give the same map.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from gpu_pathtracer_tpu_torch.constants import MATERIAL_STACK_SIZE
from gpu_pathtracer_tpu_torch.parallel.shard import Mesh, make_mesh, shard_seed
from gpu_pathtracer_tpu_torch.render import sppm as sppm_mod

# the namespace of the photon streams: far from the small integers that
# `pass_generator` and `step_generator` add to their seeds, and under bit 63
# (see `shard_seed`) apart from every seed of theirs
PHOTON_TAG = 0x5BBD << 12
_FLOAT_FIELDS = ("pos", "color", "direction", "prev")


def photon_base_seed(generator: torch.Generator) -> int:
    """The one draw from the pass's generator that seeds its rank streams."""
    return int(torch.randint(0, 2**62, (), generator=generator, device=generator.device))


def photon_stream(base: int, rank: int, device) -> torch.Generator:
    """Rank `rank`'s photon stream under `base`."""
    return torch.Generator(device=device).manual_seed(shard_seed(base, rank, PHOTON_TAG))


def photon_pass_distributed(
    scene,
    n_photons: int,
    mesh: Mesh,
    max_bounce: int = 16,
    stack_size: int = MATERIAL_STACK_SIZE,
    generator: torch.Generator | None = None,
    uniforms=None,
    differentiable: bool = False,
) -> sppm_mod.Photons:
    """Photon tracing sharded over `mesh`; returns the whole photon map on
    every rank, each field tiled in rank order along the photon axis.

    `n_photons` is the whole budget and must divide by the mesh size.  Rank r
    traces its share from `photon_stream(photon_base_seed(generator), r)`,
    or, with `uniforms` (`photon_pass`'s layout at the share's width), from
    those: then the caller hands each rank its own and no draw is taken.
    With `differentiable` the float fields are gathered so that a rank's
    deposits receive the gradient of every rank's loss (`Mesh.gather_map`:
    the surface gather reads the colours on every rank, so every rank
    reaches the backward)."""
    if n_photons % mesh.size:
        raise ValueError(f"{n_photons} photons do not split over {mesh.size} ranks")
    local = n_photons // mesh.size
    kw = dict(max_bounce=max_bounce, stack_size=stack_size, differentiable=differentiable)
    if uniforms is not None:
        photons = sppm_mod.photon_pass(scene, local, uniforms=uniforms, **kw)
    else:
        base = photon_base_seed(generator)
        photons = sppm_mod.photon_pass(
            scene, local, generator=photon_stream(base, mesh.rank, scene.geom.p.device), **kw)
    floats = torch.cat([getattr(photons, f) for f in _FLOAT_FIELDS], dim=1)
    floats = mesh.gather_map(floats) if floats.requires_grad else mesh.all_gather(floats)
    flags = mesh.all_gather(torch.stack([photons.on_surface, photons.valid], dim=1))
    parts = {f: x.contiguous() for f, x in zip(_FLOAT_FIELDS, torch.split(floats, 3, dim=1))}
    return sppm_mod.Photons(**parts, on_surface=flags[:, 0], valid=flags[:, 1])


def photon_pass_local(
    scene,
    n_photons: int,
    n_shards: int,
    max_bounce: int = 16,
    stack_size: int = MATERIAL_STACK_SIZE,
    generator: torch.Generator | None = None,
    uniforms=None,
    differentiable: bool = False,
) -> sppm_mod.Photons:
    """The map of `photon_pass_distributed` on `n_shards` ranks, traced in
    this process: the same base draw from `generator`, every rank's stream
    in turn, the maps concatenated in rank order.  `uniforms`, when given,
    is a list of every rank's."""
    if n_photons % n_shards:
        raise ValueError(f"{n_photons} photons do not split over {n_shards} shards")
    local = n_photons // n_shards
    kw = dict(max_bounce=max_bounce, stack_size=stack_size, differentiable=differentiable)
    if uniforms is not None:
        maps = [sppm_mod.photon_pass(scene, local, uniforms=u, **kw) for u in uniforms]
    else:
        base = photon_base_seed(generator)
        maps = [sppm_mod.photon_pass(scene, local,
                                     generator=photon_stream(base, r, scene.geom.p.device), **kw)
                for r in range(n_shards)]
    return sppm_mod.Photons(**{f.name: torch.cat([getattr(m, f.name) for m in maps])
                               for f in dataclasses.fields(sppm_mod.Photons)})


def render_sppm_distributed(scene, camera, cfg, seed: int, mesh: Mesh | None = None,
                            output_prefix: str | None = None, pass_log=None):
    """Full SPPM render with the photon pass sharded over `mesh` (None:
    `make_mesh()`) and the pixels sharded over it too.  The estimator of
    `render_sppm`; the photon budget is rounded up to a multiple of the mesh
    size.  Returns the (H, W, 3) image as numpy on every rank; rank 0 writes
    the debug images."""
    mesh = mesh or make_mesh(device=scene.geom.p.device)
    n_phot = int(cfg.ppm_num_photon_per_pass)
    n_phot += (-n_phot) % mesh.size
    return sppm_mod.render_sppm(
        scene, camera, cfg, seed, output_prefix=output_prefix, n_photons_override=n_phot,
        pass_log=pass_log, photon_pass_fn=functools.partial(photon_pass_distributed, mesh=mesh),
        pixel_sharding=mesh)
