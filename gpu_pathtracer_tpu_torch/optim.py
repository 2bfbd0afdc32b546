"""Inverse rendering: optimize scene parameters against target images (port
of `gpu_pathtracer_tpu.optim`): the path-tracing loss (`render_loss_fn`) and
the loss through the photon mapper (`sppm_loss_fn`).

The estimator in `render.integrator.trace_paths` is pathwise-differentiable
(the sampled paths are fixed by the generator's state, the throughput
product is differentiated), so pixel gradients flow to any continuous
material/emitter/texture parameter.  `optimize` runs Adam over any subset of
MaterialTable fields with:

* a fresh generator per step (seeded from the run's seed and the step
  number), which re-randomizes the path set and gives an unbiased stochastic
  gradient;
* non-negativity projection after each update (reflectances/emissions);
* optional checkpoints (`torch.save`) so long runs resume.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re
from typing import Callable, Iterable, Mapping

import torch

from gpu_pathtracer_tpu_torch.render.integrator import render_image_value_and_grad
from gpu_pathtracer_tpu_torch.render.sppm import render_sppm_differentiable

# optax.adam's defaults, which differ from torch.optim.Adam's in nothing but
# being spelled out here
_ADAM = dict(betas=(0.9, 0.999), eps=1e-8)
_CHECKPOINT = re.compile(r"step_(\d+)\.pt")


def _get_param(materials, name: str) -> torch.Tensor:
    """Fetch an optimizable leaf by name.  Plain names are MaterialTable
    fields; `atlas_rgb` addresses the packed texture-atlas texels, so texture
    content is optimizable, not just per-material constants."""
    if name == "atlas_rgb":
        return materials.atlas.rgb
    return getattr(materials, name)


def _substitute(scene, params: Mapping[str, torch.Tensor]):
    plain = {k: v for k, v in params.items() if k != "atlas_rgb"}
    mats = scene.materials
    if plain:
        mats = dataclasses.replace(mats, **plain)
    if "atlas_rgb" in params:
        mats = dataclasses.replace(
            mats, atlas=dataclasses.replace(mats.atlas, rgb=params["atlas_rgb"])
        )
    return dataclasses.replace(scene, materials=mats)


def render_loss_fn(
    scene,
    camera,
    target: torch.Tensor,  # (H, W, 3) linear radiance
    width: int,
    height: int,
    sample_size: int = 4,
    level: int = 4,
    hittable_pdf_weight: float = 0.5,
) -> Callable:
    """(params, generator) -> (loss, grads): the L2 loss between render and
    target and its gradient to every tensor of `params` (a dict keyed like
    `optimize`'s `param_names`), by path replay
    (`render_image_value_and_grad`)."""
    target = target.detach()

    def value_and_grad(params, generator):
        names = list(params)
        leaves = [params[n].detach().requires_grad_(True) for n in names]
        loss, _, grads = render_image_value_and_grad(
            _substitute(scene, dict(zip(names, leaves))), camera, width, height,
            lambda img: torch.mean((img - target) ** 2), leaves,
            sample_size=sample_size, level=level,
            hittable_pdf_weight=hittable_pdf_weight, generator=generator,
        )
        return loss, dict(zip(names, grads))

    return value_and_grad


# Production sizes for `sppm_loss_fn`: at 256^2 pixels pixels * photons
# crosses `render.sppm.GRID_MIN_PAIRS` and the render takes the hash-grid
# gathers.  Pass **SPPM_LOSS_PRODUCTION for real optimization runs; the
# function's own defaults stay small, so a caller on the CPU does not pick up
# a ~100x cost by accident.
SPPM_LOSS_PRODUCTION = dict(n_photons=16384, num_pass=4, max_bounce=12, eye_bounce=12)


def sppm_loss_fn(
    scene,
    camera,
    target: torch.Tensor,  # (H, W, 3) linear radiance
    n_photons: int = 512,
    num_pass: int = 2,
    max_bounce: int = 8,
    eye_bounce: int = 8,
    seed: int = 0,
    **sppm_kw,
) -> Callable:
    """(params, generator) -> (loss, grads): the L2 loss between a
    differentiable SPPM render (`render_sppm_differentiable`, emitter
    optimization through the photon mapper) and `target`, and its gradient
    to every tensor of `params` (keyed like `optimize`'s `param_names`).

    The render's random streams come from `seed` when the generator is None,
    else from a seed drawn from the generator (`optimize` hands each step a
    generator of its own, so every step traces other photons).  Defaults are
    small; real runs pass `**SPPM_LOSS_PRODUCTION` or explicit sizes.

    `sppm_kw` go to the render, among them its scale-out hooks
    `photon_pass_fn` (`parallel.sppm_shard.photon_pass_distributed`) and
    `pixel_sharding` (a `parallel.shard.Mesh`): every rank then computes the
    loss of the whole image, the mean over all pixels, and the gradients of
    the ranks' own pixels are summed over the ranks once, so every rank
    returns the same loss and gradients."""
    target = target.detach()
    mesh = sppm_kw.get("pixel_sharding")

    def value_and_grad(params, generator=None):
        names = list(params)
        leaves = [params[n].detach().requires_grad_(True) for n in names]
        run_seed = seed
        if generator is not None:
            run_seed = int(torch.randint(0, 2**31 - 1, (), generator=generator,
                                         device=generator.device))
        img = render_sppm_differentiable(
            _substitute(scene, dict(zip(names, leaves))), camera, width=target.shape[1],
            height=target.shape[0], n_photons=n_photons, num_pass=num_pass,
            max_bounce=max_bounce, eye_bounce=eye_bounce, seed=run_seed, **sppm_kw,
        )
        loss = torch.mean((img - target) ** 2)
        grads = torch.autograd.grad(loss, leaves)
        if mesh is not None:
            grads = [mesh.all_reduce(g) for g in grads]
        return loss.detach(), dict(zip(names, grads))

    return value_and_grad


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one optimization step: a stream of its own per
    (seed, step), so a resumed run draws what an uninterrupted one would."""
    return torch.Generator(device=device).manual_seed((seed << 20) + step)


def optimize(
    scene,
    camera,
    target: torch.Tensor,
    param_names: Iterable[str] = ("ke",),
    steps: int = 50,
    lr: float = 5e-2,
    seed: int = 0,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 25,
    loss_fn: Callable | None = None,
    **render_kw,
):
    """Adam-optimize MaterialTable fields to match `target`.

    Returns (params, losses).  With `checkpoint_dir`, saves (step, params,
    optimizer state) with `torch.save` every `checkpoint_every` steps and at
    the last, keeps the two newest, and resumes from the latest checkpoint if
    one exists.  `loss_fn` overrides the default path-tracing L2 loss; it
    maps (params, generator) to (loss, grads) as `render_loss_fn`'s does.
    """
    device = scene.geom.p.device
    params = {
        name: _get_param(scene.materials, name).detach().clone().requires_grad_(True)
        for name in param_names
    }
    if loss_fn is None:
        loss_fn = render_loss_fn(
            scene, camera, target, width=target.shape[1], height=target.shape[0], **render_kw
        )
    opt = torch.optim.Adam(list(params.values()), lr=lr, **_ADAM)
    start_step = 0

    ckpt = pathlib.Path(checkpoint_dir) if checkpoint_dir is not None else None
    if ckpt is not None:
        ckpt.mkdir(parents=True, exist_ok=True)
        saved = _saved_steps(ckpt)
        if saved:
            state = torch.load(ckpt / f"step_{saved[-1]}.pt", map_location=device,
                               weights_only=True)
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(state["params"][name])
            opt.load_state_dict(state["opt_state"])
            start_step = saved[-1] + 1

    losses = []
    for i in range(start_step, steps):
        loss, grads = loss_fn(params, step_generator(seed, i, device))
        for name, p in params.items():
            p.grad = grads[name]
        opt.step()
        with torch.no_grad():
            for p in params.values():
                p.clamp_(min=0.0)
        losses.append(float(loss))
        if ckpt is not None and (i % checkpoint_every == 0 or i == steps - 1):
            state = {"params": {k: v.detach() for k, v in params.items()},
                     "opt_state": opt.state_dict()}
            torch.save(state, ckpt / f"step_{i}.pt")
            for old in _saved_steps(ckpt)[:-2]:
                (ckpt / f"step_{old}.pt").unlink()
    return {k: v.detach() for k, v in params.items()}, losses


def _saved_steps(folder: pathlib.Path) -> list[int]:
    return sorted(
        int(m.group(1)) for p in folder.iterdir() if (m := _CHECKPOINT.fullmatch(p.name))
    )
