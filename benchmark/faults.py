"""Faults planted in the timed path underneath the harness, to show that the
check that decides `correct` fails each of them: on the CPU at a small frame
(`tests/test_harness_correct.py`) and on the card at the cell's own size
(`control.py --faults`).  A benchmark run never imports this file.

`FAULTS[name](loop)` plants one fault into a loop that has been set up and
returns the function that takes it out again.
"""

from __future__ import annotations

import torch

FAULTS = {}


def _fault(plant):
    FAULTS[plant.__name__] = plant
    return plant


def _wrap_render(loop, broken):
    render = loop.render
    loop.render = broken(render)
    return lambda: setattr(loop, "render", render)


@_fault
def state_unchanged(loop):
    """A frame returns the state it had: the previous frame's image, or the
    zeros it started from."""
    def broken(render):
        last = []

        def call(*args, **kwargs):
            img = render(*args, **kwargs)
            out = last[0] if last else torch.zeros_like(img)
            last[:] = [img]
            return out
        return call
    return _wrap_render(loop, broken)


@_fault
def half_the_samples(loop):
    """Half of the batch of samples left out, the mean taken over the rest."""
    def broken(render):
        def call(*args, sample_size, **kwargs):
            return render(*args, sample_size=max(1, sample_size // 2), **kwargs)
        return call
    return _wrap_render(loop, broken)


@_fault
def answer_altered(loop):
    """The image off by 0.2% where it is produced."""
    def broken(render):
        def call(*args, **kwargs):
            return render(*args, **kwargs) * 1.002
        return call
    return _wrap_render(loop, broken)


def _wavefront_tail(share: float, stale: bool):
    """The last `share` of each wavefront's rays (the bottom rows of the
    frame: the wavefront is pixel-major) return nothing, or, `stale`, the
    previous sample's radiance."""
    def plant(loop):
        from gpu_pathtracer_tpu_torch.render import integrator

        original = integrator._chunk_sample
        last = []

        def broken(*args, **kwargs):
            col = original(*args, **kwargs)
            start = int(col.shape[0] * (1.0 - share))
            tail = last[0][start:] if stale and last else torch.zeros_like(col[start:])
            last[:] = [col]
            return torch.cat([col[:start], tail])
        integrator._chunk_sample = broken
        return lambda: setattr(integrator, "_chunk_sample", original)
    return plant


FAULTS["wavefront_half_zeroed"] = _wavefront_tail(0.5, stale=False)
FAULTS["wavefront_quarter_zeroed"] = _wavefront_tail(0.25, stale=False)
FAULTS["wavefront_quarter_stale"] = _wavefront_tail(0.25, stale=True)


@_fault
def glass_refraction_bent(loop):
    """The dielectric branch's refracted direction from an index ratio 2% off
    (every transparent material; the box's glass sphere)."""
    from gpu_pathtracer_tpu_torch.ops import materials

    original = materials._snell_out_dir

    def broken(v_in, normal, cos1, sin_ratio, sign):
        return original(v_in, normal, cos1, sin_ratio * 1.02, sign)
    materials._snell_out_dir = broken
    return lambda: setattr(materials, "_snell_out_dir", original)


@_fault
def metal_lobe_altered(loop):
    """One material's BSDF altered as the program holds it: the glossiest
    opaque material's (the box's metal sphere's) Phong exponent 10% low."""
    n_s = loop.scene.materials.n_s
    finite = torch.where(torch.isfinite(n_s), n_s, torch.zeros_like(n_s))
    row = int(torch.argmax(finite))
    before = n_s[row].clone()
    n_s[row] = before * 0.9

    def undo():
        if loop.scene is not None:
            loop.scene.materials.n_s[row] = before
    return undo
