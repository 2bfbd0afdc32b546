#!/usr/bin/env python3
"""Where the card and the CPU part on the same uniforms (`chip_smoke.py`
phases 5 and 17).

    python3 scripts/split_card_cpu.py [--level 8] [--uniforms FILE.npy] [--out FILE.json]
    python3 scripts/split_card_cpu.py --diff-sppm [--out FILE.json]

Runs phase 5's query -- the Cornell box with spheres (972 triangles), 32x32
camera rays through the pixel centres, `trace_paths` at level 8 with
hittable_pdf_weight 0.5 and the uniforms of `torch.Generator` seed 3 (or
FILE, (level, 8, 1024) float32) -- on the card and on the CPU, each under a
recorder that logs every torch operation with its inputs and output, in
order.  The closest-hit query counts as one operation (the card answers it
with a kernel, the CPU with the plain version).  Then it reports:

- the two scenes' tensors, card against CPU;
- the rays that split (not allclose at rtol 1e-4, atol 1e-5: phase 5's
  test);
- the first operation whose output differs at all, and the first whose rows
  of split rays differ: its name, bounce, shapes and non-tensor arguments,
  how many elements differ, whether its tensor inputs were equal on both
  sides, and each side's largest error in float32 ulps against the same
  operation replayed in float64 on the CPU;
- the operations that differ with equal inputs, by name, with their largest
  ulp error on each side;
- per bounce for each split ray, on both sides: the closest hit (slot, t),
  the BSDF lobe (diffuse 1, reflected 2, refracted 4, false hit 8) and the
  light-tree leaf the NEE picked.

`--diff-sppm` records phase 17's same-uniforms render instead: the SPPM box
(72 triangles), `render_sppm_differentiable` at 32x32 with 1,024 photons, 2
passes, 8 photon and 8 eye bounces and the grid gathers, from the uniforms
that phase 17 draws on the CPU (`chip_smoke.diff_sppm_uniforms` seed 17),
with the emission table `ke` a leaf of autograd.  The forward is recorded,
with each closest-hit query (`trace.closest_hit`) and each any-hit query
(`trace.occluded_window`) as one operation; it reports the pixels that split
(not allclose at rtol 1e-4, atol 1e-6: phase 17's test), the first
operation that differs, its inputs, the ulp errors and the operations that
differ with equal inputs as above, and the gradient d mean / d ke on both
sides.  Its "split rays" are pixels; an operation's rows count as pixels
where its first dimension is 1,024, which the photon arrays share.

Writes the record to --out (JSON) and prints a summary.  Needs a CUDA card;
prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

import chip_smoke  # noqa: E402
from gpu_pathtracer_tpu_torch import optim  # noqa: E402
from gpu_pathtracer_tpu_torch.device import require_cuda  # noqa: E402
from gpu_pathtracer_tpu_torch.models import convert  # noqa: E402
from gpu_pathtracer_tpu_torch.models.camera import Camera  # noqa: E402
from gpu_pathtracer_tpu_torch.models.scene import build_scene  # noqa: E402
from gpu_pathtracer_tpu_torch.ops import lights, materials, trace  # noqa: E402
from gpu_pathtracer_tpu_torch.render import integrator, sppm  # noqa: E402
from gpu_pathtracer_tpu_torch.utils import config, obj_io, testscenes  # noqa: E402

SIDE, WEIGHT = 32, 0.5


def snap(x):
    """A CPU copy of every tensor in x (tuples and lists walked, other
    leaves kept as they are)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, (tuple, list)):
        return tuple(snap(v) for v in x)
    if isinstance(x, dict):
        return {k: snap(v) for k, v in x.items()}
    return x


def tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in tensors(v)]
    return []


class Recorder(TorchFunctionMode):
    """Logs (name, bounce, inputs, output) of every torch operation whose
    output holds a tensor; `opaque` runs a function as one such operation."""

    def __init__(self):
        super().__init__()
        self.ops, self.paused, self.bounce = [], 0, -1
        self.records = []  # per bounce: {"slot", "t", "lobe", "leaf"}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused:
            o = snap(out)
            if tensors(o):
                self.ops.append((getattr(func, "__name__", str(func)), self.bounce, func,
                                 snap(args), snap(kwargs or {}), o))
        return out

    def opaque(self, name, fn, *args, **kwargs):
        self.paused += 1
        try:
            out = fn(*args, **kwargs)
            self.ops.append((name, self.bounce, None, snap(args), {}, snap(out)))
        finally:
            self.paused -= 1
        return out


def run(scene, o, d, uni, level):
    """trace_paths under a Recorder; returns (radiance, recorder)."""
    rec = Recorder()
    orig = (trace.closest_hit, materials.sample_bsdf, lights.pick_light_dense)

    def closest_hit(*args, **kwargs):
        rec.bounce += 1
        t, slot, bary, hit = rec.opaque("closest_hit", orig[0], *args, **kwargs)
        rec.paused += 1
        rec.records.append({"slot": slot.cpu(), "t": t.cpu()})
        rec.paused -= 1
        return t, slot, bary, hit

    def sample_bsdf(*args, **kwargs):
        ref = orig[1](*args, **kwargs)
        rec.paused += 1
        rec.records[-1]["lobe"] = (ref.diffuse.int() + 2 * ref.reflected.int()
                                   + 4 * ref.refracted.int() + 8 * ref.false_hit.int()).cpu()
        rec.paused -= 1
        return ref

    def pick_light_dense(*args, **kwargs):
        leaf = orig[2](*args, **kwargs)
        rec.paused += 1
        rec.records[-1]["leaf"] = leaf.reshape(-1).cpu()
        rec.paused -= 1
        return leaf

    trace.closest_hit, materials.sample_bsdf, lights.pick_light_dense = (
        closest_hit, sample_bsdf, pick_light_dense)
    try:
        with torch.no_grad(), rec:
            col = integrator.trace_paths(scene, o, d, level=level, hittable_pdf_weight=WEIGHT,
                                         uniforms=uni)
    finally:
        trace.closest_hit, materials.sample_bsdf, lights.pick_light_dense = orig
    return col.cpu(), rec


def run_diff_sppm(scene, cam, kw, uniforms):
    """render_sppm_differentiable under a Recorder, `ke` a leaf of autograd;
    returns (image, d mean / d ke, recorder)."""
    rec = Recorder()
    orig = (trace.closest_hit, trace.occluded_window)

    def closest_hit(*args, **kwargs):
        rec.bounce += 1
        return rec.opaque("closest_hit", orig[0], *args, **kwargs)

    def occluded_window(*args, **kwargs):
        return rec.opaque("occluded_window", orig[1], *args, **kwargs)

    ke = scene.materials.ke.detach().clone().requires_grad_(True)
    trace.closest_hit, trace.occluded_window = closest_hit, occluded_window
    try:
        with rec:
            img = sppm.render_sppm_differentiable(optim._substitute(scene, {"ke": ke}), cam, **kw,
                                                  gather_grid=True, uniforms=uniforms)
    finally:
        trace.closest_hit, trace.occluded_window = orig
    (grad,) = torch.autograd.grad(img.mean(), ke)
    return img.detach().cpu(), grad.cpu(), rec


def differs(a, b):
    """Elements of two equal-shaped tensors that differ (NaN equals NaN)."""
    if a.is_floating_point():
        return ~((a == b) | (torch.isnan(a) & torch.isnan(b)))
    return a != b


def scene_differences(scene_gpu, scene_cpu) -> dict:
    """{scene tensor: elements that differ} card against CPU (-1: the shapes
    differ)."""
    flat_g, flat_c = convert.scene_to_numpy(scene_gpu), convert.scene_to_numpy(scene_cpu)
    out = {}
    for k, c in flat_c.items():
        n = (int(differs(torch.from_numpy(flat_g[k]), torch.from_numpy(c)).sum())
             if flat_g[k].shape == c.shape else -1)
        if n:
            out[k] = n
    return out


def same_inputs(a, b):
    ta, tb = tensors(snap(a)), tensors(snap(b))
    return len(ta) == len(tb) and all(x.shape == y.shape and not bool(differs(x, y).any())
                                      for x, y in zip(ta, tb))


def ulp_errors(func, args, kwargs, outs):
    """Each side's largest error in float32 ulps against func replayed in
    float64 on the CPU, over the float32 elements of the first output
    tensor; None when the operation does not replay."""
    def f64(x):
        if isinstance(x, torch.Tensor):
            return x.double() if x.dtype == torch.float32 else x
        if isinstance(x, tuple):
            return tuple(f64(v) for v in x)
        return x

    try:
        ref = tensors(snap(func(*f64(args), **{k: f64(v) for k, v in kwargs.items()})))[0]
    except Exception:  # noqa: BLE001 - an operation that takes no float64 inputs
        return None
    errs = []
    for out in outs:
        x = tensors(out)[0]
        if x.dtype != torch.float32 or x.shape != ref.shape:
            return None
        r32 = ref.float()
        ulp = (torch.nextafter(r32.abs(), torch.tensor(float("inf"))) - r32.abs()).double()
        e = ((x.double() - ref).abs() / ulp)[torch.isfinite(ref)]
        errs.append(float(e.max()) if e.numel() else 0.0)
    return errs


def compare(gpu, cpu, split_rows, r):
    """Walks the two op logs in order; returns the report."""
    first_any = first_split = parted = None
    by_name = {}
    n = min(len(gpu.ops), len(cpu.ops))
    for i in range(n):
        (name, bounce, func, args_g, kw_g, out_g), (name_c, _, _, args_c, kw_c, out_c) = (
            gpu.ops[i], cpu.ops[i])
        if name != name_c:
            parted = dict(index=i, card=name, cpu=name_c, bounce=bounce)
            break
        tg, tc = tensors(out_g), tensors(out_c)
        if len(tg) != len(tc) or any(a.shape != b.shape for a, b in zip(tg, tc)):
            parted = dict(index=i, card=name, cpu=name_c, bounce=bounce, shapes_differ=True)
            break
        masks = [differs(a, b) for a, b in zip(tg, tc)]
        n_diff = sum(int(m.sum()) for m in masks)
        if not n_diff:
            continue
        hits_split = any(m.shape[:1] == (r,) and bool(m.reshape(r, -1)[split_rows].any())
                         for m in masks)
        equal_in = same_inputs(args_g, args_c) and same_inputs(tuple(kw_g.values()),
                                                               tuple(kw_c.values()))
        entry = dict(index=i, name=name, bounce=bounce, elements_differ=n_diff,
                     inputs_equal=equal_in, output_shapes=[list(t.shape) for t in tg],
                     input_shapes=[list(t.shape) for t in tensors(args_c)],
                     arguments=[a for a in args_c if not isinstance(a, torch.Tensor)]
                     + list(kw_c.items()))
        if equal_in:
            entry["ulps_card_cpu"] = (ulp_errors(func, args_c, kw_c, (out_g, out_c))
                                      if func is not None else None)
            agg = by_name.setdefault(name, dict(count=0, ulps_card=0.0, ulps_cpu=0.0,
                                                first_index=i))
            agg["count"] += 1
            if entry["ulps_card_cpu"] is not None:
                agg["ulps_card"] = max(agg["ulps_card"], entry["ulps_card_cpu"][0])
                agg["ulps_cpu"] = max(agg["ulps_cpu"], entry["ulps_card_cpu"][1])
        if first_any is None:
            first_any = entry
        if first_split is None and hits_split:
            first_split = entry
    return dict(ops_card=len(gpu.ops), ops_cpu=len(cpu.ops), first_difference=first_any,
                first_difference_on_split_rays=first_split, op_sequences_part=parted,
                differ_with_equal_inputs=by_name)


def diff_sppm_split(dev, card: str, out_path: pathlib.Path) -> int:
    """The `--diff-sppm` mode (see the module docstring)."""
    folder = pathlib.Path(tempfile.mkdtemp(prefix="split_card_cpu_sppm_"))
    chip_smoke.sppm_box_master(folder, False, config, testscenes)
    host = obj_io.load_scene(folder, "box.obj")
    scenes = {"card": build_scene(host, dev), "cpu": build_scene(host, "cpu")}
    scene_diff = scene_differences(scenes["card"], scenes["cpu"])
    side, photons = chip_smoke.DIFF_SAME["side"], chip_smoke.DIFF_SAME["photons"]
    kw = dict(width=side, height=side, n_photons=photons, num_pass=chip_smoke.DIFF_SPPM["passes"],
              max_bounce=chip_smoke.DIFF_SPPM["max_bounce"],
              eye_bounce=chip_smoke.DIFF_SPPM["eye_bounce"])
    uniforms = chip_smoke.diff_sppm_uniforms(17, kw)
    res = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        cam = Camera.create(**chip_smoke.CORNELL_CAM, width=side, height=side, device=d)
        res[name] = run_diff_sppm(scenes[name], cam, kw, uniforms)
    (img_g, grad_g, rec_g), (img_c, grad_c, rec_c) = res["card"], res["cpu"]
    r = side * side
    match = torch.isclose(img_g, img_c, rtol=1e-4, atol=1e-6).all(dim=-1).reshape(-1)
    split_rows = torch.nonzero(~match)[:, 0]
    report = compare(rec_g, rec_c, split_rows, r)
    grad_rel = float((grad_g - grad_c).norm() / grad_c.norm())
    out = dict(card=card, torch=torch.__version__, mode="diff_sppm", size=side, photons=photons,
               uniforms="chip_smoke.diff_sppm_uniforms seed 17", pixels=r,
               match_share=float(match.float().mean()), split_pixels=split_rows.tolist(),
               split_pixel_values={p: {"card": img_g.reshape(r, 3)[p].tolist(),
                                       "cpu": img_c.reshape(r, 3)[p].tolist()}
                                   for p in split_rows.tolist()},
               grad_card=grad_g.tolist(), grad_cpu=grad_c.tolist(), grad_rel=grad_rel,
               closest_hit_queries=rec_g.bounce + 1, scene_tensors_differ=scene_diff, **report)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=1, default=str))
    print(f"{r} pixels, {photons} photons: {out['match_share']:.4f} match card vs CPU; split "
          f"pixels {split_rows.tolist()}; |grad card - grad CPU| / |grad CPU| {grad_rel:.2e}",
          flush=True)
    print(f"scene tensors that differ: {scene_diff or 'none'}", flush=True)
    for key in ("op_sequences_part", "first_difference", "first_difference_on_split_rays"):
        print(f"{key}: {report[key]}", flush=True)
    print(f"operations {report['ops_card']} (card) / {report['ops_cpu']} (CPU); differing with "
          f"equal inputs: {json.dumps(report['differ_with_equal_inputs'])}", flush=True)
    print(f"record: {out_path}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--level", type=int, default=8)
    ap.add_argument("--uniforms", type=pathlib.Path, default=None)
    ap.add_argument("--diff-sppm", action="store_true",
                    help="record phase 17's same-uniforms differentiable SPPM render instead")
    ap.add_argument("--out", type=pathlib.Path, default=pathlib.Path("chiprun_out/split_card_cpu.json"))
    args = ap.parse_args()
    dev = require_cuda()
    card = chip_smoke.nvidia_smi()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    if args.diff_sppm:
        out = args.out
        if out == ap.get_default("out"):
            out = out.with_name(f"{out.stem}_diff_sppm.json")
        return diff_sppm_split(dev, card, out)

    folder = pathlib.Path(tempfile.mkdtemp(prefix="split_card_cpu_"))
    testscenes.make_cornell_box(folder, spheres=True, sphere_subdiv=2)
    host = obj_io.load_scene(folder, "box.obj")
    scene_gpu, scene_cpu = build_scene(host, dev), build_scene(host, "cpu")
    scene_diff = scene_differences(scene_gpu, scene_cpu)

    cam = Camera.create(**chip_smoke.CORNELL_CAM, width=SIDE, height=SIDE)
    ii, jj = torch.meshgrid(torch.arange(float(SIDE)), torch.arange(float(SIDE)), indexing="ij")
    r = SIDE * SIDE
    o, d = cam.generate_rays(ii.reshape(-1) + 0.5, jj.reshape(-1) + 0.5, torch.zeros(r),
                             torch.zeros(r))
    if args.uniforms is not None:
        uni = torch.from_numpy(np.load(args.uniforms)).float()
    else:
        uni = torch.rand((args.level, integrator.N_UNIFORMS, r),
                         generator=torch.Generator().manual_seed(3))
    col_gpu, rec_gpu = run(scene_gpu, o.to(dev), d.to(dev), uni.to(dev), args.level)
    col_cpu, rec_cpu = run(scene_cpu, o, d, uni, args.level)
    match = torch.isclose(col_gpu, col_cpu, rtol=1e-4, atol=1e-5).all(dim=-1)
    split_rows = torch.nonzero(~match)[:, 0]
    report = compare(rec_gpu, rec_cpu, split_rows, r)

    per_ray = {}
    for ray in split_rows.tolist():
        per_ray[ray] = {
            "color_card": col_gpu[ray].tolist(), "color_cpu": col_cpu[ray].tolist(),
            "bounces": [{side: {k: (v[ray].item() if v.dim() else v.item())
                                for k, v in rec.records[b].items()}
                         for side, rec in (("card", rec_gpu), ("cpu", rec_cpu))}
                        for b in range(min(len(rec_gpu.records), len(rec_cpu.records)))]}
        # the first bounce at which the two sides' records part
        part = [b for b, rec in enumerate(per_ray[ray]["bounces"]) if rec["card"] != rec["cpu"]]
        per_ray[ray]["first_bounce_apart"] = part[0] if part else None
    out = dict(card=card, torch=torch.__version__, level=args.level,
               uniforms=str(args.uniforms or "torch.Generator seed 3"), rays=r,
               match_share=float(match.float().mean()), split_rays=split_rows.tolist(),
               scene_tensors_differ=scene_diff, **report, split_ray_records=per_ray)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1, default=str))

    print(f"{r} rays, level {args.level}: {float(match.float().mean()):.4f} match card vs CPU; "
          f"split rays {split_rows.tolist()}", flush=True)
    print(f"scene tensors that differ: {scene_diff or 'none'}", flush=True)
    for key in ("op_sequences_part", "first_difference", "first_difference_on_split_rays"):
        print(f"{key}: {report[key]}", flush=True)
    print(f"operations {report['ops_card']} (card) / {report['ops_cpu']} (CPU); differing with "
          f"equal inputs: {json.dumps(report['differ_with_equal_inputs'])}", flush=True)
    for ray, rec in per_ray.items():
        print(f"ray {ray}: first bounce whose records part: {rec['first_bounce_apart']}; "
              f"card {rec['color_card']} cpu {rec['color_cpu']}", flush=True)
    print(f"record: {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
