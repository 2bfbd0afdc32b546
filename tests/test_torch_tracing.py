"""The port's tracer (`gpu_pathtracer_tpu_torch.tracing`) on the CPU: the span
tree of a frame, tracing off, the ring's bound, the counters, and the
benchmark's four readers of spans and counters.  Tiny frames; no JAX."""

from __future__ import annotations

import importlib.util
import pathlib
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpu_pathtracer_tpu_torch import tracing
from gpu_pathtracer_tpu_torch.models.camera import Camera
from gpu_pathtracer_tpu_torch.ops import _build
from gpu_pathtracer_tpu_torch.models.scene import build_scene
from gpu_pathtracer_tpu_torch.render.integrator import render_image
from gpu_pathtracer_tpu_torch.utils import obj_io, testscenes

REPO = pathlib.Path(__file__).resolve().parents[1]
W, H, SPP, LEVEL = 8, 4, 2, 2
CAM = dict(eye=(0.5, 0.5, 2.4), center=(0.5, 0.5, 0.0), up=(0, 1, 0), fovy_deg=40.0)
STEP_CHILDREN = ("dispatch.closest_hit", "shading.surface", "shading.nee", "shading.accumulate")
METRICS = ("host_syncs.fwd", "dispatch_ms.fwd", "nee_ms.fwd", "shading_ms.fwd")


def _scene(folder, make):
    obj, _ = make(folder)
    return build_scene(obj_io.load_scene(folder, obj), torch.device("cpu"))


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    return _scene(tmp_path_factory.mktemp("cornell"),
                  lambda f: testscenes.make_cornell_box(f, spheres=True, sphere_subdiv=1))


def _render(scene, seed=1):
    with torch.no_grad():
        return render_image(scene, Camera.create(**CAM, width=W, height=H), W, H,
                            sample_size=SPP, level=LEVEL, hittable_pdf_weight=0.5,
                            generator=torch.Generator().manual_seed(seed))


def _names(frame, span):
    return [c.name for c in frame.children(span)]


def test_a_profiled_frame_has_the_step_tree_and_reaches_the_profiler(cornell):
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render(cornell)
    (frame,) = tracing.frames()
    assert frame.root.name == "render.frame" and frame.root.parent is None
    assert len(frame.named("render.frame")) == 1
    assert _names(frame, frame.root) == ["integrator.sample"] * SPP  # one chunk a sample
    for sample in frame.named("integrator.sample"):
        steps = frame.children(sample)
        assert [s.name for s in steps] == ["integrator.step"] * LEVEL
        assert [s.attrs["bounce"] for s in steps] == list(range(LEVEL))
        for step in steps:
            assert tuple(_names(frame, step)) == STEP_CHILDREN
            (dispatch,) = [c for c in frame.children(step) if c.name == "dispatch.closest_hit"]
            assert _names(frame, dispatch) == ["kernel.closest_hit"]
    assert all(s.frame == frame.id and s.t0 <= s.t1 for s in frame.spans)
    assert {s.name for s in frame.spans} <= set(tracing.SPANS)
    assert all(s.device_ms is None for s in frame.spans)  # no CUDA events on the CPU
    annotations = [e.name() for e in prof.profiler.kineto_results.events()
                   if "user_annotation" in e.activity_type()]
    for name in {s.name for s in frame.spans}:
        assert annotations.count(name) == len(frame.named(name)), name


def test_tracing_off_records_nothing_and_leaves_the_image_bit_for_bit(cornell, monkeypatch):
    tracing.clear()
    with tracing.capture():
        on = _render(cornell)
    assert len(tracing.frames()) == 1

    def refuse(*args, **kwargs):
        raise AssertionError("tracing off touched the device or the profiler")

    for name in ("Event", "synchronize", "set_sync_debug_mode", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not tracing.enabled()
    assert tracing.span("shading.nee") is tracing.frame("render.frame", "cuda")  # one no-op
    off = _render(cornell)
    assert len(tracing.frames()) == 1 and torch.equal(on, off)


def test_the_ring_keeps_the_last_frames():
    tr = tracing.Tracer()
    with tr.capture():
        for _ in range(tracing.RING_FRAMES + 2):
            with tr.frame("render.frame", "cpu"):
                with tr.span("integrator.step", bounce=0):
                    pass
    frames = tr.frames()
    assert [f.id for f in frames] == list(range(2, tracing.RING_FRAMES + 2))
    assert all(len(f.spans) == 2 for f in frames)


def test_counters_go_to_the_innermost_open_span():
    tr = tracing.Tracer()
    tr.count("launch.closest_hit")  # off: the total alone
    with tr.capture(), tr.frame("render.frame", "cpu"):
        with tr.span("dispatch.closest_hit"):
            tr.count("host_sync")
            with tr.span("kernel.closest_hit"):
                tr.count("launch.closest_hit")
        tr.count("loop_exit", 2)
    (frame,) = tr.frames()
    assert frame.named("kernel.closest_hit")[0].counters == {"launch.closest_hit": 1}
    assert frame.named("dispatch.closest_hit")[0].counters == {"host_sync": 1}
    assert frame.root.counters == {"loop_exit": 2}
    assert (frame.counter("launch.closest_hit"), frame.counter("loop_exit")) == (1, 2)
    assert tr.totals == {"launch.closest_hit": 2, "host_sync": 1, "loop_exit": 2}
    assert tr.launches() == {k: 2 if k == "closest_hit" else 0 for k in _build.KERNELS}
    tr.reset("launch.")
    assert tr.counts("") == {"host_sync": 1, "loop_exit": 2}


def test_the_sparse_light_regimes_loop_exits_count_under_nee(tmp_path):
    """The collect walk's device questions, once `lights.host_syncs`, are the
    counter `loop_exit`, inside `shading.nee`."""
    scene = _scene(tmp_path, lambda f: testscenes.make_emitter_panel(f, nx=17, ny=16))
    assert not scene.light_tree.dense  # 544 emitters
    tracing.clear()
    tracing.reset("loop_exit")
    with tracing.capture():
        _render(scene)
    (frame,) = tracing.frames()
    by_span = {s.name for s in frame.spans if s.counters.get("loop_exit")}
    assert by_span == {"shading.nee"}
    assert frame.counter("loop_exit") == tracing.totals["loop_exit"] >= SPP * LEVEL


def _reader(name):
    path = REPO / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _stub_frame(tr, frame_id, ms):
    """A recorded CUDA frame of one step whose spans' device times are `ms`."""
    frame = tracing.Frame(frame_id, "render.frame", torch.device("cuda"))
    frame.sync_hook = True

    def add(name, parent):
        span = tracing.Span(tr, name, {}, parent, frame_id)
        span._device_ms = ms[name]
        frame.spans.append(span)
        return span

    root = add("render.frame", None)
    step = add("integrator.step", add("integrator.sample", root))
    dispatch = add("dispatch.closest_hit", step)
    dispatch.counters["host_sync"] = 2
    add("kernel.closest_hit", dispatch)
    for name in STEP_CHILDREN[1:]:
        add(name, step)
    frame.named("shading.surface")[0].counters["host_sync"] = 3
    return frame


def test_each_metric_reader_on_a_stub_run(monkeypatch):
    import types

    tr = tracing.Tracer()
    ms = {"render.frame": 50.0, "integrator.sample": 49.0, "integrator.step": 48.0,
          "dispatch.closest_hit": 10.0, "kernel.closest_hit": 4.0, "shading.surface": 12.0,
          "shading.nee": 20.0, "shading.accumulate": 5.0}
    older = _stub_frame(tr, 0, {k: 1000.0 for k in ms})  # not a traced frame: left out
    frames = [older, _stub_frame(tr, 1, ms), _stub_frame(tr, 2, {k: 2 * v for k, v in ms.items()})]
    monkeypatch.setattr(tracing.TRACER, "frames", lambda: list(frames))
    run = types.SimpleNamespace(units=2, trace=object())
    want = {"host_syncs.fwd": 5.0, "dispatch_ms.fwd": 9.0, "nee_ms.fwd": 30.0,
            "shading_ms.fwd": 25.5}
    assert {name: _reader(name)(run) for name in METRICS} == pytest.approx(want)
    # nothing recorded, no traced frame, or a program without the tracer
    assert all(_reader(name)(types.SimpleNamespace(units=0, trace=None)) is None
               for name in METRICS)
    monkeypatch.setattr(tracing.TRACER, "frames", lambda: [])
    assert all(_reader(name)(run) is None for name in METRICS)
    import gpu_pathtracer_tpu_torch

    monkeypatch.delattr(gpu_pathtracer_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "gpu_pathtracer_tpu_torch.tracing", None)
    assert all(_reader(name)(run) is None for name in METRICS)
