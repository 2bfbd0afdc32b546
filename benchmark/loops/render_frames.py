"""Window loop: whole frames through the port's `render_image`.

Set-up builds the configuration's scene once (its generator writes the
OBJ/MTL inputs; the port reads them with its own loader and `build_scene`), the
camera (`Camera.create`), and renders one sample of the frame at the cell's
own shapes, which builds the closest-hit kernel the scene routes to and
warms the allocator.  A unit of work is one frame: `render_image` under
`torch.no_grad()` with `ray_chunk` = W*H (the frame is one wavefront), its
own generator seeded from the run's seed and the frame's index, ended by a
device synchronisation and a copy of the image to the host, where a
renderer delivers it.  Its work is W*H*spp*dof*level ray segments.

The check: after the window, a sample of (frame, pixel) pairs drawn from the
seed is judged against `reference/pathtrace.py`, which works the scene out
again from the generator's output and replays each pixel's paths from the
frame's own uniforms (`check.py`).
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import check  # noqa: E402
from reference import pathtrace, scene_input  # noqa: E402

CHECK_PIXELS = 2048  # (frame, pixel) pairs judged a run
CHECK_FRAMES = 4  # frames they are spread over, at most


def frame_seed(seed: int, index: int) -> int:
    """The generator seed of frame `index` of a run seeded `seed` (the
    warm-up is index -1)."""
    return (int(seed) * 0x9E3779B1 + index + 2) % (1 << 63)


def load_module(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(f"bench_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Loop:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        t = traffic
        self.width, self.height = t["width"], t["height"]
        self.work_per_unit = self.width * self.height * t["spp"] * t["dof_sample_size"] * t["level"]
        self.frames: list[torch.Tensor] = []  # host images, (H, W, 3)
        self.failed = 0
        self.render = None  # `render_image`, bound at set-up
        self._tmp = None

    # -- set-up ----------------------------------------------------------

    def setup(self) -> None:
        from gpu_pathtracer_tpu_torch.models.camera import Camera
        from gpu_pathtracer_tpu_torch.models.scene import build_scene
        from gpu_pathtracer_tpu_torch.render.integrator import render_image
        from gpu_pathtracer_tpu_torch.utils import obj_io

        self.render = render_image
        scene_cfg = self.config["scene"]
        generator = load_module(BENCH / "scenes" / f"{scene_cfg['generator']}.py")
        # the inputs stay on disk until the check has read them
        self._tmp = tempfile.TemporaryDirectory(prefix="bench-scene-")
        self.inputs = generator.make(self._tmp.name, **scene_cfg.get("params", {}))
        self.scene = build_scene(obj_io.load_scene(self.inputs["folder"], self.inputs["obj"]),
                                 self.device)
        cam = self.config["camera"]
        self.camera = Camera.create(cam["eye"], cam["center"], cam["up"], cam["fovy_deg"],
                                    self.width, self.height, device=self.device)
        self._render(-1, sample_size=1)
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _render(self, index: int, sample_size: int | None = None) -> torch.Tensor:
        t = self.traffic
        gen = torch.Generator(device=self.device).manual_seed(frame_seed(self.seed, index))
        with torch.no_grad():
            return self.render(
                self.scene, self.camera, self.width, self.height,
                sample_size=t["spp"] if sample_size is None else sample_size,
                dof_sample_size=t["dof_sample_size"], level=t["level"],
                hittable_pdf_weight=t["hittable_pdf_weight"],
                ray_chunk=self.width * self.height, generator=gen)

    # -- the window --------------------------------------------------------

    def unit(self) -> None:
        """One frame, dispatched, waited for and copied to the host."""
        index = len(self.frames)
        try:
            img = self._render(index)
            self._sync()
            finite = bool(torch.isfinite(img).all())
            host = img.cpu()
        except Exception as exc:  # a frame that raises counts as failed; the run goes on
            print(f"frame {index} raised: {exc!r}", file=sys.stderr)
            host, finite = None, False
        self.frames.append(host)
        self.failed += int(not finite)

    # -- the check -----------------------------------------------------------

    def release(self) -> None:
        """Free the program's device state before the reference runs."""
        self.scene = self.camera = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list[tuple[int, np.ndarray]]:
        """(frame index, pixel indices) pairs to judge, drawn from the seed."""
        done = [i for i, f in enumerate(self.frames) if f is not None]
        if not done:
            return []
        rng = np.random.default_rng([self.seed % (1 << 63), 0x5EED])
        picked = sorted(rng.choice(done, size=min(CHECK_FRAMES, len(done)), replace=False))
        n_pix = self.width * self.height
        per = min(CHECK_PIXELS // len(picked), n_pix)
        return [(int(f), np.sort(rng.choice(n_pix, size=per, replace=False))) for f in picked]

    def reference_pixels(self, pairs, dtype=torch.float32) -> np.ndarray:
        """The reference's values of the pairs' pixels, (sum K, 3)."""
        ref_scene = pathtrace.build_scene(scene_input.read_scene(self.inputs), self.device, dtype)
        out = []
        for f, pix in pairs:
            pix_t = torch.as_tensor(pix, device=self.device)
            out.append(pathtrace.render_pixels(ref_scene, self.config["camera"], self.traffic,
                                               frame_seed(self.seed, f), pix_t, dtype).cpu())
        return torch.cat(out).numpy()

    def program_pixels(self, pairs) -> np.ndarray:
        return np.concatenate([self.frames[f].reshape(-1, 3)[pix].numpy() for f, pix in pairs])

    def check(self, reference_dtype=torch.float32) -> dict:
        """{"correct", "attempted", "failed", "checks": {name: {value, limit, rule}},
        "seconds"}; `reference_dtype` other than float32 puts the reference
        computed in that precision in the program's place (the control)."""
        t0 = time.perf_counter()
        limit = self.config["check"]["mismatch_share"]
        pairs = self.sample()
        share, lit = 1.0, 0
        if pairs:
            ref = self.reference_pixels(pairs)
            prog = (self.program_pixels(pairs) if reference_dtype == torch.float32
                    else self.reference_pixels(pairs, reference_dtype))
            share, lit = check.mismatch_share(prog, ref)
        attempted = len(self.frames)
        checks = {
            "mismatch_share": {"value": share, "limit": limit, "rule": "<="},
            "failed_frames": {"value": self.failed, "limit": 0, "rule": "<="},
            "lit_pixels": {"value": lit, "limit": 1, "rule": ">="},
        }
        correct = (attempted > 0 and lit >= 1 and self.failed == 0 and share <= limit)
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None
        return {"correct": bool(correct), "attempted": attempted, "failed": self.failed,
                "checks": checks, "seconds": time.perf_counter() - t0}
