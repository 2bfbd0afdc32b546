"""Image output.

ASCII PPM (P3) writer with sqrt gamma and clamping, matching the reference
(`src/util/image_util.h:50-72`), plus a PNG convenience writer.
"""

from __future__ import annotations

import pathlib

import numpy as np


def tonemap(image: np.ndarray) -> np.ndarray:
    """sqrt gamma, clamp to [0, 1) like the reference (255.99 scale)."""
    img = np.sqrt(np.clip(np.nan_to_num(np.asarray(image, np.float32)), 0.0, None))
    return np.clip(img, 0.0, 0.999999)


def save_ppm(image: np.ndarray, path: str | pathlib.Path) -> None:
    """Write (H, W, 3) linear-radiance image as ASCII PPM (image_util.h:50).

    Uses the native writer (csrc/image_io.cpp) when built."""
    from gpu_pathtracer_tpu_torch.utils import native

    if native.write_ppm_native(path, np.nan_to_num(np.asarray(image, np.float32))):
        return
    img = tonemap(image)
    h, w = img.shape[:2]
    ints = (255.99 * img).astype(np.int32)
    lines = [f"P3\n{w} {h}\n255\n"]
    flat = ints.reshape(-1, 3)
    lines.extend(f"{r} {g} {b}\n" for r, g, b in flat)
    pathlib.Path(path).write_text("".join(lines))


def save_png(image: np.ndarray, path: str | pathlib.Path) -> None:
    from PIL import Image

    img = (tonemap(image) * 255.99).astype(np.uint8)
    Image.fromarray(img).save(str(path))


def load_ppm(path: str | pathlib.Path) -> np.ndarray:
    """Read an ASCII PPM back into a (H, W, 3) uint8 array (for golden tests)."""
    tokens = pathlib.Path(path).read_text().split()
    assert tokens[0] == "P3"
    w, h, maxv = int(tokens[1]), int(tokens[2]), int(tokens[3])
    data = np.asarray(tokens[4 : 4 + w * h * 3], np.int32).reshape(h, w, 3)
    assert maxv == 255
    return data.astype(np.uint8)
