"""ctypes loader for the native host runtime (csrc/libgpt_host.so).

The reference implements its host layer in C++ (OBJ/MTL parsers
`read_file_util.h`, PPM writer `image_util.h:50`, libjpeg wrapper
`external/libjpeg_cpp/`); this module exposes the equivalent native library
to Python.  The library is built on first use (a single g++ invocation) and
every entry point has a pure-Python fallback in `obj_io.py` / `image.py`, so
missing toolchains degrade gracefully.  Set GPT_TPU_NO_NATIVE=1 to force the
Python paths.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

_CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
_LIB_PATH = _CSRC / "libgpt_host.so"
_lib_cache: list = []  # [lib_or_None] once resolved


def _build() -> bool:
    try:
        res = subprocess.run(
            ["make", "-s", "-C", str(_CSRC)],
            capture_output=True,
            timeout=120,
        )
        return res.returncode == 0 and _LIB_PATH.exists()
    except Exception:
        return False


def get_lib():
    """The loaded native library, or None (unavailable / disabled)."""
    if _lib_cache:
        return _lib_cache[0]
    lib = None
    if not os.environ.get("GPT_TPU_NO_NATIVE"):
        try:
            if not _LIB_PATH.exists():
                _build()
            if _LIB_PATH.exists():
                lib = ctypes.CDLL(str(_LIB_PATH))
                _declare(lib)
        except Exception:
            lib = None
    _lib_cache.append(lib)
    return lib


def _declare(lib):
    c = ctypes
    lib.gpt_obj_count.argtypes = [c.c_char_p, c.POINTER(c.c_longlong)]
    lib.gpt_obj_count.restype = c.c_int
    lib.gpt_obj_parse.argtypes = [
        c.c_char_p, c.c_char_p, c.c_int,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_float), c.POINTER(c.c_float), c.POINTER(c.c_float),
    ]
    lib.gpt_obj_parse.restype = c.c_int
    lib.gpt_write_ppm.argtypes = [c.c_char_p, c.c_int, c.c_int, c.POINTER(c.c_float)]
    lib.gpt_write_ppm.restype = c.c_int
    lib.gpt_jpeg_size.argtypes = [c.c_char_p, c.POINTER(c.c_int), c.POINTER(c.c_int)]
    lib.gpt_jpeg_size.restype = c.c_int
    lib.gpt_jpeg_decode.argtypes = [c.c_char_p, c.POINTER(c.c_float), c.c_int]
    lib.gpt_jpeg_decode.restype = c.c_int


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def parse_obj_native(path, mat_names: list[str]):
    """Native two-pass OBJ parse.  Returns the same raw tuple layout as the
    Python tokenizer (absent vt/vn as -1), or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pathb = str(path).encode()
    counts = (ctypes.c_longlong * 5)()
    if lib.gpt_obj_count(pathb, counts) != 0:
        return None
    nv, nt, nn, ntri, _nobj = (int(counts[i]) for i in range(5))
    tri_vidx = np.empty((ntri, 3), np.int32)
    tri_tidx = np.empty((ntri, 3), np.int32)
    tri_nidx = np.empty((ntri, 3), np.int32)
    mat_idx = np.empty((ntri,), np.int32)
    object_idx = np.empty((ntri,), np.int32)
    verts = np.empty((nv, 3), np.float32)
    uvs = np.empty((nt, 2), np.float32)
    norms = np.empty((nn, 3), np.float32)
    names_blob = "\n".join(mat_names).encode()
    rc = lib.gpt_obj_parse(
        pathb, names_blob, len(mat_names),
        _iptr(tri_vidx), _iptr(tri_tidx), _iptr(tri_nidx),
        _iptr(mat_idx), _iptr(object_idx),
        _fptr(verts), _fptr(uvs), _fptr(norms),
    )
    if rc != 0:
        return None
    return tri_vidx, tri_tidx, tri_nidx, mat_idx, object_idx, verts, uvs, norms


def write_ppm_native(path, img: np.ndarray) -> bool:
    """P3 writer with sqrt gamma (image_util.h:50-72).  img (H, W, 3)."""
    lib = get_lib()
    if lib is None:
        return False
    img = np.ascontiguousarray(img, np.float32)
    h, w = img.shape[:2]
    return lib.gpt_write_ppm(str(path).encode(), h, w, _fptr(img)) == 0


def decode_jpeg_native(path, flip_rows: bool = False):
    """libjpeg decode -> (H, W, 3) float32 in [0, 1], or None."""
    lib = get_lib()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    pathb = str(path).encode()
    if lib.gpt_jpeg_size(pathb, ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.float32)
    if lib.gpt_jpeg_decode(pathb, _fptr(out), int(flip_rows)) != 0:
        return None
    return out
