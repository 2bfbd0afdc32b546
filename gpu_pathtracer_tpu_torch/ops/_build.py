"""Build, load and launch (`launch`, the one caller) the port's CUDA kernels.

Each `csrc/<name>.cu` (`KERNELS`) exposes a plain C entry point
`gpt_<name>(..., stream)` that returns a cudaError_t, and is compiled with
`nvcc` into a shared library that `ctypes` loads (no PyTorch headers, so a
build takes seconds).  The library lands in
`build/torch_kernels/<content-hash>/lib<name>.so` inside the checkout, keyed
by a hash of the source, of every header of `csrc/` it includes (directly or
through another header) and of the flags, so a changed source or header
rebuilds and an unchanged one is reused.  A missing `nvcc` or a failed build
raises: there is no fallback.  Importing this module imports nothing of the
package (the tracer imports it); `launch` reaches the tracer when it runs.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import operator
import os
import pathlib
import re
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
# the port's kernels, one a source: counter `launch.<name>` of the tracer
KERNELS = tuple(sorted(path.stem for path in CSRC.glob("*.cu")))
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# sm_90a (Hopper); no contraction of a*b+c into FMA and no fast math, so the
# kernels' float arithmetic matches their plain PyTorch versions op for op
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

CUDA_ROOTS = ("/usr/local/cuda",)

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of `nvcc`: PATH, then $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), *CUDA_ROOTS):
        if root and (pathlib.Path(root) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and in "
        "/usr/local/cuda/bin): the CUDA kernels of gpu_pathtracer_tpu_torch "
        "are built from source at first use on a machine with the CUDA toolkit"
    )


_LOCAL_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def sources(name: str, csrc: pathlib.Path | None = None) -> list[pathlib.Path]:
    """csrc/<name>.cu and every file of csrc/ it includes with quotes,
    transitively, in first-seen order (`csrc`: another directory of
    sources, e.g. an older version's)."""
    seen: list[pathlib.Path] = []
    todo = [(csrc or CSRC) / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo.extend(path.parent / inc for inc in _LOCAL_INCLUDE.findall(path.read_text()))
    return seen


def library_path(name: str) -> pathlib.Path:
    """Where the build of csrc/<name>.cu goes (content-addressed)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def build_many(names) -> list[pathlib.Path]:
    """Compile each csrc/<name>.cu whose build does not exist yet, one `nvcc`
    per source, all started together; returns the libraries in order.  Each
    compiler's output (ptxas register/shared-memory report) is kept in
    `nvcc.log` beside its library."""
    libs = [library_path(name) for name in names]
    running = []
    for name, lib in zip(names, libs):
        if lib.exists():
            continue
        nvcc = find_nvcc()
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, lib, tmp, cmd, proc))
    failed = []
    for name, lib, tmp, cmd, proc in running:
        out, _ = proc.communicate()
        (lib.parent / "nvcc.log").write_text(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu's library, once per process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build_many([name])[0]))
    return _loaded[name]


PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def bind(lib: ctypes.CDLL, name: str, signature):
    """`gpt_<name>` of `lib` (`load(name)` or a build of other sources) with
    its parameters `signature` and the stream, set once a library."""
    fn = getattr(lib, f"gpt_{name}")
    if fn.argtypes is None:
        fn.argtypes = [*signature, PTR]
        fn.restype = ctypes.c_int
    return fn


def launch(name: str, signature, device: torch.device, *args) -> None:
    """Launch `bind`'s entry point of csrc/<name>.cu with `args` on `device`'s
    current stream; raise on an error, count a launch as `launch.<name>`."""
    from gpu_pathtracer_tpu_torch import tracing

    fn = bind(load(name), name, signature)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    tracing.count(f"launch.{name}")


def arg_block(fields, slots: int):
    """The int64 argument block (a kernel's `Args`) of `fields`, a tensor as
    its pointer and strides: exactly `slots` in all."""
    flat = []
    for f in fields:
        flat += (f.data_ptr(), *f.stride()) if isinstance(f, torch.Tensor) else (f,)
    if len(flat) != slots:
        raise ValueError(f"the argument block has {slots} slots, got {len(flat)} fields")
    return (ctypes.c_int64 * slots)(*flat)


def derived(sources):
    """Keep `tables(owner)`, a kernel's tables, on `owner` until one of the
    tensors `sources(owner)` is replaced or updated in place (a decorator)."""
    def wrap(tables):
        @functools.wraps(tables)
        def kept(owner):
            now = sources(owner)
            versions = [t._version for t in now]
            held = owner.__dict__.get(f"_{tables.__name__}")
            if held is None or held[0] != versions or not all(map(operator.is_, now, held[1])):
                held = (versions, now, tables(owner))
                setattr(owner, f"_{tables.__name__}", held)
            return held[2]
        return kept
    return wrap
