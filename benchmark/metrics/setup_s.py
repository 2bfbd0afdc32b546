"""setup_s: host-clock seconds from the first line of `run.py` to the
window's start (imports, CUDA context, kernel build or cache load, scene,
warm-up)."""


def read(run):
    return run.setup_s
