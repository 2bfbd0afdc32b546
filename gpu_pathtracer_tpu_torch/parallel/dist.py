"""Multi-process execution: `torch.distributed` wiring and the global mesh
(port of `gpu_pathtracer_tpu.parallel.dist`).

* `init_distributed()` initializes the default process group from the
  environment, and is a no-op when the environment describes no
  multi-process run, so every entry point can call it unconditionally.
* `global_mesh()` is the mesh of every process of the job (one device each).
* `host_local_slice()` gives the rows of a rank-sharded batch that this
  process owns (for process-local IO).

Launch convention (the reference's variables):

    GPT_TPU_COORDINATOR=host0:12345 GPT_TPU_NUM_PROCESSES=2 \\
    GPT_TPU_PROCESS_ID=0 python -m gpu_pathtracer_tpu_torch.cli master out.ppm

or, with the variables that `torchrun` sets (`RANK`, `WORLD_SIZE`,
`MASTER_ADDR`, `MASTER_PORT`, `LOCAL_RANK`):

    GPT_TPU_AUTO_DISTRIBUTED=1 torchrun --nproc_per_node=N \\
        -m gpu_pathtracer_tpu_torch.cli master out.ppm
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from gpu_pathtracer_tpu_torch.parallel.shard import Mesh, make_mesh


def init_distributed(backend: str | None = None, timeout: float = 600.0) -> bool:
    """Initialize the default process group from the environment; no-op
    otherwise.  Returns True iff a multi-process run is initialized.

    `GPT_TPU_AUTO_DISTRIBUTED=1` reads `torchrun`'s variables (`env://`);
    else `GPT_TPU_COORDINATOR` (host:port), `GPT_TPU_NUM_PROCESSES` and
    `GPT_TPU_PROCESS_ID` describe the run.  The backend is NCCL where CUDA
    is available and gloo on the CPU, unless `backend` names one.  Under
    NCCL the process's CUDA device is `LOCAL_RANK` (the process id modulo
    the device count when it is unset).  Collectives that wait longer than
    `timeout` seconds fail; so does the rendezvous."""
    if dist.is_initialized():
        return True
    if os.environ.get("GPT_TPU_AUTO_DISTRIBUTED", "0") != "0":
        init_method, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        coord = os.environ.get("GPT_TPU_COORDINATOR")
        nproc = os.environ.get("GPT_TPU_NUM_PROCESSES")
        pid = os.environ.get("GPT_TPU_PROCESS_ID")
        if not (coord and nproc and pid):
            return False
        init_method, world, rank = f"tcp://{coord}", int(nproc), int(pid)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        device = torch.device("cuda", int(local) if local else rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        kw["device_id"] = device  # the communicator is made here, not in the first collective
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout), **kw)
    return True


def global_mesh(device=None) -> Mesh:
    """The mesh of every process of the job (this process alone when
    torch.distributed is not initialized)."""
    return make_mesh(device=device)


def host_local_slice(n_rows: int, mesh: Mesh | None = None) -> slice:
    """Rows of a rank-sharded length-`n_rows` batch owned by this process:
    one device a process, so its rank's contiguous share.  `n_rows` must
    divide evenly by the mesh size."""
    mesh = mesh or global_mesh()
    if n_rows % mesh.size:
        raise ValueError(f"{n_rows} rows do not split evenly over {mesh.size} ranks")
    per = n_rows // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)
