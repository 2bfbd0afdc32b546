"""Launch of a job of one process per rank on this host: the rendezvous
without a race for its port, the ranks started as child processes under one
time limit, and a failed rank named with its exit code or signal, its
seconds and the tail of its log.

    seconds = run_ranks([sys.executable, "job.py", ...], world, out_dir, timeout)

starts `job.py ... --rank r` for r in 0..world-1; each rank calls
`rendezvous(r, world, out_dir / "port", timeout)` and then
`dist.init_distributed(...)`.
"""

from __future__ import annotations

import datetime
import os
import pathlib
import signal
import subprocess
import time

import torch.distributed as dist

LOG_TAIL = 4000  # characters of a failed rank's log in the error


def rendezvous(rank: int, world: int, port_file, timeout: float):
    """Set the `GPT_TPU_*` variables of a process group of `world` processes
    on this host, with no race for its port: rank 0 binds the group's store
    on a port that the OS picks (`init_distributed`'s own store on that port
    then shares this server: `multi_tenant`) and writes the port to
    `port_file`, which the other ranks wait for.  Returns rank 0's store,
    which must outlive the group (None on the other ranks)."""
    port_file = pathlib.Path(port_file)
    store = None
    if rank == 0:
        store = dist.TCPStore("127.0.0.1", 0, world, True, multi_tenant=True,
                              wait_for_workers=False, timeout=datetime.timedelta(seconds=timeout))
        port_file.with_suffix(".tmp").write_text(str(store.port))
        os.replace(port_file.with_suffix(".tmp"), port_file)
    else:
        deadline = time.monotonic() + timeout
        while not port_file.exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f"rank 0 wrote no port to {port_file} in {timeout} s")
            time.sleep(0.05)
    os.environ.update(GPT_TPU_COORDINATOR=f"127.0.0.1:{port_file.read_text()}",
                      GPT_TPU_NUM_PROCESSES=str(world), GPT_TPU_PROCESS_ID=str(rank))
    return store


def exit_reason(rc: int) -> str:
    """A child's exit code in words: the signal that ended it, if one did."""
    return f"killed by {signal.Signals(-rc).name}" if rc < 0 else f"exited with code {rc}"


def run_ranks(argv, world: int, out_dir, timeout: float, env=None) -> list[float]:
    """Run `argv + ["--rank", str(r)]` for each rank r of `world` as child
    processes, each writing its output to `out_dir/rank<r>.log` (no pipe to
    fill), and wait for all of them under one limit of `timeout` seconds
    counted from their start; ranks left at the limit are killed.  Each
    rank's environment is `env` (default: this process's) without its
    `GPT_TPU_*` variables, which the rank's `rendezvous` sets, with
    `LOCAL_RANK` = r, gloo on the loopback interface and unbuffered output.
    Returns each rank's seconds; raises RuntimeError naming every rank that
    failed, how it ended, its seconds and the tail of its log."""
    out_dir = pathlib.Path(out_dir)
    base = {k: v for k, v in (os.environ if env is None else env).items()
            if not k.startswith("GPT_TPU_")}
    base.update(GLOO_SOCKET_IFNAME="lo", PYTHONUNBUFFERED="1")
    logs = [out_dir / f"rank{r}.log" for r in range(world)]
    procs = []
    t0 = time.monotonic()
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [*map(str, argv), "--rank", str(r)], env=dict(base, LOCAL_RANK=str(r)),
                    stdout=log, stderr=subprocess.STDOUT))
        seconds = [None] * world
        while None in seconds and time.monotonic() < t0 + timeout:
            for r, p in enumerate(procs):
                if seconds[r] is None and p.poll() is not None:
                    seconds[r] = time.monotonic() - t0
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    failed = []
    for r, p in enumerate(procs):
        if p.returncode == 0:
            continue
        how = exit_reason(p.returncode)
        if seconds[r] is None:
            how += f" at the job's limit of {timeout} s"
        took = time.monotonic() - t0 if seconds[r] is None else seconds[r]
        failed.append(f"rank {r} {how} after {took:.1f} s; its log ends:\n"
                      f"{logs[r].read_text()[-LOG_TAIL:]}")
    if failed:
        raise RuntimeError(f"{len(failed)} of {world} ranks failed:\n" + "\n".join(failed))
    return seconds
