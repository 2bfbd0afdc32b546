"""Scale-out over rays and pixels on `torch.distributed` (port of
`gpu_pathtracer_tpu.parallel`).

One process drives one device; a process group plays the part of the JAX
package's device mesh (`shard.Mesh`): rays and pixels sharded over the
ranks, the scene replicated, photon maps all-gathered, parameter gradients
summed over the ranks once.  NCCL carries the collectives between GPUs,
gloo between CPU processes (and between processes that share one GPU).

Two render paths:

* `render_image_distributed`, the GSPMD counterpart: every rank draws the
  numbers of the whole frame and traces its own columns, so the image is
  `render_image`'s bit for bit for any number of ranks.
* `render_image_shard_map`, the counterpart of the `shard_map` render: each
  rank runs its own wavefront loop on pixels dealt to it round robin, from a
  stream of its own, with no collective per bounce.

`train_step_distributed` is the differentiable step: each rank replays its
own columns, every rank computes the loss of the all-gathered image, and the
gradients are summed over the ranks.  `sppm_shard` shards the SPPM photon
pass and pixels (`render_sppm_distributed`) and the differentiable SPPM
render through `render_sppm_differentiable(photon_pass_fn=...,
pixel_sharding=...)`.  `launch` starts a job of one process per rank on this
host (`run_ranks`, with `rendezvous` in each rank), as `bench_scaling_torch.py`
does.
"""

from gpu_pathtracer_tpu_torch.parallel.dist import (  # noqa: F401
    global_mesh,
    host_local_slice,
    init_distributed,
)
from gpu_pathtracer_tpu_torch.parallel.shard import (  # noqa: F401
    make_mesh,
    render_image_distributed,
    render_image_shard_map,
    train_step_distributed,
)
