"""Data parallelism over processes (``mesh``) and the process group's set-up
(``multihost``): the counterpart of the JAX package's ``parallel/``."""

from nerf_kbs_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_grads,
    make_mesh,
    mean_over_ranks,
    replicate,
    shard_batch,
)

__all__ = ["Mesh", "all_reduce_grads", "make_mesh", "mean_over_ranks", "replicate",
           "shard_batch"]
