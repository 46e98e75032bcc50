"""The host sampler: uniform pixel batches in C++ with OpenMP, loaded with
ctypes (``lib.py``) and built with g++ at first use (``build.py``).
``data.datamanager`` draws every training batch with ``sample_ray_batch``,
as the JAX package's datamanager does."""

from nerf_kbs_tpu_torch.native.lib import available, sample_ray_batch

__all__ = ["available", "sample_ray_batch"]
