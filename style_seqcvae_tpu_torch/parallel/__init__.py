"""Data parallelism (counterpart of ``style_seqcvae_tpu/parallel``): the
process runtime (:mod:`.multihost`), the data mesh and batch placement
(:mod:`.mesh`), the gradient sums (:mod:`.collectives`) and a two-process
check (:mod:`.distributed_worker`). Tensor parallelism waits for ROADMAP
A10.2."""

from style_seqcvae_tpu_torch.parallel.mesh import batch_sharding, make_mesh, shard_batch

__all__ = ["batch_sharding", "make_mesh", "shard_batch"]
