"""Data and tensor parallelism (counterpart of
``style_seqcvae_tpu/parallel``): the process runtime (:mod:`.multihost`),
the (data, model) mesh, the parameter spec table and batch placement
(:mod:`.mesh`), the gradient sums and the global norm
(:mod:`.collectives`), the tensor-parallel and FSDP autograd functions
(:mod:`.tensor_parallel`) and a multi-process check
(:mod:`.distributed_worker`). The modules are imported by name: the
models import :mod:`.tensor_parallel`, and :mod:`.mesh` imports the
models' tree helpers."""
