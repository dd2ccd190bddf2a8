"""Process groups for data-parallel runs (counterpart of
``style_seqcvae_tpu/parallel/multihost.py``).

The JAX package joins JAX's multi-controller runtime from the environment;
the port joins a ``torch.distributed`` process group from the same
environment:

* ``SSC_COORDINATOR=host:port`` with ``SSC_NUM_PROCESSES`` and
  ``SSC_PROCESS_ID``: ``init_process_group(init_method="tcp://host:port")``
  with that world size and rank (the explicit wiring the JAX package's
  two-process tests use, and what ``--num-data N`` sets for its own ranks);
* ``SSC_MULTIHOST=1``, or torchrun's ``RANK``, ``WORLD_SIZE`` and
  ``MASTER_ADDR``: ``init_method="env://"``.

Without either the call does nothing and the run is one process. Each rank
runs on ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` as torchrun sets it, else the
rank) over NCCL, or on the CPU over gloo when the caller asks for the CPU.
``backend=`` exists for one case: two ranks sharing one card, which NCCL
refuses ("Duplicate GPU detected"), run gloo on CUDA tensors.

:func:`local_batch_size` is each rank's share of a global batch;
:func:`process_index` and :func:`process_count` are (0, 1) without a group.
:func:`run_local_ranks` is what a CLI's ``--num-data N`` does in a plain
run: it starts N ranks of the same CLI on this machine, wired by the
``SSC_*`` environment.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import List, Optional, Union

import torch
import torch.distributed as dist

from style_seqcvae_tpu_torch.device import resolve_device

ENV_COORDINATOR = "SSC_COORDINATOR"
ENV_NUM_PROCESSES = "SSC_NUM_PROCESSES"
ENV_PROCESS_ID = "SSC_PROCESS_ID"
ENV_AUTO = "SSC_MULTIHOST"
ENV_BACKEND = "SSC_BACKEND"
_TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def _configured() -> Optional[tuple]:
    """(init_method, world_size, rank) from the environment, or None."""
    env = os.environ
    if env.get(ENV_COORDINATOR):
        return ("tcp://" + env[ENV_COORDINATOR], int(env[ENV_NUM_PROCESSES]),
                int(env[ENV_PROCESS_ID]))
    if env.get(ENV_AUTO, "") not in ("", "0") or all(k in env for k in _TORCHRUN):
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    return None


def rank_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device this process runs on: the CPU when ``device`` is the CPU,
    an explicit ``cuda:i`` as given, else ``cuda:LOCAL_RANK`` in a process
    group (``LOCAL_RANK`` from the environment, else the rank) and
    ``cuda`` without one. Raises where the card is missing."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dist.get_rank())))
    if dev.type == "cuda" and (dev.index or 0) >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} is not present: {torch.cuda.device_count()} CUDA "
                           "device(s) are visible")
    return dev


def maybe_initialize_distributed(device: Optional[Union[str, torch.device]] = None,
                                 backend: Optional[str] = None) -> bool:
    """Join the process group the environment describes; a no-op without
    one, and idempotent. ``device`` is the caller's device choice (None:
    the GPU); the backend is ``nccl`` for a CUDA device and ``gloo`` for the
    CPU unless ``backend`` or ``SSC_BACKEND`` names one. Returns whether a
    group is up."""
    if dist.is_initialized():
        return True
    conf = _configured()
    if conf is None:
        return False
    init_method, world_size, rank = conf
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or os.environ.get(ENV_BACKEND) or ("nccl" if dev.type == "cuda"
                                                         else "gloo")
    dist.init_process_group(backend,
                            init_method=init_method, world_size=world_size, rank=rank)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_batch_size(global_batch_size: int, parts: Optional[int] = None) -> int:
    """Rows each of ``parts`` data indices (default: every process)
    contributes to a global batch (the whole batch in one process)."""
    n = process_count() if parts is None else parts
    if global_batch_size % n:
        raise ValueError(f"global batch size {global_batch_size} is not divisible by the "
                         f"{n} participating processes")
    return global_batch_size // n


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_local_ranks(module: str, argv: List[str], n: int,
                    device: Optional[Union[str, torch.device]] = None) -> None:
    """Run ``python -m module *argv`` as ``n`` ranks of one process group on
    this machine (``SSC_*`` environment on a free port; on the CPU when
    ``device`` is the CPU, each rank with its share of this process's
    threads), and wait for them. With at least ``n`` cards, rank r runs on
    ``cuda:r`` over NCCL; with fewer, the ranks share them (rank r on
    ``cuda:r % cards``) over gloo, which NCCL refuses to do, and a line
    says so. Raises, and stops the other ranks, when one fails."""
    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    shared = dev.type == "cuda" and cards < n
    if shared:
        print(f"{n} ranks share {cards} CUDA device(s) over gloo", flush=True)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    port = free_port()
    procs = []
    try:
        for rank in range(n):
            env = dict(os.environ, **{
                ENV_COORDINATOR: f"localhost:{port}", ENV_NUM_PROCESSES: str(n),
                ENV_PROCESS_ID: str(rank), "LOCAL_RANK": str(rank % cards if shared else rank),
                "OMP_NUM_THREADS": str(max(1, torch.get_num_threads() // n)),
                "PYTHONPATH": os.pathsep.join(
                    [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])})
            if shared:
                env[ENV_BACKEND] = "gloo"
            procs.append(subprocess.Popen([sys.executable, "-m", module, *argv], env=env))
        while True:
            codes = [p.poll() for p in procs]
            for rank, code in enumerate(codes):
                if code not in (None, 0):
                    raise RuntimeError(f"rank {rank} of {module} exited with code {code}")
            if all(code == 0 for code in codes):
                return
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
