"""The data-parallel mesh (counterpart of the data half of
``style_seqcvae_tpu/parallel/mesh.py``).

The JAX package builds a 2-D ``jax.sharding.Mesh`` over ``(data, model)``
and lets XLA insert the gradient ``psum``. The port's data axis is either

* a process group of ``world_size`` ranks, one device each (training:
  every rank feeds its local rows, and :mod:`.collectives` sums the
  gradients), or
* one process with several decode devices (``DecodeHarness(mesh=...)``
  splits the (z, batch, states, beam) grid over them).

The ``model`` axis (tensor parallelism, FSDP) is not ported: ``num_model``
above 1 raises naming ROADMAP A10.2.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from style_seqcvae_tpu_torch.parallel.multihost import process_count, process_index, rank_device
from style_seqcvae_tpu_torch.weights import named_leaves, tree_map


@dataclass(frozen=True)
class DataMesh:
    """``devices``: this process's devices (one per rank in a process
    group); ``group``: the process group when ``world_size`` > 1, else
    None."""
    devices: Tuple[torch.device, ...]
    world_size: int = 1
    rank: int = 0
    group: Optional[Any] = None

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def require_no_model_axis(num_model: int) -> None:
    """Refuse a ``model`` axis: tensor parallelism is not ported."""
    if num_model != 1:
        raise NotImplementedError("--num-model above 1 (tensor parallelism over a model axis, "
                                  "FSDP) is not ported yet (ROADMAP A10.2)")


def make_mesh(num_data: int = -1, num_model: int = 1,
              devices: Optional[Sequence[Union[str, torch.device]]] = None) -> DataMesh:
    """In a process group: one device per rank (this rank's), and
    ``num_data`` must be -1 or the world size. In one process: ``devices``
    (default every visible GPU), all of them, so ``num_data`` must be -1 or
    their count. A device that is not present raises."""
    require_no_model_axis(num_model)
    world = process_count()
    if world > 1:
        if num_data not in (-1, world):
            raise ValueError(f"--num-data {num_data} in a process group of {world} ranks: "
                             f"pass -1 or {world}")
        return DataMesh((rank_device(devices[0] if devices else None),), world,
                        process_index(), dist.group.WORLD)
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(rank_device(d) for d in devices)
    if not devs:
        raise RuntimeError("no CUDA device is available for the mesh; pass devices")
    if num_data not in (-1, len(devs)):
        raise ValueError(f"mesh of {num_data} does not cover the {len(devs)} devices given")
    return DataMesh(devs)


def batch_sharding(mesh: DataMesh) -> torch.device:
    """Where a batch-leading input lies: each rank's rows on its device."""
    return mesh.device


def _leading_rows(leaves: List[torch.Tensor], axis: int) -> None:
    rows = {t.shape[axis] for t in leaves if t.dim() > axis}
    if len(rows) > 1:
        raise ValueError(f"batch leaves disagree on their rows along axis {axis}: "
                         f"{sorted(rows)}")


def _put(x, device: torch.device):
    if x is None:
        return None
    t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return t.to(device)


def shard_batch(mesh: DataMesh, local_batch: Dict[str, Any],
                leading_scan_axis: bool = False) -> Dict[str, Any]:
    """This rank's local rows of a global batch, on its device. Every leaf
    is batch-leading (``leading_scan_axis``: (K, batch, ...) stacks) and
    must hold the same rows."""
    out = {k: _put(v, mesh.device) for k, v in local_batch.items()}
    _leading_rows([v for v in out.values() if v is not None and v.dim()],
                  1 if leading_scan_axis else 0)
    return out


# the detector batch's fields that are global, not batch-leading
_DETECTOR_GLOBAL = ("att_counts",)


def shard_detector_batch(mesh: DataMesh, local_batch: Dict[str, Any],
                         leading_scan_axis: bool = False) -> Dict[str, Any]:
    """:func:`shard_batch` for the detector: ``att_counts`` (the attribute
    frequencies) and 0-d leaves are global and stay whole."""
    out = {k: _put(v, mesh.device) for k, v in local_batch.items()}
    _leading_rows([v for k, v in out.items()
                   if v is not None and v.dim() and k not in _DETECTOR_GLOBAL],
                  1 if leading_scan_axis else 0)
    return out


def local_rows(n_rows: int) -> slice:
    """This process's contiguous slice of a batch-leading global axis: rank
    ``p`` of ``P`` holds rows ``[p·n/P, (p+1)·n/P)``."""
    p, n = process_index(), process_count()
    if n_rows % n:
        raise ValueError(f"{n_rows} rows do not divide over {n} processes")
    per = n_rows // n
    return slice(p * per, (p + 1) * per)


def replicate(mesh: DataMesh, tree: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One copy of the tensors of ``tree`` per device of the mesh (a device
    listed twice shares one copy). In a process group each rank's tensors
    are overwritten by rank 0's (a broadcast), so every rank holds the same
    values."""
    if mesh.world_size > 1:
        with torch.no_grad():
            for _, t in named_leaves(tree):
                dist.broadcast(t, src=0, group=mesh.group)
        return [tree]
    copies: Dict[torch.device, Dict[str, Any]] = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = tree_map(lambda t: t.to(d), tree)
    return [copies[d] for d in mesh.devices]


class GridSplit(NamedTuple):
    """How a decode grid lies on the mesh: ``axis`` "z", "batch" or None
    (not split), and each chunk's slice of that axis with its device."""
    axis: Optional[str]
    chunks: Tuple[Tuple[slice, torch.device], ...]


def decode_grid_split(mesh: DataMesh, n_z: int, batch: int) -> GridSplit:
    """The counterpart of JAX's ``decode_grid_specs``: split z when the
    mesh's device count divides ``n_z`` (always present, even at batch 1),
    else the batch, else decode the whole grid on the first device, with
    JAX's warning. z and batch elements are independent, so either split
    gives the unsplit captions."""
    devs = mesh.devices
    nd = len(devs)
    for axis, n in (("z", n_z), ("batch", batch)):
        if n % nd == 0:
            per = n // nd
            return GridSplit(axis, tuple((slice(i * per, (i + 1) * per), d)
                                         for i, d in enumerate(devs)))
    if nd > 1:
        warnings.warn(
            f"decode_grid_split: neither n_z={n_z} nor batch={batch} divides the {nd}-device "
            "data axis — decoding will run fully replicated (the whole grid on the first "
            "device). Pad n_z or batch to a multiple of the mesh to restore decode "
            "parallelism.", stacklevel=2)
    return GridSplit(None, ((slice(None), devs[0]),))
