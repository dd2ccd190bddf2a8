"""The (data, model) mesh and the parameter spec table (counterpart of
``style_seqcvae_tpu/parallel/mesh.py``).

The JAX package builds a 2-D ``jax.sharding.Mesh`` over ``(data, model)``,
shards the parameters by its ``_PARAM_SPEC_TABLE`` and lets XLA insert
the collectives. The port's :class:`Mesh` is either

* a process group of ``num_data × num_model`` ranks, one device each
  (training): rank ``r`` sits at data index ``r // num_model`` and model
  index ``r % num_model``, as JAX's ``devices.reshape(num_data,
  num_model)`` places its devices. The ranks of one data index form its
  model group (the same batch rows; activations replicated after each
  collective), the ranks of one model index its data group (gradients and
  metrics are summed over it); or
* one process with several devices, row-major over ``(num_data,
  num_model)`` (decoding: ``decode_grid_split`` splits the grid over the
  data rows, each chunk on its row's first device).

:func:`param_sharding` resolves every leaf through the copied table,
:func:`shard_params` cuts each leaf into this rank's block and
:func:`gather_params` (checkpoints, tests) gathers the blocks back. The
collectives of a sharded step are in :mod:`.tensor_parallel` and
:mod:`.collectives`.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from style_seqcvae_tpu_torch.parallel.collectives import all_gather
from style_seqcvae_tpu_torch.parallel.multihost import process_count, process_index, rank_device
from style_seqcvae_tpu_torch.weights import named_leaves, tree_map, tree_map_with_path

DATA_AXIS = "data"
MODEL_AXIS = "model"
Spec = Tuple[Optional[str], ...]


def P(*axes: Optional[str]) -> Spec:
    """A partition spec: one mesh axis (or None) a dimension, as JAX's."""
    return tuple(axes)


@dataclass(frozen=True)
class Mesh:
    """``devices``: this process's devices (in a process group, this rank's
    one device; in one process, all of them, row-major over ``(num_data,
    num_model)``). ``data_group`` / ``model_group``: this rank's groups in
    a process group, None where the axis has one rank."""
    devices: Tuple[torch.device, ...]
    world_size: int = 1
    rank: int = 0
    num_model: int = 1
    data_group: Optional[Any] = None
    model_group: Optional[Any] = None

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def num_data(self) -> int:
        return (self.world_size if self.world_size > 1 else len(self.devices)) // self.num_model

    @property
    def data_index(self) -> int:
        return self.rank // self.num_model

    @property
    def model_index(self) -> int:
        return self.rank % self.num_model

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """One process's first device of each data row."""
        return self.devices[::self.num_model]

    def size(self, axis: str) -> int:
        return {DATA_AXIS: self.num_data, MODEL_AXIS: self.num_model}[axis]

    def index(self, axis: str) -> int:
        return {DATA_AXIS: self.data_index, MODEL_AXIS: self.model_index}[axis]

    def group(self, axis: str):
        return {DATA_AXIS: self.data_group, MODEL_AXIS: self.model_group}[axis]


def _process_groups(num_data: int, num_model: int) -> Tuple[Any, Any]:
    """This rank's (data group, model group). Every rank creates every
    group, in the same order (PyTorch's rule for ``new_group``)."""
    world = dist.group.WORLD
    if num_model == 1:
        return world, None
    if num_data == 1:
        return None, world
    rank = dist.get_rank()
    data_group = model_group = None
    for d in range(num_data):
        g = dist.new_group(list(range(d * num_model, (d + 1) * num_model)))
        if rank // num_model == d:
            model_group = g
    for m in range(num_model):
        g = dist.new_group(list(range(m, num_data * num_model, num_model)))
        if rank % num_model == m:
            data_group = g
    return data_group, model_group


def make_mesh(num_data: int = -1, num_model: int = 1,
              devices: Optional[Sequence[Union[str, torch.device]]] = None) -> Mesh:
    """In a process group: one device per rank (this rank's), ``num_model``
    dividing the world and ``num_data`` -1 or the world over it. In one
    process: ``devices`` (default every visible GPU), all of them, reshaped
    ``(num_data, num_model)``. A mesh that does not cover the world or the
    devices raises, as does a device that is not present."""
    if num_model < 1:
        raise ValueError(f"--num-model {num_model}: pass a positive number")
    world = process_count()
    if world > 1:
        n_data = world // num_model
        if world % num_model or num_data not in (-1, n_data):
            raise ValueError(f"a mesh of {num_data} x {num_model} does not cover the process "
                             f"group of {world} ranks: --num-model must divide it and "
                             f"--num-data be -1 or the world over --num-model")
        data_group, model_group = _process_groups(n_data, num_model)
        return Mesh((rank_device(devices[0] if devices else None),), world, process_index(),
                    num_model, data_group, model_group)
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(rank_device(d) for d in devices)
    if not devs:
        raise RuntimeError("no CUDA device is available for the mesh; pass devices")
    if len(devs) % num_model or num_data not in (-1, len(devs) // num_model):
        raise ValueError(f"mesh of {num_data} x {num_model} does not cover the {len(devs)} "
                         "devices given")
    return Mesh(devs, num_model=num_model)


def batch_sharding(mesh: Mesh) -> torch.device:
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


def shard_batch(mesh: Mesh, local_batch: Dict[str, Any],
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


def shard_detector_batch(mesh: Mesh, local_batch: Dict[str, Any],
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


def replicate(mesh: Mesh, tree: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One copy of the tensors of ``tree`` per data row of the mesh (a
    device listed twice shares one copy). In a process group each rank's
    tensors are overwritten by those of the first rank of its data group
    (a broadcast), so every rank of a data group holds the same values:
    the blocks of one model index, or the whole tree without a model axis
    (never FSDP's blocks, which differ across the data group)."""
    if mesh.world_size > 1:
        if mesh.data_group is not None:
            with torch.no_grad():
                for _, t in named_leaves(tree):
                    dist.broadcast(t, src=mesh.model_index, group=mesh.data_group)
        return [tree]
    copies: Dict[torch.device, Dict[str, Any]] = {}
    for d in mesh.data_devices:
        if d not in copies:
            copies[d] = tree_map(lambda t: t.to(d), tree)
    return [copies[d] for d in mesh.data_devices]


class GridSplit(NamedTuple):
    """How a decode grid lies on the mesh: ``axis`` "z", "batch" or None
    (not split), and each chunk's slice of that axis with its device."""
    axis: Optional[str]
    chunks: Tuple[Tuple[slice, torch.device], ...]


def decode_grid_split(mesh: Mesh, n_z: int, batch: int) -> GridSplit:
    """The counterpart of JAX's ``decode_grid_specs``: split z when the
    mesh's data rows divide ``n_z`` (always present, even at batch 1),
    else the batch, else decode the whole grid on the first device, with
    JAX's warning. z and batch elements are independent, so either split
    gives the unsplit captions. JAX replicates each chunk over the
    ``model`` axis; the port decodes it once, on the first device of its
    data row."""
    devs = mesh.data_devices
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


# Explicit per-leaf layout for the captioner and baseline trees, keyed by
# path SUFFIX, copied entry for entry from the JAX package's table: the
# vocabulary-facing matrices and the fused (in, 4H) LSTM gate matrices over
# ``model``, small leaves replicated; the third column marks the leaves
# that FSDP (``shard_params_over_data``) shards over ``data``. A leaf that
# matches no entry raises, so a rename cannot silently de-shard it.
_PARAM_SPEC_TABLE = (
    (("embedding",), P(MODEL_AXIS, None), False),
    (("output_layer", "w"), P(None, MODEL_AXIS), False),
    (("output_layer", "b"), P(MODEL_AXIS), False),
    (("attention_lstm", "w"), P(None, MODEL_AXIS), False),
    (("encoder_lstm", "w"), P(None, MODEL_AXIS), False),
    (("decoder_lstm", "w"), P(None, MODEL_AXIS), False),
    (("language_lstm", "w"), P(None, MODEL_AXIS), False),   # baseline family
    (("attention_lstm", "b"), P(), False),
    (("encoder_lstm", "b"), P(), False),
    (("decoder_lstm", "b"), P(), False),
    (("language_lstm", "b"), P(), False),
    (("attention", "w_query"), P(), True),
    (("attention", "w_image"), P(), True),
    (("attention", "w_attend"), P(), False),
    (("fc_mean_w",), P(), True),
    (("fc_mean_b",), P(), False),
    (("fc_log_var_w",), P(), True),
    (("fc_log_var_b",), P(), False),
    # the tied head's (H, E) projection: small, replicated (FSDP-eligible);
    # its vocabulary dimension is the sharded embedding table's
    (("output_projection", "w"), P(), True),
    (("output_projection", "b"), P(), False),
)


def param_sharding(mesh: Mesh, params: Any,
                   shard_params_over_data: bool = False) -> Dict[str, Spec]:
    """Path (as ``weights.named_leaves`` writes it) → spec of every leaf of
    a captioner or baseline tree, resolved through :data:`_PARAM_SPEC_TABLE`
    as JAX's ``param_sharding`` resolves it: a leaf whose dimension does not
    divide its axis is replicated; with ``shard_params_over_data`` an
    FSDP-eligible 2-D leaf is sharded over ``data`` on dim 0 when that
    divides, else on dim 1, else follows the table."""
    nd = mesh.num_data

    def divisible(spec, leaf):
        return all(ax is None or leaf.shape[d] % mesh.size(ax) == 0
                   for d, ax in enumerate(spec))

    def spec_of(path, leaf):
        keys = tuple(path.split("/"))
        for suffix, spec, fsdp in _PARAM_SPEC_TABLE:
            if keys[-len(suffix):] == suffix:
                if fsdp and shard_params_over_data and len(leaf.shape) == 2:
                    if leaf.shape[0] % nd == 0:
                        return P(DATA_AXIS, None)
                    if leaf.shape[1] % nd == 0:
                        return P(None, DATA_AXIS)
                return spec if divisible(spec, leaf) else P()
        raise ValueError(
            f"param leaf {'.'.join(keys)} (shape {tuple(leaf.shape)}) "
            "has no entry in _PARAM_SPEC_TABLE — add an explicit spec for it "
            "(parallel/mesh.py) so its sharding is a decision, not an accident")

    return {path: spec_of(path, leaf) for path, leaf in named_leaves(params)}


def local_block(mesh: Mesh, leaf: torch.Tensor, spec: Spec) -> torch.Tensor:
    """This rank's contiguous block of a whole ``leaf`` (a view)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = leaf.shape[dim] // mesh.size(axis)
            leaf = leaf.narrow(dim, mesh.index(axis) * n, n)
    return leaf


def gather_leaf(mesh: Mesh, block: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The whole leaf from the blocks of the ranks (a collective over each
    sharded axis's group: every rank calls it)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            block = all_gather(block.detach(), mesh.group(axis), dim)
    return block


def shard_params(mesh: Mesh, params: Any, specs: Dict[str, Spec]) -> Any:
    """``params`` with every leaf cut to this rank's block of its spec."""
    return tree_map_with_path(lambda path, t: local_block(mesh, t, specs[path]), params)


def gather_params(mesh: Mesh, params: Any, specs: Dict[str, Spec]) -> Any:
    """The inverse of :func:`shard_params`: every leaf gathered whole, on
    every rank (a collective: every rank calls it, in the tree's order)."""
    return tree_map_with_path(lambda path, t: gather_leaf(mesh, t, specs[path]), params)
