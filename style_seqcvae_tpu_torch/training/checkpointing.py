"""Training checkpoints with the JAX manager's contract (counterpart of
``style_seqcvae_tpu/training/checkpointing.py:23-110``).

``step`` saves ``checkpoint_{it}`` and refreshes ``checkpoint_best`` when
the tracked metric improves or ties; ``keep`` prunes the oldest numbered
checkpoints; a resume is step-accurate (params, momentum buffers, the LR
schedule's position and the z-noise generator).

The JAX package writes orbax directories, and the GPU machine has no orbax.
A checkpoint of the port is a directory holding one ``state.npz`` keyed by
tree paths as ``weights.save_params_npz`` keys them: ``params/…`` (the JAX
tree's paths), ``opt_state/trace/…`` (the momentum buffers under the JAX
optimizer's names), ``opt_state/step`` and ``generator`` (the generator's
state bytes). The params are either model family's tree; a restore into
the other family's state raises ``ValueError`` naming both.
A directory in any other layout raises ``ValueError`` naming what it holds.

In a process group (``parallel/multihost.py``) rank 0 writes and prunes,
and every rank waits at a barrier after each write, so that any rank can
read what was saved. A state whose params are blocks of a mesh
(``trainer.create_train_state(mesh=...)``) is gathered whole before the
write (every rank takes part) and cut to its blocks on restore, so a
checkpoint written at any mesh restores at any other, as the JAX
package's orbax checkpoints reshard.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from style_seqcvae_tpu_torch.parallel.mesh import gather_leaf, local_block
from style_seqcvae_tpu_torch.parallel.multihost import process_index
from style_seqcvae_tpu_torch.weights import load_params_npz, named_leaves, param_family

STATE_FILE = "state.npz"


def read_checkpoint(path: str) -> Dict[str, Any]:
    """The nested dict of numpy arrays in the checkpoint directory ``path``."""
    f = os.path.join(path, STATE_FILE)
    if not os.path.isfile(f):
        found = sorted(os.listdir(path)) if os.path.isdir(path) else "nothing"
        raise ValueError(f"{path!r} is not a checkpoint of the port (a directory holding "
                         f"{STATE_FILE}); it holds {found}: orbax checkpoints of the JAX "
                         "package cannot be read without orbax")
    return load_params_npz(f)


def write_checkpoint(path: str, flat: Dict[str, np.ndarray]) -> None:
    """Write the checkpoint directory ``path`` holding ``flat`` (tree paths
    joined by ``/`` → arrays) as its ``state.npz``, replacing one that is
    there; a write that is cut leaves the old directory in place. In a
    process group rank 0 writes, and every rank returns once it has."""
    if process_index() == 0:
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, STATE_FILE), **flat)
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
    if dist.is_initialized():
        dist.barrier()


class CheckpointManager:
    def __init__(self, serialization_dir: str, mode: str = "max", keep: int = 10):
        """``keep``: retain at most this many ``checkpoint_{it}`` directories
        (``checkpoint_best`` is never pruned); ``keep <= 0`` keeps all."""
        self._dir = os.path.abspath(serialization_dir)
        os.makedirs(self._dir, exist_ok=True)
        self._mode = mode
        self._keep = keep
        self._best_metric: Optional[float] = None

    def _path(self, name) -> str:
        return os.path.join(self._dir, str(name))

    def step(self, state, metric: float, iteration: int, config_dump: str = "") -> None:
        """Save ``checkpoint_{iteration}``, refresh ``checkpoint_best`` when
        ``metric`` improves or ties (the train CLI passes a constant metric,
        so best tracks the newest save), then prune."""
        self.save(state, f"checkpoint_{iteration}")
        if config_dump and process_index() == 0:
            with open(self._path(f"checkpoint_{iteration}.config.yml"), "w") as f:
                f.write(config_dump)
        improved = (
            self._best_metric is None
            or (self._mode == "max" and metric >= self._best_metric)
            or (self._mode == "min" and metric <= self._best_metric)
        )
        if improved:
            self._best_metric = float(metric)
            self.save(state, "checkpoint_best")
        self._prune()

    def _prune(self) -> None:
        if self._keep <= 0 or process_index() != 0:
            return
        its = sorted(self._iterations())
        for it in its[:max(0, len(its) - self._keep)]:
            for suffix in ("", ".config.yml"):
                path = self._path(f"checkpoint_{it}{suffix}")
                if os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
                elif os.path.exists(path):
                    os.remove(path)

    def _iterations(self):
        return [int(d.split("_")[1]) for d in os.listdir(self._dir)
                if d.startswith("checkpoint_") and d.split("_")[1].isdigit()]

    def latest_iteration(self) -> Optional[int]:
        its = self._iterations()
        return max(its) if its else None

    def save(self, state, name: str) -> None:
        """Write ``state`` (a ``trainer.TrainState``) as the directory ``name``,
        replacing one that is there; blocks of a mesh are gathered whole
        first, so every rank must call it."""
        whole = _whole(state)
        flat = {f"params/{p}": whole(p, t) for p, t in named_leaves(state.params)}
        flat.update((f"opt_state/trace/{p}", whole(p, t))
                    for p, t in state.tx.momentum().items())
        flat = {k: t.detach().cpu().numpy() for k, t in flat.items()}
        flat["opt_state/step"] = np.asarray(state.step, np.int32)
        flat["generator"] = state.generator.get_state().numpy()
        write_checkpoint(self._path(name), flat)

    def restore(self, name: str, target_state):
        """Load the directory ``name`` into ``target_state`` in place (its
        params, momentum buffers, LR schedule, generator and step) and return
        it. A checkpoint of the other model family raises ``ValueError``."""
        data = read_checkpoint(self._path(name))
        found, want = param_family(data["params"]), param_family(target_state.params)
        if found != want:
            raise ValueError(f"checkpoint {name!r} holds the {found} family's parameters; "
                             f"the model being trained is the {want} family")
        params = dict(named_leaves(data["params"]))
        trace = dict(named_leaves(data["opt_state"]["trace"]))
        step = int(data["opt_state"]["step"])
        block = _block(target_state)
        with torch.no_grad():
            for path, p in target_state.tx.named:
                if path not in params:
                    raise ValueError(f"checkpoint {name!r} has no parameter {path!r}")
                p.copy_(block(path, torch.from_numpy(params[path])))
        target_state.tx.load({k: block(k, torch.from_numpy(v)) for k, v in trace.items()}, step)
        target_state.generator.set_state(torch.from_numpy(data["generator"]))
        target_state.step = step
        return target_state



def _whole(state):
    """(path, tensor) → the whole leaf of a state's block."""
    if state.specs is None:
        return lambda path, t: t
    return lambda path, t: gather_leaf(state.mesh, t, state.specs[path])


def _block(state):
    """(path, whole tensor) → the state's block of it."""
    if state.specs is None:
        return lambda path, t: t
    return lambda path, t: local_block(state.mesh, t, state.specs[path])
