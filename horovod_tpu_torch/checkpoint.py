"""Sharded checkpoints of train states: every rank writes its own part.

Counterpart of ``horovod_tpu/checkpoint.py`` (orbax, which writes each
device's shards without gathering them and restores onto the template's
shardings). In the port every rank's state is already its own part — a
ZeRO rank holds its 1/d master and optimizer shards, a tp or pp rank its
slice of the model — so each rank writes one file of its tensors, and a
restore reads them back into the template's tensors in place, on the
template's devices and in its layouts. Nothing is gathered onto one rank.

    from horovod_tpu_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager("/ckpt", max_to_keep=3)
    mgr.save(step, {"model": model, "opt": opt})    # on every rank
    state = mgr.restore({"model": model, "opt": opt})   # latest step

A state is a tensor, an object with ``state_dict()`` and
``load_state_dict()`` (a module, an optimizer, ``zero.ZeroTrainState``),
or a dict, list or tuple of states; other values (ints, strings) are
kept as they are. Layout on disk: ``<directory>/<step>/rank<r>.pt`` per
rank and ``manifest.json`` (the step and the world size), written last by
rank 0; a step is complete when the manifest and every rank's file are
there. Per-rank files rather than ``torch.distributed.checkpoint``: the
states are rank-local by construction and a restore into another world
is refused, so no resharding planner is needed.

``save`` and ``wait_until_finished`` are collective when a process group
exists (a barrier after the write, before rank 0 prunes old steps). A
restore refuses a checkpoint written by another number of ranks, and a
``ZeroTrainState`` refuses one of another stage, bucket cap,
compression or accumulation mode.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import torch
import torch.distributed as dist

_STATE_DICT = "__state_dict__"


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _snapshot(obj):
    """A copy of ``obj`` with every tensor on the host, detached: what is
    written, taken before ``save`` returns so the state may move on."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if hasattr(obj, "state_dict") and hasattr(obj, "load_state_dict"):
        return {_STATE_DICT: _snapshot(obj.state_dict())}
    if isinstance(obj, dict):
        return {k: _snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_snapshot(v) for v in obj)
    return obj


def _restore_into(template, saved, where="state"):
    """``saved`` loaded into ``template`` in place where it holds tensors;
    returns the restored value."""
    if hasattr(template, "load_state_dict") and hasattr(template,
                                                         "state_dict"):
        if not (isinstance(saved, dict) and _STATE_DICT in saved):
            raise ValueError(f"{where}: the checkpoint holds no state_dict "
                             f"for this {type(template).__name__}")
        template.load_state_dict(saved[_STATE_DICT])
        return template
    if torch.is_tensor(template):
        if not torch.is_tensor(saved) or saved.shape != template.shape or \
                saved.dtype != template.dtype:
            raise ValueError(
                f"{where}: the checkpoint holds "
                f"{getattr(saved, 'shape', type(saved).__name__)} "
                f"{getattr(saved, 'dtype', '')}, the template "
                f"{tuple(template.shape)} {template.dtype}")
        with torch.no_grad():
            template.copy_(saved)
        return template
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            raise ValueError(f"{where}: the checkpoint's keys "
                             f"{sorted(map(str, saved))} differ from the "
                             f"template's {sorted(map(str, template))}")
        return {k: _restore_into(template[k], saved[k], f"{where}[{k!r}]")
                for k in template}
    if isinstance(template, (list, tuple)):
        if len(saved) != len(template):
            raise ValueError(f"{where}: {len(saved)} entries in the "
                             f"checkpoint, {len(template)} in the template")
        return type(template)(_restore_into(t, s, f"{where}[{i}]")
                              for i, (t, s) in enumerate(zip(template,
                                                             saved)))
    return saved


class CheckpointManager:
    """Step-numbered checkpoints under ``directory``, at most
    ``max_to_keep`` of them (None: all)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self._directory = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        self._writer: Optional[threading.Thread] = None
        self._pending = None      # (step, world size) of the write
        self._error: Optional[BaseException] = None
        os.makedirs(self._directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._directory, str(int(step)))

    def save(self, step: int, state: Any, wait: bool = True) -> None:
        """Write this rank's part of ``state`` under ``step``. The tensors
        are copied to the host before the call returns; with
        ``wait=False`` the file is written in the background (call
        ``wait_until_finished()``, or the next ``save``, before relying on
        it). Every rank calls it."""
        self.wait_until_finished()
        rank, size = _world()
        payload = {"rank": rank, "world_size": size, "step": int(step),
                   "state": _snapshot(state)}
        path = self._step_dir(step)

        def write():
            try:
                os.makedirs(path, exist_ok=True)
                tmp = os.path.join(path, f".rank{rank}.pt.tmp")
                torch.save(payload, tmp)
                os.replace(tmp, os.path.join(path, f"rank{rank}.pt"))
            except Exception as e:   # re-raised by wait_until_finished
                self._error = e

        self._writer = threading.Thread(target=write, daemon=True)
        self._writer.start()
        self._pending = (int(step), size)
        if wait:
            self.wait_until_finished()

    def wait_until_finished(self) -> None:
        """Finish the write in flight; then (with a process group, on
        every rank) a barrier, rank 0's manifest and the pruning of steps
        past ``max_to_keep``."""
        if self._writer is None:
            return
        self._writer.join()
        self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        step, size = self._pending
        rank, _ = _world()
        if size > 1:
            dist.barrier()
        if rank == 0:
            manifest = os.path.join(self._step_dir(step), "manifest.json")
            with open(manifest + ".tmp", "w") as f:
                json.dump({"step": step, "world_size": size}, f)
            os.replace(manifest + ".tmp", manifest)
            if self._max_to_keep:
                for old in self.all_steps()[:-self._max_to_keep]:
                    shutil.rmtree(self._step_dir(old), ignore_errors=True)
        if size > 1:
            dist.barrier()

    def _manifest(self, step: int):
        try:
            with open(os.path.join(self._step_dir(step),
                                   "manifest.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def all_steps(self) -> List[int]:
        """The complete steps, oldest first."""
        steps = []
        for name in os.listdir(self._directory):
            if not name.isdigit():
                continue
            m = self._manifest(int(name))
            if m is not None and all(
                    os.path.exists(os.path.join(self._step_dir(int(name)),
                                                f"rank{r}.pt"))
                    for r in range(m["world_size"])):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """Read this rank's part of ``step`` (default: the latest) into
        ``template`` (a state of the same structure: a freshly built one)
        in place, and return it. Refuses a checkpoint written by another
        number of ranks."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self._directory}")
        m = self._manifest(step)
        if m is None:
            raise FileNotFoundError(f"no complete checkpoint of step {step} "
                                    f"under {self._directory}")
        rank, size = _world()
        if m["world_size"] != size:
            raise ValueError(
                f"world size mismatch: step {step} was written by "
                f"{m['world_size']} ranks, this world has {size}; restore "
                f"it into a world of the same size")
        saved = torch.load(os.path.join(self._step_dir(step),
                                        f"rank{rank}.pt"),
                           map_location="cpu", weights_only=True)
        return _restore_into(template, saved["state"])

    def close(self) -> None:
        self.wait_until_finished()
