"""Checkpoints of the trainer, and the drain marker.

Port of k8s_gpu_workload_enhancer_tpu/train/checkpoint.py. The JAX package
saves its TrainState through orbax; the port has no orbax, so its format is
its own: one file a step, `ckpt-{step}.pt`, which `torch.load(...,
weights_only=True)` reads, holding plain tensors and ints only:

    {"step": int, "params": tree,
     "opt_state": {"count": int, "mu": tree, "nu": tree}}

`params` are the f32 master weights and `mu`/`nu` the f32 Adam moments,
in the param tree of `models/transformer.init_params` (the JAX tree, so a
JAX checkpoint converts by a plain copy: scripts/convert_jax_checkpoint.py).
A file is written under a temporary name and `os.replace`d into place, so
`latest_step` sees only finished files; files beyond `max_to_keep` are
removed, oldest first.

The train step updates params and moments in place, so `save(wait=False)`
takes a host copy of the whole state before it returns; only the file
write runs on a background thread, which a later save and `close()` wait
for. `restore` puts every tensor on the device and dtype of the target's
leaf and makes the params leaves require grad again, as `init_state`
does. `load_params` is the serving load: the file memory-mapped, only
"params" kept, on the host; the Adam moments never reach the card.

On a mesh (a TrainState with `fsdp`, train/trainer.py) `save` gathers
the full tensors leaf by leaf over dp, ep, tp and pp on every rank (a
collective: every rank calls it) and only the primary writes, in the same
format; `restore` loads the full tensors on every rank and keeps this
rank's blocks of whatever (dp, pp, ep, tp, sp) mesh the target lays out. A checkpoint
written by a gang of any size and shape thus resumes on any other, and on
one device. `write_drain_marker` is the primary's alone (the trainer
main calls it on the primary only).

The drain-marker helpers are the JAX package's, byte for byte: the
control plane reads the marker through its own `read_drain_marker`.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from .trainer import TrainState, tree_map

DRAIN_MARKER = "drain-complete.json"

_CKPT_RE = re.compile(r"^ckpt-(\d+)\.pt$")


def write_drain_marker(directory: str, step: int,
                       extra: Optional[dict] = None) -> None:
    """Atomically record that a drained tenant finished its final save.

    The kube drain protocol's completion signal: the trainer writes this
    AFTER `CheckpointManager.save(step, wait=True)` returns, into the same
    (shared-volume) checkpoint directory the controller's
    `KubeDrainCallbacks` polls — so "marker present" implies "checkpoint
    durable"."""
    import json
    import time as _time
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, DRAIN_MARKER)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": int(step), "drained_at": _time.time(),
                   **(extra or {})}, f)
    os.replace(tmp, path)


def read_drain_marker(directory: str) -> Optional[dict]:
    import json
    try:
        with open(os.path.join(directory, DRAIN_MARKER)) as f:
            return json.load(f)
    except (FileNotFoundError, ValueError):
        return None


def clear_drain_marker(directory: str) -> None:
    try:
        os.unlink(os.path.join(directory, DRAIN_MARKER))
    except FileNotFoundError:
        pass


def _host_copy(tree):
    """A detached host copy of every tensor leaf (a copy on the CPU too:
    the step mutates the live tensors in place)."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def _snapshot(state: TrainState) -> Dict[str, Any]:
    opt = state.opt_state
    if state.fsdp is None:
        host = _host_copy
    else:
        # Every rank gathers; only the primary, which writes, keeps a copy.
        keep = ((lambda t: t.to("cpu", copy=True)) if state.fsdp.is_primary
                else (lambda t: None))

        def host(tree):
            return state.fsdp.full_tree(tree, keep)
    return {"step": int(state.step), "params": host(state.params),
            "opt_state": {"count": int(opt["count"]),
                          "mu": host(opt["mu"]), "nu": host(opt["nu"])}}


def _place_like(got, want, path: str = "", fsdp=None, dims=None):
    """`got` with `want`'s structure, each leaf on the device and dtype of
    `want`'s leaf (under `fsdp`, this rank's block of it, `dims` a tree of
    the (dp, tp, ep, pp) sharded dims); ValueError on a tree or shape
    mismatch."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(
                f"checkpoint tree at {path or 'root'} has "
                f"{sorted(got) if isinstance(got, dict) else type(got)}, "
                f"want {sorted(want)}")
        return {k: _place_like(got[k], want[k], f"{path}/{k}", fsdp,
                               None if dims is None else dims[k])
                for k in want}
    if fsdp is not None and isinstance(got, torch.Tensor):
        got = fsdp.shard(got, *dims)
    if not isinstance(got, torch.Tensor) or got.shape != want.shape:
        raise ValueError(
            f"checkpoint leaf {path} has shape "
            f"{tuple(getattr(got, 'shape', ()))}, want {tuple(want.shape)}")
    # copy=True: on the host too, the result must not alias the file.
    return got.to(device=want.device, dtype=want.dtype, copy=True)


class CheckpointManager:
    """`ckpt-{step}.pt` files in one directory (see the module note)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step}.pt")

    def _steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _CKPT_RE.match, os.listdir(self.directory)) if m)

    # -- save --

    def save(self, step: int, state: TrainState, wait: bool = True) -> None:
        """Save `state` as step `step`. The host copy is complete when this
        returns; with wait=False the file is written in the background.
        Under FSDP every rank calls it and the primary writes."""
        self.wait_until_finished()
        snapshot = _snapshot(state)
        if state.fsdp is not None and not state.fsdp.is_primary:
            return
        if wait:
            self._write(step, snapshot)
            return
        self._writer = threading.Thread(
            target=self._write_in_background, args=(step, snapshot),
            daemon=True, name=f"ktwe-ckpt-{step}")
        self._writer.start()

    def _write_in_background(self, step: int, snapshot) -> None:
        try:
            self._write(step, snapshot)
        except BaseException as e:      # noqa: BLE001 — re-raised by wait
            self._write_error = e

    def _write(self, step: int, snapshot) -> None:
        path = self._path(step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            torch.save(snapshot, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        for old in self._steps()[:-self._max_to_keep]:
            os.unlink(self._path(old))

    def wait_until_finished(self) -> None:
        """Wait for a background write; raise what it raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        err, self._write_error = self._write_error, None
        if err is not None:
            raise err

    # -- restore --

    def refresh(self) -> None:
        """Re-read the step list from disk: a no-op, since `latest_step`
        lists the directory on every call (the orbax manager of the JAX
        package caches it)."""

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def _resolve(self, step: Optional[int]) -> int:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return step

    def restore(self, step: Optional[int], target: TrainState) -> TrainState:
        """Step `step` (None = the latest) in the structure, devices and
        dtypes of `target` (under FSDP, this rank's blocks of it); the
        params leaves require grad."""
        step = self._resolve(step)
        data = torch.load(self._path(step), map_location="cpu",
                          weights_only=True, mmap=True)
        opt = data["opt_state"]
        fsdp = target.fsdp
        dims = None if fsdp is None else tree_map(
            lambda d, td, ed, pd: (d, td, ed, pd), fsdp.dims, fsdp.tp_dims,
            fsdp.ep_dims, fsdp.pp_dims)

        def place(got, want, path):
            return _place_like(got, want, path, fsdp, dims)
        params = place(data["params"], target.params, "params")
        return TrainState(
            params=tree_map(lambda p: p.requires_grad_(True), params),
            opt_state={"count": int(opt["count"]),
                       "mu": place(opt["mu"], target.opt_state["mu"], "mu"),
                       "nu": place(opt["nu"], target.opt_state["nu"], "nu")},
            step=int(data["step"]), fsdp=fsdp)

    def load_params(self, step: Optional[int] = None) -> Tuple[Any, int]:
        """(params, step) of step `step` (None = the latest): the f32
        master weights on the host, memory-mapped from the file."""
        step = self._resolve(step)
        data = torch.load(self._path(step), map_location="cpu",
                          weights_only=True, mmap=True)
        return data["params"], int(data["step"])

    def close(self) -> None:
        self.wait_until_finished()
