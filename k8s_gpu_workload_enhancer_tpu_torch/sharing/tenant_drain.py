"""Checkpoint-backed tenant drain for live sub-slice repartition.

Port of k8s_gpu_workload_enhancer_tpu/sharing/tenant_drain.py on the
port's single-device trainer and `CheckpointManager` (train/). The slice
controller (the JAX package's `SubSliceController.rebalance(drain=...)`,
plain Python) drains a tenant through `callbacks()`: `checkpoint` saves
the tenant's TrainState and stops it, `resume` restores the latest step
on the replacement instance and training goes on from there.

`CheckpointingTenantPool` doubles as the in-process tenant runtime:
`launch` starts a KTWE-LM train loop on synthetic data, `step` advances
it, and the pool tracks which tenants are live and which drained. A
refused save (one that raises) leaves the tenant live and answers False,
so the controller uncordons its instance. The callbacks read only
`instance.instance_id`.

One deviation: a resumed tenant's synthetic stream skips the batches it
trained on before the drain, so it trains on what an undrained tenant
would (the JAX pool restarts the stream).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from ..models import transformer as tf
from ..train import trainer
from ..train.checkpoint import CheckpointManager
from ..utils.device import resolve_device

log = logging.getLogger("ktwe.tenant_drain")


@dataclass
class DrainCallbacks:
    """Tenant lifecycle hooks for live repartition (the JAX package's
    `sharing.slice_controller.DrainCallbacks`). `checkpoint(uid, instance)
    -> bool` persists the tenant's state and stops it (False aborts the
    drain for that tenant); `resume(uid, instance)` restarts it on the
    replacement instance."""

    checkpoint: Callable[[str, Any], bool]
    resume: Callable[[str, Any], None]


class CheckpointingTenantPool:
    """KTWE-LM tenants keyed by workload uid, drained via checkpoints, each
    training on one device (`device`, the card by default)."""

    def __init__(self, checkpoint_root: str, device="cuda"):
        self._root = checkpoint_root
        self.device = resolve_device(device)
        self._live: Dict[str, Tuple[Any, Any, Any, int]] = {}
        # uid -> (model_cfg, train_cfg) for relaunch-after-drain
        self._specs: Dict[str, Tuple[tf.TransformerConfig,
                                     trainer.TrainConfig]] = {}
        self._drained: Dict[str, int] = {}       # uid -> step at drain
        self.resumed_on: Dict[str, str] = {}     # uid -> instance_id

    # -- tenant runtime --

    def _fresh(self, model_cfg, train_cfg):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(train_cfg.seed)
        state = trainer.init_state(model_cfg, train_cfg, gen)
        step_fn = trainer.make_train_step(model_cfg, train_cfg)
        batches = trainer.synthetic_batches(model_cfg, train_cfg,
                                            self.device)
        return state, step_fn, batches

    def launch(self, uid: str, model_cfg: tf.TransformerConfig,
               train_cfg: trainer.TrainConfig) -> None:
        state, step_fn, batches = self._fresh(model_cfg, train_cfg)
        self._live[uid] = (state, step_fn, batches, 0)
        self._specs[uid] = (model_cfg, train_cfg)

    def step(self, uid: str, n: int = 1) -> float:
        state, step_fn, batches, done = self._live[uid]
        metrics = None
        for _ in range(n):
            state, metrics = step_fn(state, next(batches))
            done += 1
        self._live[uid] = (state, step_fn, batches, done)
        return float(metrics["loss"]) if metrics is not None else 0.0

    def steps_done(self, uid: str) -> int:
        if uid in self._live:
            return self._live[uid][3]
        return self._drained.get(uid, 0)

    def is_live(self, uid: str) -> bool:
        return uid in self._live

    # -- DrainCallbacks --

    def callbacks(self) -> DrainCallbacks:
        return DrainCallbacks(checkpoint=self._checkpoint,
                              resume=self._resume)

    def _ckpt_dir(self, uid: str) -> str:
        return os.path.join(self._root, uid.replace("/", "_"))

    def _checkpoint(self, uid: str, instance) -> bool:
        entry = self._live.get(uid)
        if entry is None:
            return False                         # unknown tenant: refuse
        state, _step_fn, _batches, done = entry
        try:
            CheckpointManager(self._ckpt_dir(uid)).save(done, state,
                                                        wait=True)
        except Exception:
            # Refuse the drain (the controller uncordons and leaves the
            # tenant running); popping first would orphan a live training
            # state on a failed save.
            log.exception("tenant.checkpoint_failed workload=%s", uid)
            return False
        self._live.pop(uid)
        self._drained[uid] = done
        log.info("tenant.drained workload=%s step=%d instance=%s", uid,
                 done, instance.instance_id)
        return True

    def _resume(self, uid: str, instance) -> None:
        model_cfg, train_cfg = self._specs[uid]
        target, step_fn, batches = self._fresh(model_cfg, train_cfg)
        restored = CheckpointManager(self._ckpt_dir(uid)).restore(None,
                                                                  target)
        done = self._drained.pop(uid)
        for _ in range(done):
            next(batches)
        self._live[uid] = (restored, step_fn, batches, done)
        self.resumed_on[uid] = instance.instance_id
        log.info("tenant.resumed workload=%s step=%d instance=%s", uid, done,
                 instance.instance_id)
