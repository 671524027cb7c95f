"""The port's `CheckpointingTenantPool` drained and resumed by the JAX
package's `SubSliceController.rebalance(drain=...)` (the control plane
stays in the JAX package and calls the pool's callbacks), mirroring
tests/integration/test_rebalance_drain.py on the port's single-device
trainer (CPU, f32, vocab 64, d_model 32, 1 layer, batch 2, seq 16):

- two training tenants drain to checkpoints and resume on re-carved
  instances; their losses after the resume equal an undrained tenant's
  on the same data (f32, exactly: the state is restored bit for bit and
  the synthetic stream resumes at the step);
- a checkpoint that fails to save refuses the drain and leaves the tenant
  live, its training state intact;
- a layout that cannot host every tenant gives capacity back until all
  of them fit;
- churn: allocations, releases and drain-rebalances in random order; after
  every rebalance every tenant holds one instance and none is left
  drained.
"""

import random

import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.discovery.discovery import (
    DiscoveryConfig, DiscoveryService)
from k8s_gpu_workload_enhancer_tpu.discovery.fakes import make_fake_cluster
from k8s_gpu_workload_enhancer_tpu.sharing.slice_controller import (
    SubSliceController, SubSliceStrategy)
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.sharing.tenant_drain import (
    CheckpointingTenantPool, DrainCallbacks)
from k8s_gpu_workload_enhancer_tpu_torch.train import checkpoint as tckpt
from k8s_gpu_workload_enhancer_tpu_torch.train import trainer as ttrainer

import torch_parity  # noqa: F401  (one intra-op thread a process)


def build(num_nodes=1):
    tpu, k8s = make_fake_cluster(num_nodes, "2x4")
    disc = DiscoveryService(tpu, k8s,
                            DiscoveryConfig(enable_node_watch=False))
    disc.refresh_topology()
    return SubSliceController(disc)


def tiny():
    mcfg = ttf.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
        d_ff=64, max_seq=16, dtype=torch.float32)
    tcfg = ttrainer.TrainConfig(batch_size=2, seq_len=16, grad_accum=1,
                                warmup_steps=1, total_steps=100)
    return mcfg, tcfg


def strategy(dist, allow_drain=True):
    return SubSliceStrategy(name="live", profile_distribution=dist,
                            rebalance_interval_s=0.0,
                            allow_drain=allow_drain)


def test_callbacks_are_the_two_field_drain_hooks(tmp_path):
    cbs = CheckpointingTenantPool(str(tmp_path), device="cpu").callbacks()
    assert isinstance(cbs, DrainCallbacks)
    assert set(vars(cbs)) == {"checkpoint", "resume"}


def test_drain_checkpoints_and_resumes_training_tenants(tmp_path):
    slices = build()
    pool = CheckpointingTenantPool(str(tmp_path / "pool"), device="cpu")
    ref = CheckpointingTenantPool(str(tmp_path / "ref"), device="cpu")
    slices.register_strategy(strategy({"1": 1.0}))
    slices.rebalance("live", force=True)
    assert len(slices.instances()) == 8

    mcfg, tcfg = tiny()
    for uid in ("t-0", "t-1"):
        slices.allocate(uid, "1")
        pool.launch(uid, mcfg, tcfg)
        pool.step(uid, 3)
    ref.launch("undrained", mcfg, tcfg)
    ref.step("undrained", 3)
    assert all(pool.steps_done(u) == 3 for u in ("t-0", "t-1"))

    # Repartition the whole slice to 2x2: both occupied tenants drain
    # (cordon -> checkpoint -> destroy) and resume on re-carved instances.
    slices.register_strategy(strategy({"2x2": 1.0}))
    out = slices.rebalance("live", force=True, drain=pool.callbacks())
    assert out["drained"] == 2
    want = [ref.step("undrained") for _ in range(2)]
    for uid in ("t-0", "t-1"):
        assert pool.is_live(uid), f"{uid} lost in rebalance"
        assert pool.steps_done(uid) == 3        # restored, not reset
        assert [pool.step(uid) for _ in range(2)] == want
        assert pool.steps_done(uid) == 5
        assert pool.resumed_on[uid] in {i.instance_id
                                        for i in slices.instances()}
    by_uid = {i.allocated_to: i for i in slices.instances() if i.in_use}
    assert set(by_uid) == {"t-0", "t-1"}
    assert all(not i.cordoned for i in slices.instances())


def test_a_refused_checkpoint_leaves_the_tenant_live(tmp_path, monkeypatch):
    slices = build()
    pool = CheckpointingTenantPool(str(tmp_path), device="cpu")
    slices.register_strategy(strategy({"1": 1.0}))
    slices.rebalance("live", force=True)
    mcfg, tcfg = tiny()
    slices.allocate("t-0", "1")
    pool.launch("t-0", mcfg, tcfg)
    before = pool.step("t-0", 2)

    def fail(self, step, state, wait=True):
        raise OSError("checkpoint volume is full")
    monkeypatch.setattr(tckpt.CheckpointManager, "save", fail)
    slices.register_strategy(strategy({"2x2": 1.0}))
    out = slices.rebalance("live", force=True, drain=pool.callbacks())
    assert out["drained"] == 0
    assert pool.is_live("t-0") and pool.steps_done("t-0") == 2
    assert "t-0" not in pool.resumed_on
    holders = [i for i in slices.instances() if i.in_use]
    assert [i.allocated_to for i in holders] == ["t-0"]
    assert not any(i.cordoned for i in slices.instances())
    after = pool.step("t-0")                    # trains on
    assert after == after and after != before
    assert pool.steps_done("t-0") == 3


def test_tenants_survive_layout_that_cannot_host_them(tmp_path):
    slices = build()
    pool = CheckpointingTenantPool(str(tmp_path), device="cpu")
    slices.register_strategy(strategy({"1": 1.0}))
    slices.rebalance("live", force=True)
    mcfg, tcfg = tiny()
    for i in range(8):
        slices.allocate(f"t-{i}", "1")
        pool.launch(f"t-{i}", mcfg, tcfg)
        pool.step(f"t-{i}", 1)
    slices.register_strategy(strategy({"2x2": 1.0}))
    slices.rebalance("live", force=True, drain=pool.callbacks())
    live = [f"t-{i}" for i in range(8) if pool.is_live(f"t-{i}")]
    assert len(live) == 8, f"lost tenants: {set(range(8)) - set(live)}"
    assigned = {i.allocated_to for i in slices.instances() if i.in_use}
    assert assigned == {f"t-{i}" for i in range(8)}


def test_churn_no_tenant_lost_across_rebalances(tmp_path):
    """Allocations, releases and drain-rebalances in random order with the
    port's pool as the drain: after every rebalance each allocated tenant
    holds exactly one instance and is live in the pool."""
    rng = random.Random(17)
    slices = build(num_nodes=2)                  # 16 chips
    pool = CheckpointingTenantPool(str(tmp_path), device="cpu")
    cbs = pool.callbacks()
    mcfg, tcfg = tiny()
    slices.register_strategy(strategy({"1": 1.0}))
    slices.rebalance("live", force=True)
    tenants = set()
    next_id = 0
    drains = 0
    for _ in range(40):
        op = rng.random()
        if op < 0.4 and len(tenants) < 12:
            uid = f"c-{next_id}"
            next_id += 1
            try:
                slices.allocate(uid, "1")
            except Exception:  # noqa: BLE001 - no free "1" right now
                continue
            tenants.add(uid)
            pool.launch(uid, mcfg, tcfg)
        elif op < 0.55 and tenants:
            uid = rng.choice(sorted(tenants))
            for a_id, a in list(slices._allocations.items()):
                if a.workload_uid == uid:
                    slices.release(a_id)
            tenants.discard(uid)
        else:
            slices.register_strategy(strategy(rng.choice([
                {"1": 1.0}, {"2x2": 0.5, "1": 0.5}, {"2x1": 1.0},
                {"2x2": 1.0}])))
            drains += slices.rebalance("live", force=True,
                                       drain=cbs).get("drained", 0)
            assert all(pool.is_live(u) for u in tenants), (
                "tenant drained but never resumed")
        holders = {}
        for inst in slices.instances():
            if inst.in_use:
                assert inst.allocated_to not in holders, "double-held"
                holders[inst.allocated_to] = inst.instance_id
        assert set(holders) == tenants, (
            f"allocations lost: {tenants - set(holders)}")
    assert drains > 0
    for uid in tenants:
        done = pool.steps_done(uid)
        pool.step(uid)
        assert pool.steps_done(uid) == done + 1
