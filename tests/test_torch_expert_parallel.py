"""Expert parallelism on the port, held on the CPU to the JAX package on the
same meshes (the ep axis of parallel/mesh.py and parallel/sharding.py, the
expert-parallel `_moe_ffn` of models/transformer.py, train/trainer.py, the
checkpoint, the trainer main, and MoE on serving meshes).

One gloo gang of eight ranks (tests/torch_gang.py) runs three meshes in
turn on the JAX package's MoE configuration (tests/unit/test_model.py
`MOE`: vocab 256, d_model 64, 2 layers, 4 heads, d_ff 128, 4 experts), f32,
on the same numpy weights and batches as the JAX side:

- dp=2, ep=2, tp=2 (JAX `test_moe_sharded_matches_single`'s mesh): the
  forward's logits and aux against the JAX forward on that mesh (rtol
  5e-4, atol 5e-5; aux rtol 1e-4), then two train steps against JAX
  `make_train_step` on it (atol 1e-5, rtol 1e-4);
- dp=2, ep=2 (four ranks): three steps at grad_accum 1 and 2 against JAX
  on that mesh, metrics and final params; the first run's checkpoint
  restores on one device;
- ep=2, sp=2 (four ranks): one step's loss and every gradient against
  JAX on that mesh (MoE on the ring).

Each train step's collectives hold their pins (parallel/comm_gate.py),
every all-to-all within E * N_local * D f32 values. In process: the
expert-parallel `_moe_ffn` on thread gangs of 2 and 4 (parallel/comm
.ThreadGroup, the card's virtual ranks) against the single-device dense
route, forward and backward; a layout of one dp rank with ep or tp 2
takes the dense route, as JAX's whole-mesh gate does; the MoE engines
(dense, paged, a verify round, the host tier) on (1, 2) and (2, 2) thread
gangs give the unmeshed engine's and the JAX engine's greedy tokens, a
decode chunk the dense model's pinned collectives. The trainer main with
--n-experts 4 on dp=2,ep=2, tp=2 and sp=2 gangs prints one process's
lines (the dense expert route on both).
"""

import functools
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.models import serving as jsrv
from k8s_gpu_workload_enhancer_tpu.models import transformer as jtf
from k8s_gpu_workload_enhancer_tpu.parallel import mesh as jmesh
from k8s_gpu_workload_enhancer_tpu.train import trainer as jtrainer
from k8s_gpu_workload_enhancer_tpu_torch.cmd import trainer as cli
from k8s_gpu_workload_enhancer_tpu_torch.models import decode as tdecode
from k8s_gpu_workload_enhancer_tpu_torch.models import serving as tsrv
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.parallel import comm_gate
from k8s_gpu_workload_enhancer_tpu_torch.parallel.comm import ThreadGroup
from k8s_gpu_workload_enhancer_tpu_torch.parallel.mesh import ServingMesh
from k8s_gpu_workload_enhancer_tpu_torch.parallel.sharding import (
    ExpertLayout)
from k8s_gpu_workload_enhancer_tpu_torch.train import checkpoint as tckpt
from k8s_gpu_workload_enhancer_tpu_torch.train import trainer as ttrainer

import torch_gang
import torch_parity  # noqa: F401  (one intra-op thread a process)
import torch_serve_gang as tsg

ROOT = torch_gang.ROOT
DIMS = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
            d_ff=128, max_seq=64, n_experts=4)
TRAIN = dict(warmup_steps=1, total_steps=5, batch_size=4, seq_len=32,
             learning_rate=1e-2)
# The three-step runs on dp=2, ep=2 at lr 1e-3 (tests/test_torch_fsdp.py's
# for its longer runs): an embedding element whose gradient cancels over
# the batch keeps few bits, and AdamW's g / sqrt(v) then moves it by up to
# lr times the last-bit difference (1e-4 at lr 1e-2 after three steps,
# every other element within 6e-7). grad_accum 2 with the f32
# accumulator.
EP_TRAIN = dict(TRAIN, learning_rate=1e-3)
ACC2 = dict(EP_TRAIN, batch_size=8, grad_accum=2, grad_accum_dtype="f32")
STEPS_3D, STEPS_EP = 2, 3
LOGITS_TOL = dict(rtol=5e-4, atol=5e-5)
AUX_RTOL = 1e-4
TOL = dict(atol=1e-5, rtol=1e-4)
FWD_SHAPE = (4, 16)
TINY = ["--device", "cpu", "--seq-len", "16", "--d-model", "64",
        "--n-layers", "2", "--n-heads", "2", "--d-ff", "128",
        "--vocab-size", "128", "--batch-size", "4", "--steps", "10",
        "--n-experts", "4"]

# Serving: the mesh-serving tests' small dims with 4 experts.
SERVE_DIMS = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
                  n_kv_heads=4, d_ff=64, max_seq=64, n_experts=4)
ENGINE = dict(num_slots=2, prefill_len=8, decode_chunk=3)
PAGED = dict(ENGINE, kv_block_len=8)
PROMPTS = [[3, 17, 29, 5, 7], list(range(1, 12)), [5, 6] * 4]
GENS = [10, 8, 12]


def flat(tree, prefix=""):
    return torch_gang.flat(tree, prefix)


def numpy_params(seed: int) -> dict:
    params = ttf.init_params(torch.Generator().manual_seed(seed),
                             torch_cfg())
    return {k: ({n: t.numpy() for n, t in v.items()}
                if isinstance(v, dict) else v.numpy())
            for k, v in params.items()}


def tokens(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, DIMS["vocab_size"], shape).astype(np.int32)


def jax_cfg(dims: dict = DIMS, ring: bool = True) -> jtf.TransformerConfig:
    return jtf.TransformerConfig(**dims, dtype=jnp.float32, use_flash=False,
                                 use_ring_attention=ring)


def torch_cfg(dims: dict = DIMS, **kw) -> ttf.TransformerConfig:
    return ttf.TransformerConfig(**dims, dtype=torch.float32, **kw)


def job(name: str, train: dict = TRAIN, **kw) -> dict:
    return dict(name=name, model=DIMS, train=train, **kw)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The gang of eight on its three meshes, started before the JAX
    references compile (see the module note)."""
    job_dir = tmp_path_factory.mktemp("ep")
    data = {
        "m3": (numpy_params(0),
               [tokens((4, 33), 10 + i) for i in range(STEPS_3D)]),
        "acc1": (numpy_params(1),
                 [tokens((4, 33), 20 + i) for i in range(STEPS_EP)]),
        "acc2": (numpy_params(2),
                 [tokens((2, 4, 33), 30 + i) for i in range(STEPS_EP)]),
        "sp": (numpy_params(3), [tokens((2, 33), 40)]),
    }
    inputs = {"fwd": tokens(FWD_SHAPE, 50)}
    for name, (params, batches) in data.items():
        inputs.update({f"{name}/params{k}": v
                       for k, v in flat(params).items()})
        inputs.update({f"{name}/batches/{i}": b
                       for i, b in enumerate(batches)})
    phases = [
        dict(mesh_axes="dp=2,ep=2,tp=2", jobs=[
            job("fwd", kind="forward", params="m3/params", tokens=["fwd"]),
            job("train3d", params="m3/params", batches="m3/batches",
                steps=STEPS_3D)]),
        dict(mesh_axes="dp=2,ep=2", world=4, jobs=[
            job("acc1", EP_TRAIN, params="acc1/params",
                batches="acc1/batches", steps=STEPS_EP, save="ckpt-ep"),
            job("acc2", ACC2, params="acc2/params", batches="acc2/batches",
                steps=STEPS_EP)]),
        dict(mesh_axes="ep=2,sp=2", world=4, jobs=[
            job("sp", dict(TRAIN, batch_size=2), kind="grads",
                params="sp/params", batch="sp/batches/0")]),
    ]
    g = torch_gang.Gang(job_dir, 8, phases, inputs)
    g.data = data
    yield g
    g.close()


def jax_mesh(**sizes):
    n = int(np.prod(list(sizes.values())))
    return jmesh.make_mesh(jmesh.MeshConfig(**sizes),
                           devices=jax.devices()[:n])


def jax_train(params: dict, batches, train: dict, mesh):
    cfg = jax_cfg()
    tc = jtrainer.TrainConfig(**train)
    p = jax.device_put(params, jtrainer.param_shardings(cfg, mesh))
    state = jtrainer.TrainState(
        params=p, opt_state=jtrainer.make_optimizer(tc).init(p),
        step=jnp.zeros((), jnp.int32))
    step = jtrainer.make_train_step(cfg, tc, mesh)
    metrics = []
    for toks in batches:
        state, m = step(state, jnp.asarray(toks))
        metrics.append({k: float(m[k]) for k in ("loss", "nll", "aux",
                                                 "grad_norm")})
    return metrics, jax.tree.map(np.asarray, state.params)


def assert_metrics(got: list, want: list, what: str) -> None:
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("loss", "nll", "aux", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key],
                                       err_msg=f"{what} step {i} {key}",
                                       **TOL)


def assert_tree(arrays: dict, tree: str, want: dict, what: str) -> None:
    want = flat(want)
    got = {k[len(tree):]: v for k, v in arrays.items()
           if k.startswith(tree + "/")}
    assert set(got) == set(want)
    for k, w in want.items():
        w = w.detach().numpy() if isinstance(w, torch.Tensor) else w
        np.testing.assert_allclose(got[k], np.asarray(w),
                                   err_msg=f"{what} {k}", **TOL)


# ------------------------------------------------------------ the gang


def test_forward_logits_and_aux_match_jax_on_dp2_ep2_tp2(gang):
    """The ranks' logit blocks (rows by the (dp, ep) batch coordinate,
    vocab by tp) and the aux against the JAX forward on the same mesh,
    which routes dense there."""
    params = gang.data["m3"][0]
    toks = jnp.asarray(np.load(gang.dir / "inputs.npz")["fwd"])
    cfg = jax_cfg()
    want, want_aux = jax.jit(lambda p, t: jtf.forward(
        p, t, cfg, jax_mesh(dp=2, ep=2, tp=2)))(params, toks)
    rows = [[None] * 2 for _ in range(4)]
    auxes = []
    for coords, arrays in gang.rank_arrays("fwd"):
        rows[coords["dp"] * 2 + coords["ep"]][coords["tp"]] = arrays["fwd"]
        auxes.append(float(arrays["fwd/aux"]))
    got = np.concatenate([np.concatenate(r, axis=2) for r in rows], axis=0)
    assert got.shape == FWD_SHAPE + (DIMS["vocab_size"],)
    np.testing.assert_allclose(got, np.asarray(want), **LOGITS_TOL)
    assert auxes == [auxes[0]] * 8
    np.testing.assert_allclose(auxes[0], float(want_aux), rtol=AUX_RTOL)


def test_two_steps_on_dp2_ep2_tp2_match_jax(gang):
    params, batches = gang.data["m3"]
    want, want_params = jax_train(params, batches, TRAIN,
                                  jax_mesh(dp=2, ep=2, tp=2))
    out = gang.result()
    assert all(o["train3d"]["metrics"] == out[0]["train3d"]["metrics"]
               for o in out)
    assert_metrics(out[0]["train3d"]["metrics"], want, "dp2 ep2 tp2 vs JAX")
    assert_tree(gang.arrays("train3d"), "params", want_params,
                "dp2 ep2 tp2 vs JAX")
    assert all(m["aux"] > 0.5 for m in want)


def test_layout_splits_the_experts_over_ep(gang):
    """On dp=2, ep=2, tp=2 an expert leaf's rank block holds E/ep experts,
    D/dp of the model dim and F/tp of the MLP dim, of the params and both
    moments; nothing else is split over ep."""
    e, d, f, L = (DIMS[k] for k in ("n_experts", "d_model", "d_ff",
                                    "n_layers"))
    for rank in gang.result():
        got = rank["train3d"]
        assert got["blocks"]["params/layers/w_gate"] == [L, e // 2, d // 2,
                                                         f // 2]
        assert got["blocks"]["nu/layers/w_down"] == [L, e // 2, f // 2,
                                                     d // 2]
        assert got["blocks"]["mu/layers/router"] == [L, d // 2, e]
        assert sorted(k for k, v in got["ep_dims"].items()
                      if v is not None) == ["/layers/w_down",
                                            "/layers/w_gate", "/layers/w_up"]


@pytest.mark.parametrize("name", ["acc1", "acc2"])
def test_moe_steps_on_dp2_ep2_match_jax(gang, name):
    """Three MoE steps on dp=2, ep=2 (grad_accum 1, and 2 with the f32
    accumulator): loss, nll, aux, grad_norm and the final params equal the
    JAX trainer's on the same mesh."""
    params, batches = gang.data[name]
    train = EP_TRAIN if name == "acc1" else ACC2
    want, want_params = jax_train(params, batches, train,
                                  jax_mesh(dp=2, ep=2))
    out = gang.result()
    assert all(o[name]["metrics"] == out[0][name]["metrics"]
               for o in out[:4])
    assert_metrics(out[0][name]["metrics"], want, f"{name} vs JAX")
    assert_tree(gang.arrays(name), "params", want_params, f"{name} vs JAX")
    assert out[0][name]["step"] == out[0][name]["count"] == STEPS_EP


def test_checkpoint_of_dp2_ep2_resumes_on_one_device(gang):
    """The dp=2, ep=2 checkpoint (every expert gathered over ep) restores
    on one device to the gang's state, leaf for leaf, and trains on."""
    saved = gang.arrays("acc1")
    target = ttrainer.init_state(torch_cfg(), ttrainer.TrainConfig(**TRAIN),
                                 torch.Generator().manual_seed(5))
    state = tckpt.CheckpointManager(str(gang.dir / "ckpt-ep")).restore(
        None, target)
    assert state.step == state.opt_state["count"] == STEPS_EP
    trees = {"params": state.params, "mu": state.opt_state["mu"],
             "nu": state.opt_state["nu"]}
    for tree, t in trees.items():
        for k, v in flat(t).items():
            np.testing.assert_array_equal(v.detach().numpy(),
                                          saved[tree + k], err_msg=k)
    step = ttrainer.make_train_step(torch_cfg(), ttrainer.TrainConfig(**TRAIN))
    state, m = step(state, torch.from_numpy(
        gang.data["acc1"][1][0].copy()).long())
    assert state.step == STEPS_EP + 1 and np.isfinite(float(m["loss"]))


def test_ep2_sp2_loss_and_grads_match_jax(gang):
    """MoE on the ring: one step's loss and every gradient leaf (router and
    experts included) on ep=2, sp=2 equal JAX's on that mesh."""
    params, (batch,) = gang.data["sp"]
    mesh = jax_mesh(ep=2, sp=2)
    cfg = jax_cfg()
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jtf.loss_fn(p, t, cfg, mesh)[0]))(
        params, jnp.asarray(batch))
    np.testing.assert_allclose(gang.result()[0]["sp"]["loss"], float(loss),
                               rtol=2e-5)
    got = gang.arrays("sp")
    for k, w in flat(jax.tree.map(np.asarray, grads)).items():
        np.testing.assert_allclose(got["grads" + k], w, rtol=5e-4,
                                   atol=2e-5, err_msg=k)


@pytest.mark.parametrize("name,pin,rows,sp", [
    ("acc1", "train/dp2_ep2/moe", 1, 1),
    ("train3d", "train/dp2_ep2_tp2/moe", 1, 1)])
def test_ep_train_steps_hold_the_pinned_budget(gang, name, pin, rows, sp):
    """Every rank's steps make exactly the pinned collectives, two
    all-to-alls a MoE layer forward and two backward, each of E * N_local
    * D f32 values (the rank's dispatched tokens, N_local its rows times
    its positions)."""
    want = comm_gate.expected(pin, DIMS["n_layers"])
    cap = DIMS["n_experts"] * rows * TRAIN["seq_len"] // sp * \
        DIMS["d_model"] * 4
    out = gang.result()
    for r in range(8 if name == "train3d" else 4):
        steps = out[r][name]["collectives"]
        for i, calls in enumerate(steps):
            comm_gate.assert_collective_budget(
                calls, want, f"rank {r} {name} step {i}")
            a2a = [n for op, n in calls if op == "all-to-all"]
            assert a2a == [cap] * len(a2a) and len(a2a) == \
                4 * DIMS["n_layers"]


# ------------------------------------------------------------ in process


def on_threads(n: int, fn):
    group = ThreadGroup(n, timeout=60)
    out, errors = [None] * n, []

    def one(r):
        try:
            out[r] = fn(ExpertLayout(group.comm(r)))
        except BaseException as e:            # noqa: BLE001 — reported
            errors.append(e)
            group.abort()
    threads = [threading.Thread(target=one, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errors:
        raise errors[0]
    return out


def moe_leaves(seed: int, cfg) -> dict:
    lp = ttf.layer_params(ttf.init_params(
        torch.Generator().manual_seed(seed), cfg), 0)
    return {k: lp[k] for k in ("router", "w_gate", "w_up", "w_down")}


@pytest.mark.parametrize("ep", [2, 4])
def test_thread_gang_moe_matches_the_dense_route(ep):
    """`_moe_ffn` on ep virtual ranks (each its E/ep experts and its rows;
    the forwards in their threads, one backward over the sum of the
    ranks' losses): y, aux, dx and every router and expert gradient equal
    the single-device dense route's; each rank makes its two all-to-alls
    forward and two backward, E * N_local * D values each."""
    cfg = torch_cfg(moe_ragged_dispatch=False)
    lp = moe_leaves(ep, cfg)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(4, 8, DIMS["d_model"], generator=gen)
    dy = torch.randn(4, 8, DIMS["d_model"], generator=gen)
    ref = {k: v.detach().clone().requires_grad_(True) for k, v in lp.items()}
    xr = x.clone().requires_grad_(True)
    y, aux = ttf._moe_ffn(xr, ref, cfg)
    (torch.sum(y * dy) + aux).backward()
    rows = 4 // ep

    def rank(layout):
        mine = {k: v.detach().clone().requires_grad_(True)
                for k, v in layout.expert_block(lp).items()}
        r = layout.ep_rank
        xi = x[r * rows:(r + 1) * rows].clone().requires_grad_(True)
        yi, ai = ttf._moe_ffn(xi, mine, cfg, layout)
        return yi, ai, mine, xi
    with comm_gate.record() as calls:
        out = on_threads(ep, rank)
        # aux / ep a rank: the ranks' aux is the global one, and each
        # rank's gradient of it reaches its own router copy.
        total = sum(torch.sum(yi * dy[r * rows:(r + 1) * rows]) + ai / ep
                    for r, (yi, ai, _, _) in enumerate(out))
        total.backward()
    np.testing.assert_allclose(torch.cat([o[0] for o in out]).detach(),
                               y.detach(), rtol=1e-5, atol=1e-6)
    for _, ai, _, _ in out:
        np.testing.assert_allclose(float(ai.detach()), float(aux.detach()),
                                   rtol=1e-6)
    np.testing.assert_allclose(torch.cat([o[3].grad for o in out]),
                               xr.grad, rtol=1e-5, atol=1e-6)
    for k, want in ref.items():
        parts = [o[2][k].grad for o in out]
        got = sum(parts) if k == "router" else torch.cat(parts)
        np.testing.assert_allclose(got, want.grad, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    a2a = [n for op, n in calls if op == "all-to-all"]
    assert a2a == [DIMS["n_experts"] * rows * 8 * DIMS["d_model"] * 4] * (
        4 * ep)


class _OneDpRank:
    """A layout of one dp rank on a mesh of two (ep or tp 2), computing
    with whole weights: what the route gate reads of Fsdp."""
    world, ep, tp, sp = 1, 1, 1, 1
    model_parallel = False

    def __init__(self, axis: str):
        self.size = 2
        self.axis = axis

    def tp_copy(self, x):
        return x

    tp_sum = tp_copy

    def global_means(self, a, b):
        return a, b


@pytest.mark.parametrize("axis", ["ep", "tp"])
def test_a_layout_of_one_dp_rank_takes_the_dense_route(axis, monkeypatch):
    """JAX gates the ragged route on the whole mesh (`mesh.size == 1`): a
    (dp=1, ep=2) or (dp=1, tp=2) layout routes dense, never through the
    capacity-bounded dispatch that drops tokens."""
    def ragged(*_a, **_k):
        raise AssertionError("took the ragged route on a mesh of two")
    monkeypatch.setattr(ttf, "ragged_dispatch", ragged)
    cfg = torch_cfg()
    assert cfg.moe_ragged_dispatch
    lp = moe_leaves(0, cfg)
    x = torch.randn(2, 8, DIMS["d_model"],
                    generator=torch.Generator().manual_seed(1))
    got, aux = ttf._moe_ffn(x, lp, cfg, _OneDpRank(axis))
    want, want_aux = ttf._moe_ffn(
        x, lp, torch_cfg(moe_ragged_dispatch=False))
    assert torch.equal(got, want) and torch.equal(aux, want_aux)


# ------------------------------------------------------------ serving


def jax_serve_params():
    return jtf.init_params(jax.random.PRNGKey(0), jax_cfg(SERVE_DIMS, False))


@functools.lru_cache(maxsize=None)
def port_serve_params():
    return ttf.params_from_numpy(jax.tree.map(np.asarray, jax_serve_params()),
                                 torch_cfg(SERVE_DIMS), "cpu")


def run(eng, prompts=PROMPTS, gens=GENS) -> dict:
    rids = [eng.submit(list(p), n) for p, n in zip(prompts, gens)]
    eng.run()
    return {"tokens": [[int(t) for t in eng.result(r).tokens]
                       for r in rids], "metrics": eng.metrics()}


def drafter(kw: dict) -> dict:
    if not kw.get("spec_k"):
        return kw
    pairs = [[p, t] for p, t in zip(PROMPTS, one_device("paged")["tokens"])]
    return dict(kw, drafter=tsg.OracleDrafter(pairs, SERVE_DIMS["vocab_size"]))


ENGINES = {"dense": ENGINE, "paged": PAGED, "spec": dict(PAGED, spec_k=3)}


@functools.lru_cache(maxsize=None)
def one_device(name: str) -> dict:
    return run(tsrv.ContinuousBatchEngine(
        port_serve_params(), torch_cfg(SERVE_DIMS), device="cpu",
        **drafter(ENGINES[name])))


@functools.lru_cache(maxsize=None)
def jax_engine(name: str) -> list:
    return run(jsrv.ContinuousBatchEngine(
        jax_serve_params(), jax_cfg(SERVE_DIMS, False),
        **ENGINES[name]))["tokens"]


def gang_run(dp: int, tp: int, fn, kw: dict):
    """fn(engine) on the driver of a (dp, tp) thread gang of the MoE
    engine, each rank on its blocks; also the driver's programs'
    collectives ([program, steps, calls])."""
    cfg, full = torch_cfg(SERVE_DIMS), port_serve_params()
    meshes, groups = ServingMesh.thread_gang(dp, tp)
    out, errors = [None], []

    def rank(mesh):
        try:
            eng = tsrv.ContinuousBatchEngine(
                tdecode.shard_params_for_serving(full, cfg, mesh), cfg,
                device="cpu", mesh=mesh, **kw)
            if not mesh.is_driver:
                eng.follow()
                return
            seen, prog = [], eng._prog

            def recorded(name, *args):
                with comm_gate.record(this_thread=True) as calls:
                    res = prog(name, *args)
                seen.append((name, args[0] if name == "chunk" else None,
                             calls))
                return res
            eng._prog = recorded
            try:
                out[0] = (fn(eng), seen)
            finally:
                eng.stop_followers()
        except BaseException as e:            # noqa: BLE001 — reported
            errors.append(e)
            for g in groups:
                g.abort()
    threads = [threading.Thread(target=rank, args=(m,)) for m in meshes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errors:
        raise errors[0]
    return out[0]


@pytest.mark.parametrize("name,dp,tp", [
    ("dense", 1, 2), ("dense", 2, 2), ("paged", 1, 2), ("paged", 2, 2),
    ("spec", 1, 2)])
def test_moe_engines_on_a_mesh_give_one_devices_and_jaxs_tokens(name, dp,
                                                                 tp):
    """The MoE engine on a (dp, tp) thread gang (each rank every expert's
    block of the MLP dim): greedy tokens equal the unmeshed port engine's
    and the JAX engine's on one device; a verify round accepts and
    rejects through the oracle; every full decode chunk and verify round
    makes the dense model's pinned collectives."""
    kw = drafter(ENGINES[name])
    got, programs = gang_run(dp, tp, run, kw)
    want = one_device(name)
    assert got["tokens"] == want["tokens"] == jax_engine(
        "paged" if name == "spec" else name)
    # The dense engine's pin gathers its slots over dp: a mesh of dp 2.
    pins = {"chunk": "serve/decode_chunk/dense" if name == "dense"
            else "serve/decode_chunk/paged/moe",
            "verify": "serve/verify_round/paged"}
    checked = 0
    for prog, steps, calls in programs:
        full = prog == "chunk" and steps == ENGINE["decode_chunk"]
        if (full or prog == "verify") and (name != "dense" or dp == 2):
            comm_gate.assert_collective_budget(calls, comm_gate.expected(
                pins[prog], SERVE_DIMS["n_layers"], steps or 1),
                f"{name} ({dp}, {tp}) {prog}")
            checked += 1
    assert checked or (name == "dense" and dp == 1)
    if name == "spec":
        spec = got["metrics"]["spec"]
        assert 0 < spec["draft_accepted_total"] < spec["draft_proposed_total"]
        assert spec["rounds_total"] == want["metrics"]["spec"]["rounds_total"]


def test_moe_serving_pin_is_the_dense_models():
    """MoE on a tp serving mesh adds no collective: its decode chunk's pin
    is the dense model's."""
    assert comm_gate.BUDGETS["serve/decode_chunk/paged/moe"] == \
        comm_gate.BUDGETS["serve/decode_chunk/paged"]


def test_moe_host_tier_on_a_mesh_is_one_devices():
    """The host tier's traffic (eviction into the tier, its prefetches)
    on the MoE paged engine of a (1, 2) thread gang: tokens, the kvhost
    block, the radix tree, leases and free pages after every phase equal
    the unmeshed engine's."""
    kw = dict(PAGED, kv_num_blocks=9, kv_host_blocks=16)
    got, programs = gang_run(1, 2, tsg.kv_traffic, kw)
    want = tsg.kv_traffic(tsrv.ContinuousBatchEngine(
        port_serve_params(), torch_cfg(SERVE_DIMS), device="cpu", **kw))
    strip = [{k: v for k, v in phase.items() if k != "logprobs"}
             for phase in want]
    assert [{k: v for k, v in phase.items() if k != "logprobs"}
            for phase in got] == strip
    assert got[-2]["state"]["kvhost"]["hits_total"] > 0
    assert {p for p, _, _ in programs} >= {"kv_demote", "kv_restore"}


# ------------------------------------------------------------ the main


def _json_lines(text: str) -> list:
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def _main_gang(axes: str, world: int):
    port = torch_gang.free_port()
    argv = [sys.executable, "-m",
            "k8s_gpu_workload_enhancer_tpu_torch.cmd.trainer", *TINY]
    return [subprocess.Popen(
        argv, env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT),
                       COORDINATOR_ADDRESS=f"localhost:{port}",
                       NUM_PROCESSES=str(world), PROCESS_ID=str(r),
                       KTWE_MESH_AXES=axes),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def test_trainer_main_trains_moe_on_ep_tp_and_sp_gangs(gang, capsys,
                                                       monkeypatch):
    """The trainer main with --n-experts 4 as gangs through KTWE_MESH_AXES
    (dp=2,ep=2 over four processes, tp=2 and sp=2 over two) exits 0 and
    prints the step and final lines of one process on the same global
    batch, the one process on the dense expert route a mesh takes."""
    gang.result()                     # the gang's ranks are done
    runs = {"dp=2,ep=2": 4, "tp=2": 2, "sp=2": 2}
    gangs = {axes: _main_gang(axes, n) for axes, n in runs.items()}
    monkeypatch.setattr(ttf, "TransformerConfig", functools.partial(
        ttf.TransformerConfig, moe_ragged_dispatch=False))
    assert cli.main(TINY) == 0
    want = _json_lines(capsys.readouterr().out)
    try:
        for axes, procs in gangs.items():
            outs = [p.communicate(timeout=torch_gang.GANG_TIMEOUT_S)
                    for p in procs]
            for p, (_, err) in zip(procs, outs):
                assert p.returncode == 0, err[-3000:]
            got = _json_lines(outs[0][0])
            assert all(_json_lines(o) == [] for o, _ in outs[1:])
            assert [set(x) for x in got] == [set(x) for x in want]
            assert got[0]["step"] == 10 and got[1]["final"] is True
            for key in ("loss", "aux"):
                np.testing.assert_allclose(got[0][key], want[0][key],
                                           rtol=1e-5, err_msg=axes)
    finally:
        for procs in gangs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
