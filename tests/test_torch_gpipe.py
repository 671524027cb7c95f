"""Pipeline parallelism on the port, held on the CPU to the JAX package on the
same meshes: the pp axis of parallel/mesh.py and parallel/sharding.py (the
layer-stack form), the explicit GPipe schedule of parallel/pipeline.py, the
trainer's `loss_fn` override, the checkpoint on a pp mesh, the pins of
parallel/comm_gate.py and the trainer main's --pipeline-microbatches.

One gloo gang of eight ranks (tests/torch_gang.py) runs five meshes in
turn, f32, on numpy weights and batches the JAX side shares:

- dp=2, pp=4: the schedule on JAX's tanh stage (tests/unit/test_pipeline.py:
  L 8, D 16, mb 4, M 6) against JAX's `gpipe` and the sequential stack
  (rtol 1e-5, atol 1e-6; gradients rtol 1e-4, atol 1e-6); three steps
  through `gpipe_lm_loss` (M 4, batch 4: the replicated batch axes)
  against three of the layer-stack path and JAX's trajectory (JAX's
  `test_trainer_trains_through_gpipe_and_matches_stack_sharding`: rtol
  1e-4, atol 1e-5);
- dp=2, pp=2, ep=2: `gpipe_lm_loss` at M 2, 4 and 8 of a batch of 8 (the
  batch axes (dp, ep), dp and none) against JAX's on that mesh, loss and
  every gradient; two GPipe steps (M 2) against the JAX trainer through
  JAX's `gpipe_lm_loss`; two layer-stack MoE steps against the JAX
  trainer (the dryrun's second leg, `__graft_entry__.dryrun_multichip`);
- pp=2, tp=2, sp=2: two layer-stack MoE steps against the JAX trainer
  (ring attention over sp); the GPipe schedule replicated over tp and sp,
  as JAX's is: `gpipe_lm_loss` at M 2 (loss and every gradient) and two
  GPipe steps against JAX's on that mesh, and two GPipe steps of a one
  KV head model (the KV projections replicated over tp, whose gradient
  no tp sum may scale) against JAX with the KV heads replicated;
- dp=2, pp=2 (four ranks): two dense layer-stack steps against the JAX
  trainer, saved; one GPipe step; a step from a checkpoint saved on one
  device;
- pp=2 (two ranks): one GPipe step.

Each step's collectives hold their pins, per rank and stage; a handoff
carries at most one microbatch's activation. In process: the schedule and
the LM loss on gangs of threads (parallel/comm.ThreadGroup, the card's
virtual ranks), at pp 1 against `tf.loss_fn` and JAX's `gpipe_lm_loss`, the
MoE refusal, the checkpoint both ways, and the trainer main on (dp=2, pp=2)
gangs of processes with and without --pipeline-microbatches and on a
(pp=2, tp=2) gang with it, and its two bad configurations with JAX's
messages. The schedule on a (pp=2, tp=2) gang of threads (the card's
virtual tp gang: `StageLayout` with a tp `Comm`) against `tf.loss_fn`.
"""

import collections
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

from k8s_gpu_workload_enhancer_tpu.models import transformer as jtf
from k8s_gpu_workload_enhancer_tpu.parallel import mesh as jmesh
from k8s_gpu_workload_enhancer_tpu.parallel import pipeline as jpl
from k8s_gpu_workload_enhancer_tpu.parallel import sharding as jsharding
from k8s_gpu_workload_enhancer_tpu.train import trainer as jtrainer
from k8s_gpu_workload_enhancer_tpu_torch.cmd import trainer as cli
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.parallel import comm_gate
from k8s_gpu_workload_enhancer_tpu_torch.parallel import pipeline as tpl
from k8s_gpu_workload_enhancer_tpu_torch.parallel.comm import ThreadGroup
from k8s_gpu_workload_enhancer_tpu_torch.parallel.sharding import (
    StageLayout)
from k8s_gpu_workload_enhancer_tpu_torch.train import checkpoint as tckpt
from k8s_gpu_workload_enhancer_tpu_torch.train import trainer as ttrainer

import torch_gang
import torch_parity  # noqa: F401  (one intra-op thread a process)

ROOT = torch_gang.ROOT
# JAX's TestGPipeDrivesKTWELM model, and its MoE test model
# (tests/test_torch_expert_parallel.py's).
DENSE = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=2,
             n_kv_heads=2, d_ff=64, max_seq=16)
DENSE2 = dict(DENSE, n_layers=2)
DENSE_KV1 = dict(DENSE, n_kv_heads=1)
MOE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
           d_ff=128, max_seq=64, n_experts=4)
TRAIN = dict(warmup_steps=1, total_steps=50, batch_size=4, seq_len=16,
             learning_rate=1e-3)
TRAIN8 = dict(TRAIN, batch_size=8)
MOE_TRAIN = dict(warmup_steps=1, total_steps=5, batch_size=8, seq_len=32,
                 learning_rate=1e-3)
TANH = dict(L=8, D=16, MB=4, M=6)
STEPS = 3
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LM_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-5)
MICROBATCHES = (2, 4, 8)
TINY = ["--device", "cpu", "--seq-len", "16", "--d-model", "64",
        "--n-layers", "2", "--n-heads", "2", "--d-ff", "128",
        "--vocab-size", "128", "--batch-size", "4", "--steps", "10"]


def flat(tree, prefix=""):
    return torch_gang.flat(tree, prefix)


def numpy_params(dims: dict, seed: int) -> dict:
    params = ttf.init_params(torch.Generator().manual_seed(seed),
                             torch_cfg(dims))
    return {k: ({n: t.numpy() for n, t in v.items()}
                if isinstance(v, dict) else v.numpy())
            for k, v in params.items()}


def tokens(shape, seed: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def torch_cfg(dims: dict, **kw) -> ttf.TransformerConfig:
    return ttf.TransformerConfig(**dims, dtype=torch.float32, **kw)


def jax_cfg(dims: dict) -> jtf.TransformerConfig:
    return jtf.TransformerConfig(**dims, dtype=jnp.float32, use_flash=False,
                                 use_ring_attention="n_experts" in dims)


def jax_mesh(**sizes):
    n = int(np.prod(list(sizes.values())))
    return jmesh.make_mesh(jmesh.MeshConfig(**sizes),
                           devices=jax.devices()[:n])


def tanh_inputs() -> dict:
    g = np.random.default_rng(7)
    L, D, MB, M = (TANH[k] for k in ("L", "D", "MB", "M"))
    return {"w": (g.standard_normal((L, D, D)) * D ** -0.5).astype(
                np.float32),
            "b": (g.standard_normal((L, D)) * 0.01).astype(np.float32),
            "xs": g.standard_normal((M, MB, D)).astype(np.float32)}


def one_device_ckpt(path, dims, train, params, batch) -> None:
    """A checkpoint of one device's state after one step from `params`."""
    cfg, tc = torch_cfg(dims), ttrainer.TrainConfig(**train)
    state = port_state(cfg, tc, params)
    state, _ = ttrainer.make_train_step(cfg, tc)(
        state, torch.from_numpy(batch).long())
    tckpt.CheckpointManager(str(path)).save(state.step, state)


def port_state(cfg, tc, params):
    state = ttrainer.init_state(cfg, tc, torch.Generator().manual_seed(0))
    state.params = ttrainer.tree_map(
        lambda p: p.requires_grad_(True),
        ttf.params_from_numpy(params, cfg, "cpu"))
    state.opt_state = ttrainer.make_optimizer(tc).init(state.params)
    return state


def job(name: str, dims: dict, train: dict, data: str, **kw) -> dict:
    return dict(name=name, model=dims, train=train,
                params=f"{data}/params", batches=f"{data}/batches", **kw)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The gang of eight on its five meshes, started before the JAX
    references compile (see the module note)."""
    job_dir = tmp_path_factory.mktemp("pp")
    data = {
        "d4": (numpy_params(DENSE, 0),
               [tokens((4, 17), 10 + i, 128) for i in range(STEPS)]),
        "d8": (numpy_params(DENSE, 1),
               [tokens((8, 17), 20 + i, 128) for i in range(2)]),
        "moe": (numpy_params(MOE, 2),
                [tokens((8, 33), 30 + i, 256) for i in range(2)]),
        "mp": (numpy_params(MOE, 3),
               [tokens((8, 33), 40 + i, 256) for i in range(2)]),
        "d2": (numpy_params(DENSE2, 4),
               [tokens((8, 17), 50 + i, 128) for i in range(2)]),
        "tp": (numpy_params(DENSE, 5),
               [tokens((8, 17), 60 + i, 128) for i in range(2)]),
        "kv": (numpy_params(DENSE_KV1, 6),
               [tokens((8, 17), 70 + i, 128) for i in range(2)]),
    }
    inputs = {f"tanh/{k}": v for k, v in tanh_inputs().items()}
    for name, (params, batches) in data.items():
        inputs.update({f"{name}/params{k}": v
                       for k, v in flat(params).items()})
        inputs.update({f"{name}/batches/{i}": b
                       for i, b in enumerate(batches)})
    one_device_ckpt(job_dir / "ckpt-one", DENSE2, TRAIN8, data["d2"][0],
                    data["d2"][1][0])
    grads = [job(f"g{m}", DENSE, TRAIN8, "d8", kind="grads",
                 batch="d8/batches/0", gpipe=m) for m in MICROBATCHES]
    phases = [
        dict(mesh_axes="dp=2,pp=4", jobs=[
            dict(name="tanh", kind="tanh", tensors="tanh"),
            job("stack4", DENSE, TRAIN, "d4", steps=STEPS),
            job("gpipe4", DENSE, TRAIN, "d4", steps=STEPS, gpipe=4)]),
        dict(mesh_axes="dp=2,pp=2,ep=2", jobs=grads + [
            job("gpipe3d", DENSE, TRAIN8, "d8", steps=2, gpipe=2),
            job("moe3d", MOE, MOE_TRAIN, "moe", steps=2)]),
        dict(mesh_axes="pp=2,tp=2,sp=2", jobs=[
            job("moe_mp", MOE, MOE_TRAIN, "mp", steps=2),
            job("gtp", DENSE, TRAIN8, "tp", kind="grads",
                batch="tp/batches/0", gpipe=2),
            job("gpipe_tp", DENSE, TRAIN8, "tp", steps=2, gpipe=2),
            job("gpipe_kv", DENSE_KV1, TRAIN8, "kv", steps=2, gpipe=2)]),
        dict(mesh_axes="dp=2,pp=2", world=4, jobs=[
            job("stack2", DENSE2, TRAIN8, "d2", steps=2, save="ckpt-pp"),
            job("gpipe2", DENSE2, TRAIN8, "d2", steps=1, gpipe=2),
            job("resume2", DENSE2, TRAIN8, "d2", steps=2,
                restore="ckpt-one")]),
        dict(mesh_axes="pp=2", world=2, jobs=[
            job("gpipe1", DENSE2, TRAIN8, "d2", steps=1, gpipe=2)]),
    ]
    g = torch_gang.Gang(job_dir, 8, phases, inputs)
    g.data = data
    yield g
    g.close()


def jax_train(dims: dict, params: dict, batches, train: dict, mesh,
              microbatches: int = 0, rules=None):
    """The JAX trainer's metrics and final params on `mesh` from `params`,
    through JAX's `gpipe_lm_loss` with `microbatches` > 0, the params laid
    out by `rules` (None: JAX's default rules)."""
    cfg = jax_cfg(dims)
    tc = jtrainer.TrainConfig(**train)
    p = jax.device_put(params, jtrainer.param_shardings(cfg, mesh, rules))
    state = jtrainer.TrainState(
        params=p, opt_state=jtrainer.make_optimizer(tc).init(p),
        step=jnp.zeros((), jnp.int32))
    loss_fn = (None if not microbatches else
               lambda p, t, c, m: jpl.gpipe_lm_loss(p, t, c, m,
                                                    microbatches))
    step = jtrainer.make_train_step(cfg, tc, mesh, rules, loss_fn=loss_fn)
    metrics = []
    for toks in batches:
        state, m = step(state, jnp.asarray(toks))
        metrics.append({k: float(m[k]) for k in ("loss", "nll", "aux",
                                                 "grad_norm")})
    return metrics, jax.tree.map(np.asarray, state.params)


def assert_metrics(got: list, want: list, what: str, keys=(
        "loss", "nll", "aux", "grad_norm")) -> None:
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for key in keys:
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


def same_on_every_rank(out: list, name: str, world: int = 8) -> list:
    metrics = out[0][name]["metrics"]
    assert all(o[name]["metrics"] == metrics for o in out[:world])
    return metrics


# ------------------------------------------------------------ arithmetic


def test_num_ticks_and_bubble_fraction_match_jax():
    for m in (1, 2, 3, 4, 6, 8, 32):
        for p in (1, 2, 4, 8):
            assert tpl.num_ticks(m, p) == jpl.num_ticks(m, p)
            assert tpl.bubble_fraction(m, p) == jpl.bubble_fraction(m, p)
    assert tpl.bubble_fraction(4, 2) == (2 - 1) / 5
    assert tpl.bubble_fraction(1, 1) == 0.0


def test_transformer_stage_fn_refuses_moe():
    with pytest.raises(ValueError, match="MoE pipelines via layer-stack"):
        tpl.transformer_stage_fn(torch_cfg(MOE))
    with pytest.raises(ValueError):
        jpl.transformer_stage_fn(jax_cfg(MOE))


@pytest.mark.parametrize("dp,ep,mb,want", [
    (2, 2, 4, ("dp", "ep")), (2, 2, 2, ("dp",)), (2, 2, 1, None),
    (2, 1, 2, ("dp", "ep")), (2, 4, 2, ("dp",)), (1, 1, 4, None)])
def test_batch_axes_are_jaxs_three_cases(dp, ep, mb, want):
    """`batch_axes` is JAX `gpipe_lm_loss`'s choice; `batch_split` the
    rank's block under it."""
    class Layout:
        world, rank, batch_ranks, batch_rank = dp, dp - 1, dp * ep, 1
    Layout.ep = ep
    assert tpl.batch_axes(Layout, mb) == want
    n = {("dp", "ep"): dp * ep, ("dp",): dp, None: 1}[want]
    assert tpl.batch_split(Layout, mb)[0] == n


# ------------------------------------------------------------ threads


def on_threads(n: int, fn):
    group = ThreadGroup(n, timeout=60)
    out, errors = [None] * n, []

    def one(r):
        try:
            out[r] = fn(StageLayout(group.comm(r)))
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


def tanh_layer(x, lp):
    return torch.tanh(x @ lp["w"] + lp["b"])


def sequential(params: dict, xs: torch.Tensor) -> torch.Tensor:
    return tpl.gpipe(tpl.stack_stage_fn(tanh_layer), params, xs)


def test_gpipe_pp1_is_the_per_microbatch_map():
    """The pp 1 branch (no layout, and a layout of one stage) against
    JAX's vmap branch on a dp=8 mesh."""
    t = tanh_inputs()
    want = jpl.gpipe(jpl.stack_stage_fn(
        lambda x, lp: jnp.tanh(x @ lp["w"] + lp["b"])),
        {"w": t["w"], "b": t["b"]}, t["xs"], jax_mesh(dp=8))
    params = {k: torch.from_numpy(t[k]) for k in ("w", "b")}
    xs = torch.from_numpy(t["xs"])
    got = sequential(params, xs)
    # JAX's schedule tolerance: its pp 1 test's rtol 1e-6 holds XLA to
    # itself, here two libraries' f32 products differ by up to 2e-7.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    one = on_threads(1, lambda lay: tpl.gpipe(
        tpl.stack_stage_fn(tanh_layer), params, xs, lay))[0]
    assert torch.equal(one, got)


@pytest.mark.parametrize("pp", [2, 4])
def test_gpipe_on_a_thread_gang_matches_the_sequential_stack(pp):
    """The card's form: the stages on threads, one backward over the
    ranks' losses. Every rank's output and the stages' gradients equal the
    sequential stack's; each rank hands one microbatch's activation a
    call, forward and back, 2 M a neighbour."""
    t = tanh_inputs()
    full = {k: torch.from_numpy(t[k]).requires_grad_(True)
            for k in ("w", "b")}
    xs = torch.from_numpy(t["xs"])
    ref = sequential(full, xs)
    (ref ** 2).mean().backward()
    blocks = [None] * pp

    def rank(layout):
        mine = {k: v.detach().clone().requires_grad_(True) for k, v in
                layout.stage_block(full).items()}
        blocks[layout.pp_rank] = mine
        return tpl.gpipe(tpl.stack_stage_fn(tanh_layer), mine, xs, layout)
    with comm_gate.record() as calls:
        outs = on_threads(pp, rank)
        sum((o ** 2).mean() for o in outs).backward()
    for o in outs:
        np.testing.assert_allclose(o.detach(), ref.detach(), **OUT_TOL)
    for k, v in full.items():
        np.testing.assert_allclose(torch.cat([b[k].grad for b in blocks]),
                                   v.grad, **GRAD_TOL)
    p2p = [n for op, n in calls if op == "p2p"]
    assert len(p2p) == 4 * TANH["M"] * (pp - 1)
    assert max(p2p) == TANH["MB"] * TANH["D"] * 4


def thread_lm(pp: int, params: dict, toks: torch.Tensor, cfg, fn):
    """fn(rank params, layout) on a thread gang of pp stages, each rank
    with its stage's layers and its own copies of the other leaves; one
    backward over the sum of the ranks' losses. Returns (losses, full
    gradients: the stacked leaves' stage blocks joined, the others pp
    rank 0's)."""
    ranks = [None] * pp

    def rank(layout):
        mine = {k: v.detach().clone().requires_grad_(True)
                for k, v in params.items() if k != "layers"}
        mine["layers"] = {k: v.detach().clone().requires_grad_(True)
                          for k, v in layout.stage_block(
                              params["layers"]).items()}
        ranks[layout.pp_rank] = mine
        return fn(mine, layout)
    losses = on_threads(pp, rank)
    sum(losses).backward()
    grads = {k: (ranks[0][k].grad if ranks[0][k].grad is not None
                 else torch.zeros_like(ranks[0][k]))
             for k in params if k != "layers"}
    grads["layers"] = {k: torch.cat([r["layers"][k].grad for r in ranks])
                       for k in params["layers"]}
    return [float(x.detach()) for x in losses], grads


def lm_reference(dims: dict, seed: int, shape):
    cfg = torch_cfg(dims)
    params = ttf.init_params(torch.Generator().manual_seed(seed), cfg)
    toks = torch.from_numpy(tokens(shape, seed, dims["vocab_size"])).long()
    leaves = ttrainer.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = ttf.loss_fn(params, toks, cfg)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return cfg, params, toks, float(loss.detach()), ttrainer.tree_map(
        lambda _: next(it), params)


def assert_grads(got: dict, want: dict, what: str, tol=LM_GRAD_TOL):
    for k, w in flat(want).items():
        g = flat(got)[k]
        np.testing.assert_allclose(np.asarray(g.detach() if isinstance(
            g, torch.Tensor) else g), np.asarray(w.detach() if isinstance(
                w, torch.Tensor) else w), err_msg=f"{what} {k}", **tol)


def test_gpipe_lm_loss_at_pp1_matches_loss_fn_and_jax():
    """JAX's `test_gpipe_lm_matches_loss_fn`: at pp 1 the loss and every
    gradient equal the port's own `tf.loss_fn`, and JAX's
    `gpipe_lm_loss` on the same weights and tokens."""
    cfg, params, toks, ref, gref = lm_reference(DENSE, 5, (4, 17))
    got, parts = tpl.gpipe_lm_loss(params, toks, cfg, None, 2)
    assert float(parts["aux"]) == 0.0 and parts["nll"] is got
    np.testing.assert_allclose(float(got.detach()), ref, **OUT_TOL)
    grads = ttrainer._grad(got, params)
    assert_grads(grads, gref, "pp1 vs loss_fn")
    jp = jax.tree.map(lambda t: t.detach().numpy(), params)
    jcfg = jax_cfg(DENSE)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, t: jpl.gpipe_lm_loss(
        p, t, jcfg, jax_mesh(dp=1), 2)[0]))(jp, jnp.asarray(toks.numpy()))
    np.testing.assert_allclose(float(got.detach()), float(jl), **OUT_TOL)
    assert_grads(grads, jax.tree.map(np.asarray, jg), "pp1 vs JAX")


@pytest.mark.parametrize("pp", [2, 4])
def test_gpipe_lm_loss_on_a_thread_gang_matches_loss_fn(pp):
    """The LM loss through the schedule on pp virtual stages: every
    stage's loss and the joined gradients equal the one-device
    `tf.loss_fn`'s."""
    cfg, params, toks, ref, gref = lm_reference(DENSE, 6, (4, 17))
    losses, grads = thread_lm(pp, params, toks, cfg, lambda p, lay:
                              tpl.gpipe_lm_loss(p, toks, cfg, lay, 2)[0])
    np.testing.assert_allclose(losses, [ref] * pp, **OUT_TOL)
    assert_grads(grads, gref, f"pp={pp} threads")


@pytest.mark.parametrize("kv_heads", [2, 1])
def test_gpipe_lm_loss_on_a_pp2_tp2_thread_gang_matches_loss_fn(kv_heads):
    """The card's virtual (pp=2, tp=2) gang: `StageLayout` over a pp and
    a tp `Comm` of threads, each rank with its stage's tp blocks; the
    stage gathered whole over tp, the embedding, head and CE
    vocab-parallel. Every rank's loss and the gradients, the ranks'
    blocks joined, equal one device's `tf.loss_fn`; the tp-replicated
    leaves' gradients are the same on both tp ranks (with one KV head wk
    and wv too); the gang's collectives are the ranks' pins
    (`train/gpipe/pp2_tp2/threads`; with one KV head wk and wv are not
    gathered)."""
    dims = dict(DENSE, n_kv_heads=kv_heads)
    cfg, params, toks, ref, gref = lm_reference(dims, 9, (4, 17))
    pp = tp = 2
    pp_groups = [ThreadGroup(pp, timeout=60) for _ in range(tp)]
    tp_groups = [ThreadGroup(tp, timeout=60) for _ in range(pp)]
    ranks, errors = [None] * (pp * tp), []

    def rank(r):
        s, t = divmod(r, tp)
        try:
            lay = StageLayout(pp_groups[t].comm(s), tp_groups[s].comm(t),
                              cfg)
            full = {k: v for k, v in params.items() if k != "layers"}
            full["layers"] = lay.stage_block(params["layers"])
            mine = ttrainer.tree_map(
                lambda x: x.detach().clone().requires_grad_(True),
                lay.tp_block(full))
            ranks[r] = (lay, mine, tpl.gpipe_lm_loss(mine, toks, cfg, lay,
                                                     2)[0])
        except BaseException as e:            # noqa: BLE001 — reported
            errors.append(e)
            for g in pp_groups + tp_groups:
                g.abort()
    with comm_gate.record() as calls:
        threads = [threading.Thread(target=rank, args=(r,))
                   for r in range(pp * tp)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        if errors:
            raise errors[0]
        sum(loss for _, _, loss in ranks).backward()
    np.testing.assert_allclose([float(x.detach()) for _, _, x in ranks],
                               [ref] * (pp * tp), **OUT_TOL)
    dims_tp = ranks[0][0].tp_dims
    grads = {}
    for k in params:
        if k == "layers":
            continue
        blocks = [ranks[t][1][k].grad for t in range(tp)]
        d = dims_tp[k]
        grads[k] = blocks[0] if d is None else torch.cat(blocks, d)
    grads["layers"] = {}
    for k in params["layers"]:
        d = dims_tp["layers"][k]
        stages = []
        for s in range(pp):
            blocks = [ranks[s * tp + t][1]["layers"][k].grad
                      for t in range(tp)]
            if d is None:
                assert torch.equal(blocks[0], blocks[1]), k
            stages.append(blocks[0] if d is None else torch.cat(blocks, d))
        grads["layers"][k] = torch.cat(stages)
    assert_grads(grads, gref, f"pp=2 tp=2 threads, {kv_heads} kv heads")
    assert (dims_tp["layers"]["wk"] is None) == (kv_heads == 1)
    want = collections.Counter()
    for r in range(pp * tp):
        want.update(comm_gate.expected("train/gpipe/pp2_tp2/threads",
                                       microbatches=2, stage=r // tp,
                                       stages=pp))
    if kv_heads == 1:
        want["all-gather"] -= 2 * pp * tp
    comm_gate.assert_collective_budget(calls, dict(want),
                                       f"pp=2 tp=2 threads, {kv_heads} kv")


def test_layer_stack_moe_on_a_thread_gang_matches_one_device():
    """The layer-stack form on two virtual stages, MoE (each stage one
    layer, broadcast from it; the dense expert route): loss and every
    gradient equal the one-device model's on the dense route."""
    cfg, params, toks, ref, gref = lm_reference(
        dict(MOE, max_seq=32), 8, (2, 33))
    dense = torch_cfg(dict(MOE, max_seq=32), moe_ragged_dispatch=False)
    ref, _ = ttf.loss_fn(params, toks, dense)
    gref = ttrainer._grad(ref, params)
    losses, grads = thread_lm(2, params, toks, cfg, lambda p, lay: ttf.loss_fn(
        p, toks, cfg, fsdp=lay)[0])
    np.testing.assert_allclose(losses, [float(ref.detach())] * 2, **OUT_TOL)
    assert_grads(grads, gref, "layer-stack threads")


# ------------------------------------------------------------ the gang


def test_tanh_schedule_on_dp2_pp4_matches_jax_and_the_stack(gang):
    """JAX's `test_gpipe_matches_sequential` and its gradient twin on the
    gang: every rank's output, and each stage's w and b gradients joined
    over the stages, against JAX's `gpipe` on (dp=2, pp=4) and the
    sequential stack."""
    t = tanh_inputs()
    mesh = jax_mesh(dp=2, pp=4)
    stage = jpl.stack_stage_fn(lambda x, lp: jnp.tanh(x @ lp["w"] + lp["b"]))
    params = {"w": t["w"], "b": t["b"]}
    want = jax.jit(lambda p: jpl.gpipe(stage, p, t["xs"], mesh))(params)
    jgrads = jax.jit(jax.grad(lambda p: (jpl.gpipe(
        stage, p, t["xs"], mesh) ** 2).mean()))(params)
    full = {k: torch.from_numpy(t[k]).requires_grad_(True)
            for k in ("w", "b")}
    seq = sequential(full, torch.from_numpy(t["xs"]))
    (seq ** 2).mean().backward()
    by_stage = {}
    for coords, arrays in gang.rank_arrays("tanh"):
        np.testing.assert_allclose(arrays["out"], np.asarray(want),
                                   **OUT_TOL)
        np.testing.assert_allclose(arrays["out"], seq.detach(), **OUT_TOL)
        by_stage.setdefault(coords["dp"], {})[coords["pp"]] = arrays
    for dp, stages in by_stage.items():
        for k in ("w", "b"):
            got = np.concatenate([stages[r][k] for r in range(4)])
            np.testing.assert_allclose(got, np.asarray(jgrads[k]),
                                       err_msg=k, **GRAD_TOL)
            np.testing.assert_allclose(got, full[k].grad, err_msg=k,
                                       **GRAD_TOL)


def test_gpipe_steps_track_the_layer_stack_and_jax_on_dp2_pp4(gang):
    """JAX's `test_trainer_trains_through_gpipe_and_matches_stack_sharding`:
    three steps through the schedule (M 4 of a batch of 4: every rank
    pipelines the whole batch) and three of the layer-stack path from the
    same weights and batches, both against JAX's layer-stack trajectory on
    (dp=2, pp=4): metrics and final params."""
    params, batches = gang.data["d4"]
    want, want_params = jax_train(DENSE, params, batches, TRAIN,
                                  jax_mesh(dp=2, pp=4))
    out = gang.result()
    for name in ("stack4", "gpipe4"):
        assert_metrics(same_on_every_rank(out, name), want, name)
        assert_tree(gang.arrays(name), "params", want_params, name)
    assert_metrics(out[0]["gpipe4"]["metrics"], out[0]["stack4"]["metrics"],
                   "gpipe vs stack")
    # The stacked leaves and their moments are split over pp on dim 0.
    blocks = out[0]["stack4"]["blocks"]
    assert blocks["params/layers/wq"][0] == DENSE["n_layers"] // 4
    assert blocks["nu/layers/ln1"][0] == DENSE["n_layers"] // 4
    assert out[0]["stack4"]["pp_dims"]["/layers/w_up"] == 0
    assert out[0]["stack4"]["pp_dims"]["/embed"] is None


@pytest.mark.parametrize("m", MICROBATCHES)
def test_gpipe_lm_loss_on_dp2_pp2_ep2_matches_jax(gang, m):
    """`gpipe_lm_loss` on (dp=2, pp=2, ep=2) at M 2, 4 and 8 of a batch of
    8: JAX's three batch-axes cases ((dp, ep), dp, none); loss and every
    gradient against JAX's on that mesh, and the rows each rank took."""
    params, (batch, _) = gang.data["d8"]
    jcfg = jax_cfg(DENSE)
    mesh = jax_mesh(dp=2, pp=2, ep=2)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, t: jpl.gpipe_lm_loss(
        p, t, jcfg, mesh, m)[0]))(params, jnp.asarray(batch))
    out = gang.result()
    name = f"g{m}"
    rows = {2: 2, 4: 4, 8: 8}[m]
    assert all(o[name]["rows"] == [rows, 17] for o in out)
    for o in out:
        np.testing.assert_allclose(o[name]["loss"], float(loss), **OUT_TOL)
    got = gang.arrays(name)
    for k, w in flat(jax.tree.map(np.asarray, grads)).items():
        np.testing.assert_allclose(got["grads" + k], w, err_msg=k,
                                   **LM_GRAD_TOL)


def test_gpipe_steps_on_dp2_pp2_ep2_match_jax(gang):
    """Two train steps through the schedule (M 2) on (dp=2, pp=2, ep=2)
    against the JAX trainer through JAX's `gpipe_lm_loss` on that mesh."""
    params, batches = gang.data["d8"]
    want, want_params = jax_train(DENSE, params, batches, TRAIN8,
                                  jax_mesh(dp=2, pp=2, ep=2), 2)
    out = gang.result()
    assert_metrics(same_on_every_rank(out, "gpipe3d"), want, "gpipe3d")
    assert_tree(gang.arrays("gpipe3d"), "params", want_params, "gpipe3d")


def test_gpipe_lm_loss_on_pp2_tp2_sp2_matches_jax(gang):
    """`gpipe_lm_loss` on (pp=2, tp=2, sp=2) at M 2 of a batch of 8: the
    stage replicated over tp and sp, as JAX's (its `param_specs` name only
    pp, its `xs_spec` only the batch axes); loss and every gradient
    against JAX's `gpipe_lm_loss` on that mesh, every rank on the whole
    batch."""
    params, (batch, _) = gang.data["tp"]
    jcfg = jax_cfg(DENSE)
    mesh = jax_mesh(pp=2, tp=2, sp=2)
    p = jax.device_put(params, jtrainer.param_shardings(jcfg, mesh))
    loss, grads = jax.jit(jax.value_and_grad(lambda p, t: jpl.gpipe_lm_loss(
        p, t, jcfg, mesh, 2)[0]))(p, jnp.asarray(batch))
    out = gang.result()
    assert all(o["gtp"]["rows"] == [8, 17] for o in out)
    for o in out:
        np.testing.assert_allclose(o["gtp"]["loss"], float(loss), **OUT_TOL)
    got = gang.arrays("gtp")
    for k, w in flat(jax.tree.map(np.asarray, grads)).items():
        np.testing.assert_allclose(got["grads" + k], w, err_msg=k,
                                   **LM_GRAD_TOL)


@pytest.mark.parametrize("name,dims,data,rules", [
    ("gpipe_tp", DENSE, "tp", None),
    ("gpipe_kv", DENSE_KV1, "kv", dict(jsharding.DEFAULT_RULES,
                                       kv_heads=None))])
def test_gpipe_steps_on_pp2_tp2_sp2_match_jax(gang, name, dims, data,
                                              rules):
    """Two GPipe steps (M 2) on (pp=2, tp=2, sp=2) against the JAX
    trainer through JAX's `gpipe_lm_loss` on that mesh: the dense model,
    and one KV head (the port replicates wk and wv over tp; JAX with the
    KV heads replicated, its default rule cannot lay one head over two
    devices). A KV gradient summed over tp would double their share of
    the grad norm."""
    params, batches = gang.data[data]
    want, want_params = jax_train(dims, params, batches, TRAIN8,
                                  jax_mesh(pp=2, tp=2, sp=2), 2, rules)
    out = gang.result()
    assert_metrics(same_on_every_rank(out, name), want, name)
    assert_tree(gang.arrays(name), "params", want_params, name)


@pytest.mark.parametrize("name,axes,data", [
    ("moe3d", dict(dp=2, pp=2, ep=2), "moe"),
    ("moe_mp", dict(pp=2, tp=2, sp=2), "mp")])
def test_layer_stack_moe_steps_match_jax(gang, name, axes, data):
    """Two layer-stack MoE steps (the layers on pp, the experts on ep, the
    dense route) on (dp=2, pp=2, ep=2), the dryrun's second leg, and on
    (pp=2, tp=2, sp=2), against the JAX trainer on the same mesh."""
    params, batches = gang.data[data]
    want, want_params = jax_train(MOE, params, batches, MOE_TRAIN,
                                  jax_mesh(**axes))
    out = gang.result()
    assert_metrics(same_on_every_rank(out, name), want, name)
    assert_tree(gang.arrays(name), "params", want_params, name)
    assert all(m["aux"] > 0.5 for m in want)


def test_layer_stack_dense_steps_on_dp2_pp2_match_jax(gang):
    params, batches = gang.data["d2"]
    want, want_params = jax_train(DENSE2, params, batches, TRAIN8,
                                  jax_mesh(dp=2, pp=2))
    out = gang.result()
    assert_metrics(same_on_every_rank(out, "stack2", 4), want, "stack2")
    assert_tree(gang.arrays("stack2"), "params", want_params, "stack2")


def test_checkpoint_of_dp2_pp2_resumes_on_one_device_and_back(gang):
    """The (dp=2, pp=2) checkpoint (every layer gathered over pp) restores
    on one device to the gang's state leaf for leaf and trains on; and a
    one-device checkpoint restores on (dp=2, pp=2) to one device's next
    step."""
    saved = gang.arrays("stack2")
    cfg, tc = torch_cfg(DENSE2), ttrainer.TrainConfig(**TRAIN8)
    target = ttrainer.init_state(cfg, tc, torch.Generator().manual_seed(5))
    state = tckpt.CheckpointManager(str(gang.dir / "ckpt-pp")).restore(
        None, target)
    assert state.step == state.opt_state["count"] == 2
    trees = {"params": state.params, "mu": state.opt_state["mu"],
             "nu": state.opt_state["nu"]}
    for tree, t in trees.items():
        for k, v in flat(t).items():
            np.testing.assert_array_equal(v.detach().numpy(),
                                          saved[tree + k], err_msg=k)
    step = ttrainer.make_train_step(cfg, tc)
    batches = gang.data["d2"][1]
    state, m = step(state, torch.from_numpy(batches[0].copy()).long())
    assert state.step == 3 and np.isfinite(float(m["loss"]))
    # Back: the gang's steps from the one-device checkpoint (after step 1
    # on batch 0) equal one device's from it.
    one = tckpt.CheckpointManager(str(gang.dir / "ckpt-one")).restore(
        None, ttrainer.init_state(cfg, tc, torch.Generator().manual_seed(6)))
    want = []
    for b in batches:
        one, m = step(one, torch.from_numpy(b.copy()).long())
        want.append({k: float(m[k]) for k in ("loss", "nll", "aux",
                                               "grad_norm")})
    out = gang.result()
    assert out[0]["resume2"]["step"] == 3
    assert_metrics(same_on_every_rank(out, "resume2", 4), want, "resume2")
    assert_tree(gang.arrays("resume2"), "params", one.params, "resume2")


@pytest.mark.parametrize("name,pin,world,stages,rows,seq", [
    ("stack2", "train/dp2_pp2", 4, 2, 0, 0),
    ("moe3d", "train/dp2_pp2_ep2/moe", 8, 2, 0, 0),
    ("gpipe2", "train/gpipe/dp2_pp2", 4, 2, 2, 16),
    ("gpipe1", "train/gpipe/pp2", 2, 2, 4, 16),
    ("gpipe3d", "train/gpipe/dp2_pp2_ep2", 8, 2, 1, 16),
    ("gpipe_tp", "train/gpipe/pp2_tp2_sp2", 8, 2, 4, 16),
    ("gpipe_kv", "train/gpipe/pp2_tp2_sp2/kv_replicated", 8, 2, 4, 16)])
def test_pp_train_steps_hold_the_pinned_budget(gang, name, pin, world,
                                               stages, rows, seq):
    """Every rank's steps make exactly the pinned collectives for its
    stage; each GPipe handoff carries at most one microbatch's
    activation (the rank's rows of it x seq x d_model f32 values); a
    change of count fails the gate."""
    out = gang.result()
    dims = {"moe3d": MOE, "gpipe3d": DENSE, "gpipe_tp": DENSE,
            "gpipe_kv": DENSE}.get(name, DENSE2)
    m = 2 if rows else 0
    for r in range(world):
        stage = out[r][name]["coords"]["pp"]
        want = comm_gate.expected(pin, dims["n_layers"], microbatches=m,
                                  stage=stage, stages=stages)
        for i, calls in enumerate(out[r][name]["collectives"]):
            calls = [tuple(c) for c in calls]
            comm_gate.assert_collective_budget(
                calls, want, f"rank {r} {name} step {i}")
            if rows:
                comm_gate.assert_sizes_within(
                    [c for c in calls if c[0] == "p2p"],
                    comm_gate.handoff_caps(rows, seq, dims["d_model"], 4),
                    f"{name} handoffs")
                assert max(n for op, n in calls if op == "p2p") == \
                    rows * seq * dims["d_model"] * 4
    if rows:
        with pytest.raises(AssertionError, match="p2p expected 6 got 4"):
            comm_gate.assert_collective_budget(
                out[0][name]["collectives"][0], comm_gate.expected(
                    pin, dims["n_layers"], microbatches=3, stages=stages),
                name)


# ------------------------------------------------------------ the main


def _json_lines(text: str) -> list:
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def _main_gang(axes: str, world: int, extra: list):
    port = torch_gang.free_port()
    argv = [sys.executable, "-m",
            "k8s_gpu_workload_enhancer_tpu_torch.cmd.trainer", *TINY, *extra]
    return [subprocess.Popen(
        argv, env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT),
                       COORDINATOR_ADDRESS=f"localhost:{port}",
                       NUM_PROCESSES=str(world), PROCESS_ID=str(r),
                       KTWE_MESH_AXES=axes),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def test_trainer_main_trains_through_gpipe_on_a_pp_gang(gang, capsys):
    """The trainer main on (dp=2, pp=2) gangs of four processes, with
    --pipeline-microbatches 2 and without (the layer-stack path), and on a
    (pp=2, tp=2) gang with it (the stage whole on both tp ranks): one
    process prints; the GPipe runs' losses track the layer-stack run's
    and one device's within JAX's end-to-end bound (1e-4)."""
    gang.result()                     # the gang's ranks are done
    gangs = {"gpipe": _main_gang("dp=2,pp=2", 4,
                                 ["--pipeline-microbatches", "2"]),
             "stack": _main_gang("dp=2,pp=2", 4, []),
             "gpipe_tp": _main_gang("pp=2,tp=2", 4,
                                    ["--pipeline-microbatches", "2"])}
    assert cli.main(TINY) == 0
    want = _json_lines(capsys.readouterr().out)
    got = {}
    try:
        for name, procs in gangs.items():
            outs = [p.communicate(timeout=torch_gang.GANG_TIMEOUT_S)
                    for p in procs]
            for p, (_, err) in zip(procs, outs):
                assert p.returncode == 0, err[-3000:]
            got[name] = _json_lines(outs[0][0])
            assert all(_json_lines(o) == [] for o, _ in outs[1:])
            assert [set(x) for x in got[name]] == [set(x) for x in want]
            assert got[name][0]["step"] == 10
            assert got[name][1]["final"] is True
    finally:
        for procs in gangs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    for ref in (got["stack"], want):
        for name in ("gpipe", "gpipe_tp"):
            np.testing.assert_allclose(got[name][0]["loss"], ref[0]["loss"],
                                       rtol=1e-4, err_msg=name)


def test_trainer_main_fails_as_jax_on_bad_pipeline_configs():
    """Without a pp axis, and with a batch M does not divide, the main
    exits with the JAX trainer's messages before it joins a gang."""
    with pytest.raises(SystemExit, match=r"^--pipeline-microbatches needs a "
                       r"pp>1 mesh axis \(got meshAxes \[dp=2\]\)$"):
        cli.main(TINY + ["--pipeline-microbatches", "2"], env={
            "KTWE_MESH_AXES": "dp=2", "NUM_PROCESSES": "2",
            "PROCESS_ID": "0", "COORDINATOR_ADDRESS": "localhost:1"})
    with pytest.raises(SystemExit, match=r"^--batch-size 4 not divisible by "
                       r"--pipeline-microbatches 3$"):
        cli.main(TINY + ["--pipeline-microbatches", "3"], env={
            "KTWE_MESH_AXES": "pp=2", "NUM_PROCESSES": "2",
            "PROCESS_ID": "0", "COORDINATOR_ADDRESS": "localhost:1"})
    assert not torch.distributed.is_initialized()
