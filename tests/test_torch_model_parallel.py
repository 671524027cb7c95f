"""Tensor- and sequence-parallel training on the port, held on the CPU to the
JAX package on the same meshes (models/transformer.py's model-parallel
forward, parallel/sharding.py's layout, train/trainer.py, the checkpoint
and the trainer main).

One gloo gang of eight ranks (tests/torch_gang.py) runs four meshes in
turn, each its own process group, on the same numpy weights and batches
as the JAX side (f32, `params_from_numpy`):

- dp=2, tp=2, sp=2: the forward's logits against the JAX forward on the
  same mesh and on one device (rtol 5e-4, atol 5e-5); two train steps
  against JAX `make_train_step` on the mesh (losses, grad norms, params:
  atol 1e-5, rtol 1e-4), saved, each step's collectives held to their
  pinned budget (parallel/comm_gate.py); two steps at grad_accum 2 (f32
  accumulator) with remat against the port's single-process steps; one
  step with `use_ring_attention=False` (K and V gathered over sp) against
  JAX's with it, held to its own pin;
- sp=8 at seq 512: loss and every gradient against the JAX dense model
  (loss rtol 2e-5; gradients rtol 5e-4, atol 2e-5), through the ring and
  through the gathered attention; causality at the shard boundaries (a
  changed last token leaves earlier logits bit for bit);
- dp=2, sp=4: the checkpoint of dp=2, tp=2, sp=2 restores to the state
  saved, and one step from it equals the step from the same checkpoint
  restored on one device;
- dp=4, tp=2 with one KV head (n_kv_heads % tp != 0: the KV projections
  replicated over tp): two train steps against JAX on the same mesh with
  the KV heads replicated (its default rule cannot lay out one head over
  two devices).

The trainer main runs as gangs of four through KTWE_MESH_AXES (tp=2,
sp=2 on synthetic data; dp=2, tp=2 on a token shard) and prints the lines
one process prints; pp, ep and MoE on tp or sp
are accepted (their gangs: tests/test_torch_expert_parallel.py); MoE
through the model-parallel forward on a one-rank layout equals the
one-device model; the token pipeline splits over dp alone. In process,
the gathered attention on a gang of sp threads (parallel/comm.ThreadGroup)
equals one whole-sequence call, output and gradients, and each rank's
K/V rows past its last query get exactly zero dK and dV.
"""

import json
import os
import pathlib
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
from k8s_gpu_workload_enhancer_tpu.parallel import sharding as jsharding
from k8s_gpu_workload_enhancer_tpu.train import trainer as jtrainer
from k8s_gpu_workload_enhancer_tpu_torch.cmd import trainer as cli
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.ops.attention import attention
from k8s_gpu_workload_enhancer_tpu_torch.ops.flash_attention import (
    flash_attention_backward, flash_attention_plain)
from k8s_gpu_workload_enhancer_tpu_torch.parallel import comm_gate
from k8s_gpu_workload_enhancer_tpu_torch.parallel.comm import ThreadGroup
from k8s_gpu_workload_enhancer_tpu_torch.parallel.ring_attention import (
    gathered_attention)
from k8s_gpu_workload_enhancer_tpu_torch.train import bootstrap as tboot
from k8s_gpu_workload_enhancer_tpu_torch.train import checkpoint as tckpt
from k8s_gpu_workload_enhancer_tpu_torch.train import data as tdata
from k8s_gpu_workload_enhancer_tpu_torch.train import trainer as ttrainer

import torch_gang
import torch_parity  # noqa: F401  (one intra-op thread a process)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DIMS = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
            d_ff=128, max_seq=32)
KV_DIMS = dict(DIMS, n_kv_heads=1)
SP8_DIMS = dict(DIMS, max_seq=512)
GATHERED = dict(use_ring_attention=False)
TRAIN = dict(warmup_steps=1, total_steps=5, batch_size=4, seq_len=32,
             learning_rate=1e-2)
ACC2 = dict(TRAIN, grad_accum=2, grad_accum_dtype="f32")
STEPS = 2
LOGITS_TOL = dict(rtol=5e-4, atol=5e-5)
TOL = dict(atol=1e-5, rtol=1e-4)
TINY = ["--device", "cpu", "--seq-len", "16", "--d-model", "64",
        "--n-layers", "2", "--n-heads", "2", "--d-ff", "128",
        "--vocab-size", "128", "--batch-size", "4", "--steps", "10"]


def flat(tree, prefix=""):
    return torch_gang.flat(tree, prefix)


def numpy_params(dims: dict, seed: int) -> dict:
    params = ttf.init_params(torch.Generator().manual_seed(seed),
                             ttf.TransformerConfig(**dims,
                                                   dtype=torch.float32))
    return {k: ({n: t.numpy() for n, t in v.items()}
                if isinstance(v, dict) else v.numpy())
            for k, v in params.items()}


def tokens(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, DIMS["vocab_size"], shape).astype(np.int32)


def jax_cfg(dims: dict, ring: bool = True) -> jtf.TransformerConfig:
    return jtf.TransformerConfig(**dims, dtype=jnp.float32, use_flash=False,
                                 use_ring_attention=ring)


def torch_cfg(dims: dict) -> ttf.TransformerConfig:
    return ttf.TransformerConfig(**dims, dtype=torch.float32)


def job(name: str, dims: dict, train: dict = TRAIN, **kw) -> dict:
    return dict(name=name, model=dims, train=train, **kw)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The gang of eight on its four meshes, started before the JAX
    references compile (see the module note)."""
    job_dir = tmp_path_factory.mktemp("mp")
    data = {
        "mp": (numpy_params(DIMS, 0),
               [tokens((4, 33), 10 + i) for i in range(STEPS)]),
        "kv": (numpy_params(KV_DIMS, 1),
               [tokens((4, 33), 20 + i) for i in range(STEPS)]),
        "acc": (numpy_params(DIMS, 2),
                [tokens((2, 2, 33), 30 + i) for i in range(STEPS)]),
        "sp8": (numpy_params(SP8_DIMS, 3), [tokens((2, 513), 40)]),
    }
    inputs = {}
    for name, (params, batches) in data.items():
        inputs.update({f"{name}/params{k}": v
                       for k, v in flat(params).items()})
        inputs.update({f"{name}/batches/{i}": b
                       for i, b in enumerate(batches)})
    inputs["fwd"] = tokens((4, 32), 50)
    causal = tokens((1, 256), 51)
    flipped = causal.copy()
    flipped[0, -1] = (flipped[0, -1] + 1) % DIMS["vocab_size"]
    inputs.update({"causal/a": causal, "causal/b": flipped})
    trained = dict(params="mp/params", batches="mp/batches", steps=STEPS)
    phases = [
        dict(mesh_axes="dp=2,tp=2,sp=2", jobs=[
            job("fwd", DIMS, kind="forward", params="mp/params",
                tokens=["fwd"]),
            job("train", DIMS, save="ckpt-mp", **trained),
            job("acc2_remat", dict(DIMS, remat=True), ACC2,
                params="acc/params", batches="acc/batches", steps=STEPS),
            job("gathered", dict(DIMS, **GATHERED), params="mp/params",
                batches="mp/batches", steps=1)]),
        dict(mesh_axes="sp=8", jobs=[
            job("sp8", SP8_DIMS, dict(TRAIN, batch_size=2, seq_len=512),
                kind="grads", params="sp8/params", batch="sp8/batches/0"),
            job("sp8_gathered", dict(SP8_DIMS, **GATHERED),
                dict(TRAIN, batch_size=2, seq_len=512), kind="grads",
                params="sp8/params", batch="sp8/batches/0"),
            job("causal", SP8_DIMS, kind="forward", params="sp8/params",
                tokens=["causal/a", "causal/b"])]),
        dict(mesh_axes="dp=2,sp=4", jobs=[
            job("resume", DIMS, restore="ckpt-mp", seed=9),
            job("resume_step", DIMS, restore="ckpt-mp", seed=9,
                batches="mp/batches", steps=1)]),
        dict(mesh_axes="dp=4,tp=2", jobs=[
            job("kvrep", KV_DIMS, params="kv/params", batches="kv/batches",
                steps=STEPS)]),
    ]
    g = torch_gang.Gang(job_dir, 8, phases, inputs)
    g.data = data
    yield g
    g.close()


def jax_mesh(**sizes):
    return jmesh.make_mesh(jmesh.MeshConfig(**sizes),
                           devices=jax.devices()[:8])


def jax_train(params: dict, batches, dims: dict, train: dict, mesh,
              rules=None, ring: bool = True):
    cfg = jax_cfg(dims, ring)
    tc = jtrainer.TrainConfig(**train)
    p = jax.device_put(params, jtrainer.param_shardings(cfg, mesh, rules))
    state = jtrainer.TrainState(
        params=p, opt_state=jtrainer.make_optimizer(tc).init(p),
        step=jnp.zeros((), jnp.int32))
    step = jtrainer.make_train_step(cfg, tc, mesh, rules)
    metrics = []
    for toks in batches:
        state, m = step(state, jnp.asarray(toks))
        metrics.append({k: float(m[k]) for k in ("loss", "nll",
                                                 "grad_norm")})
    return metrics, jax.tree.map(np.asarray, state.params)


def assert_metrics(got: list, want: list, what: str) -> None:
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("loss", "nll", "grad_norm"):
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


def logits_of(gang, name: str, key: str, sizes: dict) -> np.ndarray:
    """The global logits (B, S, V) from the ranks' blocks of job `name`."""
    dp, tp, sp = (sizes.get(a, 1) for a in ("dp", "tp", "sp"))
    grid = [[[None] * tp for _ in range(sp)] for _ in range(dp)]
    for coords, arrays in gang.rank_arrays(name):
        grid[coords["dp"]][coords["sp"]][coords["tp"]] = arrays[key]
    return np.concatenate([np.concatenate([np.concatenate(cols, axis=2)
                                           for cols in row], axis=1)
                           for row in grid], axis=0)


def single_process(params: dict, batches, dims: dict, train: dict):
    tcfg = ttrainer.TrainConfig(**train)
    p = ttrainer.tree_map(lambda t: t.requires_grad_(True),
                          ttf.params_from_numpy(params, torch_cfg(dims)))
    state = ttrainer.TrainState(p, ttrainer.make_optimizer(tcfg).init(p), 0)
    step = ttrainer.make_train_step(torch_cfg(dims), tcfg)
    metrics = []
    for toks in batches:
        state, m = step(state, torch.from_numpy(toks.copy()).long())
        metrics.append({k: float(m[k]) for k in ("loss", "nll",
                                                 "grad_norm")})
    return state, metrics


def test_sharded_forward_matches_jax_on_the_mesh_and_one_device(gang):
    params = gang.data["mp"][0]
    toks = jnp.asarray(np.asarray(np.load(gang.dir / "inputs.npz")["fwd"]))
    got = logits_of(gang, "fwd", "fwd", dict(dp=2, tp=2, sp=2))
    cfg = jax_cfg(DIMS)
    single, _ = jtf.forward(params, toks, cfg)
    mesh = jax_mesh(dp=2, tp=2, sp=2)
    sharded, _ = jax.jit(lambda p, t: jtf.forward(p, t, cfg, mesh))(
        params, toks)
    assert got.shape == (4, 32, DIMS["vocab_size"])
    np.testing.assert_allclose(got, np.asarray(sharded), **LOGITS_TOL)
    np.testing.assert_allclose(got, np.asarray(single), **LOGITS_TOL)


def test_two_steps_on_dp2_tp2_sp2_match_jax(gang):
    params, batches = gang.data["mp"]
    want, want_params = jax_train(params, batches, DIMS, TRAIN,
                                  jax_mesh(dp=2, tp=2, sp=2))
    out = gang.result()
    assert all(o["train"]["metrics"] == out[0]["train"]["metrics"]
               for o in out)
    assert_metrics(out[0]["train"]["metrics"], want, "dp2 tp2 sp2 vs JAX")
    assert_tree(gang.arrays("train"), "params", want_params,
                "dp2 tp2 sp2 vs JAX")
    assert out[0]["train"]["step"] == out[0]["train"]["count"] == STEPS


def test_layout_splits_each_leaf_over_dp_and_tp(gang):
    """Each rank holds 1/dp of every embed axis and 1/tp of every heads,
    MLP and vocab axis, of the params and both moments; the norm scales
    whole."""
    axes = flat(ttf.param_logical_axes(torch_cfg(DIMS)))
    shapes = flat(ttf.param_shapes(torch_cfg(DIMS)))
    tp_names = ("heads", "kv_heads", "mlp", "vocab")
    for rank in gang.result():
        got = rank["train"]
        for key, shape in shapes.items():
            want = list(shape)
            for d, name in enumerate(axes[key]):
                if name == "embed":
                    want[d] //= 2
                if name in tp_names:
                    want[d] //= 2
            for tree in ("params", "mu", "nu"):
                assert got["blocks"][tree + key] == want, (rank, key)
        assert sorted(k for k, d in got["tp_dims"].items() if d is None) == [
            "/final_ln", "/layers/ln1", "/layers/ln2"]


def test_train_step_collectives_hold_the_pinned_budget(gang):
    """Every rank's train steps on dp=2, tp=2, sp=2 make exactly the
    collectives pinned for them (parallel/comm_gate.BUDGETS, the JAX
    dryrun's collective budget): a sharding change that adds or drops a
    gather fails here with JAX's drift message."""
    want = comm_gate.expected("train/dp2_tp2_sp2", DIMS["n_layers"])
    for r, out in enumerate(gang.result()):
        steps = out["train"]["collectives"]
        assert len(steps) == STEPS
        for i, calls in enumerate(steps):
            comm_gate.assert_collective_budget(
                calls, want, f"rank {r} train step {i} on dp=2,tp=2,sp=2")


def test_grad_accum_with_remat_matches_the_single_process_steps(gang):
    params, batches = gang.data["acc"]
    state, want = single_process(params, batches, DIMS, ACC2)
    out = gang.result()[0]["acc2_remat"]
    assert_metrics(out["metrics"], want, "grad_accum 2, remat")
    assert_tree(gang.arrays("acc2_remat"), "params", state.params,
                "grad_accum 2, remat")


@pytest.fixture(scope="module")
def sp8_jax(gang):
    """The JAX dense model's loss and gradients on the sp8 batch (one
    device, its `use_ring_attention=False` attention)."""
    params, (batch,) = gang.data["sp8"]
    cfg = jax_cfg(SP8_DIMS, ring=False)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jnp.asarray(batch), cfg, None)[0]))(params)
    return float(loss), flat(jax.tree.map(np.asarray, grads))


def assert_sp8(gang, name: str, want) -> None:
    loss, grads = want
    np.testing.assert_allclose(gang.result()[0][name]["loss"], loss,
                               rtol=2e-5)
    got = gang.arrays(name)
    for k, w in grads.items():
        np.testing.assert_allclose(got["grads" + k], w, rtol=5e-4,
                                   atol=2e-5, err_msg=f"{name} {k}")


def test_sp8_loss_and_grads_match_jax_dense(gang, sp8_jax):
    """The ring's loss and gradients at seq 512 over sp=8 equal the JAX
    dense model's (the JAX package's long-context pin)."""
    assert_sp8(gang, "sp8", sp8_jax)


def test_sp8_gathered_attention_matches_jax_dense(gang, sp8_jax):
    """`use_ring_attention=False` at seq 512 over sp=8: each rank's
    queries over the K and V gathered from the eight ranks give the loss
    and every gradient of the JAX dense model (the same reference and
    tolerances as the ring), and every rank reports the same loss."""
    assert_sp8(gang, "sp8_gathered", sp8_jax)
    out = gang.result()
    assert len({o["sp8_gathered"]["loss"] for o in out}) == 1


def test_gathered_step_on_dp2_tp2_sp2_matches_jax_and_its_pin(gang):
    """One train step with `use_ring_attention=False` on (dp=2, tp=2,
    sp=2) against the JAX step with it on that mesh (metrics and params),
    every rank's collectives held to `train/dp2_tp2_sp2/gathered`: the
    ring's shifts replaced by one K/V all-gather a layer and its
    reduce-scatter."""
    params, batches = gang.data["mp"]
    want, want_params = jax_train(params, batches[:1], DIMS, TRAIN,
                                  jax_mesh(dp=2, tp=2, sp=2), ring=False)
    out = gang.result()
    assert all(o["gathered"]["metrics"] == out[0]["gathered"]["metrics"]
               for o in out)
    assert_metrics(out[0]["gathered"]["metrics"], want, "gathered vs JAX")
    assert_tree(gang.arrays("gathered"), "params", want_params,
                "gathered vs JAX")
    pin = comm_gate.expected("train/dp2_tp2_sp2/gathered", DIMS["n_layers"])
    for r, o in enumerate(out):
        for calls in o["gathered"]["collectives"]:
            comm_gate.assert_collective_budget(
                calls, pin, f"rank {r} gathered step on dp=2,tp=2,sp=2")
    with pytest.raises(AssertionError, match="p2p expected 4 got 0"):
        comm_gate.assert_collective_budget(
            out[0]["gathered"]["collectives"][0],
            comm_gate.expected("train/dp2_tp2_sp2", DIMS["n_layers"]),
            "the ring's pin")


@pytest.mark.parametrize("kv_heads", [2, 1])
def test_gathered_attention_on_a_thread_gang_matches_one_call(kv_heads):
    """`gathered_attention` on a gang of four sp threads (one backward
    over the ranks' losses: the gather is one node, its backward the
    reduce-scatter) equals one `attention` call on the whole causal
    sequence, output and dQ, dK, dV (MHA and GQA); and rank r's own dK
    and dV of the gathered K/V, at its offset r * S/sp, are exactly zero
    on every row past its last query."""
    sp, b, seq, h, d = 4, 2, 32, 2, 8
    g = torch.Generator().manual_seed(11)
    q, do = (torch.randn(b, seq, h, d, generator=g) for _ in range(2))
    k, v = (torch.randn(b, seq, kv_heads, d, generator=g) for _ in range(2))
    whole = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = attention(*whole, causal=True)
    (o * do).sum().backward()
    s = seq // sp
    shards = [[t[:, r * s:(r + 1) * s].clone().requires_grad_(True)
               for t in (q, k, v)] for r in range(sp)]
    group = ThreadGroup(sp, timeout=60)
    outs, errors = [None] * sp, []

    def rank(r):
        try:
            outs[r] = gathered_attention(*shards[r], group.comm(r), True)
        except BaseException as e:            # noqa: BLE001 — reported
            errors.append(e)
            group.abort()
    threads = [threading.Thread(target=rank, args=(r,)) for r in range(sp)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    if errors:
        raise errors[0]
    sum((outs[r] * do[:, r * s:(r + 1) * s]).sum() for r in range(sp)
        ).backward()
    np.testing.assert_allclose(torch.cat(outs, 1).detach(), o.detach(),
                               rtol=1e-6, atol=1e-6)
    for i, name in enumerate(("dq", "dk", "dv")):
        np.testing.assert_allclose(
            torch.cat([sh[i].grad for sh in shards], 1), whole[i].grad,
            rtol=1e-5, atol=1e-6, err_msg=name)
    # Each rank's own part: its queries at offset r * s over the whole K/V.
    kk, vv = (t.repeat_interleave(h // kv_heads, dim=2) for t in (k, v))
    for r in range(sp):
        qr, dor = q[:, r * s:(r + 1) * s], do[:, r * s:(r + 1) * s]
        o_r, lse = flash_attention_plain(qr, kk, vv, True, r * s, 0,
                                         return_lse=True)
        _, dk, dv = flash_attention_backward(qr, kk, vv, o_r, lse, dor,
                                             True, r * s, 0)
        tail = slice((r + 1) * s, seq)
        assert torch.count_nonzero(dk[:, tail]) == 0, r
        assert torch.count_nonzero(dv[:, tail]) == 0, r
        assert torch.count_nonzero(dk[:, :(r + 1) * s]) > 0, r


def test_sp8_ring_respects_causality_at_shard_boundaries(gang):
    a = logits_of(gang, "causal", "causal/a", dict(sp=8))
    b = logits_of(gang, "causal", "causal/b", dict(sp=8))
    np.testing.assert_array_equal(a[0, :-1], b[0, :-1])
    assert not np.allclose(a[0, -1], b[0, -1])


def test_checkpoint_of_dp2_tp2_sp2_resumes_on_dp2_sp4_and_one_device(gang):
    out = gang.result()
    assert [o["resume"]["step"] for o in out] == [STEPS] * 8
    saved, restored = gang.arrays("train"), gang.arrays("resume")
    assert set(saved) == set(restored)
    for k, v in saved.items():
        np.testing.assert_array_equal(restored[k], v, err_msg=k)
    # One device: the same checkpoint, the same next step.
    tcfg = ttrainer.TrainConfig(**TRAIN)
    target = ttrainer.init_state(torch_cfg(DIMS), tcfg,
                                 torch.Generator().manual_seed(4))
    state = tckpt.CheckpointManager(
        str(gang.dir / "ckpt-mp")).restore(None, target)
    assert state.step == state.opt_state["count"] == STEPS
    for k, v in flat(state.params).items():
        np.testing.assert_array_equal(v.detach().numpy(),
                                      saved["params" + k], err_msg=k)
    step = ttrainer.make_train_step(torch_cfg(DIMS), tcfg)
    batch = gang.data["mp"][1][0]
    _, m = step(state, torch.from_numpy(batch.copy()).long())
    want = {k: float(m[k]) for k in ("loss", "nll", "grad_norm")}
    assert_metrics(out[0]["resume_step"]["metrics"], [want],
                   "dp2 sp4 step from the checkpoint vs one device")
    assert out[0]["resume_step"]["step"] == STEPS + 1


def test_kv_heads_replicated_over_tp_match_jax(gang):
    """One KV head on tp=2: the port replicates wk and wv over tp (each
    rank reads the head its Q heads need); JAX on the same mesh with the
    KV heads replicated computes the same steps."""
    params, batches = gang.data["kv"]
    rules = dict(jsharding.DEFAULT_RULES, kv_heads=None)
    want, want_params = jax_train(params, batches, KV_DIMS, TRAIN,
                                  jax_mesh(dp=4, tp=2), rules)
    out = gang.result()
    assert_metrics(out[0]["kvrep"]["metrics"], want, "kv replicated vs JAX")
    assert_tree(gang.arrays("kvrep"), "params", want_params,
                "kv replicated vs JAX")
    dims = out[0]["kvrep"]["tp_dims"]
    assert dims["/layers/wk"] is None and dims["/layers/wq"] == 2


def _json_lines(text: str) -> list:
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def _main_gang(axes: str, extra: list, world: int = 4):
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


def test_trainer_main_gangs_with_tp_and_sp_print_the_one_process_lines(
        tmp_path, capsys):
    """The trainer main as four processes through KTWE_MESH_AXES: tp=2,
    sp=2 on synthetic data and dp=2, tp=2 on a token shard (each tp rank
    of a dp coordinate reads that coordinate's rows) print the step and
    final lines of one process on the same global batch."""
    shard = str(tmp_path / "tokens.bin")
    tdata.write_token_file(shard, np.random.default_rng(2).integers(
        0, 128, 17 * 48))
    runs = {"tp=2,sp=2": [], "dp=2,tp=2": ["--data-file", shard]}
    gangs = {axes: _main_gang(axes, extra) for axes, extra in runs.items()}
    want = {}
    for axes, extra in runs.items():
        assert cli.main(TINY + extra) == 0
        want[axes] = _json_lines(capsys.readouterr().out)
    try:
        for axes, procs in gangs.items():
            outs = [p.communicate(timeout=torch_gang.GANG_TIMEOUT_S)
                    for p in procs]
            for p, (_, err) in zip(procs, outs):
                assert p.returncode == 0, err[-3000:]
            got = _json_lines(outs[0][0])
            assert all(_json_lines(o) == [] for o, _ in outs[1:])
            assert [set(x) for x in got] == [set(x) for x in want[axes]]
            assert got[0]["step"] == 10
            np.testing.assert_allclose(got[0]["loss"], want[axes][0]["loss"],
                                       rtol=1e-5, err_msg=axes)
            assert got[1]["final"] is True
    finally:
        for procs in gangs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()


@pytest.mark.parametrize("axes,extra", [
    ("ep=2", []), ("pp=2", []), ("tp=2", ["--n-experts", "4"]),
    ("sp=2", ["--n-experts", "4"]), ("dp=2,tp=2,sp=2",
                                     ["--n-experts", "4"])])
def test_trainer_main_refuses_ep_pp_and_moe_on_tp_or_sp(axes, extra, capsys):
    """pp, ep, and MoE on tp or sp, are ported: the main refuses none of
    them (the pp gangs that train: tests/test_torch_gpipe.py)."""
    n = int(np.prod([int(a.split("=")[1]) for a in axes.split(",")]))
    env = {"KTWE_MESH_AXES": axes, "NUM_PROCESSES": str(n),
           "PROCESS_ID": "0", "COORDINATOR_ADDRESS": "localhost:1"}
    args = cli.build_parser().parse_args(TINY + extra)
    assert cli.refused(args, tboot.mesh_config(env)) is None


def test_moe_on_a_model_parallel_layout_is_refused():
    """MoE is no longer refused on a model-parallel layout: through the
    model-parallel forward on a layout of one rank (every tp and sp
    collective the identity) its loss parts and every gradient equal the
    one-device model's on the dense expert route."""
    class Layout:
        model_parallel, kv_replicated = True, False
        tp = sp = ep = size = 1
        tp_rank = sp_rank = 0
        sp_group = None

        def seq_shard(self, t):
            return t

        def leaf(self, params, name):
            return params[name]

        def layer_params(self, params, layer):
            return ttf.layer_params(params, layer)

        def tp_copy(self, x):
            return x
        tp_sum = tp_copy

        def global_means(self, a, b):
            return a, b
    cfg = torch_cfg(dict(DIMS, n_experts=4, moe_ragged_dispatch=False))
    toks = torch.from_numpy(tokens((2, 17), 7)).long()
    got, want = [ttrainer.tree_map(
        lambda t: t.requires_grad_(True),
        ttf.init_params(torch.Generator().manual_seed(3), cfg))
        for _ in range(2)]
    (tot, parts), (wtot, wparts) = (
        ttf.loss_fn(got, toks, cfg, fsdp=Layout()),
        ttf.loss_fn(want, toks, cfg))
    assert float(parts["aux"].detach()) > 0.5
    for k in ("nll", "aux"):
        np.testing.assert_allclose(float(parts[k].detach()),
                                   float(wparts[k].detach()), rtol=1e-5)
    (tot + wtot).backward()
    for k, w in flat(want).items():
        np.testing.assert_allclose(flat(got)[k].grad, w.grad, rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("acc", [1, 2])
def test_token_pipeline_splits_over_dp_alone(tmp_path, acc):
    """On dp=2, tp=2 the two tp ranks of a dp coordinate read the same
    rows, and the gang reads what dp=2 alone reads: each coordinate its
    block of every microbatch of one process's batch."""
    shard = str(tmp_path / "tokens.bin")
    tdata.write_token_file(shard, np.random.default_rng(3).integers(
        0, 128, 17 * 40))
    args = cli.build_parser().parse_args(
        ["--data-file", shard, "--seq-len", "16", "--batch-size", "8",
         "--seed", "5", "--grad-accum", str(acc)])
    tcfg = ttrainer.TrainConfig(batch_size=8, seq_len=16, seed=5,
                                grad_accum=acc)

    def take(cfg):
        it = tdata.TokenDataset(cfg).batches(2)
        return [next(it) for _ in range(3)]
    whole = take(cli.data_config(args, tcfg, 1, 0))
    # Ranks of (dp, tp) coordinates in mesh order: dp is the outer axis.
    coords = [(d, t) for d in range(2) for t in range(2)]
    reads = [take(cli.data_config(args, tcfg, 2, d)) for d, _ in coords]
    axis = 0 if acc == 1 else 1
    for step, want in enumerate(whole):
        for (d, _), got in zip(coords, reads):
            np.testing.assert_array_equal(
                got[step], np.split(want, 2, axis=axis)[d])
