"""Mixture-of-Experts on the port, held to the JAX package on the same
weights and inputs (CPU, f32; the `MOE` configuration of
tests/unit/test_model.py: vocab 256, d_model 64, 2 layers, 4 heads, d_ff
128, 4 experts, max_seq 64).

- `ops/moe_dispatch.py`: `capacity` equals the JAX function's, and
  `ragged_dispatch` gives the JAX function's outputs and dropped fraction,
  with room to spare and with tokens dropped past an expert's capacity.
- `_moe_ffn` on the ragged and the dense route at top-1 and top-2: y
  within 1e-4, aux within 1e-5; a router tie picks the lowest expert index
  as jax.lax.top_k does.
- `loss_fn`'s total, nll and aux and every gradient leaf (router and
  experts included) within 1e-4, with and without remat; two train steps
  against the JAX train step.
- Inference routes dense: `forward_cached` prefill and decode logits, and
  the dense, paged and speculative engines' greedy tokens equal the JAX
  engines' exactly, with the same page and lifetime bookkeeping.
- A JAX MoE param tree crosses through `params_from_numpy` leaf for leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.models import decode as jdec
from k8s_gpu_workload_enhancer_tpu.models import serving as jsrv
from k8s_gpu_workload_enhancer_tpu.models import transformer as jtf
from k8s_gpu_workload_enhancer_tpu.ops import moe_dispatch as jmoe
from k8s_gpu_workload_enhancer_tpu.ops.quant import quantize_params as jquant
from k8s_gpu_workload_enhancer_tpu.parallel import mesh as jmesh
from k8s_gpu_workload_enhancer_tpu.train import trainer as jtrainer
from k8s_gpu_workload_enhancer_tpu_torch.models import decode as tdec
from k8s_gpu_workload_enhancer_tpu_torch.models import serving as tsrv
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
from k8s_gpu_workload_enhancer_tpu_torch.ops import moe_dispatch as tmoe
from k8s_gpu_workload_enhancer_tpu_torch.train import trainer as ttrainer

import torch_parity  # noqa: F401  (one intra-op thread a process)

DIMS = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
            d_ff=128, max_seq=64, n_experts=4)
TOL = dict(atol=1e-4, rtol=1e-4)
AUX_TOL = dict(atol=1e-5, rtol=1e-5)
ENGINE = dict(num_slots=2, prefill_len=8, decode_chunk=4)
KV_FIELDS = ("blocks_total", "blocks_free", "blocks_used", "blocks_shared",
             "blocks_cached", "evictions_total", "deferrals_total",
             "prompt_tokens_total", "matched_tokens_total")


def configs(**kw):
    """(jax cfg, port cfg) of the MoE model with `kw` on both."""
    return (jtf.TransformerConfig(**DIMS, dtype=jnp.float32,
                                  use_flash=False, use_ring_attention=False,
                                  **kw),
            ttf.TransformerConfig(**DIMS, dtype=torch.float32, **kw))


def model(seed=0, **kw):
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    jcfg, tcfg = configs(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, tcfg, ttf.params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


@pytest.fixture(scope="module")
def moe():
    return model()


def _randn(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, DIMS["vocab_size"], shape).astype(np.int32)


def _layer0(jp, tp_):
    jl = jax.tree.map(lambda w: w[0], jp["layers"])
    return jl, ttf.layer_params(tp_, 0)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# ------------------------------------------------------------ the dispatch


@pytest.mark.parametrize("n,e,cf", [(1, 4, 1.25), (64, 4, 1.25),
                                    (100, 8, 1.0), (2048, 4, 1.25),
                                    (16384, 4, 1.25), (7, 3, 2.0)])
def test_capacity_equals_jax(n, e, cf):
    assert tmoe.capacity(n, e, cf) == jmoe.capacity(n, e, cf)
    assert tmoe.capacity(n, e, cf) % 8 == 0 and tmoe.capacity(n, e, cf) >= 8


def _expert_ffns(e, d, seed):
    """A per-expert affine map in both packages: xs (E, C, D) -> (E, C, D)."""
    w = _randn(e, d, d, seed=seed, scale=d ** -0.5)
    b = _randn(e, d, seed=seed + 1)
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)

    def jffn(eids, xs):
        return jnp.einsum("ecd,edf->ecf", xs, jnp.asarray(w)[eids]) + \
            jnp.asarray(b)[eids][:, None, :]

    def tffn(eids, xs):
        return torch.matmul(xs, tw[eids]) + tb[eids][:, None, :]
    return jffn, tffn


@pytest.mark.parametrize("skew,cf", [(False, 4.0), (True, 1.25),
                                     (True, 0.5)],
                         ids=["room", "overflow", "tight"])
def test_ragged_dispatch_equals_jax(skew, cf):
    """At capacity to spare nothing drops; with a skewed routing the
    tokens past an expert's capacity drop in the JAX order (the stable
    sort keeps the earliest), and y2 and the dropped fraction are the JAX
    function's."""
    n, d, e = 40, 16, 4
    rng = np.random.default_rng(3)
    x = _randn(n, d, seed=5)
    idx = (rng.choice(e, n, p=[0.7, 0.1, 0.1, 0.1]) if skew
           else rng.integers(0, e, n)).astype(np.int32)
    gate = rng.uniform(0.2, 1.0, n).astype(np.float32)
    jffn, tffn = _expert_ffns(e, d, seed=7)
    jy, jdrop = jmoe.ragged_dispatch(jnp.asarray(x), jnp.asarray(idx),
                                     jnp.asarray(gate), e, jffn, cf)
    ty, tdrop = tmoe.ragged_dispatch(torch.from_numpy(x),
                                     torch.from_numpy(idx),
                                     torch.from_numpy(gate), e, tffn, cf)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    assert float(tdrop) == pytest.approx(float(jdrop), abs=1e-7)
    assert (float(tdrop) > 0) == (cf < 4.0)
    dropped_rows = np.all(np.asarray(jy) == 0, axis=1)
    assert dropped_rows.sum() == round(float(jdrop) * n)


def test_ragged_dispatch_differentiates_like_jax():
    n, d, e = 24, 8, 4
    rng = np.random.default_rng(9)
    x = _randn(n, d, seed=11)
    idx = rng.choice(e, n, p=[0.55, 0.15, 0.15, 0.15]).astype(np.int32)
    gate = rng.uniform(0.2, 1.0, n).astype(np.float32)
    jffn, tffn = _expert_ffns(e, d, seed=13)
    jdx, jdg = jax.grad(
        lambda xx, gg: jnp.sum(jmoe.ragged_dispatch(
            xx, jnp.asarray(idx), gg, e, jffn, 1.0)[0] ** 2),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(gate))
    tx = torch.from_numpy(x).requires_grad_(True)
    tg = torch.from_numpy(gate).requires_grad_(True)
    y, _ = tmoe.ragged_dispatch(tx, torch.from_numpy(idx), tg, e, tffn, 1.0)
    dx, dg = torch.autograd.grad((y ** 2).sum(), (tx, tg))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(dg.numpy(), np.asarray(jdg), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------------ _moe_ffn


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "dense"])
def test_moe_ffn_equals_jax(moe, ragged, k):
    jcfg, jp, tcfg, params = moe
    jcfg = dataclasses.replace(jcfg, moe_ragged_dispatch=ragged,
                               expert_top_k=k)
    tcfg = dataclasses.replace(tcfg, moe_ragged_dispatch=ragged,
                               expert_top_k=k)
    jl, tl = _layer0(jp, params)
    x = _randn(2, 12, DIMS["d_model"], seed=21)
    jy, jaux = jtf._moe_ffn(jnp.asarray(x), jl, jcfg, None)
    ty, taux = ttf._moe_ffn(torch.from_numpy(x), tl, tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **AUX_TOL)


@pytest.mark.parametrize("k", [1, 2])
def test_router_ties_pick_the_lowest_expert_as_jax(moe, k):
    """Experts 1 and 3 share a router column that beats the others, so
    their probabilities are equal for every row: top-1 takes expert 1 and
    top-2 (1, 3), as jax.lax.top_k orders ties, never 3 first; a router of
    zeros ties all four: top-1 expert 0, top-2 (0, 1). y and aux equal the
    JAX function's on both routes."""
    jcfg, jp, tcfg, params = moe
    jl, tl = _layer0(jp, params)
    d, e = DIMS["d_model"], DIMS["n_experts"]
    x = np.abs(_randn(2, 8, d, seed=23)) + 0.1
    col = np.abs(_randn(d, seed=24)) * 0.1
    tied = np.zeros((d, e), np.float32)
    tied[:, 1] = tied[:, 3] = col
    for router, want in ((tied, [1, 3]), (np.zeros((d, e), np.float32),
                                          [0, 1])):
        jl2 = dict(jl, router=jnp.asarray(router))
        tl2 = dict(tl, router=torch.from_numpy(router))
        probs = torch.softmax(torch.from_numpy(x) @ tl2["router"], dim=-1)
        _, topi = ttf._top_k(probs, k)
        assert (topi == torch.tensor(want[:k])).all()
        _, jtopi = jax.lax.top_k(jnp.asarray(probs.numpy()), k)
        assert np.array_equal(topi.numpy(), np.asarray(jtopi))
        for ragged in (True, False):
            jc = dataclasses.replace(jcfg, expert_top_k=k,
                                     moe_ragged_dispatch=ragged)
            tc = dataclasses.replace(tcfg, expert_top_k=k,
                                     moe_ragged_dispatch=ragged)
            jy, jaux = jtf._moe_ffn(jnp.asarray(x), jl2, jc, None)
            ty, taux = ttf._moe_ffn(torch.from_numpy(x), tl2, tc)
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
            np.testing.assert_allclose(float(taux), float(jaux), **AUX_TOL)


# ------------------------------------------------------------ training


@pytest.mark.parametrize("kw", [dict(), dict(moe_ragged_dispatch=False),
                                dict(expert_top_k=2), dict(remat=True)],
                         ids=["ragged", "dense", "top2", "remat"])
def test_loss_and_every_gradient_equal_jax(kw):
    """total, nll, aux and the gradient of every leaf, router and expert
    banks included."""
    jcfg, jp, tcfg, params = model(seed=1, **kw)
    toks = _tokens((2, 17), seed=31)
    (jtotal, jparts), jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jnp.asarray(toks), jcfg),
        has_aux=True)(jp)
    leaves = ttrainer.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    total, parts = ttf.loss_fn(params, torch.from_numpy(toks).long(), tcfg)
    grads = torch.autograd.grad(total, leaves)
    total, parts = total.detach(), {k: v.detach() for k, v in parts.items()}
    np.testing.assert_allclose(float(total), float(jtotal), **TOL)
    np.testing.assert_allclose(float(parts["nll"]), float(jparts["nll"]),
                               **TOL)
    np.testing.assert_allclose(float(parts["aux"]), float(jparts["aux"]),
                               **AUX_TOL)
    assert float(parts["aux"]) > 0
    assert float(total) == pytest.approx(
        float(parts["nll"]) + 0.01 * float(parts["aux"]), rel=1e-6)
    got = dict(zip(_flat(params), grads))
    want = _flat(jax.tree.map(np.asarray, jgrads))
    assert set(got) == set(want) and "/layers/router" in got
    for path, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[path], err_msg=path,
                                   **TOL)


def test_two_train_steps_equal_jax():
    """Two steps of the train step from the same params on the same tokens
    (ragged dispatch, the JAX single-device route): loss, nll, aux,
    grad_norm and every param within 1e-4."""
    jcfg, _, tcfg, _ = model()
    tc = dict(learning_rate=1e-2, warmup_steps=1, total_steps=5,
              batch_size=2, seq_len=16)
    mesh = jmesh.single_device_mesh()
    jstate = jtrainer.init_state(jcfg, jtrainer.TrainConfig(**tc), mesh)
    jstep = jtrainer.make_train_step(jcfg, jtrainer.TrainConfig(**tc), mesh)
    train_cfg = ttrainer.TrainConfig(**tc)
    tparams = ttrainer.tree_map(
        lambda p: p.requires_grad_(True),
        ttf.params_from_numpy(jax.tree.map(np.asarray, jstate.params), tcfg))
    tstate = ttrainer.TrainState(
        params=tparams, opt_state=ttrainer.make_optimizer(train_cfg).init(
            tparams), step=0)
    tstep = ttrainer.make_train_step(tcfg, train_cfg)
    kernels.reset_launches()
    for i in range(2):
        toks = _tokens((2, 17), seed=40 + i)
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tstate, tm = tstep(tstate, torch.from_numpy(toks).long())
        for key in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       err_msg=f"step {i} {key}", **TOL)
        np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                                   err_msg=f"step {i} aux", **AUX_TOL)
        want = _flat(jax.tree.map(np.asarray, jstate.params))
        for path, p in _flat(tstate.params).items():
            np.testing.assert_allclose(p.detach().numpy(), want[path],
                                       err_msg=f"step {i} {path}", **TOL)
    assert tstate.opt_state["count"] == 2
    assert sum(kernels.launches.values()) == 0     # CPU: plain versions


# ------------------------------------------------------------ inference


def test_forward_cached_prefill_and_decode_equal_jax(moe):
    """A 12-token prefill then two decode steps through the cache: the
    dense route's logits within 1e-4 of the JAX function's."""
    jcfg, jp, tcfg, params = moe
    prompt = _tokens((2, 12), seed=51)
    jcache = jdec.init_cache(jcfg, 2)
    tcache = tdec.init_cache(tcfg, 2)
    jl, jcache = jdec.forward_cached(jp, jnp.asarray(prompt), jcache, 0,
                                     jcfg)
    with torch.no_grad():
        tl, _ = tdec.forward_cached(params, torch.from_numpy(prompt).long(),
                                    tcache, 0, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for pos in (12, 13):
        jl, jcache = jdec.forward_cached(jp, jnp.asarray(nxt), jcache, pos,
                                         jcfg)
        with torch.no_grad():
            tl, _ = tdec.forward_cached(params, torch.from_numpy(nxt).long(),
                                        tcache, pos, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)


def test_inference_never_takes_the_ragged_route(moe, monkeypatch):
    _, _, tcfg, params = moe

    def refuse(*a, **k):
        raise AssertionError("inference took the ragged route")
    monkeypatch.setattr(ttf, "ragged_dispatch", refuse)
    with torch.no_grad():
        tdec.forward_cached(params, torch.from_numpy(_tokens((1, 6))).long(),
                            tdec.init_cache(tcfg, 1), 0, tcfg)
    eng = tsrv.ContinuousBatchEngine(params, tcfg, device="cpu", **ENGINE)
    rid = eng.submit([5, 6, 7], 6)
    eng.run()
    assert len(eng.result(rid).tokens) == 6


def _oracle(want: dict):
    def oracle(context, k):
        for p, w in want.items():
            if tuple(context[:len(p)]) == p:
                done = len(context) - len(p)
                return w[done:done + k]
        return []
    return oracle


PROMPTS = [[3, 17, 29, 5], [40, 2, 7, 1, 3, 9, 11, 4, 8, 30],
           [41, 2, 7, 1, 3], [12] * 9, [200, 100, 50]]
LENS = [20, 14, 24, 12, 18]


@pytest.mark.parametrize("kind", [{}, {"kv_block_len": 8},
                                  {"spec_k": 3},
                                  {"spec_k": 3, "kv_block_len": 8}],
                         ids=["dense", "paged", "spec", "spec-paged"])
def test_engines_equal_the_jax_engines(moe, kind):
    """Five requests through two slots, admitted one step apart (slots
    and pages reused, a two-chunk prompt): greedy tokens equal the JAX
    engine's and the isolated JAX generation's exactly, logprobs within
    1e-4, and the lifetime counters and the paged pool's bookkeeping
    equal. The spec engines run an oracle drafter of the JAX spec-off
    continuations, so verify rounds accept drafts, and their `spec` block
    equals the JAX engine's."""
    jcfg, jp, tcfg, params = moe
    want = {}
    for p, n in zip(PROMPTS, LENS):
        out = jdec.generate(jp, jnp.asarray([p], jnp.int32), n, jcfg,
                            max_seq=jcfg.max_seq)
        want[tuple(p)] = np.asarray(out)[0, len(p):].tolist()
    kw = dict(ENGINE, **kind)
    if "spec_k" in kind:
        kw["drafter"] = _oracle(want)
    jeng = jsrv.ContinuousBatchEngine(jp, jcfg, **kw)
    teng = tsrv.ContinuousBatchEngine(params, tcfg, device="cpu", **kw)

    def drive(eng):
        rids = []
        for p, n in zip(PROMPTS, LENS):
            rids.append(eng.submit(p, n))
            eng.step()
        eng.run()
        return rids
    jids, tids = drive(jeng), drive(teng)
    for p, a, b in zip(PROMPTS, jids, tids):
        j, t = jeng.result(a), teng.result(b)
        assert t.tokens == j.tokens == want[tuple(p)]
        assert t.finish_reason == j.finish_reason == "length"
        np.testing.assert_allclose(t.logprobs, j.logprobs, atol=1e-4, rtol=0)
    jm, tm = jeng.metrics(), teng.metrics()
    for f in ("completed", "tokens", "decode_steps", "prefill_chunks"):
        assert tm["lifetime"][f] == jm["lifetime"][f], f
    if "kv_block_len" in kind:
        for f in KV_FIELDS:
            assert tm["kv_cache"][f] == jm["kv_cache"][f], f
        kv = tm["kv_cache"]
        assert kv["blocks_free"] + kv["blocks_cached"] == kv["blocks_total"]
    if "spec_k" in kind:
        assert tm["spec"]["rounds_total"] > 0
        assert tm["spec"]["draft_accepted_total"] > 0
        assert tm["spec"] == jm["spec"]


# ------------------------------------------------------------ params


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_a_jax_moe_tree_crosses_leaf_for_leaf(int8):
    """`params_from_numpy` carries a JAX MoE tree (router (L, d, E), expert
    banks (L, E, d, f) and (L, E, f, d); int8 {"q8", "scale"} experts)
    across as a plain copy; `param_shapes` and `init_params` have the JAX
    tree's structure and shapes; a dense tree is refused."""
    jcfg, tcfg = configs()
    jp = jtf.init_params(jax.random.PRNGKey(2), jcfg)
    if int8:
        jp = jquant(jp)
    host = jax.tree.map(np.asarray, jp)
    got = _flat(ttf.params_from_numpy(host, tcfg))
    want = _flat(host)
    assert set(got) == set(want)
    for path, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[path], err_msg=path)
    L, d, e, f = 2, 64, 4, 128
    shapes = ttf.param_shapes(tcfg)["layers"]
    assert (shapes["router"], shapes["w_gate"], shapes["w_up"],
            shapes["w_down"]) == ((L, d, e), (L, e, d, f), (L, e, d, f),
                                  (L, e, f, d))
    init = ttf.init_params(torch.Generator().manual_seed(0), tcfg)
    jinit = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    assert {k: tuple(v.shape) for k, v in _flat(init).items()} == \
        {k: tuple(v.shape) for k, v in _flat(jinit).items()}
    for name in ("router", "w_gate", "w_down"):   # fan-in scaled draws
        std = float(init["layers"][name].std())
        jstd = float(jnp.std(jinit["layers"][name]))
        assert std == pytest.approx(jstd, rel=0.1), name
    dense = jax.tree.map(np.asarray, jtf.init_params(
        jax.random.PRNGKey(0), dataclasses.replace(jcfg, n_experts=0)))
    with pytest.raises(KeyError, match="router"):
        ttf.params_from_numpy(dense, tcfg)
