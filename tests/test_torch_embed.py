"""The port's embedding (ops/embed.py) against the JAX package's, on the
CPU, from seeded numpy inputs.

`embed_tokens` is held bit for bit to the JAX model's expression
`table.astype(dt)[ids] * math.sqrt(d_model)` (models/transformer.py:310,
decode.py:251, serving.py:286 and :738), where the weakly typed product
rounds sqrt(d_model) to the compute dtype first, and its VJP to the one
JAX's AD takes of that expression; the model's three embedding sites are
shown to reach it. The plain `embed_lookup` is held to the JAX
`embed_lookup` (its Pallas kernel in interpret mode) and to its custom VJP.
VJP limits: f32 sums of repeated ids taken in another order (1e-6
relative, in norm: an entry where the sum cancels may differ by more than
1e-6 of itself); bf16, one rounding of such a sum (one bf16 ulp, 2^-7 of
the value).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.ops import embed_pallas as jembed
from k8s_gpu_workload_enhancer_tpu_torch.models import decode as tdecode
from k8s_gpu_workload_enhancer_tpu_torch.models import serving as tserving
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.ops import embed, kernels

import torch_parity as tp

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
VOCAB = 64
# In range and out of it: V and past it clamp to V - 1 in the forward and
# drop in the VJP; -1 wraps to V - 1; -V wraps to 0; -V - 3 wraps to -3,
# then clamps to 0 and drops.
WILD_IDS = [[0, VOCAB - 1, VOCAB, VOCAB + 5, -1, -VOCAB, -VOCAB - 3, 7],
            [7, 7, 3, VOCAB - 1, 0, 2, 2 * VOCAB, 5]]


def _table(v, d, seed=0):
    return (0.02 * np.random.default_rng(seed).standard_normal((v, d))
            ).astype(np.float32)


def _ids(shape, v, seed=1):
    return np.random.default_rng(seed).integers(0, v, shape).astype(np.int32)


def _f32(a) -> np.ndarray:
    """A JAX array or a torch tensor as f32 numpy (exact for bf16)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _jax_model_embed(table, ids, d, jdt):
    return jnp.asarray(table).astype(jdt)[jnp.asarray(ids)] * math.sqrt(d)


def _assert_within_ulp(got, want, dtype):
    g, w = _f32(got), _f32(want)
    if dtype == "f32":
        assert np.linalg.norm(g - w) <= 1e-6 * np.linalg.norm(w)
    else:
        np.testing.assert_array_less(np.abs(g - w),
                                     np.abs(w) * 2.0 ** -7 + 1e-30)


@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [512, 2048])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embed_tokens_matches_jax_model_expression(dtype, d, table_dtype):
    jdt, tdt = DTYPES[dtype]
    table = _table(VOCAB, d)
    if table_dtype == "bf16":         # a table already in the compute dtype
        table = _f32(torch.from_numpy(table).to(torch.bfloat16))
    ids = _ids((4, 32), VOCAB)
    want = _jax_model_embed(table, ids, d, jdt)
    t = torch.from_numpy(table)
    got = embed.embed_tokens(t, torch.from_numpy(ids), d, tdt)
    assert got.dtype == tdt and got.shape == (4, 32, d)
    np.testing.assert_array_equal(_f32(got), _f32(want))
    # The unrounded scale (the expression before the repair) is off by an
    # ulp on a few percent of the elements at bf16 where sqrt(d) is not a
    # bf16 value; at f32 it is the same function.
    before = t.to(tdt)[torch.from_numpy(ids).long()] * math.sqrt(d)
    assert np.array_equal(_f32(before), _f32(want)) == (dtype == "f32")


@pytest.mark.parametrize("d", [512, 2048])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embed_tokens_vjp_matches_jax_model(dtype, d):
    jdt, tdt = DTYPES[dtype]
    table = _table(VOCAB, d, seed=2)
    ids = _ids((4, 32), 8, seed=3)            # ids 0..7, many repeats
    g = np.random.default_rng(4).standard_normal((4, 32, d)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda t: _jax_model_embed(t, ids, d, jdt),
                     jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g).astype(jdt))
    t = torch.from_numpy(table).requires_grad_()
    out = embed.embed_tokens(t, torch.from_numpy(ids), d, tdt)
    (got,) = torch.autograd.grad(out, (t,), torch.from_numpy(g).to(tdt))
    assert got.dtype == torch.float32
    _assert_within_ulp(got, want, dtype)
    assert not got[8:].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embed_tokens_out_of_range_ids_match_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    d = 256
    table = _table(VOCAB, d, seed=5)
    ids = np.asarray(WILD_IDS, np.int32)
    g = np.random.default_rng(6).standard_normal(ids.shape + (d,)).astype(
        np.float32)
    want, vjp = jax.vjp(lambda t: _jax_model_embed(t, ids, d, jdt),
                        jnp.asarray(table))
    (want_dt,) = vjp(jnp.asarray(g).astype(jdt))
    t = torch.from_numpy(table).requires_grad_()
    for id_dtype in (torch.int32, torch.int64):
        got = embed.embed_tokens(t, torch.from_numpy(ids).to(id_dtype), d,
                                 tdt)
        np.testing.assert_array_equal(_f32(got), _f32(want))
        (got_dt,) = torch.autograd.grad(got, (t,),
                                        torch.from_numpy(g).to(tdt))
        _assert_within_ulp(got_dt, want_dt, dtype)


def test_embed_tokens_reads_strided_ids():
    """The training loss passes `tokens[:, :-1]`, a view with row stride
    S + 1; decode passes (B,) ids."""
    table = torch.from_numpy(_table(VOCAB, 64))
    toks = torch.from_numpy(_ids((3, 17), VOCAB, seed=7)).long()
    view = toks[:, :-1]
    assert not view.is_contiguous()
    got = embed.embed_tokens(table, view, 2048, torch.bfloat16)
    assert torch.equal(got, embed.embed_tokens(table, view.contiguous(),
                                               2048, torch.bfloat16))
    assert torch.equal(embed.embed_tokens(table, toks[:, 0], 2048,
                                          torch.bfloat16), got[:, 0])


def test_model_sites_reach_embed_tokens(monkeypatch):
    """forward_hidden (training), forward_cached (every prefill chunk) and
    the engine's decode step each embed through `embed_tokens`: once per
    call, chunk and step."""
    _, _, cfg, params = tp.model()
    calls = {}

    def spy(module):
        real = module.embed_tokens

        def counted(*a, **k):
            calls[module.__name__] = calls.get(module.__name__, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(module, "embed_tokens", counted)
    for module in (ttf, tdecode, tserving):
        spy(module)
    toks = torch.from_numpy(tp.tokens((2, 33)))
    ttf.loss_fn(params, toks, cfg)
    assert calls == {ttf.__name__: 1}
    calls.clear()
    kernels.reset_launches()
    eng = tserving.ContinuousBatchEngine(params, cfg, num_slots=2,
                                         prefill_len=tp.PREFILL_LEN,
                                         device="cpu")
    rids = [eng.submit(tp.tokens((40,), seed=s).tolist(), 6)
            for s in (1, 2)]
    eng.run()
    assert all(len(eng.result(r).tokens) == 6 for r in rids)
    life = eng.metrics()["lifetime"]
    assert calls == {tdecode.__name__: life["prefill_chunks"],
                     tserving.__name__: life["decode_steps"]}
    assert life["prefill_chunks"] == 4 and life["decode_steps"] > 0
    assert sum(kernels.launches.values()) == 0


@pytest.mark.parametrize("table_dtype,out_dtype", [("f32", "f32"),
                                                   ("bf16", "bf16"),
                                                   ("f32", "bf16")])
def test_embed_lookup_and_vjp_match_jax(table_dtype, out_dtype):
    d, scale = 1024, 1.2345
    jt, tt = DTYPES[table_dtype]
    jo, to = DTYPES[out_dtype]
    table = _table(VOCAB, d, seed=8)
    ids = np.asarray([[3, 9, 3, 0, 63, 9, 9, 1], [5, 5, 5, 3, 0, 63, 2, 4]],
                     np.int32)                  # (2, 8) with repeats
    g = np.random.default_rng(9).standard_normal((2, 8, d)).astype(
        np.float32)
    jtable = jnp.asarray(table).astype(jt)
    want, vjp = jax.vjp(lambda t: jembed.embed_lookup(t, jnp.asarray(ids),
                                                      scale, jo), jtable)
    (want_dt,) = vjp(jnp.asarray(g).astype(jo))
    t = torch.from_numpy(table).to(tt).requires_grad_()
    got = embed.embed_lookup(t, torch.from_numpy(ids), scale, to)
    assert got.dtype == to and got.shape == (2, 8, d)
    np.testing.assert_array_equal(_f32(got), _f32(want))
    (got_dt,) = torch.autograd.grad(got, (t,), torch.from_numpy(g).to(to))
    assert got_dt.dtype == tt
    _assert_within_ulp(got_dt, want_dt, table_dtype)
    assert sum(kernels.launches.values()) == 0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embed_lookup_out_of_range_ids_match_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    d = 1024
    table = _table(VOCAB, d, seed=10)
    ids = np.asarray(WILD_IDS, np.int32)
    g = np.random.default_rng(11).standard_normal(ids.shape + (d,)).astype(
        np.float32)
    jtable = jnp.asarray(table).astype(jdt)
    want, vjp = jax.vjp(lambda t: jembed.embed_lookup(t, jnp.asarray(ids),
                                                      0.5, jdt), jtable)
    (want_dt,) = vjp(jnp.asarray(g).astype(jdt))
    t = torch.from_numpy(table).to(tdt).requires_grad_()
    got = embed.embed_lookup(t, torch.from_numpy(ids), 0.5, tdt)
    np.testing.assert_array_equal(_f32(got), _f32(want))
    (got_dt,) = torch.autograd.grad(got, (t,), torch.from_numpy(g).to(tdt))
    _assert_within_ulp(got_dt, want_dt, dtype)


def test_cpu_embedding_takes_the_plain_version_and_launches_nothing():
    kernels.reset_launches()
    table = torch.from_numpy(_table(VOCAB, 64))
    ids = torch.from_numpy(np.asarray(WILD_IDS, np.int32))
    for round_rows in (False, True):
        assert torch.equal(
            embed.embed_gather(table, ids, 3.0, torch.bfloat16, round_rows),
            embed.embed_gather_plain(table, ids, 3.0, torch.bfloat16,
                                     round_rows))
    assert sum(kernels.launches.values()) == 0
    with pytest.raises(ValueError):     # the CUDA-only wrapper refuses CPU
        embed._embed_gather_cuda(table, ids, 1.0, torch.float32)
