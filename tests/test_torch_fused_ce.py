"""The port's fused LM-head cross-entropy against the JAX package's.

The plain versions of the fused CE kernels against the JAX Pallas kernels
in interpret mode (as tests/unit/test_fused_ce.py runs them), the
differentiable op against the JAX custom VJP, the shape gate against the
JAX gate, and the model loss with `ce_cache_logits` on at a fused-eligible
shape (d 512, 2 heads of 256, seq 256, vocab 512, f32), where both
packages take the fused path: loss and every gradient leaf.

Tolerances: loss 1e-5 (f32 sums in another order); gradients 1e-4 in
relative norm (the plain versions repeat every bf16 rounding point of the
kernels, so only the last bits of the f32 sums differ, and a logit on a
bf16 rounding boundary may round to the neighbouring stash value).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.models import transformer as jtf
from k8s_gpu_workload_enhancer_tpu.ops import fused_ce as jfce
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.ops import fused_ce as tfce
from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
from k8s_gpu_workload_enhancer_tpu_torch.train import trainer as ttrainer

import torch_parity  # noqa: F401  (one intra-op thread a process)

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_REL_NORM = 1e-4

# The fused- and t-layout-eligible model of this file and of
# tests/test_torch_flagship.py (tests/unit/test_model.py's t-layout shape,
# vocab 512).
FUSED_DIMS = dict(vocab_size=512, d_model=512, n_layers=1, n_heads=2,
                  n_kv_heads=2, d_ff=1024, max_seq=256)


def _randn(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_norm(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _case(b, s, d, v, seed):
    h = _randn(b, s, d, seed=seed)
    head = _randn(d, v, seed=seed + 1, scale=0.05)
    tgt = np.random.default_rng(seed + 2).integers(0, v, (b, s)).astype(
        np.int32)
    tgt.flat[0], tgt.flat[-1] = 0, v - 1          # both ends of the vocab
    return h, head, tgt


@pytest.mark.parametrize("b,s,d,v", [(2, 64, 256, 1024), (1, 256, 512, 512),
                                     (3, 40, 128, 264)])
def test_plain_versions_match_jax_kernels(b, s, d, v):
    """Each kernel's plain version against the Pallas kernel in interpret
    mode: lse and gold, the bf16 stash, dlg and dH."""
    h, head, tgt = _case(b, s, d, v, seed=b * 10 + v)
    n = b * s
    h2, t1 = h.reshape(n, d), tgt.reshape(n)
    lse_j, gold_j, stash_j = jfce._fused_forward(
        jnp.asarray(h2), jnp.asarray(head), jnp.asarray(t1), 0, 0,
        interpret=True)
    lse, gold, stash = tfce.fused_ce_forward_plain(_t(h2), _t(head), _t(t1))
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **LOSS_TOL)
    np.testing.assert_allclose(gold.numpy(), np.asarray(gold_j), **LOSS_TOL)
    # A logit within an f32 rounding of a bf16 midpoint may round to the
    # neighbouring bf16 value: at most one ulp, in a handful of entries.
    diff = np.abs(stash.float().numpy() - np.asarray(stash_j, np.float32))
    assert diff.max() <= np.abs(np.asarray(stash_j, np.float32)).max() / 128
    assert (diff > 0).mean() < 1e-3
    scale = np.float32(0.7 / n)
    dlg_j, dh_j = jfce._fused_backward(
        stash_j, jnp.asarray(head), lse_j, jnp.asarray(t1), scale, 0, 0,
        interpret=True)
    stash_from_j = _t(np.asarray(stash_j, np.float32)).to(torch.bfloat16)
    dlg, dh = tfce.fused_ce_backward_plain(
        stash_from_j, _t(head), _t(np.asarray(lse_j)), _t(t1),
        torch.tensor([scale]))
    assert dlg.dtype == dh.dtype == torch.bfloat16
    ulp = np.abs(np.asarray(dlg_j, np.float32)) / 128 + 1e-30
    assert np.all(np.abs(dlg.float().numpy() - np.asarray(dlg_j, np.float32))
                  <= ulp)
    assert _rel_norm(dh.float().numpy(),
                     np.asarray(dh_j, np.float32)) < GRAD_REL_NORM


@pytest.mark.parametrize("b,s,d,v", [(3, 40, 128, 264), (1, 8, 128, 8)])
def test_dlg_stage_matches_jax_backward(b, s, d, v):
    """The plain backward's first stage (the card's dlg pass) against the
    dlg of the Pallas backward in interpret mode, at ragged N and V: within
    one bf16 ulp (the two exps may round an f32 p differently)."""
    h, head, tgt = _case(b, s, d, v, seed=3 * b + v)
    n = b * s
    h2, t1 = h.reshape(n, d), tgt.reshape(n)
    lse_j, _, stash_j = jfce._fused_forward(
        jnp.asarray(h2), jnp.asarray(head), jnp.asarray(t1), 0, 0,
        interpret=True)
    scale = np.float32(0.3 / n)
    dlg_j, _ = jfce._fused_backward(
        stash_j, jnp.asarray(head), lse_j, jnp.asarray(t1), scale, 0, 0,
        interpret=True)
    dlg = tfce.fused_ce_dlg_plain(
        _t(np.asarray(stash_j, np.float32)).to(torch.bfloat16),
        _t(np.asarray(lse_j)), _t(t1), torch.tensor([scale]))
    assert dlg.dtype == torch.bfloat16 and dlg.shape == (n, v)
    want = np.asarray(dlg_j, np.float32)
    assert np.all(np.abs(dlg.float().numpy() - want)
                  <= np.abs(want) / 128 + 1e-30)


@pytest.mark.parametrize("dtype,body", [(torch.bfloat16, "wgmma"),
                                        (torch.float32, "f32 pipes")])
def test_ce_body_is_chosen_by_dtype(dtype, body):
    """bf16 runs the tensor-core bodies, f32 the f32 pipes (true f32
    products for the f32 gates)."""
    assert tfce.ce_body(dtype) == body


@pytest.mark.parametrize("b,s,d,v", [(2, 64, 256, 1024), (1, 256, 512, 512)])
def test_fused_xent_value_and_grads_match_jax(b, s, d, v):
    h, head, tgt = _case(b, s, d, v, seed=7 * b + d)

    def jloss(a, w):
        return jfce.fused_lm_head_xent(a, w, jnp.asarray(tgt))
    want, (want_dh, want_dhead) = jax.value_and_grad(
        jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(head))
    ht, headt = _t(h).requires_grad_(), _t(head).requires_grad_()
    loss = tfce.fused_lm_head_xent(ht, headt, _t(tgt))
    dh, dhead = torch.autograd.grad(loss, (ht, headt))
    np.testing.assert_allclose(loss.item(), float(want), **LOSS_TOL)
    assert dh.dtype == dhead.dtype == torch.float32
    assert _rel_norm(dh.numpy(), want_dh) < GRAD_REL_NORM
    assert _rel_norm(dhead.numpy(), want_dhead) < GRAD_REL_NORM
    assert sum(kernels.launches.values()) == 0


@pytest.mark.parametrize("hidden,head", [
    ((2, 64, 256), (256, 1024)),      # the JAX test's case: supported
    ((2, 64, 256), (256, 1023)),      # V not block-divisible
    ((2, 64, 256), (255, 1024)),      # D mismatch
    ((64, 256), (256, 1024)),         # 2-D hidden
    ((2, 64, 200), (200, 1024)),      # D % 128 != 0
    ((1, 37, 256), (256, 1024)),      # N = 37 cannot block
    ((1, 8, 4096), (4096, 8)),        # the smallest blocks, D at its limit
    ((1, 8, 4224), (4224, 8)),        # D above 4096
])
def test_fused_ce_supported_matches_jax(hidden, head):
    want = jfce.fused_ce_supported(jax.ShapeDtypeStruct(hidden, jnp.float32),
                                   jax.ShapeDtypeStruct(head, jnp.float32))
    got = tfce.fused_ce_supported(torch.empty(hidden), torch.empty(head))
    assert got == want


def _models(dims, **kw):
    jcfg = jtf.TransformerConfig(**dims, dtype=jnp.float32, use_flash=True,
                                 use_ring_attention=False,
                                 scan_layers=False, **kw)
    tcfg = ttf.TransformerConfig(**dims, dtype=torch.float32, **kw)
    return jcfg, tcfg


def test_loss_fn_with_cached_logits_matches_jax():
    """`ce_cache_logits` at a fused-eligible shape: the JAX loss takes its
    fused CE kernels (bf16 dlogits, bf16 dH even in f32), so must the
    port's; a single-chunk chunked CE in the hidden dtype misses dH and
    dHead by 1e-3 in relative norm."""
    jcfg, tcfg = _models(FUSED_DIMS, ce_chunk=512, ce_cache_logits=True)
    jp = jtf.init_params(jax.random.PRNGKey(11), jcfg)
    toks = np.random.default_rng(12).integers(
        0, FUSED_DIMS["vocab_size"], (2, FUSED_DIMS["max_seq"] + 1)).astype(
        np.int32)
    (want, want_parts), want_g = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jnp.asarray(toks), jcfg), has_aux=True)(jp)
    params = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    leaves = ttrainer.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    total, parts = ttf.loss_fn(params, _t(toks).long(), tcfg)
    grads = torch.autograd.grad(total, leaves)
    np.testing.assert_allclose(total.item(), float(want), **LOSS_TOL)
    np.testing.assert_allclose(parts["nll"].item(), float(want_parts["nll"]),
                               **LOSS_TOL)
    names = ttrainer.tree_leaves(ttrainer._map_with_name(
        lambda name, _: name, params))
    want_leaves = ttrainer.tree_leaves(
        ttrainer.tree_map(lambda _, w: w, params,
                          jax.tree.map(np.asarray, want_g)))
    errs = {n: _rel_norm(g.numpy(), w)
            for n, g, w in zip(names, grads, want_leaves)}
    assert max(errs.values()) < GRAD_REL_NORM, errs


def test_loss_fn_keeps_the_chunked_ce_where_the_gate_is_off(monkeypatch):
    """ce_fused off, or a shape the gate refuses: the chunked op runs."""
    calls = []
    monkeypatch.setattr(ttf, "fused_lm_head_xent",
                        lambda *a: calls.append(a) or tfce.fused_lm_head_xent(
                            *a))
    _, tcfg = _models(FUSED_DIMS, ce_chunk=512, ce_cache_logits=True)
    params = ttf.init_params(torch.Generator().manual_seed(0), tcfg)
    toks = torch.randint(0, 512, (1, 65),
                         generator=torch.Generator().manual_seed(1))
    losses = {}
    for name, cfg, t in (
            ("fused", tcfg, toks),
            ("off", dataclasses.replace(tcfg, ce_fused=False), toks),
            ("ragged", tcfg, toks[:, :38])):      # N = 37 cannot block
        before = len(calls)
        losses[name] = ttf.loss_fn(params, t, cfg)[0].item()
        assert (len(calls) > before) == (name == "fused"), name
    assert losses["fused"] == pytest.approx(losses["off"], rel=1e-5)
