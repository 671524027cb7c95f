"""The port's training path against the JAX package's on the same inputs.

The plain backward versions of the CUDA kernels (RMSNorm, flash attention,
RoPE) against the JAX Pallas kernels in interpret mode; the lean SwiGLU
and chunked cross-entropy gradients against jax.grad; the port's loss_fn
and its gradients against tf.loss_fn on the same weights; and three train
steps of the port against the JAX train step on a one-device mesh, from
the same params and token arrays, at grad_accum 1 and 2 (bf16
accumulator). Everything runs in f32 on the CPU. Tolerances: 1e-5 for
single ops (summation order and transcendental implementations), 1e-4 for
flash and for whole models and train steps (sums over more terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.models import transformer as jtf
from k8s_gpu_workload_enhancer_tpu.ops import chunked_ce as jce
from k8s_gpu_workload_enhancer_tpu.ops import flash_attention as jflash
from k8s_gpu_workload_enhancer_tpu.ops import layers as jlayers
from k8s_gpu_workload_enhancer_tpu.ops import rms_pallas as jrms
from k8s_gpu_workload_enhancer_tpu.ops import rope_pallas as jrope
from k8s_gpu_workload_enhancer_tpu.parallel import mesh as jmesh
from k8s_gpu_workload_enhancer_tpu.train import trainer as jtrainer
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.ops import chunked_ce as tce
from k8s_gpu_workload_enhancer_tpu_torch.ops import flash_attention as tflash
from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
from k8s_gpu_workload_enhancer_tpu_torch.ops import layers as tlayers
from k8s_gpu_workload_enhancer_tpu_torch.ops import rms as trms
from k8s_gpu_workload_enhancer_tpu_torch.ops import rope as trope
from k8s_gpu_workload_enhancer_tpu_torch.train import trainer as ttrainer

import torch_parity as tp

OP_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)


def _randn(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _grads_np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got, want, path="", **tol):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], f"{path}/{k}", **tol)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=path, **tol)


# ---------------------------------------------------------------------------
# The kernels' plain backward versions against the JAX kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,d", [(64, 256), (256, 512), (8, 128)])
def test_rms_backward_plain_matches_jax_kernel(rows, d):
    x = _randn(rows, d, seed=rows)
    w = 1.0 + _randn(d, seed=1, scale=0.1)
    g = _randn(rows, d, seed=2)
    want_dx, want_dw = jrms._rms_bwd_call(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(g), 1e-6,
                                          interpret=True)
    dx, dw = trms.rms_norm_backward_plain(_t(x), _t(w), _t(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **OP_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), **OP_TOL)


# The port's width: the autograd path (the CPU's plain backward) and the
# plain backward against the JAX backward kernel in interpret mode. f32
# within OP_TOL; bf16 x and dy with the trainer's f32 weight: dx within one
# bf16 rounding (rtol 2^-7) plus 1e-3 of its root mean square for entries
# where cancellation decides the last bits, dw (f32 sums over the rows)
# within OP_TOL.
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_backward_matches_jax_kernel_at_the_port_width(dtype):
    x = _randn(64, 2048, seed=9, scale=2.0)
    w = 1.0 + _randn(2048, seed=10, scale=0.1)
    g = _randn(64, 2048, seed=11)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    want_dx, want_dw = jrms._rms_bwd_call(
        jnp.asarray(x).astype(jdt), jnp.asarray(w),
        jnp.asarray(g).astype(jdt), 1e-6, interpret=True)
    want_dx = np.asarray(want_dx.astype(jnp.float32))
    xt = _t(x).to(tdt).requires_grad_()
    wt = _t(w).requires_grad_()
    gt = _t(g).to(tdt)
    got = {"autograd": torch.autograd.grad(trms.rms_norm(xt, wt), (xt, wt),
                                           gt),
           "plain": trms.rms_norm_backward_plain(xt.detach(), wt.detach(),
                                                 gt)}
    rms_dx = float(np.sqrt(np.mean(want_dx ** 2)))
    dx_tol = (dict(atol=1e-3 * rms_dx, rtol=2.0 ** -7) if dtype == "bf16"
              else OP_TOL)
    for path, (dx, dw) in got.items():
        assert dx.dtype == tdt and dw.dtype == torch.float32, path
        np.testing.assert_allclose(dx.float().numpy(), want_dx,
                                   err_msg=path, **dx_tol)
        np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw),
                                   err_msg=path, **OP_TOL)


def test_rms_autograd_matches_jax_vjp():
    x, w, g = _randn(4, 8, 128, seed=3), 1.0 + _randn(128, seed=4, scale=0.1), \
        _randn(4, 8, 128, seed=5)
    _, vjp = jax.vjp(lambda a, b: jrms.rms_norm_pallas(a, b), jnp.asarray(x),
                     jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    dx, dw = torch.autograd.grad(trms.rms_norm(xt, wt), (xt, wt), _t(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **OP_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), **OP_TOL)


def _flat(a, b, s, h, d):
    return jnp.asarray(a).transpose(0, 2, 1, 3).reshape(b * h, s, d)


def _unflat(a, b, s, h, d):
    return np.asarray(a).reshape(b, h, s, d).transpose(0, 2, 1, 3)


# (causal, stash, (b, sq, sk, h, d, q_offset)): D 128 at S 256 under its
# first ids, then head_dim 64, queries at an offset (Sq 256 against Sk 512,
# q_offset 256), and the flagship's head_dim 512 on its flat (B*H, S, 1, D)
# view: the edges and widths the card's bodies are held to them at.
_BWD_PLAIN_CASES = (
    [pytest.param(causal, stash, (1, 256, 256, 2, 128, 0),
                  id=f"{causal}-{stash}")
     for stash in (True, False) for causal in (True, False)]
    + [pytest.param(causal, stash, (1, 128, 128, 2, 64, 0),
                    id=f"d64-{causal}-{stash}")
       for stash in (True, False) for causal in (True, False)]
    + [pytest.param(True, stash, (1, 256, 512, 2, 128, 256),
                    id=f"q_offset256-True-{stash}")
       for stash in (True, False)]
    + [pytest.param(causal, stash, (1, 128, 128, 1, 512, 0),
                    id=f"d512-{causal}-{stash}")
       for stash in (True, False) for causal in (True, False)])


@pytest.mark.parametrize("causal,stash,shape", _BWD_PLAIN_CASES)
def test_flash_backward_plain_matches_jax_kernels(monkeypatch, stash,
                                                  causal, shape):
    """Both dK/dV branches of `_flash_backward_flat` (the p/ds stash and
    the recompute kernel, chosen by PDS_STASH_LIMIT_BYTES), whole and
    composed from the per-kernel plain versions, at D 128 and S 256, at
    D 64, with Sq 256 at q_offset 256 against Sk 512, and at the flagship's
    head_dim 512 (one head)."""
    b, sq, sk, h, d, q_off = shape
    q, do = (_randn(b, sq, h, d, seed=10 + i) for i in (0, 3))
    k, v = (_randn(b, sk, h, d, seed=10 + i) for i in (1, 2))
    o, lse = tflash.flash_attention(_t(q), _t(k), _t(v), causal, q_off,
                                    return_lse=True)
    monkeypatch.setattr(jflash, "PDS_STASH_LIMIT_BYTES",
                        int(1.2e9) if stash else 0)
    want = jflash._flash_backward_flat(
        *(_flat(a, b, s_, h, d) for a, s_ in ((q, sq), (k, sk), (v, sk),
                                              (o.numpy(), sq))),
        jnp.asarray(lse.numpy()).reshape(b * h, sq), _flat(do, b, sq, h, d),
        causal, q_off, 0, interpret=True)
    got = tflash.flash_attention_backward_plain(_t(q), _t(k), _t(v), o, lse,
                                                _t(do), causal, q_off)
    # The same branch composed from the per-kernel plain versions.
    args = (_t(q), _t(k), _t(v), _t(do), lse,
            tflash.backward_delta(o, _t(do)), causal, q_off)
    dq, p_st, ds_st = tflash.flash_bwd_dq_plain(*args, stash=stash)
    dkv = (tflash.flash_bwd_dkv_from_stash_plain(*args[:4], p_st, ds_st,
                                                 causal, q_off)
           if stash else tflash.flash_bwd_dkv_plain(*args))
    for name, g, g2, w, s_ in zip(("dq", "dk", "dv"), got, (dq, *dkv), want,
                                  (sq, sk, sk)):
        np.testing.assert_allclose(g.numpy(), _unflat(w, b, s_, h, d),
                                   err_msg=name, **TOL)
        np.testing.assert_allclose(g2.numpy(), _unflat(w, b, s_, h, d),
                                   err_msg=f"per-kernel {name}", **TOL)


def test_flash_autograd_matches_jax_vjp_with_gqa_and_offsets():
    """The port's differentiable entry (GQA expanded, then the kernels'
    plain versions) against jax.vjp of the JAX attention reference, with
    q/kv offsets."""
    b, sq, sk, h, kh, d = 2, 16, 48, 4, 2, 64
    q, k, v = (_randn(b, s_, hh, d, seed=20 + i)
               for i, (s_, hh) in enumerate(((sq, h), (sk, kh), (sk, kh))))
    g = _randn(b, sq, h, d, seed=23)
    from k8s_gpu_workload_enhancer_tpu.ops.attention import attention_reference
    _, vjp = jax.vjp(lambda a, bb, c: attention_reference(
        a, bb, c, causal=True, q_offset=20, kv_offset=8),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = tflash.flash_attention_train(qt, kt, vt, True, 20, 8)
    got = torch.autograd.grad(out, (qt, kt, vt), _t(g))
    for name, gg, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(gg.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def test_rope_vjp_matches_jax():
    x, g = _randn(2, 16, 2, 256, seed=30), _randn(2, 16, 2, 256, seed=31)
    ang = np.outer(np.arange(16), np.linspace(0.1, 1.0, 128)).astype(
        np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    _, vjp = jax.vjp(lambda a: jrope.rope_rotate(a, jnp.asarray(cos),
                                                 jnp.asarray(sin)),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_()
    (got,) = torch.autograd.grad(trope.rope_rotate(xt, _t(cos), _t(sin)),
                                 (xt,), _t(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


# ---------------------------------------------------------------------------
# Plain-torch training ops against jax.grad
# ---------------------------------------------------------------------------


def test_swiglu_lean_grads_match_jax():
    x = _randn(6, 64, seed=40)
    ws = (_randn(64, 96, seed=41, scale=0.1), _randn(64, 96, seed=42,
                                                     scale=0.1),
          _randn(96, 64, seed=43, scale=0.1))
    g = _randn(6, 64, seed=44)
    _, vjp = jax.vjp(jlayers.swiglu_lean, jnp.asarray(x),
                     *map(jnp.asarray, ws))
    want = vjp(jnp.asarray(g))
    args = [_t(a).requires_grad_() for a in (x, *ws)]
    out = tlayers.swiglu_lean(*args)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jlayers.swiglu(jnp.asarray(x), *map(jnp.asarray, ws))),
        **OP_TOL)
    got = torch.autograd.grad(out, args, _t(g))
    for name, gg, w in zip(("dx", "dw_gate", "dw_up", "dw_down"), got, want):
        np.testing.assert_allclose(gg.numpy(), np.asarray(w), err_msg=name,
                                   **OP_TOL)


@pytest.mark.parametrize("vocab,chunk,cache", [
    (320, 128, False),      # ragged tail: last chunk clamped to 192
    (256, 64, False),       # chunks divide the vocab
    (96, 96, True),         # one chunk, cached logits
])
def test_chunked_xent_value_and_grads_match_jax(vocab, chunk, cache):
    h = _randn(2, 5, 32, seed=50)
    head = _randn(32, vocab, seed=51, scale=0.3)
    tgt = np.random.default_rng(52).integers(0, vocab, (2, 5)).astype(
        np.int32)
    tgt[0, 0], tgt[1, 4] = vocab - 1, 0          # both ends of the vocab

    def jloss(a, b):
        return jce.chunked_softmax_xent(a, b, jnp.asarray(tgt), chunk, cache)
    want_loss, (want_dh, want_dhead) = jax.value_and_grad(
        jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(head))
    ht, headt = _t(h).requires_grad_(), _t(head).requires_grad_()
    loss = tce.chunked_softmax_xent(ht, headt, _t(tgt), chunk, cache)
    dh, dhead = torch.autograd.grad(loss, (ht, headt))
    np.testing.assert_allclose(loss.item(), float(want_loss), **OP_TOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(want_dh), **OP_TOL)
    np.testing.assert_allclose(dhead.numpy(), np.asarray(want_dhead),
                               **OP_TOL)
    # And the plain full-logits loss computes the same function.
    np.testing.assert_allclose(
        tlayers.cross_entropy_loss(ht.detach() @ headt.detach(),
                                   _t(tgt)).item(),
        float(jlayers.cross_entropy_loss(jnp.asarray(h) @ jnp.asarray(head),
                                         jnp.asarray(tgt))), **OP_TOL)


# ---------------------------------------------------------------------------
# The model loss and the train step
# ---------------------------------------------------------------------------


def _train_tokens(shape, seed):
    return np.random.default_rng(seed).integers(
        0, tp.TRAIN_DIMS["vocab_size"], shape).astype(np.int32)


@pytest.mark.parametrize("ffn_lean,use_chunked_ce",
                         [(True, True), (False, False)])
def test_loss_fn_and_grads_match_jax(ffn_lean, use_chunked_ce):
    import dataclasses
    jcfg = dataclasses.replace(tp.train_jax_cfg(), ffn_lean_vjp=ffn_lean,
                               use_chunked_ce=use_chunked_ce)
    tcfg = dataclasses.replace(tp.train_torch_cfg(), ffn_lean_vjp=ffn_lean,
                               use_chunked_ce=use_chunked_ce)
    jp = jtf.init_params(jax.random.PRNGKey(3), jcfg)
    toks = _train_tokens((2, tp.TRAIN_DIMS["max_seq"] + 1), seed=7)
    (want, want_parts), want_g = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jnp.asarray(toks), jcfg), has_aux=True)(jp)
    params = ttf.params_from_numpy(_grads_np(jp), tcfg, "cpu")
    leaves = ttrainer.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    total, parts = ttf.loss_fn(params, _t(toks).long(), tcfg)
    grads = iter(torch.autograd.grad(total, leaves))
    got_g = ttrainer.tree_map(lambda _: next(grads), params)
    np.testing.assert_allclose(total.item(), float(want), **TOL)
    np.testing.assert_allclose(parts["nll"].item(), float(want_parts["nll"]),
                               **TOL)
    _assert_tree_close(got_g, want_g, **TOL)


def test_remat_keeps_loss_and_grads():
    import dataclasses
    cfg = tp.train_torch_cfg()
    jp = jtf.init_params(jax.random.PRNGKey(4), tp.train_jax_cfg())
    toks = _t(_train_tokens((2, tp.TRAIN_DIMS["max_seq"] + 1), seed=8)).long()
    out = []
    for c in (cfg, dataclasses.replace(cfg, remat=True),
              dataclasses.replace(cfg, remat_ffn=True)):
        params = ttf.params_from_numpy(_grads_np(jp), c, "cpu")
        leaves = ttrainer.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        total, _ = ttf.loss_fn(params, toks, c)
        out.append((total.item(), torch.autograd.grad(total, leaves)))
    for total, grads in out[1:]:
        assert total == pytest.approx(out[0][0], rel=1e-6)
        for a, b in zip(grads, out[0][1]):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("grad_accum,lr", [(1, 1e-2), (2, 1e-3)])
def test_train_steps_match_jax(grad_accum, lr):
    """Three steps from the same params on the same tokens: loss,
    grad_norm and params within 1e-4 after every step. warmup_steps 1, so
    step 0 runs at lr 0 and steps 1-2 update. With the bf16 accumulator a
    gradient element whose two microbatch halves cancel keeps only a few
    bits, so the two packages' last-bit differences can move its Adam
    update by a few percent of lr: that case runs at lr 1e-3."""
    jcfg, tcfg = tp.train_jax_cfg(), tp.train_torch_cfg()
    tc = dict(learning_rate=lr, warmup_steps=1, total_steps=5,
              batch_size=4, seq_len=tp.TRAIN_DIMS["max_seq"],
              grad_accum=grad_accum, grad_accum_dtype="bf16")
    mesh = jmesh.single_device_mesh()
    jstate = jtrainer.init_state(jcfg, jtrainer.TrainConfig(**tc), mesh)
    jstep = jtrainer.make_train_step(jcfg, jtrainer.TrainConfig(**tc), mesh)
    tstate = ttrainer.TrainState(
        params=ttrainer.tree_map(lambda p: p.requires_grad_(True),
                                 tp.to_torch_tree(jstate.params)),
        opt_state=None, step=0)
    tcfg_train = ttrainer.TrainConfig(**tc)
    tstate.opt_state = ttrainer.make_optimizer(tcfg_train).init(
        tstate.params)
    tstep = ttrainer.make_train_step(tcfg, tcfg_train)
    shape = ((4, tc["seq_len"] + 1) if grad_accum == 1
             else (grad_accum, 4 // grad_accum, tc["seq_len"] + 1))
    for i in range(3):
        toks = _train_tokens(shape, seed=100 + i)
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tstate, tm = tstep(tstate, _t(toks).long())
        for key in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       err_msg=f"step {i} {key}", **TOL)
        assert tm["step"] == int(jm["step"]) == i + 1
        _assert_tree_close(tstate.params, jstate.params, f"step {i}", **TOL)
        if i == 0:   # lr 0 at count 0: the params have not moved
            _assert_tree_close(tstate.params, tp.to_torch_tree(
                jtf.init_params(jax.random.PRNGKey(0), jcfg)), **TOL)
    assert tstate.opt_state["count"] == 3
    assert sum(kernels.launches.values()) == 0


def test_optimizer_update_matches_optax():
    """clip_by_global_norm then adamw (eps 1e-8, b2 0.95, weight decay on
    every leaf, the schedule at the pre-increment count) over four updates,
    clipping and not, with a weight decay large enough to see."""
    import optax
    cfg = ttrainer.TrainConfig(learning_rate=0.05, warmup_steps=2,
                               total_steps=6, weight_decay=0.5, grad_clip=1.0)
    tree = {"a": _randn(3, 4, seed=60), "b": {"c": _randn(5, seed=61)}}
    opt = jtrainer.make_optimizer(jtrainer.TrainConfig(
        learning_rate=0.05, warmup_steps=2, total_steps=6, weight_decay=0.5,
        grad_clip=1.0))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = opt.init(jparams)
    tparams = ttrainer.tree_map(_t, tree)
    adamw = ttrainer.make_optimizer(cfg)
    tstate = adamw.init(tparams)
    for i, scale in enumerate((3.0, 0.1, 2.0, 0.05)):   # clipped and not
        grads = {"a": _randn(3, 4, seed=70 + i, scale=scale),
                 "b": {"c": _randn(5, seed=80 + i, scale=scale)}}
        upd, jstate = opt.update(jax.tree.map(jnp.asarray, grads), jstate,
                                 jparams)
        jparams = optax.apply_updates(jparams, upd)
        adamw.update(tparams, ttrainer.tree_map(_t, grads), tstate)
        _assert_tree_close(tparams, jparams, f"update {i}", atol=1e-6,
                           rtol=1e-5)
    np.testing.assert_allclose(
        ttrainer.global_norm(ttrainer.tree_map(_t, tree)).item(),
        float(optax.global_norm(jax.tree.map(jnp.asarray, tree))), rtol=1e-6)


def test_learning_rate_schedule_matches_optax():
    import optax
    cfg = ttrainer.TrainConfig(learning_rate=3e-4, warmup_steps=4,
                               total_steps=10)
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 4, 10)
    for count in range(14):
        assert ttrainer.learning_rate(cfg, count) == pytest.approx(
            float(sched(count)), rel=1e-6, abs=1e-12)
    short = ttrainer.TrainConfig(warmup_steps=100, total_steps=50)
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 100, 101)
    for count in (0, 50, 100, 101, 150):
        assert ttrainer.learning_rate(short, count) == pytest.approx(
            float(sched(count)), rel=1e-6, abs=1e-12)


def test_train_config_is_validated():
    with pytest.raises(ValueError):
        ttrainer.TrainConfig(grad_accum_dtype="f16")
    with pytest.raises(ValueError):
        ttrainer.TrainConfig(batch_size=6, grad_accum=4).microbatch_size
    for f in ("learning_rate", "warmup_steps", "total_steps", "weight_decay",
              "grad_clip", "batch_size", "seq_len", "seed", "grad_accum",
              "grad_accum_dtype"):
        assert getattr(ttrainer.TrainConfig(), f) == getattr(
            jtrainer.TrainConfig(), f), f


def test_flops_per_token_matches_jax():
    for kw in (dict(), dict(vocab_size=32768, d_model=2048, n_layers=8,
                            n_heads=16, d_ff=8192, max_seq=2048)):
        assert ttf.TransformerConfig(**kw).flops_per_token() == \
            jtf.TransformerConfig(**kw).flops_per_token()
        assert ttf.TransformerConfig(**kw).flops_per_token(512) == \
            jtf.TransformerConfig(**kw).flops_per_token(512)


def test_train_loop_reports_throughput_on_the_cpu():
    tcfg = ttrainer.TrainConfig(batch_size=2, seq_len=16, warmup_steps=1,
                                total_steps=4)
    seen = []
    out = ttrainer.train_loop(tp.train_torch_cfg(), tcfg, num_steps=4,
                              callback=lambda i, m: seen.append(i),
                              device="cpu", stop=lambda: len(seen) == 3)
    assert seen == [0, 1, 2] and out["steps_run"] == 3
    assert out["steps"] == 2                  # the first step is left out
    assert np.isfinite(out["final_loss"])
    assert out["tokens_per_s"] > 0 and out["achieved_tflops"] > 0


def test_unported_model_options_raise():
    import dataclasses
    cfg = dataclasses.replace(tp.train_torch_cfg(), n_experts=4)
    params = ttf.init_params(torch.Generator().manual_seed(0),
                             tp.train_torch_cfg())
    toks = _t(_train_tokens((1, 9), seed=9)).long()
    with pytest.raises(NotImplementedError, match="A11"):
        ttf.loss_fn(params, toks, cfg)
