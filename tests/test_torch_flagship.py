"""The port's flagship training path (the t-layout RoPE and flash
attention, the fused LM-head CE) against the JAX package's, on the CPU.

The t-layout gate of the model (`_t_layout_ok`) against the JAX model's on
a table of shapes; and the whole slice at a small fused- and t-layout-
eligible size (d 512, 2 heads of 256, seq 256, vocab 512, 2 layers, f32):
the loss and its gradients through the fused and the chunked CE, then
three train steps at grad_accum 2 from the same params on the same tokens
with an f32 and a bf16 accumulator, and the flagship configuration's copy
against the JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.models import transformer as jtf
from k8s_gpu_workload_enhancer_tpu.ops import attention as jattn
from k8s_gpu_workload_enhancer_tpu.parallel import mesh as jmesh
from k8s_gpu_workload_enhancer_tpu.train import trainer as jtrainer
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
from k8s_gpu_workload_enhancer_tpu_torch.train import flagship
from k8s_gpu_workload_enhancer_tpu_torch.train import trainer as ttrainer

import torch_parity  # noqa: F401  (one intra-op thread a process)

TOL = dict(atol=1e-4, rtol=1e-4)
SLICE_DIMS = dict(vocab_size=512, d_model=512, n_layers=2, n_heads=2,
                  n_kv_heads=2, d_ff=1024, max_seq=256)


def _cfgs(dims, **kw):
    jcfg = jtf.TransformerConfig(**dims, dtype=jnp.float32, use_flash=True,
                                 use_ring_attention=False,
                                 scan_layers=False, **kw)
    return jcfg, ttf.TransformerConfig(**dims, dtype=torch.float32, **kw)


def _count(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("heads,kv_heads,head_dim,seq,offset,on", [
    (2, 2, 256, 64, 0, True),       # the parity model's shape
    (1, 1, 512, 512, 0, True),      # the flagship's head_dim
    (2, 2, 256, 768, 0, True),      # blocks of 256 on both gates
    (2, 2, 128, 64, 0, False),      # head_dim 128: RoPE's gate refuses
    (4, 2, 256, 64, 0, False),      # GQA
    (2, 2, 256, 64, 8, False),      # a prefill chunk at an offset
    (2, 2, 256, 12, 0, False),      # seq not a multiple of 8
    (2, 2, 256, 640, 0, False),     # seq past 256, not a multiple of it
])
def test_t_layout_gate_matches_jax(monkeypatch, heads, kv_heads, head_dim,
                                   seq, offset, on):
    dims = dict(vocab_size=64, d_model=heads * head_dim, n_layers=1,
                n_heads=heads, n_kv_heads=kv_heads, d_ff=64,
                max_seq=seq + offset)
    jcfg, tcfg = _cfgs(dims)
    j_calls = _count(monkeypatch, jattn, "apply_rope_t")
    t_calls = _count(monkeypatch, ttf, "apply_rope_t")
    real_flash_t = ttf.flash_attention_t

    def flash_t(*args):   # the kernels take contiguous (B*H, S, D) only
        assert all(a.is_contiguous() for a in args[:3])
        return real_flash_t(*args)
    monkeypatch.setattr(ttf, "flash_attention_t", flash_t)
    jp = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                jcfg))
    jax.eval_shape(lambda p: jtf.forward_hidden(
        p, jnp.zeros((1, seq), jnp.int32), jcfg, None, offset), jp)
    params = ttf.init_params(torch.Generator().manual_seed(0), tcfg)
    with torch.no_grad():
        ttf.forward_hidden(params, torch.zeros((1, seq), dtype=torch.long),
                           tcfg, offset)
    assert (len(j_calls) > 0) == on
    assert (len(t_calls) > 0) == on
    assert len(t_calls) == len(j_calls)


def _slice_tokens(shape, seed):
    return np.random.default_rng(seed).integers(
        0, SLICE_DIMS["vocab_size"], shape).astype(np.int32)


def _rel_norm(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("cache,grad_rel_norm", [(True, 1e-4), (False, 1e-5)])
def test_slice_loss_and_grads_match_jax(monkeypatch, cache, grad_rel_norm):
    """The loss and every gradient leaf, elementwise within 1e-4 and in
    relative norm per leaf. The two packages' f32 sums part in the last
    bits from the first RMSNorm and every matmul on; through the chunked CE
    (cache off) the gradients stay near that (about 1.2e-6 here, limit
    1e-5), while the fused CE (cache on) rounds dlogits and dH to bf16 in
    both packages, which turns those bits into bf16 rounding flips (about
    6.4e-5 here, limit 1e-4, the port's parity standard)."""
    jcfg, tcfg = _cfgs(SLICE_DIMS, ce_chunk=512, ce_cache_logits=cache)
    fused = _count(monkeypatch, ttf, "fused_lm_head_xent")
    t_layout = _count(monkeypatch, ttf, "flash_attention_t")
    jp = jtf.init_params(jax.random.PRNGKey(5), jcfg)
    toks = _slice_tokens((2, SLICE_DIMS["max_seq"] + 1), seed=6)
    want, want_g = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jnp.asarray(toks), jcfg)[0])(jp)
    params = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    leaves = ttrainer.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    total, _ = ttf.loss_fn(params, torch.from_numpy(toks).long(), tcfg)
    grads = torch.autograd.grad(total, leaves)
    assert len(fused) == int(cache)
    assert len(t_layout) == SLICE_DIMS["n_layers"]
    np.testing.assert_allclose(total.item(), float(want), **TOL)
    want_leaves = ttrainer.tree_leaves(ttrainer.tree_map(
        lambda _, w: np.asarray(w), params, want_g))
    for g, w in zip(grads, want_leaves):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
        assert _rel_norm(g.numpy(), w) <= grad_rel_norm


@pytest.mark.parametrize("acc_dtype", ["f32", "bf16"])
def test_slice_train_steps_match_jax(acc_dtype):
    """Three steps at grad_accum 2, warmup 1 so step 0 runs at lr 0 and
    steps 1-2 update, lr 1e-3. Loss, nll and grad norm within 1e-4 at
    either accumulator dtype, and with the f32 accumulator every param.

    The bf16 accumulator (the trainer's default, which the flagship runs)
    rounds the microbatch gradients, which differ between the packages by
    the fused CE's bf16 flips (test_slice_loss_and_grads_match_jax), to
    bf16 again: so some elements of the summed gradient differ by one bf16
    ulp. Where an element's two microbatch halves cancel, that ulp is most
    of the sum, and Adam's normalised step moves the element by a part of
    lr. Read at these inputs: at most 9 elements of 5.8 M past 1e-4 in a
    step, by 3.4e-4 at most, no leaf off by more than 2.1e-5 of its norm.
    So the bf16 case holds each param leaf to 1e-4 in relative norm, and
    elementwise to 1e-4 except at most 1e-5 of a leaf's elements, each
    within a reversed Adam step (2 lr) per update taken."""
    jcfg, tcfg = _cfgs(SLICE_DIMS, ce_chunk=512, ce_cache_logits=True)
    tc = dict(learning_rate=1e-3, warmup_steps=1, total_steps=5,
              batch_size=2, seq_len=SLICE_DIMS["max_seq"], grad_accum=2,
              grad_accum_dtype=acc_dtype)
    mesh = jmesh.single_device_mesh()
    jstate = jtrainer.init_state(jcfg, jtrainer.TrainConfig(**tc), mesh)
    jstep = jtrainer.make_train_step(jcfg, jtrainer.TrainConfig(**tc), mesh)
    params = ttf.params_from_numpy(jax.tree.map(np.asarray, jstate.params),
                                   tcfg, "cpu")
    tstate = ttrainer.TrainState(
        params=ttrainer.tree_map(lambda p: p.requires_grad_(True), params),
        opt_state=None, step=0)
    ttc = ttrainer.TrainConfig(**tc)
    tstate.opt_state = ttrainer.make_optimizer(ttc).init(tstate.params)
    tstep = ttrainer.make_train_step(tcfg, ttc)
    for i in range(3):
        toks = _slice_tokens((2, 1, tc["seq_len"] + 1), seed=200 + i)
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tstate, tm = tstep(tstate, torch.from_numpy(toks).long())
        for key in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       err_msg=f"step {i} {key}", **TOL)
        got = ttrainer.tree_leaves(tstate.params)
        want = ttrainer.tree_leaves(ttrainer.tree_map(
            lambda _, w: np.asarray(w), tstate.params, jstate.params))
        for g, w in zip(got, want):
            g = g.detach().numpy()
            if acc_dtype == "f32":
                np.testing.assert_allclose(g, w, err_msg=f"step {i}", **TOL)
                continue
            assert _rel_norm(g, w) <= 1e-4, f"step {i}"
            off = np.abs(g - w) > TOL["atol"] + TOL["rtol"] * np.abs(w)
            assert off.sum() <= 1e-5 * w.size, f"step {i}: {off.sum()}"
            assert np.all(np.abs(g - w)[off] <= 2 * tc["learning_rate"] * i)
    assert sum(kernels.launches.values()) == 0


def test_flagship_configs_match_the_jax_package():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    from _probe_common import FLAGSHIP_MODEL, FLAGSHIP_TRAIN
    mcfg, tcfg = flagship.flagship_configs()
    jcfg = jtf.TransformerConfig(**FLAGSHIP_MODEL)
    for f in dataclasses.fields(mcfg):
        if f.name != "dtype":
            assert getattr(mcfg, f.name) == getattr(jcfg, f.name), f.name
    assert mcfg.dtype == torch.bfloat16 and mcfg.head_dim == 512
    for k, v in FLAGSHIP_TRAIN.items():
        assert getattr(tcfg, k) == v, k
    assert flagship.flagship_configs(batch_size=32, grad_accum=4)[1] \
        .microbatch_size == 8
