"""The port's ops (plain versions of the CUDA kernels, and the plain torch
ops around them) against the JAX package's functions on the same inputs.

The JAX side runs as its own tests run it on the CPU: the Pallas RMSNorm,
RoPE and flash kernels in interpret mode. Tolerance atol 1e-5 / rtol 1e-5
at f32 (the two differ only in summation order and transcendental
implementations); int8 quantization matches exactly except where a value
lands on a rounding tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.ops import attention as jattn
from k8s_gpu_workload_enhancer_tpu.ops import flash_attention as jflash
from k8s_gpu_workload_enhancer_tpu.ops import layers as jlayers
from k8s_gpu_workload_enhancer_tpu.ops import quant as jquant
from k8s_gpu_workload_enhancer_tpu.ops.rms_pallas import rms_norm_pallas
from k8s_gpu_workload_enhancer_tpu_torch.ops import attention as tattn
from k8s_gpu_workload_enhancer_tpu_torch.ops import flash_attention as tflash
from k8s_gpu_workload_enhancer_tpu_torch.ops import layers as tlayers
from k8s_gpu_workload_enhancer_tpu_torch.ops import quant as tquant
from k8s_gpu_workload_enhancer_tpu_torch.ops import rms as trms
from k8s_gpu_workload_enhancer_tpu_torch.ops import rope as trope

TOL = dict(atol=1e-5, rtol=1e-5)


def _randn(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("rows", [8, 128])
def test_rms_norm_matches_jax_kernel(rows):
    x = _randn(rows, 512, seed=rows)
    w = 1.0 + _randn(512, seed=1, scale=0.1)
    want = np.asarray(rms_norm_pallas(jnp.asarray(x), jnp.asarray(w)))
    got = trms.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # The layers.rms_norm entry point computes the same function.
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))), **TOL)


# The port's width (d_model 2048) and a row count of one JAX block: f32
# within TOL; bf16 (the serving and training dtype, x and out in bf16, an
# f32 weight as the trainer holds it) within one bf16 rounding (an ulp is
# at most 2^-7 of a value) of f32 sums taken in another order; and f32
# inputs that are bf16 values, within TOL.
@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16_values_f32"])
def test_rms_norm_matches_jax_kernel_at_the_port_width(mode):
    x = _randn(64, 2048, seed=7, scale=2.0)
    w = 1.0 + _randn(2048, seed=8, scale=0.1)
    tol = TOL
    if mode == "bf16":
        jx = jnp.asarray(x).astype(jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
        tol = dict(atol=1e-6, rtol=2.0 ** -7)
    else:
        if mode == "bf16_values_f32":
            x = np.array(jnp.asarray(x).astype(jnp.bfloat16)
                           .astype(jnp.float32))
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = rms_norm_pallas(jx, jnp.asarray(w))
    got = trms.rms_norm(tx, torch.from_numpy(w))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_rope_frequencies_match():
    np.testing.assert_allclose(tattn.rope_frequencies(256, 64).numpy(),
                               np.asarray(jattn.rope_frequencies(256, 64)),
                               **TOL)


@pytest.mark.parametrize("offset", [0, 16])
def test_rope_matches_jax_kernel(offset):
    x = _randn(2, 32, 2, 256, seed=offset)
    jf = jattn.rope_frequencies(256, 64)
    want = np.asarray(jattn.apply_rope(jnp.asarray(x), jf, offset))
    tf_ = tattn.rope_frequencies(256, 64)
    got = tattn.apply_rope(torch.from_numpy(x), tf_, offset)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # rope_rotate on pre-sliced tables is the same rotation.
    fr = tf_[offset:offset + 32]
    np.testing.assert_allclose(
        trope.rope_rotate(torch.from_numpy(x), fr[..., 0].contiguous(),
                          fr[..., 1].contiguous()).numpy(), want, **TOL)


@pytest.mark.parametrize("sq,sk,causal,q_off,kv_off", [
    (32, 32, True, 0, 0),
    (32, 32, False, 0, 0),
    (32, 64, True, 0, 0),       # static cache, unwritten tail masked
    (32, 64, True, 32, 0),      # second prefill chunk at offset 32
    (16, 32, True, 0, 40),      # every row fully masked -> zeros
])
def test_flash_matches_jax_kernel(sq, sk, causal, q_off, kv_off):
    q = _randn(1, sq, 2, 256, seed=1)
    k = _randn(1, sk, 2, 256, seed=2)
    v = _randn(1, sk, 2, 256, seed=3)
    want = np.asarray(jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, q_off,
        kv_off))
    got = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal, q_off, kv_off)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.isfinite(got.numpy()).all()


def test_flash_lse_matches_jax_kernel():
    q, k, v = (_randn(2, 32, 2, 256, seed=s) for s in (4, 5, 6))
    want_o, want_lse = jflash.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)
    got_o, got_lse = tflash.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), True,
        return_lse=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("sq,kh,q_off", [(1, 2, 40), (1, 1, 40), (32, 1, 0)])
def test_attention_dispatch_matches_jax(sq, kh, q_off):
    """Decode rows (Sq = 1) and GQA go through the port's flash path; the
    JAX dispatch answers them with its reference math."""
    q = _randn(2, sq, 2, 256, seed=7)
    k = _randn(2, 64, kh, 256, seed=8)
    v = _randn(2, 64, kh, 256, seed=9)
    want = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True,
                                      use_flash=True, q_offset=q_off))
    got = tattn.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, q_offset=q_off)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("sq,sk,kh,causal,q_off,kv_off", [
    (1, 64, 2, True, 40, 0),
    (1, 64, 1, True, 40, 0),
    (32, 64, 1, True, 32, 0),
    (32, 32, 2, False, 0, 0),
    (16, 48, 2, True, 20, 8),
])
def test_flash_plain_matches_jax_attention_reference(sq, sk, kh, causal,
                                                     q_off, kv_off):
    """The flash kernel's plain version is the port's one plain attention:
    it computes the JAX package's attention_reference."""
    q = _randn(2, sq, 2, 256, seed=14)
    k = _randn(2, sk, kh, 256, seed=15)
    v = _randn(2, sk, kh, 256, seed=16)
    want = np.asarray(jattn.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=q_off, kv_offset=kv_off))
    got = tflash.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, q_off, kv_off)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_swiglu_matches_jax():
    x = _randn(4, 512, seed=10)
    wg, wu = _randn(512, 1024, seed=11, scale=0.04), _randn(512, 1024,
                                                            seed=12,
                                                            scale=0.04)
    wd = _randn(1024, 512, seed=13, scale=0.03)
    want = np.asarray(jlayers.swiglu(*map(jnp.asarray, (x, wg, wu, wd))))
    got = tlayers.swiglu(*map(torch.from_numpy, (x, wg, wu, wd)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name,shape", [("wq", (2, 64, 2, 32)),
                                        ("wo", (2, 2, 32, 64)),
                                        ("w_down", (2, 128, 64)),
                                        ("lm_head", (64, 256))])
def test_quantize_int8_matches_jax(name, shape):
    w = _randn(*shape, seed=len(name), scale=0.05)
    axes = jquant._contract_axes(name, len(shape))
    assert tquant._contract_axes(name, len(shape)) == axes
    want = jquant.quantize_int8(jnp.asarray(w), axes)
    got = tquant.quantize_int8(torch.from_numpy(w), axes)
    np.testing.assert_allclose(got["scale"].numpy(),
                               np.asarray(want["scale"]), rtol=1e-7, atol=0)
    q_got, q_want = got["q8"].numpy(), np.asarray(want["q8"])
    assert q_got.dtype == q_want.dtype == np.int8
    diff = np.abs(q_got.astype(np.int32) - q_want.astype(np.int32))
    # Exact except where w / scale sits on a .5 tie, which the two
    # divisions may round to neighbouring integers.
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    np.testing.assert_allclose(
        tquant.as_compute(got, torch.float32).numpy(),
        np.asarray(jquant.as_compute(want, jnp.float32)), atol=1e-3)


def test_quantize_params_tree_matches_jax():
    tree = {"embed": _randn(32, 16, seed=1),
            "layers": {"ln1": _randn(2, 16, seed=2),
                       "wq": _randn(2, 16, 2, 8, seed=3)},
            "lm_head": _randn(16, 32, seed=4)}
    want = jquant.quantize_params({k: (jnp.asarray(v) if not isinstance(
        v, dict) else {kk: jnp.asarray(vv) for kk, vv in v.items()})
        for k, v in tree.items()})
    got = tquant.quantize_params({k: (torch.from_numpy(v) if not isinstance(
        v, dict) else {kk: torch.from_numpy(vv) for kk, vv in v.items()})
        for k, v in tree.items()})
    assert tquant.is_quantized(got["layers"]["wq"])
    assert tquant.is_quantized(got["lm_head"])
    assert not tquant.is_quantized(got["embed"])
    np.testing.assert_array_equal(got["layers"]["wq"]["q8"].numpy(),
                                  np.asarray(want["layers"]["wq"]["q8"]))
    np.testing.assert_array_equal(got["lm_head"]["q8"].numpy(),
                                  np.asarray(want["lm_head"]["q8"]))
