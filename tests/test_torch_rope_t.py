"""The port's layout-emitting RoPE (`rope_rotate_t`, VJP
`rope_rotate_t_inverse`) against the JAX package's `rope_rotate_t` and its
custom VJP, run as the JAX package's tests run them (Pallas interpret mode
on the CPU), in f32 from seeded numpy inputs. The port rounds each
multiply and add on its own (its kernel too, so that it matches this plain
version bit for bit on the card); XLA on the CPU fuses a multiply into the
add, one rounding fewer, so the two agree within an f32 ulp or two of the
operands (1e-6), not bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.ops import attention as jattn
from k8s_gpu_workload_enhancer_tpu.ops import rope_pallas as jrope
from k8s_gpu_workload_enhancer_tpu_torch.ops import attention as tattn
from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
from k8s_gpu_workload_enhancer_tpu_torch.ops import rope as trope

import torch_parity  # noqa: F401  (one intra-op thread a process)

TOL = dict(atol=1e-6, rtol=1e-6)


def _randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tables(s, d, seed):
    ang = np.outer(np.arange(s), np.random.default_rng(seed).uniform(
        0.01, 1.0, d // 2)).astype(np.float32)
    return np.cos(ang), np.sin(ang)


@pytest.mark.parametrize("b,s,h,d", [(2, 32, 3, 256), (1, 512, 2, 512),
                                     (3, 8, 1, 256)])
def test_rope_rotate_t_and_vjp_match_jax(b, s, h, d):
    x = _randn(b, s, h, d, seed=s)
    g = _randn(b * h, s, d, seed=s + 1)
    cos, sin = _tables(s, d, seed=d)
    want, vjp = jax.vjp(lambda a: jrope.rope_rotate_t(
        a, jnp.asarray(cos), jnp.asarray(sin)), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = trope.rope_rotate_t(xt, torch.from_numpy(cos),
                              torch.from_numpy(sin))
    assert got.shape == (b * h, s, d)
    (dx,) = torch.autograd.grad(got, (xt,), torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **TOL)
    # The VJP's entry on its own, and the t-layout pair against the 4-D
    # rotation it relays out.
    np.testing.assert_array_equal(
        trope.rope_rotate_t_inverse(torch.from_numpy(g), torch.from_numpy(cos),
                                    torch.from_numpy(sin), h).numpy(),
        dx.numpy())
    np.testing.assert_array_equal(
        got.detach().numpy(),
        trope.rope_rotate_plain(torch.from_numpy(x), torch.from_numpy(cos),
                                torch.from_numpy(sin)).permute(0, 2, 1, 3)
        .reshape(b * h, s, d).numpy())
    assert sum(kernels.launches.values()) == 0


def test_apply_rope_t_matches_jax():
    b, s, h, d = 2, 16, 2, 256
    x = _randn(b, s, h, d, seed=3)
    want = jattn.apply_rope_t(jnp.asarray(x),
                              jattn.rope_frequencies(d, 64, 10000.0))
    got = tattn.apply_rope_t(torch.from_numpy(x),
                             tattn.rope_frequencies(d, 64, 10000.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 32, 2, 256), (1, 512, 4, 512),
                                   (1, 768, 1, 256), (1, 4, 2, 256),
                                   (1, 640, 2, 256), (2, 32, 2, 128),
                                   (2, 32, 2, 384), (32, 2, 256)])
def test_rope_supported_matches_jax(shape):
    want = jrope.rope_supported(jax.ShapeDtypeStruct(shape, jnp.float32))
    assert trope.rope_supported(torch.empty(shape)) == want
