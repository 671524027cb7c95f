"""The port's RoPE as the model calls it: `apply_rope` on the model's
(max_seq, D/2, 2) frequency table, whose cos and sin rows the kernels read
in place (views with an element stride of 2), against the JAX package's
`apply_rope` and the VJP of its `rope_pallas.rope_rotate`, run as the JAX
package's tests run them (Pallas interpret mode on the CPU), in f32 from
seeded numpy inputs. The port rounds each multiply and add on its own; XLA
on the CPU may fuse a multiply into the add, one rounding fewer, so the two
agree within an f32 ulp or two of the operands (1e-6), not bit for bit."""

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
B, S, H, D, MAX_SEQ = 2, 32, 2, 256, 96


def _randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _start(offset):
    """The JAX dynamic slice's start: a negative offset wrapped once by
    max_seq, then clamped to [0, max_seq - S]."""
    if offset < 0:
        offset += MAX_SEQ
    return max(0, min(offset, MAX_SEQ - S))


# 0, a middle offset, one past max_seq - S (clamped), a negative one that
# wraps into the clamp and one that wraps below 0.
OFFSETS = [0, 40, 90, -5, -100]


@pytest.mark.parametrize("offset", OFFSETS)
def test_apply_rope_on_the_table_matches_jax(offset):
    x = _randn(B, S, H, D, seed=abs(offset) + 7)
    want = jattn.apply_rope(jnp.asarray(x),
                            jattn.rope_frequencies(D, MAX_SEQ), offset)
    kernels.reset_launches()
    got = tattn.apply_rope(torch.from_numpy(x),
                           tattn.rope_frequencies(D, MAX_SEQ), offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sum(kernels.launches.values()) == 0


@pytest.mark.parametrize("offset", OFFSETS)
def test_apply_rope_vjp_matches_jax_rope_rotate_vjp(offset):
    """The port's VJP (the rotation by -sin, read from the same views)
    against the custom VJP of JAX `rope_pallas.rope_rotate` on the rows of
    the JAX table at the clamped offset."""
    x = _randn(B, S, H, D, seed=abs(offset) + 11)
    g = _randn(B, S, H, D, seed=abs(offset) + 12)
    start = _start(offset)
    fr = jattn.rope_frequencies(D, MAX_SEQ)[start:start + S]
    _, vjp = jax.vjp(lambda a: jrope.rope_rotate(a, fr[..., 0], fr[..., 1]),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    y = tattn.apply_rope(xt, tattn.rope_frequencies(D, MAX_SEQ), offset)
    (got,) = torch.autograd.grad(y, (xt,), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("offset", OFFSETS)
def test_tables_are_views_of_the_frequency_table(offset):
    """No copy of the table: cos and sin lie inside `freqs`, sin one float
    past cos, element stride 2: the layout the kernels read in place."""
    freqs = tattn.rope_frequencies(D, MAX_SEQ)
    cos, sin = tattn._tables(freqs, S, offset)
    lo = freqs.data_ptr()
    hi = lo + freqs.numel() * freqs.element_size()
    for t in (cos, sin):
        assert lo <= t.data_ptr() < hi
        assert t.untyped_storage().data_ptr() == freqs.untyped_storage(
        ).data_ptr()
        assert t.shape == (S, D // 2) and t.stride() == (D, 2)
    start = _start(offset)
    assert cos.data_ptr() == lo + start * D * 4
    assert sin.data_ptr() == cos.data_ptr() + 4
    # What the kernels are handed: both addresses, then each table's row and
    # element stride in floats.
    args = trope._table_args(freqs, cos, sin, S, D, "rope")
    assert args == (cos.data_ptr(), sin.data_ptr(), D, 2, D, 2)
    torch.testing.assert_close(cos, freqs[start:start + S, :, 0],
                               rtol=0, atol=0)


def test_inverse_rotation_is_the_rotation_by_minus_sin():
    """`rope_rotate_forward(..., inverse=True)`, the VJP's one call, equals
    the rotation by -sin bit for bit, on the in-place views and on
    contiguous tables alike; nothing launches on the CPU."""
    x = torch.from_numpy(_randn(B, S, H, D, seed=3))
    cos, sin = tattn._tables(tattn.rope_frequencies(D, MAX_SEQ), S, 17)
    kernels.reset_launches()
    want = trope.rope_rotate_plain(x, cos, -sin)
    assert torch.equal(trope.rope_rotate_forward(x, cos, sin, inverse=True),
                       want)
    assert torch.equal(trope.rope_rotate_forward(
        x, cos.contiguous(), sin.contiguous(), inverse=True), want)
    # A rotation and its inverse give x back to within rounding.
    back = trope.rope_rotate_forward(trope.rope_rotate_forward(x, cos, sin),
                                     cos, sin, inverse=True)
    torch.testing.assert_close(back, x, atol=1e-5, rtol=1e-5)
    assert sum(kernels.launches.values()) == 0


def test_apply_rope_t_on_the_table_matches_the_relaid_rotation():
    """The t-layout entry reads the same views: its output is
    `apply_rope`'s relaid out (B*H, S, D), bit for bit."""
    x = torch.from_numpy(_randn(B, S, H, D, seed=5))
    freqs = tattn.rope_frequencies(D, MAX_SEQ)
    got = tattn.apply_rope_t(x, freqs, 24)
    want = tattn.apply_rope(x, freqs, 24).transpose(1, 2).reshape(
        B * H, S, D)
    assert torch.equal(got, want)
