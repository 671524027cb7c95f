"""The port's (B, S, H, D) <-> (B*H, S, D) relayouts (ops/relayout.py)
against the JAX package's `to_t_layout` / `from_t_layout` and their custom
VJPs (Pallas interpret mode on the CPU), from seeded numpy inputs: a
relayout moves bits, so forward and VJP agree bit for bit in f32 and bf16.
The model's t-layout branch is shown to send v into the flat layout and
the attention output out of it through them, forward and backward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.ops import relayout as jrelayout
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels, relayout

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,d", [(2, 256, 2, 128), (1, 64, 4, 256)])
def test_relayouts_and_vjps_match_jax(dtype, b, s, h, d):
    jdt, tdt = DTYPES[dtype]
    x = _randn(b, s, h, d, seed=1)
    g = _randn(b * h, s, d, seed=2)
    jx, jg = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    want_t, vjp_t = jax.vjp(jrelayout.to_t_layout, jx)
    (want_dx,) = vjp_t(jg)
    want_f, vjp_f = jax.vjp(lambda a: jrelayout.from_t_layout(a, b, h), jg)
    (want_dg,) = vjp_f(jx)

    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tg = torch.from_numpy(g).to(tdt).requires_grad_()
    got_t = relayout.to_t_layout(tx)
    (dx,) = torch.autograd.grad(got_t, (tx,), tg.detach())
    got_f = relayout.from_t_layout(tg, b, h)
    (dg,) = torch.autograd.grad(got_f, (tg,), tx.detach())
    assert got_t.shape == (b * h, s, d) and got_f.shape == (b, s, h, d)
    assert got_t.is_contiguous() and got_f.is_contiguous()
    for got, want in ((got_t, want_t), (dx, want_dx), (got_f, want_f),
                      (dg, want_dg)):
        assert got.dtype == tdt
        np.testing.assert_array_equal(_f32(got), _f32(want))
    # The round trip, and each VJP is the other direction.
    assert torch.equal(relayout.from_t_layout(got_t, b, h), tx)
    assert torch.equal(dx, relayout.from_t_forward(tg.detach(), b, h))
    assert torch.equal(dg, relayout.to_t_forward(tx.detach()))


def test_cpu_relayouts_take_the_plain_versions_and_launch_nothing():
    kernels.reset_launches()
    x = torch.from_numpy(_randn(1, 8, 3, 24, seed=3))
    xt = relayout.to_t_forward(x)
    assert torch.equal(xt, relayout.to_t_layout_plain(x))
    assert torch.equal(relayout.from_t_forward(xt, 1, 3),
                       relayout.from_t_layout_plain(xt, 1, 3))
    assert sum(kernels.launches.values()) == 0
    with pytest.raises(ValueError):     # the CUDA-only wrapper refuses CPU
        relayout._relayout_cuda(x, 1, 3, True)


@pytest.mark.parametrize("batch", [1, 2])
def test_t_layout_branch_calls_the_relayouts(monkeypatch, batch):
    """On the t-layout path (head_dim 256, offset 0) each layer sends v
    into the flat layout and the output out of it through the relayouts;
    the backward runs each one's inverse, so each entry runs 2L times a
    loss and its gradient."""
    cfg = ttf.TransformerConfig(vocab_size=64, d_model=512, n_layers=2,
                                n_heads=2, n_kv_heads=2, d_ff=128,
                                max_seq=64, dtype=torch.float32)
    calls = {"to_t_forward": 0, "from_t_forward": 0}
    shapes = []

    def spy(name):
        real = getattr(relayout, name)

        def counted(*a):
            calls[name] += 1
            shapes.append(tuple(a[0].shape))
            return real(*a)
        monkeypatch.setattr(relayout, name, counted)
    for name in calls:
        spy(name)
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    params = {k: ({n: t.requires_grad_() for n, t in v.items()}
                  if isinstance(v, dict) else v.requires_grad_())
              for k, v in params.items()}
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, 64, (batch, 65)))
    loss, _ = ttf.loss_fn(params, toks, cfg)
    assert calls == {"to_t_forward": 2, "from_t_forward": 2}
    loss.backward()
    assert calls == {"to_t_forward": 4, "from_t_forward": 4}
    flat, model = (batch * 2, 64, 256), (batch, 64, 2, 256)
    assert sorted(set(shapes)) == sorted({flat, model})
