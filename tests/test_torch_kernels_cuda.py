"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card (Hopper: the kernels are built for
sm_90a) and skip without one. Run them on the card from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(--noconftest: the suite's conftest imports jax, which the card's machine
need not have.) Tolerances: f32 kernels differ from the plain versions only
by summation order (1e-5); bf16 outputs by at most a couple of bf16 ulps
where those f32 sums round differently (2e-2).
"""

import pytest
import torch

from k8s_gpu_workload_enhancer_tpu_torch.ops import (
    attention, flash_attention as flash, kernels, paged_attention as paged, rms,
    rope)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _randn(dev, *shape, dtype=torch.float32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(128, 2048), (8, 2048), (3, 203), (1, 8)])
def test_rms_kernel_matches_plain(dev, dtype, rows, d):
    x = _randn(dev, rows, d, dtype=dtype)
    w = 1.0 + 0.1 * _randn(dev, d, seed=1)
    before = kernels.launches["rms_norm"]
    got = rms.rms_norm(x, w)
    torch.cuda.synchronize()
    assert kernels.launches["rms_norm"] == before + 1
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got, rms.rms_norm_plain(x, w), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", [((1, 128, 4, 512), 0),
                                          ((1, 128, 4, 512), 128),
                                          ((2, 7, 3, 24), 5),
                                          ((1, 1, 2, 2), 3)])
def test_rope_kernel_matches_plain(dev, dtype, shape, offset):
    x = _randn(dev, *shape, dtype=dtype)
    freqs = attention.rope_frequencies(shape[-1], 256, device=dev)
    fr = freqs[offset:offset + shape[1]]
    c, s = fr[..., 0].contiguous(), fr[..., 1].contiguous()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(rope.rope_rotate(x, c, s),
                               rope.rope_rotate_plain(x, c, s),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kh,d,causal,q_off,kv_off", [
    (1, 128, 256, 4, 4, 512, True, 0, 0),      # serving prefill, offset 0
    (1, 128, 256, 4, 4, 512, True, 128, 0),    # chunk at offset 128
    (2, 1, 64, 4, 2, 256, True, 40, 0),        # decode row, GQA
    (2, 19, 45, 4, 2, 72, False, 0, 0),        # ragged, not causal
    (1, 16, 32, 2, 2, 64, True, 0, 40),        # every row fully masked
])
def test_flash_kernel_matches_plain(dev, dtype, b, sq, sk, h, kh, d, causal,
                                    q_off, kv_off):
    q = _randn(dev, b, sq, h, d, dtype=dtype, seed=2)
    k = _randn(dev, b, sk, kh, d, dtype=dtype, seed=3)
    v = _randn(dev, b, sk, kh, d, dtype=dtype, seed=4)
    out, lse = flash.flash_attention(q, k, v, causal, q_off, kv_off,
                                     return_lse=True)
    want, want_lse = flash.flash_attention_plain(q, k, v, causal, q_off,
                                                 kv_off, return_lse=True)
    atol, rtol = TOL[dtype]
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out, want, atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


def _paged_inputs(dev, dtype, b, h, kh, d, bl, s_max, seed=5):
    """Pages for b slots of s_max positions each, handed out in a shuffled
    order (a permuted table), plus the trash page 0; the last slot is
    parked (an all-trash row at pos s_max - 1)."""
    mb = s_max // bl
    nb = b * mb + 1
    g = torch.Generator().manual_seed(seed)
    table = (torch.randperm(nb - 1, generator=g) + 1).reshape(b, mb)
    table[-1] = 0
    pos = torch.tensor([0, 37, s_max - 1] * b, dtype=torch.int32)[:b]
    pos[-1] = s_max - 1
    q = _randn(dev, b, h, d, dtype=dtype, seed=seed)
    k = _randn(dev, nb, bl, kh, d, dtype=dtype, seed=seed + 1)
    v = _randn(dev, nb, bl, kh, d, dtype=dtype, seed=seed + 2)
    return (q, k, v, table.to(torch.int32).to(dev), pos.to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bl", [8, 16, 32])
@pytest.mark.parametrize("h,kh,d", [
    (4, 4, 512),            # the serving shape (MHA, head_dim 512)
    (4, 2, 256),            # GQA, 2 query heads per kv head
    (8, 2, 128),            # groups of 4
    (6, 2, 64),             # groups of 3 (a bound of 4 in the kernel)
    (8, 1, 96),             # groups of 8
    (16, 1, 64),            # the largest group the kernel takes
    (3, 3, 200),            # ragged head_dim
])
def test_paged_decode_kernel_matches_plain(dev, dtype, bl, h, kh, d):
    q, k, v, table, pos = _paged_inputs(dev, dtype, 4, h, kh, d, bl, 128)
    before = kernels.launches["paged_decode"]
    got = paged.paged_decode_attention(q, k, v, table, pos, block_len=bl)
    torch.cuda.synchronize()
    assert kernels.launches["paged_decode"] == before + 1
    want = paged.paged_decode_attention_plain(q, k, v, table, pos,
                                              block_len=bl)
    atol, rtol = TOL[dtype]
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


def test_kernels_raise_on_shapes_they_do_not_take(dev):
    q = _randn(dev, 1, 4, 2, 12)                    # head_dim not a multiple of 8
    with pytest.raises(ValueError):
        flash.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        rms.rms_norm(_randn(dev, 4, 8).t(), torch.ones(4, device=dev))
    with pytest.raises(TypeError):                  # f32 and bf16 only
        rms.rms_norm(_randn(dev, 4, 8, dtype=torch.float16),
                     torch.ones(8, device=dev))
    q, k, v, table, pos = _paged_inputs(dev, torch.float32, 2, 4, 2, 64, 8,
                                        32)

    def call(q=q, k=k, v=v, table=table, pos=pos):
        return paged.paged_decode_attention(q, k, v, table, pos, block_len=8)
    for bad_d in (12, 520):                         # not a multiple of 8 / > 512
        qd = _randn(dev, 2, 4, bad_d)
        kd = _randn(dev, k.shape[0], 8, 2, bad_d)
        with pytest.raises(ValueError):
            call(q=qd, k=kd, v=kd)
    with pytest.raises(ValueError):                 # kv heads do not divide H
        call(q=_randn(dev, 2, 3, 64))
    with pytest.raises(ValueError):                 # 32 query heads per kv head
        call(q=_randn(dev, 2, 64, 64))
    with pytest.raises(TypeError):                  # table must be int32
        call(table=table.long())
    with pytest.raises(TypeError):                  # f32 and bf16 only
        call(q=q.half(), k=k.half(), v=v.half())
    with pytest.raises(ValueError):                 # not contiguous
        call(q=_randn(dev, 2, 64, 4).transpose(1, 2))
