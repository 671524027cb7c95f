"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card (Hopper: the kernels are built for
sm_90a) and skip without one. Run them on the card from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(--noconftest: the suite's conftest imports jax, which the card's machine
need not have.) Tolerances: f32 forward kernels differ from the plain
versions only by summation order (1e-5); bf16 forward outputs by at most a
couple of bf16 ulps where those f32 sums round differently (2e-2). The
backward kernels are held to limits scaled to each output's own values
(`_assert_bwd_close`).
"""

import pytest
import torch

from k8s_gpu_workload_enhancer_tpu_torch.ops import (
    attention, embed, flash_attention as flash, fused_ce, kernels,
    paged_attention as paged, relayout, rms, rope)

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
    (2, 100, 100, 4, 2, 64, True, 0, 0),       # Sq 100: both tile tails, GQA
    (1, 2048, 2048, 2, 2, 128, True, 0, 0),    # the trainer's head_dim, long
    (1, 100, 237, 4, 2, 128, True, 37, 0),     # offset 37 across a tile edge
    (1, 100, 300, 2, 1, 128, True, 128, 0),    # offset 128, GQA 2:1
    (1, 100, 64, 2, 1, 128, True, 0, 50),      # rows 0-49 fully masked
    (1, 100, 237, 4, 2, 256, True, 37, 0),     # head_dim 256
    (2, 1, 300, 4, 2, 512, True, 299, 0),      # one query row at 512
    (1, 2048, 2048, 1, 1, 512, True, 0, 0),    # the flagship's flat head
    (1, 100, 180, 2, 2, 512, False, 0, 0),     # 512, not causal, ragged
    (1, 16, 64, 2, 2, 512, True, 0, 40),       # 512, every row masked
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


@pytest.mark.parametrize("dtype,body", [(torch.bfloat16, 1),
                                        (torch.float32, 0)])
def test_flash_bf16_runs_the_wgmma_body(dev, dtype, body):
    q = _randn(dev, 1, 64, 2, 128, dtype=dtype, seed=2)
    k = _randn(dev, 1, 64, 2, 128, dtype=dtype, seed=3)
    before = dict(kernels.launches)
    flash.flash_attention(q, k, k)
    torch.cuda.synchronize()
    assert (kernels.launches[flash.KERNEL]
            == before.get(flash.KERNEL, 0) + 1)
    assert (kernels.launches[flash.KERNEL_WGMMA]
            == before.get(flash.KERNEL_WGMMA, 0) + body)


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


# ---------------------------------------------------------------------------
# Backward kernels (training). Each output is held to a limit scaled to its
# own values: rtol one bf16 rounding (an ulp is at most 2^-7 of a value) of
# f32 sums taken in another order than the plain version's, or in f32 those
# sums themselves; atol a fraction of the output's root mean square, for
# entries near zero where cancellation decides the last bits.
# ---------------------------------------------------------------------------

BWD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
BWD_ATOL_OF_RMS = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


def _assert_bwd_close(got, want, msg=None):
    rms_w = (float(torch.linalg.vector_norm(want, dtype=torch.float32))
             / max(1, want.numel()) ** 0.5)
    torch.testing.assert_close(got, want,
                               atol=BWD_ATOL_OF_RMS[want.dtype] * rms_w,
                               rtol=BWD_RTOL[want.dtype], msg=msg)


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(128, 2048), (600, 2048), (3, 203),
                                    (1, 8), (1000, 1024)])
def test_rms_backward_kernel_matches_plain(dev, dtype, w_dtype, rows, d):
    x = _randn(dev, rows, d, dtype=dtype)
    w = (1.0 + 0.1 * _randn(dev, d, seed=1)).to(w_dtype)
    dy = _randn(dev, rows, d, dtype=dtype, seed=2)
    before = kernels.launches["rms_norm_bwd"]
    dx, dw = rms.rms_norm_backward(x, w, dy)
    torch.cuda.synchronize()
    assert kernels.launches["rms_norm_bwd"] == before + 1
    assert dx.dtype == dtype and dw.dtype == w_dtype
    want_dx, want_dw = rms.rms_norm_backward_plain(x, w, dy)
    _assert_bwd_close(dx, want_dx)
    _assert_bwd_close(dw, want_dw)
    # dw's cross-row sum runs in a fixed order: bitwise the same each time.
    assert torch.equal(rms.rms_norm_backward(x, w, dy)[1], dw)


def test_rms_autograd_on_the_card_launches_both_kernels(dev):
    x = _randn(dev, 4, 16, 256, dtype=torch.bfloat16).requires_grad_()
    w = (1.0 + 0.1 * _randn(dev, 256, seed=1)).requires_grad_()
    g = _randn(dev, 4, 16, 256, dtype=torch.bfloat16, seed=2)
    kernels.reset_launches()
    dx, dw = torch.autograd.grad(rms.rms_norm(x, w), (x, w), g)
    assert dict(kernels.launches) == {"rms_norm": 1, "rms_norm_bwd": 1}
    want_dx, want_dw = rms.rms_norm_backward_plain(x.detach(), w.detach(), g)
    _assert_bwd_close(dx, want_dx)
    _assert_bwd_close(dw, want_dw)


# Every layout the RMSNorm launchers choose (csrc/rms.cu): widths from a
# warp of rows a block (256) to the backward's widest (8192 bf16), f32,
# the trainer's rows and counts that leave the last block or row group
# part empty, the serving weights in bf16, the ragged one-element path.
_RMS_LAYOUTS = [
    # (x dtype, w dtype, rows, d)
    (torch.bfloat16, torch.float32, 64, 1024),
    (torch.bfloat16, torch.float32, 64, 2048),
    (torch.bfloat16, torch.float32, 64, 4096),
    (torch.bfloat16, torch.float32, 64, 8192),
    (torch.float32, torch.float32, 64, 4096),
    (torch.bfloat16, torch.float32, 1, 2048),
    (torch.bfloat16, torch.float32, 7, 2048),
    (torch.bfloat16, torch.float32, 33, 2048),
    (torch.bfloat16, torch.float32, 600, 2048),
    (torch.bfloat16, torch.float32, 16384, 2048),
    (torch.float32, torch.float32, 1024, 2048),
    (torch.bfloat16, torch.bfloat16, 8, 2048),
    (torch.bfloat16, torch.bfloat16, 128, 2048),
    (torch.bfloat16, torch.float32, 7, 256),
    (torch.bfloat16, torch.float32, 1001, 256),
    (torch.bfloat16, torch.float32, 33, 512),
    (torch.bfloat16, torch.float32, 3, 203),
    (torch.float32, torch.float32, 3, 203),
]


@pytest.mark.parametrize("dtype,w_dtype,rows,d", _RMS_LAYOUTS)
def test_rms_kernels_match_plain_at_every_layout(dev, dtype, w_dtype, rows,
                                                 d):
    x = _randn(dev, rows, d, dtype=dtype)
    w = (1.0 + 0.1 * _randn(dev, d, seed=1)).to(w_dtype)
    dy = _randn(dev, rows, d, dtype=dtype, seed=2)
    kernels.reset_launches()
    got = rms.rms_norm(x, w)
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {"rms_norm": 1}
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got, rms.rms_norm_plain(x, w), atol=atol,
                               rtol=rtol)
    dx, dw = rms.rms_norm_backward(x, w, dy)
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {"rms_norm": 1, "rms_norm_bwd": 1}
    want_dx, want_dw = rms.rms_norm_backward_plain(x, w, dy)
    _assert_bwd_close(dx, want_dx)
    _assert_bwd_close(dw, want_dw)
    assert torch.equal(rms.rms_norm_backward(x, w, dy)[1], dw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_kernels_take_a_weight_off_16_byte_alignment(dev, dtype):
    # A weight 4 bytes into its storage goes to the one-element instances.
    d = 1024
    store = 1.0 + 0.1 * _randn(dev, d + 1, seed=1)
    w = store[1:]
    assert w.data_ptr() % 16 and w.is_contiguous()
    x = _randn(dev, 40, d, dtype=dtype)
    dy = _randn(dev, 40, d, dtype=dtype, seed=2)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(rms.rms_norm(x, w), rms.rms_norm_plain(x, w),
                               atol=atol, rtol=rtol)
    dx, dw = rms.rms_norm_backward(x, w, dy)
    want_dx, want_dw = rms.rms_norm_backward_plain(x, w, dy)
    _assert_bwd_close(dx, want_dx)
    _assert_bwd_close(dw, want_dw)
    assert torch.equal(rms.rms_norm_backward(x, w, dy)[1], dw)


def test_rms_kernels_raise_past_their_widest_rows(dev):
    # The forward takes 2048 vectors a row, the backward 1024; the
    # one-element instances as many columns.
    for d, dtype in ((16392, torch.bfloat16), (2049, torch.float32)):
        with pytest.raises(ValueError):
            rms.rms_norm(_randn(dev, 2, d, dtype=dtype),
                         torch.ones(d, device=dev))
    for d, dtype in ((8200, torch.bfloat16), (4100, torch.float32)):
        x = _randn(dev, 2, d, dtype=dtype)
        with pytest.raises(ValueError):
            rms.rms_norm_backward(x, torch.ones(d, device=dev), x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_vjp_is_the_inverse_rotation(dev, dtype):
    x = _randn(dev, 2, 64, 4, 128, dtype=dtype).requires_grad_()
    g = _randn(dev, 2, 64, 4, 128, dtype=dtype, seed=1)
    fr = attention.rope_frequencies(128, 64, device=dev)
    c, s = fr[..., 0].contiguous(), fr[..., 1].contiguous()
    kernels.reset_launches()
    (dx,) = torch.autograd.grad(rope.rope_rotate(x, c, s), (x,), g)
    assert kernels.launches["rope"] == 2
    _assert_bwd_close(dx, rope.rope_rotate_plain(g, c, -s))


@pytest.mark.parametrize("stash", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,d,causal,q_off,kv_off", [
    (1, 256, 256, 2, 128, True, 0, 0),       # the training layout, D 128
    (2, 100, 100, 3, 64, True, 0, 0),        # ragged tiles, D 64
    (1, 77, 77, 2, 256, True, 0, 0),         # D 256
    (1, 70, 70, 2, 96, False, 0, 0),         # not causal, D 96 (< its bound)
    (2, 16, 48, 2, 64, True, 32, 0),         # queries at an offset
    (1, 16, 32, 2, 64, True, 0, 40),         # every row fully masked
    (1, 64, 64, 2, 512, True, 0, 0),         # the flagship's head_dim 512
    (2, 37, 37, 1, 512, True, 0, 0),         # D 512, ragged tiles
    (1, 40, 40, 2, 264, False, 0, 0),        # D 264 (< 512), not causal
    (2, 90, 90, 2, 72, True, 0, 0),          # D 72: columns 72-127 zero-filled
    (1, 2048, 2048, 4, 128, True, 0, 0),     # many tiles of both sides
    (1, 96, 300, 2, 128, True, 0, 17),       # Sq 96 against Sk 300, kv_offset 17
    (1, 200, 200, 2, 128, True, 0, 0),       # Sq 200: ragged 64-row tiles
    (2, 256, 256, 1, 512, True, 0, 0),       # D 512, several tiles of both sides
    (1, 200, 300, 1, 512, True, 0, 17),      # D 512, Sk 300 (not a multiple of 8)
    (1, 136, 136, 2, 264, True, 0, 0),       # D 264: three 128-column slices
])
def test_flash_backward_kernels_match_plain(dev, monkeypatch, stash, dtype, b,
                                            sq, sk, h, d, causal, q_off,
                                            kv_off):
    q = _randn(dev, b, sq, h, d, dtype=dtype, seed=2)
    k = _randn(dev, b, sk, h, d, dtype=dtype, seed=3)
    v = _randn(dev, b, sk, h, d, dtype=dtype, seed=4)
    do = _randn(dev, b, sq, h, d, dtype=dtype, seed=5)
    o, lse = flash.flash_attention(q, k, v, causal, q_off, kv_off,
                                   return_lse=True)
    monkeypatch.setattr(flash, "PDS_STASH_LIMIT_BYTES",
                        int(1.2e9) if stash else 0)
    kernels.reset_launches()
    got = flash.flash_attention_backward(q, k, v, o, lse, do, causal, q_off,
                                         kv_off)
    torch.cuda.synchronize()
    dkv = ("flash_attention_bwd_dkv_stash" if stash
           else "flash_attention_bwd_dkv")
    want_launches = {"flash_attention_bwd_dq": 1, dkv: 1}
    if dtype == torch.bfloat16:                  # the tensor-core bodies
        want_launches[flash.KERNEL_BWD_DQ_WGMMA] = 1
        if stash:
            want_launches[flash.KERNEL_BWD_DKV_STASH_WGMMA] = 1
        elif d <= 128:
            want_launches[flash.KERNEL_BWD_DKV_WGMMA] = 1
    assert dict(kernels.launches) == want_launches
    want = flash.flash_attention_backward_plain(q, k, v, o, lse, do, causal,
                                                q_off, kv_off)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and torch.isfinite(g.float()).all(), name
        _assert_bwd_close(g, w, msg=name)


@pytest.mark.parametrize("d", [128, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_flash_backward_kernel_matches_its_plain_version(dev, dtype, d):
    """dQ with its p/ds stash, dK/dV from that stash, and the recompute
    dK/dV, each against its own plain version, at the training layouts
    (head_dim 128, and the flagship's 512) with a ragged last tile."""
    q, k, v, do = (_randn(dev, 2, 200, 2, d, dtype=dtype, seed=10 + i)
                   for i in range(4))
    o, lse = flash.flash_attention(q, k, v, True, return_lse=True)
    args = (q, k, v, do, lse, flash.backward_delta(o, do))
    got = flash.flash_bwd_dq(*args, stash=True)
    want = flash.flash_bwd_dq_plain(*args, stash=True)
    for name, g, w in zip(("dq", "p_stash", "ds_stash"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _assert_bwd_close(g, w, msg=name)
    for name, g, w in zip(
            ("dk", "dv"), flash.flash_bwd_dkv_from_stash(q, k, v, do, *got[1:]),
            flash.flash_bwd_dkv_from_stash_plain(q, k, v, do, *got[1:])):
        _assert_bwd_close(g, w, msg=f"stash {name}")
    for name, g, w in zip(("dk", "dv"), flash.flash_bwd_dkv(*args),
                          flash.flash_bwd_dkv_plain(*args)):
        _assert_bwd_close(g, w, msg=f"recompute {name}")


@pytest.mark.parametrize("stash", [True, False])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.bfloat16, 512),
                                     (torch.float32, 128)])
def test_flash_backward_bf16_runs_the_wgmma_bodies(dev, monkeypatch, stash,
                                                   dtype, d):
    """bf16 dQ and the stash dK/dV run tensor-core bodies at every head_dim,
    the recompute dK/dV at head_dim <= 128, and the library's body query
    says so, instance included; f32, and the recompute dK/dV at head_dim
    512, keep the f32-pipe bodies."""
    q, k, v, do = (_randn(dev, 1, 64, 2, d, dtype=dtype, seed=20 + i)
                   for i in range(4))
    o, lse = flash.flash_attention(q, k, v, True, return_lse=True)
    monkeypatch.setattr(flash, "PDS_STASH_LIMIT_BYTES",
                        int(1.2e9) if stash else 0)
    bf16 = int(dtype == torch.bfloat16)
    wgmma = {flash.KERNEL_BWD_DQ: bf16,
             flash.KERNEL_BWD_DKV: bf16 * int(d <= 128),
             flash.KERNEL_BWD_DKV_STASH: bf16}
    before = dict(kernels.launches)
    flash.flash_attention_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()

    def rise(name):
        return kernels.launches[name] - before.get(name, 0)
    assert rise(flash.KERNEL_BWD_DQ) == 1
    assert rise(flash.KERNEL_BWD_DQ_WGMMA) == wgmma[flash.KERNEL_BWD_DQ]
    assert rise(flash.KERNEL_BWD_DKV) == int(not stash)
    assert rise(flash.KERNEL_BWD_DKV_WGMMA) \
        == wgmma[flash.KERNEL_BWD_DKV] * int(not stash)
    assert rise(flash.KERNEL_BWD_DKV_STASH) == int(stash)
    assert rise(flash.KERNEL_BWD_DKV_STASH_WGMMA) \
        == wgmma[flash.KERNEL_BWD_DKV_STASH] * int(stash)
    f32_bound = next(b for b in (64, 128, 256, 512) if d <= b)
    for kernel, on in wgmma.items():
        body = flash.bwd_body(kernel, d, dtype)
        assert body["body"] == ("wgmma" if on else "f32 pipes"), kernel
        bound = (f32_bound if not on else 128
                 if kernel != flash.KERNEL_BWD_DKV_STASH and d <= 128 else 512)
        assert body["instance"] == f"d<={bound}", kernel
        assert body["dynamic_smem_bytes"] > 0, kernel


@pytest.mark.parametrize("d", [128, 512])
def test_flash_dq_stash_holds_zeros_past_the_diagonal(dev, d):
    """The tensor-core dQ bodies (head_dim 128 and 512) write the whole p/ds
    stash: the plain version's values bit for bit in the causal range (P
    and dS round as the plain version's in-order sums make them round) and
    exact zeros in every tile past it up to Sk, over memory that held NaNs
    before."""
    b, sq, sk, h = 1, 200, 260, 2
    q, do = (_randn(dev, b, sq, h, d, dtype=torch.bfloat16, seed=30 + i)
             for i in range(2))
    k, v = (_randn(dev, b, sk, h, d, dtype=torch.bfloat16, seed=32 + i)
            for i in range(2))
    o, lse = flash.flash_attention(q, k, v, True, return_lse=True)
    args = (q, k, v, do, lse, flash.backward_delta(o, do))
    garbage = torch.full((2, b * h, sq, sk), float("nan"),
                         dtype=torch.bfloat16, device=dev)
    del garbage       # the caching allocator hands this memory out next
    dq, p_st, ds_st = flash.flash_bwd_dq(*args, stash=True)
    want_dq, want_p, want_ds = flash.flash_bwd_dq_plain(*args, stash=True)
    past = (torch.arange(sk, device=dev)[None, :]
            > torch.arange(sq, device=dev)[:, None])
    for name, g, w in (("p_stash", p_st, want_p), ("ds_stash", ds_st, want_ds)):
        assert torch.isfinite(g.float()).all(), name
        assert bool((g[:, past] == 0).all()), name
        assert torch.equal(g, w), name
    _assert_bwd_close(dq, want_dq, msg="dq")


def test_flash_train_on_the_card_matches_plain_with_gqa(dev):
    """The differentiable entry expands GQA before the kernels; autograd
    sums the copies' gradients back onto the kv heads."""
    q = _randn(dev, 2, 64, 4, 64, seed=6).requires_grad_()
    k = _randn(dev, 2, 64, 2, 64, seed=7).requires_grad_()
    v = _randn(dev, 2, 64, 2, 64, seed=8).requires_grad_()
    g = _randn(dev, 2, 64, 4, 64, seed=9)
    kernels.reset_launches()
    got = torch.autograd.grad(flash.flash_attention_train(q, k, v), (q, k, v),
                              g)
    assert kernels.launches["flash_attention"] == 1
    assert kernels.launches["flash_attention_bwd_dq"] == 1
    qc, kc, vc = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(flash.flash_attention_train(qc, kc, vc),
                               (qc, kc, vc), g.cpu())
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.cpu(), w, atol=1e-4, rtol=1e-4, msg=name)


def test_train_step_on_the_card_matches_the_cpu(dev):
    """Loss and every gradient leaf of a small f32 model: the kernels on
    the card against the plain versions on the CPU, same weights."""
    from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as tf
    from k8s_gpu_workload_enhancer_tpu_torch.train import trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tf.TransformerConfig(vocab_size=320, d_model=256, n_layers=2,
                               n_heads=2, n_kv_heads=2, d_ff=512, max_seq=64,
                               dtype=torch.float32, ce_chunk=128)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, 320, (2, 65),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for where in ("cpu", "cuda"):
        p = trainer.tree_map(
            lambda t: t.detach().to(where).requires_grad_(), params)
        kernels.reset_launches()
        loss, _ = tf.loss_fn(p, toks.to(where), cfg)
        grads = torch.autograd.grad(loss, trainer.tree_leaves(p))
        out[where] = (loss.item(), [g.cpu() for g in grads],
                      dict(kernels.launches))
    assert out["cpu"][2] == {}
    assert out["cuda"][2] == {"embed_gather": 1, "rms_norm": 5,
                              "rms_norm_bwd": 5, "rope": 8,
                              "flash_attention": 2,
                              "flash_attention_bwd_dq": 2,
                              "flash_attention_bwd_dkv_stash": 2}
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for a, w in zip(out["cuda"][1], out["cpu"][1]):
        assert float((a - w).norm() / w.norm().clamp_min(1e-12)) < 1e-4


def test_backward_kernels_raise_on_inputs_they_do_not_take(dev):
    q = _randn(dev, 1, 16, 4, 64)
    kv = _randn(dev, 1, 16, 2, 64)                  # GQA: expand first
    o, lse = flash.flash_attention(q, q, q, True, return_lse=True)
    with pytest.raises(ValueError):
        flash.flash_attention_backward(q, kv, kv, o, lse, q)
    q5 = _randn(dev, 1, 16, 1, 520)                 # head_dim above 512
    lse5 = torch.zeros((1, 1, 16), device=dev)
    with pytest.raises(ValueError):
        flash.flash_attention_backward(q5, q5, q5, q5, lse5, q5)
    with pytest.raises(TypeError):                  # dO in another dtype
        flash.flash_attention_backward(q, q, q, o, lse, q.bfloat16())
    with pytest.raises(ValueError):                 # wider than the kernel
        x = _randn(dev, 2, 1025)
        rms.rms_norm_backward(x, torch.ones(1025, device=dev), x)


def test_fused_ce_runs_on_the_card(dev):
    """ce_fused with ce_cache_logits takes the fused CE kernels on the card
    (the model's shape gate holds at N 8, D 128, V 256) and agrees with the
    chunked op."""
    import dataclasses
    from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as tf
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tf.TransformerConfig(vocab_size=256, d_model=128, n_layers=1,
                               n_heads=1, n_kv_heads=1, d_ff=256, max_seq=16,
                               dtype=torch.float32, ce_cache_logits=True)
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    toks = torch.randint(0, 256, (1, 9), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    kernels.reset_launches()
    loss, _ = tf.loss_fn(params, toks, cfg)
    assert kernels.launches["fused_ce_fwd"] == 1
    assert kernels.launches["fused_ce_fwd_wgmma"] == 0     # f32: the f32 pipes
    chunked, _ = tf.loss_fn(params, toks, dataclasses.replace(cfg,
                                                              ce_fused=False))
    assert torch.isfinite(loss)
    assert loss.item() == pytest.approx(chunked.item(), rel=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 4, 512), (1, 7, 3, 24),
                                   (3, 5, 2, 2)])
def test_rope_t_kernels_match_plain(dev, dtype, shape):
    """The t-layout rotation and its inverse, bit for bit (both round every
    multiply and add on its own)."""
    b, s, h, d = shape
    x = _randn(dev, *shape, dtype=dtype)
    g = _randn(dev, b * h, s, d, dtype=dtype, seed=1)
    fr = attention.rope_frequencies(d, s + 3, device=dev)[3:]
    c, sn = fr[..., 0].contiguous(), fr[..., 1].contiguous()
    kernels.reset_launches()
    got = rope.rope_rotate_t_forward(x, c, sn)
    back = rope.rope_rotate_t_inverse(g, c, sn, h)
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {"rope_t": 1, "rope_t_inv": 1}
    assert torch.equal(got, rope.rope_rotate_t_plain(x, c, sn))
    assert torch.equal(back, rope.rope_rotate_t_inv_plain(g, c, sn, h))
    # Through autograd: the VJP is the inverse kernel.
    xr = x.detach().requires_grad_()
    (dx,) = torch.autograd.grad(rope.rope_rotate_t(xr, c, sn), (xr,), g)
    assert torch.equal(dx, back)


def _ce_inputs(dev, dtype, n, d, v, seed=0):
    h2 = _randn(dev, n, d, dtype=dtype, seed=seed)
    head = (0.05 * _randn(dev, d, v, seed=seed + 1)).to(dtype)
    t1 = torch.randint(0, v, (n,), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(seed))
    t1[0], t1[-1] = 0, v - 1
    return h2, head, t1


def _assert_within_ulp(got, want, msg):
    """bf16 values at most one bf16 ulp (2^-7 of the value) apart, with the
    backward limits' floor (1e-3 of want's root mean square) for entries
    near zero, where two f32 sums' order decides more than an ulp."""
    g, w = got.float(), want.float()
    floor = BWD_ATOL_OF_RMS[torch.bfloat16] * float(w.norm()) / w.numel() ** 0.5
    assert bool(((g - w).abs() <= w.abs() / 128 + floor).all()), msg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,v", [
    (256, 512, 1024), (300, 128, 264),
    (8, 256, 8),                    # N < 64: one consumer's rows all past N
    (1024, 2048, 4096),
    (2048, 2048, 32768),            # the flagship's widths
    (300, 2048, 264)])              # ragged N and V at the full D
def test_fused_ce_kernels_match_plain(dev, dtype, n, d, v):
    """Forward: lse and gold within 1e-3 relative in bf16 (the tensor
    cores sum in another order) or 1e-5 in f32, the stash within one bf16
    ulp. Backward from the plain version's stash: dlg within one ulp, dH
    to the backward limits scaled to its root mean square. Every bf16 call
    runs the wgmma body, no f32 call does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    h2, head, t1 = _ce_inputs(dev, dtype, n, d, v)
    wgmma = int(dtype == torch.bfloat16)
    assert fused_ce.ce_body(dtype) == ("wgmma" if wgmma else "f32 pipes")
    kernels.reset_launches()
    lse, gold, stash = fused_ce.fused_ce_forward(h2, head, t1)
    torch.cuda.synchronize()
    assert dict(kernels.launches) == (
        {"fused_ce_fwd": 1, "fused_ce_fwd_wgmma": 1} if wgmma
        else {"fused_ce_fwd": 1})
    w_lse, w_gold, w_stash = fused_ce.fused_ce_forward_plain(h2, head, t1)
    rtol = 1e-3 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(lse, w_lse, rtol=rtol, atol=rtol)
    torch.testing.assert_close(gold, w_gold, rtol=rtol, atol=rtol)
    _assert_within_ulp(stash, w_stash, "stash")
    scale = torch.tensor([0.5 / n], device=dev)
    dlg, dh = fused_ce.fused_ce_backward(w_stash, head, w_lse, t1, scale)
    torch.cuda.synchronize()
    assert kernels.launches["fused_ce_bwd"] == 1
    assert kernels.launches["fused_ce_bwd_wgmma"] == wgmma
    for kernel in (fused_ce.KERNEL_FWD, fused_ce.KERNEL_BWD):
        assert fused_ce.body_report(kernel, dtype)["body"] == \
            fused_ce.ce_body(dtype)
    w_dlg, w_dh = fused_ce.fused_ce_backward_plain(w_stash, head, w_lse, t1,
                                                   scale)
    _assert_within_ulp(dlg, w_dlg, "dlg")
    rms_w = float(w_dh.float().norm()) / w_dh.numel() ** 0.5
    torch.testing.assert_close(dh.float(), w_dh.float(),
                               atol=BWD_ATOL_OF_RMS[torch.bfloat16] * rms_w,
                               rtol=BWD_RTOL[torch.bfloat16])


def test_fused_ce_kernels_raise_on_inputs_they_do_not_take(dev):
    h2, head, t1 = _ce_inputs(dev, torch.bfloat16, 16, 128, 64)
    with pytest.raises(ValueError):                 # D not a multiple of 128
        fused_ce.fused_ce_forward(h2[:, :96].contiguous(),
                                  head[:96].contiguous(), t1)
    with pytest.raises(TypeError):                  # head in another dtype
        fused_ce.fused_ce_forward(h2, head.float(), t1)
    with pytest.raises(ValueError):                 # V not a multiple of 8
        fused_ce.fused_ce_forward(h2, head[:, :60].contiguous(), t1)


def test_flagship_layout_train_step_on_the_card_matches_the_cpu(dev):
    """A small f32 model on the flagship's paths (t-layout RoPE and flash
    at head_dim 256, fused CE): loss and every gradient leaf, the kernels
    on the card against the plain versions on the CPU."""
    from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as tf
    from k8s_gpu_workload_enhancer_tpu_torch.train import trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tf.TransformerConfig(vocab_size=512, d_model=512, n_layers=2,
                               n_heads=2, n_kv_heads=2, d_ff=1024, max_seq=64,
                               dtype=torch.float32, ce_chunk=512,
                               ce_cache_logits=True)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, 512, (2, 65),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for where in ("cpu", "cuda"):
        p = trainer.tree_map(
            lambda t: t.detach().to(where).requires_grad_(), params)
        kernels.reset_launches()
        loss, _ = tf.loss_fn(p, toks.to(where), cfg)
        grads = torch.autograd.grad(loss, trainer.tree_leaves(p))
        out[where] = (loss.item(), [g.cpu() for g in grads],
                      dict(kernels.launches))
    assert out["cpu"][2] == {}
    assert out["cuda"][2] == {"embed_gather": 1, "rms_norm": 5,
                              "rms_norm_bwd": 5, "rope_t": 4,
                              "rope_t_inv": 4, "relayout_to_t": 4,
                              "relayout_from_t": 4, "flash_attention": 2,
                              "flash_attention_bwd_dq": 2,
                              "flash_attention_bwd_dkv_stash": 2,
                              "fused_ce_fwd": 1, "fused_ce_bwd": 1}
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for a, w in zip(out["cuda"][1], out["cpu"][1]):
        assert float((a - w).norm() / w.norm().clamp_min(1e-12)) < 1e-3


# ---------------------------------------------------------------------------
# The embedding gather and the relayouts: both move or scale bits exactly,
# so each kernel equals its plain version bit for bit.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("round_rows", [False, True])
@pytest.mark.parametrize("table_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("v,d,ids_shape", [
    (32768, 2048, (8,)),                # a decode step
    (32768, 2048, (1, 128)),            # a prefill chunk
    (32768, 2048, (8, 2048)),           # a flagship microbatch
    (300, 203, (3, 17)),                # a ragged width (scalar path)
])
def test_embed_kernel_matches_plain(dev, round_rows, table_dtype, out_dtype,
                                    v, d, ids_shape):
    table = (0.02 * _randn(dev, v, d)).to(table_dtype)
    g = torch.Generator(device=dev).manual_seed(3)
    for id_dtype in (torch.int32, torch.int64):
        ids = torch.randint(0, v, ids_shape, device=dev, generator=g,
                            dtype=id_dtype)
        ids.view(-1)[:4] = torch.tensor([0, v - 1, 0, v - 1], device=dev)
        kernels.reset_launches()
        got = embed.embed_gather(table, ids, 45.25, out_dtype, round_rows)
        torch.cuda.synchronize()
        assert dict(kernels.launches) == {"embed_gather": 1}
        assert got.shape == (*ids_shape, d) and got.dtype == out_dtype
        assert torch.equal(got, embed.embed_gather_plain(
            table, ids, 45.25, out_dtype, round_rows))


def test_embed_kernel_reads_strided_and_wild_ids(dev):
    """tokens[:, :-1] through its strides, and ids out of range clamped
    like the JAX model's gather."""
    v, d = 64, 256
    table = _randn(dev, v, d)
    toks = torch.randint(0, v, (4, 33), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
    view = toks[:, :-1]
    assert not view.is_contiguous()
    got = embed.embed_tokens(table, view, 2048, torch.bfloat16)
    assert torch.equal(got, embed.embed_gather_plain(
        table, view, embed.embed_scale(2048, torch.bfloat16),
        torch.bfloat16, True))
    wild = torch.tensor([[0, v - 1, v, v + 5, -1, -v, -v - 3, 2 * v]],
                        device=dev)
    assert torch.equal(embed.embed_gather(table, wild, 0.5, torch.float32),
                       embed.embed_gather_plain(table, wild, 0.5,
                                                torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embed_autograd_on_the_card_matches_the_cpu(dev, dtype):
    """The model's embedding and `embed_lookup`: forward bit for bit and
    the VJP (plain torch) against the same ops on the CPU."""
    v, d = 64, 512
    table = _randn(dev, v, d).requires_grad_()
    ids = torch.randint(0, v, (2, 16), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))
    gy = _randn(dev, 2, 16, d, seed=6).to(dtype)
    tc = table.detach().cpu().requires_grad_()
    for fn in (lambda t, i: embed.embed_tokens(t, i, 2048, dtype),
               lambda t, i: embed.embed_lookup(t, i, 1.5, dtype)):
        kernels.reset_launches()
        y = fn(table, ids)
        (dt,) = torch.autograd.grad(y, (table,), gy)
        assert dict(kernels.launches) == {"embed_gather": 1}
        yc = fn(tc, ids.cpu())
        (dtc,) = torch.autograd.grad(yc, (tc,), gy.cpu())
        assert torch.equal(y.cpu(), yc)
        # Repeated ids' sums in another order: the backward limits of the
        # compute dtype.
        rms_w = float(dtc.norm()) / dtc.numel() ** 0.5
        torch.testing.assert_close(dt.cpu(), dtc,
                                   atol=BWD_ATOL_OF_RMS[dtype] * rms_w,
                                   rtol=BWD_RTOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 2048, 4, 512), (1, 512, 4, 512),
                                   (3, 5, 2, 24), (2, 7, 3, 13)])
def test_relayout_kernels_match_plain(dev, dtype, shape):
    b, s, h, d = shape
    x = _randn(dev, *shape, dtype=dtype)
    g = _randn(dev, b * h, s, d, dtype=dtype, seed=1)
    kernels.reset_launches()
    xt = relayout.to_t_forward(x)
    gb = relayout.from_t_forward(g, b, h)
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {"relayout_to_t": 1,
                                      "relayout_from_t": 1}
    assert torch.equal(xt, relayout.to_t_layout_plain(x))
    assert torch.equal(gb, relayout.from_t_layout_plain(g, b, h))
    # Through autograd: each VJP is the other kernel.
    xr, gr = x.detach().requires_grad_(), g.detach().requires_grad_()
    (dx,) = torch.autograd.grad(relayout.to_t_layout(xr), (xr,), g)
    (dg,) = torch.autograd.grad(relayout.from_t_layout(gr, b, h), (gr,), x)
    assert torch.equal(dx, gb) and torch.equal(dg, xt)


def test_embed_and_relayout_kernels_raise_on_inputs_they_do_not_take(dev):
    table = _randn(dev, 16, 64)
    ids = torch.zeros((2, 4), dtype=torch.long, device=dev)
    with pytest.raises(TypeError):                  # f32 and bf16 tables
        embed.embed_gather(table.half(), ids, 1.0, torch.float32)
    with pytest.raises(TypeError):                  # f32 and bf16 outputs
        embed.embed_gather(table, ids, 1.0, torch.float16)
    with pytest.raises(ValueError):                 # not contiguous
        embed.embed_gather(table.t(), ids, 1.0, torch.float32)
    with pytest.raises(ValueError):                 # ids must be integers
        embed.embed_gather(table, ids.float(), 1.0, torch.float32)
    with pytest.raises(ValueError):                 # (B, S) or (B,) ids
        embed.embed_gather(table, ids[None], 1.0, torch.float32)
    with pytest.raises(ValueError):                 # ids on the table's card
        embed.embed_gather(table, ids.cpu(), 1.0, torch.float32)
    x = _randn(dev, 2, 8, 3, 64)
    with pytest.raises(ValueError):                 # not contiguous
        relayout.to_t_forward(x.transpose(1, 2))
    with pytest.raises(TypeError):                  # f32 and bf16
        relayout.to_t_forward(x.half())
    with pytest.raises(ValueError):                 # 4-d into the flat layout
        relayout.to_t_forward(x[0])
    with pytest.raises(ValueError):                 # B*H must match
        relayout.from_t_forward(_randn(dev, 6, 8, 64), 4, 2)
