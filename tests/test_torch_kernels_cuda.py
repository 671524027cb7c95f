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
    (2, 19, 45, 4, 2, 12, True, 20, 0),        # head_dim 12, zero-padded to 16
    (1, 50, 70, 2, 1, 640, True, 20, 0),       # 640: two 512-column slices
    (1, 16, 64, 2, 2, 1032, True, 0, 40),      # three slices, rows masked
    (1, 5, 256, 4, 4, 512, True, 131, 0),      # a verify block of k+1 rows
    (1, 5, 256, 4, 4, 512, True, 250, 0),      # ... at max_seq - 6
    (1, 5, 197, 8, 8, 128, True, 131, 0),      # generate's defaults, k 4
    (1, 5, 197, 8, 8, 128, True, 191, 0),      # ... at max_seq - 6
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
@pytest.mark.parametrize("bl", [1, 8, 16, 32])
@pytest.mark.parametrize("h,kh,d", [
    (4, 4, 512),            # the serving shape (MHA, head_dim 512)
    (4, 2, 256),            # GQA, 2 query heads per kv head
    (8, 2, 128),            # groups of 4
    (6, 2, 64),             # groups of 3 (an f32 group tile of 4)
    (8, 1, 96),             # groups of 8
    (16, 1, 64),            # one full bf16 group tile of 16
    (32, 1, 64),            # two group tiles (past the old ceiling of 16)
    (64, 1, 128),           # four group tiles
    (3, 3, 200),            # ragged head_dim
    (2, 2, 12),             # head_dim not a multiple of 8 (8-byte copies)
    (2, 1, 520),            # two 512-column slices, the second 8 wide
    (2, 2, 1024),           # two full slices
])
def test_paged_decode_kernel_matches_plain(dev, dtype, bl, h, kh, d):
    q, k, v, table, pos = _paged_inputs(dev, dtype, 4, h, kh, d, bl, 128)
    before = {n: kernels.launches[n]
              for n in (paged.KERNEL, paged.KERNEL_COMBINE)}
    got = paged.paged_decode_attention(q, k, v, table, pos, block_len=bl)
    torch.cuda.synchronize()
    assert {n: kernels.launches[n] - c for n, c in before.items()} == {
        paged.KERNEL: 1, paged.KERNEL_COMBINE: 1}
    want = paged.paged_decode_attention_plain(q, k, v, table, pos,
                                              block_len=bl)
    atol, rtol = TOL[dtype]
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kh,d,bl,s_max", [
    (4, 4, 512, 16, 256),   # the paged engine's shape
    (8, 2, 128, 16, 1024),  # longer tables: fewer, longer splits
    (3, 1, 13, 4, 96),      # an odd head_dim (element-wise bf16 copies)
])
def test_paged_decode_split_edges_and_repeat(dev, dtype, h, kh, d, bl, s_max):
    # Positions at 0, on either side of a split boundary and at the table's
    # last row; two calls give the same bits.
    b = 4
    q, k, v, table, _ = _paged_inputs(dev, dtype, b, h, kh, d, bl, s_max)
    table[-1] = table[0]                     # no parked slot here
    split, splits = paged.split_plan(b, h, kh, d, s_max, dtype)
    assert splits > 1
    pos = torch.tensor([0, split - 1, split, s_max - 1], dtype=torch.int32,
                       device=dev)
    got = paged.paged_decode_attention(q, k, v, table, pos, block_len=bl)
    again = paged.paged_decode_attention(q, k, v, table, pos, block_len=bl)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = paged.paged_decode_attention_plain(q, k, v, table, pos,
                                              block_len=bl)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_combine_kernel_matches_plain(dev, dtype):
    # The split kernel's partials at the paged engine's shape (slot 0 at
    # position 0: its later splits are empty, their acc never written).
    q, k, v, table, pos = _paged_inputs(dev, dtype, 4, 4, 4, 512, 16, 256)
    acc, ml = paged.paged_decode_partials(q, k, v, table, pos, block_len=16)
    before = kernels.launches[paged.KERNEL_COMBINE]
    got = paged.paged_decode_combine(acc, ml, dtype)
    torch.cuda.synchronize()
    assert kernels.launches[paged.KERNEL_COMBINE] == before + 1
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(
        got, paged.paged_decode_combine_plain(acc, ml, dtype), atol=atol,
        rtol=rtol)


def test_kernels_raise_on_shapes_they_do_not_take(dev):
    with pytest.raises(ValueError):
        rms.rms_norm(_randn(dev, 4, 8).t(), torch.ones(4, device=dev))
    with pytest.raises(TypeError):                  # f32 and bf16 only
        rms.rms_norm(_randn(dev, 4, 8, dtype=torch.float16),
                     torch.ones(8, device=dev))
    q, k, v, table, pos = _paged_inputs(dev, torch.float32, 2, 4, 2, 64, 8,
                                        32)

    def call(q=q, k=k, v=v, table=table, pos=pos):
        return paged.paged_decode_attention(q, k, v, table, pos, block_len=8)
    with pytest.raises(ValueError):                 # kv heads do not divide H
        call(q=_randn(dev, 2, 3, 64))
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


@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 16392),    # forward: past 2048 16-byte vectors
    (torch.float32, 8196),
    (torch.float32, 2049),      # past 2048 columns of one element
    (torch.bfloat16, 8200),     # backward: past 1024 16-byte vectors
    (torch.float32, 4100),
    (torch.float32, 1025),      # past 1024 columns of one element
])
def test_rms_kernels_raise_past_their_widest_rows(dev, dtype, d):
    # The register-resident layouts end at these widths (the forward's 2048
    # vectors a row, the backward's 1024); past them the wide-row bodies
    # take the row, so nothing raises: both directions match the plain
    # versions at the first width past each limit, and dw repeats bitwise.
    x = _randn(dev, 5, d, dtype=dtype, seed=3)
    dy = _randn(dev, 5, d, dtype=dtype, seed=4)
    w = 1.0 + 0.1 * _randn(dev, d, seed=5)
    before = {n: kernels.launches[n] for n in (rms.KERNEL, rms.KERNEL_BWD)}
    got = rms.rms_norm(x, w)
    dx, dw = rms.rms_norm_backward(x, w, dy)
    torch.cuda.synchronize()
    assert {n: kernels.launches[n] - c for n, c in before.items()} == {
        rms.KERNEL: 1, rms.KERNEL_BWD: 1}
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got, rms.rms_norm_plain(x, w), atol=atol,
                               rtol=rtol)
    want_dx, want_dw = rms.rms_norm_backward_plain(x, w, dy)
    _assert_bwd_close(dx, want_dx)
    _assert_bwd_close(dw, want_dw)
    assert torch.equal(rms.rms_norm_backward(x, w, dy)[1], dw)


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
    (2, 40, 40, 2, 12, True, 0, 0),          # D 12, zero-padded to 16
    (1, 70, 70, 2, 640, True, 0, 0),         # D 640: two 512-column slices
    (1, 33, 50, 1, 640, True, 0, 9),         # D 640, ragged, kv_offset 9
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
    if dtype == torch.bfloat16 and d <= 512:     # the tensor-core bodies
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


@pytest.mark.parametrize("d", [128, 512, 640])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_flash_backward_kernel_matches_its_plain_version(dev, dtype, d):
    """dQ with its p/ds stash, dK/dV from that stash, and the recompute
    dK/dV, each against its own plain version, at the training layouts
    (head_dim 128, and the flagship's 512) with a ragged last tile, and at
    640 (the column-sliced bodies)."""
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


@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, (1, 256, 2, 128)), (torch.bfloat16, (2, 512, 4, 128)),
    (torch.bfloat16, (1, 256, 2, 512))])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_lse_matches_plain(dev, dtype, shape, causal):
    """The LSE entry point's O and LSE, and its backward for cotangents of
    both outputs (the LSE's folded into delta), against the plain
    versions on the kernels' own O and LSE."""
    q, k, v, do = (_randn(dev, *shape, dtype=dtype, seed=30 + i)
                   for i in range(4))
    b, s, h, _ = shape
    g_lse = _randn(dev, b, h, s, seed=34)
    kernels.reset_launches()
    o, lse = flash.flash_attention_lse(q, k, v, causal)
    assert kernels.launches["flash_attention"] == 1
    want_o, want_lse = flash.flash_attention_plain(q, k, v, causal,
                                                   return_lse=True)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(o, want_o, atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=2e-4, rtol=0)
    got = flash.flash_attention_backward(q, k, v, o, lse, do, causal,
                                         g_lse=g_lse)
    want = flash.flash_attention_backward_plain(q, k, v, o, lse, do, causal,
                                                g_lse=g_lse)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _assert_bwd_close(g, w, msg=name)


@pytest.mark.parametrize("d,dtype", [(128, torch.bfloat16),
                                     (512, torch.bfloat16),
                                     (128, torch.float32)])
def test_ring_blocks_on_the_card_match_the_plain_schedule(dev, d, dtype):
    """The ring's per-step block function through `flash_attention_lse` for
    4 virtual ranks (the shift replaced by indexing), outputs and
    gradients, against the same schedule's plain f32 block updates on the
    same shards."""
    from k8s_gpu_workload_enhancer_tpu_torch.parallel import (
        ring_attention as ring)
    sp, s = 4, 256
    full = [_randn(dev, 1, sp * s, 2, d, dtype=dtype, seed=40 + i)
            for i in range(4)]

    def run(flash_route):
        shards = [[t[:, r * s:(r + 1) * s].contiguous().requires_grad_(True)
                   for r in range(sp)] for t in full[:3]]
        outs = []
        for r in range(sp):
            part = ring.init_partials(shards[0][r])
            for step in range(sp):
                src = (r - step) % sp
                part = ring.ring_step(shards[0][r], shards[1][src],
                                      shards[2][src], part, r, src, True,
                                      flash_route)
            outs.append(ring.finish(part, dtype))
        o = torch.cat(outs, dim=1)
        leaves = [t for group in shards for t in group]
        grads = torch.autograd.grad((o.float() * full[3].float()).sum(),
                                    leaves)
        return o, [torch.cat(grads[i * sp:(i + 1) * sp], dim=1)
                   for i in range(3)]
    kernels.reset_launches()
    got_o, got_g = run(True)
    assert kernels.launches["flash_attention"] == sp * (sp + 1) // 2
    assert kernels.launches["flash_attention_bwd_dq"] == sp * (sp + 1) // 2
    want_o, want_g = run(False)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got_o, want_o, atol=atol, rtol=rtol)
    for name, g, w in zip(("dq", "dk", "dv"), got_g, want_g):
        if dtype == torch.float32:
            _assert_bwd_close(g, w, msg=name)
            continue
        # bf16: each block's output and gradients are rounded to bf16
        # before the merge and autograd's sums, a few ulps of the largest
        # term where terms cancel (chip_smoke.py's RING_RTOL and
        # RING_ATOL_OF_MAX).
        top = float(w.abs().max())
        torch.testing.assert_close(g, w, atol=2.0 ** -6 * top,
                                   rtol=2.0 ** -6, msg=name)


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
    with pytest.raises(TypeError):                  # dO in another dtype
        flash.flash_attention_backward(q, q, q, o, lse, q.bfloat16())


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


def _table_views(dev, d, max_seq, start, s):
    """The (S, D/2) cos and sin of the model's (max_seq, D/2, 2) table at
    `start`, three ways: the in-place views (element stride 2, sin one
    float past cos), contiguous copies, and views of element stride 3 (the
    kernels' any-stride read)."""
    freqs = attention.rope_frequencies(d, max_seq, device=dev)
    fr = freqs[start:start + s]
    wide = torch.zeros((s, d // 2, 3), device=dev)
    wide[..., :2] = fr
    return {"in_place": (fr[..., 0], fr[..., 1]),
            "contiguous": (fr[..., 0].contiguous(), fr[..., 1].contiguous()),
            "stride_3": (wide[..., 0], wide[..., 1])}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,start", [((1, 128, 4, 512), 0),
                                         ((1, 128, 4, 512), 128),
                                         ((2, 64, 16, 128), 3),
                                         ((2, 7, 3, 24), 5), ((1, 1, 2, 2), 9)])
def test_rope_reads_strided_tables_bit_for_bit(dev, dtype, shape, start):
    """The rotation and its inverse (the sign flag) on the table read in
    place, on contiguous tables and through any strides: each bit for bit
    with the plain version, one launch a call; then the t-layout pair on the
    same tables, bit for bit."""
    b, s, h, d = shape
    x = _randn(dev, *shape, dtype=dtype)
    g = _randn(dev, b * h, s, d, dtype=dtype, seed=1)
    for name, (c, sn) in _table_views(dev, d, 256, start, s).items():
        kernels.reset_launches()
        fwd = rope.rope_rotate_forward(x, c, sn)
        inv = rope.rope_rotate_forward(x, c, sn, inverse=True)
        xt = rope.rope_rotate_t_forward(x, c, sn)
        back = rope.rope_rotate_t_inverse(g, c, sn, h)
        torch.cuda.synchronize()
        assert dict(kernels.launches) == {"rope": 2, "rope_t": 1,
                                          "rope_t_inv": 1}, name
        assert torch.equal(fwd, rope.rope_rotate_plain(x, c, sn)), name
        assert torch.equal(inv, rope.rope_rotate_plain(x, c, -sn)), name
        assert torch.equal(xt, rope.rope_rotate_t_plain(x, c, sn)), name
        assert torch.equal(back, rope.rope_rotate_t_inv_plain(g, c, sn, h)), \
            name


def _device_kernels(fn, tries: int = 3) -> int:
    """CUDA kernels one call of fn launches (torch.profiler). The window is
    fenced by a spin kernel before and after fn; one in which the profiler
    did not record both fences is incomplete and is taken again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        fences = sum("spin_kernel" in n for n in names)
        if fences == 2:
            return len(names) - fences
    raise AssertionError(f"no profiler window recorded both fences in "
                         f"{tries} tries")


@pytest.mark.parametrize("t_layout", [False, True])
def test_main_path_rotation_is_one_launch_each_way(dev, t_layout):
    """`apply_rope` / `apply_rope_t` on the model's table, as the model
    calls them: one kernel forward and one backward, no copy of the table
    and no -sin; the gradient is the plain inverse rotation's bit for
    bit."""
    b, s, h, d = (1, 128, 4, 512)
    freqs = attention.rope_frequencies(d, 256, device=dev)
    x = _randn(dev, b, s, h, d, dtype=torch.bfloat16).requires_grad_()
    fn = attention.apply_rope_t if t_layout else attention.apply_rope
    y = fn(x, freqs, 64)
    g = _randn(dev, *y.shape, dtype=torch.bfloat16, seed=1)
    with torch.no_grad():
        assert _device_kernels(lambda: fn(x, freqs, 64)) == 1
    assert _device_kernels(lambda: torch.autograd.grad(
        y, (x,), g, retain_graph=True)) == 1
    (dx,) = torch.autograd.grad(y, (x,), g)
    c, sn = freqs[64:64 + s, :, 0], freqs[64:64 + s, :, 1]
    want = (rope.rope_rotate_t_inv_plain(g, c, sn, h) if t_layout
            else rope.rope_rotate_plain(g, c, -sn))
    assert torch.equal(dx, want)


@pytest.mark.parametrize("table_dtype,out_dtype,round_rows", [
    (torch.bfloat16, torch.bfloat16, True),
    (torch.float32, torch.bfloat16, True),
    (torch.float32, torch.float32, False)])
@pytest.mark.parametrize("n", [1, 8, 128, 16384])
@pytest.mark.parametrize("d", [2048, 1004, 1001])
def test_embed_gather_at_every_grid_bit_for_bit(dev, table_dtype, out_dtype,
                                                round_rows, n, d):
    """The gather's launch shapes (one wave of small blocks at 1, 8 and 128
    ids, two vectors a thread at 16384), at a width that is a multiple of
    the vector (2048), of 4 but not 8 elements (1004: bf16 moves one element
    a vector, an f32 table four) and of neither (1001); ids 0, V - 1, -1, V
    and wild ones, through 1-d int32 ids and a strided 2-d int64 view."""
    v = 32768
    table = (0.02 * _randn(dev, v, d)).to(table_dtype)
    g = torch.Generator(device=dev).manual_seed(n)
    cols = min(n, 128)
    base = torch.randint(-2 * v, 2 * v, (n // cols, cols + 1), device=dev,
                         generator=g)
    base.view(-1)[:4] = torch.tensor([0, v - 1, -1, v], device=dev)[
        :base.numel()]
    for ids in (base[:, :-1].reshape(-1).to(torch.int32), base[:, :-1]):
        kernels.reset_launches()
        got = embed.embed_gather(table, ids, 45.25, out_dtype, round_rows)
        torch.cuda.synchronize()
        assert dict(kernels.launches) == {"embed_gather": 1}
        assert torch.equal(got, embed.embed_gather_plain(
            table, ids, 45.25, out_dtype, round_rows))


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


def test_prefetch_to_device_matches_the_numpy_batches(dev, tmp_path):
    """The token pipeline on the card: batches copied from pinned host
    tensors on a side stream, each waited for before use, equal the numpy
    windows (as int64 tokens), and a step that consumes a batch sees it."""
    import numpy as np
    from k8s_gpu_workload_enhancer_tpu_torch.train import data
    path = str(tmp_path / "tokens.bin")
    data.write_token_file(path, np.random.default_rng(0).integers(
        0, 30000, 40 * 257))
    cfg = data.DataConfig(path=path, batch_size=8, seq_len=256, seed=1)
    want = data.TokenDataset(cfg).batches(2)
    got = data.make_input_pipeline(cfg, start_step=2, device=dev)
    for _ in range(6):
        b = next(got)
        assert b.device == dev and b.dtype == torch.int64
        total = int(b.sum())                 # consumed on the current stream
        w = next(want)
        assert total == int(w.astype(np.int64).sum())
        assert torch.equal(b.cpu(), torch.from_numpy(w).long())


@pytest.mark.parametrize("kv_block_len", [0, 16], ids=["dense", "paged"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefix_and_resumed_admissions_match_a_cold_prompt(dev, dtype,
                                                           kv_block_len):
    """On the card, through the kernels: a request riding a registered
    160-token prefix (dense: one 128-token chunk borrowed, the suffix
    prefilled at q_offset 128; paged: ten pinned pages) and a request
    resumed from an eject after 9 tokens give the greedy tokens of the
    cold full prompt."""
    import numpy as np
    from k8s_gpu_workload_enhancer_tpu_torch.models import serving
    from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as tf
    cfg = tf.TransformerConfig(vocab_size=1024, d_model=512, n_layers=2,
                               n_heads=4, n_kv_heads=4, d_ff=1024,
                               max_seq=256, dtype=dtype)
    params = _cast_tree(tf.init_params(
        torch.Generator(device=dev).manual_seed(0), cfg), dtype)

    def engine():
        return serving.ContinuousBatchEngine(
            params, cfg, num_slots=4, prefill_len=128, decode_chunk=8,
            kv_block_len=kv_block_len, device=dev)
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 1024, 160).tolist()
    suffix = rng.integers(0, 1024, 32).tolist()
    cold_eng = engine()
    rid = cold_eng.submit(prefix + suffix, 48)
    cold_eng.run()
    cold = cold_eng.result(rid).tokens
    eng = engine()
    pid = eng.register_prefix(prefix)
    assert eng.prefix_cached_len(pid) == (160 if kv_block_len else 128)
    kernels.reset_launches()
    rid = eng.submit(suffix, 48, prefix_id=pid)
    eng.run()
    assert eng.result(rid).tokens == cold
    assert kernels.launches["flash_attention"] >= cfg.n_layers
    src = engine()
    rid = src.submit(prefix + suffix, 48)
    while len(src.result(rid).tokens) < 9:
        src.step()
    state = src.eject(rid)
    dst = engine()
    r2 = dst.submit(state["prompt"], 48, committed=state["committed"],
                    prng_key=state["prngKey"])
    dst.run()
    assert dst.result(r2).tokens == cold


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def _serving_model(dev):
    """A small bf16 model for the engine tests (4 heads of 128)."""
    from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as tf
    cfg = tf.TransformerConfig(vocab_size=1024, d_model=512, n_layers=2,
                               n_heads=4, n_kv_heads=4, d_ff=1024,
                               max_seq=256, dtype=torch.bfloat16)
    params = [_cast_tree(tf.init_params(
        torch.Generator(device=dev).manual_seed(seed), cfg), cfg.dtype)
        for seed in (0, 1)]
    return cfg, params


def _graph_engine(dev, params, cfg, kv_block_len, **kw):
    from k8s_gpu_workload_enhancer_tpu_torch.models import serving
    return serving.ContinuousBatchEngine(
        params, cfg, num_slots=2, prefill_len=128, decode_chunk=8,
        kv_block_len=kv_block_len, top_k=40, enable_top_p=True, device=dev,
        **kw)


def _graph_workload(eng, seed=0):
    """Three requests through two slots (admissions between replays): a
    greedy one, a two-chunk prompt, a sampled one with top-k and top-p."""
    import numpy as np
    rng = np.random.default_rng(seed)
    rids = [eng.submit(rng.integers(0, 1024, 40).tolist(), 24),
            eng.submit(rng.integers(0, 1024, 150).tolist(), 20),
            eng.submit(rng.integers(0, 1024, 9).tolist(), 30,
                       temperature=0.8, top_p=0.9, prng_key=[7, seed])]
    eng.run()
    out = [(eng.result(r).tokens, eng.result(r).logprobs) for r in rids]
    assert all(eng.result(r).finish_reason == "length" for r in rids)
    return out


def _engine_launches(cfg, lifetime, paged):
    """Launches of an engine run: per prefill chunk a gather, 2L+1 norms,
    2L RoPE rotations and L flash forwards (on the wgmma body); per decode
    step a gather, 2L+1 norms and, paged, L split-KV and L combine
    kernels."""
    chunks, steps = lifetime["prefill_chunks"], lifetime["decode_steps"]
    n = cfg.n_layers
    want = {"embed_gather": chunks + steps,
            "rms_norm": (2 * n + 1) * (chunks + steps),
            "rope": 2 * n * chunks, "flash_attention": n * chunks,
            "flash_attention_wgmma": n * chunks}
    if paged:
        want.update(paged_decode=n * steps, paged_decode_combine=n * steps)
    return want


@pytest.mark.parametrize("kv_block_len", [0, 16], ids=["dense", "paged"])
def test_graphed_engine_equals_the_eager_engine_bitwise(dev, kv_block_len):
    """The decode chunk replayed as one CUDA graph under the overlapped
    pipeline gives the eager, serialized engine's tokens and logprobs bit
    for bit (greedy, and sampled through top-k and top-p); one capture
    serves every request, and the launch counts equal the per-step
    formula through the replays."""
    cfg, (params, _) = _serving_model(dev)
    eng = _graph_engine(dev, params, cfg, kv_block_len,
                        watchdog_timeout=30)
    kernels.reset_launches()
    got = _graph_workload(eng)
    torch.cuda.synchronize()
    m = eng.metrics()
    assert dict(kernels.launches) == _engine_launches(
        cfg, m["lifetime"], kv_block_len > 0)
    got += _graph_workload(eng, seed=1)
    hp = eng.metrics()["hotpath"]
    assert hp["graphs_captured"] == 1 and hp["graph_replays"] > 0
    assert eng.metrics()["resilience"]["watchdog_trips"] == 0
    ref = _graph_engine(dev, params, cfg, kv_block_len, cuda_graph=False,
                        overlap_commit=False)
    want = _graph_workload(ref) + _graph_workload(ref, seed=1)
    assert ref.metrics()["hotpath"]["graphs_captured"] == 0
    assert got == want


@pytest.mark.parametrize("kv_block_len", [0, 16], ids=["dense", "paged"])
def test_graphed_engine_after_a_swap_equals_a_fresh_engine(dev,
                                                           kv_block_len):
    """swap_params with a chunk in flight: the new leaves are copied into
    the captured storage, the graph is kept, and requests after the swap
    equal a fresh graphed engine's on the new weights."""
    cfg, (pa, pb) = _serving_model(dev)
    eng = _graph_engine(dev, pa, cfg, kv_block_len)
    before = eng.submit(list(range(1, 40)), 30)
    for _ in range(3):
        eng.step()
    assert eng._inflight is not None
    eng.swap_params(pb)
    eng.run()
    assert eng.result(before).finish_reason == "length"
    got = _graph_workload(eng)
    assert eng.metrics()["hotpath"]["graphs_captured"] == 1
    assert got == _graph_workload(_graph_engine(dev, pb, cfg, kv_block_len))


def _preempt_workload(eng, temperature=None):
    """Two batch requests decoding in both slots, then an interactive one:
    the later batch request is preempted with a chunk in flight. Returns
    every request's tokens and logprobs and the victim's resume state."""
    import numpy as np
    rng = np.random.default_rng(3)
    b = [eng.submit(rng.integers(0, 1024, 96).tolist(), 64,
                    priority="batch", temperature=temperature,
                    prng_key=[5, i]) for i in range(2)]
    for _ in range(200):
        if all(len(eng.result(r).tokens) >= 9 for r in b):
            break
        eng.step()
    i = eng.submit(rng.integers(0, 1024, 40).tolist(), 24,
                   temperature=temperature, prng_key=[6, 0])
    assert eng._inflight is not None
    eng.run()
    st = eng.result(b[1]).resume_state
    assert st is not None and st["reason"] == "preempt"
    assert eng.result(b[0]).finish_reason == "length"
    return [(eng.result(r).tokens, eng.result(r).logprobs)
            for r in b + [i]], st


@pytest.mark.parametrize("temperature", [None, 0.8], ids=["greedy", "t0.8"])
def test_graphed_paged_preemption_equals_the_eager_engine(dev, temperature):
    """A preemption on the graphed, pipelined paged engine (the victim's
    pages handed to the interactive request while a replayed chunk still
    decodes for it) equals the eager, serialized engine bit for bit:
    every request's tokens and logprobs and the victim's resume state. One
    capture serves it, no page leaks, and the victim resumed on a fresh
    engine continues its uninterrupted stream."""
    cfg, (params, _) = _serving_model(dev)
    eng = _graph_engine(dev, params, cfg, 16, watchdog_timeout=30)
    got, st = _preempt_workload(eng, temperature)
    m = eng.metrics()
    assert m["hotpath"]["graphs_captured"] == 1
    assert m["resilience"]["watchdog_trips"] == 0
    assert m["migration"]["preempted_total"] == 1
    kv = m["kv_cache"]
    assert kv["blocks_free"] + kv["blocks_cached"] == kv["blocks_total"]
    ref = _graph_engine(dev, params, cfg, 16, cuda_graph=False,
                        overlap_commit=False)
    want, want_st = _preempt_workload(ref, temperature)
    assert got == want and st == want_st
    whole = _graph_engine(dev, params, cfg, 16)
    rid = whole.submit(st["prompt"], 64, temperature=temperature,
                       prng_key=st["prngKey"])
    whole.run()
    res = _graph_engine(dev, params, cfg, 16)
    r2 = res.submit(st["prompt"], 64, committed=st["committed"],
                    temperature=temperature, prng_key=st["prngKey"],
                    priority="batch", preempted=st["preempted"])
    res.run()
    assert res.result(r2).tokens == whole.result(rid).tokens


@pytest.mark.parametrize("kv_block_len", [0, 16], ids=["dense", "paged"])
def test_graphed_chunked_engine_equals_the_eager_plain_engine(dev,
                                                              kv_block_len):
    """prefill_chunk_tokens 32 on the graphed, pipelined engine: the third
    request waits for a slot, so the backlog drops decode to the quantum
    (decode_chunk 8 // 4 = 2 steps, a second captured graph) while the
    prompts prefill in 32-token slices at offsets that
    are no multiple of the 64-row tiles; the tokens and logprobs equal the
    eager, serialized plain engine's (128-token slices, full chunks) bit
    for bit. Two captures, each length once; the launch counts follow the
    per-step formula through both graphs' replays."""
    cfg, (params, _) = _serving_model(dev)
    eng = _graph_engine(dev, params, cfg, kv_block_len,
                        prefill_chunk_tokens=32, watchdog_timeout=30)
    kernels.reset_launches()
    got = _graph_workload(eng)
    torch.cuda.synchronize()
    m = eng.metrics()
    assert dict(kernels.launches) == _engine_launches(
        cfg, m["lifetime"], kv_block_len > 0)
    assert m["hotpath"]["graphs_captured"] == 2
    assert eng._graph.captures == eng._quantum_graph.captures == 1
    assert m["resilience"]["watchdog_trips"] == 0
    ref = _graph_engine(dev, params, cfg, kv_block_len, cuda_graph=False,
                        overlap_commit=False)
    assert got == _graph_workload(ref)


def test_prefill_role_engine_never_captures(dev):
    """A prefill-role engine on the card hands every request off after its
    first token (the eager plain engine's first token and logprob) and
    never dispatches a decode chunk, so it never captures a graph."""
    cfg, (params, _) = _serving_model(dev)
    eng = _graph_engine(dev, params, cfg, 16, handoff_first_token=True)
    ref = _graph_engine(dev, params, cfg, 16, cuda_graph=False,
                        overlap_commit=False)
    import numpy as np
    prompts = np.random.default_rng(4).integers(0, 1024, (4, 40)).tolist()
    rids = [eng.submit(p, 24) for p in prompts]
    eng.run()
    want = [ref.submit(p, 1) for p in prompts]
    ref.run()
    for r, w in zip(rids, want):
        req = eng.result(r)
        assert req.finish_reason == "migrated"
        assert req.resume_state["reason"] == "handoff"
        assert (req.tokens, req.logprobs) == (ref.result(w).tokens,
                                              ref.result(w).logprobs)
    m = eng.metrics()
    assert m["lifetime"]["decode_steps"] == 0
    assert m["hotpath"]["graphs_captured"] == 0
    assert m["migration"]["handoffs_total"] == 4
    kv = m["kv_cache"]
    assert kv["blocks_free"] + kv["blocks_cached"] == kv["blocks_total"]


@pytest.mark.parametrize("kv_block_len", [0, 16], ids=["dense", "paged"])
def test_graphed_int8_kv_engine_equals_the_eager_engine(dev, kv_block_len):
    """kv_cache_int8 on the card: int8 K/V with f32 scales, the graphed
    pipelined engine equal to the eager serialized one bit for bit, the
    launch counts of a dense decode (no paged decode kernel, as the JAX
    engine switches its paged kernel off under int8), no page leaked; the
    quantizer's scales within 1e-6 of its CPU run and its q8 equal, but
    where the value before rounding lies within 1e-4 of a half-integer
    (the card's and the CPU's division may part in the last bit), there by
    at most one step."""
    import dataclasses
    from k8s_gpu_workload_enhancer_tpu_torch.models import decode
    cfg, (params, _) = _serving_model(dev)
    cfg8 = dataclasses.replace(cfg, kv_cache_int8=True)
    eng = _graph_engine(dev, params, cfg8, kv_block_len, watchdog_timeout=30)
    assert eng._cache.k.dtype == torch.int8
    assert eng._cache.kscale.dtype == torch.float32
    kernels.reset_launches()
    got = _graph_workload(eng)
    torch.cuda.synchronize()
    m = eng.metrics()
    assert dict(kernels.launches) == _engine_launches(cfg, m["lifetime"],
                                                      False)
    assert m["hotpath"]["graphs_captured"] == 1
    ref = _graph_engine(dev, params, cfg8, kv_block_len, cuda_graph=False,
                        overlap_commit=False)
    assert got == _graph_workload(ref)
    kv = m["kv_cache"]
    assert kv["blocks_free"] + kv["blocks_cached"] == kv["blocks_total"]
    x = _randn(dev, 3, 5, 4, 512, dtype=cfg.dtype, seed=3)
    q8, sc = decode.kv_quantize(x)
    q8c, scc = decode.kv_quantize(x.cpu())
    torch.testing.assert_close(sc.cpu(), scc, rtol=1e-6, atol=0)
    pre = x.cpu().float() / scc[..., None]
    tie = (pre - pre.floor() - 0.5).abs() < 1e-4
    diff = q8.cpu().int() - q8c.int()
    assert not diff[~tie].any()
    assert diff.abs().max() <= 1


def _spec_workload(eng, seed=0):
    """Three requests through two slots on prompts of a repeated 8-token
    cycle (the n-gram drafter's regime): two greedy, one sampled with
    top-k and top-p, which rides the verify rounds without drafting."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cycles = [rng.integers(0, 1024, 8).tolist() for _ in range(3)]
    rids = [eng.submit(cycles[0] * 5, 40), eng.submit(cycles[1] * 18, 30),
            eng.submit(cycles[2] * 2, 30, temperature=0.8, top_p=0.9,
                       prng_key=[9, seed])]
    eng.run()
    out = [(eng.result(r).tokens, eng.result(r).logprobs) for r in rids]
    assert all(eng.result(r).finish_reason == "length" for r in rids)
    return out


@pytest.mark.parametrize("kv_block_len", [0, 16], ids=["dense", "paged"])
def test_graphed_verify_rounds_equal_the_eager_engine(dev, kv_block_len):
    """spec_k 4 on the card: the verify round captured once as its own
    graph, whose replay launches one gather and 2L+1 norms (no paged
    decode, RoPE or flash); the graphed engine's tokens and logprobs equal
    the eager engine's bit for bit, and its launches those of its prefill
    chunks, decode steps and verify rounds (a round one step, with no
    paged decode); no page leaked."""
    cfg, (params, _) = _serving_model(dev)
    eng = _graph_engine(dev, params, cfg, kv_block_len, spec_k=4,
                        watchdog_timeout=30)
    kernels.reset_launches()
    got = _spec_workload(eng) + _spec_workload(eng, seed=1)
    torch.cuda.synchronize()
    m = eng.metrics()
    rounds = m["spec"]["rounds_total"]
    assert rounds > 0 and m["spec"]["draft_accepted_total"] > 0
    want = _engine_launches(cfg, m["lifetime"], kv_block_len > 0)
    if kv_block_len:
        want["paged_decode"] -= cfg.n_layers * rounds
        want["paged_decode_combine"] -= cfg.n_layers * rounds
    assert dict(kernels.launches) == want
    vg = eng._verify_graph
    assert vg.captures == 1 and vg.replays == rounds - 1
    assert dict(vg.launches) == {"embed_gather": 1,
                                 "rms_norm": 2 * cfg.n_layers + 1}
    ref = _graph_engine(dev, params, cfg, kv_block_len, spec_k=4,
                        cuda_graph=False)
    assert got == _spec_workload(ref) + _spec_workload(ref, seed=1)
    assert ref.metrics()["spec"] == m["spec"]
    kv = m["kv_cache"]
    assert kv["blocks_free"] + kv["blocks_cached"] == kv["blocks_total"]


def _tier_workload(eng, seed=0):
    """Three prompts of distinct 64-token prefixes through a pool that
    holds two requests' pages (each request leaves 5 full prompt pages
    cached), so admissions evict earlier prefixes into the host tier; then
    each prefix again under a new tail, restored from the tier."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 1024, 64).tolist() for _ in range(3)]
    rids = [eng.submit(p + rng.integers(0, 1024, 16).tolist(), 24)
            for p in prefixes]
    eng.run()
    rids += [eng.submit(p + rng.integers(0, 1024, 16).tolist(), 24)
             for p in prefixes]
    eng.run()
    assert all(eng.result(r).finish_reason == "length" for r in rids)
    return [(eng.result(r).tokens, eng.result(r).logprobs) for r in rids]


def _watch_demotions(eng):
    """digest -> the page's leaves as they were when it was demoted."""
    seen = {}
    real = eng._radix.on_evict

    def hook(node):
        seen[node.digest] = [t[:, node.block].clone()
                             for t in eng._cache.leaves()]
        real(node)
    eng._radix.on_evict = hook
    return seen


def test_graphed_engine_with_the_host_tier_equals_the_eager_engine(dev):
    """kv_host_blocks on the card: the graphed, pipelined paged engine
    whose admissions demote pages to pinned host memory on a side stream
    and restore them in place gives the eager serialized engine's tokens
    and logprobs bit for bit, the same tier counters (the wall-clock DMA
    seconds aside), restores every re-arrival's prefix, and leaks no page;
    its launches are its prefill chunks' and decode steps' (a restore
    launches no table kernel)."""
    cfg, (params, _) = _serving_model(dev)
    kw = dict(kv_num_blocks=15, kv_host_blocks=32)
    eng = _graph_engine(dev, params, cfg, 16, watchdog_timeout=30, **kw)
    kernels.reset_launches()
    got = _tier_workload(eng)
    torch.cuda.synchronize()
    m = eng.metrics()
    assert dict(kernels.launches) == _engine_launches(cfg, m["lifetime"],
                                                      True)
    assert m["hotpath"]["graphs_captured"] == 1
    tier = m["kvhost"]
    assert tier["offloads_total"] >= 12 and tier["hits_total"] >= 8
    assert tier["prefetches_total"] == tier["hits_total"]
    ref = _graph_engine(dev, params, cfg, 16, cuda_graph=False,
                        overlap_commit=False, **kw)
    assert got == _tier_workload(ref)
    rm = ref.metrics()["kvhost"]
    for k in ("dma_seconds_total",):
        tier.pop(k)
        rm.pop(k)
    assert rm == tier
    kv = m["kv_cache"]
    assert kv["blocks_free"] + kv["blocks_cached"] == kv["blocks_total"]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_host_tier_restores_pages_in_place_bit_for_bit(dev, int8):
    """Every page restored from the host tier equals, bit for bit, the
    page as it was when demoted (k, v and, under int8, the scales), in the
    pool tensors the engine was built with: each restore is held as it
    lands, and the pages still in the tree after the run, with no sync
    between the engine's steps; the demotion's staging copy on the compute
    stream and the side stream's copy to pinned memory see the page before
    the admission that freed it overwrites it."""
    import dataclasses
    cfg, (params, _) = _serving_model(dev)
    cfg = dataclasses.replace(cfg, kv_cache_int8=int8)
    eng = _graph_engine(dev, params, cfg, 16, kv_num_blocks=15,
                        kv_host_blocks=32)
    ptrs = [t.data_ptr() for t in eng._cache.leaves()]
    demoted = _watch_demotions(eng)
    tier, restored = eng._host_tier, []
    real_restore = tier.restore

    def restore(cache, block_id, entry):
        real_restore(cache, block_id, entry)
        torch.cuda.synchronize()
        for got, want in zip(cache.leaves(), demoted[entry.digest]):
            assert torch.equal(got[:, block_id], want)
        restored.append(entry.digest)
    tier.restore = restore
    _tier_workload(eng)
    torch.cuda.synchronize()
    assert len(restored) >= 8 and len(restored) == tier.prefetches_total
    assert [t.data_ptr() for t in eng._cache.leaves()] == ptrs
    checked, stack = 0, list(eng._radix.root.children.values())
    while stack:
        node = stack.pop()
        stack.extend(node.children.values())
        if node.digest in demoted:
            for got, want in zip(eng._cache.leaves(), demoted[node.digest]):
                assert torch.equal(got[:, node.block], want)
            checked += 1
    assert checked >= 1
    assert eng._host_tier.host_bytes() > 0
    host = next(iter(eng._host_tier._entries.values()))
    arrays = host.arrays or host.pending
    assert all(a.is_pinned() for a in arrays.values())


def _moe_serving_model(dev):
    """The engine tests' model with 4 experts a layer (top-1)."""
    import dataclasses
    from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as tf
    cfg, _ = _serving_model(dev)
    cfg = dataclasses.replace(cfg, n_experts=4)
    params = [_cast_tree(tf.init_params(
        torch.Generator(device=dev).manual_seed(seed), cfg), cfg.dtype)
        for seed in (2, 3)]
    return cfg, params


@pytest.mark.parametrize("kv_block_len", [0, 16], ids=["dense", "paged"])
def test_graphed_moe_engine_equals_the_eager_engine_bitwise(dev,
                                                            kv_block_len):
    """An MoE model (4 experts, the dense one-hot route at every decode
    step, inside the captured graph): the graphed, pipelined engine gives
    the eager, serialized engine's tokens and logprobs bit for bit, greedy
    and sampled; one capture; the launch counts are a dense model's per
    chunk and step (MoE adds no table kernel); no page leaked."""
    cfg, (params, _) = _moe_serving_model(dev)
    eng = _graph_engine(dev, params, cfg, kv_block_len, watchdog_timeout=30)
    kernels.reset_launches()
    got = _graph_workload(eng)
    torch.cuda.synchronize()
    m = eng.metrics()
    assert dict(kernels.launches) == _engine_launches(
        cfg, m["lifetime"], kv_block_len > 0)
    assert m["hotpath"]["graphs_captured"] == 1
    assert m["resilience"]["watchdog_trips"] == 0
    ref = _graph_engine(dev, params, cfg, kv_block_len, cuda_graph=False,
                        overlap_commit=False)
    assert got == _graph_workload(ref)
    kv = m["kv_cache"]
    assert kv["blocks_free"] + kv["blocks_cached"] == kv["blocks_total"]


class _Drafter:
    """Proposes nothing until `on`, then repeats the context's last token:
    a spec engine first dispatches a bypass chunk (the chunk graph), then
    verify rounds (the verify graph)."""

    def __init__(self):
        self.on = False

    def __call__(self, context, k):
        return [int(context[-1])] * k if self.on else []


def _census_engines(dev):
    """(name, engine, drafter or None, graphs it must capture) of every
    mode: dense and paged, plain, spec and chunked, and MoE."""
    cfg, (params, _) = _serving_model(dev)
    mcfg, (mparams, _) = _moe_serving_model(dev)
    out = []
    for bl, kind in ((0, "dense"), (16, "paged")):
        out.append((kind, _graph_engine(dev, params, cfg, bl), None,
                    {"chunk": 1}))
        drafter = _Drafter()
        out.append((f"{kind}-spec", _graph_engine(dev, params, cfg, bl,
                                                  spec_k=4, drafter=drafter),
                    drafter, {"chunk": 1, "verify": 1}))
        out.append((f"{kind}-chunked", _graph_engine(
            dev, params, cfg, bl, prefill_chunk_tokens=32), None,
            {"chunk": 1, "quantum": 1}))
        out.append((f"{kind}-moe", _graph_engine(dev, mparams, mcfg, bl),
                    None, {"chunk": 1}))
    return out


def _census_traffic(eng, drafter, seed):
    """A short request, then after two steps a two-chunk prompt and a third
    request through the two slots: a prefill runs while a slot decodes and
    a request waits (the quantum on a chunked engine); a spec engine's
    drafter switches on after the first dispatches."""
    import numpy as np
    rng = np.random.default_rng(seed)
    rids = [eng.submit(rng.integers(0, 1024, 9).tolist(), 24)]
    for _ in range(2):
        eng.step()
    if drafter is not None:
        drafter.on = True
    rids += [eng.submit(rng.integers(0, 1024, n).tolist(),
                        int(rng.integers(20, 40))) for n in (150, 40)]
    eng.run()
    assert all(eng.result(r).finish_reason == "length" for r in rids)


def test_capture_census_exact_and_no_steady_state_captures(dev):
    """The capture census (the port's counterpart of the JAX
    tests/unit/test_compile_census.py): an engine in each mode, warmed by
    its first traffic, has captured exactly its graphs (the chunk, the
    quantum when chunked prefill is on, the verify round when spec is
    on), each once, and the sentinel counted them; then steady traffic of
    new prompts and lengths and a weight swap make no capture and no
    kernel build or load."""
    from k8s_gpu_workload_enhancer_tpu_torch.analysis import compilewatch
    kernels.build()
    compilewatch.reset()
    compilewatch.enable(force=True)
    try:
        engines = _census_engines(dev)
        for _, eng, drafter, _ in engines:
            _census_traffic(eng, drafter, seed=0)
        graphs = {"chunk": "_graph", "quantum": "_quantum_graph",
                  "verify": "_verify_graph"}
        total = 0
        for name, eng, _, want in engines:
            got = {g: getattr(eng, attr).captures
                   for g, attr in graphs.items()
                   if getattr(eng, attr) is not None}
            assert got == want, name
            total += sum(want.values())
        assert compilewatch.counts().get("capture", 0) == total
        compilewatch.mark_warm("census warm")
        cfg, (_, new) = _serving_model(dev)
        _, (_, mnew) = _moe_serving_model(dev)
        for name, eng, drafter, _ in engines:
            _census_traffic(eng, drafter, seed=1)
            eng.swap_params(mnew if name.endswith("moe") else new)
            _census_traffic(eng, drafter, seed=2)
            m = eng.metrics()
            assert m["hotpath"]["graphs_captured"] == sum(
                g.captures for g in (eng._graph, eng._quantum_graph,
                                     eng._verify_graph) if g is not None)
            kv = m["kv_cache"]
            if eng.kv_block_len:
                assert kv["blocks_free"] + kv["blocks_cached"] == \
                    kv["blocks_total"]
        assert compilewatch.post_warm_compiles() == []
        compilewatch.verify()
    finally:
        compilewatch.disable()
        compilewatch.reset()


def _mesh_gang(dp, tp, rank_fn):
    """rank_fn(mesh) on every rank of a (dp, tp) gang of threads on the
    card; rank 0's result."""
    import threading
    from k8s_gpu_workload_enhancer_tpu_torch.parallel.mesh import ServingMesh
    meshes, groups = ServingMesh.thread_gang(dp, tp)
    out, errors = [None] * (dp * tp), []

    def one(r):
        try:
            out[r] = rank_fn(meshes[r])
        except BaseException as e:              # noqa: BLE001 — reported
            errors.append(e)
            for g in groups:
                g.abort()
    threads = [threading.Thread(target=one, args=(r,))
               for r in range(dp * tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not errors, errors
    return out[0]


@pytest.mark.parametrize("kv_block_len", [0, 16], ids=["dense", "paged"])
def test_size_one_mesh_runs_the_single_device_kernels(dev, kv_block_len):
    """An engine on a (1, 1) serving mesh (an NCCL group of one) runs the
    single-device programs: the kernels with exactly the unmeshed engine's
    launches, one graph capture, and its tokens; a (1, 2) thread gang runs
    the plain ops and launches no kernel."""
    import socket
    from k8s_gpu_workload_enhancer_tpu_torch.models import decode
    from k8s_gpu_workload_enhancer_tpu_torch.train import bootstrap
    cfg, (params, _) = _serving_model(dev)
    greedy = lambda eng: _graph_workload(eng)[:2]          # noqa: E731
    kernels.reset_launches()
    want = greedy(_graph_engine(dev, params, cfg, kv_block_len))
    want_launches = dict(kernels.launches)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx, mesh = bootstrap.initialize_serving(
        (1, 1), {"COORDINATOR_ADDRESS": f"localhost:{port}",
                 "NUM_PROCESSES": "1", "PROCESS_ID": "0"}, device="cuda",
        group_of_one=True)
    try:
        eng = _graph_engine(dev, params, cfg, kv_block_len, mesh=mesh)
        kernels.reset_launches()
        got = greedy(eng)
        assert dict(kernels.launches) == want_launches
        assert eng.metrics()["hotpath"]["graphs_captured"] == 1
        eng.stop_followers()
    finally:
        ctx.close()
    assert [t for t, _ in got] == [t for t, _ in want]

    def rank(mesh):
        eng = _graph_engine(dev, decode.shard_params_for_serving(
            params, cfg, mesh), cfg, kv_block_len, mesh=mesh)
        if not mesh.is_driver:
            eng.follow()
            return None
        try:
            return greedy(eng), eng.metrics()["hotpath"]["graphs_captured"]
        finally:
            eng.stop_followers()
    kernels.reset_launches()
    _, captures = _mesh_gang(1, 2, rank)
    assert not kernels.launches and captures == 0


@pytest.mark.parametrize("kv_block_len", [0, 16], ids=["dense", "paged"])
def test_graphed_size_one_mesh_recaptures_after_a_device_loss(dev,
                                                              kv_block_len):
    """A graphed engine on a (1, 1) NCCL mesh loses its device after its
    decode graph was captured: the rebuild's new cache and table void the
    graph, which is dropped and captured again, so the degraded engine
    (paged decode kernel off) gives an unmeshed engine's tokens on that
    route and launches no paged decode kernel."""
    import socket
    from k8s_gpu_workload_enhancer_tpu_torch import faultlab
    from k8s_gpu_workload_enhancer_tpu_torch.train import bootstrap
    cfg, (params, _) = _serving_model(dev)
    prompt = list(range(1, 41))
    ref = _graph_engine(dev, params, cfg, kv_block_len, cuda_graph=False)
    ref._paged_kernel = False                   # the degraded route
    rid = ref.submit(prompt, 16)
    ref.run()
    want = ref.result(rid).tokens
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx, mesh = bootstrap.initialize_serving(
        (1, 1), {"COORDINATOR_ADDRESS": f"localhost:{port}",
                 "NUM_PROCESSES": "1", "PROCESS_ID": "0"}, device="cuda",
        group_of_one=True)
    try:
        eng = _graph_engine(dev, params, cfg, kv_block_len, mesh=mesh)
        r0 = eng.submit(prompt, 16)
        for _ in range(16):
            eng.step()
            if eng.result(r0).tokens:
                break
        captured = eng._graph.captures
        faultlab.activate(faultlab.TargetedPlan({"engine.device_loss": [0]}))
        try:
            eng.step()
        finally:
            faultlab.deactivate()
        kernels.reset_launches()
        r1 = eng.submit(prompt, 16)
        eng.run()
        got, launches = eng.result(r1).tokens, dict(kernels.launches)
        finish = eng.result(r0).finish_reason
    finally:
        ctx.close()
    assert captured == 1 and eng._graph.captures == 2
    assert finish == "migrated" and eng.mesh is None
    assert "paged_decode" not in launches
    for k in ("rms_norm", "rope", "flash_attention", "embed_gather"):
        assert launches.get(k, 0) > 0, launches
    assert got == want


def test_degraded_engine_launches_the_single_device_kernels(dev):
    """A dense engine on a (2, 2) thread gang loses a device: every request
    is evacuated, and the degraded engine serves on one device through the
    kernels (rows 1, 3, 6 and 13; the paged decode kernel is off), its
    tokens those of an unmeshed engine."""
    from k8s_gpu_workload_enhancer_tpu_torch import faultlab
    from k8s_gpu_workload_enhancer_tpu_torch.models import decode
    cfg, (params, _) = _serving_model(dev)
    ref = _graph_engine(dev, params, cfg, 0, cuda_graph=False)
    rid = ref.submit(list(range(1, 41)), 16)
    ref.run()
    want = ref.result(rid).tokens

    def rank(mesh):
        eng = _graph_engine(dev, decode.shard_params_for_serving(
            params, cfg, mesh), cfg, 0, mesh=mesh)
        if not mesh.is_driver:
            eng.follow()
            return None
        try:
            r0 = eng.submit(list(range(1, 41)), 16)
            for _ in range(16):
                eng.step()
                if eng.result(r0).tokens:
                    break
            faultlab.activate(faultlab.TargetedPlan(
                {"engine.device_loss": [0]}))
            try:
                eng.step()
            finally:
                faultlab.deactivate()
            kernels.reset_launches()
            r1 = eng.submit(list(range(1, 41)), 16)
            eng.run()
            return (eng.result(r0).finish_reason, eng.result(r1).tokens,
                    dict(kernels.launches), eng.mesh)
        finally:
            eng.stop_followers()
    finish, tokens, launches, mesh = _mesh_gang(2, 2, rank)
    assert finish == "migrated" and mesh is None
    for k in ("rms_norm", "rope", "flash_attention", "embed_gather"):
        assert launches.get(k, 0) > 0, launches
    assert "paged_decode" not in launches
    assert tokens == want
