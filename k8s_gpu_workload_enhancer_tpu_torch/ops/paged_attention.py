"""Paged decode attention: the hand-written CUDA kernel and its plain
version.

Port of `paged_decode_attention` / `_paged_decode_kernel` of
k8s_gpu_workload_enhancer_tpu/ops/flash_attention.py: one decode step of
attention for every slot, reading the slot's K/V through its block table.
The kernels are csrc/paged_decode.cu, a split-KV schedule: the split
kernel (`paged_decode_partials`) writes an f32 partial (m, l, acc) for every
split of the table's positions, the combine kernel
(`paged_decode_combine`) merges them in split order; the source note says
what bounds them on the card and how the design answers that.

`paged_decode_attention` launches both kernels, in one call into the
library, for CUDA tensors and takes the plain version only for tensors on
the CPU. The kernels take f32 and
bf16, any head_dim, any number of query heads per kv head and any
block_len; a CUDA call outside that raises.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from . import kernels
from .attention import NEG_INF

KERNEL = "paged_decode"
# The second kernel of every call: it merges the splits' partials.
KERNEL_COMBINE = "paged_decode_combine"


def paged_decode_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor, table: torch.Tensor,
                                 pos: torch.Tensor, *,
                                 block_len: int) -> torch.Tensor:
    """The kernel's function in plain torch: gather every slot's logical
    (MB * BL) view through its table row, then f32 scores times D^-0.5,
    positions past pos[b] masked to NEG_INF, the max clamped at
    NEG_INF / 2, p cast to V's dtype before the PV product, output divided
    by max(l, 1e-30)."""
    b, h, d = q.shape
    nb, bl, kh, _ = k_pages.shape
    if bl != block_len:
        raise ValueError(f"pages of {bl} rows, block_len {block_len}")
    g = h // kh
    j = torch.arange(table.shape[1] * bl, device=q.device)
    rows = table.long()[:, j // bl] * bl + j % bl                # (B, S)
    ka = k_pages.reshape(nb * bl, kh, d)[rows].float()           # (B, S, KH, D)
    va = v_pages.reshape(nb * bl, kh, d)[rows]
    qg = q.reshape(b, kh, g, d).float()       # query heads kv-head-major
    s = torch.einsum("bkgd,bskd->bkgs", qg, ka) * d ** -0.5
    s = torch.where((j[None, :] <= pos.long()[:, None])[:, None, None, :], s,
                    NEG_INF)
    m = torch.clamp_min(s.amax(dim=-1, keepdim=True), NEG_INF / 2)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_pages.dtype).float(),
                     va.float())
    return (o / torch.clamp_min(l, 1e-30)).reshape(b, h, d).to(q.dtype)


def paged_decode_combine_plain(part_acc: torch.Tensor,
                               part_ml: torch.Tensor,
                               dtype: torch.dtype) -> torch.Tensor:
    """The combine kernel's function in plain torch: partials (S, B, H, D)
    and (S, B, H, 2) (running max, sum; an empty split has sum 0 and an acc
    nobody reads) -> (B, H, D) in `dtype`: every split rescaled by
    exp(m_s - m) against the largest m (clamped at NEG_INF / 2), divided by
    max(l, 1e-30)."""
    m, l = part_ml[..., 0], part_ml[..., 1]
    live = l > 0
    mx = torch.where(live, m, NEG_INF / 2).amax(dim=0).clamp_min(NEG_INF / 2)
    w = torch.where(live, torch.exp(m - mx), 0.0)
    acc = torch.where(live[..., None], part_acc, 0.0)
    o = (w[..., None] * acc).sum(dim=0)
    return (o / torch.clamp_min((w * l).sum(dim=0), 1e-30)[..., None]).to(
        dtype)


@functools.lru_cache(maxsize=256)
def split_plan(b: int, h: int, kh: int, d: int, span: int,
               dtype: torch.dtype) -> tuple:
    """(positions a split, splits) the kernel takes for these shapes: a
    function of the table's static width `span` (MB * BL), never of pos,
    so a call can be captured in a CUDA graph."""
    lib = kernels.library(KERNEL)
    split_len = lib.ktwe_paged_decode_split_len(b, h, kh, d, span,
                                                kernels.DTYPE_CODES[dtype])
    if split_len <= 0:
        raise ValueError(f"paged_decode takes no split of ({b}, {h}, {kh}, "
                         f"{d}, span {span})")
    return split_len, -(-span // split_len)


def _check(q, k_pages, v_pages, table, pos, block_len) -> None:
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        kernels.require(t, f"paged_decode {name}")
    for name, t in (("table", table), ("pos", pos)):
        kernels.require(t, f"paged_decode {name}", dtypes=(torch.int32,))
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"paged_decode q must be (B, H, D) and pages "
                         f"(NB, BL, KH, D), got {tuple(q.shape)} / "
                         f"{tuple(k_pages.shape)}")
    b, h, d = q.shape
    nb, bl, kh, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d or bl != block_len:
        raise ValueError(f"paged_decode pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)} and block_len {block_len}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype or any(
            t.device != q.device for t in (k_pages, v_pages, table, pos)):
        raise ValueError("paged_decode q and pages must share dtype, and all "
                         "inputs one device")
    if table.dim() != 2 or table.shape[0] != b or table.shape[1] < 1 \
            or pos.shape != (b,):
        raise ValueError(f"paged_decode table {tuple(table.shape)} / pos "
                         f"{tuple(pos.shape)} must be (B, MB >= 1) / (B,) "
                         f"for B = {b}")
    if h % kh:
        raise ValueError(f"paged_decode kv heads {kh} must divide {h}")
    if b > 65535:
        raise ValueError("paged_decode batch must be <= 65535")


def _launch(q, k_pages, v_pages, table, pos, block_len, fused):
    """Check the arguments, size the partials' one scratch tensor and call
    the library: with `fused` both kernels (the output), else the split
    kernel alone (the partials)."""
    _check(q, k_pages, v_pages, table, pos, block_len)
    b, h, d = q.shape
    nb, bl, kh, _ = k_pages.shape
    split_len, splits = split_plan(b, h, kh, d, table.shape[1] * bl, q.dtype)
    # One scratch: the (S, B, H, 2) statistics, padded to 16 bytes, then
    # the (S, B, H, D) accumulators (addresses only on the main path, whose
    # host cost views would add to).
    n_ml = splits * b * h * 2
    n_pad = n_ml + -n_ml % 4
    ws = torch.empty(n_pad + splits * b * h * d, dtype=torch.float32,
                     device=q.device)
    ml_ptr, acc_ptr = ws.data_ptr(), ws.data_ptr() + 4 * n_pad
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), pos.data_ptr())
    tail = (b, h, kh, d, nb, bl, table.shape[1], split_len, float(d ** -0.5),
            kernels.DTYPE_CODES[q.dtype], q.device.index or 0,
            kernels.stream_handle(q))
    lib = kernels.library(KERNEL)
    if fused:
        out = torch.empty_like(q)
        code = lib.ktwe_paged_decode_fwd(*args, out.data_ptr(), acc_ptr,
                                         ml_ptr, *tail)
    else:
        code = lib.ktwe_paged_decode_split(*args, acc_ptr, ml_ptr, *tail)
    kernels.check(lib, KERNEL, code)
    kernels.launches[KERNEL] += 1
    if fused:
        kernels.launches[KERNEL_COMBINE] += 1
        return out
    return (ws[n_pad:].view(splits, b, h, d),
            ws[:n_ml].view(splits, b, h, 2))


def paged_decode_partials(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, table: torch.Tensor,
                          pos: torch.Tensor, *, block_len: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split kernel alone on CUDA tensors: every split's f32 partial,
    (S, B, H, D) acc and (S, B, H, 2) (running max, sum), S from
    `split_plan`; the arguments as for `paged_decode_attention`."""
    return _launch(q, k_pages, v_pages, table, pos, int(block_len), False)


def paged_decode_combine(part_acc: torch.Tensor, part_ml: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """The combine kernel for CUDA partials (the plain version for CPU
    ones): (B, H, D) in `dtype`."""
    if part_acc.device.type == "cpu":
        return paged_decode_combine_plain(part_acc, part_ml, dtype)
    for name, t in (("part_acc", part_acc), ("part_ml", part_ml)):
        kernels.require(t, f"paged_decode_combine {name}",
                        dtypes=(torch.float32,))
    if part_acc.dim() != 4 or part_ml.shape != (*part_acc.shape[:3], 2) \
            or part_ml.device != part_acc.device:
        raise ValueError(f"paged_decode_combine partials "
                         f"{tuple(part_acc.shape)} / {tuple(part_ml.shape)} "
                         f"must be (S, B, H, D) / (S, B, H, 2) on one device")
    splits, b, h, d = part_acc.shape
    out = torch.empty((b, h, d), dtype=dtype, device=part_acc.device)
    lib = kernels.library(KERNEL)
    code = lib.ktwe_paged_decode_combine(
        part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(), b * h, d,
        splits, kernels.DTYPE_CODES[dtype], part_acc.device.index or 0,
        kernels.stream_handle(part_acc))
    kernels.check(lib, KERNEL_COMBINE, code)
    kernels.launches[KERNEL_COMBINE] += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, table: torch.Tensor,
                           pos: torch.Tensor, *,
                           block_len: int) -> torch.Tensor:
    """One decode step of attention through a block table.

    q: (B, H, D) current-token queries, kv-head-major (query head h reads
    kv head h // (H / KH)); k_pages/v_pages: (NB, BL, KH, D) pool pages;
    table: (B, MB) int32 physical page ids (entries beyond a slot's
    reservation point at the trash page 0); pos: (B,) int32 per-slot write
    frontiers, whose K/V must already be written. Returns (B, H, D) in q's
    dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, table, pos,
                                            block_len=block_len)
    if q.numel() == 0:                  # no slot or no column: nothing to run
        _check(q, k_pages, v_pages, table, pos, int(block_len))
        return torch.empty_like(q)
    return _launch(q, k_pages, v_pages, table, pos, int(block_len), True)
