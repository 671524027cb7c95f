"""Paged decode attention: the hand-written CUDA kernel and its plain
version.

Port of `paged_decode_attention` / `_paged_decode_kernel` of
k8s_gpu_workload_enhancer_tpu/ops/flash_attention.py: one decode step of
attention for every slot, reading the slot's K/V through its block table.
The kernel is csrc/paged_decode.cu; its source note says what bounds it on
the card and how the design answers that.

`paged_decode_attention` launches the kernel for CUDA tensors and takes the
plain version only for tensors on the CPU. The kernel takes f32 and bf16, a
head_dim that is a multiple of 8 up to 512, up to 16 query heads per kv
head and any block_len; a CUDA call outside that raises.
"""

from __future__ import annotations

import torch

from . import kernels
from .attention import NEG_INF

KERNEL = "paged_decode"
MAX_HEAD_DIM = 512
MAX_GROUP = 16


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


def _paged_decode_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, table: torch.Tensor,
                       pos: torch.Tensor, block_len: int) -> torch.Tensor:
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
    if h % kh or h // kh > MAX_GROUP:
        raise ValueError(f"paged_decode kv heads {kh} must divide {h} with "
                         f"at most {MAX_GROUP} query heads each")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"paged_decode head_dim {d} must be a multiple of 8 "
                         f"and at most {MAX_HEAD_DIM}")
    if b > 65535:
        raise ValueError("paged_decode batch must be <= 65535")
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = kernels.library("paged_decode")
    code = lib.ktwe_paged_decode_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), pos.data_ptr(), out.data_ptr(), b, h, kh, d, nb,
        bl, table.shape[1], float(d ** -0.5), kernels.DTYPE_CODES[q.dtype],
        q.device.index or 0, kernels.stream_handle(q))
    kernels.check(lib, KERNEL, code)
    kernels.launches[KERNEL] += 1
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
    return _paged_decode_cuda(q, k_pages, v_pages, table, pos,
                              int(block_len))
