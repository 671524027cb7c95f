"""Embedding gather: the hand-written CUDA kernel and its plain version.

Port of k8s_gpu_workload_enhancer_tpu/ops/embed_pallas.py: `embed_lookup`
(table (V, D) x ids -> (..., D) rows times a scale, f32 row math, cast to
the output dtype) with its custom VJP `_embed_bwd` (an f32 scatter-add
cast once to the table's dtype: plain torch, as the reference leaves it to
XLA). The kernel is csrc/embed.cu; its source note says what bounds it on
the card and how the design answers that.

`embed_tokens` is the model's embedding, the JAX model's
`params["embed"].astype(dt)[tokens] * math.sqrt(d_model)`
(models/transformer.py:310, decode.py:251, serving.py:286 and :738 of the
JAX package): there the product is weakly typed, so sqrt(d_model) is
rounded to the compute dtype first (45.25 for d 2048 in bf16), each row is
rounded to the compute dtype, multiplied in f32 and rounded once. Its VJP
is the one the model's autograd takes, in the compute dtype: the cotangent
times that scale, scatter-added into a table of the compute dtype, then
cast to the table's dtype.

Ids follow the JAX model's gather: a negative id wraps once by V, then the
forward clamps it into [0, V - 1] and the VJP drops it if it is still out
of range (XLA's gather clamps, its scatter skips). Each entry launches the
kernel for a CUDA table and takes the plain version only for a table on
the CPU; a CUDA input the kernel does not take raises.
"""

from __future__ import annotations

import functools
import math

import torch

from . import kernels

KERNEL = "embed_gather"
_ID_DTYPES = (torch.int32, torch.int64)


@functools.lru_cache(maxsize=64)
def embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to `dtype`, as JAX rounds the Python float of
    a weakly typed product (cached: the decode step asks every step)."""
    return float(torch.tensor(math.sqrt(d_model), dtype=torch.float64)
                 .to(dtype))


def gather_rows(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """The table rows the forward reads: ids wrapped once, then clamped."""
    ids = ids.long()
    return torch.where(ids < 0, ids + vocab, ids).clamp_(0, vocab - 1)


def scatter_rows(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """The rows the VJP adds into: ids wrapped once; those still out of
    range go to row `vocab`, one past the table, which is dropped."""
    ids = ids.long()
    w = torch.where(ids < 0, ids + vocab, ids)
    return torch.where((w >= 0) & (w < vocab), w, vocab)


def embed_gather_plain(table: torch.Tensor, ids: torch.Tensor, scale: float,
                       out_dtype: torch.dtype,
                       round_rows: bool = False) -> torch.Tensor:
    """out[n] = cast_out(f32(table[row(ids[n])]) * f32(scale)); with
    `round_rows`, each row is first rounded to `out_dtype`."""
    rows = table[gather_rows(ids, table.shape[0])]
    if round_rows:
        rows = rows.to(out_dtype)
    return (rows.float() * scale).to(out_dtype)


def _embed_gather_cuda(table: torch.Tensor, ids: torch.Tensor, scale: float,
                       out_dtype: torch.dtype,
                       round_rows: bool = False) -> torch.Tensor:
    kernels.require(table, "embed table")
    if table.dim() != 2 or table.shape[0] == 0:
        raise ValueError(f"embed table must be (V, D) with V > 0, got "
                         f"{tuple(table.shape)}")
    if out_dtype not in kernels.DTYPE_CODES:
        raise TypeError(f"embed output dtype {out_dtype} not taken by the "
                        f"kernel")
    if (ids.device != table.device or ids.dtype not in _ID_DTYPES
            or ids.dim() not in (1, 2)):
        raise ValueError(f"embed ids must be 1- or 2-d int32/int64 on the "
                         f"table's device, got {ids.dtype} "
                         f"{tuple(ids.shape)} on {ids.device}")
    v, d = table.shape
    out = torch.empty((*ids.shape, d), dtype=out_dtype, device=table.device)
    if out.numel() == 0:
        return out
    if ids.dim() == 2:
        cols, (s0, s1) = ids.shape[1], ids.stride()
    else:
        cols, s0, s1 = ids.shape[0], 0, ids.stride(0)
    lib = kernels.library("embed")
    code = lib.ktwe_embed_gather(
        table.data_ptr(), ids.data_ptr(), out.data_ptr(), ids.numel(), cols,
        s0, s1, v, d, float(scale), ids.element_size(), int(round_rows),
        kernels.DTYPE_CODES[table.dtype], kernels.DTYPE_CODES[out_dtype],
        table.device.index or 0, kernels.stream_handle(table))
    kernels.check(lib, KERNEL, code)
    kernels.launches[KERNEL] += 1
    return out


def embed_gather(table: torch.Tensor, ids: torch.Tensor, scale: float,
                 out_dtype: torch.dtype,
                 round_rows: bool = False) -> torch.Tensor:
    """The kernel (plain version for a CPU table), no autograd."""
    if table.device.type == "cpu":
        return embed_gather_plain(table, ids, scale, out_dtype, round_rows)
    return _embed_gather_cuda(table, ids, scale, out_dtype, round_rows)


class _EmbedLookup(torch.autograd.Function):
    """Residuals are the ids and the table's shape and dtype
    (embed_pallas.py:120-125); the VJP is `_embed_bwd`."""

    @staticmethod
    def forward(ctx, table, ids, scale, out_dtype):
        ctx.save_for_backward(ids)
        ctx.scale, ctx.vocab, ctx.table_dtype = scale, table.shape[0], \
            table.dtype
        return embed_gather(table, ids, scale, out_dtype)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        v, d = ctx.vocab, g.shape[-1]
        acc = torch.zeros((v + 1, d), dtype=torch.float32, device=g.device)
        acc.index_add_(0, scatter_rows(ids, v).reshape(-1),
                       g.reshape(-1, d).float() * ctx.scale)
        return acc[:v].to(ctx.table_dtype), None, None, None


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, scale: float,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """table (V, D) x ids (B, S) -> (B, S, D) out_dtype, scaled, with f32
    row math (`embed_pallas.embed_lookup`); differentiable in the table."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _EmbedLookup.apply(table, ids, float(scale), out_dtype)
    return embed_gather(table, ids, scale, out_dtype)


class _EmbedTokens(torch.autograd.Function):
    """The model's embedding; the VJP is the model autograd's, in the
    compute dtype (see the module note)."""

    @staticmethod
    def forward(ctx, table, ids, scale, dtype):
        ctx.save_for_backward(ids)
        ctx.scale, ctx.dtype, ctx.vocab, ctx.table_dtype = \
            scale, dtype, table.shape[0], table.dtype
        return embed_gather(table, ids, scale, dtype, round_rows=True)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        v, d = ctx.vocab, g.shape[-1]
        acc = torch.zeros((v + 1, d), dtype=ctx.dtype, device=g.device)
        acc.index_put_((scatter_rows(ids, v).reshape(-1),),
                       (g * ctx.scale).reshape(-1, d), accumulate=True)
        return acc[:v].to(ctx.table_dtype), None, None, None


def embed_tokens(table: torch.Tensor, ids: torch.Tensor, d_model: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """The model's embedding of token ids (B, S) or (B,): rows of `table`
    rounded to `dtype`, times sqrt(d_model) rounded to `dtype`, in f32,
    rounded once to `dtype`. Differentiable in the table; where autograd
    records nothing (the serving path), the kernel runs without the
    autograd.Function's host cost."""
    scale = embed_scale(d_model, dtype)
    if torch.is_grad_enabled() and table.requires_grad:
        return _EmbedTokens.apply(table, ids, scale, dtype)
    return embed_gather(table, ids, scale, dtype, round_rows=True)
