"""Ring attention: sequence parallelism over the ``sp`` axis of a mesh.

Port of k8s_gpu_workload_enhancer_tpu/parallel/ring_attention.py. Each sp
rank holds its S/sp shard of Q, K and V (rank r the positions r*S/sp ...).
K and V travel around the sp group's ring: at step i rank r holds the
block of rank (r - i) mod sp, merges it into the online-softmax partials
(o, m, l) of its resident Q shard in f32, and passes it on to rank r + 1.

Causality is static per ring step, as in the JAX package: the diagonal
block (step 0) is causal, a strictly past block (src < r) is unmasked and
a future block is skipped, so the kernel's offsets stay 0 and no row ever
merges an empty block (each rank's first block is its diagonal one). A
block goes through the flash kernels' LSE entry point
(ops/flash_attention.flash_attention_lse) where the shard shapes pass the
port's `flash_supported` gate and the shards are equal in length, else
through the plain f32 block update (`block_update`); `use_flash` forces
either, as the reference's does (None: the kernels on a CUDA tensor).

`_Shift` is the differentiable neighbour exchange (the reference's
`ppermute`): its forward sends this rank's block to r + 1 and receives
r - 1's, its backward sends the gradient the other way. The ring's
backward is then plain autograd over the kernel-backed blocks. Every rank
takes part in every shift, forward and backward: a skipped block is tied
into the output's graph with a zero gradient (`_Tie`), so that the
shifts' backward runs on every rank of the ring.

`gathered_attention` is the JAX model's other attention over sp
(`use_ring_attention=False`): each rank gathers the whole sequence's K
and V from the sp ranks (one differentiable all-gather of both, whose
backward reduce-scatters dK and dV, `Comm.all_gather_grad`) and attends
its own queries over them at their global offsets, through `attention`:
on the card the flash kernels at Sq = S/sp, Sk = S and a nonzero
q_offset, where the ring's blocks run them at offsets 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.attention import NEG_INF, attention, repeat_kv
from ..ops.flash_attention import flash_attention_lse, flash_supported
from .comm import exchange

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def block_update(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                 q_offset: int, kv_offset: int, causal: bool) -> Partials:
    """The reference's `_block_update`: one K/V block merged into the
    partials in plain f32. q (B, Sq, H, D), k/v (B, Sk, H, D), o (B, Sq,
    H, D) f32, m and l (B, H, Sq) f32; offsets are the blocks' global
    positions (unmasked where not `causal`)."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    if causal:
        qi = q_offset + torch.arange(sq, device=q.device)[:, None]
        kj = kv_offset + torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qi >= kj, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    # A fully masked row: s == NEG_INF == m_new gives p == 1 spuriously.
    p = torch.where(s <= NEG_INF / 2, 0.0, p)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o * corr.transpose(1, 2)[..., None] + pv, m_new, l_new


def merge_lse(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
              out_b: torch.Tensor, lse_b: torch.Tensor) -> Partials:
    """A kernel block's (output, LSE) merged into the partials (the
    reference's `_merge_flash`): the block counts as one row of weight
    exp(lse_b - m_new) whose value is its normalised output."""
    m_new = torch.maximum(m, lse_b)
    corr = torch.exp(m - m_new)
    w = torch.exp(lse_b - m_new)
    o = (o * corr.transpose(1, 2)[..., None]
         + out_b.float() * w.transpose(1, 2)[..., None])
    return o, m_new, l * corr + w


def init_partials(q: torch.Tensor) -> Partials:
    """(o, m, l) before the first block: zeros, NEG_INF (finite), zeros."""
    b, sq, h, _ = q.shape
    return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, h, sq), dtype=torch.float32, device=q.device))


def finish(partials: Partials, dtype: torch.dtype) -> torch.Tensor:
    """The attention output from the merged partials, in `dtype`."""
    o, _, l = partials
    return (o / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
            ).to(dtype)


class _Tie(torch.autograd.Function):
    """Forward: `o` as it is. Backward: o's gradient, and a zero gradient
    for `block`, so that autograd runs the backward of the shift that
    delivered a skipped block on this rank too."""

    @staticmethod
    def forward(ctx, o, block):
        ctx.shape, ctx.dtype = block.shape, block.dtype
        return o.view_as(o)

    @staticmethod
    def backward(ctx, g):
        return g, g.new_zeros((), dtype=ctx.dtype).expand(ctx.shape)


def ring_uses_flash(q: torch.Tensor, k: torch.Tensor, causal: bool,
                    use_flash: Optional[bool] = None) -> bool:
    """Whether the blocks go through `flash_attention_lse`: the shards
    pass `flash_supported` and (causal) are equal in length, and
    `use_flash` is True, or None on a CUDA tensor."""
    ok = flash_supported(q, k, k) and (not causal or q.shape[1] == k.shape[1])
    want = q.is_cuda if use_flash is None else use_flash
    return ok and want


def ring_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              partials: Partials, rank: int, src: int, causal: bool = True,
              flash: bool = False) -> Partials:
    """One ring step of sp rank `rank`: the visiting K/V block of rank
    `src` classified (diagonal, past, future), run and merged into the
    partials of the resident Q shard (all shards equal in length). A
    future block under `causal` is skipped (its block tied in with a zero
    gradient, `_Tie`). Without `flash` the block is `block_update` at the
    shards' global offsets."""
    o, m, l = partials
    if causal and src > rank:
        return _Tie.apply(o, k), m, l
    diagonal = causal and src == rank
    if flash:
        out_b, lse_b = flash_attention_lse(q, k, v, diagonal)
        return merge_lse(o, m, l, out_b, lse_b)
    if not causal:
        return block_update(q, k, v, o, m, l, 0, 0, False)
    sq, sk = q.shape[1], k.shape[1]
    return block_update(q, k, v, o, m, l, rank * sq, src * sk, True)


def _ring_peers(group) -> Tuple[int, int]:
    """Global ranks of the next (r + 1) and previous (r - 1) ring ranks."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return (dist.get_global_rank(group, (r + 1) % n),
            dist.get_global_rank(group, (r - 1) % n))


class _Shift(torch.autograd.Function):
    """The ring's differentiable shift: forward sends to r + 1 and receives
    from r - 1, backward sends the gradient to r - 1 and receives from
    r + 1."""

    @staticmethod
    def forward(ctx, t, group):
        nxt, prv = _ring_peers(group)
        ctx.group, ctx.peers = group, (nxt, prv)
        return exchange(t, nxt, prv, group)

    @staticmethod
    def backward(ctx, g):
        nxt, prv = ctx.peers
        return exchange(g, prv, nxt, ctx.group), None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, causal: bool = True,
                   use_flash: Optional[bool] = None) -> torch.Tensor:
    """Attention of this sp rank's Q shard (B, S/sp, H, D) over the whole
    sequence, whose K/V shards (B, S/sp, KH, D) the sp ranks of `group`
    hold in rank order; -> (B, S/sp, H, D) in q's dtype. GQA is expanded
    before the ring. With no group, or one of size 1, it is `attention`."""
    sp = 1 if group is None else dist.get_world_size(group)
    if sp <= 1:
        return attention(q, k, v, causal=causal)
    n_rep = q.shape[2] // k.shape[2]
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"ring attention needs equal shards, got q "
                         f"{tuple(q.shape)} and k {tuple(k.shape)}")
    rank = dist.get_rank(group)
    flash = ring_uses_flash(q, k, causal, use_flash)
    kv = torch.stack([k, v])
    partials = init_partials(q)
    for step in range(sp):
        src = (rank - step) % sp
        partials = ring_step(q, kv[0], kv[1], partials, rank, src, causal,
                             flash)
        if step < sp - 1:
            kv = _Shift.apply(kv, group)
    return finish(partials, q.dtype)


def gathered_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       comm, causal: bool = True,
                       position_offset: int = 0) -> torch.Tensor:
    """Attention of this sp rank's Q shard (B, S/sp, H, D) over the whole
    sequence, without the ring: the K/V shards (B, S/sp, KH, D) of the sp
    ranks of `comm` (a parallel/comm.Comm, the ranks in sequence order)
    gathered in one differentiable all-gather, then `attention` with the
    shard's queries at global positions position_offset + rank * S/sp + i
    and the keys at position_offset + j. Under `causal` the K/V rows past
    the rank's last query are masked for all its queries: their dK and dV
    from this rank are exact zeros. -> (B, S/sp, H, D) in q's dtype."""
    kv = comm.all_gather_grad(torch.stack([k, v]), 2)
    return attention(q, kv[0], kv[1], causal=causal,
                     q_offset=position_offset + comm.rank * q.shape[1],
                     kv_offset=position_offset)
