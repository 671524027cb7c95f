"""Sort-based capacity-bounded MoE token dispatch (one device).

Port of k8s_gpu_workload_enhancer_tpu/ops/moe_dispatch.py. The dense
one-hot route of models/transformer.py `_moe_ffn` runs every token through
every expert; this one gives each expert a fixed-capacity window of the
tokens routed to it, so its FLOPs are ~capacity_factor x the dense FFN's:

  1. the top-1 expert id of each token,
  2. token indices stably sorted by expert id,
  3. each expert's window of C = capacity(N, E) slots of the sorted order,
     an (E, C) gather map built from the per-expert count cumsum,
  4. the batched expert FFN on (E, C, D),
  5. the results added back into the token rows, weighted by the router
     gate; tokens past an expert's capacity are dropped (their FFN output
     is zero, the residual stream carries them).

Plain torch on every device, no hand-written kernel: the JAX package
computes all of it outside any Pallas kernel (a sort, gathers, a scatter
and einsums that XLA lowers), so there is no TPU kernel to port. Shapes
depend only on (N, E, capacity_factor), never on the routing, and nothing
reads a device value on the host: the counts are a fixed-length
`scatter_add_` (`torch.bincount` on CUDA reads the input's max on the
host).
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch


def capacity(n_tokens: int, n_experts: int,
             capacity_factor: float = 1.25) -> int:
    """Per-expert token capacity, rounded up to a multiple of 8, at least
    8."""
    c = math.ceil(capacity_factor * n_tokens / n_experts)
    return max(8, -(-c // 8) * 8)


def ragged_dispatch(x2: torch.Tensor, expert_idx: torch.Tensor,
                    gate: torch.Tensor, n_experts: int,
                    ffn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                    capacity_factor: float = 1.25
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run `ffn(expert_ids, xs)` over capacity-bounded per-expert batches.

    x2:         (N, D) tokens (batch and sequence flattened).
    expert_idx: (N,) integer top-1 expert of each token.
    gate:       (N,) router weight of each token (applied to the output).
    ffn:        ((E,), (E, C, D)) -> (E, C, D), the batched expert FFN
                (expert weights indexed by the leading axis).

    Returns (y2 (N, D) in the FFN's dtype, dropped fraction f32 scalar).
    """
    n, d = x2.shape
    e = n_experts
    c = capacity(n, e, capacity_factor)
    dev = x2.device
    expert_idx = expert_idx.long()

    # Stable sort by expert id: token order within an expert is kept.
    sorted_experts, order = torch.sort(expert_idx, stable=True)

    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, expert_idx, torch.ones_like(expert_idx))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_expert = torch.arange(n, device=dev) - starts[sorted_experts]

    # (E, C) gather map into the sorted order; under-filled slots resolve
    # to index N, the pad row, so the gather reads zeros and the add below
    # writes into the discarded row.
    ar_c = torch.arange(c, device=dev)
    slot = starts[:, None] + ar_c[None, :]
    valid = ar_c[None, :] < counts[:, None]
    gather_idx = torch.where(valid, slot.clamp(0, n - 1), n)

    token_of_sorted = torch.cat([order, order.new_full((1,), n)])
    padded = torch.cat([x2, x2.new_zeros((1, d))], dim=0)
    token_idx = token_of_sorted[gather_idx]                 # (E, C)
    xs = padded[token_idx]                                  # (E, C, D)

    ys = ffn(torch.arange(e, device=dev), xs)               # (E, C, D)

    # At top-1 each valid (e, c) slot owns exactly one token and each
    # token at most one slot, so adding into zeros writes each kept
    # token's row once; only the pad row N takes several (and is cut).
    y2 = ys.new_zeros((n + 1, d)).index_add(
        0, token_idx.reshape(e * c), ys.reshape(e * c, d))[:n]
    y2 = y2 * gate[:, None].to(y2.dtype)

    kept = (pos_in_expert < c).float().sum()
    dropped_frac = 1.0 - kept / n
    return y2, dropped_frac
