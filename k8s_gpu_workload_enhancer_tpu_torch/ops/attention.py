"""Attention ops: dispatch to the flash kernel, and RoPE.

Port of k8s_gpu_workload_enhancer_tpu/ops/attention.py. Arrays are shaped
(batch, seq, heads, head_dim); GQA is supported (n_kv_heads divides
n_heads). Causal masking takes explicit `q_offset`/`kv_offset` global
positions, so a prefill chunk at an offset into a static cache masks both
the future and the cache's unwritten tail.

The JAX module's `attention_reference` has one counterpart here, the flash
kernel's plain version `flash_attention.flash_attention_plain` (the same
function, and the kernel's oracle); there is no second plain attention.
"""

from __future__ import annotations

import torch

from .rope import rope_rotate

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KH, D) -> (B, S, KH*n_rep, D) for GQA."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int = 0,
              kv_offset: int = 0) -> torch.Tensor:
    """Flash attention: the CUDA kernels on a CUDA tensor, their plain
    versions on the CPU. Unlike the JAX dispatch there is no shape gate:
    the forward kernel takes every shape the serving path gives it, Sq = 1
    and GQA included. Where autograd records (an input requires grad), the
    differentiable entry runs, forward and backward kernels, with GQA
    expanded first."""
    from .flash_attention import flash_attention, flash_attention_train
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return flash_attention_train(q, k, v, causal, q_offset, kv_offset)
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                           kv_offset=kv_offset)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """(max_seq, head_dim//2, 2) cos/sin table, f32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.stack([torch.cos(freqs), torch.sin(freqs)], dim=-1)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor,
               position_offset: int = 0) -> torch.Tensor:
    """x: (B, S, H, D); freqs: (max_seq, D/2, 2) from rope_frequencies.
    Rotate-half pairs (i, i + D/2), through the RoPE kernel on the card.
    The offset clamps to [0, max_seq - S] like the JAX dynamic slice."""
    s = x.shape[1]
    start = max(0, min(int(position_offset), freqs.shape[0] - s))
    fr = freqs[start:start + s]
    return rope_rotate(x, fr[..., 0].contiguous(), fr[..., 1].contiguous())
