"""Memory-efficient fused LM-head + softmax cross-entropy.

Port of k8s_gpu_workload_enhancer_tpu/ops/chunked_ce.py, plain torch as it
is XLA code in the JAX package. The final `hidden @ lm_head` would produce
(B, S, V) logits; this op never materializes them: the vocab axis is
processed in chunks with an online logsumexp, and the backward recomputes
each chunk's logits instead of storing them. Residuals are (hidden, head,
targets, lse). A vocab that the chunk does not divide takes a last chunk
whose start is clamped to V - chunk (re-reading some columns of the one
before it), with a `valid` mask that keeps the re-read columns out of the
sums and the gradient.

Matmul inputs stay in the hidden's dtype, with the logits taken to f32.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


def _head_chunk(head: torch.Tensor, off: int, chunk: int
                ) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """(D, chunk) slice of the (D, V) head whose start is clamped to
    [0, V - chunk], its start, and the (chunk,) mask of columns not already
    counted by an earlier chunk."""
    v = head.shape[1]
    start = min(max(off, 0), max(v - chunk, 0))
    hc = head[:, start:start + chunk]
    valid = (start + torch.arange(chunk, device=head.device)) >= off
    return hc, start, valid


def _gold_index(t1: torch.Tensor, off: int, start: int, chunk: int):
    local = t1 - start
    in_chunk = (t1 >= off) & (local < chunk)
    return torch.clamp(local, 0, chunk - 1), in_chunk


def _lse_and_gold(h2: torch.Tensor, head: torch.Tensor, t1: torch.Tensor,
                  chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online logsumexp over vocab chunks. h2 (N, D), t1 (N,). Returns
    (lse (N,), gold (N,)) f32."""
    n = h2.shape[0]
    m = torch.full((n,), NEG_INF, dtype=torch.float32, device=h2.device)
    l = torch.zeros((n,), dtype=torch.float32, device=h2.device)
    gold = torch.zeros((n,), dtype=torch.float32, device=h2.device)
    for off in range(0, head.shape[1], chunk):
        hc, start, valid = _head_chunk(head, off, chunk)
        lg = (h2 @ hc.to(h2.dtype)).float()
        lg = torch.where(valid[None, :], lg, NEG_INF)
        m_new = torch.maximum(m, lg.amax(dim=1))
        l = l * torch.exp(m - m_new) + torch.exp(lg - m_new[:, None]).sum(1)
        idx, in_chunk = _gold_index(t1, off, start, chunk)
        g = torch.gather(lg, 1, idx[:, None])[:, 0]
        gold = torch.where(in_chunk, g, gold)
        m = m_new
    return m + torch.log(torch.clamp_min(l, 1e-30)), gold


class _ChunkedSoftmaxXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, head, targets, chunk, cache_logits):
        b, s, d = hidden.shape
        h2 = hidden.reshape(b * s, d)
        t1 = targets.reshape(b * s).long()
        lg16 = None
        if cache_logits and chunk >= head.shape[1]:
            lg = (h2 @ head.to(h2.dtype)).float()
            lse = torch.logsumexp(lg, dim=1)
            gold = torch.gather(lg, 1, t1[:, None])[:, 0]
            lg16 = lg.to(torch.bfloat16)
        else:
            lse, gold = _lse_and_gold(h2, head, t1, chunk)
        ctx.chunk = chunk
        ctx.cached = lg16 is not None
        ctx.save_for_backward(hidden, head, targets, lse,
                              *((lg16,) if lg16 is not None else ()))
        return (lse - gold).mean()

    @staticmethod
    def backward(ctx, g):
        hidden, head, targets, lse = ctx.saved_tensors[:4]
        b, s, d = hidden.shape
        n = b * s
        h2 = hidden.reshape(n, d)
        t1 = targets.reshape(n).long()
        v = head.shape[1]
        scale = g.float() / n                       # d(mean nll)
        rows = torch.arange(n, device=h2.device)
        if ctx.cached:
            lg16 = ctx.saved_tensors[4]
            p = torch.exp(lg16.float() - lse[:, None])
            p[rows, t1] -= 1.0                      # p - onehot
            dlg = (p * scale).to(h2.dtype)
            hd = head.to(h2.dtype)
            dh = (dlg @ hd.T).float()
            dhead = (h2.T @ dlg).float()
            return (dh.reshape(b, s, d).to(hidden.dtype),
                    dhead.to(head.dtype), None, None, None)
        chunk = ctx.chunk
        dh = torch.zeros((n, d), dtype=torch.float32, device=h2.device)
        dhead = torch.zeros(head.shape, dtype=torch.float32,
                            device=head.device)
        for off in range(0, v, chunk):
            hc, start, valid = _head_chunk(head, off, chunk)
            hc = hc.to(h2.dtype)
            lg = (h2 @ hc).float()
            p = torch.exp(lg - lse[:, None])
            p = torch.where(valid[None, :], p, 0.0)   # overlap: no gradient
            idx, in_chunk = _gold_index(t1, off, start, chunk)
            p[rows[in_chunk], idx[in_chunk]] -= 1.0     # p - onehot
            dlg_c = (p * scale).to(h2.dtype)
            dh += (dlg_c @ hc.T).float()
            # Overlap columns carry a zero gradient, so adding the whole
            # chunk at its clamped start is exact.
            dhead[:, start:start + chunk] += (h2.T @ dlg_c).float()
        return (dh.reshape(b, s, d).to(hidden.dtype), dhead.to(head.dtype),
                None, None, None)


def chunked_softmax_xent(hidden: torch.Tensor, head: torch.Tensor,
                         targets: torch.Tensor, chunk: int = 8192,
                         cache_logits: bool = False) -> torch.Tensor:
    """Mean token NLL of softmax(hidden @ head) against targets, f32.

    hidden (B, S, D) activations, head (D, V) weights, targets (B, S). V
    need not be a chunk multiple (requires V >= chunk; callers clamp the
    chunk). `cache_logits` (single chunk only, chunk >= V) keeps the logits
    as bf16 residuals instead of recomputing them in the backward."""
    return _ChunkedSoftmaxXent.apply(hidden, head, targets, int(chunk),
                                     bool(cache_logits))
