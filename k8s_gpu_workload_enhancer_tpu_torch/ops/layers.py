"""Small layer ops (RMSNorm, SwiGLU, cross-entropy).

Port of k8s_gpu_workload_enhancer_tpu/ops/layers.py. RMSNorm goes to the
hand-written kernels for every CUDA tensor (ops/rms.py); the JAX package
launches its Pallas kernels only on a TPU, with the same math. SwiGLU's
three products stay plain matmuls and the cross-entropy plain torch, as
the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import rms


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    return rms.rms_norm(x, weight, eps)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: (silu(x @ w_gate) * (x @ w_up)) @ w_down. Shapes
    (..., D) x (D, F) x (D, F) x (F, D)."""
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    return torch.matmul(F.silu(g) * u, w_down)


class _SwigluLean(torch.autograd.Function):
    """`swiglu` whose backward keeps only x, the two matmul outputs (g, u)
    and the weights, and recomputes the silu product elementwise
    (layers.py:57-96 of the JAX package), with the same dtype casts."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down):
        g = torch.matmul(x, w_gate)
        u = torch.matmul(x, w_up)
        ctx.save_for_backward(x, g, u, w_gate, w_up, w_down)
        return torch.matmul(F.silu(g) * u, w_down)

    @staticmethod
    def backward(ctx, dy):
        x, g, u, w_gate, w_up, w_down = ctx.saved_tensors
        x2 = x.reshape(-1, x.shape[-1])
        g2, u2 = g.reshape(-1, g.shape[-1]), u.reshape(-1, u.shape[-1])
        dy2 = dy.reshape(-1, dy.shape[-1])
        gf = g2.float()
        sig = torch.sigmoid(gf)
        silu_g = (gf * sig).to(g.dtype)
        h = silu_g * u2                                  # recomputed
        dh = dy2 @ w_down.T
        dw_down = h.T @ dy2
        du = dh * silu_g
        # d silu(g)/dg = sigmoid(g) * (1 + g * (1 - sigmoid(g)))
        dsilu = (sig * (1.0 + gf * (1.0 - sig))).to(g.dtype)
        dg = dh * u2 * dsilu
        dx = dg @ w_gate.T + du @ w_up.T
        dw_gate = x2.T @ dg
        dw_up = x2.T @ du
        return dx.reshape(x.shape), dw_gate, dw_up, dw_down


def swiglu_lean(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """`swiglu` with the memory-lean backward (see `_SwigluLean`)."""
    return _SwigluLean.apply(x, w_gate, w_up, w_down)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL in f32. logits (B, S, V), targets (B, S) integer."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()
