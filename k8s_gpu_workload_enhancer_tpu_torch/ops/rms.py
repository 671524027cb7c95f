"""RMSNorm forward and backward: the hand-written CUDA kernels and their
plain versions.

Port of k8s_gpu_workload_enhancer_tpu/ops/rms_pallas.py: `rms_norm_pallas`
with its custom VJP, whose residuals are (x, weight) only and whose
backward recomputes rsqrt(var) from x. The kernels are in csrc/rms.cu; its
source note says what bounds them on the card and how the design answers
that.

`rms_norm` is differentiable (a `torch.autograd.Function`). Each direction
launches its kernel for a CUDA tensor and takes the plain version only for
a tensor on the CPU. The kernels take any width (past the register-resident
layouts the library runs its wide-row bodies). A CUDA tensor a kernel does
not take raises; nothing falls back quietly.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import kernels

KERNEL = "rms_norm"
KERNEL_BWD = "rms_norm_bwd"
# Partial dw rows the backward writes before its fixed-order final sum
# (csrc/rms.cu kBwdParts: 132 SMs x 4 blocks of its 64-register body);
# fixed, so dw's summation order never depends on the card.
BWD_PARTS = 528


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """f32 mean of squares, x * rsqrt(var + eps) * w in f32, cast back to
    x's dtype (ops/layers.py:40-44 of the JAX package)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rms_norm_backward_plain(x: torch.Tensor, weight: torch.Tensor,
                            dy: torch.Tensor, eps: float = 1e-6
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's function (`_rms_bwd_kernel`): with r =
    rsqrt(mean(x^2) + eps) and x_hat = x * r, all in f32,
    dx = r * (dy*w - x_hat * mean(dy*w*x_hat)) in x's dtype and
    dw = sum over all rows of dy * x_hat, in w's dtype."""
    xf, g = x.float(), dy.float()
    w = weight.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    xhat = xf * r
    dyw = g * w
    proj = torch.mean(dyw * xhat, dim=-1, keepdim=True)
    dx = (r * (dyw - xhat * proj)).to(x.dtype)
    dw = (g * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx, dw.to(weight.dtype)


def _check_weight(x: torch.Tensor, weight: torch.Tensor) -> int:
    if weight.device != x.device or weight.dtype not in kernels.DTYPE_CODES:
        raise ValueError("rms_norm weight must be a float tensor on x's "
                         "device")
    d = x.shape[-1]
    if weight.shape != (d,) or not weight.is_contiguous():
        raise ValueError(f"rms_norm weight must be contiguous ({d},), got "
                         f"{tuple(weight.shape)}")
    return d


def _rms_norm_cuda(x: torch.Tensor, weight: torch.Tensor,
                   eps: float) -> torch.Tensor:
    kernels.require(x, "rms_norm x")
    d = _check_weight(x, weight)
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    lib = kernels.library("rms")
    code = lib.ktwe_rms_norm_fwd(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d, float(eps),
        kernels.DTYPE_CODES[x.dtype], kernels.DTYPE_CODES[weight.dtype],
        x.device.index or 0, kernels.stream_handle(x))
    kernels.check(lib, KERNEL, code)
    kernels.launches[KERNEL] += 1
    return out


def _rms_norm_backward_cuda(x: torch.Tensor, weight: torch.Tensor,
                            dy: torch.Tensor, eps: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    kernels.require(x, "rms_norm_bwd x")
    kernels.require(dy, "rms_norm_bwd dy", dtypes=(x.dtype,))
    d = _check_weight(x, weight)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"rms_norm_bwd dy {tuple(dy.shape)} on {dy.device} "
                         f"must match x {tuple(x.shape)} on {x.device}")
    dx = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return dx, torch.zeros_like(weight)
    parts = min(rows, BWD_PARTS)
    partial = torch.empty((parts, d), dtype=torch.float32, device=x.device)
    dw = torch.empty_like(weight)
    lib = kernels.library("rms")
    code = lib.ktwe_rms_norm_bwd(
        x.data_ptr(), weight.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), dw.data_ptr(), rows, d, float(eps), parts,
        kernels.DTYPE_CODES[x.dtype], kernels.DTYPE_CODES[weight.dtype],
        x.device.index or 0, kernels.stream_handle(x))
    kernels.check(lib, KERNEL_BWD, code)
    kernels.launches[KERNEL_BWD] += 1
    return dx, dw


def rms_norm_forward(x: torch.Tensor, weight: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """The forward kernel (plain version for a CPU tensor), no autograd."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    return _rms_norm_cuda(x, weight, eps)


def rms_norm_backward(x: torch.Tensor, weight: torch.Tensor,
                      dy: torch.Tensor, eps: float = 1e-6
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) by the backward kernel (plain version for a CPU tensor)."""
    if x.device.type == "cpu":
        return rms_norm_backward_plain(x, weight, dy, eps)
    return _rms_norm_backward_cuda(x, weight, dy, eps)


class _RMSNorm(torch.autograd.Function):
    """Residuals are (x, weight) only, as in rms_pallas.py:141-147."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, weight)
        return rms_norm_forward(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_backward(x, weight, dy.contiguous(), ctx.eps)
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis of x (any leading shape), differentiable
    in x and weight. Where autograd records nothing (the serving path), the
    forward runs without the autograd.Function's host cost."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RMSNorm.apply(x, weight, eps)
    return rms_norm_forward(x, weight, eps)
