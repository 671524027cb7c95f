"""Rotate-half RoPE: the hand-written CUDA kernel and its plain version.

Port of k8s_gpu_workload_enhancer_tpu/ops/rope_pallas.py:rope_rotate with
its custom VJP (`_rope_bwd`): a rotation's transpose is the inverse
rotation, so the backward is the same kernel with sin negated, and the
cos/sin tables get no gradient. The layout-emitting twins
(`rope_rotate_t`, `_rope_t_inv_kernel`) are not ported yet. The kernel is
csrc/rope.cu; its source note says what bounds it on the card and how the
design answers that.

`rope_rotate` launches the kernel for a CUDA tensor and takes the plain
version only for a tensor on the CPU. The kernel takes any even head_dim.
"""

from __future__ import annotations

import torch

from . import kernels

KERNEL = "rope"


def rope_rotate_plain(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) rotated in pairs (i, i + D/2) by f32 cos/sin (S, D/2):
    [x1*c - x2*s, x2*c + x1*s] in f32, cast back to x's dtype."""
    half = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    c = cos.float()[None, :, None, :]
    s = sin.float()[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _rope_rotate_cuda(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    kernels.require(x, "rope x")
    if x.dim() != 4 or x.shape[-1] % 2:
        raise ValueError(f"rope x must be (B, S, H, D) with even D, got "
                         f"{tuple(x.shape)}")
    b, s, h, d = x.shape
    for name, t in (("cos", cos), ("sin", sin)):
        if (t.device != x.device or t.dtype != torch.float32
                or not t.is_contiguous() or t.shape != (s, d // 2)):
            raise ValueError(f"rope {name} must be contiguous f32 "
                             f"({s}, {d // 2}) on x's device, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = kernels.library("rope")
    code = lib.ktwe_rope_fwd(
        x.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(), b, s, h,
        d // 2, kernels.DTYPE_CODES[x.dtype], x.device.index or 0,
        kernels.stream_handle(x))
    kernels.check(lib, KERNEL, code)
    kernels.launches[KERNEL] += 1
    return out


def rope_rotate_forward(x: torch.Tensor, cos: torch.Tensor,
                        sin: torch.Tensor) -> torch.Tensor:
    """The kernel (plain version for a CPU tensor), no autograd."""
    if x.device.type == "cpu":
        return rope_rotate_plain(x, cos, sin)
    return _rope_rotate_cuda(x, cos, sin)


class _RopeRotate(torch.autograd.Function):
    """Residuals are the tables only; the cotangent is rotated back by the
    same kernel with -sin (rope_pallas.py:82-85)."""

    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        return rope_rotate_forward(x, cos, sin)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        return rope_rotate_forward(g.contiguous(), cos, -sin), None, None


def rope_rotate(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """Rotate x (B, S, H, D) by the (S, D/2) tables (same math as
    ops/attention.apply_rope), differentiable in x. Where autograd records
    nothing (the serving path), the kernel runs without the
    autograd.Function's host cost."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _RopeRotate.apply(x, cos, sin)
    return rope_rotate_forward(x, cos, sin)
