"""(B, S, H, D) <-> (B*H, S, D) relayout: the hand-written CUDA kernels and
their plain versions.

Port of k8s_gpu_workload_enhancer_tpu/ops/relayout.py: `to_t_layout`
(`_to_t_kernel`) into the flash kernels' flat layout and `from_t_layout`
(`_from_t_kernel`) back, each the other's VJP (a transpose's cotangent
rule is the inverse transpose). The kernels are csrc/relayout.cu; its
source note says what bounds them on the card and how the design answers
that. They take every shape and both float dtypes: the reference's tiling
gate (`relayout_supported`) has no counterpart here, and the model's
t-layout gate decides where they run.

Each entry launches its kernel for a CUDA tensor and takes the plain
version only for a tensor on the CPU; a CUDA input the kernel does not
take raises.
"""

from __future__ import annotations

import torch

from . import kernels

KERNEL_TO_T = "relayout_to_t"
KERNEL_FROM_T = "relayout_from_t"


def to_t_layout_plain(x: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) as a contiguous (B*H, S, D)."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).contiguous().view(b * h, s, d)


def from_t_layout_plain(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """x (B*H, S, D) as a contiguous (B, S, H, D)."""
    _, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(1, 2).contiguous()


def _relayout_cuda(x: torch.Tensor, b: int, h: int,
                   to_flat: bool) -> torch.Tensor:
    """x (B, S, H, D) -> (B*H, S, D) when `to_flat`, else x (B*H, S, D)
    -> (B, S, H, D)."""
    name = KERNEL_TO_T if to_flat else KERNEL_FROM_T
    kernels.require(x, f"{name} x")
    if to_flat:
        if x.dim() != 4:
            raise ValueError(f"{name} x must be (B, S, H, D), got "
                             f"{tuple(x.shape)}")
        b, s, h, d = x.shape
        out = torch.empty((b * h, s, d), dtype=x.dtype, device=x.device)
    else:
        if x.dim() != 3 or b <= 0 or h <= 0 or x.shape[0] != b * h:
            raise ValueError(f"{name} x must be (B*H, S, D) with B*H = "
                             f"{b} * {h}, got {tuple(x.shape)}")
        _, s, d = x.shape
        out = torch.empty((b, s, h, d), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    lib = kernels.library("relayout")
    code = lib.ktwe_relayout(x.data_ptr(), out.data_ptr(), b, s, h, d,
                             x.element_size(), int(to_flat),
                             x.device.index or 0, kernels.stream_handle(x))
    kernels.check(lib, name, code)
    kernels.launches[name] += 1
    return out


def to_t_forward(x: torch.Tensor) -> torch.Tensor:
    """`_to_t_kernel` (plain version for a CPU tensor), no autograd."""
    if x.device.type == "cpu":
        return to_t_layout_plain(x)
    return _relayout_cuda(x, 0, 0, True)


def from_t_forward(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """`_from_t_kernel` (plain version for a CPU tensor), no autograd."""
    if x.device.type == "cpu":
        return from_t_layout_plain(x, b, h)
    return _relayout_cuda(x, b, h, False)


class _ToT(torch.autograd.Function):
    """The cotangent goes back through `_from_t_kernel` (relayout.py:
    _to_t_bwd)."""

    @staticmethod
    def forward(ctx, x):
        ctx.b, ctx.h = x.shape[0], x.shape[2]
        return to_t_forward(x)

    @staticmethod
    def backward(ctx, g):
        return from_t_forward(g.contiguous(), ctx.b, ctx.h)


class _FromT(torch.autograd.Function):
    """The cotangent goes back through `_to_t_kernel` (relayout.py:
    _from_t_bwd)."""

    @staticmethod
    def forward(ctx, x, b, h):
        return from_t_forward(x, b, h)

    @staticmethod
    def backward(ctx, g):
        return to_t_forward(g.contiguous()), None, None


def to_t_layout(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B*H, S, D), the flash kernels' flat layout,
    differentiable in x."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ToT.apply(x)
    return to_t_forward(x)


def from_t_layout(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """(B*H, S, D) -> (B, S, H, D), differentiable in x."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _FromT.apply(x, b, h)
    return from_t_forward(x, b, h)
