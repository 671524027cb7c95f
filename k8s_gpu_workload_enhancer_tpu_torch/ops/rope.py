"""Rotate-half RoPE: the hand-written CUDA kernels and their plain versions.

Port of k8s_gpu_workload_enhancer_tpu/ops/rope_pallas.py: `rope_rotate`
with its custom VJP (`_rope_bwd`): a rotation's transpose is the inverse
rotation, so the backward is the same kernel with sin negated, and the
cos/sin tables get no gradient; and the layout-emitting twin
`rope_rotate_t` (`_rope_t_kernel`), which writes the flash kernels' flat
(B*H, S, D) layout, with its VJP `_rope_t_inv_kernel`, which reads a flat
cotangent and writes (B, S, H, D) rotated by -sin. The kernels are
csrc/rope.cu; its source note says what bounds them on the card and how
the design answers that.

Each entry launches its kernel for a CUDA tensor and takes the plain
version only for a tensor on the CPU. The kernels take any even head_dim,
and (S, D/2) f32 tables of any strides: contiguous ones, or the cos and
sin views of the model's (max_seq, D/2, 2) frequency table, which they
read in place (`ops/attention._tables`), so a rotation is one launch
forward and one backward.
"""

from __future__ import annotations

import torch

from . import kernels

KERNEL = "rope"
KERNEL_T = "rope_t"
KERNEL_T_INV = "rope_t_inv"
# The reference's sequence block (rope_pallas.DEFAULT_BLOCK_S) in its gate.
DEFAULT_BLOCK_S = 256


def rope_supported(x: torch.Tensor, block_s: int = DEFAULT_BLOCK_S) -> bool:
    """The reference's shape gate (ops/rope_pallas.py:rope_supported):
    (B, S, H, D) with D a multiple of 256 and S block-divisible, S >= 8."""
    if x.dim() != 4:
        return False
    _, s, _, d = x.shape
    return d % 256 == 0 and s % min(block_s, s) == 0 and s >= 8


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


def rope_rotate_t_plain(x: torch.Tensor, cos: torch.Tensor,
                        sin: torch.Tensor) -> torch.Tensor:
    """`rope_rotate_plain` of x (B, S, H, D), laid out (contiguous) as
    (B*H, S, D)."""
    b, s, h, d = x.shape
    return rope_rotate_plain(x, cos, sin).transpose(1, 2).contiguous().view(
        b * h, s, d)


def rope_rotate_t_inv_plain(g: torch.Tensor, cos: torch.Tensor,
                            sin: torch.Tensor, heads: int) -> torch.Tensor:
    """g (B*H, S, D) rotated by -sin, laid out as (B, S, H, D)."""
    bh, s, d = g.shape
    g4 = g.reshape(bh // heads, heads, s, d).permute(0, 2, 1, 3)
    return rope_rotate_plain(g4, cos, -sin).contiguous()


def _table_args(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                s: int, d: int, what: str) -> tuple:
    """The tables' addresses and strides as the kernels take them (cos,
    sin, then each one's row and element stride in floats)."""
    for name, t in (("cos", cos), ("sin", sin)):
        if (t.device != x.device or t.dtype != torch.float32
                or t.shape != (s, d // 2)):
            raise ValueError(f"{what} {name} must be f32 ({s}, {d // 2}) on "
                             f"x's device, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    return (cos.data_ptr(), sin.data_ptr(), *cos.stride(), *sin.stride())


def _rope_rotate_cuda(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                      inverse: bool = False) -> torch.Tensor:
    kernels.require(x, "rope x")
    if x.dim() != 4 or x.shape[-1] % 2:
        raise ValueError(f"rope x must be (B, S, H, D) with even D, got "
                         f"{tuple(x.shape)}")
    b, s, h, d = x.shape
    c_ptr, s_ptr, *strides = _table_args(x, cos, sin, s, d, "rope")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = kernels.library("rope")
    code = lib.ktwe_rope_fwd(
        x.data_ptr(), c_ptr, s_ptr, out.data_ptr(), b, s, h, d // 2,
        *strides, int(inverse), kernels.DTYPE_CODES[x.dtype],
        x.device.index or 0, kernels.stream_handle(x))
    kernels.check(lib, KERNEL, code)
    kernels.launches[KERNEL] += 1
    return out


def _rope_t_cuda(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 heads: int, to_flat: bool) -> torch.Tensor:
    """The t-layout kernels: x (B, S, H, D) -> (B*H, S, D) rotated when
    `to_flat`, else x (B*H, S, D) -> (B, S, H, D) rotated by -sin."""
    name = KERNEL_T if to_flat else KERNEL_T_INV
    kernels.require(x, f"{name} x")
    want_dim = 4 if to_flat else 3
    if x.dim() != want_dim or x.shape[-1] % 2:
        raise ValueError(f"{name} x must be {want_dim}-d with even D, got "
                         f"{tuple(x.shape)}")
    if to_flat:
        b, s, h, d = x.shape
        out = torch.empty((b * h, s, d), dtype=x.dtype, device=x.device)
    else:
        bh, s, d = x.shape
        h = heads
        if h <= 0 or bh % h:
            raise ValueError(f"{name}: heads {h} must divide {bh}")
        b = bh // h
        out = torch.empty((b, s, h, d), dtype=x.dtype, device=x.device)
    c_ptr, s_ptr, *strides = _table_args(x, cos, sin, s, d, name)
    if x.numel() == 0:
        return out
    lib = kernels.library("rope")
    code = lib.ktwe_rope_t(
        x.data_ptr(), c_ptr, s_ptr, out.data_ptr(), b, s, h, d // 2,
        *strides, int(to_flat), kernels.DTYPE_CODES[x.dtype],
        x.device.index or 0, kernels.stream_handle(x))
    kernels.check(lib, name, code)
    kernels.launches[name] += 1
    return out


def rope_rotate_t_forward(x: torch.Tensor, cos: torch.Tensor,
                          sin: torch.Tensor) -> torch.Tensor:
    """`_rope_t_kernel` (plain version for a CPU tensor), no autograd."""
    if x.device.type == "cpu":
        return rope_rotate_t_plain(x, cos, sin)
    return _rope_t_cuda(x, cos, sin, x.shape[2], True)


def rope_rotate_t_inverse(g: torch.Tensor, cos: torch.Tensor,
                          sin: torch.Tensor, heads: int) -> torch.Tensor:
    """`_rope_t_inv_kernel` (plain version for a CPU tensor): g (B*H, S,
    D) -> (B, S, H, D) rotated by -sin."""
    if g.device.type == "cpu":
        return rope_rotate_t_inv_plain(g, cos, sin, heads)
    return _rope_t_cuda(g, cos, sin, heads, False)


def rope_rotate_forward(x: torch.Tensor, cos: torch.Tensor,
                        sin: torch.Tensor,
                        inverse: bool = False) -> torch.Tensor:
    """The kernel (plain version for a CPU tensor), no autograd; with
    `inverse`, the rotation by -sin (the kernel negates sin as it reads
    it)."""
    if x.device.type == "cpu":
        return rope_rotate_plain(x, cos, -sin if inverse else sin)
    return _rope_rotate_cuda(x, cos, sin, inverse)


class _RopeRotate(torch.autograd.Function):
    """Residuals are the tables only; the cotangent is rotated back by the
    same kernel with -sin (rope_pallas.py:82-85), one launch."""

    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        return rope_rotate_forward(x, cos, sin)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        return (rope_rotate_forward(g.contiguous(), cos, sin, inverse=True),
                None, None)


def rope_rotate(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """Rotate x (B, S, H, D) by the (S, D/2) tables (same math as
    ops/attention.apply_rope), differentiable in x. Where autograd records
    nothing (the serving path), the kernel runs without the
    autograd.Function's host cost."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _RopeRotate.apply(x, cos, sin)
    return rope_rotate_forward(x, cos, sin)


class _RopeRotateT(torch.autograd.Function):
    """Residuals are the tables and the head count; the flat cotangent goes
    back through the inverse kernel (rope_pallas.py:202-204)."""

    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        ctx.heads = x.shape[2]
        return rope_rotate_t_forward(x, cos, sin)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        return (rope_rotate_t_inverse(g.contiguous(), cos, sin, ctx.heads),
                None, None)


def rope_rotate_t(x: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor) -> torch.Tensor:
    """`rope_rotate` that emits (B*H, S, D), flash_attention_t's layout;
    the cotangent flows back in that layout and returns in (B, S, H, D)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _RopeRotateT.apply(x, cos, sin)
    return rope_rotate_t_forward(x, cos, sin)
