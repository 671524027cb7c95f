"""Fused LM-head + softmax cross-entropy: the hand-written CUDA kernels and
their plain versions.

Port of k8s_gpu_workload_enhancer_tpu/ops/fused_ce.py. The forward
(`_ce_fwd_kernel`) computes the logits tile by tile, folds them into a
per-row online logsumexp, picks the gold logit from the f32 tile and
writes only the bf16 logits stash; the backward (`_ce_bwd_kernel`) turns
the stash back into the softmax gradient, rounds it to bf16 (dlg, written
out) and contracts it with the head into dH, accumulated in f32 and stored
as bf16. dHead = h2^T dlg stays a plain product with f32 accumulation, as
the reference leaves it to XLA. Every rounding point of the reference is
kept, whatever the hidden dtype: gold and lse from the f32 logits, bf16
stash, bf16 dlg, bf16 dH cast to the hidden dtype. The kernels are
csrc/fused_ce.cu; its source note says what bounds them on the card and
how the design answers that.

`fused_lm_head_xent` launches the kernels for CUDA tensors and takes the
plain versions only for tensors on the CPU. The library picks the body by
dtype (`ce_body`): bf16 runs the tensor-core (wgmma + TMA) bodies, f32
the f32 pipes, which the f32 gates need for true f32 products. The port has no block-size
knobs: `fused_ce_supported` is the reference's shape gate at its 512/512
defaults, which decides between this op and the chunked one (ops/
chunked_ce.py) in the model's loss.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import kernels

KERNEL_FWD = "fused_ce_fwd"
KERNEL_BWD = "fused_ce_bwd"
# The tensor-core bodies (wgmma + TMA) that every bf16 call runs, counted
# beside the two names above; which body a call runs is the library's rule
# (`ktwe_fused_ce_wgmma`), written out in `ce_body`.
KERNEL_FWD_WGMMA = "fused_ce_fwd_wgmma"
KERNEL_BWD_WGMMA = "fused_ce_bwd_wgmma"
# Kernel codes of the library's tile query (csrc's `Kernel`).
CE_CODES = {KERNEL_FWD: 0, KERNEL_BWD: 1}
# The reference's block sizes (the same for its forward and backward),
# which its shape gate asks N and V to be cut into.
DEFAULT_BLOCK_N = DEFAULT_BLOCK_V = 512
# D must be a multiple of this (the f32 body's column tile).
TILE = 128


def _pick(total: int, preferred: int) -> int:
    b = preferred
    while b > 8 and total % b:
        b //= 2
    return b if total % b == 0 else 0


def fused_ce_supported(hidden: torch.Tensor, head: torch.Tensor) -> bool:
    """The reference's shape gate at its default blocks: hidden (B, S, D),
    head (D, V), D a multiple of 128 up to 4096, and N = B*S and V
    block-divisible."""
    if hidden.dim() != 3 or head.dim() != 2:
        return False
    b, s, d = hidden.shape
    v = head.shape[1]
    if head.shape[0] != d or d % 128 or d > 4096:
        return False
    return bool(_pick(b * s, DEFAULT_BLOCK_N) and _pick(v, DEFAULT_BLOCK_V))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def fused_ce_forward_plain(h2: torch.Tensor, head16: torch.Tensor,
                           t1: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """h2 (N, D) and head16 (D, V) in one dtype, targets t1 (N,) ->
    (lse (N,) f32, gold (N,) f32, stash (N, V) bf16): the f32 logits'
    logsumexp and target entry, and the logits rounded to bf16."""
    lg = h2.float() @ head16.float()
    m = lg.amax(dim=1)
    l = torch.exp(lg - m[:, None]).sum(dim=1)
    lse = m + torch.log(torch.clamp_min(l, 1e-30))
    gold = torch.gather(lg, 1, t1.long()[:, None])[:, 0]
    return lse, gold, lg.to(torch.bfloat16)


def fused_ce_dlg_plain(stash: torch.Tensor, lse: torch.Tensor,
                       t1: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The backward's first stage: dlg (N, V) = ((exp(stash - lse) -
    onehot) * scale) rounded to bf16. `scale` is the f32 one-element
    g / N."""
    p = torch.exp(stash.float() - lse[:, None])
    p[torch.arange(p.shape[0], device=p.device), t1.long()] -= 1.0
    return (p * scale.float()).to(torch.bfloat16)


def fused_ce_backward_plain(stash: torch.Tensor, head16: torch.Tensor,
                            lse: torch.Tensor, t1: torch.Tensor,
                            scale: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (dlg (N, V) bf16, dh (N, D) bf16): dlg from `fused_ce_dlg_plain`,
    then dh = dlg @ head16^T summed in f32 and rounded to bf16."""
    dlg = fused_ce_dlg_plain(stash, lse, t1, scale)
    dh = (dlg.float() @ head16.float().t()).to(torch.bfloat16)
    return dlg, dh


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def ce_body(dtype: torch.dtype) -> str:
    """The body both fused CE launchers run for `dtype`: bf16 the tensor
    cores (wgmma + TMA), f32 the f32 pipes (the library's rule,
    `ktwe_fused_ce_wgmma`)."""
    return "wgmma" if dtype == torch.bfloat16 else "f32 pipes"


def body_report(kernel: str, dtype: torch.dtype) -> dict:
    """Which body the library runs for `kernel` (KERNEL_FWD or KERNEL_BWD)
    and `dtype`, as its launchers decide, the tile of that body and the
    dynamic shared memory a block asks for."""
    lib = kernels.library("fused_ce")
    code = kernels.DTYPE_CODES[dtype]
    rows, cols, depth, stages, smem = (
        lib.ktwe_fused_ce_tile(CE_CODES[kernel], code, i) for i in range(5))
    return dict(body="wgmma" if lib.ktwe_fused_ce_wgmma(code)
                else "f32 pipes",
                instance=f"{rows} x {cols} tiles, {depth} deep, {stages} "
                         f"stage(s)",
                dynamic_smem_bytes=smem)


def _count(lib, kernel: str, wgmma_name: str, dtype: torch.dtype) -> None:
    kernels.launches[kernel] += 1
    if lib.ktwe_fused_ce_wgmma(kernels.DTYPE_CODES[dtype]):
        kernels.launches[wgmma_name] += 1


def _targets(t1: torch.Tensor, n: int, what: str) -> torch.Tensor:
    if t1.shape != (n,) or t1.device.type != "cuda" \
            or t1.is_floating_point():
        raise ValueError(f"{what} targets must be an ({n},) integer CUDA "
                         f"tensor, got {t1.dtype} {tuple(t1.shape)}")
    return t1.to(torch.int32).contiguous()


def _check_head(h_dtype, head16: torch.Tensor, d: int, what: str) -> int:
    kernels.require(head16, f"{what} head", dtypes=(h_dtype,))
    if head16.dim() != 2 or head16.shape[0] != d:
        raise ValueError(f"{what} head must be ({d}, V), got "
                         f"{tuple(head16.shape)}")
    v = head16.shape[1]
    if d % TILE or v % 8 or v == 0:
        raise ValueError(f"{what} takes D a multiple of {TILE} and V a "
                         f"positive multiple of 8, got D {d}, V {v}")
    return v


def _fused_ce_forward_cuda(h2, head16, t1):
    kernels.require(h2, "fused_ce_fwd h2")
    if h2.dim() != 2:
        raise ValueError(f"fused_ce_fwd h2 must be (N, D), got "
                         f"{tuple(h2.shape)}")
    n, d = h2.shape
    v = _check_head(h2.dtype, head16, d, "fused_ce_fwd")
    t32 = _targets(t1, n, "fused_ce_fwd")
    dev = h2.device
    stash = torch.empty((n, v), dtype=torch.bfloat16, device=dev)
    lse = torch.empty((n,), dtype=torch.float32, device=dev)
    gold = torch.empty((n,), dtype=torch.float32, device=dev)
    lib = kernels.library("fused_ce")
    dt = kernels.DTYPE_CODES[h2.dtype]
    splits = lib.ktwe_fused_ce_splits(n, v, dt)
    part = torch.empty((3, splits, n), dtype=torch.float32, device=dev)
    code = lib.ktwe_fused_ce_fwd(
        h2.data_ptr(), head16.data_ptr(), t32.data_ptr(), stash.data_ptr(),
        part.data_ptr(), lse.data_ptr(), gold.data_ptr(), n, d, v, splits,
        dt, dev.index or 0, kernels.stream_handle(h2))
    kernels.check(lib, KERNEL_FWD, code)
    _count(lib, KERNEL_FWD, KERNEL_FWD_WGMMA, h2.dtype)
    return lse, gold, stash


def _fused_ce_backward_cuda(stash, head16, lse, t1, scale):
    kernels.require(stash, "fused_ce_bwd stash", dtypes=(torch.bfloat16,))
    if stash.dim() != 2:
        raise ValueError(f"fused_ce_bwd stash must be (N, V), got "
                         f"{tuple(stash.shape)}")
    n = stash.shape[0]
    d = head16.shape[0] if head16.dim() == 2 else -1
    v = _check_head(head16.dtype, head16, d, "fused_ce_bwd")
    if stash.shape[1] != v:
        raise ValueError(f"fused_ce_bwd stash width {stash.shape[1]} is "
                         f"not the head's V {v}")
    for name, t, shape in (("lse", lse, (n,)), ("scale", scale, (1,))):
        kernels.require(t, f"fused_ce_bwd {name}", dtypes=(torch.float32,))
        if t.shape != shape:
            raise ValueError(f"fused_ce_bwd {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    t32 = _targets(t1, n, "fused_ce_bwd")
    dev = stash.device
    dlg = torch.empty((n, v), dtype=torch.bfloat16, device=dev)
    dh = torch.empty((n, d), dtype=torch.bfloat16, device=dev)
    lib = kernels.library("fused_ce")
    code = lib.ktwe_fused_ce_bwd(
        stash.data_ptr(), head16.data_ptr(), lse.data_ptr(), t32.data_ptr(),
        scale.data_ptr(), dlg.data_ptr(), dh.data_ptr(), n, d, v,
        kernels.DTYPE_CODES[head16.dtype], dev.index or 0,
        kernels.stream_handle(stash))
    kernels.check(lib, KERNEL_BWD, code)
    _count(lib, KERNEL_BWD, KERNEL_BWD_WGMMA, head16.dtype)
    return dlg, dh


def fused_ce_forward(h2: torch.Tensor, head16: torch.Tensor,
                     t1: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`_ce_fwd_kernel` (plain version for CPU tensors): (lse, gold,
    stash) as `fused_ce_forward_plain` returns them."""
    if h2.device.type == "cpu":
        return fused_ce_forward_plain(h2, head16, t1)
    return _fused_ce_forward_cuda(h2, head16, t1)


def fused_ce_backward(stash: torch.Tensor, head16: torch.Tensor,
                      lse: torch.Tensor, t1: torch.Tensor,
                      scale: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_ce_bwd_kernel` (plain version for CPU tensors): (dlg, dh) as
    `fused_ce_backward_plain` returns them."""
    if stash.device.type == "cpu":
        return fused_ce_backward_plain(stash, head16, lse, t1, scale)
    return _fused_ce_backward_cuda(stash, head16, lse, t1, scale)


def dhead_product(h2: torch.Tensor, dlg: torch.Tensor) -> torch.Tensor:
    """h2^T dlg (D, V) in f32: the bf16 products summed in f32 (one cuBLAS
    call with an f32 output on the card), as the reference's einsum with
    preferred_element_type=f32; an f32 h2 takes dlg's values in f32."""
    if h2.is_cuda and h2.dtype == torch.bfloat16:
        return torch.mm(h2.t(), dlg, out_dtype=torch.float32)
    return h2.float().t() @ dlg.float()


class _FusedLMHeadXent(torch.autograd.Function):
    """Residuals (hidden, head, targets, lse, stash), as the reference's
    custom VJP keeps them; the head is cast to the hidden dtype again in
    the backward."""

    @staticmethod
    def forward(ctx, hidden, head, targets):
        b, s, d = hidden.shape
        h2 = hidden.reshape(b * s, d)
        head16 = head.to(h2.dtype).contiguous()
        t1 = targets.reshape(b * s)
        lse, gold, stash = fused_ce_forward(h2, head16, t1)
        ctx.save_for_backward(hidden, head, t1, lse, stash)
        return (lse - gold).mean()

    @staticmethod
    def backward(ctx, g):
        hidden, head, t1, lse, stash = ctx.saved_tensors
        b, s, d = hidden.shape
        n = b * s
        h2 = hidden.reshape(n, d)
        head16 = head.to(h2.dtype).contiguous()
        scale = (g.float() / n).reshape(1)
        dlg, dh = fused_ce_backward(stash, head16, lse, t1, scale)
        dhead = dhead_product(h2, dlg)
        return (dh.reshape(b, s, d).to(hidden.dtype), dhead.to(head.dtype),
                None)


def fused_lm_head_xent(hidden: torch.Tensor, head: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Mean token NLL of softmax(hidden @ head) against targets, f32.

    hidden (B, S, D), head (D, V) in its master dtype (cast to the hidden
    dtype for the products), targets (B, S). Callers gate on
    `fused_ce_supported`. Numerics are the reference's: the forward
    statistics come from the f32 logits, the backward's softmax from the
    bf16 stash."""
    return _FusedLMHeadXent.apply(hidden, head, targets)
