"""Flash attention forward and backward: the hand-written CUDA kernels
and their plain versions.

Port of k8s_gpu_workload_enhancer_tpu/ops/flash_attention.py: the forward
(`flash_attention` / `_flash_kernel`) and its custom VJP, the backward of
`_flash_backward_flat` (the dQ kernel with its optional p/ds stash, then
dK/dV either from that stash or recomputed, chosen by the same
`PDS_STASH_LIMIT_BYTES` gate). The paged decode kernel belongs to the
paged engine (ops/paged_attention.py). The kernels are
csrc/flash_attention.cu and csrc/flash_attention_bwd.cu; their source
notes say what bounds them on the card and how the designs answer that.
bf16 calls run tensor-core (wgmma + TMA) bodies: the forward, dQ and the
stash dK/dV at every head_dim, the recompute dK/dV at head_dim <= 128.
`launches` counts those launches under KERNEL_WGMMA, KERNEL_BWD_DQ_WGMMA,
KERNEL_BWD_DKV_WGMMA and KERNEL_BWD_DKV_STASH_WGMMA, beside each kernel's
own name.

`flash_attention` is the forward alone (the serving path): it takes any
Sq >= 1, any Sk, GQA natively (KH dividing H) and any head_dim: the
kernels take multiples of 8 (above 512 in column-sliced f32-pipe bodies,
in either dtype), and the wrapper zero-pads any other head_dim to the next
multiple of 8 (zero columns change no score and no kept output; the scale
stays the true D^-0.5) and slices the result back. `flash_attention_train`
is differentiable: it expands GQA first, as the JAX kernels require, and
its backward takes the same head dims the same way. `flash_attention_lse`
(MHA, offsets 0) returns the LSE beside the output and takes a cotangent
of each, the LSE's folded into the backward's delta (the reference's
`flash_attention_lse`, which ring attention's blocks run through,
parallel/ring_attention.py). `flash_attention_t` is the differentiable entry
on the kernels' flat (B*H, S, D) layout (the reference's
`flash_attention_t`, training offsets 0), which the model's t-layout path
feeds from `rope_rotate_t`; `flash_supported` is the reference's shape
gate for that path. Each launches its kernels for CUDA tensors and takes
the plain versions only for tensors on the CPU; a CUDA call outside what
the kernels take raises.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from . import kernels
from .attention import NEG_INF, attention, repeat_kv

KERNEL = "flash_attention"
# The tensor-core body (wgmma + TMA) that every bf16 forward launch runs;
# f32 runs the f32-pipe body. `KERNEL` counts both.
KERNEL_WGMMA = "flash_attention_wgmma"
KERNEL_BWD_DQ = "flash_attention_bwd_dq"
KERNEL_BWD_DKV = "flash_attention_bwd_dkv"
KERNEL_BWD_DKV_STASH = "flash_attention_bwd_dkv_stash"
# The tensor-core bodies (wgmma + TMA) that bf16 calls run (dQ and the
# stash dK/dV at every head_dim, the recompute dK/dV at head_dim <= 128),
# counted beside the three names above; which body a call runs is the
# library's rule (`bwd_body`).
KERNEL_BWD_DQ_WGMMA = "flash_attention_bwd_dq_wgmma"
KERNEL_BWD_DKV_WGMMA = "flash_attention_bwd_dkv_wgmma"
KERNEL_BWD_DKV_STASH_WGMMA = "flash_attention_bwd_dkv_stash_wgmma"
# Kernel codes of the backward library's body queries (csrc's `Which`).
BWD_CODES = {KERNEL_BWD_DQ: 0, KERNEL_BWD_DKV: 1, KERNEL_BWD_DKV_STASH: 2}
LSE_MASKED = 1e30
# The widest head_dim the tensor-core (wgmma) bodies take; above it bf16
# runs the column-sliced f32-pipe bodies, which the wgmma counters skip.
MAX_HEAD_DIM_WGMMA = 512
# The reference's preferred and fallback flash block sizes, which its shape
# gate `flash_supported` asks a sequence to divide.
DEFAULT_BLOCK_Q = DEFAULT_BLOCK_K = 512
FALLBACK_BLOCK = 256
# Ceiling for the backward's transient p/ds stash, as in the JAX module:
# above it dK/dV recompute s, p and dp instead of reading the stash.
PDS_STASH_LIMIT_BYTES = int(1.2e9)

Result = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _pick_block(seq: int, preferred: int) -> int:
    for cand in (preferred, FALLBACK_BLOCK):
        b = min(cand, seq)
        if seq % b == 0:
            return b
    return 0


def flash_supported(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> bool:
    """The reference's shape gate (ops/flash_attention.py:flash_supported):
    (B, S, H, D) with D a multiple of 128, both sequences block-divisible,
    MHA."""
    if q.dim() != 4 or k.shape != v.shape:
        return False
    _, sq, h, d = q.shape
    sk = k.shape[1]
    if d % 128:
        return False
    bq = _pick_block(sq, DEFAULT_BLOCK_Q)
    bk = _pick_block(sk, DEFAULT_BLOCK_K)
    if bq == 0 or bk == 0 or bq % 8 or bk % 8:
        return False
    return h == k.shape[2]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, q_offset: int = 0,
                          kv_offset: int = 0,
                          return_lse: bool = False) -> Result:
    """The kernel's function in plain torch: f32 scores times D^-0.5,
    NEG_INF masking on global positions, the max clamped at NEG_INF / 2 (a
    fully masked row gives zeros), P cast to V's dtype before the PV
    product, output divided by max(l, 1e-30). LSE is (B, H, Sq) f32."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    kk = repeat_kv(k, h // kh)
    vv = repeat_kv(v, h // kh)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * d ** -0.5
    if causal:
        qi = q_offset + torch.arange(sq, device=q.device)[:, None]
        kj = kv_offset + torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qi >= kj, s, NEG_INF)
    m = torch.clamp_min(s.amax(dim=-1, keepdim=True), NEG_INF / 2)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)                                        # (B, H, Sq)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vv.float())
    o = o / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
    out = o.to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m[..., 0] + torch.log(torch.clamp_min(l, 1e-30)),
                      torch.full_like(l, LSE_MASKED))
    return out, lse


def _pad_head_dim(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Zero-pad the last axis to a multiple of 8, the kernels' head_dim
    granularity (contiguous copies; the tensors as they are otherwise)."""
    pad = -ts[0].shape[-1] % 8
    if not pad:
        return ts
    return tuple(torch.nn.functional.pad(t, (0, pad)) for t in ts)


def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, q_offset: int, kv_offset: int,
                          return_lse: bool) -> Result:
    for name, t in (("q", q), ("k", k), ("v", v)):
        kernels.require(t, f"flash_attention {name}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention {name} must be (B, S, H, D), "
                             f"got {tuple(t.shape)}")
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention k/v {tuple(k.shape)} / "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device \
            or v.device != q.device:
        raise ValueError("flash_attention q, k, v must share dtype and device")
    if h % kh:
        raise ValueError(f"flash_attention kv heads {kh} must divide {h}")
    if b > 65535 or h > 65535:
        raise ValueError("flash_attention batch and heads must be <= 65535")
    qp, kp, vp = _pad_head_dim(q, k, v)
    dp = qp.shape[-1]
    out = torch.empty_like(qp)
    lse: Optional[torch.Tensor] = (
        torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        if return_lse else None)
    if q.numel() and sk:
        lib = kernels.library("flash_attention")
        code = lib.ktwe_flash_attention_fwd(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None, b, sq, sk, h, kh, dp,
            int(bool(causal)), int(q_offset), int(kv_offset), float(d ** -0.5),
            kernels.DTYPE_CODES[q.dtype], q.device.index or 0,
            kernels.stream_handle(q))
        kernels.check(lib, KERNEL, code)
        kernels.launches[KERNEL] += 1
        # The launcher's choice of body.
        if q.dtype == torch.bfloat16 and dp <= MAX_HEAD_DIM_WGMMA:
            kernels.launches[KERNEL_WGMMA] += 1
    elif q.numel():
        raise ValueError("flash_attention needs at least one key")
    if dp != d:
        out = out[..., :d].contiguous()
    return (out, lse) if return_lse else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0,
                    kv_offset: int = 0, return_lse: bool = False) -> Result:
    """q (B, Sq, H, D), k/v (B, Sk, KH, D) -> (B, Sq, H, D) in q's dtype
    (plus LSE (B, H, Sq) f32 with return_lse). Global positions are
    q_offset + i and kv_offset + j."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, int(q_offset),
                                     int(kv_offset), return_lse)
    return _flash_attention_cuda(q, k, v, causal, int(q_offset),
                                 int(kv_offset), return_lse)


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------


def backward_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (B, H, Sq): plain torch, as it is
    XLA in the JAX package."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_bwd_probs_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lse: torch.Tensor, do: torch.Tensor,
                          delta: torch.Tensor, causal: bool = True,
                          q_offset: int = 0, kv_offset: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the dQ kernel stashes, (B, H, Sq, Sk) in f32: p = exp(s - lse)
    from f32 scores times D^-0.5 with NEG_INF past the diagonal, and ds =
    p * (dp - delta) * scale rounded to q's dtype."""
    d = q.shape[-1]
    sq, sk = q.shape[1], k.shape[1]
    scale = d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qi = q_offset + torch.arange(sq, device=q.device)[:, None]
        kj = kv_offset + torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qi >= kj, s, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    return p, ds


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=True, q_offset=0,
                       kv_offset=0, stash=False):
    """The dQ kernel's function (`flash_bwd_dq`): dq = ds K in f32, cast to
    q's dtype, and with `stash` the p and ds stashes (B*H, Sq, Sk) in dO's
    and q's dtypes (zeros past the diagonal), else None."""
    p, ds = flash_bwd_probs_plain(q, k, v, lse, do, delta, causal, q_offset,
                                  kv_offset)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)
    if not stash:
        return dq, None, None
    b, sq, h, _ = q.shape
    flat = (b * h, sq, k.shape[1])
    return dq, p.to(do.dtype).reshape(flat), ds.to(q.dtype).reshape(flat)


def flash_bwd_dkv_from_stash_plain(q, k, v, do, p_stash, ds_stash,
                                   causal=True, q_offset=0, kv_offset=0):
    """The stash dK/dV kernel's function (`flash_bwd_dkv_from_stash`):
    dk = ds^T Q and dv = p^T dO from the stashes, f32 sums, in k's and v's
    dtypes. The masking is already in the stashes."""
    b, sq, h, _ = q.shape
    full = (b, h, sq, k.shape[1])
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_stash.reshape(full).float(),
                      q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p_stash.reshape(full).float(),
                      do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=True, q_offset=0,
                        kv_offset=0):
    """The recompute dK/dV kernel's function (`flash_bwd_dkv`): p and ds
    recomputed, p cast to dO's dtype and ds to q's before the products."""
    p, ds = flash_bwd_probs_plain(q, k, v, lse, do, delta, causal, q_offset,
                                  kv_offset)
    return flash_bwd_dkv_from_stash_plain(q, k, v, do, p.to(do.dtype),
                                          ds.to(q.dtype))


def _delta(o: torch.Tensor, do: torch.Tensor,
           g_lse: Optional[torch.Tensor]) -> torch.Tensor:
    """The backward's delta with an LSE cotangent folded in: ds = p (dp -
    delta + g_lse), since dlse/ds = p (the reference's `delta - g_lse`)."""
    delta = backward_delta(o, do)
    return delta if g_lse is None else delta - g_lse.float()


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, o: torch.Tensor,
                                   lse: torch.Tensor, do: torch.Tensor,
                                   causal: bool = True, q_offset: int = 0,
                                   kv_offset: int = 0,
                                   g_lse: Optional[torch.Tensor] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """The backward kernels' function in plain torch, with their rounding
    points: delta = rowsum(dO * O) in f32 (minus `g_lse`, the LSE
    output's cotangent (B, H, Sq), where one is given), p and ds as
    `flash_bwd_probs_plain` makes them, ds in q's dtype before the dQ and
    dK products, p cast to dO's dtype before the dV product, f32 sums.
    q/o/dO (B, Sq, H, D), k/v (B, Sk, H, D) (MHA), lse (B, H, Sq) f32.
    Returns (dq, dk, dv) in q's, k's, v's dtypes."""
    args = (causal, q_offset, kv_offset)
    dq, p_st, ds_st = flash_bwd_dq_plain(q, k, v, do, lse,
                                         _delta(o, do, g_lse), *args,
                                         stash=True)
    dk, dv = flash_bwd_dkv_from_stash_plain(q, k, v, do, p_st, ds_st, *args)
    return dq, dk, dv


def stash_bytes(q: torch.Tensor, k: torch.Tensor, do: torch.Tensor) -> int:
    """Bytes of the p stash (in dO's dtype) plus the ds stash (in q's
    dtype), sized as the JAX module sizes them."""
    b, sq, h, _ = q.shape
    return b * h * sq * k.shape[1] * (do.element_size() + q.element_size())


def bwd_body(kernel: str, d: int, dtype: torch.dtype) -> dict:
    """Which body the backward library runs for `kernel` (a KERNEL_BWD_*
    name) at head_dim `d` and `dtype`, as its launcher decides: wgmma
    (tensor cores) or the f32 pipes, the instance (the widest head_dim it
    takes) and the dynamic shared memory a block asks for."""
    lib = kernels.library("flash_attention_bwd")
    args = (BWD_CODES[kernel], d, kernels.DTYPE_CODES[dtype])
    return dict(body="wgmma" if lib.ktwe_flash_bwd_wgmma(*args)
                else "f32 pipes",
                instance=f"d<={lib.ktwe_flash_bwd_dmax(*args)}",
                dynamic_smem_bytes=lib.ktwe_flash_bwd_smem(*args))


def _count_bwd(lib, kernel: str, wgmma_name: str, d: int,
               dtype: torch.dtype) -> None:
    kernels.launches[kernel] += 1
    if lib.ktwe_flash_bwd_wgmma(BWD_CODES[kernel], d,
                                kernels.DTYPE_CODES[dtype]):
        kernels.launches[wgmma_name] += 1


def _check_bwd(q, k, v, do, lse, delta=None,
               pad_ok=False) -> Tuple[int, ...]:
    """Checks shared by the backward wrappers; (b, sq, sk, h, d). With
    `pad_ok` any head_dim passes (the caller pads it)."""
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        kernels.require(t, f"flash_attention_bwd {name}", dtypes=(q.dtype,))
        if t.dim() != 4 or t.device != q.device:
            raise ValueError(f"flash_attention_bwd {name} must be (B, S, H, D) "
                             f"on q's device, got {tuple(t.shape)}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if do.shape != q.shape:
        raise ValueError("flash_attention_bwd do must match q's shape")
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention_bwd k/v {tuple(k.shape)} / "
                         f"{tuple(v.shape)} must be MHA over q "
                         f"{tuple(q.shape)}: expand GQA first")
    if d % 8 and not pad_ok:
        raise ValueError(f"flash_attention_bwd head_dim {d} must be a "
                         f"multiple of 8 (flash_attention_backward pads "
                         f"other head dims)")
    if b > 65535 or h > 65535:
        raise ValueError("flash_attention_bwd batch and heads must be "
                         "<= 65535")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is None:
            continue
        kernels.require(t, f"flash_attention_bwd {name}",
                        dtypes=(torch.float32,))
        if t.shape != (b, h, sq) or t.device != q.device:
            raise ValueError(f"flash_attention_bwd {name} must be "
                             f"({b}, {h}, {sq}) f32 on q's device, got "
                             f"{tuple(t.shape)}")
    return b, sq, sk, h, d


def flash_bwd_dq(q, k, v, do, lse, delta, causal=True, q_offset=0,
                 kv_offset=0, stash=False, scale=None):
    """The dQ kernel on CUDA tensors: (dq, p_stash, ds_stash), the stashes
    (B*H, Sq, Sk) in dO's and q's dtypes when `stash`, else None. `scale`
    defaults to head_dim^-0.5 (a padded call passes the true one)."""
    b, sq, sk, h, d = _check_bwd(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    p_st = ds_st = None
    if stash:
        p_st = torch.empty((b * h, sq, sk), dtype=do.dtype, device=q.device)
        ds_st = torch.empty((b * h, sq, sk), dtype=q.dtype, device=q.device)
    lib = kernels.library("flash_attention_bwd")
    code = lib.ktwe_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        p_st.data_ptr() if stash else None,
        ds_st.data_ptr() if stash else None, b, sq, sk, h, d,
        int(bool(causal)), int(q_offset), int(kv_offset),
        float(d ** -0.5 if scale is None else scale),
        kernels.DTYPE_CODES[q.dtype], q.device.index or 0,
        kernels.stream_handle(q))
    kernels.check(lib, KERNEL_BWD_DQ, code)
    _count_bwd(lib, KERNEL_BWD_DQ, KERNEL_BWD_DQ_WGMMA, d, q.dtype)
    return dq, p_st, ds_st


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, q_offset=0,
                  kv_offset=0, scale=None):
    """The recompute dK/dV kernel on CUDA tensors: (dk, dv); `scale` as for
    `flash_bwd_dq`."""
    b, sq, sk, h, d = _check_bwd(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = kernels.library("flash_attention_bwd")
    code = lib.ktwe_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
        sq, sk, h, d, int(bool(causal)), int(q_offset), int(kv_offset),
        float(d ** -0.5 if scale is None else scale),
        kernels.DTYPE_CODES[q.dtype], q.device.index or 0,
        kernels.stream_handle(q))
    kernels.check(lib, KERNEL_BWD_DKV, code)
    _count_bwd(lib, KERNEL_BWD_DKV, KERNEL_BWD_DKV_WGMMA, d, q.dtype)
    return dk, dv


def flash_bwd_dkv_from_stash(q, k, v, do, p_stash, ds_stash, causal=True,
                             q_offset=0, kv_offset=0):
    """The stash dK/dV kernel on CUDA tensors, from the stashes the dQ
    kernel wrote for the same arguments: (dk, dv). k and v give only the
    shapes of the results."""
    b, sq, sk, h, d = _check_bwd(q, k, v, do, None)
    for name, t, dt in (("p_stash", p_stash, do.dtype),
                        ("ds_stash", ds_stash, q.dtype)):
        kernels.require(t, f"flash_attention_bwd {name}", dtypes=(dt,))
        if t.shape != (b * h, sq, sk) or t.device != q.device:
            raise ValueError(f"flash_attention_bwd {name} must be "
                             f"({b * h}, {sq}, {sk}), got {tuple(t.shape)}")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = kernels.library("flash_attention_bwd")
    code = lib.ktwe_flash_bwd_dkv_stash(
        q.data_ptr(), do.data_ptr(), p_stash.data_ptr(), ds_stash.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, d, int(bool(causal)),
        int(q_offset), int(kv_offset), kernels.DTYPE_CODES[q.dtype],
        q.device.index or 0, kernels.stream_handle(q))
    kernels.check(lib, KERNEL_BWD_DKV_STASH, code)
    _count_bwd(lib, KERNEL_BWD_DKV_STASH, KERNEL_BWD_DKV_STASH_WGMMA, d,
               q.dtype)
    return dk, dv


def _flash_attention_backward_cuda(q, k, v, o, lse, do, causal, q_offset,
                                   kv_offset, g_lse):
    b, sq, sk, h, d = _check_bwd(q, k, v, do, lse, pad_ok=True)
    kernels.require(o, "flash_attention_bwd o", dtypes=(q.dtype,))
    if o.shape != q.shape or o.device != q.device:
        raise ValueError("flash_attention_bwd o must match q's shape")
    if q.numel() == 0 or sk == 0:
        return (torch.zeros_like(q), torch.zeros_like(k),
                torch.zeros_like(v))
    if g_lse is not None and (g_lse.shape != lse.shape
                              or g_lse.device != q.device):
        raise ValueError(f"flash_attention_bwd g_lse must be "
                         f"{tuple(lse.shape)} on q's device, got "
                         f"{tuple(g_lse.shape)}")
    delta = _delta(o, do, g_lse)
    args = (causal, q_offset, kv_offset)
    scale = d ** -0.5
    qp, kp, vp, dop = _pad_head_dim(q, k, v, do)
    if stash_bytes(q, k, do) <= PDS_STASH_LIMIT_BYTES:
        dq, p_st, ds_st = flash_bwd_dq(qp, kp, vp, dop, lse, delta, *args,
                                       stash=True, scale=scale)
        dk, dv = flash_bwd_dkv_from_stash(qp, kp, vp, dop, p_st, ds_st,
                                          *args)
    else:
        dq, _, _ = flash_bwd_dq(qp, kp, vp, dop, lse, delta, *args,
                                scale=scale)
        dk, dv = flash_bwd_dkv(qp, kp, vp, dop, lse, delta, *args,
                               scale=scale)
    if qp is not q:
        dq, dk, dv = (t[..., :d].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor,
                             causal: bool = True, q_offset: int = 0,
                             kv_offset: int = 0,
                             g_lse: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) by the backward kernels (plain version for CPU
    tensors); the arguments as for `flash_attention_backward_plain`.
    `g_lse` enters the kernels only through delta, which they read."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, o, lse, do, causal,
                                              int(q_offset), int(kv_offset),
                                              g_lse)
    return _flash_attention_backward_cuda(q, k, v, o, lse, do, causal,
                                          int(q_offset), int(kv_offset),
                                          g_lse)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its LSE; residuals (q, k, v, o, lse), as the
    JAX custom VJP keeps them. With `with_lse` the LSE is an output too and
    the backward takes both cotangents (`flash_attention_lse`), else the
    output alone (`flash_attention_train`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_offset, with_lse):
        o, lse = flash_attention(q, k, v, causal, q_offset, kv_offset,
                                 return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, q_offset, kv_offset)
        return (o, lse) if with_lse else o

    @staticmethod
    def backward(ctx, g, g_lse=None):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse,
                                              g.contiguous(), *ctx.args,
                                              g_lse=g_lse)
        return dq, dk, dv, None, None, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True,
                          q_offset: int = 0,
                          kv_offset: int = 0) -> torch.Tensor:
    """Differentiable flash attention, q (B, Sq, H, D), k/v (B, Sk, KH, D):
    GQA is expanded with `repeat_kv` before the kernels (autograd sums the
    copies' gradients back), as the JAX kernels require."""
    n_rep = q.shape[2] // k.shape[2]
    return _FlashAttention.apply(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                                 causal, int(q_offset), int(kv_offset), False)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable flash attention that also returns the per-row
    logsumexp: q (B, Sq, H, D), k/v (B, Sk, H, D) (MHA) at offsets 0 ->
    (O (B, Sq, H, D) in q's dtype, LSE (B, H, Sq) f32), the reference's
    `flash_attention_lse`, the statistic ring attention merges blocks by.
    Fully masked rows report LSE_MASKED. The backward takes cotangents of
    both outputs: the LSE's folds into delta (`flash_attention_backward`'s
    `g_lse`)."""
    return _FlashAttention.apply(q, k, v, causal, 0, 0, True)


def flash_attention_t(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                      causal: bool = True) -> torch.Tensor:
    """Flash attention on (B*H, S, D) tensors at offsets 0 (the training
    path). The flat layout is the kernels' (B, S, H, D) with B*H batches of
    one head, so `attention` runs on views: differentiable where autograd
    records, with the residuals (q, k, v, o, lse) of the reference's
    `_t_fwd`."""
    return attention(qt[:, :, None], kt[:, :, None], vt[:, :, None],
                     causal=causal)[:, :, 0]
