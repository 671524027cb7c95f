"""KTWE-LM, the decoder-only transformer, in PyTorch (dense, one device).

Port of k8s_gpu_workload_enhancer_tpu/models/transformer.py. Params are a
plain dict with the JAX package's tree: stacked (L, ...) layer leaves of the
same names and shapes, so a JAX param tree converts leaf for leaf
(`params_from_numpy`) and both packages compute the same function. Layers
are a Python loop over the stacked leaves. Activations run in `cfg.dtype`,
norms and softmax statistics in f32, logits are returned in f32.

Training: `loss_fn` is the next-token loss through the fused LM-head
cross-entropy (ops/fused_ce.py) where the reference's gate takes it
(`ce_fused`, `ce_cache_logits` and `fused_ce_supported`), else the chunked
one (ops/chunked_ce.py), differentiable end to end: the embedding
gather (ops/embed.py), RMSNorm, RoPE and attention run their kernels on
the card, the FFN the lean SwiGLU backward, and `remat` / `remat_ffn`
recompute a layer or its FFN in the backward (torch.utils.checkpoint).
Attention takes the reference's t-layout path where its gate
(`_t_layout_ok`) holds: RoPE writes the flash kernels' flat (B*H, S, D)
layout, v goes into it and the output comes out of it through the
relayout kernels (ops/relayout.py), and attention runs on it.

Not ported here: MoE, ring attention and meshes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops.attention import (apply_rope, apply_rope_t, attention,
                             rope_frequencies)
from ..ops.embed import embed_tokens
from ..ops.flash_attention import flash_attention_t, flash_supported
from ..ops.fused_ce import fused_ce_supported, fused_lm_head_xent
from ..ops.layers import cross_entropy_loss, rms_norm, swiglu, swiglu_lean
from ..ops.quant import as_compute, is_quantized
from ..ops.relayout import from_t_layout, to_t_layout
from ..ops.rope import rope_supported

Params = Dict[str, Any]


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 1024
    n_layers: int = 8
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 4096
    max_seq: int = 2048
    rope_theta: float = 10000.0
    # MoE: 0 experts = dense, the only kind ported (ROADMAP A11).
    n_experts: int = 0
    expert_top_k: int = 1
    dtype: torch.dtype = torch.bfloat16
    # Training: recompute each layer (remat) or only its FFN (remat_ffn) in
    # the backward; the lean SwiGLU backward (ops/layers.swiglu_lean).
    remat: bool = False
    remat_ffn: bool = False
    ffn_lean_vjp: bool = True
    tie_embeddings: bool = False
    # Training loss path: LM head + CE over vocab chunks (ops/chunked_ce.py),
    # never materializing (B, S, V) f32 logits; ce_cache_logits stashes bf16
    # logits for a single-chunk backward. ce_fused with ce_cache_logits
    # takes the fused LM-head CE kernels (ops/fused_ce.py) where its shape
    # gate holds.
    use_chunked_ce: bool = True
    ce_chunk: int = 8192
    ce_cache_logits: bool = False
    ce_fused: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def flops_per_token(self, seq_len: Optional[int] = None) -> float:
        """Model fwd+bwd FLOPs/token: 6 * params-activated plus the causal
        attention-score matmuls (the JAX package's formula, PaLM appendix
        B; causal halves the score term). seq_len defaults to max_seq."""
        d, f, L, v = self.d_model, self.d_ff, self.n_layers, self.vocab_size
        s = seq_len if seq_len is not None else self.max_seq
        attn = 4 * d * d + 2 * d * d  # qkv+o projections (approx, MHA)
        ffn = 3 * d * f
        if self.is_moe:
            ffn *= self.expert_top_k
        per_layer = attn + ffn
        attn_scores = 6.0 * s * d * L
        return 6.0 * (L * per_layer + 2 * d * v / 2) + attn_scores


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def param_shapes(cfg: TransformerConfig) -> Params:
    """The param tree's leaf shapes (the JAX package's init_params tree)."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes: Params = {
        "embed": (cfg.vocab_size, d),
        "layers": {
            "ln1": (L, d), "ln2": (L, d),
            "wq": (L, d, h, hd), "wk": (L, d, kh, hd), "wv": (L, d, kh, hd),
            "wo": (L, h, hd, d),
            "w_gate": (L, d, f), "w_up": (L, d, f), "w_down": (L, f, d),
        },
        "final_ln": (d,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


# fan-in of each truncated-normal leaf (norm scales start at one)
_FAN_IN = {"wq": "d", "wk": "d", "wv": "d", "wo": "hd_all", "w_gate": "d",
           "w_up": "d", "w_down": "f", "embed": "one", "lm_head": "d"}


def init_params(generator: torch.Generator, cfg: TransformerConfig) -> Params:
    """f32 master weights on the generator's device: truncated normal in
    [-2, 2] scaled by fan-in^-0.5, norm scales one. Same tree as the JAX
    init; the draws differ (a torch.Generator is not a jax key)."""
    device = generator.device
    fan = {"d": cfg.d_model, "f": cfg.d_ff,
           "hd_all": cfg.n_heads * cfg.head_dim, "one": 1}

    def init(name, shape):
        if name in ("ln1", "ln2", "final_ln"):
            return torch.ones(shape, dtype=torch.float32, device=device)
        t = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return t.mul_(fan[_FAN_IN[name]] ** -0.5)

    shapes = param_shapes(cfg)
    params: Params = {k: init(k, v) for k, v in shapes.items()
                      if k != "layers"}
    params["layers"] = {k: init(k, v) for k, v in shapes["layers"].items()}
    return params


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")           # a writable host copy
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16, bit for bit
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Dict[str, Any], cfg: TransformerConfig,
                      device="cpu") -> Params:
    """A JAX package param tree, as numpy arrays, as the port's tensors on
    `device`: dtypes kept (f32, bf16, int8 {"q8", "scale"} leaves), shapes
    checked against `cfg`."""
    shapes = param_shapes(cfg)

    def convert(node, want, path):
        if isinstance(want, dict):
            missing = set(want) - set(node)
            if missing:
                raise KeyError(f"param tree lacks {sorted(missing)} at "
                               f"{path or 'root'}")
            return {k: convert(node[k], want[k], f"{path}/{k}")
                    for k in want}
        if is_quantized(node):
            leaf = {"q8": _to_tensor(np.asarray(node["q8"]), device),
                    "scale": _to_tensor(np.asarray(node["scale"]), device)}
            got = tuple(leaf["q8"].shape)
        else:
            leaf = _to_tensor(np.asarray(node), device)
            got = tuple(leaf.shape)
        if got != tuple(want):
            raise ValueError(f"param {path} has shape {got}, config wants "
                             f"{tuple(want)}")
        return leaf

    return convert(tree, shapes, "")


def param_count(params: Params) -> int:
    def count(node):
        if isinstance(node, dict):
            if is_quantized(node):
                return node["q8"].numel()
            return sum(count(v) for v in node.values())
        return node.numel()
    return count(params)


def layer_params(params: Params, layer: int) -> Params:
    """Layer `layer`'s slice of the stacked leaves (views, no copies)."""
    def pick(v):
        if is_quantized(v):
            return {"q8": v["q8"][layer], "scale": v["scale"][layer]}
        return v[layer]
    return {k: pick(v) for k, v in params["layers"].items()}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def output_head(params: Params, cfg: TransformerConfig):
    """(D, V) LM-head weight (tied or separate), in master dtype."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _t_layout_ok(q: torch.Tensor, cfg: TransformerConfig,
                 position_offset: int) -> bool:
    """The reference's gate for the kernel-native-layout attention path
    (models/transformer.py `_t_layout_ok`) on one device: training offset
    0, full MHA, and both kernels' shape gates."""
    return (position_offset == 0 and cfg.n_kv_heads == cfg.n_heads
            and flash_supported(q, q, q) and rope_supported(q))


def _attention_block(x: torch.Tensor, lp: Params, cfg: TransformerConfig,
                     freqs: torch.Tensor, position_offset: int) -> torch.Tensor:
    dt = cfg.dtype
    bsz, slen, d = x.shape
    nh, nkh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["ln1"]).reshape(bsz * slen, d)
    q = (h @ as_compute(lp["wq"], dt).reshape(d, nh * hd)
         ).reshape(bsz, slen, nh, hd)
    k = (h @ as_compute(lp["wk"], dt).reshape(d, nkh * hd)
         ).reshape(bsz, slen, nkh, hd)
    v = (h @ as_compute(lp["wv"], dt).reshape(d, nkh * hd)
         ).reshape(bsz, slen, nkh, hd)
    if _t_layout_ok(q, cfg, position_offset):
        # RoPE emits (B*H, S, D) and flash keeps its residuals there; v
        # goes into that layout and the output comes back through the
        # relayout kernels (the reference's transposes).
        qt = apply_rope_t(q, freqs)
        kt = apply_rope_t(k, freqs)
        ot = flash_attention_t(qt, kt, to_t_layout(v), True)
        o = from_t_layout(ot, bsz, nh)
    else:
        q = apply_rope(q, freqs, position_offset)
        k = apply_rope(k, freqs, position_offset)
        o = attention(q, k, v, causal=True, q_offset=position_offset,
                      kv_offset=position_offset)
    return x + (o.reshape(bsz * slen, nh * hd)
                @ as_compute(lp["wo"], dt).reshape(nh * hd, d)
                ).reshape(bsz, slen, d)


def _ffn(h3: torch.Tensor, w_gate, w_up, w_down,
         cfg: TransformerConfig) -> torch.Tensor:
    dt = cfg.dtype
    op = swiglu_lean if cfg.ffn_lean_vjp else swiglu
    bsz, slen, d = h3.shape
    return op(h3.reshape(bsz * slen, d), as_compute(w_gate, dt),
              as_compute(w_up, dt), as_compute(w_down, dt)
              ).reshape(bsz, slen, d)


def _layer(x: torch.Tensor, lp: Params, cfg: TransformerConfig,
           freqs: torch.Tensor, position_offset: int) -> torch.Tensor:
    x = _attention_block(x, lp, cfg, freqs, position_offset)
    h3 = rms_norm(x, lp["ln2"])
    if cfg.remat_ffn and not cfg.remat and torch.is_grad_enabled():
        y = checkpoint(_ffn, h3, lp["w_gate"], lp["w_up"], lp["w_down"], cfg,
                       use_reentrant=False)
    else:
        y = _ffn(h3, lp["w_gate"], lp["w_up"], lp["w_down"], cfg)
    return x + y


def forward_hidden(params: Params, tokens: torch.Tensor,
                   cfg: TransformerConfig,
                   position_offset: int = 0) -> torch.Tensor:
    """tokens (B, S) -> final hidden (B, S, D) after the last norm."""
    if cfg.is_moe:
        raise NotImplementedError("MoE layers (n_experts > 0) are not ported "
                                  "(ROADMAP A11)")
    x = embed_tokens(params["embed"], tokens, cfg.d_model, cfg.dtype)
    freqs = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                             x.device)
    for layer in range(cfg.n_layers):
        lp = layer_params(params, layer)
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_layer, x, lp, cfg, freqs, position_offset,
                           use_reentrant=False)
        else:
            x = _layer(x, lp, cfg, freqs, position_offset)
    return rms_norm(x, params["final_ln"])


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            position_offset: int = 0) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) f32 (the head matmul runs in
    cfg.dtype, then the cast)."""
    x = forward_hidden(params, tokens, cfg, position_offset)
    head = as_compute(output_head(params, cfg), cfg.dtype)
    return (x @ head).float()


def loss_fn(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token LM loss over tokens (B, S+1) -> (total, {nll, aux}). The
    dense model has no auxiliary loss, so aux is 0."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if cfg.use_chunked_ce:
        from ..ops.chunked_ce import chunked_softmax_xent
        x = forward_hidden(params, inputs, cfg)
        head = output_head(params, cfg)
        if (cfg.ce_fused and cfg.ce_cache_logits
                and fused_ce_supported(x, head)):
            nll = fused_lm_head_xent(x, head, targets)
        else:
            nll = chunked_softmax_xent(x, head, targets,
                                       min(cfg.ce_chunk, cfg.vocab_size),
                                       cfg.ce_cache_logits)
    else:
        nll = cross_entropy_loss(forward(params, inputs, cfg), targets)
    aux = torch.zeros((), dtype=torch.float32, device=nll.device)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}
