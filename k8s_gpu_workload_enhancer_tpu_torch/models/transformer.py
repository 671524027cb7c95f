"""KTWE-LM, the decoder-only transformer, in PyTorch (dense or MoE; one
device, or a mesh of dp, pp, ep, tp and sp).

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

MoE (`n_experts > 0`): every layer's FFN is a router and a bank of
experts (`_moe_ffn`, Switch-style top-k with the load-balance aux loss,
which `loss_fn` adds to the total). Training routes through the sort-based
capacity-bounded dispatch (ops/moe_dispatch.py) where the reference's
single-device gate takes it (`moe_ragged_dispatch`, top-1, a mesh of one
device: the whole mesh's size, as JAX's `mesh.size == 1`), else through
the dense one-hot route, which inference always takes.

FSDP: `loss_fn` takes `fsdp` (parallel/sharding.Fsdp), the layout of a
param tree whose weights each rank holds a block of. The forward then
gathers each leaf just before its use (the embedding table, a layer's
slices of the stacked leaves, the LM head), the backward reduce-scatters
their gradients, and the MoE load-balance fractions are averaged over the
ranks before their product. `param_logical_axes` names each leaf's axes
for the sharding rules, as in the JAX package.

Expert parallelism: where the layout's ep axis exceeds 1, each rank holds
n_experts/ep experts a layer and its rows of the batch (split over dp and
ep jointly). The dense route's dispatched tokens xe (E, N, D) go, split on
E into ep chunks, through an all-to-all over ep (`ep_comm.all_to_all_grad`,
whose backward is the inverse all-to-all): the rank receives every rank's
tokens for its experts, (ep, E/ep, N, D), runs its experts on them, and a
second all-to-all brings the outputs back to (E, N, D), which the rank's
own gates combine. This is the token all-to-all GSPMD inserts for the JAX
package's sharding hints on xe and ye (`"ep"` on the expert axis, the
batch over dp). The router is replicated over ep; its gradient and every
other ep-replicated leaf's are averaged over ep after the backward
(`Fsdp.reduce_grads_`).

Tensor and sequence parallelism: where the layout's tp or sp axis
exceeds 1 (`fsdp.model_parallel`), `loss_fn` and `forward` run the
model-parallel forward (`_forward_hidden_mp`), with explicit collectives:
Q/K/V and w_gate/w_up column-parallel over this rank's heads and MLP
columns, wo and w_down row-parallel with an all-reduce over tp (the
layout's `tp_copy` and `tp_sum`, Megatron's f and g), a vocab-parallel
embedding (a masked lookup of the rank's rows, summed over tp) and a
vocab-parallel LM head and cross-entropy (`_vocab_parallel_xent`). Each sp
rank embeds its S/sp positions at their global offsets, and attention is a
ring over sp (parallel/ring_attention.py), whose blocks run the flash
kernels' LSE entry point, or with `use_ring_attention` False JAX's other
path: each rank's queries attend over the whole sequence's K and V,
gathered over sp (`gathered_attention`: the flash kernels at Sq = S/sp,
Sk = S and the rank's offset); with sp 1 it is `attention` on the rank's
heads.
Route choice follows the JAX package on a model-parallel mesh: no t-layout
path and no fused CE, RMSNorm, RoPE and the embedding in plain torch
(where the reference falls back to XLA). An MoE layer there is the dense
route on the rank's experts (all of them, or its E/ep with ep) and its
columns of their MLP dim: the router runs on the normed input as it is
(every tp rank computes the same gates), the experts' input goes through
`tp_copy` and so do the combine weights (the rank's expert outputs are
partial sums over the MLP dim, so are the combine weights' gradients), and
the combined output through `tp_sum`. The layers' aux losses are summed as
on one device.

Pipeline parallelism: both forwards read a layer's leaves through the
layout (`fsdp.layer_params`), which on a pp mesh takes each layer from
the stage that holds it (parallel/sharding.py, the layer-stack form: the
batch replicated over pp, as JAX's "layers" -> "pp" rule runs the
model); MoE, ep, tp and sp run inside it unchanged. The explicit GPipe
schedule runs `_layer` as its stage (parallel/pipeline.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ..ops.attention import (_tables, apply_rope, apply_rope_t, attention,
                             rope_frequencies)
from ..ops.embed import embed_scale, embed_tokens
from ..ops.flash_attention import flash_attention_t, flash_supported
from ..ops.fused_ce import fused_ce_supported, fused_lm_head_xent
from ..ops.layers import cross_entropy_loss, rms_norm, swiglu, swiglu_lean
from ..ops.moe_dispatch import ragged_dispatch
from ..ops.quant import as_compute, is_quantized
from ..ops.relayout import from_t_layout, to_t_layout
from ..ops.rms import rms_norm_plain
from ..ops.rope import rope_rotate_plain, rope_supported
from ..parallel.ring_attention import gathered_attention, ring_attention

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
    # MoE: 0 experts = dense. With experts, every layer's FFN is a router +
    # expert bank (Switch-style top-1 by default).
    n_experts: int = 0
    expert_top_k: int = 1
    # MoE dispatch in training: the sort-based capacity-bounded route
    # (ops/moe_dispatch.py, capacity factor 1.25) at top-1, else the dense
    # one-hot route.
    moe_ragged_dispatch: bool = True
    dtype: torch.dtype = torch.bfloat16
    # Inference only: store the KV cache as int8 with per-row (token,
    # kv-head) f32 scales (models/decode.py). Training ignores it.
    kv_cache_int8: bool = False
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
    # Attention over sp (only an sp axis above 1 reads it): the ring
    # (parallel/ring_attention.py), or each rank's queries over the K and V
    # gathered from the sp ranks (JAX's use_ring_attention=False).
    use_ring_attention: bool = True

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
        },
        "final_ln": (d,),
    }
    if cfg.is_moe:
        e = cfg.n_experts
        shapes["layers"].update({
            "router": (L, d, e), "w_gate": (L, e, d, f),
            "w_up": (L, e, d, f), "w_down": (L, e, f, d)})
    else:
        shapes["layers"].update({
            "w_gate": (L, d, f), "w_up": (L, d, f), "w_down": (L, f, d)})
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


# fan-in of each truncated-normal leaf (norm scales start at one)
_FAN_IN = {"wq": "d", "wk": "d", "wv": "d", "wo": "hd_all", "w_gate": "d",
           "w_up": "d", "w_down": "f", "router": "d", "embed": "one",
           "lm_head": "d"}


def param_logical_axes(cfg: TransformerConfig) -> Params:
    """Logical sharding axes mirroring the param tree (parallel/sharding.py)."""
    layers: Dict[str, Tuple] = {
        "ln1": ("layers", None),
        "ln2": ("layers", None),
        "wq": ("layers", "embed", "heads", "head_dim"),
        "wk": ("layers", "embed", "kv_heads", "head_dim"),
        "wv": ("layers", "embed", "kv_heads", "head_dim"),
        "wo": ("layers", "heads", "head_dim", "embed"),
    }
    if cfg.is_moe:
        layers.update({
            "router": ("layers", "embed", None),
            "w_gate": ("layers", "expert", "embed", "mlp"),
            "w_up": ("layers", "expert", "embed", "mlp"),
            "w_down": ("layers", "expert", "mlp", "embed"),
        })
    else:
        layers.update({
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        })
    axes: Params = {
        "embed": ("vocab", "embed"),
        "layers": layers,
        "final_ln": (None,),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def init_params(generator: torch.Generator, cfg: TransformerConfig,
                finish: Optional[Callable[[str, torch.Tensor], Any]] = None
                ) -> Params:
    """f32 master weights on the generator's device: truncated normal in
    [-2, 2] scaled by fan-in^-0.5, norm scales one. Same tree as the JAX
    init; the draws differ (a torch.Generator is not a jax key).
    `finish(name, leaf)`, when given, replaces each leaf as soon as it is
    drawn (a cast, a quantization, a rank's block), so at most one full f32
    leaf is alive beyond the finished tree; the draws are the same."""
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

    def leaf(name, shape):
        t = init(name, shape)
        return t if finish is None else finish(name, t)

    shapes = param_shapes(cfg)
    params: Params = {k: leaf(k, v) for k, v in shapes.items()
                      if k != "layers"}
    params["layers"] = {k: leaf(k, v) for k, v in shapes["layers"].items()}
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


def output_head(params: Params, cfg: TransformerConfig, fsdp=None):
    """(D, V) LM-head weight (tied or separate), in master dtype; under
    `fsdp` gathered."""
    if fsdp is not None:
        return (fsdp.leaf(params, "embed").T if cfg.tie_embeddings
                else fsdp.leaf(params, "lm_head"))
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


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last axis, in
    descending order, ties to the lowest index (jax.lax.top_k's order;
    torch.topk promises none among ties): k argmax passes, each taking the
    first maximal index, the chosen entry masked below every probability
    before the next."""
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(probs, dim=-1, keepdim=True)
        vals.append(torch.gather(probs, -1, i))
        idxs.append(i)
        probs = probs.scatter(-1, i, -1.0)
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def _moe_ffn(x: torch.Tensor, lp: Params, cfg: TransformerConfig,
             fsdp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Switch-style MoE FFN of one layer: x (B, S, D) -> (y (B, S, D), the
    load-balance aux loss, f32 scalar). Router logits in x's dtype, the
    softmax in f32; top-k (k 1 keeps the raw router probability as the
    gate, so the router keeps its main-path gradient; k > 1 renormalises).
    aux = E * sum(frac_tokens * frac_probs) over the batch; under `fsdp`
    over the global batch (both fractions averaged over the ranks). The
    sort-based ragged route (ops/moe_dispatch.py) where
    `moe_ragged_dispatch`, k == 1 and the whole mesh is one device, else
    the dense one-hot route, every expert over every row (JAX
    models/transformer.py `_moe_ffn`). Under a layout with ep above 1 the
    rank's E/ep experts run on every ep rank's rows for them, carried by
    two all-to-alls over ep; with tp above 1 on the rank's MLP columns,
    the output summed over tp (see the module note)."""
    e, k = cfg.n_experts, cfg.expert_top_k
    dt = x.dtype
    bsz, slen, d = x.shape
    n = bsz * slen
    logits = (x.reshape(n, d) @ as_compute(lp["router"], dt)
              ).reshape(bsz, slen, e)
    probs = torch.softmax(logits.float(), dim=-1)
    topw, topi = _top_k(probs, k)                              # (B, S, k)
    if k > 1:
        topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    # One-hot by comparison (no host-side bounds check, graph-capturable).
    disp = (topi[..., None] == torch.arange(e, device=x.device)
            ).to(dt)                                           # (B,S,k,E)
    frac_tokens = disp.sum(2).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    if fsdp is not None:
        frac_tokens, frac_probs = fsdp.global_means(frac_tokens, frac_probs)
    aux = e * torch.sum(frac_tokens * frac_probs)
    w_gate = as_compute(lp["w_gate"], dt)                  # (E/ep, D, F/tp)
    w_up = as_compute(lp["w_up"], dt)
    w_down = as_compute(lp["w_down"], dt)                  # (E/ep, F/tp, D)

    single_device = fsdp is None or fsdp.size == 1
    if cfg.moe_ragged_dispatch and k == 1 and single_device:
        def expert_ffn(_eids, xs):                             # (E, C, D)
            h = torch.matmul(xs, w_gate)
            u = torch.matmul(xs, w_up)
            return torch.matmul(F.silu(h) * u, w_down)

        y2, _dropped = ragged_dispatch(
            x.reshape(n, d), topi[..., 0].reshape(-1),
            topw[..., 0].reshape(-1), e, expert_ffn)
        return y2.reshape(bsz, slen, d).to(dt), aux

    # Dense route: (N, D) x (N, E) -> (E, N, D), each expert's FFN over
    # every row, combined by the gates of the chosen experts.
    combine = (disp * topw[..., None].to(dt)).sum(2).reshape(n, e)
    x2 = x.reshape(n, d)
    ep = 1 if fsdp is None else fsdp.ep
    if fsdp is not None:
        x2, combine = fsdp.tp_copy(x2), fsdp.tp_copy(combine)
    xe = torch.einsum("nd,ne->end", x2, disp.sum(2).reshape(n, e))
    if ep > 1:
        # To the experts' ranks: (ep sources, E/ep, N, D) of this rank's
        # experts; the experts broadcast over the sources.
        xe = fsdp.ep_comm.all_to_all_grad(xe.reshape(ep, e // ep, n, d))
    h = torch.matmul(xe, w_gate)
    u = torch.matmul(xe, w_up)
    ye = torch.matmul(F.silu(h) * u, w_down)
    if ep > 1:
        # And back: (ep expert ranks, E/ep, N, D) -> (E, N, D).
        ye = fsdp.ep_comm.all_to_all_grad(ye).reshape(e, n, d)
    y = torch.einsum("end,ne->nd", ye, combine)
    if fsdp is not None:
        y = fsdp.tp_sum(y)
    return y.reshape(bsz, slen, d), aux


def _layer(x: torch.Tensor, lp: Params, cfg: TransformerConfig,
           freqs: torch.Tensor, position_offset: int, fsdp=None
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block: (x out, the layer's MoE aux loss or None when dense)."""
    x = _attention_block(x, lp, cfg, freqs, position_offset)
    h3 = rms_norm(x, lp["ln2"])
    if cfg.is_moe:
        y, aux = _moe_ffn(h3, lp, cfg, fsdp)
        return x + y, aux
    if cfg.remat_ffn and not cfg.remat and torch.is_grad_enabled():
        y = checkpoint(_ffn, h3, lp["w_gate"], lp["w_up"], lp["w_down"], cfg,
                       use_reentrant=False)
    else:
        y = _ffn(h3, lp["w_gate"], lp["w_up"], lp["w_down"], cfg)
    return x + y, None


def _forward_hidden_aux(params: Params, tokens: torch.Tensor,
                        cfg: TransformerConfig, position_offset: int = 0,
                        fsdp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (final hidden (B, S, D) after the last norm, the
    sum of the layers' MoE aux losses, f32 scalar; 0 when dense). Under
    `fsdp` each leaf is gathered just before its use."""
    pick = (lambda name: params[name]) if fsdp is None else (
        lambda name: fsdp.leaf(params, name))
    x = embed_tokens(pick("embed"), tokens, cfg.d_model, cfg.dtype)
    freqs = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                             x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(cfg.n_layers):
        lp = (layer_params(params, layer) if fsdp is None
              else fsdp.layer_params(params, layer))
        if cfg.remat and torch.is_grad_enabled():
            # Under a layout, early stop off: the recomputation runs the
            # whole layer, its collectives (the MoE fractions' mean, the
            # all-to-alls) included, on every rank.
            with set_checkpoint_early_stop(fsdp is None):
                x, layer_aux = checkpoint(_layer, x, lp, cfg, freqs,
                                          position_offset, fsdp,
                                          use_reentrant=False)
        else:
            x, layer_aux = _layer(x, lp, cfg, freqs, position_offset, fsdp)
        if layer_aux is not None:
            aux = aux + layer_aux
    return rms_norm(x, pick("final_ln")), aux


# ---------------------------------------------------------------------------
# Tensor- and sequence-parallel forward
# ---------------------------------------------------------------------------


def _embed_vocab_parallel(table: torch.Tensor, tokens: torch.Tensor,
                          cfg: TransformerConfig, fsdp) -> torch.Tensor:
    """The embedding from this tp rank's vocab rows (V/tp, D): each token's
    scaled row where the rank holds it, zeros elsewhere, summed over tp
    (`embed_tokens`' rounding: the row and sqrt(d_model) in cfg.dtype, the
    product in f32, rounded once)."""
    v_loc = table.shape[0]
    ids = tokens.long() - fsdp.tp_rank * v_loc
    mine = (ids >= 0) & (ids < v_loc)
    rows = table[ids.clamp(0, v_loc - 1)].to(cfg.dtype)
    x = (rows.float() * embed_scale(cfg.d_model, cfg.dtype)).to(cfg.dtype)
    return fsdp.tp_sum(torch.where(mine[..., None], x, torch.zeros_like(x)))


def _kv_heads_of_rank(cfg: TransformerConfig, fsdp, device) -> torch.Tensor:
    """The KV head each of this tp rank's Q heads reads, where the KV
    projections are replicated over tp (`fsdp.kv_replicated`)."""
    h_loc = cfg.n_heads // fsdp.tp
    n_rep = cfg.n_heads // cfg.n_kv_heads
    first = fsdp.tp_rank * h_loc
    return torch.arange(first, first + h_loc, device=device) // n_rep


def _layer_mp(x: torch.Tensor, lp: Params, cfg: TransformerConfig,
              freqs: torch.Tensor, position_offset: int, fsdp
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block on this rank's positions (B, S/sp, D) with its tp (and
    ep) blocks of the layer's weights (see the module note): (x out, the
    layer's MoE aux loss or None when dense)."""
    dt = cfg.dtype
    bsz, slen, d = x.shape
    hd = cfg.head_dim
    h = fsdp.tp_copy(rms_norm_plain(x, lp["ln1"])).reshape(bsz * slen, d)

    def project(w):
        w = as_compute(w, dt)
        return (h @ w.reshape(d, -1)).reshape(bsz, slen, -1, hd)
    q, k, v = project(lp["wq"]), project(lp["wk"]), project(lp["wv"])
    if fsdp.kv_replicated:
        idx = _kv_heads_of_rank(cfg, fsdp, x.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    cos, sin = _tables(freqs, slen, position_offset)
    q, k = rope_rotate_plain(q, cos, sin), rope_rotate_plain(k, cos, sin)
    if fsdp.sp > 1 and not cfg.use_ring_attention:
        o = gathered_attention(q, k, v, fsdp.sp_comm, causal=True,
                               position_offset=position_offset
                               - fsdp.sp_rank * slen)
    else:
        o = ring_attention(q, k, v, fsdp.sp_group if fsdp.sp > 1 else None,
                           causal=True)
    nh = q.shape[2]
    x = x + fsdp.tp_sum((o.reshape(bsz * slen, nh * hd)
                         @ as_compute(lp["wo"], dt).reshape(nh * hd, d)
                         ).reshape(bsz, slen, d))
    if cfg.is_moe:
        # _moe_ffn takes the tp copies and the tp sum itself.
        y, aux = _moe_ffn(rms_norm_plain(x, lp["ln2"]), lp, cfg, fsdp)
        return x + y, aux
    h3 = fsdp.tp_copy(rms_norm_plain(x, lp["ln2"]))
    if cfg.remat_ffn and not cfg.remat and torch.is_grad_enabled():
        y = checkpoint(_ffn, h3, lp["w_gate"], lp["w_up"], lp["w_down"], cfg,
                       use_reentrant=False)
    else:
        y = _ffn(h3, lp["w_gate"], lp["w_up"], lp["w_down"], cfg)
    return x + fsdp.tp_sum(y), None


def _forward_hidden_mp(params: Params, tokens: torch.Tensor,
                       cfg: TransformerConfig, fsdp,
                       position_offset: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's positions of the final hidden (B, S/sp, D), after the
    last norm, from its rows of tokens (B, S): the sp shard of the
    positions, at global offsets position_offset + sp_rank * S/sp; and
    the sum of the layers' MoE aux losses (0 when dense)."""
    tokens = fsdp.seq_shard(tokens)
    offset = position_offset + fsdp.sp_rank * tokens.shape[1]
    x = _embed_vocab_parallel(fsdp.leaf(params, "embed"), tokens, cfg, fsdp)
    freqs = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                             x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(cfg.n_layers):
        lp = fsdp.layer_params(params, layer)
        if cfg.remat and torch.is_grad_enabled():
            # Early stop off: the recomputation runs the whole layer, its
            # collectives (ring shifts, tp sums, all-to-alls) included, on
            # every rank.
            with set_checkpoint_early_stop(False):
                x, layer_aux = checkpoint(_layer_mp, x, lp, cfg, freqs,
                                          offset, fsdp, use_reentrant=False)
        else:
            x, layer_aux = _layer_mp(x, lp, cfg, freqs, offset, fsdp)
        if layer_aux is not None:
            aux = aux + layer_aux
    return rms_norm_plain(x, fsdp.leaf(params, "final_ln")), aux


def _vocab_parallel_logits(x: torch.Tensor, head: torch.Tensor,
                           cfg: TransformerConfig, fsdp) -> torch.Tensor:
    """(N, V/tp) f32 logits of this tp rank's vocab columns, from the
    hidden (..., D) and its head block (D, V/tp)."""
    h2 = fsdp.tp_copy(x).reshape(-1, x.shape[-1])
    return (h2 @ as_compute(head, cfg.dtype)).float()


def _vocab_parallel_xent(x: torch.Tensor, head: torch.Tensor,
                         targets: torch.Tensor, cfg: TransformerConfig,
                         fsdp) -> torch.Tensor:
    """Mean token NLL with the vocab split over tp: the local logits' max
    (a MAX all-reduce, no gradient) and sum of exponentials (summed over
    tp) give the logsumexp, and the gold logit comes from the rank that
    holds it (summed over tp)."""
    logits = _vocab_parallel_logits(x, head, cfg, fsdp)
    v_loc = logits.shape[1]
    with torch.no_grad():
        m = logits.amax(dim=1)
        if fsdp.tp > 1:
            m = fsdp.tp_max(m)
    sumexp = fsdp.tp_sum(torch.exp(logits - m[:, None]).sum(dim=1))
    lse = m + torch.log(sumexp)
    t = targets.reshape(-1).long() - fsdp.tp_rank * v_loc
    mine = (t >= 0) & (t < v_loc)
    gold = torch.gather(logits, 1, t.clamp(0, v_loc - 1)[:, None])[:, 0]
    gold = fsdp.tp_sum(torch.where(mine, gold, torch.zeros_like(gold)))
    return (lse - gold).mean()


def forward_hidden(params: Params, tokens: torch.Tensor,
                   cfg: TransformerConfig,
                   position_offset: int = 0) -> torch.Tensor:
    """tokens (B, S) -> final hidden (B, S, D) after the last norm."""
    return _forward_hidden_aux(params, tokens, cfg, position_offset)[0]


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            position_offset: int = 0, fsdp=None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) f32 (the head matmul runs in
    cfg.dtype, then the cast). On a model-parallel layout (`fsdp` with tp
    or sp above 1) `params` are this rank's blocks and `tokens` its rows:
    the result is this rank's block (B, S/sp, V/tp) of positions and
    vocab."""
    if fsdp is not None and fsdp.model_parallel:
        x, _ = _forward_hidden_mp(params, tokens, cfg, fsdp, position_offset)
        return _vocab_parallel_logits(x, output_head(params, cfg, fsdp), cfg,
                                      fsdp).reshape(*x.shape[:2], -1)
    x = forward_hidden(params, tokens, cfg, position_offset)
    head = as_compute(output_head(params, cfg), cfg.dtype)
    return (x @ head).float()


def loss_fn(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            aux_weight: float = 0.01, fsdp=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token LM loss over tokens (B, S+1) -> (total, {nll, aux}):
    total = nll + aux_weight * aux, aux the layers' summed MoE load-balance
    loss (0 for the dense model). Under `fsdp`, `params` are this rank's
    blocks and `tokens` its rows: nll is the mean over those rows, aux the
    global batch's. On a model-parallel layout nll is the mean over this
    rank's rows and its sp shard of the positions, sliced after the
    input/target shift."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if fsdp is not None and fsdp.model_parallel:
        x, aux = _forward_hidden_mp(params, inputs, cfg, fsdp)
        nll = _vocab_parallel_xent(x, output_head(params, cfg, fsdp),
                                   fsdp.seq_shard(targets), cfg, fsdp)
        return nll + aux_weight * aux, {"nll": nll, "aux": aux}
    if cfg.use_chunked_ce:
        from ..ops.chunked_ce import chunked_softmax_xent
        x, aux = _forward_hidden_aux(params, inputs, cfg, fsdp=fsdp)
        head = output_head(params, cfg, fsdp)
        if (cfg.ce_fused and cfg.ce_cache_logits
                and fused_ce_supported(x, head)):
            nll = fused_lm_head_xent(x, head, targets)
        else:
            nll = chunked_softmax_xent(x, head, targets,
                                       min(cfg.ce_chunk, cfg.vocab_size),
                                       cfg.ce_cache_logits)
    else:
        x, aux = _forward_hidden_aux(params, inputs, cfg, fsdp=fsdp)
        head = as_compute(output_head(params, cfg, fsdp), cfg.dtype)
        nll = cross_entropy_loss((x @ head).float(), targets)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}
