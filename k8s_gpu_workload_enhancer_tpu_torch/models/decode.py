"""Autoregressive inference for KTWE-LM: KV cache, prefill, decode,
sampling.

Port of k8s_gpu_workload_enhancer_tpu/models/decode.py (dense cache, one
device). The cache is allocated at `max_seq`; positions past the write
frontier are hidden by the causal mask on global positions, exactly as in
the JAX package. Where JAX threads the cache functionally through a layer
`scan`, the port writes each layer's new rows into `cache.k[l]` /
`cache.v[l]` IN PLACE: a forward pass copies no cache, it only writes the
T new rows per layer.

The paged pool (`init_paged_pool`, `paged_rows`) is the same KVCache with
the sequence axes cut into (num_blocks, block_len) pages; the paged engine
(models/serving.py, `kv_block_len > 0`) addresses it through per-slot
block tables.

Not ported here: the int8 KV cache and mesh sharding.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..ops.attention import apply_rope, attention, rope_frequencies
from ..ops.embed import embed_tokens
from ..ops.layers import rms_norm, swiglu
from ..ops.quant import as_compute
from . import transformer as tf

Params = tf.Params


@dataclass
class KVCache:
    """k, v: (L, B, S_max, KH, D) in the activation dtype; a paged pool
    (init_paged_pool) holds (L, NB, BL, KH, D) pages instead."""
    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]


def init_cache(cfg: tf.TransformerConfig, batch: int,
               max_seq: Optional[int] = None, device="cpu") -> KVCache:
    max_seq = max_seq or cfg.max_seq
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=device))


def init_paged_pool(cfg: tf.TransformerConfig, num_blocks: int,
                    block_len: int, device="cpu") -> KVCache:
    """Paged serving pool: the dense cache's KVCache with the sequence axes
    as (num_blocks, block_len) physical pages — k/v are (L, NB, BL, KH, D).
    Block 0 is the engine's trash page (models/paged_kv.TRASH_BLOCK):
    parked slots point there, so their ignored decode writes never reach
    another request's pages."""
    shape = (cfg.n_layers, num_blocks, block_len, cfg.n_kv_heads,
             cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=device))


def paged_rows(table: torch.Tensor, positions: torch.Tensor,
               block_len: int) -> torch.Tensor:
    """Physical pool-row ids for logical `positions`.

    table: (..., max_blocks) int physical block ids per slot; positions:
    broadcastable int logical positions. Row of logical j is
    ``table[j // block_len] * block_len + j % block_len``; table entries
    beyond a slot's reservation are TRASH_BLOCK (0), so a clamped or
    parked position lands in the trash page, never in another slot's
    pages."""
    blk = torch.div(positions, block_len, rounding_mode="floor")
    blk = blk.expand(*table.shape[:-1], blk.shape[-1])
    phys = torch.gather(table, -1, blk.to(torch.int64))
    return phys * block_len + positions % block_len


def forward_cached(params: Params, tokens: torch.Tensor, cache: KVCache,
                   pos: int, cfg: tf.TransformerConfig, *,
                   freqs: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, KVCache]:
    """One cached forward pass.

    tokens: (B, T), the T new tokens whose global positions start at `pos`
    (prefill: pos = offset of the chunk, T = its length; decode: T = 1).
    Writes their K/V into `cache` in place and attends over cache positions
    [0, pos + T). `freqs` is the rope_frequencies table of the cache's
    length; callers that run many passes build it once and pass it in.
    Returns (logits (B, T, V) f32, the same cache)."""
    dt = cfg.dtype
    b, t = tokens.shape
    nh, nkh, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    x = embed_tokens(params["embed"], tokens, d, dt)
    if freqs is None:
        freqs = rope_frequencies(hd, cache.max_seq, cfg.rope_theta, x.device)
    # The write window clamps into the cache like a dynamic_update_slice.
    start = max(0, min(int(pos), cache.max_seq - t))
    for layer in range(cfg.n_layers):
        lp = tf.layer_params(params, layer)
        h2 = rms_norm(x, lp["ln1"]).reshape(b * t, d)
        q = (h2 @ as_compute(lp["wq"], dt).reshape(d, nh * hd)
             ).reshape(b, t, nh, hd)
        k = (h2 @ as_compute(lp["wk"], dt).reshape(d, nkh * hd)
             ).reshape(b, t, nkh, hd)
        v = (h2 @ as_compute(lp["wv"], dt).reshape(d, nkh * hd)
             ).reshape(b, t, nkh, hd)
        q = apply_rope(q, freqs, pos)
        k = apply_rope(k, freqs, pos)
        cache.k[layer, :, start:start + t] = k
        cache.v[layer, :, start:start + t] = v
        o = attention(q, cache.k[layer], cache.v[layer], causal=True,
                      q_offset=pos, kv_offset=0)
        x = x + (o.reshape(b * t, nh * hd)
                 @ as_compute(lp["wo"], dt).reshape(nh * hd, d)
                 ).reshape(b, t, d)
        h = rms_norm(x, lp["ln2"])
        x = x + swiglu(h, as_compute(lp["w_gate"], dt),
                       as_compute(lp["w_up"], dt),
                       as_compute(lp["w_down"], dt))
    x = rms_norm(x, params["final_ln"])
    head = as_compute(tf.output_head(params, cfg), dt)
    return (x @ head).float(), cache


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature: float, top_k: int) -> torch.Tensor:
    """logits (B, V) -> (B,) int64. temperature 0 = greedy (the first
    maximal index, as jnp.argmax)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(params: Params, prompt: torch.Tensor, num_steps: int,
             cfg: tf.TransformerConfig, *, max_seq: Optional[int] = None,
             temperature: float = 0.0, top_k: int = 0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Prefill on `prompt` (B, P), then decode `num_steps` tokens.
    Returns (B, P + num_steps): the prompt with its continuation."""
    b, p = prompt.shape
    if num_steps <= 0:
        return prompt
    max_seq = max_seq or cfg.max_seq
    if p + num_steps > max_seq:
        raise ValueError(f"generation of {p} + {num_steps} tokens exceeds "
                         f"the {max_seq}-row cache")
    prompt = prompt.long()
    cache = init_cache(cfg, b, max_seq, prompt.device)
    freqs = rope_frequencies(cfg.head_dim, max_seq, cfg.rope_theta,
                             prompt.device)
    logits, cache = forward_cached(params, prompt, cache, 0, cfg,
                                   freqs=freqs)
    tok = _sample(logits[:, -1], generator, temperature, top_k)
    out = [tok]
    for step in range(num_steps - 1):
        logits, cache = forward_cached(params, tok[:, None], cache, p + step,
                                       cfg, freqs=freqs)
        tok = _sample(logits[:, -1], generator, temperature, top_k)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
