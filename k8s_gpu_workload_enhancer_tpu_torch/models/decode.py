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

With `cfg.kv_cache_int8` the cache holds int8 K/V and per-row (token,
kv-head) f32 scales, quantized on write (`kv_quantize`, symmetric amax/127
over the head dim, the JAX package's recipe). `forward_cached` attends over
the layer dequantized (`kv_dequantize`), the rows it has just written
included, so prefill still runs the flash kernel; the serving engine's
decode folds the scales into its logits and probabilities instead
(models/serving.py).

`scatter_rows` and `spec_write_rows` are the multi-row cache writes of the
serving engine's speculative verify rounds (models/serving.py `spec_k`).

`ffn` is the FFN of every inference pass, here and in the serving
engine's decode steps and verify rounds: SwiGLU, or for an MoE model the
dense one-hot route of `transformer._moe_ffn`, as the JAX package routes
inference.

**Tensor-parallel serving** (a `parallel/mesh.ServingMesh` of (dp, tp)).
`shard_params_for_serving` gives a rank its blocks by `SERVING_RULES`
(the training rules with `embed` and `layers` replicated: no FSDP, the
weights stay resident): attention heads, KV heads, the MLP hidden and the
vocab over tp (Megatron), the KV projections replicated over tp where
the KV heads do not divide over it (`_kv_tp_axis`, the GQA fallback);
int8 leaves shard with their q8 values, their per-channel scales
replicated on their size-1 contracted axes. The cache and the paged pool
hold the rank's KV heads (`init_cache`'s batch is the rank's rows).
`forward_cached` on a mesh above one rank runs the JAX package's
meshed program: the plain RMSNorm, RoPE, attention and a vocab-parallel
embedding on the rank's shard (the JAX package runs no Pallas kernel on a
mesh above one device), a tp sum after `wo` and after `w_down`, and the
logits gathered over tp, so every rank holds the full-vocab rows. A mesh
of one rank runs the single-device program. One body serves both: the
route helpers (`embed`, `norm`, `tp_sum`, `head_logits`, `kv_index`) pick
the kernel or the plain op and add the tp collectives, here and in the
serving engine's decode step and verify round. `generate` runs on a mesh
with the rank's rows of the prompt.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..ops.attention import _tables, attention, rope_frequencies
from ..ops.embed import embed_tokens
from ..ops.flash_attention import flash_attention_plain
from ..ops.layers import rms_norm, swiglu
from ..ops.quant import as_compute, is_quantized, _contract_axes
from ..ops.rms import rms_norm_plain
from ..ops.rope import rope_rotate, rope_rotate_plain
from ..parallel.sharding import DEFAULT_RULES
from . import transformer as tf

Params = tf.Params

# Serving shards the weights over tp (the Megatron attention and MLP split
# and the vocab-parallel embedding and head); no FSDP (the embed dim stays
# whole: serving keeps its weights resident) and no pipe axis.
SERVING_RULES = {**DEFAULT_RULES, "embed": None, "layers": None}


def _kv_tp_axis(cfg: tf.TransformerConfig, mesh) -> Optional[str]:
    """"tp" when the KV heads divide over tp, else None: K/V (and the KV
    cache) replicate over tp, the Megatron GQA serving fallback."""
    tp = mesh.tp if mesh is not None else 1
    return "tp" if cfg.n_kv_heads % max(tp, 1) == 0 else None


def kv_replicated(cfg: tf.TransformerConfig, mesh) -> bool:
    """The KV projections and cache are replicated over a tp above 1."""
    return mesh is not None and mesh.tp > 1 and _kv_tp_axis(cfg, mesh) is None


def meshed(mesh) -> bool:
    """A mesh above one rank: the meshed programs run (plain ops and the
    tp collectives); a mesh of one runs the single-device programs."""
    return mesh is not None and mesh.size > 1


def _serving_tp_dims(cfg: tf.TransformerConfig, mesh) -> dict:
    """Each leaf's dim split over tp under SERVING_RULES (None:
    replicated), by leaf name (a layer's names and the top level's do not
    overlap)."""
    rules = dict(SERVING_RULES, kv_heads=_kv_tp_axis(cfg, mesh))

    def one(axes):
        dims = [d for d, name in enumerate(axes) if rules.get(name) == "tp"]
        return dims[0] if dims else None
    axes = tf.param_logical_axes(cfg)
    return {n: one(a) for n, a in {**axes, **axes["layers"]}.items()
            if n != "layers"}


def _map_serving(fn, params: Params, cfg: tf.TransformerConfig, mesh
                 ) -> Params:
    """`fn(tensor, dim or None)` over every tensor of `params` (a param
    tree, or leaves by name): a plain leaf at its tp dim, an int8 leaf's
    q8 at the weight's and its scale at the same dim unless the matmul
    contracts it (size 1: replicated)."""
    dims = _serving_tp_dims(cfg, mesh)

    def leaf(name, v):
        d = dims[name]
        if is_quantized(v):
            sd = (None if d is None
                  or d in _contract_axes(name, v["q8"].dim()) else d)
            return {"q8": fn(v["q8"], d), "scale": fn(v["scale"], sd)}
        return fn(v, d)
    return {k: ({n: leaf(n, t) for n, t in v.items()} if k == "layers"
                else leaf(k, v)) for k, v in params.items()}


def serving_dims(params: Params, cfg: tf.TransformerConfig, mesh
                 ) -> Params:
    """`params`' tree with each tensor's tp dim (None: replicated)."""
    return _map_serving(lambda t, d: d, params, cfg, mesh)


def tp_block(t: torch.Tensor, d: Optional[int], mesh, device=None,
             copy: bool = True) -> torch.Tensor:
    """This rank's tp block of a full tensor split on dim `d`, copied
    contiguous onto `device` (default: the tensor's), or with `copy=False`
    a view (for a shape check). Where `d` is None the whole tensor, moved
    to `device` when one is given."""
    if d is not None and mesh.tp > 1:
        if t.shape[d] % mesh.tp:
            raise ValueError(f"a leaf of shape {tuple(t.shape)} cannot be "
                             f"sharded over tp={mesh.tp}: its dim {d} (size "
                             f"{t.shape[d]}) is not a multiple of {mesh.tp}")
        k = t.shape[d] // mesh.tp
        t = t.narrow(d, mesh.tp_rank * k, k)
        if copy:
            return t.to(device or t.device, copy=True).contiguous()
    return t.to(device) if copy and device is not None else t


def shard_params_for_serving(params: Params, cfg: tf.TransformerConfig,
                             mesh, device=None, copy: bool = True
                             ) -> Params:
    """This rank's blocks of a full param tree (or of leaves by name) on
    the serving mesh (see the module note): its tp block of each sharded
    dim, the whole leaf where it is replicated, on `device` (`tp_block`).
    Only the blocks are copied, so a tree on the host places no full leaf
    on the card."""
    return _map_serving(lambda t, d: tp_block(t, d, mesh, device, copy),
                        params, cfg, mesh)


def gather_params_for_serving(params: Params, cfg: tf.TransformerConfig,
                              mesh) -> Params:
    """The full tree from the tp ranks' blocks (a collective over tp: every
    rank calls it)."""
    return _map_serving(
        lambda t, d: t if d is None or mesh.tp == 1 else mesh.tp_gather(t, d),
        params, cfg, mesh)


def _kv_heads_local(cfg: tf.TransformerConfig, mesh) -> int:
    if mesh is None or _kv_tp_axis(cfg, mesh) is None:
        return cfg.n_kv_heads
    return cfg.n_kv_heads // mesh.tp


@dataclass
class KVCache:
    """k, v: (L, B, S_max, KH, D) in the activation dtype, or int8 under
    `kv_cache_int8` with per-row f32 scales kscale/vscale (L, B, S_max, KH)
    (None otherwise); a paged pool (init_paged_pool) holds (L, NB, BL, KH,
    D) pages and (L, NB, BL, KH) scales instead."""
    k: torch.Tensor
    v: torch.Tensor
    kscale: Optional[torch.Tensor] = None
    vscale: Optional[torch.Tensor] = None

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.kscale is not None

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        """k, v and, quantized, their scales: every tensor that moves
        with a KV row."""
        if self.quantized:
            return self.k, self.v, self.kscale, self.vscale
        return self.k, self.v


def kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) rows -> (int8 (..., D), f32 scale (...)): symmetric per
    row, scale = max(amax, 1e-12) / 127 over the head dim, round half to
    even, clip to +-127 (JAX decode.kv_quantize)."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().amax(dim=-1), 1e-12) / 127.0
    q8 = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q8.to(torch.int8), scale


def kv_dequantize(q8: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """int8 rows and their per-row scale -> `dtype` rows, materialized."""
    return (q8.float() * scale[..., None]).to(dtype)


def _kv_zeros(cfg: tf.TransformerConfig, shape, device) -> KVCache:
    """A zero KVCache of (..., KH, D) rows: the activation dtype, or
    int8 with f32 (..., KH) scales under kv_cache_int8."""
    dt = torch.int8 if cfg.kv_cache_int8 else cfg.dtype
    leaves = [torch.zeros(shape, dtype=dt, device=device) for _ in "kv"]
    if cfg.kv_cache_int8:
        leaves += [torch.zeros(shape[:-1], dtype=torch.float32,
                               device=device) for _ in "kv"]
    return KVCache(*leaves)


def init_cache(cfg: tf.TransformerConfig, batch: int,
               max_seq: Optional[int] = None, device="cpu",
               mesh=None) -> KVCache:
    """A zero cache of `batch` rows (on a mesh: this rank's rows and KV
    heads)."""
    max_seq = max_seq or cfg.max_seq
    return _kv_zeros(cfg, (cfg.n_layers, batch, max_seq,
                           _kv_heads_local(cfg, mesh), cfg.head_dim), device)


def init_paged_pool(cfg: tf.TransformerConfig, num_blocks: int,
                    block_len: int, device="cpu", mesh=None) -> KVCache:
    """Paged serving pool: the dense cache's KVCache with the sequence axes
    as (num_blocks, block_len) physical pages — k/v are (L, NB, BL, KH, D).
    Block 0 is the engine's trash page (models/paged_kv.TRASH_BLOCK):
    parked slots point there, so their ignored decode writes never reach
    another request's pages. Under kv_cache_int8 the pages are int8 with
    (L, NB, BL, KH) f32 scales. On a mesh the pages hold the rank's KV
    heads (never a share of the blocks: dp replicates the pool)."""
    return _kv_zeros(cfg, (cfg.n_layers, num_blocks, block_len,
                           _kv_heads_local(cfg, mesh), cfg.head_dim), device)


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


def scatter_rows(leaf: torch.Tensor, vals: torch.Tensor,
                 rows: torch.Tensor) -> None:
    """Per-slot multi-row cache write, in place: leaf (B, S, ...) <- vals
    (B, T, ...) at per-slot row indices rows (B, T). One indexed write
    (never an accumulate), so a CUDA graph captures it. Unlike a T-row
    window write, whose clamped start would shift the whole window back
    over valid rows near the cache end, each row lands on its own index;
    callers clamp out-of-range rows to a spill row whose garbage is never
    attended (spec_write_rows). Duplicate (clamped) indices land on that
    spill row only, where which write wins is a don't-care."""
    b = leaf.shape[0]
    leaf[torch.arange(b, device=leaf.device)[:, None], rows] = vals


def spec_write_rows(pos: torch.Tensor, t: int, max_seq: int) -> torch.Tensor:
    """Write rows for a t-token speculative block at per-slot positions
    pos (B,): row i of slot b is min(pos[b] + i, max_seq - 1). Rows clamped
    to the last cache row are SPILL writes: engines running speculation
    keep that row out of every request's live range (prompt + max_new <=
    max_seq - 1), so spilled garbage is never attended and never overwrites
    a row a live query needs this round."""
    return torch.clamp(
        pos[:, None] + torch.arange(t, device=pos.device)[None, :],
        max=max_seq - 1)


def ffn(h: torch.Tensor, lp: Params, cfg: tf.TransformerConfig
        ) -> torch.Tensor:
    """The FFN of inference on rows h (..., D): SwiGLU, or with experts
    the dense one-hot route of `_moe_ffn` (JAX decode.py: inference always
    routes dense, so capacity never drops a generated token; at a decode
    step's few rows the ragged route's capacity would drop under any
    router skew)."""
    dt = cfg.dtype
    if cfg.is_moe:
        rows = h.reshape(-1, 1, h.shape[-1])
        y, _ = tf._moe_ffn(
            rows, lp, dataclasses.replace(cfg, moe_ragged_dispatch=False))
        return y.reshape(h.shape)
    return swiglu(h, as_compute(lp["w_gate"], dt), as_compute(lp["w_up"], dt),
                  as_compute(lp["w_down"], dt))


def embed(params: Params, toks: torch.Tensor, cfg: tf.TransformerConfig,
          mesh=None) -> torch.Tensor:
    """The embedding rows of `toks`: the gather kernel's, or on a mesh
    above one rank the vocab-parallel lookup summed over tp."""
    if meshed(mesh):
        return tf._embed_vocab_parallel(params["embed"], toks, cfg, mesh)
    return embed_tokens(params["embed"], toks, cfg.d_model, cfg.dtype)


def norm(x: torch.Tensor, w: torch.Tensor, mesh=None) -> torch.Tensor:
    """RMSNorm: the kernel, or the plain version on a mesh above one rank
    (the JAX package's `pallas_ok`)."""
    return rms_norm_plain(x, w) if meshed(mesh) else rms_norm(x, w)


def tp_sum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """A row-parallel product's partials summed over tp (on a mesh)."""
    return mesh.tp_sum(x) if meshed(mesh) else x


def head_logits(x: torch.Tensor, params: Params, cfg: tf.TransformerConfig,
                mesh=None) -> torch.Tensor:
    """f32 logits (N, V) of hidden rows (..., D); on a mesh each tp rank's
    vocab columns, gathered, so every rank samples from the full row."""
    if meshed(mesh):
        return mesh.tp_gather(tf._vocab_parallel_logits(
            x, tf.output_head(params, cfg), cfg, mesh), -1)
    head = as_compute(tf.output_head(params, cfg), cfg.dtype)
    return (x @ head).float().reshape(-1, head.shape[-1])


def kv_index(cfg: tf.TransformerConfig, mesh, device
             ) -> Optional[torch.Tensor]:
    """Where the KV heads are replicated over tp: the KV head each of the
    rank's Q heads reads (None otherwise)."""
    if not kv_replicated(cfg, mesh):
        return None
    return tf._kv_heads_of_rank(cfg, mesh, device)


def pick_heads(t: Optional[torch.Tensor], idx: Optional[torch.Tensor]
               ) -> Optional[torch.Tensor]:
    """t (B, S, KH, ...) through the KV heads `idx` (None: as it is)."""
    return t if t is None or idx is None else t.index_select(2, idx)


def forward_cached(params: Params, tokens: torch.Tensor, cache: KVCache,
                   pos: int, cfg: tf.TransformerConfig, *,
                   freqs: Optional[torch.Tensor] = None, mesh=None
                   ) -> Tuple[torch.Tensor, KVCache]:
    """One cached forward pass.

    tokens: (B, T), the T new tokens whose global positions start at `pos`
    (prefill: pos = offset of the chunk, T = its length; decode: T = 1).
    Writes their K/V into `cache` in place and attends over cache positions
    [0, pos + T). `freqs` is the rope_frequencies table of the cache's
    length; callers that run many passes build it once and pass it in.
    A quantized cache takes the rows int8 with their scales, and the
    attention reads the layer dequantized (its new rows too), as in the
    JAX package. Returns (logits (B, T, V) f32, the same cache). On a mesh
    above one rank `params` and `cache` are the rank's blocks and the
    meshed program runs (the module note): the plain ops, the rank's
    heads, MLP hidden and vocab, a tp sum after the attention's and the
    MLP's row-parallel products, the logits gathered over tp; with the KV
    heads replicated over tp each Q head reads its KV head."""
    dt = cfg.dtype
    b, t = tokens.shape
    hd, d = cfg.head_dim, cfg.d_model
    plain = meshed(mesh)
    x = embed(params, tokens, cfg, mesh)
    if freqs is None:
        freqs = rope_frequencies(hd, cache.max_seq, cfg.rope_theta, x.device)
    cos, sin = _tables(freqs, t, pos)
    rope = rope_rotate_plain if plain else rope_rotate
    attend = flash_attention_plain if plain else attention
    kv_idx = kv_index(cfg, mesh, x.device)
    # The write window clamps into the cache like a dynamic_update_slice.
    start = max(0, min(int(pos), cache.max_seq - t))
    for layer in range(cfg.n_layers):
        lp = tf.layer_params(params, layer)
        h2 = norm(x, lp["ln1"], mesh).reshape(b * t, d)

        def project(w):
            return (h2 @ as_compute(w, dt).reshape(d, -1)).reshape(
                b, t, -1, hd)
        q, k, v = project(lp["wq"]), project(lp["wk"]), project(lp["wv"])
        q, k = rope(q, cos, sin), rope(k, cos, sin)
        ka, va = _write_rows(cache, layer, start, k, v, dt)
        o = attend(q, pick_heads(ka, kv_idx), pick_heads(va, kv_idx),
                   causal=True, q_offset=pos, kv_offset=0)
        x = x + tp_sum((o.reshape(b * t, -1)
                        @ as_compute(lp["wo"], dt).reshape(-1, d)
                        ).reshape(b, t, d), mesh)
        h = norm(x, lp["ln2"], mesh)
        x = x + tp_sum(ffn(h, lp, cfg), mesh)
    x = norm(x, params["final_ln"], mesh)
    return head_logits(x, params, cfg, mesh).reshape(b, t, -1), cache


def _write_rows(cache: KVCache, layer: int, start: int, k: torch.Tensor,
                v: torch.Tensor, dt: torch.dtype
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write the T new K/V rows of `layer` at [start, start + T) (quantized
    first on an int8 cache) and return the layer's rows to attend over."""
    t = k.shape[1]
    if cache.quantized:
        for rows, scales, val in ((cache.k, cache.kscale, k),
                                  (cache.v, cache.vscale, v)):
            q8, sc = kv_quantize(val)
            rows[layer, :, start:start + t] = q8
            scales[layer, :, start:start + t] = sc
        return (kv_dequantize(cache.k[layer], cache.kscale[layer], dt),
                kv_dequantize(cache.v[layer], cache.vscale[layer], dt))
    cache.k[layer, :, start:start + t] = k
    cache.v[layer, :, start:start + t] = v
    return cache.k[layer], cache.v[layer]


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
             generator: Optional[torch.Generator] = None,
             mesh=None) -> torch.Tensor:
    """Prefill on `prompt` (B, P), then decode `num_steps` tokens.
    Returns (B, P + num_steps): the prompt with its continuation. On a
    mesh `params` are the rank's blocks and `prompt` its rows; every rank
    samples the same tokens from the same full-vocab rows."""
    b, p = prompt.shape
    if num_steps <= 0:
        return prompt
    max_seq = max_seq or cfg.max_seq
    if p + num_steps > max_seq:
        raise ValueError(f"generation of {p} + {num_steps} tokens exceeds "
                         f"the {max_seq}-row cache")
    prompt = prompt.long()
    cache = init_cache(cfg, b, max_seq, prompt.device, mesh)
    freqs = rope_frequencies(cfg.head_dim, max_seq, cfg.rope_theta,
                             prompt.device)
    logits, cache = forward_cached(params, prompt, cache, 0, cfg,
                                   freqs=freqs, mesh=mesh)
    tok = _sample(logits[:, -1], generator, temperature, top_k)
    out = [tok]
    for step in range(num_steps - 1):
        logits, cache = forward_cached(params, tok[:, None], cache, p + step,
                                       cfg, freqs=freqs, mesh=mesh)
        tok = _sample(logits[:, -1], generator, temperature, top_k)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
