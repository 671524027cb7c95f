"""Continuous-batching serving engine for KTWE-LM (one device).

Port of the dense and the paged engine of
k8s_gpu_workload_enhancer_tpu/models/serving.py.

- **Slots.** A fixed pool of `num_slots` rows in one static (L, N, S, KH, D)
  KV cache. Requests are admitted into free slots and evicted on
  completion on the host; device shapes never change.
- **Paged KV** (`kv_block_len > 0`). The cache becomes a pool of
  (num_blocks, block_len) pages (decode.init_paged_pool) and each slot a
  block-table row. A request reserves the pages its prompt + max_new span
  needs, all or nothing, evicting cold radix pages LRU; when the pool is
  short it waits at the queue head (deferred), and a reservation that can
  never fit fails. Prompt full blocks are published to a radix tree
  (models/paged_kv.py) and later prompts with the same prefix map those
  pages read-only instead of recomputing them. Decode attention walks the
  table in the paged decode kernel (ops/paged_attention.py). Block 0 is the
  trash page: a freed slot's table row is parked there, so its ignored
  decode writes never reach pages another request now owns. A freed page
  is handed out again at once; that is safe because all device work runs
  in order on one stream and the engine collects every chunk before it
  dispatches the next, so no chunk that read the old table is in flight.
- **Per-slot positions.** Each slot decodes at its own frontier `pos[b]`:
  RoPE rows are gathered at `pos`, the new K/V row is written at `pos`
  BEFORE the attention read, and attention masks `j <= pos[b]`, so a freed
  slot's stale rows are never attended and the next request may reuse it.
  Parked slots keep stepping with `pos` clamped at `max_seq - 1`.
- **Chunked decode.** `decode_chunk` steps per dispatch; the chunk's tokens
  and their logprobs come back in ONE (C, B, 2) int32 array (tokens, and
  the f32 logprobs bitcast), the engine's one device sync per chunk.
- **Chunked prefill.** A prompt is prefilled in `prefill_len` chunks at
  offsets that are multiples of prefill_len, through a batch-1 temp cache,
  then committed into its slot; at most `prefill_interleave` chunks run per
  step while any slot is decoding. The final chunk samples the request's
  first token, which lands on the host right away (the TTFT stamp).
- **Lifecycle.** `submit` bounds the queue (`QueueFull`), `cancel` evicts
  wherever the request is, results stay until `release`d or aged out past
  `keep_results`, `drain` stops admission (`Draining`). A fault in one
  phase fails only the requests that phase touched.
- **Registered prefixes.** `register_prefix` prefills a shared prompt
  prefix once. Dense: its first (len // prefill_len) * prefill_len tokens
  stay as a frozen batch-1 temp cache, and a `submit(prefix_id=)`
  admission starts from a COPY of it at that grid offset (the port's
  prefill writes its temp cache in place, so borrowing the cache itself
  would let the first borrower's suffix rows overwrite the prefix). Paged:
  the prefix's full blocks are prefilled into pool pages, inserted into
  the radix tree and pinned, so every admission sharing them matches them.
- **Migration.** `eject` finishes a live request as "migrated" with a
  resume state (prompt, committed tokens, total budget, sampling params,
  stop sequences, sampling key); `submit(committed=)` continues such a
  state: the committed tokens prefill as context (riding the radix tree on
  the paged engine), count against the total budget and are never
  re-emitted, and the first new token samples at index len(committed), so
  a sampled resume continues the uninterrupted stream.
- **Weight hot-swap.** `swap_params` validates a new param tree against
  the engine's (structure, shapes, dtypes) before it touches anything,
  places it on the device, re-prefills every registered prefix under the
  new weights and commits it all between steps. On the paged engine the
  radix tree is detached (its pages hold old-weight KV), the prefixes'
  new pages are inserted and pinned, and a prefill in flight across the
  swap never publishes its blocks.
- **Sampling.** Greedy slots take the argmax (the first maximal index, as
  jnp.argmax, so greedy tokens match the JAX engine). A sampled token is a
  pure function of (request key, sample index): Gumbel-max noise from a
  torch.Generator seeded by both, so a sampled stream does not depend on
  slot or batch company.

The norms, prefill RoPE, prefill attention and paged decode attention run
the hand-written CUDA kernels on the card (ops/). Dense decode attention,
decode RoPE, the KV writes and sampling are plain torch, as they are plain
XLA in the JAX package. Where JAX donates the cache to each program and
threads it through a layer `scan`, the port writes the cache's new rows in
place: no step copies it, and a prefill commits only the rows it owns.

Not ported here (later slices): speculative decoding, the host-RAM KV
tier, preemption, the int8 KV cache, meshes, the prefill role's
first-token handoff, tenancy (a resume state carries the tenancy keys at
their defaults), the watchdog and FaultLab
sites, phase events, and the overlapped dispatch/commit pipeline (this
engine collects every chunk before it dispatches the next).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.attention import NEG_INF, rope_frequencies
from ..ops.embed import embed_tokens
from ..ops.layers import rms_norm, swiglu
from ..ops.paged_attention import paged_decode_attention
from ..ops.quant import as_compute
from ..utils.device import resolve_device
from ..utils.stats import percentile
from . import decode, paged_kv
from . import transformer as tf

Params = tf.Params


def _map_leaves(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def _check_same_tree(old, new, path: str = "") -> None:
    """ValueError unless `new` has `old`'s dict structure and every leaf is
    a tensor of the same shape and dtype."""
    if isinstance(old, dict):
        if not isinstance(new, dict) or set(new) != set(old):
            raise ValueError(
                f"param tree structure mismatch at {path or 'root'}: engine "
                f"has {sorted(old)}, got "
                f"{sorted(new) if isinstance(new, dict) else type(new)}")
        for k in old:
            _check_same_tree(old[k], new[k], f"{path}/{k}")
        return
    if (not isinstance(new, torch.Tensor) or new.shape != old.shape
            or new.dtype != old.dtype):
        raise ValueError(
            f"param leaf {path} mismatch: engine has shape "
            f"{tuple(old.shape)} dtype {old.dtype}, got shape "
            f"{tuple(getattr(new, 'shape', ()))} dtype "
            f"{getattr(new, 'dtype', type(new))}")


class QueueFull(RuntimeError):
    """submit() beyond max_queue: callers map it to backpressure (HTTP
    429). `retryable` tells pressure that clears on its own (the queue, a
    paged pool under eviction: a Retry-After helps) from a full prefix
    registry, which only a release clears (no Retry-After)."""

    def __init__(self, message: str, retryable: bool = True):
        super().__init__(message)
        self.retryable = retryable


class Draining(RuntimeError):
    """submit() after drain(): accepted work finishes, nothing new is
    admitted (HTTP 503 + Retry-After)."""


# ---------------------------------------------------------------------------
# Device programs
# ---------------------------------------------------------------------------


def _rope_at(x: torch.Tensor, freqs: torch.Tensor,
             pos: torch.Tensor) -> torch.Tensor:
    """Rotate x (B, H, D) at per-slot positions pos (B,): the rotate-half
    convention of ops/attention.apply_rope with the frequency rows gathered
    per slot."""
    d = x.shape[-1]
    fr = freqs[pos]                                       # (B, D/2, 2)
    cos = torch.cat([fr[..., 0], fr[..., 0]], dim=-1)[:, None, :]
    sin = torch.cat([fr[..., 1], fr[..., 1]], dim=-1)[:, None, :]
    xf = x.float()
    rot = torch.cat([-xf[..., d // 2:], xf[..., :d // 2]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


def _write_slot(cache: torch.Tensor, kv: torch.Tensor,
                pos: torch.Tensor) -> None:
    """cache (B, S, KH, D) <- kv (B, KH, D) at row pos[b] of each slot, in
    place (one indexed write, no cache copy)."""
    cache[torch.arange(cache.shape[0], device=cache.device), pos] = kv


def _mix64(*words: int) -> int:
    """A 63-bit seed from integer words (splitmix64 finalizer per word)."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (int(w) & 0xFFFFFFFFFFFFFFFF)) * 0xBF58476D1CE4E5B9
        h &= 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
        h = (h * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 29
    return h & 0x7FFFFFFFFFFFFFFF


def _sample_per_slot(logits: torch.Tensor, keys: np.ndarray,
                     counts: Sequence[int], temps: np.ndarray,
                     top_ps: np.ndarray, top_k: int,
                     enable_top_p: bool) -> torch.Tensor:
    """logits (B, V) -> (B,) int64 with PER-SLOT sampling params.

    temps[b] <= 0 is greedy (argmax). A sampled slot filters by the
    engine-wide top_k and, with enable_top_p, its nucleus mass top_ps[b]
    (exclusive cumulative mass, so the first token always survives), then
    draws by Gumbel-max with noise seeded from (keys[b], counts[b]): the
    draw is a pure function of the request's key and sample index."""
    greedy = torch.argmax(logits, dim=-1)
    sampled = np.nonzero(np.asarray(temps) > 0.0)[0]
    if len(sampled) == 0:
        return greedy
    out = greedy.clone()
    for b in sampled:
        row = logits[b].float() / max(float(temps[b]), 1e-6)
        if top_k > 0:
            cutoff = torch.topk(row, top_k).values[-1]
            row = torch.where(row < cutoff, float("-inf"), row)
        if enable_top_p and float(top_ps[b]) < 1.0:
            probs = torch.softmax(row, dim=-1)
            sp = torch.sort(probs, descending=True).values
            keep = (torch.cumsum(sp, dim=-1) - sp) < float(top_ps[b])
            cutoff = sp[int(keep.sum()) - 1]
            row = torch.where(probs >= cutoff, row, float("-inf"))
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(_mix64(keys[b][0], keys[b][1], counts[b]))
        u = torch.rand(row.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        out[b] = torch.argmax(row + gumbel)
    return out


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b accumulated and returned in f32 (JAX's
    preferred_element_type=f32) without an f32 copy of a bf16 operand."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())      # no copy when already f32


@dataclass
class _Sampling:
    """Per-slot sampling state for one dispatch (host arrays)."""
    keys: np.ndarray          # (B, 2) uint32 request base keys
    counts: np.ndarray        # (B,) sample index of the next token
    temps: np.ndarray         # (B,) f32, <= 0 greedy
    top_ps: np.ndarray        # (B,) f32
    top_k: int = 0
    enable_top_p: bool = False

    def at(self, step: int) -> "_Sampling":
        return _Sampling(self.keys, self.counts + step, self.temps,
                         self.top_ps, self.top_k, self.enable_top_p)


Attend = Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor],
                  torch.Tensor]


def _dense_attend(cache: decode.KVCache, pos: torch.Tensor,
                  cfg: tf.TransformerConfig) -> Attend:
    """Decode attention over the dense cache: layer `layer`'s new K/V rows
    go in place at pos[b] of each slot, then each slot attends j <=
    pos[b]."""
    b, s_max = cache.k.shape[1], cache.max_seq
    nh, nkh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mask = (torch.arange(s_max, device=pos.device)[None, :]
            <= pos[:, None])                                        # (B, S)

    def attend(layer, q, k, v):
        _write_slot(cache.k[layer], k, pos)
        _write_slot(cache.v[layer], v, pos)
        # Query heads grouped by KV head (GQA without repeating the cache);
        # the cache is read in its own dtype, with f32 products.
        kt = cache.k[layer].transpose(1, 2).reshape(b * nkh, s_max, hd)
        vt = cache.v[layer].transpose(1, 2).reshape(b * nkh, s_max, hd)
        qg = q.reshape(b * nkh, nh // nkh, hd)
        logits = (_bmm_f32(qg, kt.transpose(1, 2)) * hd ** -0.5
                  ).reshape(b, nh, s_max)
        logits = torch.where(mask[:, None, :], logits, NEG_INF)
        p = torch.softmax(logits, dim=-1).to(q.dtype)
        o = _bmm_f32(p.reshape(b * nkh, nh // nkh, s_max), vt)
        return o.reshape(b, nh, hd).to(q.dtype)
    return attend


def _paged_attend(pool: decode.KVCache, table: torch.Tensor,
                  pos: torch.Tensor, block_len: int) -> Attend:
    """Decode attention through the block table: layer `layer`'s new K/V
    rows go in place at each slot's physical row of pos[b] (a parked slot's
    land in the trash page), then the paged decode kernel attends j <=
    pos[b] page by page."""
    nb, bl, nkh, hd = pool.k.shape[1:]
    wrow = decode.paged_rows(table, pos[:, None], block_len)[:, 0]   # (B,)
    pos32 = pos.to(torch.int32)

    def attend(layer, q, k, v):
        pool.k[layer].view(nb * bl, nkh, hd)[wrow] = k
        pool.v[layer].view(nb * bl, nkh, hd)[wrow] = v
        return paged_decode_attention(q, pool.k[layer], pool.v[layer], table,
                                      pos32, block_len=block_len)
    return attend


def _decode_step(params: Params, toks: torch.Tensor, pos: torch.Tensor,
                 cfg: tf.TransformerConfig, freqs: torch.Tensor,
                 sampling: _Sampling, attend: Attend
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batched decode step at per-slot positions. toks, pos: (B,).
    `attend` writes each layer's new K/V rows and returns its attention.
    Returns (next token (B,) int64, its logprob (B,) f32)."""
    dt = cfg.dtype
    b = toks.shape[0]
    nh, nkh, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    x = embed_tokens(params["embed"], toks, d, dt)                 # (B, D)
    for layer in range(cfg.n_layers):
        lp = tf.layer_params(params, layer)
        h = rms_norm(x, lp["ln1"])
        q = (h @ as_compute(lp["wq"], dt).reshape(d, nh * hd)
             ).reshape(b, nh, hd)
        k = (h @ as_compute(lp["wk"], dt).reshape(d, nkh * hd)
             ).reshape(b, nkh, hd)
        v = (h @ as_compute(lp["wv"], dt).reshape(d, nkh * hd)
             ).reshape(b, nkh, hd)
        o = attend(layer, _rope_at(q, freqs, pos), _rope_at(k, freqs, pos), v)
        x = x + (o.reshape(b, nh * hd)
                 @ as_compute(lp["wo"], dt).reshape(nh * hd, d))
        h2 = rms_norm(x, lp["ln2"])
        x = x + swiglu(h2, as_compute(lp["w_gate"], dt),
                       as_compute(lp["w_up"], dt),
                       as_compute(lp["w_down"], dt))
    x = rms_norm(x, params["final_ln"])
    head = as_compute(tf.output_head(params, cfg), dt)
    logits = (x @ head).float()                                     # (B, V)
    nxt = _sample_per_slot(logits, sampling.keys, sampling.counts,
                           sampling.temps, sampling.top_ps, sampling.top_k,
                           sampling.enable_top_p)
    # Model logprob of the chosen token (raw log-softmax, independent of
    # the sampling filters).
    lp_tok = torch.log_softmax(logits, dim=-1).gather(1, nxt[:, None])[:, 0]
    return nxt, lp_tok


def _pack(toks: torch.Tensor, lps: torch.Tensor) -> torch.Tensor:
    """(C, B) tokens and (C, B) f32 logprobs -> (C, B, 2) int32, the
    logprobs bitcast (bit-exact)."""
    return torch.stack([toks.to(torch.int32),
                        lps.float().contiguous().view(torch.int32)], dim=-1)


def _unpack(packed_h: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host (C, B, 2) int32 -> ((C, B) tokens, (C, B) f32 logprobs), both
    views of the one fetched buffer."""
    packed_h = np.ascontiguousarray(packed_h)
    return packed_h[..., 0], packed_h.view(np.float32)[..., 1]


def _steps(params: Params, toks: torch.Tensor, pos: torch.Tensor,
           cfg: tf.TransformerConfig, steps: int, freqs: torch.Tensor,
           sampling: _Sampling, s_max: int,
           attend_at: Callable[[torch.Tensor], Attend]) -> torch.Tensor:
    """`steps` decode steps, attending through `attend_at(pos)`; returns
    the packed (C, B, 2) int32 result. Step n of slot b samples at index
    sampling.counts[b] + n. Parked slots' positions clamp at s_max - 1 so
    their ignored writes stay in bounds."""
    out, lps = [], []
    for n in range(steps):
        toks, lp = _decode_step(params, toks, pos, cfg, freqs,
                                sampling.at(n), attend_at(pos))
        out.append(toks)
        lps.append(lp)
        pos = torch.clamp(pos + 1, max=s_max - 1)
    return _pack(torch.stack(out), torch.stack(lps))


def _decode_chunk(params: Params, cache: decode.KVCache, toks: torch.Tensor,
                  pos: torch.Tensor, cfg: tf.TransformerConfig, steps: int,
                  freqs: torch.Tensor, sampling: _Sampling) -> torch.Tensor:
    """`steps` decode steps over the dense cache."""
    return _steps(params, toks, pos, cfg, steps, freqs, sampling,
                  cache.max_seq, lambda p: _dense_attend(cache, p, cfg))


def _decode_chunk_paged(params: Params, pool: decode.KVCache,
                        table: torch.Tensor, toks: torch.Tensor,
                        pos: torch.Tensor, cfg: tf.TransformerConfig,
                        steps: int, freqs: torch.Tensor, sampling: _Sampling,
                        block_len: int) -> torch.Tensor:
    """`steps` decode steps through the block table (B, MB) int32, which
    does not change within a chunk: a reservation covers the request's
    whole prompt + max_new span from admission."""
    return _steps(params, toks, pos, cfg, steps, freqs, sampling,
                  table.shape[1] * block_len,
                  lambda p: _paged_attend(pool, table, p, block_len))


def _init_temp_cache(cfg: tf.TransformerConfig, max_seq: int,
                     device) -> decode.KVCache:
    """Batch-1 temp prefill cache."""
    return decode.init_cache(cfg, 1, max_seq, device)


def _prefill_step(params: Params, temp: decode.KVCache, chunk: torch.Tensor,
                  cfg: tf.TransformerConfig, offset: int,
                  freqs: torch.Tensor) -> decode.KVCache:
    """One NON-final prefill chunk: advance the temp cache over `chunk`
    (1, P) of real tokens at global offset `offset`; the logits are
    discarded."""
    _, temp = decode.forward_cached(params, chunk, temp, offset, cfg,
                                    freqs=freqs)
    return temp


def _prefill_final(params: Params, cache: decode.KVCache,
                   temp: decode.KVCache, chunk: torch.Tensor, slot: int,
                   plen: int, cfg: tf.TransformerConfig, offset: int,
                   freqs: torch.Tensor,
                   sampling: _Sampling) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final prefill chunk: advance the temp cache over the (padded) last
    `chunk`, copy the whole temp cache into engine slot `slot`, and sample
    the first token from the logits at plen - 1 (plen = real tokens in this
    chunk). Pad rows hold garbage K/V that decode overwrites before the
    mask ever reaches them. Returns (token, logprob) device scalars."""
    logits, temp = decode.forward_cached(params, chunk, temp, offset, cfg,
                                         freqs=freqs)
    cache.k[:, slot].copy_(temp.k[:, 0])
    cache.v[:, slot].copy_(temp.v[:, 0])
    return _first_token(logits[0, plen - 1], sampling)


def _first_token(last: torch.Tensor, sampling: _Sampling
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample a request's first token from its last prompt row's logits
    (V,); returns (token, logprob) device scalars."""
    tok = _sample_per_slot(last[None], sampling.keys, sampling.counts,
                           sampling.temps, sampling.top_ps, sampling.top_k,
                           sampling.enable_top_p)[0]
    return tok, torch.log_softmax(last, dim=-1)[tok]


def _pool_rows(row: np.ndarray, start: int, stop: int, block_len: int,
               device) -> torch.Tensor:
    """Physical pool rows of logical positions [start, stop) of a slot
    whose block-table row is `row` (host int32)."""
    return decode.paged_rows(torch.as_tensor(row, device=device),
                             torch.arange(start, stop, device=device),
                             block_len)


def _temp_from_pool(pool: decode.KVCache, row: np.ndarray, matched: int,
                    max_seq: int, block_len: int) -> decode.KVCache:
    """A batch-1 temp prefill cache whose first `matched` rows are gathered
    from the pool (a radix-matched prefix), the rest zero: suffix prefill
    chunks attend over the shared prefix KV without recomputing it."""
    l, nb, bl, kh, d = pool.k.shape
    rows = _pool_rows(row, 0, matched, block_len, pool.k.device)

    def gather(pages: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((l, 1, max_seq, kh, d), dtype=pages.dtype,
                          device=pages.device)
        out[:, 0, :matched] = pages.view(l, nb * bl, kh, d)[:, rows]
        return out
    return decode.KVCache(k=gather(pool.k), v=gather(pool.v))


def _commit_rows(pool: decode.KVCache, temp: decode.KVCache, row: np.ndarray,
                 write_from: int, write_to: int, block_len: int) -> None:
    """Scatter temp rows [write_from, write_to) into the slot's pool pages
    through its table row, in place (JAX's _commit_window_rows +
    _pool_commit_rows). Rows outside the window are not written at all, so
    shared prefix pages stay read-only and pad garbage never lands; the
    JAX package's trash redirect of those rows is not needed."""
    l, nb, bl, kh, d = pool.k.shape
    rows = _pool_rows(row, write_from, write_to, block_len, pool.k.device)
    for pages, src in ((pool.k, temp.k), (pool.v, temp.v)):
        pages.view(l, nb * bl, kh, d)[:, rows] = src[:, 0, write_from:write_to]


def _prefill_final_paged(params: Params, pool: decode.KVCache,
                         temp: decode.KVCache, chunk: torch.Tensor,
                         row: np.ndarray, write_from: int, write_to: int,
                         plen: int, cfg: tf.TransformerConfig, offset: int,
                         freqs: torch.Tensor, sampling: _Sampling,
                         block_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paged twin of _prefill_final: advance the temp cache over the
    (padded) last chunk, commit rows [write_from, write_to) — the part of
    the prompt no shared page holds — into the slot's pages, and sample the
    first token from the logits at plen - 1 (real tokens in this chunk)."""
    logits, temp = decode.forward_cached(params, chunk, temp, offset, cfg,
                                         freqs=freqs)
    _commit_rows(pool, temp, row, write_from, write_to, block_len)
    return _first_token(logits[0, plen - 1], sampling)


# ---------------------------------------------------------------------------
# Host-side engine
# ---------------------------------------------------------------------------


@dataclass
class ServeRequest:
    req_id: int
    prompt: List[int]
    max_new_tokens: int
    tokens: List[int] = field(default_factory=list)
    # Model logprob (raw log-softmax at the chosen token), parallel to tokens.
    logprobs: List[float] = field(default_factory=list)
    # Per-token latency seconds: TTFT for the first token, then chunk wall /
    # chunk length for every token of a chunk.
    token_lat_s: List[float] = field(default_factory=list)
    submitted_at: float = 0.0
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None
    cancelled: bool = False
    # Per-request sampling (None = the engine defaults).
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    # Stop sequences (token-id lists); a matched tail is trimmed.
    stop: List[List[int]] = field(default_factory=list)
    # length|eos|stop|cancelled|error|migrated
    finish_reason: Optional[str] = None
    error: Optional[str] = None
    # Sampling base key (two uint32 words): token n draws from (key, n).
    base_key: Any = None
    # Registered prefix this request rides on (None = plain); `prompt`
    # holds the full sequence, prefix + suffix.
    prefix_id: Optional[int] = None
    # Resumed requests: tokens[:emit_from] were generated by another
    # replica. They prefill as context, count against max_new_tokens and
    # are never re-emitted.
    emit_from: int = 0
    # Set by eject(): the resumeFrom payload another replica continues.
    resume_state: Optional[dict] = None

    @property
    def done(self) -> bool:
        return self.done_at is not None


@dataclass
class _PrefillState:
    """A slot mid-prefill, reserved until the final chunk commits it.
    offset = prompt tokens already in the temp cache."""
    req: ServeRequest
    slot: int
    offset: int
    temp: Optional[decode.KVCache]
    # The prefill context: prompt + a resumed request's committed tokens.
    ctx: List[int] = field(default_factory=list)
    # Paged engines: prompt tokens served from radix-matched pool pages (a
    # multiple of kv_block_len; 0 = cold). The final commit writes only
    # [matched, len(prompt)) — shared pages are read-only.
    matched: int = 0
    # False once a weight swap lands mid-prefill: its temp rows straddle
    # two checkpoints, so its blocks stay private (never published).
    publish: bool = True


@dataclass
class _Prefix:
    """A registered prompt prefix. Dense: its first grid_len = (len //
    prefill_len) * prefill_len tokens as a frozen batch-1 temp cache (None
    when grid_len is 0), the tail re-prefilled with each suffix. Paged:
    `chain`, the pinned radix nodes of its full blocks (grid_len = their
    tokens)."""
    tokens: List[int]
    grid_len: int
    temp: Optional[decode.KVCache]
    chain: Optional[list] = None


@dataclass
class _KVLease:
    """A paged request's block ownership: `nodes` are radix-tree blocks it
    holds a reference on (shared, read-only), `private` are pool blocks it
    owns outright (prompt tail + decode span), `row` is the host copy of
    its block-table row."""
    nodes: list
    private: List[int]
    row: np.ndarray                 # (max_blocks,) int32


class ContinuousBatchEngine:
    """Slot-based continuous batching over one KTWE-LM instance.

    submit() enqueues (QueueFull beyond max_queue); step() admits pending
    requests into free slots (at most `prefill_interleave` prefill chunks
    per step while anything decodes), advances every live slot by
    `decode_chunk` tokens and commits them; cancel() evicts; run() drains.
    `device` defaults to "cuda" and raises without a card; params must
    already live on it. `kv_block_len > 0` builds the paged engine over a
    pool of `kv_num_blocks` pages (0 = the dense cache's rows plus the
    trash page)."""

    def __init__(self, params: Params, cfg: tf.TransformerConfig, *,
                 num_slots: int = 4, max_seq: Optional[int] = None,
                 prefill_len: int = 64, decode_chunk: int = 8,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 enable_top_p: Optional[bool] = None, seed: int = 0,
                 max_queue: int = 256, prefill_interleave: int = 2,
                 keep_results: int = 1024, kv_block_len: int = 0,
                 kv_num_blocks: int = 0, max_prefixes: int = 8,
                 device="cuda"):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.params = params
        self.cfg = cfg
        self.num_slots = int(num_slots)
        self.max_seq = int(max_seq or cfg.max_seq)
        if self.max_seq % prefill_len:
            # The final (padded) chunk writes a whole prefill_len window at
            # a prefill_len multiple; it must not clamp back over real rows.
            raise ValueError(f"max_seq {self.max_seq} must be a multiple of "
                             f"prefill_len {prefill_len}")
        self.prefill_len = int(prefill_len)
        self.decode_chunk = int(decode_chunk)
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.enable_top_p = (bool(enable_top_p) if enable_top_p is not None
                             else self.top_p < 1.0)
        if self.top_p < 1.0 and not self.enable_top_p:
            raise ValueError("top_p < 1 requires enable_top_p")
        self.max_queue = int(max_queue)
        self.prefill_interleave = max(1, int(prefill_interleave))
        self.keep_results = int(keep_results)
        self.max_prefixes = int(max_prefixes)
        self._prefixes: Dict[int, _Prefix] = {}
        self._next_prefix_id = 0
        self._seed = int(seed)
        self.kv_block_len = int(kv_block_len or 0)
        self._paged = self.kv_block_len > 0
        if self._paged:
            if self.max_seq % self.kv_block_len:
                raise ValueError(f"max_seq {self.max_seq} must be a multiple "
                                 f"of kv_block_len {self.kv_block_len}")
            self._max_blocks = self.max_seq // self.kv_block_len
            # Auto: the dense cache's HBM (slots x max_seq rows) plus the
            # trash page; density then comes from short sequences and
            # shared prefixes.
            nb = (int(kv_num_blocks or 0)
                  or self.num_slots * self._max_blocks + 1)
            self.kv_num_blocks = nb
            self._pool = paged_kv.BlockPool(nb, self.kv_block_len)
            self._radix = paged_kv.RadixCache(self._pool)
            self._leases: Dict[int, _KVLease] = {}
            # Device block tables, one row per slot; a row is non-trash only
            # while its slot holds a live request.
            self._table_d = torch.zeros((self.num_slots, self._max_blocks),
                                        dtype=torch.int32, device=self.device)
            self._cache = decode.init_paged_pool(cfg, nb, self.kv_block_len,
                                                 self.device)
        else:
            self.kv_num_blocks = 0
            self._cache = decode.init_cache(cfg, self.num_slots,
                                            self.max_seq, self.device)
        self._freqs = rope_frequencies(cfg.head_dim, self.max_seq,
                                       cfg.rope_theta, self.device)
        # Host slot table: the truth for every slot's next input token,
        # position, sampling params and sample counter; uploaded per chunk.
        n = self.num_slots
        self._cur = np.zeros(n, np.int64)
        self._pos = np.zeros(n, np.int64)
        self._temps = np.full(n, self.temperature, np.float32)
        self._topps = np.full(n, self.top_p, np.float32)
        self._skeys = np.zeros((n, 2), np.uint32)
        self._scnt = np.zeros(n, np.int64)
        self._slot_req: List[Optional[ServeRequest]] = [None] * n
        self._prefill: Optional[_PrefillState] = None
        self._queue: deque = deque()
        self._reqs: Dict[int, ServeRequest] = {}
        self._done_order: deque = deque()
        self._next_id = 0
        self._draining = False
        # Lifetime totals (monotonic; metrics() rows cover retained
        # requests only).
        self._completed_total = 0
        self._cancelled_total = 0
        self._tokens_out_total = 0
        self._decode_steps_total = 0
        self._prefill_chunks_total = 0
        self._errors_total = {"prefill": 0, "decode": 0}
        self._started_at: Optional[float] = None
        # Prompt-token accounting behind kv_cache.prefix_hit_rate, and the
        # paged pool's admission deferrals (counted once per request).
        self._prefix_hits = 0
        self._kv_prompt_tokens_total = 0
        self._kv_matched_tokens_total = 0
        self._kv_deferrals_total = 0
        self._kv_deferred_req: Optional[int] = None
        self._swaps_total = 0
        self._swap_pause_ms_total = 0.0
        self._swap_pause_ms_last = 0.0
        # Migration: requests admitted with committed tokens, those
        # tokens, live requests ejected as resume states.
        self._resumed_total = 0
        self._resume_committed_total = 0
        self._ejected_total = 0

    # -- client API --

    def register_prefix(self, tokens: List[int]) -> int:
        """Prefill a shared prompt prefix once; `submit(prefix_id=)`
        requests then skip it. Dense: the first (len // prefill_len) *
        prefill_len tokens are kept as a batch-1 temp cache (one temp
        cache of device memory a prefix, at most max_prefixes), the tail
        re-prefills with each suffix; a prefix shorter than one chunk
        keeps no cache. Paged: the prefix's full blocks are committed to
        pool pages (matching whatever chain the tree already holds) and
        pinned. QueueFull(retryable=False) when max_prefixes are
        registered; QueueFull when the pool cannot hold the blocks."""
        tokens = [int(t) for t in tokens]
        if not 0 < len(tokens) <= self.max_seq - 2:
            raise ValueError(
                f"prefix length {len(tokens)} not in [1, {self.max_seq - 2}]"
                f" (need room for >= 1 suffix token and >= 1 generated "
                f"token)")
        if len(self._prefixes) >= self.max_prefixes:
            raise QueueFull(f"prefix cache full ({self.max_prefixes} "
                            f"registered; release one first)",
                            retryable=False)
        if self._paged:
            chain = self._register_prefix_blocks(tokens)
            pfx = _Prefix(tokens=tokens, grid_len=len(chain)
                          * self.kv_block_len, temp=None, chain=chain)
        else:
            grid_len = (len(tokens) // self.prefill_len) * self.prefill_len
            pfx = _Prefix(tokens=tokens, grid_len=grid_len,
                          temp=(self._prefill_grid(tokens, grid_len)
                                if grid_len > 0 else None))
        pid = self._next_prefix_id
        self._next_prefix_id += 1
        self._prefixes[pid] = pfx
        return pid

    def release_prefix(self, prefix_id: int) -> None:
        """Drop a registered prefix (KeyError if unknown). Requests that
        already borrowed it keep their copy; paged: its chain is unpinned
        and stays cached until pool pressure evicts it."""
        pfx = self._prefixes.pop(prefix_id)
        if self._paged and pfx.chain:
            self._radix.unpin(pfx.chain)

    def has_prefix(self, prefix_id: int) -> bool:
        return prefix_id in self._prefixes

    def prefix_cached_len(self, prefix_id: int) -> int:
        """Prefix tokens served from the cache a hit (the rest of the
        prefix re-prefills with each request)."""
        return self._prefixes[prefix_id].grid_len

    def _prefill_range(self, temp: decode.KVCache, tokens: List[int],
                       off: int, stop: int,
                       params: Optional[Params] = None) -> decode.KVCache:
        """Prefill tokens[off:stop] into `temp` in prefill_len chunks from
        `off` (a prefill_len multiple), the last one padded, under `params`
        (default: the engine's; a swap re-prefills under the new ones)."""
        p = self.params if params is None else params
        plen = self.prefill_len
        for start in range(off, stop, plen):
            chunk = np.zeros((1, plen), np.int64)
            n = min(plen, stop - start)
            chunk[0, :n] = tokens[start:start + n]
            temp = _prefill_step(p, temp,
                                 torch.as_tensor(chunk, device=self.device),
                                 self.cfg, start, self._freqs)
        return temp

    def _prefill_grid(self, tokens: List[int], grid_len: int,
                      params: Optional[Params] = None) -> decode.KVCache:
        """A dense prefix's first `grid_len` tokens (a prefill_len
        multiple) in a fresh batch-1 temp cache."""
        return self._prefill_range(
            _init_temp_cache(self.cfg, self.max_seq, self.device), tokens,
            0, grid_len, params)

    def _register_prefix_blocks(self, tokens: List[int]) -> list:
        """Paged registration: match the chain the tree already holds,
        prefill and commit only the tail blocks, insert and pin the whole
        chain. A sub-block prefix pins nothing (admissions prefill and
        publish it like any prompt)."""
        bl = self.kv_block_len
        span = (len(tokens) // bl) * bl
        if span == 0:
            return []
        chain = self._radix.match(tokens)
        matched = len(chain) * bl
        self._radix.acquire(chain)          # eviction guard while we work
        try:
            need = span // bl - len(chain)
            fresh = self._kv_alloc(need)
            if fresh is None:
                raise QueueFull(f"kv pool exhausted: prefix needs {need} "
                                f"more blocks, {self._pool.free_count} free "
                                f"after eviction")
            if need:
                try:
                    self._prefill_span_to_blocks(
                        tokens, span, self._table_row(chain, fresh), matched)
                except Exception:
                    self._pool.free(fresh)
                    raise
        finally:
            self._radix.release(chain)
        nodes = list(chain)
        parent = chain[-1] if chain else None
        for i, blk in enumerate(fresh):
            j = len(chain) + i
            node = self._radix.insert(parent, tokens[j * bl:(j + 1) * bl],
                                      blk)
            if node.block != blk:           # an identical chain: theirs
                self._pool.free([blk])
            nodes.append(node)
            parent = node
        self._radix.pin(nodes)
        return nodes

    def _stage_prefix_blocks(self, tokens: List[int],
                             params: Params) -> List[int]:
        """A paged swap's pre-commit half: the prefix's full blocks
        prefilled under the NEW weights into fresh pool pages that no
        table reaches until swap_params commits."""
        bl = self.kv_block_len
        span = (len(tokens) // bl) * bl
        blocks = self._kv_alloc(span // bl)
        if blocks is None:
            raise ValueError(f"kv pool exhausted mid hot-swap: prefix needs "
                             f"{span // bl} blocks, {self._pool.free_count} "
                             f"free")
        try:
            self._prefill_span_to_blocks(tokens, span,
                                         self._table_row([], blocks), 0,
                                         params)
        except Exception:
            self._pool.free(blocks)
            raise
        return blocks

    def _prefill_span_to_blocks(self, tokens: List[int], span: int,
                                row: np.ndarray, matched: int,
                                params: Optional[Params] = None) -> None:
        """Prefill positions [matched, span) of `tokens` and commit them
        to the pool pages of table row `row`: the grid walk behind paged
        registration and the swap's staging. The padded last chunk's
        garbage rows fall outside the commit window."""
        bl = self.kv_block_len
        temp = (_temp_from_pool(self._cache, row, matched, self.max_seq, bl)
                if matched > 0
                else _init_temp_cache(self.cfg, self.max_seq, self.device))
        off = (min(matched, span - 1) // self.prefill_len) * self.prefill_len
        temp = self._prefill_range(temp, tokens, off, span, params)
        _commit_rows(self._cache, temp, row, matched, span, bl)

    def submit(self, prompt: List[int], max_new_tokens: int,
               prefix_id: Optional[int] = None,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None,
               stop: Optional[List[List[int]]] = None,
               committed: Optional[List[int]] = None,
               prng_key: Optional[Sequence[int]] = None) -> int:
        """Enqueue a generation; returns its request id. `prng_key` (two
        uint32 words) is the request's sampling base key, so the same key
        at the same temperature gives the same tokens on any engine; the
        default is (seed, request id). `prefix_id` prepends a registered
        prefix to `prompt`. `committed` + `prng_key` resume another
        replica's generation (eject's state): the committed tokens are
        context and output at once, count against max_new_tokens (the
        request's TOTAL budget) and anchor the stop-tail state."""
        if self._draining:
            raise Draining("engine is draining (shutdown in progress); retry "
                           "against another replica")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        committed = [int(t) for t in (committed or [])]
        if committed and not len(committed) < max_new_tokens:
            raise ValueError(
                f"resume carries {len(committed)} committed tokens but "
                f"maxNewTokens is {max_new_tokens}: nothing left to "
                f"generate")
        if prng_key is not None:
            if len(prng_key) != 2:
                raise ValueError("prngKey must be two uint32 words")
            prng_key = np.asarray([int(k) & 0xFFFFFFFF for k in prng_key],
                                  np.uint32)
        if top_p is not None:
            if not 0.0 < top_p <= 1.0:
                raise ValueError(f"top_p {top_p} must be in (0, 1]")
            if top_p < 1.0 and not self.enable_top_p:
                raise ValueError("per-request top_p needs an engine built "
                                 "with enable_top_p=True")
        prompt = [int(t) for t in prompt]
        if prefix_id is not None:
            if prefix_id not in self._prefixes:
                raise ValueError(f"unknown prefix id {prefix_id}")
            if not prompt:
                raise ValueError("prompt must carry >= 1 token after the "
                                 "prefix (sampling reads the final prompt "
                                 "row)")
            prompt = self._prefixes[prefix_id].tokens + prompt
        limit = self.max_seq - max_new_tokens
        if not 0 < len(prompt) <= limit:
            raise ValueError(f"prompt length {len(prompt)} (incl. prefix) not"
                             f" in [1, {limit}] (max_seq {self.max_seq} - "
                             f"max_new_tokens {max_new_tokens})")
        if self._paged:
            need = paged_kv.blocks_needed(len(prompt) + max_new_tokens,
                                          self.kv_block_len)
            if need > self._pool.capacity:
                raise ValueError(
                    f"request needs {need} KV blocks; the pool has "
                    f"{self._pool.capacity} total (raise kv_num_blocks or "
                    f"lower maxNewTokens)")
        if len(self._queue) >= self.max_queue:
            raise QueueFull(
                f"serving queue full ({self.max_queue} requests waiting)")
        req = ServeRequest(req_id=self._next_id, prompt=prompt,
                           max_new_tokens=int(max_new_tokens),
                           submitted_at=time.perf_counter(),
                           temperature=temperature, top_p=top_p,
                           stop=[list(s) for s in (stop or []) if s],
                           prefix_id=prefix_id)
        self._next_id += 1
        req.base_key = (prng_key if prng_key is not None else np.asarray(
            [self._seed & 0xFFFFFFFF, req.req_id & 0xFFFFFFFF], np.uint32))
        if committed:
            # The logprob and latency rows are placeholders: the replica
            # that generated these tokens delivered the real ones.
            req.tokens = list(committed)
            req.logprobs = [0.0] * len(committed)
            req.token_lat_s = [0.0] * len(committed)
            req.emit_from = len(committed)
            self._resumed_total += 1
            self._resume_committed_total += len(committed)
        self._reqs[req.req_id] = req
        self._queue.append(req)
        return req.req_id

    def result(self, req_id: int) -> ServeRequest:
        return self._reqs[req_id]

    def cancel(self, req_id: int) -> bool:
        """Evict a request wherever it is (queued, mid-prefill, decoding);
        its slot is reusable at once. False if it already finished."""
        req = self._reqs[req_id]
        if req.done:
            return False
        req.cancelled = True
        self._evict(req)
        return True

    def _evict(self, req: ServeRequest) -> None:
        """Finish `req` and take it out wherever it is: the queue, the
        prefill in flight, its slot (parked)."""
        self._finish(req)
        if self._prefill is not None and self._prefill.req is req:
            self._prefill = None
        for b in range(self.num_slots):
            if self._slot_req[b] is req:
                self._slot_req[b] = None
                self._park_slot(b)
        try:
            self._queue.remove(req)
        except ValueError:
            pass

    def eject(self, req_id: int, reason: str = "eject") -> Optional[dict]:
        """Evict a live request as a resume state, the migration half of
        a zero-loss drain: it finishes as "migrated", its slot and pages
        free as cancel frees them, and the state carries what another
        replica needs to continue it exactly (prompt, every committed
        token, the total budget, sampling params, stop sequences, the
        sampling key and position). A second eject of the same request
        returns the cached state; a request that finished for real
        returns None."""
        req = self._reqs[req_id]
        if req.done:
            return req.resume_state
        state = {
            "requestId": req.req_id,
            "prompt": list(req.prompt),
            "committed": list(req.tokens),
            "maxNewTokens": req.max_new_tokens,
            "remaining": req.max_new_tokens - len(req.tokens),
            "temperature": req.temperature,
            "topP": req.top_p,
            "stop": [list(s) for s in req.stop],
            "prngKey": [int(x) for x in np.asarray(req.base_key)],
            "prngPos": len(req.tokens),
            "reason": reason,
            # The tenancy keys at their defaults: tenancy is not ported.
            "tenant": "",
            "priority": "interactive",
            "preempted": 0,
        }
        req.resume_state = state
        req.finish_reason = "migrated"
        self._ejected_total += 1
        self._evict(req)
        return state

    def eject_live(self) -> List[dict]:
        """Eject every live request (queued, prefilling, decoding): the
        force-eject of a drain deadline."""
        live = [r.req_id for r in self._reqs.values() if not r.done]
        return [s for s in (self.eject(rid) for rid in live)
                if s is not None]

    def release(self, req_id: int) -> None:
        """Drop a finished request's record."""
        req = self._reqs.get(req_id)
        if req is None:
            return
        if not req.done:
            raise ValueError(f"request {req_id} still active")
        del self._reqs[req_id]

    def drain(self) -> None:
        """Stop admitting (submit raises Draining); accepted work goes on."""
        self._draining = True

    @property
    def draining(self) -> bool:
        return self._draining

    def swap_params(self, new_params: Params) -> float:
        """Live weight hot-swap: validate `new_params` against the engine's
        tree (structure, shapes, dtypes), place every leaf on the engine's
        device, re-prefill every registered prefix under the new weights,
        wait for the device, and swap. Returns the pause in ms.

        Callers pause the engine between steps (cmd/serve.py holds the
        service lock, so no step() runs concurrently); queued and decoding
        requests survive, every chunk after the swap uses the new weights.
        A mismatched tree raises ValueError before anything is touched, and
        a fault while re-prefilling leaves the engine on the old weights
        and the old prefixes, with no page leaked. Paged: each prefix's
        blocks are staged into fresh pages first; at the commit the radix
        tree is detached (its pages hold old-weight KV: unreferenced pages
        free now, pages live requests still map free with their leases),
        the staged chains are inserted and pinned, and a prefill in flight
        across the swap finishes but never publishes its blocks."""
        t0 = time.perf_counter()
        _check_same_tree(self.params, new_params)
        placed = _map_leaves(lambda t: t.to(self.device), new_params)
        new_temps: Dict[int, decode.KVCache] = {}
        staged: Dict[int, List[int]] = {}
        if self._paged:
            try:
                for pid, pfx in self._prefixes.items():
                    if len(pfx.tokens) >= self.kv_block_len:
                        staged[pid] = self._stage_prefix_blocks(pfx.tokens,
                                                                placed)
            except Exception:
                for blocks in staged.values():
                    self._pool.free(blocks)
                raise
        else:
            for pid, pfx in self._prefixes.items():
                if pfx.grid_len > 0:
                    new_temps[pid] = self._prefill_grid(
                        pfx.tokens, pfx.grid_len, placed)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # Commit: host-side assignments only, nothing below can raise.
        self.params = placed
        for pid, temp in new_temps.items():
            self._prefixes[pid].temp = temp
        if self._paged:
            for pfx in self._prefixes.values():
                if pfx.chain:
                    self._radix.unpin(pfx.chain)
                    pfx.chain = None
            self._radix.detach_all()
            if self._prefill is not None:
                self._prefill.publish = False
            bl = self.kv_block_len
            for pid, blocks in staged.items():
                pfx = self._prefixes[pid]
                nodes, parent = [], None
                for i, blk in enumerate(blocks):
                    node = self._radix.insert(
                        parent, pfx.tokens[i * bl:(i + 1) * bl], blk)
                    if node.block != blk:
                        # Two prefixes share this block: the first staged
                        # insert won, the duplicate page goes back.
                        self._pool.free([blk])
                    nodes.append(node)
                    parent = node
                self._radix.pin(nodes)
                pfx.chain = nodes
                pfx.grid_len = len(nodes) * bl
        pause_ms = (time.perf_counter() - t0) * 1e3
        self._swaps_total += 1
        self._swap_pause_ms_total += pause_ms
        self._swap_pause_ms_last = pause_ms
        return pause_ms

    @property
    def pending(self) -> int:
        return len(self._queue) + self.slots_busy

    @property
    def slots_busy(self) -> int:
        """Slots holding a decoding request, plus one reserved by a
        prefill in flight."""
        return (sum(1 for r in self._slot_req if r is not None)
                + (1 if self._prefill is not None else 0))

    @property
    def active(self) -> bool:
        return self.pending > 0

    def step(self) -> int:
        """Admit (bounded prefill work), dispatch one decode chunk over the
        live slots and commit its tokens. Returns tokens committed. A fault
        fails only the requests of the phase it hit (finish_reason
        "error") and the engine keeps serving."""
        # A slot live before admission waited through this step's prefill
        # work too: its tokens' latency is measured from here.
        t0 = (time.perf_counter()
              if any(r is not None for r in self._slot_req) else None)
        try:
            self._admit()
        except Exception as e:                 # noqa: BLE001 — contained
            self._contain_failure("prefill", e)
        if not any(r is not None for r in self._slot_req):
            return 0
        try:
            return self._collect(self._dispatch_chunk(t0))
        except Exception as e:                 # noqa: BLE001 — contained
            self._contain_failure("decode", e)
            return 0

    def run(self, max_chunks: int = 1_000_000) -> None:
        for _ in range(max_chunks):
            if not self.active:
                return
            self.step()

    # -- internals --

    def _contain_failure(self, phase: str, exc: Exception) -> None:
        """Fail the requests `phase` touched: the one being prefilled, or
        every decoding slot."""
        self._errors_total[phase] += 1
        msg = f"{phase} failed: {type(exc).__name__}: {exc}"
        if phase == "prefill":
            touched = [self._prefill.req] if self._prefill is not None else []
            self._prefill = None
        else:
            # Paged: the pool needs no rebuild. The port writes in place,
            # and a faulted chunk can have written only its slots' private
            # decode rows (and the trash page), never a shared tree page:
            # a slot's pos is past every block its prompt published.
            touched = [r for r in self._slot_req if r is not None]
            for b, r in enumerate(self._slot_req):
                if r is not None:
                    self._park_slot(b)
            self._slot_req = [None] * self.num_slots
        for req in touched:
            if not req.done:
                self._fail_request(req, msg)

    def _fail_request(self, req: ServeRequest, msg: str) -> None:
        """Finish `req` as errored with `msg` (its lease goes back)."""
        req.finish_reason = "error"
        req.error = msg
        self._finish(req)

    @staticmethod
    def _matched_stop(req: ServeRequest) -> Optional[List[int]]:
        """The stop sequence the output's tail matches (first declared
        wins), or None."""
        toks = req.tokens
        for s in req.stop:
            if len(toks) >= len(s) and toks[len(toks) - len(s):] == s:
                return s
        return None

    def _terminal(self, req: ServeRequest) -> bool:
        return (len(req.tokens) >= req.max_new_tokens
                or (self.eos_id is not None and bool(req.tokens)
                    and req.tokens[-1] == self.eos_id)
                or self._matched_stop(req) is not None)

    def _finish(self, req: ServeRequest) -> None:
        req.done_at = time.perf_counter()
        # Paged: the request's pages go back the moment it finishes (radix
        # references drop, private pages return to the free list). Queued
        # requests have no lease.
        self._release_lease(req)
        if req.finish_reason is None:
            if req.cancelled:
                req.finish_reason = "cancelled"
            elif (self.eos_id is not None and req.tokens
                  and req.tokens[-1] == self.eos_id):
                req.finish_reason = "eos"
            else:
                s = self._matched_stop(req)
                if s is not None:
                    req.finish_reason = "stop"
                    keep = len(req.tokens) - len(s)
                    del req.tokens[keep:]
                    del req.logprobs[keep:]
                    del req.token_lat_s[keep:]
                else:
                    req.finish_reason = "length"
        if req.cancelled:
            self._cancelled_total += 1
        elif req.finish_reason not in ("error", "migrated"):
            # A migrated request counts under ejected_total; the replica
            # that resumes it counts the completion.
            self._completed_total += 1
        # Cancelled requests' partial tokens ran real decode work: count
        # them; a resumed request's committed tokens ran elsewhere.
        self._tokens_out_total += max(0, len(req.tokens) - req.emit_from)
        self._done_order.append(req.req_id)
        while len(self._done_order) > self.keep_results:
            old = self._done_order.popleft()
            r = self._reqs.get(old)
            if r is not None and r.done:
                del self._reqs[old]

    def _sampling(self) -> _Sampling:
        return _Sampling(self._skeys, self._scnt, self._temps, self._topps,
                         self.top_k, self.enable_top_p)

    def _dispatch_chunk(self, t_start: Optional[float] = None):
        """Run one decode chunk over every slot (parked ones included) and
        advance the host pos / sample-counter mirrors as the device did.
        `t_start` stamps where the chunk's wall begins (default: now)."""
        t_start = time.perf_counter() if t_start is None else t_start
        n = self.decode_chunk
        toks = torch.as_tensor(self._cur, device=self.device)
        pos = torch.as_tensor(self._pos, device=self.device)
        if self._paged:
            packed = _decode_chunk_paged(self.params, self._cache,
                                         self._table_d, toks, pos, self.cfg,
                                         n, self._freqs, self._sampling(),
                                         self.kv_block_len)
        else:
            packed = _decode_chunk(self.params, self._cache, toks, pos,
                                   self.cfg, n, self._freqs,
                                   self._sampling())
        snapshot = [(b, r) for b, r in enumerate(self._slot_req)
                    if r is not None]
        self._pos = np.minimum(self._pos + n, self.max_seq - 1)
        self._scnt = self._scnt + n
        self._decode_steps_total += n
        return packed, snapshot, t_start, n

    def _collect(self, dispatched) -> int:
        """Fetch a chunk's packed tokens (THE device sync) and commit them
        slot by slot; each token's latency is the chunk wall over its
        length."""
        packed, snapshot, t_start, n = dispatched
        toks_h, lps_h = _unpack(packed.cpu().numpy())
        self._cur = toks_h[-1].astype(np.int64)
        per_tok = (time.perf_counter() - t_start) / n
        emitted = 0
        for b, req in snapshot:
            if req.done:
                continue                    # cancelled after dispatch
            emitted += self._commit_tokens(req, b, toks_h[:, b], lps_h[:, b],
                                           per_tok)
        return emitted

    def _commit_tokens(self, req: ServeRequest, b: int, toks, lps,
                       per_tok: float) -> int:
        """Append a chunk's tokens one at a time with the budget / EOS /
        stop checks between appends; finish and evict on a terminal one."""
        emitted = 0
        for t, lp in zip(toks, lps):
            if len(req.tokens) >= req.max_new_tokens:
                break
            t = int(t)
            req.tokens.append(t)
            req.logprobs.append(float(lp))
            req.token_lat_s.append(per_tok)
            emitted += 1
            if (self.eos_id is not None and t == self.eos_id) or (
                    req.stop and self._matched_stop(req) is not None):
                break
        if self._terminal(req):
            self._finish(req)
            if self._slot_req[b] is req:
                self._slot_req[b] = None
                self._park_slot(b)
        return emitted

    def _admit(self) -> None:
        """Advance admissions by whole prefill chunks; while any slot
        decodes, at most `prefill_interleave` chunks per step."""
        done_chunks = 0
        while True:
            if (done_chunks >= self.prefill_interleave
                    and any(r is not None for r in self._slot_req)):
                return
            if self._prefill is None and not self._start_prefill():
                return
            self._advance_prefill()
            done_chunks += 1

    def _free_slot(self) -> Optional[int]:
        reserved = self._prefill.slot if self._prefill is not None else -1
        for b in range(self.num_slots):
            if self._slot_req[b] is None and b != reserved:
                return b
        return None

    def _start_prefill(self) -> bool:
        while self._queue and self._queue[0].cancelled:
            self._queue.popleft()
        if not self._queue:
            return False
        b = self._free_slot()
        if b is None:
            return False
        if self._started_at is None:
            self._started_at = time.perf_counter()
        if self._paged:
            return self._start_prefill_paged(b)
        req = self._queue.popleft()
        req.admitted_at = time.perf_counter()
        ctx = req.prompt + req.tokens[:req.emit_from]
        self._kv_prompt_tokens_total += len(ctx)
        self._prefill = _PrefillState(req=req, slot=b, offset=0, temp=None,
                                      ctx=ctx)
        pfx = (self._prefixes.get(req.prefix_id)
               if req.prefix_id is not None else None)
        if pfx is not None and pfx.grid_len > 0:
            # Borrow a COPY of the prefix's cache: the suffix prefill
            # writes the temp cache in place. (A prefix released since
            # submit falls through to a full prefill of the stored tokens.)
            self._prefix_hits += 1
            self._kv_matched_tokens_total += pfx.grid_len
            self._prefill.offset = pfx.grid_len
            self._prefill.temp = decode.KVCache(k=pfx.temp.k.clone(),
                                                v=pfx.temp.v.clone())
            return True
        self._prefill.temp = _init_temp_cache(self.cfg, self.max_seq,
                                              self.device)
        return True

    # -- paged block plumbing --

    def _table_row(self, chain, blocks) -> np.ndarray:
        """Host block-table row: matched chain pages first, then the
        private/fresh pages, remaining entries the trash page — the layout
        paged_rows assumes."""
        row = np.zeros(self._max_blocks, np.int32)
        for i, node in enumerate(chain):
            row[i] = node.block
        for i, blk in enumerate(blocks):
            row[len(chain) + i] = blk
        return row

    def _kv_alloc(self, n: int) -> Optional[List[int]]:
        """All-or-nothing pool allocation, evicting cold radix blocks
        LRU-first under pressure. None = defer (the pool cannot cover `n`
        even after eviction). Eviction is all-or-nothing too: when `n`
        cannot be met even by evicting everything cold, nothing is evicted,
        so an oversized reservation never wipes the warm prefix cache for
        nothing."""
        if n > self._pool.free_count:
            deficit = n - self._pool.free_count
            if deficit > self._radix.evictable_blocks():
                return None
            self._radix.evict(deficit)
        return self._pool.alloc(n)

    def _release_lease(self, req: ServeRequest) -> None:
        """Give a finished, cancelled or failed request's pages back: radix
        references drop, private pages return to the free list. Reusing
        them at once is safe: the slot's table row is parked before the
        next chunk, and no chunk is in flight (see the module note)."""
        if not self._paged:
            return
        lease = self._leases.pop(req.req_id, None)
        if lease is None:
            return
        self._radix.release(lease.nodes)
        if lease.private:
            self._pool.free(lease.private)

    def _park_slot(self, b: int) -> None:
        """Point a freed slot's table row at the trash page, so the next
        chunks' (ignored) writes for it land there."""
        if self._paged:
            self._table_d[b].zero_()

    def _start_prefill_paged(self, b: int) -> bool:
        """Paged admission: radix-match the prompt's full blocks, reserve
        the rest of the prompt + max_new span from the pool, and start the
        suffix prefill at the match's prefill-grid frontier. When the pool
        cannot cover the reservation even after eviction the request stays
        at the queue head (deferred, strict FIFO); one that can never fit
        fails instead of blocking the queue forever."""
        req = self._queue[0]
        bl = self.kv_block_len
        # The context: prompt + a resumed request's committed tokens (the
        # radix match makes a migrated-in request warm).
        ctx = req.prompt + req.tokens[:req.emit_from]
        plen = len(ctx)
        chain = self._radix.match(ctx)
        while chain and len(chain) * bl >= plen:
            # Keep >= 1 prompt token out of the match: the first token is
            # sampled from the last prompt row's logits.
            chain = chain[:-1]
        matched = len(chain) * bl
        # The whole span is prompt + max_new: the committed tokens ride
        # inside the budget.
        need = paged_kv.blocks_needed(len(req.prompt) + req.max_new_tokens,
                                      bl) - len(chain)
        self._radix.acquire(chain)       # eviction guard + our reference
        private = self._kv_alloc(need)
        if private is None:
            self._radix.release(chain)
            # The whole footprint must fit in capacity minus pinned blocks
            # (eviction never touches those), except pinned blocks the
            # request itself rides. Matched unpinned blocks get no credit:
            # every retry re-acquires them, so they hold headroom exactly
            # like fresh pages.
            rideable = sum(1 for n in chain if n.pins > 0)
            footprint = len(chain) + need - rideable
            headroom = self._pool.capacity - self._radix.pinned_blocks()
            if footprint > headroom:
                self._queue.popleft()
                self._fail_request(
                    req, f"request needs {footprint} KV blocks but only "
                         f"{headroom} are reclaimable (pinned prefixes hold "
                         f"the rest); raise kv_num_blocks")
                return False
            if self._kv_deferred_req != req.req_id:
                self._kv_deferrals_total += 1
                self._kv_deferred_req = req.req_id
            return False
        row = self._table_row(chain, private)
        self._queue.popleft()
        req.admitted_at = time.perf_counter()
        self._leases[req.req_id] = _KVLease(
            nodes=list(chain), private=list(private), row=row)
        if matched > 0:
            self._prefix_hits += 1
        self._kv_prompt_tokens_total += plen
        self._kv_matched_tokens_total += matched
        # The suffix prefill starts at the match's prefill-grid frontier;
        # positions [off0, matched) are recomputed into the temp cache but
        # never committed.
        off0 = (min(matched, plen - 1) // self.prefill_len) * self.prefill_len
        self._prefill = _PrefillState(req=req, slot=b, offset=off0, temp=None,
                                      ctx=ctx, matched=matched)
        self._prefill.temp = (
            _temp_from_pool(self._cache, row, matched, self.max_seq, bl)
            if matched > 0
            else _init_temp_cache(self.cfg, self.max_seq, self.device))
        return True

    def _insert_prompt_blocks(self, tokens: List[int],
                              lease: _KVLease) -> None:
        """After the final prefill commit, publish the request's full prompt
        blocks into the radix tree, so the next request sharing this prefix
        matches them. The request keeps a reference on each published node
        (released with its lease); its partial tail block and decode span
        stay private."""
        bl = self.kv_block_len
        full = len(tokens) // bl
        start = len(lease.nodes)
        if full <= start:
            return
        parent = lease.nodes[-1] if lease.nodes else None
        keep_private: List[int] = []
        new_nodes = []
        for idx, i in enumerate(range(start, full)):
            blk = lease.private[idx]
            node = self._radix.insert(parent, tokens[i * bl:(i + 1) * bl],
                                      blk)
            if node.block == blk:
                new_nodes.append(node)
            else:
                # An identical chain is already in the tree: its node serves
                # later matches, our identical page stays private.
                keep_private.append(blk)
            parent = node
        keep_private.extend(lease.private[full - start:])
        self._radix.acquire(new_nodes)
        lease.nodes.extend(new_nodes)
        lease.private = keep_private

    def _advance_prefill(self) -> None:
        st = self._prefill
        if st.req.done:                           # cancelled mid-prefill
            self._prefill = None
            return
        ctx = st.ctx
        remaining = len(ctx) - st.offset
        if remaining > self.prefill_len:          # non-final chunk
            chunk = torch.as_tensor(
                [ctx[st.offset:st.offset + self.prefill_len]],
                dtype=torch.int64, device=self.device)
            st.temp = _prefill_step(self.params, st.temp, chunk, self.cfg,
                                    st.offset, self._freqs)
            st.offset += self.prefill_len
            self._prefill_chunks_total += 1
            return
        # Final chunk: commit into the slot and sample token #1.
        padded = np.zeros((1, self.prefill_len), np.int64)
        padded[0, :remaining] = ctx[st.offset:]
        req, b = st.req, st.slot
        r_temp = (req.temperature if req.temperature is not None
                  else self.temperature)
        r_topp = req.top_p if req.top_p is not None else self.top_p
        # The first new token samples at index emit_from (0 for a fresh
        # request), where the uninterrupted stream sampled it.
        sampling = _Sampling(req.base_key[None],
                             np.asarray([req.emit_from], np.int64),
                             np.asarray([r_temp], np.float32),
                             np.asarray([r_topp], np.float32), self.top_k,
                             self.enable_top_p)
        chunk = torch.as_tensor(padded, device=self.device)
        if self._paged:
            lease = self._leases[req.req_id]
            tok, lp = _prefill_final_paged(
                self.params, self._cache, st.temp, chunk, lease.row,
                st.matched, len(ctx), remaining, self.cfg, st.offset,
                self._freqs, sampling, self.kv_block_len)
            # Publish the prompt's full blocks for automatic reuse, unless
            # a weight swap landed mid-prefill.
            if st.publish:
                self._insert_prompt_blocks(ctx, lease)
        else:
            tok, lp = _prefill_final(
                self.params, self._cache, st.temp, chunk, b, remaining,
                self.cfg, st.offset, self._freqs, sampling)
        self._prefill_chunks_total += 1
        self._prefill = None
        t = int(tok)                              # the first-token sync
        lpv = float(lp)
        now = time.perf_counter()
        req.tokens.append(t)
        req.logprobs.append(lpv)
        req.token_lat_s.append(now - req.submitted_at)            # TTFT
        req.first_token_at = now
        if self._terminal(req):
            self._finish(req)
            return
        self._cur[b] = t
        self._pos[b] = len(ctx)
        self._temps[b] = r_temp
        self._topps[b] = r_topp
        self._skeys[b] = req.base_key
        self._scnt[b] = req.emit_from + 1   # the prefill's index is used
        if self._paged:
            self._table_d[b] = torch.as_tensor(
                self._leases[req.req_id].row, device=self.device)
        self._slot_req[b] = req

    # -- metrics --

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Counters and flat per-request rows; the percentile sorts live in
        aggregate_metrics (callers run them outside any serving lock)."""
        rows = [{
            "req_id": r.req_id,
            "cancelled": r.cancelled,
            "errored": r.finish_reason == "error",
            "migrated": r.finish_reason == "migrated",
            # Tokens generated on this replica.
            "n_tokens": max(0, len(r.tokens) - r.emit_from),
            "submitted_at": r.submitted_at,
            "first_token_at": r.first_token_at,
            "done_at": r.done_at,
            "token_lat_s": list(r.token_lat_s[r.emit_from:]),
        } for r in self._reqs.values() if r.done]
        return {
            "rows": rows,
            "started_at": self._started_at,
            "queued": len(self._queue),
            "lifetime": {
                "completed": self._completed_total,
                "cancelled": self._cancelled_total,
                "tokens": self._tokens_out_total,
                "decode_steps": self._decode_steps_total,
                "prefill_chunks": self._prefill_chunks_total,
            },
            "errors": dict(self._errors_total),
            "draining": self._draining,
            # Fault, drain and hot-swap state (the JAX engine's block; its
            # watchdog and device-loss fields are not ported).
            "resilience": {
                "errors": dict(self._errors_total),
                "weight_swaps": self._swaps_total,
                "swap_pause_ms_total": self._swap_pause_ms_total,
                "swap_pause_ms_last": self._swap_pause_ms_last,
                "draining": self._draining,
            },
            # Zero-loss migration (monotonic counters).
            "migration": {
                "resumed_total": self._resumed_total,
                "resume_committed_tokens_total":
                    self._resume_committed_total,
                "ejected_total": self._ejected_total,
            },
            # Prompt prefix reuse: hits and tokens saved monotonic,
            # registered instantaneous.
            "prefix_cache": {
                "registered": len(self._prefixes),
                "hits": self._prefix_hits,
                # Every matched prompt token is one the prefill skipped.
                "prompt_tokens_saved": self._kv_matched_tokens_total,
            },
            # Paged pool and radix state; zeros on a dense engine except
            # the prompt-token total.
            "kv_cache": {
                "paged": self._paged,
                "block_len": self.kv_block_len,
                "blocks_total": self._pool.capacity if self._paged else 0,
                "blocks_free": self._pool.free_count if self._paged else 0,
                "blocks_used": self._pool.used_count if self._paged else 0,
                "blocks_shared": (self._radix.shared_blocks()
                                  if self._paged else 0),
                "blocks_cached": (self._radix.cached_blocks
                                  if self._paged else 0),
                "evictions_total": (self._radix.evictions_total
                                    if self._paged else 0),
                "deferrals_total": self._kv_deferrals_total,
                "prompt_tokens_total": self._kv_prompt_tokens_total,
                "matched_tokens_total": self._kv_matched_tokens_total,
                "prefix_hit_rate": (
                    self._kv_matched_tokens_total
                    / self._kv_prompt_tokens_total
                    if self._kv_prompt_tokens_total else 0.0),
            },
        }

    @staticmethod
    def aggregate_metrics(snap: Dict[str, Any]) -> Dict[str, Any]:
        """metrics_snapshot() -> the metrics dict. Cancelled and errored
        requests are counted but kept out of throughput and latency."""
        rows = snap["rows"]
        done = [r for r in rows if not r["cancelled"] and not r["errored"]
                and not r["migrated"]]
        total_toks = sum(r["n_tokens"] for r in done)
        wall = 0.0
        if done and snap["started_at"] is not None:
            window_start = max(snap["started_at"],
                               min(r["submitted_at"] for r in done))
            wall = max(r["done_at"] for r in done) - window_start
        decode_lats = sorted(lat for r in done
                             for lat in r["token_lat_s"][1:])  # excl. TTFT
        ttfts = sorted(r["first_token_at"] - r["submitted_at"] for r in done
                       if r["first_token_at"] is not None)
        return {
            "requests_completed": len(done),
            "requests_cancelled": sum(1 for r in rows if r["cancelled"]),
            "requests_errored": sum(1 for r in rows if r["errored"]),
            "lifetime": snap["lifetime"],
            "prefix_cache": snap["prefix_cache"],
            "kv_cache": snap["kv_cache"],
            "migration": snap["migration"],
            "errors": snap["errors"],
            "draining": snap["draining"],
            "resilience": snap["resilience"],
            "queued": snap["queued"],
            "tokens": total_toks,
            "wall_s": wall,
            "aggregate_tokens_per_s": total_toks / wall if wall else 0.0,
            "token_lat_p50_ms": percentile(decode_lats, 50) * 1e3,
            "token_lat_p99_ms": percentile(decode_lats, 99) * 1e3,
            "ttft_p50_ms": percentile(ttfts, 50) * 1e3,
            "ttft_p95_ms": percentile(ttfts, 95) * 1e3,
            "ttft_p99_ms": percentile(ttfts, 99) * 1e3,
            "per_request_tokens_per_s": {
                r["req_id"]: r["n_tokens"] / (r["done_at"]
                                              - r["first_token_at"])
                for r in done
                if r["done_at"] and r["first_token_at"]
                and r["done_at"] > r["first_token_at"]},
        }

    def metrics(self) -> Dict[str, Any]:
        return self.aggregate_metrics(self.metrics_snapshot())
