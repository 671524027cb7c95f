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

Not ported here (later slices): register_prefix/release_prefix, speculative
decoding, the host-RAM KV tier and preemption of the paged engine, the int8
KV cache, meshes, eject/resume/handoff, tenancy, the watchdog and FaultLab
sites, `swap_params` (and with it radix detachment), phase events, and the
overlapped dispatch/commit pipeline (this engine collects every chunk
before it dispatches the next).
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


class QueueFull(RuntimeError):
    """submit() beyond max_queue: callers map it to backpressure (HTTP
    429 + Retry-After)."""


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
    finish_reason: Optional[str] = None      # length|eos|stop|cancelled|error
    error: Optional[str] = None
    # Sampling base key (two uint32 words): token n draws from (key, n).
    base_key: Any = None

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
    # Paged engines: prompt tokens served from radix-matched pool pages (a
    # multiple of kv_block_len; 0 = cold). The final commit writes only
    # [matched, len(prompt)) — shared pages are read-only.
    matched: int = 0


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
                 kv_num_blocks: int = 0, device="cuda"):
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

    # -- client API --

    def submit(self, prompt: List[int], max_new_tokens: int,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None,
               stop: Optional[List[List[int]]] = None) -> int:
        """Enqueue a generation; returns its request id."""
        if self._draining:
            raise Draining("engine is draining (shutdown in progress); retry "
                           "against another replica")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if top_p is not None:
            if not 0.0 < top_p <= 1.0:
                raise ValueError(f"top_p {top_p} must be in (0, 1]")
            if top_p < 1.0 and not self.enable_top_p:
                raise ValueError("per-request top_p needs an engine built "
                                 "with enable_top_p=True")
        limit = self.max_seq - max_new_tokens
        if not 0 < len(prompt) <= limit:
            raise ValueError(f"prompt length {len(prompt)} not in [1, {limit}]"
                             f" (max_seq {self.max_seq} - max_new_tokens "
                             f"{max_new_tokens})")
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
        req = ServeRequest(req_id=self._next_id, prompt=[int(t) for t in prompt],
                           max_new_tokens=int(max_new_tokens),
                           submitted_at=time.perf_counter(),
                           temperature=temperature, top_p=top_p,
                           stop=[list(s) for s in (stop or []) if s])
        self._next_id += 1
        req.base_key = np.asarray([self._seed & 0xFFFFFFFF,
                                   req.req_id & 0xFFFFFFFF], np.uint32)
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
        return True

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
        elif req.finish_reason != "error":
            self._completed_total += 1
        # Cancelled requests' partial tokens ran real decode work: count them.
        self._tokens_out_total += len(req.tokens)
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
        self._kv_prompt_tokens_total += len(req.prompt)
        self._prefill = _PrefillState(req=req, slot=b, offset=0, temp=None)
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
        plen = len(req.prompt)
        chain = self._radix.match(req.prompt)
        while chain and len(chain) * bl >= plen:
            # Keep >= 1 prompt token out of the match: the first token is
            # sampled from the last prompt row's logits.
            chain = chain[:-1]
        matched = len(chain) * bl
        need = paged_kv.blocks_needed(plen + req.max_new_tokens, bl) \
            - len(chain)
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
                                      matched=matched)
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
        ctx = st.req.prompt
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
        sampling = _Sampling(req.base_key[None], np.zeros(1, np.int64),
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
            # Publish the prompt's full blocks for automatic reuse.
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
        self._scnt[b] = 1            # the prefill consumed sample index 0
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
            "n_tokens": len(r.tokens),
            "submitted_at": r.submitted_at,
            "first_token_at": r.first_token_at,
            "done_at": r.done_at,
            "token_lat_s": list(r.token_lat_s),
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
            # Prompt prefix reuse (monotonic counters).
            "prefix_cache": {
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
        done = [r for r in rows if not r["cancelled"] and not r["errored"]]
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
            "errors": snap["errors"],
            "draining": snap["draining"],
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
