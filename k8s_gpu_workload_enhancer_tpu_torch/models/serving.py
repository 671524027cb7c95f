"""Continuous-batching serving engine for KTWE-LM (one device or a mesh).

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
  is handed out again at once, even while a chunk that still maps it is in
  flight: all device work runs in order on one stream, so that chunk's
  (ignored) writes land before the new owner's prefill writes the page,
  and a slot only ever decodes into its private pages.
- **int8 KV** (`cfg.kv_cache_int8`). The cache or pool holds int8 K/V
  with per-row f32 scales (models/decode.py). Prefill quantizes on write
  and attends over the dequantized layer; decode attention reads the int8
  rows converted to the compute dtype and folds the scales into its
  logits and probabilities (the scale-after-dot form, in the JAX engine's
  order, so f32 greedy tokens match). The paged engine then gathers each
  slot's rows in logical order and runs the same einsum, never the paged
  decode kernel, as the JAX engine switches its paged kernel off under
  int8. Every move of KV rows (the slot commit, the radix gather and
  commit, registered prefixes) carries their scales.
- **Per-slot positions.** Each slot decodes at its own frontier `pos[b]`:
  RoPE rows are gathered at `pos`, the new K/V row is written at `pos`
  BEFORE the attention read, and attention masks `j <= pos[b]`, so a freed
  slot's stale rows are never attended and the next request may reuse it.
  Parked slots keep stepping with `pos` clamped at `max_seq - 1`.
- **Chunked decode.** `decode_chunk` steps per dispatch, reading and
  advancing device-resident slot mirrors (next token, position, sampling
  params); the chunk's tokens and their logprobs come back in ONE (C, B, 2)
  int32 array (tokens, and the f32 logprobs bitcast), copied to pinned
  host memory behind an event: the engine's one device sync per chunk. On
  the card the chunk is one captured CUDA graph, replayed
  (models/decode_graph.py), the counterpart of the JAX engine's jitted
  chunk program.
- **Overlapped dispatch/commit pipeline.** `step()` dispatches chunk N+1
  behind chunk N, fetches N, then commits N's tokens (budget, EOS and
  stop checks, slot frees) while N+1 runs on the device: the device never
  waits on the host's launch of the next chunk. Bookkeeping
  trails the device by one chunk: a slot freed by chunk N's commit still
  decodes (ignored) in N+1, and a request's last chunk is committed one
  step after its dispatch. The dispatch reads only the device mirrors, so
  tokens are identical with the pipeline on or off. A `watchdog_timeout`
  fails the in-flight batch when its chunk does not land in time.
- **Chunked prefill.** A prompt is prefilled in `prefill_len` chunks at
  offsets that are multiples of prefill_len, through a batch-1 temp cache,
  then committed into its slot; at most `prefill_interleave` chunks run per
  step while any slot is decoding. The final chunk samples the request's
  first token into the slot's device mirror, so the next chunk decodes
  from it without a sync; its host copy lands at the next commit (the
  TTFT stamp).
- **The decode quantum** (`prefill_chunk_tokens > 0`). The value replaces
  prefill_len as the prompt slice, and while a prefill is mid-flight or a
  request waits, a dispatch decodes only `max(1, decode_chunk // 4)` steps,
  so the next slice interleaves within a few tokens instead of a whole
  chunk: the TTFT tail of a storm shrinks on one replica. Slice and chunk
  lengths move the schedule, not a row's arithmetic, so the tokens are the
  plain engine's, except where a matmul kernel chosen for fewer rows sums
  in another order (bf16 on the card: PERF.md). On the card the quantum is
  a second captured graph, over the first rows of the same static noise
  and output buffers; each graph is captured on its first use.
- **The prefill role** (`handoff_first_token`). The engine prefills,
  lands each request's first token in the step that sampled it and ejects
  the request at once as a `reason="handoff"` resume state, which the
  fleet router continues on a decode replica. Such an engine never
  dispatches a decode chunk (and never captures a graph); a request of one
  new token finishes normally.
- **Speculative decoding** (`spec_k > 0`). Each step drafts up to spec_k
  tokens a greedy slot on the host (the n-gram self-drafter over the slot's
  own committed tokens, or any `drafter` callable), then ONE (spec_k + 1)
  -wide verify round over every slot (`_spec_verify`: each row writes its
  K/V at spec_write_rows before the attention reads, row i attends [0,
  pos + i]; on the paged engine through the block table, rows past a
  reservation in the trash page, the layer read in logical order, never
  the paged decode kernel) accepts the longest matching prefix a slot on
  the device and commits accepted + 1 tokens. Sampled slots ride the
  round without drafting and sample their one token from row 0 with the
  noise of their sample index, so their stream is the spec-off engine's.
  A per-slot acceptance EMA shrinks a slot's draft length under rejection
  down to 0; a round where no slot drafts is a plain decode chunk (the
  bypass), and after 8 such rounds in a row every live slot re-probes at
  one draft. Greedy tokens equal the spec-off engine's at f32
  (speculation moves the schedule, never the tokens); in bf16 the
  (k+1)-row matmuls round otherwise than single rows, so near-ties may
  part. A verify round is collected in the step that dispatched it, in
  the JAX engine's order (the round in flight is fetched before the
  drafts, committed after the dispatch); a bypass chunk stays in flight
  across steps only while no live slot could draft. On the card the round
  is one more captured graph over static block and draft-length buffers.
  One spill row at the cache end is kept out of every request's span
  (the submit bound), and speculation refuses the int8 KV cache.
- **Lifecycle.** `submit` bounds the queue (`QueueFull`), `cancel` evicts
  wherever the request is (a chunk in flight drops its tokens at commit),
  results stay until `release`d or aged out past `keep_results`, `drain`
  stops admission (`Draining`). A fault fails only the requests it
  touched, counted by cause as the JAX engine counts them (prefill,
  dispatch, collect, commit, watchdog).
- **Registered prefixes.** `register_prefix` prefills a shared prompt
  prefix once. Dense: its first (len // prefill_len) * prefill_len tokens
  stay as a frozen batch-1 temp cache, and a `submit(prefix_id=)`
  admission starts from a COPY of it at that grid offset (the port's
  prefill writes its temp cache in place, so borrowing the cache itself
  would let the first borrower's suffix rows overwrite the prefix). Paged:
  the prefix's full blocks are prefilled into pool pages, inserted into
  the radix tree and pinned, so every admission sharing them matches them.
- **Priority admission and preemption.** A request is "interactive" (the
  default) or "batch". The oldest waiting interactive request is admitted
  first; batch requests keep FIFO order among themselves. With no free
  slot for an interactive head, or with the paged pool too short for it,
  the most recently submitted decoding batch request still under
  `preempt_cap` is ejected as a `reason="preempt"` resume state (moved,
  not killed: the fleet resumes it elsewhere). Its pages and slot free at
  once, even with a chunk in flight that still decodes for it (that
  chunk's tokens for it are dropped at commit, as for any eject). The
  state's `preempted` count rises by one a hop and rides the carry, so
  the cap holds across the fleet and batch work always finishes.
- **Migration.** `eject` finishes a live request as "migrated" with a
  resume state (prompt, committed tokens, total budget, sampling params,
  stop sequences, sampling key, tenant, priority, preempt hops);
  `submit(committed=)` continues such a state: the committed tokens
  prefill as context (riding the radix tree on the paged engine), count
  against the total budget and are never re-emitted, and the first new
  token samples at index len(committed), so a sampled resume continues
  the uninterrupted stream.
- **Weight hot-swap.** `swap_params` validates a new param tree against
  the engine's (structure, shapes, dtypes) before it touches anything,
  places it on the device, re-prefills every registered prefix under the
  new weights and commits it all between steps. On the paged engine the
  radix tree is detached (its pages hold old-weight KV), the prefixes'
  new pages are inserted and pinned, and a prefill in flight across the
  swap never publishes its blocks. A chunk in flight finishes on the old
  weights. A graphed engine copies the new leaves into the storage its
  decode graph captured, in stream order, and keeps the graph.
- **Sampling.** Greedy slots take the argmax (the first maximal index, as
  jnp.argmax, so greedy tokens match the JAX engine). A sampled token is a
  pure function of (request key, sample index): Gumbel-max noise from a
  torch.Generator seeded by both, drawn on the host side of each dispatch
  into a static (C, B, V) buffer, so a sampled stream does not depend on
  slot or batch company; the filters and the draw run on the device with
  no host branch or sync.

An MoE model (`cfg.n_experts > 0`) takes the dense one-hot expert route
at every decode step and verify round (`decode.ffn`), inside the captured
graphs, as the JAX engines route it: every expert over every row, no
sort, no host read.

The norms, prefill RoPE, prefill attention and paged decode attention run
the hand-written CUDA kernels on the card (ops/); a verify round runs the
norms and the embedding gather. Dense decode attention, decode and verify
RoPE and attention, the KV writes and sampling are plain torch, as they are
plain XLA in the JAX package. Where JAX donates the cache to each program and
threads it through a layer `scan`, the port writes the cache's new rows in
place: no step copies it, and a prefill commits only the rows it owns.

**Phase events** (`record_phase_events`, off by default). Each request
then carries a `phase_events` list of (perf_counter, name, value) tuples,
appended where the JAX engine appends them: `resume` at a submit with
committed tokens, `eject` with its reason, `prefill_chunk` with the
prefill offset after each chunk (the final one: the whole context),
`decode_step` (the request's token count) and `commit` ((tokens, host
seconds, overlapped)) at a commit, at most one of each a
`phase_event_every` tokens (a verify round's commit records
`spec_round` ((count, proposed, accepted)) in place of `decode_step`).
The serve main's flight recorder
(observability/flight.py) turns them into span events. They are taken on
the host at commit, never inside the captured decode graph; off, a
request holds None and each site is one `is not None` check.

FaultLab (faultlab/) names five of the JAX engine's fault boundaries here,
where the JAX engine crosses them: `engine.dispatch` (a plain chunk's or
a verify round's dispatch), `engine.collect` (its fetch), `engine.commit`
(one request's commit), `engine.paged_admit` (a paged admission, before anything is
reserved) and `engine.prefill` (each prefill chunk). An injected fault
takes the containment its boundary's real faults take.

**The host KV tier** (`kv_host_blocks > 0`, paged only;
models/kvhost.py). Radix eviction DEMOTES a cold full block to host RAM
(`_kv_demote`, the tree's `on_evict` hook) instead of discarding it; under
the `kv_offload_watermark` free fraction an admission demotes up to two
cold blocks ahead of its match. An admission PREFETCHES the continuation
of its radix match from the tier (`_kv_prefetch`: a restore into a fresh
page, inserted into the tree) before it sizes its reservation, so each
restored block is a prefill chunk it never re-pays; any miss ends the walk
and the rest re-prefills. A restore writes into the pool's own tensors,
so the decode graphs see it. `kvhost_export` / `kvhost_import` ship tier
blocks between replicas (`/v1/kvhost`); on a serving mesh see below.
Every paged engine gossips a bloom
filter of the chain digests it holds (tree and tier) in the `kvhost`
metrics block, rebuilt at most every `kv_gossip_interval` seconds, which
the fleet's router reads to route a prompt to the replica warm for it. A
weight swap clears the tier (its blocks are the old weights' KV).

**overlap** (default True). False collects every chunk in the step that
dispatched it (the JAX engine's `overlap=False`): no chunk stays in flight
across steps, which changes no token.

**Serving meshes** (`mesh=`, a parallel/mesh.ServingMesh of (dp, tp); the
JAX engine's `mesh`). The gang is one driver and its followers: rank 0
runs all of the host logic above (admission, the radix tree and leases,
preemption, the drafter, FaultLab, the HTTP server around it), and every
device program (a decode chunk, a verify round, a prefill step or final,
a temp cache's making, the paged commit, a park, a weight swap's staging)
goes through `_prog`: the driver broadcasts a small header (the program's
name and its host inputs: tokens, positions, tables, drafts, the noise's
keys) and every rank then runs the same program on its own shard of the
params and of the cache or pool; the followers (`follow`) hold no host
state and loop on headers until `stop_followers` (or the degrade). The
programs do their own collectives (decode.py's meshed forward; here the
tp sums after `wo` and `w_down`, the vocab-parallel embedding, the logits
gathered over tp before sampling, so every tp rank samples the same
token, and on the dense engine the packed tokens gathered over dp in slot
order), so rank 0 reads back what one device would. Running the engine in
lockstep on every rank instead would diverge: `_chunk_ready`, the
watchdog and the collect clock read device state and wall time, and two
ranks taking different dispatch decisions hang the collectives. The
dense engine's slots shard over dp (num_slots % dp, the JAX check); the
paged pool holds the rank's KV heads and replicates over dp. On a mesh
above one rank the programs run the plain ops (the JAX package runs no
Pallas kernel there) and eager (no graph); a mesh of one rank runs the
single-device programs, kernels and graphs. An MoE model serves on a
mesh as the dense one does: the serving mesh has no ep axis, so every
rank holds every expert's block of the MLP dim over tp and the router
whole (`decode.SERVING_RULES`), `decode.ffn` computes the rank's partial
output of the dense expert route and the callers' tp sum finishes it, as
for the dense MLP; no collective is added.

The host KV tier on a mesh is the driver's alone (its entries, crcs, LRU
order and counters; followers build none), and holds assembled pages
(every KV head), so `/v1/kvhost` ships the JAX tier's payloads. Its
device work is two programs through `_prog`: a demotion (`_p_kv_demote`,
the tier's stage, queued before the page can be freed) gathers the KV-head
shards of the driver's dp replica over tp (nothing moves under the GQA
fallback, where the driver's page is whole; the other dp replicas hold the
same bits and take no part), and a restore (`_p_kv_restore`) sends the
page from the driver to every rank, each writing its KV-head slice into
the pool in place. The `kvhost.*` FaultLab sites fire on the driver
before either header goes out, so a faulted demotion or fetch sends
nothing and ends as on one device. The signature keys entries by the mesh
(models/kvhost.mesh_signature): a page of another mesh is a miss.

**The degraded-mesh evacuation.** A dispatch on a mesh crosses
`engine.device_loss` after `engine.dispatch`; a device loss there ejects
every live request (queued, prefilling, decoding) as a reason="evacuate"
resume frame (`errors.device_loss`, `evacuated_total`), then the driver
gathers the full weights over the gang (where a deployment restores a
checkpoint), which releases the followers, and serves on one device with
the paged decode kernel off and a fresh device state (`mesh_degraded`);
the decode graphs of a mesh of one rank read the old state, so they are
dropped and captured again.

Tenant metering and budgets live in the serve main (cost/cost_engine.py):
the engine only carries each request's tenant. The serve main also
advertises the disaggregated role.
"""

from __future__ import annotations

import functools
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.attention import NEG_INF, rope_frequencies
from ..ops.paged_attention import paged_decode_attention
from ..ops.quant import as_compute
from .. import faultlab
from ..utils.device import resolve_device
from ..utils.stats import percentile
from . import decode, decode_graph, kvhost, paged_kv, speculative
from . import transformer as tf

Params = tf.Params


def _map_leaves(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def _copy_leaves(dst, src) -> None:
    """Copy every leaf of `src` into the same leaf of `dst` in place."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_leaves(dst[k], src[k])
        return
    with torch.no_grad():
        dst.copy_(src)


def _flat_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf of a param tree, in its order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _flat_leaves(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


def _unflat_leaves(leaves: List[Tuple[str, torch.Tensor]]) -> Params:
    tree: Params = {}
    for path, t in leaves:
        node = tree
        parts = path.strip("/").split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return tree


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


class WatchdogTimeout(RuntimeError):
    """A dispatched decode chunk produced no completed result within
    watchdog_timeout seconds of its dispatch: the device is presumed hung,
    and step() fails the in-flight batch instead of blocking every client
    forever."""


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
    """cache (B, S, ...) <- kv (B, ...) at row pos[b] of each slot, in
    place (one indexed write, no cache copy): K/V rows (B, S, KH, D), and
    an int8 cache's scales (B, S, KH), the JAX engine's _write_slot_scale."""
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


def _sample(logits: torch.Tensor, temps: torch.Tensor,
            top_ps: torch.Tensor, noise: torch.Tensor, top_k: int,
            enable_top_p: bool) -> torch.Tensor:
    """logits (B, V) f32 -> (B,) int64 with PER-SLOT sampling params, as a
    tensor function: no host branch and no sync, so a CUDA graph captures
    it. temps[b] <= 0 is greedy (argmax: the first maximal index, as
    jnp.argmax). A sampled slot filters by the engine-wide top_k and, with
    enable_top_p, its nucleus mass top_ps[b] (exclusive cumulative mass, so
    the first token always survives; top_ps[b] >= 1 keeps every token),
    then takes the Gumbel-max draw over noise (B, V) (`_draw_gumbel`)."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp_min(temps, 1e-6)[:, None]
    if top_k > 0:
        cutoff = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < cutoff, float("-inf"), scaled)
    if enable_top_p:
        probs = torch.softmax(scaled, dim=-1)
        sp = torch.sort(probs, dim=-1, descending=True).values
        keep = (((torch.cumsum(sp, dim=-1) - sp) < top_ps[:, None])
                | (top_ps[:, None] >= 1.0))
        cutoff = sp.gather(-1, keep.sum(dim=-1, keepdim=True) - 1)
        scaled = torch.where(probs >= cutoff, scaled, float("-inf"))
    sampled = torch.argmax(scaled + noise, dim=-1)
    return torch.where(temps > 0.0, sampled, greedy)


def _draw_gumbel(out: torch.Tensor, key: Sequence[int], index: int) -> None:
    """Gumbel noise for the token at sample `index` of the request with
    sampling key `key` into `out` (V,): uniforms from a torch.Generator
    seeded by (key, index) on out's device, so a sampled token is a pure
    function of (request key, sample index), whatever the slot or the
    batch around it."""
    gen = torch.Generator(device=out.device)
    gen.manual_seed(_mix64(key[0], key[1], index))
    u = torch.rand(out.shape, generator=gen, device=out.device)
    out.copy_(-torch.log(-torch.log(u.clamp_min(1e-20))))


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b accumulated and returned in f32 (JAX's
    preferred_element_type=f32) without an f32 copy of a bf16 operand."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())      # no copy when already f32


@dataclass
class _Sampling:
    """The sampling inputs of one dispatch, on the device: per-slot
    temperatures and nucleus masses, and the Gumbel noise of every step
    (noise[n] is step n's (B, V))."""
    temps: torch.Tensor       # (B,) f32, <= 0 greedy
    top_ps: torch.Tensor      # (B,) f32
    noise: torch.Tensor       # (C, B, V) f32
    top_k: int = 0
    enable_top_p: bool = False

    def sample(self, logits: torch.Tensor, step: int) -> torch.Tensor:
        return _sample(logits, self.temps, self.top_ps, self.noise[step],
                       self.top_k, self.enable_top_p)


Attend = Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor],
                  torch.Tensor]


def _attend_rows(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                 ks: Optional[torch.Tensor], vs: Optional[torch.Tensor],
                 mask: torch.Tensor) -> torch.Tensor:
    """Decode attention of q (B, H, D) over each slot's rows kc, vc (B, S,
    KH, D) in logical order, masked by mask (B, S). int8 rows come with
    their scales ks, vs (B, S, KH): the rows are read converted to the
    compute dtype and the scales fold into the f32 logits (before the
    1/sqrt(D) scale) and into the probabilities, in the JAX engine's
    order. Query heads are grouped by KV head (GQA without repeating the
    cache), with f32 products."""
    b, s_max, nkh, hd = kc.shape
    nh, dt = q.shape[1], q.dtype
    g = nh // nkh
    kt = kc.transpose(1, 2).reshape(b * nkh, s_max, hd).to(dt)
    vt = vc.transpose(1, 2).reshape(b * nkh, s_max, hd).to(dt)
    logits = _bmm_f32(q.reshape(b * nkh, g, hd), kt.transpose(1, 2))
    if ks is not None:
        logits = logits * ks.transpose(1, 2).reshape(b * nkh, 1, s_max)
    logits = (logits * hd ** -0.5).reshape(b, nh, s_max)
    logits = torch.where(mask[:, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).reshape(b * nkh, g, s_max)
    if vs is not None:
        p = p * vs.transpose(1, 2).reshape(b * nkh, 1, s_max)
    o = _bmm_f32(p.to(dt), vt)
    return o.reshape(b, nh, hd).to(dt)


def _dense_attend(cache: decode.KVCache, pos: torch.Tensor,
                  cfg: tf.TransformerConfig,
                  kv_idx: Optional[torch.Tensor] = None) -> Attend:
    """Decode attention over the dense cache: layer `layer`'s new K/V rows
    (quantized first on an int8 cache) go in place at pos[b] of each slot,
    then each slot attends j <= pos[b] (through `kv_idx`'s KV heads where
    they are replicated over tp)."""
    s_max = cache.max_seq
    mask = (torch.arange(s_max, device=pos.device)[None, :]
            <= pos[:, None])                                        # (B, S)

    def attend(layer, q, k, v):
        ks = vs = None
        if cache.quantized:
            (k, sk), (v, sv) = decode.kv_quantize(k), decode.kv_quantize(v)
            _write_slot(cache.kscale[layer], sk, pos)
            _write_slot(cache.vscale[layer], sv, pos)
            ks, vs = cache.kscale[layer], cache.vscale[layer]
        _write_slot(cache.k[layer], k, pos)
        _write_slot(cache.v[layer], v, pos)
        return _attend_rows(q, decode.pick_heads(cache.k[layer], kv_idx),
                            decode.pick_heads(cache.v[layer], kv_idx),
                            decode.pick_heads(ks, kv_idx),
                            decode.pick_heads(vs, kv_idx), mask)
    return attend


def _paged_attend(pool: decode.KVCache, table: torch.Tensor,
                  pos: torch.Tensor, block_len: int, paged_kernel: bool = True,
                  kv_idx: Optional[torch.Tensor] = None) -> Attend:
    """Decode attention through the block table: layer `layer`'s new K/V
    rows go in place at each slot's physical row of pos[b] (a parked slot's
    land in the trash page), then each slot attends j <= pos[b] through the
    paged decode kernel, page by page. An int8 pool never reaches the
    kernel (the JAX engine's paged kernel is off under int8 too), nor does
    an engine whose `paged_kernel` is off (a mesh, a degraded engine): its
    rows are gathered in logical order (`paged_rows`) for the dense
    engine's function, through `kv_idx`'s KV heads where they are
    replicated over tp."""
    nb, bl, nkh, hd = pool.k.shape[1:]
    wrow = decode.paged_rows(table, pos[:, None], block_len)[:, 0]   # (B,)
    gather = pool.quantized or not paged_kernel
    if gather:
        s_max = table.shape[1] * block_len
        jpos = torch.arange(s_max, device=pos.device)[None, :]
        rows = decode.paged_rows(table, jpos, block_len)            # (B, S)
        mask = jpos <= pos[:, None]
    else:
        pos32 = pos.to(torch.int32)

    def attend(layer, q, k, v):
        ks = vs = None
        if pool.quantized:
            (k, sk), (v, sv) = decode.kv_quantize(k), decode.kv_quantize(v)
            fks = pool.kscale[layer].view(nb * bl, nkh)
            fvs = pool.vscale[layer].view(nb * bl, nkh)
            fks[wrow] = sk
            fvs[wrow] = sv
            ks, vs = fks[rows], fvs[rows]
        fk = pool.k[layer].view(nb * bl, nkh, hd)
        fv = pool.v[layer].view(nb * bl, nkh, hd)
        fk[wrow] = k
        fv[wrow] = v
        if gather:
            return _attend_rows(q, decode.pick_heads(fk[rows], kv_idx),
                                decode.pick_heads(fv[rows], kv_idx),
                                decode.pick_heads(ks, kv_idx),
                                decode.pick_heads(vs, kv_idx), mask)
        return paged_decode_attention(q, pool.k[layer], pool.v[layer],
                                      table, pos32, block_len=block_len)
    return attend


def _decode_step(params: Params, toks: torch.Tensor, pos: torch.Tensor,
                 cfg: tf.TransformerConfig, freqs: torch.Tensor,
                 sampling: _Sampling, step: int, attend: Attend,
                 mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step `step` of a chunk: one batched decode step at per-slot
    positions. toks, pos: (B,). `attend` writes each layer's new K/V rows
    and returns its attention. On a mesh above one rank `params` are the
    rank's blocks (its heads, MLP hidden and vocab): a tp sum after `wo`
    and after `w_down`, the logits gathered over tp before sampling.
    Returns (next token (B,) int64, its logprob (B,) f32)."""
    dt = cfg.dtype
    b = toks.shape[0]
    hd, d = cfg.head_dim, cfg.d_model
    x = decode.embed(params, toks, cfg, mesh)                       # (B, D)
    for layer in range(cfg.n_layers):
        lp = tf.layer_params(params, layer)
        h = decode.norm(x, lp["ln1"], mesh)
        q = (h @ as_compute(lp["wq"], dt).reshape(d, -1)).reshape(b, -1, hd)
        k = (h @ as_compute(lp["wk"], dt).reshape(d, -1)).reshape(b, -1, hd)
        v = (h @ as_compute(lp["wv"], dt).reshape(d, -1)).reshape(b, -1, hd)
        o = attend(layer, _rope_at(q, freqs, pos), _rope_at(k, freqs, pos), v)
        x = x + decode.tp_sum(o.reshape(b, -1)
                              @ as_compute(lp["wo"], dt).reshape(-1, d), mesh)
        h2 = decode.norm(x, lp["ln2"], mesh)
        x = x + decode.tp_sum(decode.ffn(h2, lp, cfg), mesh)
    x = decode.norm(x, params["final_ln"], mesh)
    logits = decode.head_logits(x, params, cfg, mesh)               # (B, V)
    nxt = sampling.sample(logits, step)
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


def _h2d(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`. On the card the copy is staged through
    pinned memory and left in flight: a copy from pageable memory would
    wait for every chunk already queued on the stream."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


@dataclass
class _HostCopy:
    """A device tensor's copy into host memory, started without a sync:
    `host` (pinned on the card) and `event`, recorded behind the copy on
    the card (None on the CPU, where the copy is done when it returns)."""
    host: torch.Tensor
    event: Optional[Any] = None

    @classmethod
    def start(cls, src: torch.Tensor,
              host: Optional[torch.Tensor] = None) -> "_HostCopy":
        if host is None:
            host = torch.empty(src.shape, dtype=src.dtype,
                               pin_memory=src.is_cuda)
        host.copy_(src, non_blocking=src.is_cuda)
        event = None
        if src.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(src.device))
        return cls(host, event)

    def numpy(self) -> np.ndarray:
        """The copied values in a host array of their own (waits for the
        copy: the designed sync)."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy().copy()


def _steps(params: Params, toks: torch.Tensor, pos: torch.Tensor,
           cfg: tf.TransformerConfig, steps: int, freqs: torch.Tensor,
           sampling: _Sampling, s_max: int,
           attend_at: Callable[[torch.Tensor], Attend], mesh=None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`steps` decode steps, attending through `attend_at(pos)`. Returns
    the packed (C, B, 2) int32 result, the last step's tokens and the
    advanced positions. Parked slots' positions clamp at s_max - 1 so
    their ignored writes stay in bounds."""
    out, lps = [], []
    for n in range(steps):
        toks, lp = _decode_step(params, toks, pos, cfg, freqs, sampling, n,
                                attend_at(pos), mesh)
        out.append(toks)
        lps.append(lp)
        pos = torch.clamp(pos + 1, max=s_max - 1)
    return _pack(torch.stack(out), torch.stack(lps)), toks, pos


def _decode_chunk(params: Params, cache: decode.KVCache, toks: torch.Tensor,
                  pos: torch.Tensor, cfg: tf.TransformerConfig, steps: int,
                  freqs: torch.Tensor, sampling: _Sampling, mesh=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`steps` decode steps over the dense cache (on a mesh: the rank's
    slots, toks and pos its rows)."""
    kv_idx = decode.kv_index(cfg, mesh, toks.device)
    return _steps(params, toks, pos, cfg, steps, freqs, sampling,
                  cache.max_seq, lambda p: _dense_attend(cache, p, cfg,
                                                         kv_idx), mesh)


def _decode_chunk_paged(params: Params, pool: decode.KVCache,
                        table: torch.Tensor, toks: torch.Tensor,
                        pos: torch.Tensor, cfg: tf.TransformerConfig,
                        steps: int, freqs: torch.Tensor, sampling: _Sampling,
                        block_len: int, mesh=None, paged_kernel: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`steps` decode steps through the block table (B, MB) int32, which
    does not change within a chunk: a reservation covers the request's
    whole prompt + max_new span from admission."""
    kv_idx = decode.kv_index(cfg, mesh, toks.device)
    return _steps(params, toks, pos, cfg, steps, freqs, sampling,
                  table.shape[1] * block_len,
                  lambda p: _paged_attend(pool, table, p, block_len,
                                          paged_kernel, kv_idx), mesh)


def _attend_block(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Verify attention of q (B, T, H, D) over each slot's rows kc, vc (B,
    S, KH, D) in logical order, masked by mask (B, T, S): _attend_rows for
    T query rows a slot. Query heads are grouped by KV head, with f32
    products."""
    b, t, nh, hd = q.shape
    s_max, nkh = kc.shape[1], kc.shape[2]
    g, dt = nh // nkh, q.dtype
    kt = kc.transpose(1, 2).reshape(b * nkh, s_max, hd).to(dt)
    vt = vc.transpose(1, 2).reshape(b * nkh, s_max, hd).to(dt)
    qg = q.reshape(b, t, nkh, g, hd).permute(0, 2, 1, 3, 4)
    logits = _bmm_f32(qg.reshape(b * nkh, t * g, hd), kt.transpose(1, 2))
    logits = (logits * hd ** -0.5).reshape(b, nkh, t, g, s_max)
    logits = torch.where(mask[:, None, :, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).reshape(b * nkh, t * g, s_max)
    o = _bmm_f32(p.to(dt), vt).reshape(b, nkh, t, g, hd)
    return o.permute(0, 2, 1, 3, 4).reshape(b, t, nh, hd).to(dt)


def _verify_block(params: Params, cache: decode.KVCache,
                  block: torch.Tensor, pos: torch.Tensor,
                  cfg: tf.TransformerConfig, freqs: torch.Tensor,
                  sampling: _Sampling, table: Optional[torch.Tensor],
                  block_len: int, mesh=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batched multi-token verify step at per-slot positions.

    block: (B, T) candidate tokens (T = spec_k + 1; row 0 is the slot's
    committed token, rows 1.. its drafts). Row i's output is what the model
    emits after [history..., block[:i + 1]]: a T-step incremental decode in
    one pass. Each row's K/V is written at spec_write_rows before the
    attention reads the layer; row i attends [0, pos + i]. `table` None is
    the dense cache; otherwise the paged pool through the block table,
    rows past a reservation landing in the trash page, and the attention
    reads each slot's rows in logical order (the paged decode kernel is
    single-token, as the JAX engine's). Row 0 samples with `sampling`'s
    first noise row (a sampled slot never drafts, so its row 0 is the only
    row it can commit); rows 1.. take the argmax. On a mesh the rank's
    heads, MLP hidden and vocab, as in `_decode_step`. Returns (out (B, T)
    int64, the model logprobs of out (B, T) f32)."""
    dt = cfg.dtype
    b, t = block.shape
    hd, d = cfg.head_dim, cfg.d_model
    nkh = cache.k.shape[3]
    kv_idx = decode.kv_index(cfg, mesh, block.device)
    paged = table is not None
    s_max = table.shape[1] * block_len if paged else cache.max_seq
    wrows = decode.spec_write_rows(pos, t, s_max)                 # (B, T)
    flat_rows = wrows.reshape(b * t)
    jpos = torch.arange(s_max, device=pos.device)
    posm = pos[:, None] + torch.arange(t, device=pos.device)[None, :]
    mask = jpos[None, None, :] <= posm[:, :, None]                # (B, T, S)
    if paged:
        nb, bl = cache.k.shape[1:3]
        rows_all = decode.paged_rows(table, jpos[None, :], block_len)
        wphys = decode.paged_rows(table, wrows, block_len).reshape(b * t)
    x = decode.embed(params, block, cfg, mesh)                    # (B, T, D)
    for layer in range(cfg.n_layers):
        lp = tf.layer_params(params, layer)
        h = decode.norm(x.reshape(b * t, d), lp["ln1"], mesh)
        q = (h @ as_compute(lp["wq"], dt).reshape(d, -1)
             ).reshape(b * t, -1, hd)
        k = (h @ as_compute(lp["wk"], dt).reshape(d, nkh * hd)
             ).reshape(b * t, nkh, hd)
        v = (h @ as_compute(lp["wv"], dt).reshape(d, nkh * hd)
             ).reshape(b, t, nkh, hd)
        q = _rope_at(q, freqs, flat_rows).reshape(b, t, -1, hd)
        k = _rope_at(k, freqs, flat_rows).reshape(b, t, nkh, hd)
        if paged:
            fk = cache.k[layer].view(nb * bl, nkh, hd)
            fv = cache.v[layer].view(nb * bl, nkh, hd)
            fk[wphys] = k.reshape(b * t, nkh, hd)
            fv[wphys] = v.reshape(b * t, nkh, hd)
            ka, va = fk[rows_all], fv[rows_all]                   # (B, S, ...)
        else:
            decode.scatter_rows(cache.k[layer], k, wrows)
            decode.scatter_rows(cache.v[layer], v, wrows)
            ka, va = cache.k[layer], cache.v[layer]
        o = _attend_block(q, decode.pick_heads(ka, kv_idx),
                          decode.pick_heads(va, kv_idx), mask)
        x = x + decode.tp_sum(o.reshape(b * t, -1)
                              @ as_compute(lp["wo"], dt).reshape(-1, d),
                              mesh).reshape(b, t, d)
        h2 = decode.norm(x.reshape(b * t, d), lp["ln2"], mesh)
        x = x + decode.tp_sum(decode.ffn(h2, lp, cfg), mesh).reshape(b, t, d)
    x = decode.norm(x.reshape(b * t, d), params["final_ln"], mesh)
    logits = decode.head_logits(x, params, cfg, mesh).reshape(b, t, -1)
    out = torch.cat([sampling.sample(logits[:, 0], 0)[:, None],
                     torch.argmax(logits[:, 1:], dim=-1)], dim=1)
    lps = torch.log_softmax(logits, dim=-1).gather(2, out[..., None])[..., 0]
    return out, lps


def _spec_verify(params: Params, cache: decode.KVCache, block: torch.Tensor,
                 draft_len: torch.Tensor, pos: torch.Tensor,
                 cfg: tf.TransformerConfig, freqs: torch.Tensor,
                 sampling: _Sampling, table: Optional[torch.Tensor],
                 block_len: int, mesh=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Verify and accept, on the device: `_verify_block`, then each slot's
    emitted count (speculative.accept_counts), its next token (the last
    emitted one) and its position advanced past them (clamped to s_max -
    1). Returns (packed (B, 2T+1) int32: the T candidate tokens, their f32
    logprobs bitcast and the emitted count; the next tokens; the
    positions). Rejected rows stay garbage behind the frontier, overwritten
    by the next round before any mask admits them."""
    s_max = table.shape[1] * block_len if table is not None \
        else cache.max_seq
    out, lps = _verify_block(params, cache, block, pos, cfg, freqs,
                             sampling, table, block_len, mesh)
    emitted = speculative.accept_counts(block[:, 1:], out, draft_len)
    cur = out.gather(1, (emitted - 1)[:, None])[:, 0]
    packed = torch.cat([out.to(torch.int32),
                        lps.float().contiguous().view(torch.int32),
                        emitted[:, None].to(torch.int32)], dim=1)
    return packed, cur, torch.clamp(pos + emitted, max=s_max - 1)


def _init_temp_cache(cfg: tf.TransformerConfig, max_seq: int,
                     device, mesh=None) -> decode.KVCache:
    """Batch-1 temp prefill cache (on a mesh: the rank's KV heads; every
    dp rank holds one)."""
    return decode.init_cache(cfg, 1, max_seq, device, mesh)


def _prefill_step(params: Params, temp: decode.KVCache, chunk: torch.Tensor,
                  cfg: tf.TransformerConfig, offset: int,
                  freqs: torch.Tensor, mesh=None) -> decode.KVCache:
    """One NON-final prefill chunk: advance the temp cache over `chunk`
    (1, P) of real tokens at global offset `offset`; the logits are
    discarded."""
    _, temp = decode.forward_cached(params, chunk, temp, offset, cfg,
                                    freqs=freqs, mesh=mesh)
    return temp


def _prefill_final(params: Params, cache: decode.KVCache,
                   temp: decode.KVCache, chunk: torch.Tensor,
                   slot: Optional[int], plen: int, cfg: tf.TransformerConfig,
                   offset: int, freqs: torch.Tensor, sampling: _Sampling,
                   mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final prefill chunk: advance the temp cache over the (padded) last
    `chunk`, copy the whole temp cache into cache row `slot` (None: the
    slot lives on another dp rank, which writes it), and sample the first
    token from the logits at plen - 1 (plen = real tokens in this chunk).
    Pad rows hold garbage K/V that decode overwrites before the mask ever
    reaches them. Returns (token, logprob) device scalars."""
    logits, temp = decode.forward_cached(params, chunk, temp, offset, cfg,
                                         freqs=freqs, mesh=mesh)
    if slot is not None:
        for big, small in zip(cache.leaves(), temp.leaves()):
            big[:, slot].copy_(small[:, 0])
    return _first_token(logits[0, plen - 1], sampling)


def _first_token(last: torch.Tensor, sampling: _Sampling
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample a request's first token from its last prompt row's logits
    (V,) with a batch-1 `sampling` (the decode steps' function); returns
    (token, logprob) device scalars."""
    tok = sampling.sample(last[None], 0)[0]
    return tok, torch.log_softmax(last, dim=-1)[tok]


def _pool_rows(row: np.ndarray, start: int, stop: int, block_len: int,
               device) -> torch.Tensor:
    """Physical pool rows of logical positions [start, stop) of a slot
    whose block-table row is `row` (host int32)."""
    return decode.paged_rows(_h2d(row, device),
                             torch.arange(start, stop, device=device),
                             block_len)


def _temp_from_pool(pool: decode.KVCache, row: np.ndarray, matched: int,
                    max_seq: int, block_len: int) -> decode.KVCache:
    """A batch-1 temp prefill cache whose first `matched` rows are gathered
    from the pool (a radix-matched prefix), the rest zero: suffix prefill
    chunks attend over the shared prefix KV without recomputing it. int8
    scales come with their rows."""
    l, nb, bl = pool.k.shape[:3]
    rows = _pool_rows(row, 0, matched, block_len, pool.k.device)

    def gather(pages: torch.Tensor) -> torch.Tensor:
        tail = pages.shape[3:]
        out = torch.zeros((l, 1, max_seq) + tail, dtype=pages.dtype,
                          device=pages.device)
        out[:, 0, :matched] = pages.view((l, nb * bl) + tail)[:, rows]
        return out
    return decode.KVCache(*map(gather, pool.leaves()))


def _commit_rows(pool: decode.KVCache, temp: decode.KVCache, row: np.ndarray,
                 write_from: int, write_to: int, block_len: int) -> None:
    """Scatter temp rows [write_from, write_to) into the slot's pool pages
    through its table row, in place (JAX's _commit_window_rows +
    _pool_commit_rows). Rows outside the window are not written at all, so
    shared prefix pages stay read-only and pad garbage never lands; the
    JAX package's trash redirect of those rows is not needed. int8 scales
    go with their rows."""
    l, nb, bl = pool.k.shape[:3]
    rows = _pool_rows(row, write_from, write_to, block_len, pool.k.device)
    for pages, src in zip(pool.leaves(), temp.leaves()):
        pages.view((l, nb * bl) + pages.shape[3:])[:, rows] = \
            src[:, 0, write_from:write_to]


def _prefill_final_paged(params: Params, pool: decode.KVCache,
                         temp: decode.KVCache, chunk: torch.Tensor,
                         row: np.ndarray, write_from: int, write_to: int,
                         plen: int, cfg: tf.TransformerConfig, offset: int,
                         freqs: torch.Tensor, sampling: _Sampling,
                         block_len: int, mesh=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paged twin of _prefill_final: advance the temp cache over the
    (padded) last chunk, commit rows [write_from, write_to) — the part of
    the prompt no shared page holds — into the slot's pages, and sample the
    first token from the logits at plen - 1 (real tokens in this chunk)."""
    logits, temp = decode.forward_cached(params, chunk, temp, offset, cfg,
                                         freqs=freqs, mesh=mesh)
    _commit_rows(pool, temp, row, write_from, write_to, block_len)
    return _first_token(logits[0, plen - 1], sampling)


@dataclass(frozen=True)
class _Tag:
    """A temp prefill cache named on the wire: the driver's temp and each
    follower's of the same tag hold the same rows, each of its rank's
    shard."""
    tag: int


# Device programs that make a temp cache: the driver names it (its tag
# rides the header) and every follower files its own under that name.
_MAKES_TEMP = frozenset({"temp_new", "temp_clone", "temp_from_pool"})


def _chunk_ready(inflight) -> bool:
    """True once a dispatched chunk's (or first token's) copy to the host
    has landed: the copy's event on the card; on the CPU a dispatched
    chunk is already computed. Module-level so a test can simulate a hung
    device by patching it."""
    event = inflight.copy.event
    return event is None or bool(event.query())


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
    # Host-tier prefetch window (engines with kv_host_blocks > 0): the
    # admission restored offloaded prefix blocks between these two
    # perf_counter stamps, before admitted_at (the flight recorder's
    # `prefetch` span: queue_wait ends where it starts).
    prefetch_started_at: Optional[float] = None
    prefetch_done_at: Optional[float] = None
    # Resumed requests: tokens[:emit_from] were generated by another
    # replica. They prefill as context, count against max_new_tokens and
    # are never re-emitted.
    emit_from: int = 0
    # Set by eject(): the resumeFrom payload another replica continues.
    resume_state: Optional[dict] = None
    # Tenancy: the tenant the serve meters, the priority class
    # ("interactive" admitted ahead of "batch"; batch slots may be
    # preempted for an interactive head) and the preempt hops this
    # generation has taken fleet-wide (carried in the resume state).
    tenant: str = ""
    priority: str = "interactive"
    preempted: int = 0
    # The flight recorder's phase log (record_phase_events engines only;
    # None otherwise, so a request with the recorder off allocates
    # nothing): (perf_counter, name, value) tuples.
    phase_events: Optional[list] = None

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


@dataclass
class _Inflight:
    """A dispatched decode chunk: its packed tokens' copy to the host, the
    (slot, request) pairs live at dispatch, when its dispatch began (its
    wall starts there: an eager chunk's launches take host time) and
    ended (the watchdog's deadline runs from there, so a capture never
    counts), and the chunk's length (decode_chunk, or the quantum): its
    copy holds exactly that many rows. A speculative verify round carries
    its slots' draft lengths in `dlen` (None for a decode chunk), and its
    copy the packed (B, 2T+1) round."""
    copy: _HostCopy
    snapshot: List[Tuple[int, ServeRequest]]
    t_start: float
    t_dispatch: float
    n: int
    dlen: Optional[np.ndarray] = None


@dataclass
class _PendingFirst:
    """An admitted request's first token, still on its way to the host:
    the (1, 1, 2) packed token and logprob."""
    req: ServeRequest
    slot: int
    copy: _HostCopy


class ContinuousBatchEngine:
    """Slot-based continuous batching over one KTWE-LM instance.

    submit() enqueues (QueueFull beyond max_queue); step() admits pending
    requests into free slots (at most `prefill_interleave` prefill chunks
    per step while anything decodes), dispatches the next `decode_chunk`
    tokens of every live slot behind the chunk in flight, then fetches
    and commits that one; cancel() evicts; run() drains.
    `device` defaults to "cuda" and raises without a card; params must
    already live on it. `kv_block_len > 0` builds the paged engine over a
    pool of `kv_num_blocks` pages (0 = the dense cache's rows plus the
    trash page).

    One chunk stays in flight across steps; `overlap_commit` fetches and
    commits it behind the next dispatch (False: before it, for
    bisection), which changes no token; `overlap=False` collects every
    chunk in the step that dispatched it. `watchdog_timeout` (seconds, None off) fails the
    in-flight batch when its chunk has not landed that long after its
    dispatch. `cuda_graph` (the card only) replays the decode chunk as
    one captured CUDA graph (models/decode_graph.py); False launches it
    eagerly, which exists to hold the graph to the eager path.
    `prefill_chunk_tokens > 0` replaces prefill_len and decodes the short
    quantum under a prefill backlog; `handoff_first_token` is the prefill
    role (see the module notes). `record_phase_events` gives every request
    a phase_events log, its decode_step and commit events at most one a
    `phase_event_every` tokens (see the module notes). `spec_k > 0` turns
    on speculative decoding: up to spec_k drafts a greedy slot from
    `drafter` (any callable (context, k) -> tokens; default an NGramDrafter
    of max_n `spec_ngram`), verified in one (spec_k + 1)-wide round, with
    the per-slot adaptive controller unless `spec_adaptive` is False (see
    the module notes). `kv_host_blocks > 0` (paged only) puts the host KV
    tier under the pool, `kv_offload_watermark` is its demote-ahead free
    fraction and `kv_gossip_interval` the seconds between bloom rebuilds
    (see the module notes)."""

    def __init__(self, params: Params, cfg: tf.TransformerConfig, *,
                 num_slots: int = 4, max_seq: Optional[int] = None,
                 prefill_len: int = 64, decode_chunk: int = 8,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 enable_top_p: Optional[bool] = None, seed: int = 0,
                 max_queue: int = 256, prefill_interleave: int = 2,
                 keep_results: int = 1024, kv_block_len: int = 0,
                 kv_num_blocks: int = 0, max_prefixes: int = 8,
                 overlap_commit: bool = True,
                 watchdog_timeout: Optional[float] = None,
                 cuda_graph: bool = True, preempt_cap: int = 2,
                 prefill_chunk_tokens: int = 0,
                 handoff_first_token: bool = False,
                 record_phase_events: bool = False,
                 phase_event_every: int = 16, spec_k: int = 0,
                 spec_ngram: int = 3, spec_adaptive: bool = True,
                 drafter: Optional[Callable] = None, overlap: bool = True,
                 kv_host_blocks: int = 0, kv_offload_watermark: float = 0.0,
                 kv_gossip_interval: float = 30.0, mesh=None,
                 device="cuda"):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.params = params
        self.cfg = cfg
        self.num_slots = int(num_slots)
        self.max_seq = int(max_seq or cfg.max_seq)
        # The serving mesh (see the module notes): `mesh` is this rank's
        # place on the gang; `_layout` the mesh the programs see, None on
        # one device and on a mesh of one rank (the single-device
        # programs, kernels and graphs).
        self.mesh = mesh
        if mesh is not None:
            if not kv_block_len and self.num_slots % mesh.dp:
                raise ValueError(
                    f"num_slots {num_slots} must divide over the mesh's "
                    f"batch axes (dp*ep = {mesh.dp}) — the KV cache's slot "
                    f"dim shards over them")
        self._layout = mesh if decode.meshed(mesh) else None
        # The KV heads' tp axis ("tp", or None where the KV heads are
        # replicated over tp: the GQA fallback), as the JAX engine decides
        # it once.
        self._kv_tp = (decode._kv_tp_axis(cfg, mesh) if mesh is not None
                       else None)
        # The paged decode kernel runs on one device only (the JAX engine
        # gates its Pallas kernel off on a mesh, and off after a device
        # loss).
        self._paged_kernel = self._layout is None
        # Temp caches by tag (followers), the next tag and the tags of the
        # driver's temps that died since its last header.
        self._temp_caches: Dict[int, decode.KVCache] = {}
        self._next_tag = 0
        self._dead_tags: deque = deque()
        self._staged: Optional[Params] = None
        self._swap_src: Optional[Params] = None
        self._stopped = False
        # Chunked prefill: the value replaces prefill_len as the prompt
        # slice, and a prefill backlog drops decode to the short quantum.
        self.prefill_chunk_tokens = int(prefill_chunk_tokens or 0)
        self._chunked_prefill = self.prefill_chunk_tokens > 0
        if self._chunked_prefill:
            prefill_len = self.prefill_chunk_tokens
        if self.max_seq % prefill_len:
            # The final (padded) chunk writes a whole prefill_len window at
            # a prefill_len multiple; it must not clamp back over real rows.
            raise ValueError(f"max_seq {self.max_seq} must be a multiple of "
                             f"prefill_len {prefill_len}")
        self.prefill_len = int(prefill_len)
        self.decode_chunk = int(decode_chunk)
        self._decode_quantum = max(1, self.decode_chunk // 4)
        # The prefill role: one token a request, then a handoff eject.
        self.handoff_first_token = bool(handoff_first_token)
        # The flight recorder's phase events (off: no request allocates a
        # log and each site is one `is not None` check).
        self._phases_on = bool(record_phase_events)
        self._phase_event_every = max(1, int(phase_event_every))
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
        self.overlap = bool(overlap)
        self.overlap_commit = bool(overlap_commit)
        self.watchdog_timeout = (float(watchdog_timeout)
                                 if watchdog_timeout else None)
        self.max_prefixes = int(max_prefixes)
        # Speculative decoding: drafts on the host, one verify round a step
        # (the module notes); the floor under rejection is plain decode.
        self.spec_k = int(spec_k or 0)
        self._spec = self.spec_k > 0
        self.spec_ngram = int(spec_ngram)
        self._spec_adaptive = bool(spec_adaptive)
        if self._spec:
            if cfg.kv_cache_int8:
                raise ValueError(
                    "speculation (spec_k > 0) does not support "
                    "kv_cache_int8 yet — the verify program carries no "
                    "scale rows (same gate as generate_speculative)")
            if drafter is None:
                drafter = speculative.NGramDrafter(max_n=self.spec_ngram)
        self._drafter = drafter
        # The per-slot adaptive controller: draft length and acceptance
        # EMA a slot, reset at admission; the slow engine-wide EMA decides
        # whether an admission starts at full k or at one probe.
        self._spec_k_cur = [self.spec_k] * int(num_slots)
        self._spec_ema = [1.0] * int(num_slots)
        self._spec_global_ema = 1.0
        # Consecutive all-bypass rounds before speculation re-probes at k=1.
        self._spec_reprobe = 8
        self._spec_rounds_total = 0
        self._spec_tokens_total = 0
        self._spec_proposed_total = 0
        self._spec_accepted_total = 0
        self._spec_bypass_total = 0
        self._spec_bypass_streak = 0
        # Slot-rounds by dispatched draft length (0: rode the round without
        # drafting).
        self._spec_k_hist = [0] * (self.spec_k + 1)
        # How many times one batch generation may be preempted, fleet-wide
        # (its carried `preempted` count); 0 disables preemption.
        self.preempt_cap = int(preempt_cap)
        self._prefixes: Dict[int, _Prefix] = {}
        self._next_prefix_id = 0
        self._seed = int(seed)
        self.kv_block_len = int(kv_block_len or 0)
        self._paged = self.kv_block_len > 0
        # The slots this rank's cache holds: all of them, but on a dense
        # engine on a mesh its dp block (a paged pool replicates over dp).
        dp = (self._layout.dp if self._layout is not None and not self._paged
              else 1)
        nloc = self.num_slots // dp
        r = self._layout.dp_rank if dp > 1 else 0
        self._rows = (r * nloc, (r + 1) * nloc)
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
                                                 self.device, self._layout)
        else:
            self.kv_num_blocks = 0
            self._cache = decode.init_cache(cfg, nloc, self.max_seq,
                                            self.device, self._layout)
        # The host KV tier (paged only): radix eviction demotes into it and
        # admission prefetches from it (the module notes).
        self.kv_host_blocks = (int(kv_host_blocks or 0)
                               if self._paged else 0)
        self.kv_offload_watermark = float(kv_offload_watermark or 0.0)
        self.kv_gossip_interval = float(kv_gossip_interval or 30.0)
        self._host_tier: Optional[kvhost.HostBlockTier] = None
        # A restore's host rows, on the driver while its program runs.
        self._restore_src: Optional[Dict[str, torch.Tensor]] = None
        if self.kv_host_blocks > 0 and (mesh is None or mesh.is_driver):
            # On a mesh the tier is the driver's alone (followers hold no
            # host state); its pages are assembled, every KV head.
            self._host_tier = kvhost.HostBlockTier(
                capacity=self.kv_host_blocks, block_len=self.kv_block_len,
                device=self.device, mesh=mesh, kv_tp=self._kv_tp,
                stage=lambda cache, blk: self._prog("kv_demote", blk),
                write=self._kv_write, page_layout={
                    n: (self._page_shape(t), t.dtype)
                    for n, t in zip(kvhost.LEAF_NAMES,
                                    self._cache.leaves())})
            self._radix.on_evict = self._kv_demote
        # The gossiped warmth bloom, rebuilt lazily in metrics_snapshot.
        self._kv_bloom_hex = ""
        self._kv_bloom_bits = 0
        self._kv_bloom_hashes = 0
        self._kv_bloom_at = 0.0
        self._freqs = rope_frequencies(cfg.head_dim, self.max_seq,
                                       cfg.rope_theta, self.device)
        # Device slot mirrors: every slot's next input token, position and
        # sampling params. A chunk reads them and writes the tokens and
        # positions back on the device; an admission writes its slot's
        # entries in place (its first token never visits the host first).
        # They are the captured graph's static inputs, so they are only
        # ever written in place.
        n, dev = self.num_slots, self.device
        self._cur_d = torch.zeros(n, dtype=torch.int64, device=dev)
        self._pos_d = torch.zeros(n, dtype=torch.int64, device=dev)
        self._temps_d = torch.full((n,), self.temperature,
                                   dtype=torch.float32, device=dev)
        self._topps_d = torch.full((n,), self.top_p, dtype=torch.float32,
                                   device=dev)
        # Gumbel noise of a chunk's sampled slots, drawn on the host side
        # of each dispatch; and the chunk's packed (C, B, 2) output. A
        # quantum reads and writes their first rows.
        self._noise_d = torch.zeros((self.decode_chunk, n, cfg.vocab_size),
                                    dtype=torch.float32, device=dev)
        self._out_d = torch.zeros((self.decode_chunk, n, 2),
                                  dtype=torch.int32, device=dev)
        # Two host buffers, alternating: a chunk's copy is started while
        # the one before it may not have been read yet.
        self._out_h = [torch.zeros(self._out_d.shape, dtype=torch.int32,
                                   pin_memory=dev.type == "cuda")
                       for _ in range(2)]
        # Host mirrors the noise draw reads: sample counters advanced per
        # dispatch as the device's chunks advance, sampling keys and
        # temperatures. (Positions live on the device alone: no host code
        # reads them.)
        self._scnt = np.zeros(n, np.int64)
        self._skeys = np.zeros((n, 2), np.uint32)
        self._temps = np.full(n, self.temperature, np.float32)
        self._slot_req: List[Optional[ServeRequest]] = [None] * n
        self._prefill: Optional[_PrefillState] = None
        # First tokens sampled at admission, resolved at the next commit.
        self._pending_first: List[_PendingFirst] = []
        # The chunk in flight: fetched by the next step.
        self._inflight: Optional[_Inflight] = None
        self._last_collect_t: Optional[float] = None
        # One decode graph a chunk length, each captured on its first
        # dispatch: the full chunk's, and the quantum's when it differs.
        # A mesh above one rank runs eager: its chunk's collectives are not
        # captured (ROADMAP's held list).
        graphed = cuda_graph and dev.type == "cuda" and self._layout is None
        self._graph = decode_graph.DecodeGraph(dev) if graphed else None
        self._quantum_graph = (
            decode_graph.DecodeGraph(dev, "decode quantum")
            if graphed and self._chunked_prefill
            and self._decode_quantum != self.decode_chunk else None)
        # The verify round's static buffers: the (B, k+1) block (column 0
        # the slots' next tokens, copied on the device; the host's drafts
        # go into the rest before each round), the draft lengths and the
        # packed (B, 2k+3) round with its host buffer. It is one more
        # graph, captured on the first round.
        if self._spec:
            t = self.spec_k + 1
            self._block_d = torch.zeros((n, t), dtype=torch.int64,
                                        device=dev)
            self._dlen_d = torch.zeros(n, dtype=torch.int64, device=dev)
            self._spec_out_d = torch.zeros((n, 2 * t + 1), dtype=torch.int32,
                                           device=dev)
            self._spec_out_h = torch.zeros(self._spec_out_d.shape,
                                           dtype=torch.int32,
                                           pin_memory=dev.type == "cuda")
        self._verify_graph = (decode_graph.DecodeGraph(dev, "verify round")
                              if graphed and self._spec else None)
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
        # Contained failures by cause (the JAX engine's keys).
        self._errors_total = {"dispatch": 0, "collect": 0, "commit": 0,
                              "prefill": 0, "watchdog": 0,
                              # A device lost under a meshed dispatch:
                              # answered by evacuation, never per-request
                              # failure; a prefix the degraded rebuild
                              # could not pin again.
                              "device_loss": 0, "prefix_repin": 0}
        self._watchdog_trips = 0
        # The degraded-mesh evacuation: requests ejected as
        # reason="evacuate" frames, and whether the engine serves on one
        # device after a device loss.
        self._evacuated_total = 0
        self._mesh_degraded = False
        # Radix evictions before a device-state rebuild (the counter is
        # monotonic across it).
        self._kv_evictions_prior = 0
        # Hot-path accounting: host seconds waiting on the fetch (the
        # round's one sync, watchdog poll included) and committing, and the
        # commit seconds that ran behind an already-dispatched chunk.
        self._commit_rounds_total = 0
        self._commit_s_total = 0.0
        self._commit_overlapped_s_total = 0.0
        self._fetch_sync_s_total = 0.0
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
        # tokens, live requests ejected as resume states, and the ejects
        # that were priority preemptions.
        self._resumed_total = 0
        self._resume_committed_total = 0
        self._ejected_total = 0
        self._preempted_total = 0
        self._handoffs_total = 0

    # -- the gang: device programs --

    def _prog(self, name: str, *args):
        """Run device program `name` (the method `_p_<name>`) on this
        rank's state. On a mesh the driver first broadcasts the program's
        header: its name, its host inputs (a temp cache by its tag), the
        tag of a temp it makes and the tags of the driver's temps that died
        since the last header; every follower then runs the same program on
        its shard (`follow`)."""
        fn = getattr(self, "_p_" + name)
        if self.mesh is None:
            return fn(*args)
        tag = None
        if name in _MAKES_TEMP:
            tag, self._next_tag = self._next_tag, self._next_tag + 1
        dead = []
        while self._dead_tags:
            dead.append(self._dead_tags.popleft())
        self._send((name, tuple(_Tag(a.tag) if isinstance(a, decode.KVCache)
                                else a for a in args), tag, dead))
        out = fn(*args)
        if tag is not None:
            out.tag = tag
            weakref.finalize(out, self._dead_tags.append, tag)
        return out

    def _send(self, header) -> None:
        """The driver's broadcast of one header."""
        self.mesh.world.broadcast_object(header, 0)

    def follow(self) -> None:
        """A follower's loop (a rank above 0 of a serving mesh): run the
        driver's device programs on this rank's shard, in the driver's
        order, until the driver stops the gang or degrades to one device.
        The follower holds no host state."""
        if self.mesh is None or self.mesh.is_driver:
            raise RuntimeError("follow() runs on a follower rank (above 0) "
                               "of a serving mesh")
        while True:
            name, wire, tag, dead = self.mesh.world.broadcast_object(None, 0)
            for t in dead:
                self._temp_caches.pop(t, None)
            if name == "stop":
                return
            out = getattr(self, "_p_" + name)(*(
                self._temp_caches[a.tag] if isinstance(a, _Tag) else a
                for a in wire))
            if tag is not None:
                self._temp_caches[tag] = out
            if name == "degrade":
                return

    def stop_followers(self) -> None:
        """The driver's stop header: every follower leaves its loop (the
        serve main's shutdown). A no-op off a mesh and after a degrade."""
        if self.mesh is not None and self.mesh.is_driver and not self._stopped:
            self._stopped = True
            self._send(("stop", (), None, []))

    def _local_slot(self, b: int) -> Optional[int]:
        """Slot b's row in this rank's cache (None: another dp rank's)."""
        lo, hi = self._rows
        return b - lo if lo <= b < hi else None

    def _p_temp_new(self) -> decode.KVCache:
        return _init_temp_cache(self.cfg, self.max_seq, self.device,
                                self._layout)

    def _p_temp_clone(self, src: decode.KVCache) -> decode.KVCache:
        return decode.KVCache(*(t.clone() for t in src.leaves()))

    def _p_temp_from_pool(self, row: np.ndarray,
                          matched: int) -> decode.KVCache:
        return _temp_from_pool(self._cache, row, matched, self.max_seq,
                               self.kv_block_len)

    def _p_prefill_step(self, temp: decode.KVCache, chunk: np.ndarray,
                        offset: int, staged: bool) -> decode.KVCache:
        return _prefill_step(self._staged if staged else self.params, temp,
                             _h2d(chunk, self.device), self.cfg, offset,
                             self._freqs, mesh=self._layout)

    def _p_commit_rows(self, temp: decode.KVCache, row: np.ndarray,
                       write_from: int, write_to: int) -> None:
        _commit_rows(self._cache, temp, row, write_from, write_to,
                     self.kv_block_len)

    def _p_park(self, b: int) -> None:
        self._table_d[b].zero_()

    def _p_prefill_final(self, temp: decode.KVCache, chunk: np.ndarray,
                         b: int, ctx_len: int, plen: int, offset: int,
                         r_temp: float, r_topp: float, key: Sequence[int],
                         index: int, row: Optional[np.ndarray],
                         matched: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The final prefill chunk into slot b, its first token sampled at
        `index` of `key`, and the slot's device entries: the first token
        goes to the next chunk without visiting the host."""
        sampling = self._first_sampling(r_temp, r_topp, key, index)
        chunk = _h2d(chunk, self.device)
        if self._paged:
            tok, lp = _prefill_final_paged(
                self.params, self._cache, temp, chunk, row, matched, ctx_len,
                plen, self.cfg, offset, self._freqs, sampling,
                self.kv_block_len, mesh=self._layout)
            self._table_d[b].copy_(_h2d(row, self.device))
        else:
            tok, lp = _prefill_final(
                self.params, self._cache, temp, chunk, self._local_slot(b),
                plen, self.cfg, offset, self._freqs, sampling,
                mesh=self._layout)
        self._cur_d[b] = tok
        self._pos_d[b] = ctx_len
        self._temps_d[b] = r_temp
        self._topps_d[b] = r_topp
        return tok, lp

    def _p_chunk(self, n: int, noise: list) -> None:
        """One decode chunk of n steps (its graph's replay on the card)."""
        self._draw_noise(noise, n)
        graph = (self._quantum_graph if n != self.decode_chunk
                 else self._graph)
        if graph is not None:
            graph.replay(functools.partial(self._run_chunk, n))
        else:
            self._run_chunk(n)

    def _p_verify(self, drafts: np.ndarray, dlen: np.ndarray,
                  noise: list) -> None:
        """One verify round over the host's drafts."""
        self._draw_noise(noise, 1)
        self._block_d[:, 1:].copy_(_h2d(drafts, self.device))
        self._dlen_d.copy_(_h2d(dlen, self.device))
        if self._verify_graph is not None:
            self._verify_graph.replay(self._run_verify)
        else:
            self._run_verify()

    def _page_shape(self, pages: torch.Tensor) -> Tuple[int, ...]:
        """The assembled page of a pool leaf (L, NB, BL, KH[, D]): (L, BL,
        every KV head[, D])."""
        shape = [pages.shape[0]] + list(pages.shape[2:])
        shape[2] = self.cfg.n_kv_heads
        return tuple(shape)

    def _kv_sharded(self) -> bool:
        """This rank's pool holds its tp block of the KV heads."""
        return (self._layout is not None and self._layout.tp > 1
                and self._kv_tp is not None)

    def _p_kv_demote(self, blk: int) -> Optional[Dict[str, torch.Tensor]]:
        """A demotion's stage: on the driver page `blk` of every leaf,
        assembled (every KV head), in tensors of its own, queued on the
        compute stream before the page can be freed. On a mesh the ranks of
        the driver's dp replica gather their KV-head shards over tp (under
        the GQA fallback the driver's page is whole and nothing moves);
        the other replicas hold the same bits (every rank sums in rank
        order) and take no part. Followers keep nothing."""
        lay = self._layout
        if lay is None:
            return kvhost.stage_page(self._cache, blk)
        if lay.dp_rank:
            return None
        if self._kv_sharded():
            page = {n: lay.tp_gather(t[:, blk], 2)
                    for n, t in zip(kvhost.LEAF_NAMES, self._cache.leaves())}
        elif lay.is_driver:
            page = kvhost.stage_page(self._cache, blk)
        else:
            return None
        return page if lay.is_driver else None

    def _kv_write(self, cache, blk: int,
                  arrays: Dict[str, torch.Tensor]) -> None:
        """The tier's restore of host rows `arrays` into page `blk`: a
        device program every rank runs."""
        self._restore_src = arrays
        try:
            self._prog("kv_restore", blk)
        finally:
            self._restore_src = None

    def _p_kv_restore(self, blk: int) -> None:
        """A restore: the driver's host rows written into page `blk` in
        place (the pool tensors keep their storage, so a captured decode
        graph reads the page). On a mesh above one rank the driver sends
        each assembled leaf to every rank, and every rank of every dp
        replica writes its own KV-head slice."""
        src = self._restore_src
        if self._layout is None:
            kvhost.write_page(self._cache, blk, src)
            return
        lay = self._layout
        for name, pages in zip(kvhost.LEAF_NAMES, self._cache.leaves()):
            buf = (src[name].to(self.device, non_blocking=True)
                   if src is not None else
                   torch.empty(self._page_shape(pages), dtype=pages.dtype,
                               device=self.device))
            lay.world.broadcast(buf.reshape(-1).view(torch.uint8), 0)
            if self._kv_sharded():
                kh = pages.shape[3]
                buf = buf.narrow(2, lay.tp_rank * kh, kh)
            pages[:, blk].copy_(buf)

    def _p_swap_stage(self, meta: Optional[list]) -> None:
        """The new weights staged on every rank: on a mesh the driver's
        full tree broadcast leaf by leaf (`meta`: each leaf's path, shape
        and dtype), each rank keeping its block of a leaf before the next
        one comes, so a rank's card holds one full leaf beyond its blocks."""
        if self.mesh is None:
            self._staged = _map_leaves(lambda t: t.to(self.device),
                                       self._swap_src)
            return
        src = (dict(_flat_leaves(self._swap_src)) if self.mesh.is_driver
               else None)
        dims = dict(_flat_leaves(decode.serving_dims(self.params, self.cfg,
                                                     self.mesh)))
        blocks = []
        for path, shape, dtype in meta:
            t = (src[path].to(self.device).contiguous() if src is not None
                 else torch.empty(shape, dtype=getattr(torch, dtype),
                                  device=self.device))
            self.mesh.world.broadcast(t.reshape(-1).view(torch.uint8), 0)
            blocks.append((path, decode.tp_block(t, dims[path], self.mesh)))
            del t
        self._staged = _unflat_leaves(blocks)

    def _p_swap_commit(self) -> None:
        # The decode graphs read the engine's leaves' storage, so a graphed
        # engine copies the new values into it, in stream order: the chunk
        # in flight finishes on the old weights, every later chunk reads
        # the new ones, and both graphs stay as captured.
        if self._graph is not None:
            _copy_leaves(self.params, self._staged)
        else:
            self.params = self._staged
        self._staged = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _p_swap_abort(self) -> None:
        self._staged = None

    def _p_degrade(self) -> Params:
        """The full param tree, gathered over tp (a collective: the
        followers' last program)."""
        if self._layout is None:
            return self.params
        return decode.gather_params_for_serving(self.params, self.cfg,
                                                self._layout)

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
                       staged: bool = False) -> decode.KVCache:
        """Prefill tokens[off:stop] into `temp` in prefill_len chunks from
        `off` (a prefill_len multiple), the last one padded, under the
        engine's weights (`staged`: a swap's new ones)."""
        plen = self.prefill_len
        for start in range(off, stop, plen):
            chunk = np.zeros((1, plen), np.int64)
            n = min(plen, stop - start)
            chunk[0, :n] = tokens[start:start + n]
            temp = self._prog("prefill_step", temp, chunk, start, staged)
        return temp

    def _prefill_grid(self, tokens: List[int], grid_len: int,
                      staged: bool = False) -> decode.KVCache:
        """A dense prefix's first `grid_len` tokens (a prefill_len
        multiple) in a fresh batch-1 temp cache."""
        return self._prefill_range(self._prog("temp_new"), tokens, 0,
                                   grid_len, staged)

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

    def _stage_prefix_blocks(self, tokens: List[int]) -> List[int]:
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
                                         staged=True)
        except Exception:
            self._pool.free(blocks)
            raise
        return blocks

    def _prefill_span_to_blocks(self, tokens: List[int], span: int,
                                row: np.ndarray, matched: int,
                                staged: bool = False) -> None:
        """Prefill positions [matched, span) of `tokens` and commit them
        to the pool pages of table row `row`: the grid walk behind paged
        registration and the swap's staging. The padded last chunk's
        garbage rows fall outside the commit window."""
        temp = (self._prog("temp_from_pool", row, matched) if matched > 0
                else self._prog("temp_new"))
        off = (min(matched, span - 1) // self.prefill_len) * self.prefill_len
        temp = self._prefill_range(temp, tokens, off, span, staged)
        self._prog("commit_rows", temp, row, matched, span)

    def submit(self, prompt: List[int], max_new_tokens: int,
               prefix_id: Optional[int] = None,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None,
               stop: Optional[List[List[int]]] = None,
               committed: Optional[List[int]] = None,
               prng_key: Optional[Sequence[int]] = None,
               tenant: str = "", priority: str = "interactive",
               preempted: int = 0) -> int:
        """Enqueue a generation; returns its request id. `prng_key` (two
        uint32 words) is the request's sampling base key, so the same key
        at the same temperature gives the same tokens on any engine; the
        default is (seed, request id). `prefix_id` prepends a registered
        prefix to `prompt`. `committed` + `prng_key` resume another
        replica's generation (eject's state): the committed tokens are
        context and output at once, count against max_new_tokens (the
        request's TOTAL budget) and anchor the stop-tail state. `tenant`,
        `priority` ("interactive" or "batch") and `preempted` (the preempt
        hops a resumed generation already took) are the tenancy keys."""
        if self._draining:
            raise Draining("engine is draining (shutdown in progress); retry "
                           "against another replica")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if priority not in ("interactive", "batch"):
            raise ValueError(f"priority must be 'interactive' or 'batch', "
                             f"got {priority!r}")
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
        # Speculation keeps one spill row at the cache end out of every live
        # range: a verify round writes up to spec_k rows past the frontier,
        # clamped there (decode.spec_write_rows).
        limit = self.max_seq - max_new_tokens - (1 if self._spec else 0)
        if not 0 < len(prompt) <= limit:
            raise ValueError(
                f"prompt length {len(prompt)} (incl. prefix) not in [1, "
                f"{limit}] (max_seq {self.max_seq} - max_new_tokens "
                f"{max_new_tokens}"
                + (" - 1 speculation spill row)" if self._spec else ")"))
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
                           prefix_id=prefix_id, tenant=str(tenant or ""),
                           priority=priority,
                           preempted=max(0, int(preempted)))
        self._next_id += 1
        req.base_key = (prng_key if prng_key is not None else np.asarray(
            [self._seed & 0xFFFFFFFF, req.req_id & 0xFFFFFFFF], np.uint32))
        if self._phases_on:
            req.phase_events = []
            if committed:
                req.phase_events.append(
                    (req.submitted_at, "resume", len(committed)))
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
        sampling key and position) and its tenancy keys (tenant, priority,
        and the preempt hops, one more on `reason="preempt"`). Only
        committed tokens go in: the tokens of a chunk in flight (and a
        first token not landed yet) are dropped and regenerate on the
        resuming replica, since a sampled token is a function of (key,
        index). A second eject of the same request returns the cached
        state; a request that finished for real returns None."""
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
            # The resuming replica meters the same tenant, keeps the
            # class, and enforces preempt_cap on the carried hop count.
            "tenant": req.tenant,
            "priority": req.priority,
            "preempted": req.preempted + (1 if reason == "preempt" else 0),
        }
        req.resume_state = state
        req.finish_reason = "migrated"
        if req.phase_events is not None:
            req.phase_events.append((time.perf_counter(), "eject", reason))
        self._ejected_total += 1
        if reason == "handoff":
            self._handoffs_total += 1
        elif reason == "preempt":
            self._preempted_total += 1
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
        the staged chains are inserted and pinned, a prefill in flight
        across the swap finishes but never publishes its blocks, and the
        host KV tier is cleared (its blocks are old-weight KV).

        A graphed engine copies the new values into the leaves it was
        built with (its decode graphs read their storage), so a caller
        that kept that tree sees the new weights in it; an eager engine
        takes the placed tree. The pause includes the wait for the chunk
        in flight and, graphed, the copy.

        On a mesh `new_params` is the full tree, best left on the host: the
        driver checks views of its blocks against the engine's and
        broadcasts it leaf by leaf, and every rank keeps its blocks, so no
        card holds more than one full leaf."""
        t0 = time.perf_counter()
        _check_same_tree(self.params, new_params if self._layout is None
                         else decode.shard_params_for_serving(
                             new_params, self.cfg, self._layout, copy=False))
        self._swap_src = new_params
        try:
            self._prog("swap_stage", None if self.mesh is None else [
                (path, tuple(t.shape), str(t.dtype).split(".")[-1])
                for path, t in _flat_leaves(new_params)])
        finally:
            self._swap_src = None
        new_temps: Dict[int, decode.KVCache] = {}
        staged: Dict[int, List[int]] = {}
        try:
            for pid, pfx in self._prefixes.items():
                if self._paged and len(pfx.tokens) >= self.kv_block_len:
                    staged[pid] = self._stage_prefix_blocks(pfx.tokens)
                elif not self._paged and pfx.grid_len > 0:
                    new_temps[pid] = self._prefill_grid(
                        pfx.tokens, pfx.grid_len, staged=True)
        except Exception:
            for blocks in staged.values():
                self._pool.free(blocks)
            self._prog("swap_abort")
            raise
        # Commit: nothing below can raise (the trees matched).
        self._prog("swap_commit")
        for pid, temp in new_temps.items():
            self._prefixes[pid].temp = temp
        if self._paged:
            for pfx in self._prefixes.values():
                if pfx.chain:
                    self._radix.unpin(pfx.chain)
                    pfx.chain = None
            self._radix.detach_all()
            if self._host_tier is not None:
                # The tier's blocks are the old weights' KV.
                self._host_tier.clear()
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
        """True while there is any work: queued, prefilling or decoding
        requests, or a chunk in flight."""
        return self.pending > 0 or self._inflight is not None

    def step(self) -> int:
        """Admit (bounded prefill work), dispatch the next chunk over the
        live slots behind the chunk in flight, fetch the chunk in flight
        (the one device sync of a round) and commit its tokens while the
        new one runs on the device. Returns the tokens committed (0 while
        the pipeline fills or when idle). The dispatch goes first so that
        the device never waits on the host's launch of the next chunk.
        overlap_commit=False fetches and commits before the dispatch
        instead (bisection). The dispatch reads only the device mirrors,
        and slot frees land on the same step in either ordering, so both
        give the same tokens. overlap=False collects the new chunk in this
        step as well, after the dispatch (the JAX engine's strict per-chunk
        sync), so no chunk is in flight between steps.

        On the prefill role the first tokens land right after the
        admission (a sync: TTFT is that replica's whole job), so the
        handoff frees every slot before a dispatch would run.

        A fault fails only the requests it touched (finish_reason "error",
        counted by cause) and the engine keeps serving: a prefill fault
        the request being prefilled; a dispatch or collect fault, or a
        watchdog trip, every request of the batch; a commit fault the one
        request it was committing."""
        try:
            self._admit()
        except Exception as e:                 # noqa: BLE001 — contained
            self._contain_prefill_failure(e)
        if self.handoff_first_token:
            try:
                self._resolve_first_tokens()
            except Exception as e:             # noqa: BLE001 — contained
                self._contain_collect_failure(e)
        if self._spec:
            return self._step_spec()
        emitted = 0
        inflight, self._inflight = self._inflight, None
        if inflight is not None and not self.overlap_commit:
            try:
                emitted = self._commit_phase(self._fetch(inflight),
                                             overlapped=False)
            except Exception as e:             # noqa: BLE001 — contained
                self._contain_collect_failure(e)
                return emitted
            inflight = None
        nxt = None
        if any(r is not None for r in self._slot_req):
            try:
                nxt = self._dispatch_chunk()
            except faultlab.InjectedDeviceLoss as e:
                # The mesh shrank under the batch: evacuation, never
                # per-request failure.
                self._evacuate_device_loss(e)
            except Exception as e:             # noqa: BLE001 — contained
                self._contain_dispatch_failure(e)
        if inflight is not None:
            # A fault here (a chunk or a first token that never lands)
            # fails the batch; the chunk just dispatched descends from the
            # same device state and goes with it.
            try:
                emitted = self._commit_phase(self._fetch(inflight),
                                             overlapped=nxt is not None)
            except Exception as e:             # noqa: BLE001 — contained
                self._contain_collect_failure(e)
                return 0
        if nxt is not None and not self.overlap:
            try:
                emitted += self._commit_phase(self._fetch(nxt),
                                              overlapped=False)
            except Exception as e:             # noqa: BLE001 — contained
                self._contain_collect_failure(e)
            nxt = None
        self._inflight = nxt
        return emitted

    def _step_spec(self) -> int:
        """step() past admission on a speculative engine, in the JAX
        engine's order: fetch the round in flight, dispatch the next one
        (its drafts first), commit the fetched round behind it, then
        collect the new round at once unless it is a bypass chunk while no
        live slot could draft (and overlap is on). A round is in flight
        across steps only as such a chunk, so a slot that drafts has every
        token of its own committed (its first token lands before its
        drafts)."""
        emitted, fetched = 0, None
        inflight, self._inflight = self._inflight, None
        if inflight is not None:
            try:
                fetched = self._fetch(inflight)
            except Exception as e:             # noqa: BLE001 — contained
                self._contain_collect_failure(e)
                return 0
            if not self.overlap_commit:
                try:
                    emitted = self._commit_phase(fetched, overlapped=False)
                except Exception as e:         # noqa: BLE001 — contained
                    self._contain_collect_failure(e)
                    return emitted
                fetched = None
        nxt = None
        if any(r is not None for r in self._slot_req):
            try:
                nxt = self._dispatch_round()
            except faultlab.InjectedDeviceLoss as e:
                self._evacuate_device_loss(e)
            except WatchdogTimeout as e:
                # A first token that never landed, met before drafting.
                self._contain_collect_failure(e)
            except Exception as e:             # noqa: BLE001 — contained
                self._contain_dispatch_failure(e)
        if fetched is not None:
            try:
                emitted = self._commit_phase(fetched,
                                             overlapped=nxt is not None)
            except Exception as e:             # noqa: BLE001 — contained
                # The round just dispatched descends from the same state;
                # its requests were failed with the batch.
                self._contain_collect_failure(e)
                nxt = None
        if nxt is not None:
            if (self.overlap and nxt.dlen is None
                    and not self._spec_can_draft()):
                self._inflight = nxt
            else:
                try:
                    emitted += self._commit_phase(self._fetch(nxt),
                                                  overlapped=False)
                except Exception as e:         # noqa: BLE001 — contained
                    self._contain_collect_failure(e)
        return emitted

    def run(self, max_chunks: int = 1_000_000) -> None:
        for _ in range(max_chunks):
            if not self.active:
                return
            self.step()

    # -- internals --

    def _contain_prefill_failure(self, exc: Exception) -> None:
        """A prefill fault touches the request being prefilled: fail it
        (its lease goes back) and keep admitting the others."""
        self._errors_total["prefill"] += 1
        st, self._prefill = self._prefill, None
        if st is not None:
            self._fail_request(st.req, f"prefill failed: {exc!r}")

    def _contain_dispatch_failure(self, exc: Exception,
                                  cause: str = "dispatch") -> None:
        """A chunk is one batched program over every live slot: fail them
        all and the first tokens still on their way. No device state is
        rebuilt: the port writes the cache in place, and a faulted chunk
        can have written only its slots' private decode rows (and the
        trash page), never a shared tree page, since a slot's position is
        past every block its prompt published; the mirrors of the parked
        slots are rewritten by their next admission."""
        self._errors_total[cause] += 1
        msg = f"{cause} failed: {exc!r}"
        for req in list(self._slot_req):
            if req is not None:
                self._fail_request(req, msg)
        for pending in self._pending_first:
            self._fail_request(pending.req, msg)
        self._pending_first = []

    def _evacuate_device_loss(self, exc: Exception) -> None:
        """The degraded-mesh evacuation (the JAX engine's): a device died
        under a meshed dispatch, so no request on the mesh can make
        progress, but every one is resumable. Every live request (queued,
        prefilling, decoding) leaves as a reason="evacuate" resume frame
        (the frames a drain emits, which the fleet splices onto healthy
        replicas), then the engine serves on one device at reduced
        capacity (`mesh_degraded`)."""
        self._errors_total["device_loss"] += 1
        self._inflight = None            # descends from the lost device
        self._pending_first = []
        evacuated = 0
        for req in list(self._reqs.values()):
            if not req.done and self.eject(req.req_id,
                                           reason="evacuate") is not None:
                evacuated += 1
        self._evacuated_total += evacuated
        self._degrade_to_single_device()
        self._mesh_degraded = True

    def _degrade_to_single_device(self) -> None:
        """Serve on the driver's device alone: the full weights gathered
        over the gang (in this reproduction the driver still reaches every
        shard, where a deployment restores a checkpoint), the followers
        released by that last program, then the single-device programs
        with the paged decode kernel off (the JAX engine's degraded
        engine) and a fresh device state."""
        self.params = self._prog("degrade")
        self.mesh = None
        self._layout = None
        self._paged_kernel = False
        self._rows = (0, self.num_slots)
        self._rebuild_device_state()

    def _rebuild_device_state(self) -> None:
        """Fresh device state at this engine's (now single-device) shapes:
        the cache or pool; on the paged engine the block pool, the radix
        tree (its KV died with the old pool) and the tables, the prefixes
        pinned again best-effort (one that fails stays cold, counted under
        prefix_repin); a dense prefix re-prefilled into a temp cache of
        the new shape; the slot mirrors zeroed; the decode graphs (a mesh
        of one rank's) dropped, since they read the old cache and table and
        ran the paged kernel, to be captured again on their next replay.
        Callers have ejected every request first."""
        cfg, dev, n = self.cfg, self.device, self.num_slots
        for graph in (self._graph, self._quantum_graph, self._verify_graph):
            if graph is not None:
                graph.reset()
        if self._paged:
            self._cache = decode.init_paged_pool(cfg, self.kv_num_blocks,
                                                 self.kv_block_len, dev)
            self._kv_evictions_prior += self._radix.evictions_total
            self._pool = paged_kv.BlockPool(self.kv_num_blocks,
                                            self.kv_block_len)
            self._radix = paged_kv.RadixCache(self._pool)
            self._table_d = torch.zeros((n, self._max_blocks),
                                        dtype=torch.int32, device=dev)
            self._leases = {}
            for pfx in self._prefixes.values():
                try:
                    pfx.chain = self._register_prefix_blocks(pfx.tokens)
                    pfx.grid_len = len(pfx.chain) * self.kv_block_len
                except Exception:      # noqa: BLE001 — degrade, don't block
                    self._errors_total["prefix_repin"] += 1
                    pfx.chain, pfx.grid_len = [], 0
        else:
            self._cache = decode.init_cache(cfg, n, self.max_seq, dev)
            for pfx in self._prefixes.values():
                if pfx.grid_len > 0:
                    pfx.temp = self._prefill_grid(pfx.tokens, pfx.grid_len)
        with torch.no_grad():
            self._cur_d.zero_()
            self._pos_d.zero_()
            self._temps_d.fill_(self.temperature)
            self._topps_d.fill_(self.top_p)
        self._scnt = np.zeros(n, np.int64)

    def _contain_collect_failure(self, exc: Exception) -> None:
        """A fetch fault or a watchdog trip: the batch in flight, and every
        live request, descends from the chunk that did not land; fail them
        as a dispatch fault does, under their own cause."""
        if isinstance(exc, WatchdogTimeout):
            self._watchdog_trips += 1
            self._contain_dispatch_failure(exc, cause="watchdog")
        else:
            self._contain_dispatch_failure(exc, cause="collect")

    def _contain_commit_failure(self, req: ServeRequest,
                                exc: Exception) -> None:
        """A host-side fault while committing one request's tokens touches
        that request alone (commit reads fetched host arrays and changes
        per-request lists): fail it; its co-tenants and the chunk already
        dispatched go on."""
        self._errors_total["commit"] += 1
        self._fail_request(req, f"commit failed: {exc!r}")

    def _fail_request(self, req: ServeRequest, msg: str) -> None:
        """Finish `req` as errored with `msg` and free its slot (its lease
        goes back); a finished request is left as it is."""
        if req.done:
            return
        req.finish_reason = "error"
        req.error = msg
        self._finish(req)
        for b in range(self.num_slots):
            if self._slot_req[b] is req:
                self._slot_req[b] = None
                self._park_slot(b)

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

    def _run_chunk(self, steps: int) -> None:
        """One decode chunk of `steps` steps over every slot (parked ones
        included), from the device mirrors into them: the packed tokens
        into the first `steps` rows of _out_d, the last tokens into
        _cur_d, the advanced positions into _pos_d. The program a CUDA
        graph captures (one a chunk length), and the eager path. On a
        dense engine on a mesh the rank decodes its dp block of the slots
        and the packed tokens are gathered over dp in slot order."""
        lo, hi = self._rows
        sampling = _Sampling(self._temps_d[lo:hi], self._topps_d[lo:hi],
                             self._noise_d[:, lo:hi], self.top_k,
                             self.enable_top_p)
        with torch.no_grad():
            if self._paged:
                packed, cur, pos = _decode_chunk_paged(
                    self.params, self._cache, self._table_d, self._cur_d,
                    self._pos_d, self.cfg, steps, self._freqs,
                    sampling, self.kv_block_len, mesh=self._layout,
                    paged_kernel=self._paged_kernel)
            else:
                packed, cur, pos = _decode_chunk(
                    self.params, self._cache, self._cur_d[lo:hi],
                    self._pos_d[lo:hi], self.cfg, steps, self._freqs,
                    sampling, mesh=self._layout)
            if hi - lo < self.num_slots:
                packed = self._layout.dp_gather(packed, 1)
            self._out_d[:steps].copy_(packed)
            self._cur_d[lo:hi].copy_(cur)
            self._pos_d[lo:hi].copy_(pos)

    def _noise_spec(self, steps: int) -> list:
        """(slot, key words, first sample index) of every live sampled
        slot: the inputs of the next dispatch's noise draw, `steps` indices
        from there (step n of slot b samples at index _scnt[b] + n);
        greedy and parked slots draw nothing."""
        return [(b, int(self._skeys[b][0]), int(self._skeys[b][1]),
                 int(self._scnt[b]))
                for b, req in enumerate(self._slot_req)
                if req is not None and self._temps[b] > 0.0]

    def _draw_noise(self, spec: list, steps: int) -> None:
        """The Gumbel noise of `spec`'s slots (`_noise_spec`) for `steps`
        steps, drawn for the slots this rank decodes; with no sampled slot
        nothing is drawn at all."""
        for b, k0, k1, first in spec:
            if self._local_slot(b) is None:
                continue
            for n in range(steps):
                _draw_gumbel(self._noise_d[n, b], (k0, k1), first + n)

    def _dispatch_chunk(self) -> _Inflight:
        """Dispatch one decode chunk (its graph's replay on the card) and
        start the copy of its packed tokens, exactly its rows, to the
        host; advance the host sample counters as the chunk advances
        them. With chunked prefill and a backlog (a prompt mid-slice or a
        request waiting, read after the step's admission) the chunk is
        the short quantum."""
        faultlab.site("engine.dispatch")
        if self.mesh is not None:
            faultlab.site("engine.device_loss")
        n, t_start = self.decode_chunk, time.perf_counter()
        if self._chunked_prefill and (self._prefill is not None
                                      or self._queue):
            n = self._decode_quantum
        self._prog("chunk", n, self._noise_spec(n))
        self._out_h.reverse()
        copy = _HostCopy.start(self._out_d[:n], self._out_h[0][:n])
        snapshot = [(b, r) for b, r in enumerate(self._slot_req)
                    if r is not None]
        self._scnt = self._scnt + n
        self._decode_steps_total += n
        return _Inflight(copy, snapshot, t_start, time.perf_counter(), n)

    # -- speculative decoding --

    def _slot_could_draft(self, b: int) -> bool:
        """A greedy slot with draft budget left in its controller (sampled
        slots never draft: acceptance by equality is a greedy argument)."""
        return self._temps[b] <= 0.0 and self._spec_k_cur[b] > 0

    def _spec_can_draft(self) -> bool:
        return any(r is not None and self._slot_could_draft(b)
                   for b, r in enumerate(self._slot_req))

    def _dispatch_round(self) -> Optional[_Inflight]:
        """A speculative engine's dispatch: a verify round when some slot
        drafted, else a plain decode chunk (the bypass: committing one
        token a slot through the (k+1)-wide program would waste it), or
        None when resolving the first tokens finished every live slot."""
        round_ = self._dispatch_spec()
        if round_ is not None:
            return round_
        if not any(r is not None for r in self._slot_req):
            return None
        return self._dispatch_chunk()

    def _dispatch_spec(self) -> Optional[_Inflight]:
        """Draft and dispatch one verify round, or None to bypass (no slot
        drafted). The first tokens pending land first: a slot's drafter
        needs its whole history, and a request of one new token finishes
        before it can ride the round. Each greedy slot drafts at most its
        controller's length and never past its budget; one decode step is
        counted a round. The round is collected in the step that
        dispatched it."""
        self._resolve_first_tokens()
        live = [(b, r) for b, r in enumerate(self._slot_req)
                if r is not None]
        if not live:
            return None
        faultlab.site("engine.dispatch")
        if self.mesh is not None:
            faultlab.site("engine.device_loss")
        k, n = self.spec_k, self.num_slots
        drafts = np.zeros((n, k), np.int64)
        dlen = np.zeros(n, np.int64)
        for b, req in live:
            if not self._slot_could_draft(b):
                continue
            # A round commits at most draft_len + 1 tokens.
            budget = min(self._spec_k_cur[b],
                         req.max_new_tokens - len(req.tokens) - 1)
            if budget <= 0:
                continue
            prop = list(self._drafter(req.prompt + req.tokens,
                                      budget))[:budget]
            if prop:
                drafts[b, :len(prop)] = prop
                dlen[b] = len(prop)
        if not dlen.any():
            self._spec_bypass_total += 1
            self._spec_bypass_streak += 1
            if (self._spec_adaptive
                    and self._spec_bypass_streak >= self._spec_reprobe):
                # Re-probe: a workload that shrank every slot to k=0 may
                # have turned repetitive since.
                self._spec_bypass_streak = 0
                for b, _ in live:
                    self._spec_k_cur[b] = max(1, self._spec_k_cur[b])
            return None
        self._spec_bypass_streak = 0
        t_start = time.perf_counter()
        # A sampled slot samples its one token from row 0, at its index.
        self._prog("verify", drafts, dlen, self._noise_spec(1))
        copy = _HostCopy.start(self._spec_out_d, self._spec_out_h)
        self._spec_rounds_total += 1
        self._decode_steps_total += 1
        self._spec_proposed_total += int(dlen.sum())
        for b, _ in live:
            self._spec_k_hist[int(dlen[b])] += 1
        return _Inflight(copy, live, t_start, time.perf_counter(), 1, dlen)

    def _run_verify(self) -> None:
        """One verify round over every slot (parked ones included: they
        draft nothing and their writes stay in their own rows or the trash
        page), from the device mirrors and the static block into them: the
        packed round into _spec_out_d, the next tokens into _cur_d, the
        advanced positions into _pos_d. The program the verify graph
        captures, and the eager path. A dense engine on a mesh verifies its
        dp block of the slots; the rounds are gathered over dp."""
        lo, hi = self._rows
        sampling = _Sampling(self._temps_d[lo:hi], self._topps_d[lo:hi],
                             self._noise_d[:1, lo:hi], self.top_k,
                             self.enable_top_p)
        with torch.no_grad():
            self._block_d[:, 0].copy_(self._cur_d)
            packed, cur, pos = _spec_verify(
                self.params, self._cache, self._block_d[lo:hi],
                self._dlen_d[lo:hi], self._pos_d[lo:hi], self.cfg,
                self._freqs, sampling, self._table_d if self._paged else None,
                self.kv_block_len, mesh=self._layout)
            if hi - lo < self.num_slots:
                packed = self._layout.dp_gather(packed, 0)
            self._spec_out_d.copy_(packed)
            self._cur_d[lo:hi].copy_(cur)
            self._pos_d[lo:hi].copy_(pos)

    def _commit_spec(self, packed_h: np.ndarray, inflight: _Inflight,
                     overlapped: bool) -> int:
        """Commit a fetched verify round: each live slot's emitted tokens
        (decided on the device), one at a time with the budget, EOS and
        stop checks, each at the round's wall over their count; the sample
        counters advance by the emitted count for every slot, parked ones
        included, as their device positions did. Each drafting slot feeds
        its controller: the acceptance EMA shrinks its draft length below
        0.35 and grows it above 0.65."""
        t = self.spec_k + 1
        out_h = packed_h[:, :t]
        lps_h = np.ascontiguousarray(packed_h[:, t:2 * t]).view(np.float32)
        acc_h = packed_h[:, 2 * t]
        wall = self._collect_wall(inflight.t_start)
        self._scnt = self._scnt + acc_h
        dlen, emitted = inflight.dlen, 0
        for b, req in inflight.snapshot:
            if req.done:
                continue
            n, d = int(acc_h[b]), int(dlen[b])
            tc0 = (time.perf_counter()
                   if req.phase_events is not None else 0.0)
            try:
                faultlab.site("engine.commit")
                committed = self._commit_tokens(req, b, out_h[b, :n],
                                                lps_h[b, :n],
                                                wall / max(1, n))
            except Exception as e:             # noqa: BLE001 — contained
                self._contain_commit_failure(req, e)
                committed = 0
            emitted += committed
            if req.phase_events is not None and committed:
                self._phase_events_at_commit(
                    req, committed, time.perf_counter() - tc0, overlapped,
                    spec=(d, min(n - 1, d)))
            if d > 0:
                accepted = min(n - 1, d)
                self._spec_accepted_total += accepted
                if self._spec_adaptive:
                    frac = accepted / d
                    self._spec_ema[b] = 0.5 * self._spec_ema[b] + 0.5 * frac
                    self._spec_global_ema = (0.95 * self._spec_global_ema
                                             + 0.05 * frac)
                    if self._spec_ema[b] < 0.35:
                        self._spec_k_cur[b] = max(0, self._spec_k_cur[b] - 1)
                    elif self._spec_ema[b] > 0.65:
                        self._spec_k_cur[b] = min(self.spec_k,
                                                  self._spec_k_cur[b] + 1)
        self._spec_tokens_total += emitted
        return emitted

    def _fetch(self, inflight: _Inflight) -> Tuple[np.ndarray, _Inflight]:
        """Wait for a dispatched chunk's packed tokens (THE sync of a
        round). With the watchdog armed, poll the copy up to the deadline,
        which runs from this chunk's own dispatch, and raise
        WatchdogTimeout past it instead of waiting forever."""
        t0 = time.perf_counter()
        faultlab.site("engine.collect")
        packed_h = self._landed(inflight, inflight.t_dispatch,
                                "no decode chunk completed")
        self._fetch_sync_s_total += time.perf_counter() - t0
        return packed_h, inflight

    def _landed(self, pending, since: float, what: str) -> np.ndarray:
        """The values of `pending`'s copy to the host (a chunk in flight or
        a first token). With the watchdog armed, poll it and raise
        WatchdogTimeout once watchdog_timeout seconds have passed since
        `since`, instead of waiting on a device that may never answer."""
        if self.watchdog_timeout is not None:
            deadline = since + self.watchdog_timeout
            while not _chunk_ready(pending):
                if time.perf_counter() > deadline:
                    raise WatchdogTimeout(
                        f"{what} within {self.watchdog_timeout}s")
                time.sleep(1e-4)
        return pending.copy.numpy()

    def _commit_phase(self, fetched: Tuple[np.ndarray, _Inflight],
                      overlapped: bool) -> int:
        """All host-side commit work of a fetched chunk: the first tokens
        pending, then each live request's tokens. `overlapped`: it runs
        behind the next chunk's device execution."""
        t0 = time.perf_counter()
        self._resolve_first_tokens()
        if fetched[1].dlen is not None:
            emitted = self._commit_spec(*fetched, overlapped)
        else:
            emitted = self._commit_chunk(*fetched, overlapped)
        dur = time.perf_counter() - t0
        self._commit_rounds_total += 1
        self._commit_s_total += dur
        if overlapped:
            self._commit_overlapped_s_total += dur
        return emitted

    def _resolve_first_tokens(self) -> None:
        """Land the first tokens sampled at admission (their copies are in
        flight since) before any decode token of theirs, so an EOS or a
        budget of one finishes the request before a decode token is
        appended. An entry is popped only once its token landed: a fault
        leaves the rest for the containment to fail."""
        now = time.perf_counter()
        while self._pending_first:
            pending = self._pending_first[0]
            req, b = pending.req, pending.slot
            if req.done:
                self._pending_first.pop(0)
                continue
            toks_h, lps_h = _unpack(self._landed(
                pending, time.perf_counter(), "no first token landed"))
            self._pending_first.pop(0)
            req.tokens.append(int(toks_h[0, 0]))
            req.logprobs.append(float(lps_h[0, 0]))
            req.token_lat_s.append(now - req.submitted_at)         # TTFT
            req.first_token_at = now
            if self._terminal(req):
                self._finish(req)
                if self._slot_req[b] is req:
                    self._slot_req[b] = None
                    self._park_slot(b)
            elif self.handoff_first_token:
                # The prefill role's share is done: the decode pool
                # continues the stream from the resume state.
                self.eject(req.req_id, reason="handoff")

    def _collect_wall(self, t_start: float) -> float:
        """A chunk's wall: the time since the previous collect while the
        pipeline is busy (dispatch -> collect spans overlapped work), else
        since this chunk's dispatch began."""
        now = time.perf_counter()
        base = t_start
        if self._last_collect_t is not None and \
                self._last_collect_t > t_start:
            base = self._last_collect_t
        self._last_collect_t = now
        return now - base

    def _commit_chunk(self, packed_h: np.ndarray, inflight: _Inflight,
                      overlapped: bool) -> int:
        """Commit a fetched chunk slot by slot; each token's latency is the
        chunk's wall over its length. A request that finished, was
        cancelled or ejected after the dispatch drops its in-flight
        tokens. With phase events on, a request's commit records its
        decode_step and commit events (`overlapped`: this commit runs
        behind the next chunk's device work)."""
        toks_h, lps_h = _unpack(packed_h)
        per_tok = self._collect_wall(inflight.t_start) / inflight.n
        emitted = 0
        for b, req in inflight.snapshot:
            if req.done:
                continue
            tc0 = (time.perf_counter()
                   if req.phase_events is not None else 0.0)
            try:
                faultlab.site("engine.commit")
                n = self._commit_tokens(req, b, toks_h[:, b], lps_h[:, b],
                                        per_tok)
            except Exception as e:             # noqa: BLE001 — contained
                self._contain_commit_failure(req, e)
                continue
            emitted += n
            if req.phase_events is not None and n:
                self._phase_events_at_commit(
                    req, n, time.perf_counter() - tc0, overlapped)
        return emitted

    def _phase_events_at_commit(self, req: ServeRequest, n: int,
                                dur_s: float, overlapped: bool,
                                spec: Optional[Tuple[int, int]] = None
                                ) -> None:
        """A request's decode_step and commit events for a commit of `n`
        tokens, when that commit crossed a multiple of phase_event_every
        in its token count (or was its first): (count) and (n, host
        seconds, overlapped 0/1), the JAX engine's two events of a plain
        chunk. A verify round's commit gives `spec` = (proposed, accepted)
        and a spec_round event (count, proposed, accepted) in place of
        decode_step. Callers guard on phase_events."""
        every = self._phase_event_every
        total = len(req.tokens)
        if (total - n) // every == total // every and total != n:
            return
        now = time.perf_counter()
        if spec is None:
            req.phase_events.append((now, "decode_step", total))
        else:
            req.phase_events.append((now, "spec_round", (total,) + spec))
        req.phase_events.append(
            (now, "commit", (n, dur_s, 1 if overlapped else 0)))

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

    def _promote_interactive_head(self) -> None:
        """Priority admission: the next request admitted is the oldest
        waiting interactive one; batch requests keep FIFO order among
        themselves and advance only when no interactive request waits. A
        rotation, not a second queue, so the promoted request is the head
        the paged deferral parks."""
        if not self._queue or self._queue[0].priority == "interactive":
            return
        for i, r in enumerate(self._queue):
            if not r.cancelled and r.priority == "interactive":
                del self._queue[i]
                self._queue.appendleft(r)
                return

    def _preempt_for(self, req: ServeRequest) -> bool:
        """Free capacity for an interactive queue head by ejecting one
        decoding batch request as a reason="preempt" resume state. The
        victim is the most recently submitted batch request still under
        preempt_cap, so the oldest batch work (closest to done) keeps its
        slot. True when one was ejected: its slot and pages are free at
        once (see the module note on a chunk in flight)."""
        if req.priority != "interactive" or self.preempt_cap <= 0:
            return False
        victims = [r for r in self._slot_req
                   if r is not None and r.priority == "batch"
                   and r.preempted < self.preempt_cap]
        if not victims:
            return False
        victim = max(victims, key=lambda r: (r.submitted_at, r.req_id))
        self.eject(victim.req_id, reason="preempt")
        return True

    def _start_prefill(self) -> bool:
        while self._queue and self._queue[0].cancelled:
            self._queue.popleft()
        self._promote_interactive_head()
        if not self._queue:
            return False
        b = self._free_slot()
        if b is None and self._preempt_for(self._queue[0]):
            # Slot pressure with an interactive head: a batch victim
            # leaves as a resume state instead of the interactive request
            # queueing behind the batch backlog.
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
            self._prefill.temp = self._prog("temp_clone", pfx.temp)
            return True
        self._prefill.temp = self._prog("temp_new")
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

    def _kv_demote(self, node) -> None:
        """RadixCache.on_evict hook: copy the eviction victim's KV to the
        host tier before its page is freed. Never raises: a copy fault
        (kvhost.dma) degrades to the plain discard inside the tier, and any
        other failure here must not break eviction (the tier is purely
        additive). The trash page is never demoted."""
        tier = self._host_tier
        if tier is None or node.block == paged_kv.TRASH_BLOCK:
            return
        try:
            parent = node.parent
            tier.offload(self._cache, node.block, node.digest,
                         parent.digest if parent is not None else "",
                         node.key)
        except Exception:                      # noqa: BLE001 — contained
            tier.dma_failures_total += 1

    def kvhost_export(self, digests: List[str]) -> List[dict]:
        """Serialize the host-tier blocks of `digests` for a peer replica
        (/v1/kvhost); digests the tier does not hold are skipped (the peer
        re-prefills that tail)."""
        tier = self._host_tier
        if tier is None:
            return []
        out = []
        for d in digests:
            payload = tier.export_entry(d)
            if payload is not None:
                out.append(payload)
        return out

    def kvhost_import(self, payloads: List[dict]) -> int:
        """Install peer-shipped blocks into the host tier (host side only:
        the next matching admission prefetches them through the same
        checksummed restore as local demotions). Returns how many were
        accepted; payloads of another signature or corrupt ones are
        rejected inside the tier."""
        tier = self._host_tier
        if tier is None:
            return 0
        return sum(1 for p in payloads if tier.import_entry(p))

    def _kv_prefetch(self, ctx: List[int], chain: list, plen: int,
                     req: ServeRequest) -> list:
        """Extend a radix match with blocks restored from the host tier
        before the prefill reservation is sized: each restored block is a
        prefill chunk the request never re-pays. The chain (matched and
        restored so far) rides an acquire guard while pages are allocated,
        as admission's own eviction guard: `_kv_alloc` may evict (and
        demote), never the pages this admission is about to use. Any tier
        miss (absent, faulted, corrupt, another signature) ends the walk;
        the rest re-prefills."""
        tier = self._host_tier
        bl = self.kv_block_len
        self._radix.acquire(chain)
        try:
            parent = chain[-1] if chain else self._radix.root
            # Keep >= 1 prompt token out (the match trim's rule: the first
            # token is sampled from the last prompt row's logits).
            while (len(chain) + 1) * bl < plen:
                off = len(chain) * bl
                key = tuple(int(t) for t in ctx[off:off + bl])
                entry = tier.fetch(paged_kv.chain_digest(parent.digest, key))
                if entry is None:
                    break
                if req.prefetch_started_at is None:
                    req.prefetch_started_at = time.perf_counter()
                blks = self._kv_alloc(1)
                if blks is None:
                    break
                # The restore is queued on the compute stream before the
                # prefill that reads the page (module kvhost notes).
                tier.restore(self._cache, blks[0], entry)
                node = self._radix.insert(parent, key, blks[0])
                if node.block != blks[0]:
                    # An identical chain raced in (a concurrent
                    # registration): the tree's node wins, our page goes
                    # back.
                    self._pool.free(blks)
                self._radix.acquire([node])
                chain.append(node)
                parent = node
        finally:
            # Hand the guard back: the caller acquires the whole chain
            # through the normal admission flow.
            self._radix.release(chain)
        if (req.prefetch_started_at is not None
                and req.prefetch_done_at is None):
            req.prefetch_done_at = time.perf_counter()
        return chain

    def _release_lease(self, req: ServeRequest) -> None:
        """Give a finished, cancelled or failed request's pages back: radix
        references drop, private pages return to the free list. Reusing
        them at once is safe even with a chunk in flight (see the module
        note)."""
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
            self._prog("park", b)

    def _start_prefill_paged(self, b: int) -> bool:
        """Paged admission: radix-match the prompt's full blocks, reserve
        the rest of the prompt + max_new span from the pool, and start the
        suffix prefill at the match's prefill-grid frontier. When the pool
        cannot cover the reservation even after eviction the request stays
        at the queue head (deferred, strict FIFO); one that can never fit
        fails instead of blocking the queue forever. A deferred
        interactive head preempts one batch request, whose pages free at
        once, so it is admitted on the next step."""
        req = self._queue[0]
        bl = self.kv_block_len
        # A fault here touches no request: the head stays queued and the
        # next step admits it again (the JAX engine's containment).
        faultlab.site("engine.paged_admit")
        # The context: prompt + a resumed request's committed tokens (the
        # radix match makes a migrated-in request warm).
        ctx = req.prompt + req.tokens[:req.emit_from]
        plen = len(ctx)
        tier = self._host_tier
        if (tier is not None and self.kv_offload_watermark > 0.0
                and self._pool.free_count
                < self.kv_offload_watermark * self._pool.capacity):
            # Demote-ahead: under the free watermark, push a couple of cold
            # blocks through eviction (which demotes them) before this
            # admission needs the headroom.
            self._radix.evict(min(2, self._radix.evictable_blocks()))
        chain = self._radix.match(ctx)
        while chain and len(chain) * bl >= plen:
            # Keep >= 1 prompt token out of the match: the first token is
            # sampled from the last prompt row's logits.
            chain = chain[:-1]
        if tier is not None and tier.blocks_used:
            # Restore the match's offloaded continuation before sizing the
            # prefill.
            chain = self._kv_prefetch(ctx, chain, plen, req)
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
            self._preempt_for(req)
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
        self._prefill.temp = (self._prog("temp_from_pool", row, matched)
                              if matched > 0 else self._prog("temp_new"))
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
        faultlab.site("engine.prefill")
        ctx = st.ctx
        remaining = len(ctx) - st.offset
        if remaining > self.prefill_len:          # non-final chunk
            st.temp = self._prog(
                "prefill_step", st.temp, np.asarray(
                    [ctx[st.offset:st.offset + self.prefill_len]], np.int64),
                st.offset, False)
            st.offset += self.prefill_len
            self._prefill_chunks_total += 1
            if st.req.phase_events is not None:
                st.req.phase_events.append(
                    (time.perf_counter(), "prefill_chunk", st.offset))
            return
        # Final chunk: commit into the slot and sample token #1.
        padded = np.zeros((1, self.prefill_len), np.int64)
        padded[0, :remaining] = ctx[st.offset:]
        req, b = st.req, st.slot
        r_temp = (req.temperature if req.temperature is not None
                  else self.temperature)
        r_topp = req.top_p if req.top_p is not None else self.top_p
        # The first token samples at index emit_from (0 for a fresh
        # request), where the uninterrupted stream sampled it; the slot's
        # device entries are written in place behind any chunk already in
        # flight.
        lease = self._leases[req.req_id] if self._paged else None
        tok, lp = self._prog(
            "prefill_final", st.temp, padded, b, len(ctx), remaining,
            st.offset, r_temp, r_topp,
            [int(w) for w in np.asarray(req.base_key)], req.emit_from,
            lease.row if lease is not None else None, st.matched)
        if lease is not None and st.publish:
            # Publish the prompt's full blocks for automatic reuse, unless
            # a weight swap landed mid-prefill.
            self._insert_prompt_blocks(ctx, lease)
        self._prefill_chunks_total += 1
        if req.phase_events is not None:
            req.phase_events.append(
                (time.perf_counter(), "prefill_chunk", len(ctx)))
        self._prefill = None
        # The first token's copy lands for the next commit.
        self._pending_first.append(_PendingFirst(
            req, b, _HostCopy.start(_pack(tok.view(1, 1), lp.view(1, 1)))))
        self._temps[b] = r_temp
        self._skeys[b] = req.base_key
        self._scnt[b] = req.emit_from + 1   # the prefill's index is used
        self._slot_req[b] = req
        # A fresh speculation controller: full k while the engine-wide
        # acceptance says drafting pays, one probe once the workload has
        # proven adversarial.
        self._spec_k_cur[b] = (self.spec_k
                               if self._spec_global_ema >= 0.25 else 1)
        self._spec_ema[b] = 1.0

    def _first_sampling(self, temp: float, top_p: float, key: Sequence[int],
                        index: int) -> _Sampling:
        """Batch-1 sampling inputs of a request's first token, which
        samples at `index` of its key `key`."""
        dev, v = self.device, self.cfg.vocab_size
        noise = torch.zeros((1, 1, v), dtype=torch.float32, device=dev)
        if temp > 0.0:
            _draw_gumbel(noise[0, 0], key, index)
        return _Sampling(
            torch.full((1,), temp, dtype=torch.float32, device=dev),
            torch.full((1,), top_p, dtype=torch.float32, device=dev),
            noise, self.top_k, self.enable_top_p)

    # -- metrics --

    def _kvhost_snapshot(self) -> Dict[str, Any]:
        """The `kvhost` metrics block: the host tier's counters and the
        gossiped warmth bloom over every prefix digest this replica can
        serve warm (the device radix tree and the host tier), rebuilt at
        most every kv_gossip_interval seconds (staleness costs a few
        seconds of routing on old warmth, which the radix miss absorbs). A
        dense engine sends an empty bloom."""
        tier = self._host_tier
        out: Dict[str, Any] = {
            "enabled": tier is not None,
            "capacity": self.kv_host_blocks,
            "blocks_used": tier.blocks_used if tier else 0,
            "offloads_total": tier.offloads_total if tier else 0,
            "prefetches_total": tier.prefetches_total if tier else 0,
            "hits_total": tier.hits_total if tier else 0,
            "discards_total": tier.discards_total if tier else 0,
            "corrupt_drops_total": tier.corrupt_drops_total if tier else 0,
            "dma_failures_total": tier.dma_failures_total if tier else 0,
            "dma_seconds_total": tier.dma_seconds_total if tier else 0.0,
            "imports_total": tier.imports_total if tier else 0,
            "exports_total": tier.exports_total if tier else 0,
            "block_len": self.kv_block_len,
            "bloom": "", "bloom_bits": 0, "bloom_hashes": 0,
        }
        if not self._paged:
            return out
        now = time.monotonic()
        if (not self._kv_bloom_hex
                or now - self._kv_bloom_at >= self.kv_gossip_interval):
            bloom = kvhost.PrefixBloom()
            stack = list(self._radix.root.children.values())
            while stack:
                node = stack.pop()
                bloom.add(node.digest)
                stack.extend(node.children.values())
            if tier is not None:
                for digest in tier.digests():
                    bloom.add(digest)
            self._kv_bloom_hex = bloom.to_hex()
            self._kv_bloom_bits = bloom.bits
            self._kv_bloom_hashes = bloom.hashes
            self._kv_bloom_at = now
        out["bloom"] = self._kv_bloom_hex
        out["bloom_bits"] = self._kv_bloom_bits
        out["bloom_hashes"] = self._kv_bloom_hashes
        return out

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Counters and flat per-request rows; the percentile sorts live in
        aggregate_metrics (callers run them outside any serving lock)."""
        graphs = [g for g in (self._graph, self._quantum_graph,
                              self._verify_graph) if g is not None]
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
            # Queue depth by priority class: the fleet's router and
            # autoscaler steer interactive traffic on the split.
            "queued_interactive": sum(1 for r in self._queue
                                      if r.priority == "interactive"),
            "queued_batch": sum(1 for r in self._queue
                                if r.priority == "batch"),
            "lifetime": {
                "completed": self._completed_total,
                "cancelled": self._cancelled_total,
                "tokens": self._tokens_out_total,
                "decode_steps": self._decode_steps_total,
                "prefill_chunks": self._prefill_chunks_total,
            },
            "errors": dict(self._errors_total),
            "draining": self._draining,
            # Fault, drain, hot-swap and evacuation state (the JAX
            # engine's block).
            "resilience": {
                "errors": dict(self._errors_total),
                "watchdog_trips": self._watchdog_trips,
                "weight_swaps": self._swaps_total,
                "swap_pause_ms_total": self._swap_pause_ms_total,
                "swap_pause_ms_last": self._swap_pause_ms_last,
                "draining": self._draining,
                # The degraded-mesh evacuation: requests ejected as
                # reason="evacuate" frames on a device loss (monotonic), and
                # whether the engine serves on one device since; the serve
                # main folds mesh_degraded into its `mesh` block.
                "evacuated_total": self._evacuated_total,
                "mesh_degraded": self._mesh_degraded,
            },
            # Decode hot path: host seconds on the sync path (the fetch,
            # watchdog poll included; plus the commit when it does not
            # overlap) and commit seconds that ran behind a chunk in
            # flight; the decode graph's captures and replays.
            "hotpath": {
                "overlap_commit": self.overlap_commit,
                "commit_rounds_total": self._commit_rounds_total,
                "commit_s_total": self._commit_s_total,
                "commit_overlapped_s_total": self._commit_overlapped_s_total,
                "fetch_sync_s_total": self._fetch_sync_s_total,
                "graphs_captured": sum(g.captures for g in graphs),
                "graph_replays": sum(g.replays for g in graphs),
            },
            # Speculative decoding (all zero with spec_k 0): monotonic
            # counters; acceptance_rate and tokens_per_round are lifetime
            # ratios; k_hist[i] counts slot-rounds dispatched at draft
            # length i; effective_tokens_per_step is the commit depth a
            # round, which the fleet folds into its TTFT-pressure math
            # (1.0 when speculation is off or idle).
            "spec": {
                "enabled": self._spec,
                "k": self.spec_k,
                "rounds_total": self._spec_rounds_total,
                "bypass_rounds_total": self._spec_bypass_total,
                "tokens_total": self._spec_tokens_total,
                "draft_proposed_total": self._spec_proposed_total,
                "draft_accepted_total": self._spec_accepted_total,
                "acceptance_rate": (
                    self._spec_accepted_total / self._spec_proposed_total
                    if self._spec_proposed_total else 0.0),
                "tokens_per_round": (
                    self._spec_tokens_total / self._spec_rounds_total
                    if self._spec_rounds_total else 0.0),
                "effective_tokens_per_step": (
                    self._spec_tokens_total / self._spec_rounds_total
                    if self._spec and self._spec_rounds_total else 1.0),
                "k_hist": list(self._spec_k_hist),
            },
            # Zero-loss migration (monotonic counters).
            "migration": {
                "resumed_total": self._resumed_total,
                "resume_committed_tokens_total":
                    self._resume_committed_total,
                "ejected_total": self._ejected_total,
                # Batch requests ejected for an interactive head, and
                # the prefill role's first-token handoffs (subsets of
                # ejected_total).
                "preempted_total": self._preempted_total,
                "handoffs_total": self._handoffs_total,
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
                                    + self._kv_evictions_prior
                                    if self._paged else 0),
                "deferrals_total": self._kv_deferrals_total,
                "prompt_tokens_total": self._kv_prompt_tokens_total,
                "matched_tokens_total": self._kv_matched_tokens_total,
                "prefix_hit_rate": (
                    self._kv_matched_tokens_total
                    / self._kv_prompt_tokens_total
                    if self._kv_prompt_tokens_total else 0.0),
            },
            # The host KV tier and the fleet's warmth gossip: the
            # ktwe_serving_kvhost_* source; the fleet registry reads the
            # bloom fields for warm routing.
            "kvhost": self._kvhost_snapshot(),
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
            # .get: a stub snapshot without the block reads as tier-off
            # with an empty bloom.
            "kvhost": snap.get("kvhost", {
                "enabled": False, "capacity": 0, "blocks_used": 0,
                "offloads_total": 0, "prefetches_total": 0,
                "hits_total": 0, "discards_total": 0,
                "corrupt_drops_total": 0, "dma_failures_total": 0,
                "dma_seconds_total": 0.0, "imports_total": 0,
                "exports_total": 0, "block_len": 0, "bloom": "",
                "bloom_bits": 0, "bloom_hashes": 0}),
            "migration": snap["migration"],
            "errors": snap["errors"],
            "draining": snap["draining"],
            "resilience": snap["resilience"],
            "hotpath": snap["hotpath"],
            "spec": snap["spec"],
            "queued": snap["queued"],
            "queued_interactive": snap["queued_interactive"],
            "queued_batch": snap["queued_batch"],
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
