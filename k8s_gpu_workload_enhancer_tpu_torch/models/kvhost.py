"""kvhost: the host-RAM block tier under the paged KV pool, and the
fleet-warmth primitives (prefix digests and a bloom filter) built on it.

Port of k8s_gpu_workload_enhancer_tpu/models/kvhost.py. The digest and
bloom surface is a copy (the same sha256 double hashing, so a bloom's hex
is bit-identical to the JAX replica's after the same requests); the tier
is rewritten in PyTorch's idiom.

The paged engine's radix tree caps out at device memory: evicting a cold
block frees its page and the KV is gone, so every re-arrival of a cold
system prompt re-pays its prefill. This module adds the next level:

- **HostBlockTier** — an LRU store of full KV blocks in host memory,
  keyed by chain digest. Radix eviction DEMOTES a cold block here
  (`offload`) instead of discarding it, and admission PREFETCHES a
  matched-but-evicted prefix back (`restore`) before sizing its prefill.
  On the card a demotion stages the page on the compute stream (one
  device-to-device copy of its leaves, ordered after every write queued
  to the page and before any later one), then copies the stage into
  pinned host memory on a side stream behind an event; the entry is
  finalized (event waited, crc taken) lazily at its first `fetch` or
  `export_entry`, so the engine's step loop never waits on the host link
  to demote. A restore copies the host rows into the existing pool
  tensors in place (`pages[:, blk].copy_`) on the compute stream, so a
  prefill (or a decode graph, which captured that storage) queued after
  it reads the restored page. On the CPU the same code runs with plain
  copies and no streams.

- **prompt_digests** — the cumulative chain digests of a prompt's full
  blocks (`paged_kv.chain_digest`, which the radix nodes carry): the key
  of the tier and of the fleet's warmth probe.

- **PrefixBloom** — the per-replica prefix-digest bloom filter the fleet
  registry reads from `/v1/metrics`: the engine adds every digest it holds
  (device radix tree and host tier); the router walks a prompt's digests
  against each replica's filter and routes to the deepest warm match. A
  false positive costs one radix miss (a normal prefill), never an error.

Entries are keyed by a MESH SIGNATURE that names the backend
("backend=torch" on one device, where the JAX package's is ""): a page
shipped in from a JAX replica is a miss here, and a torch page a miss
there, so KV computed by one package's kernels is never read by the
other's; the request re-prefills. On a serving mesh the signature is
"backend=torch|" and then the JAX tier's own string for the same mesh
(its five axes' sizes and the KV-head partition axis): a page of another
mesh is a miss too, never resharded through the tier.

**On a serving mesh** (models/serving.py) the tier lives on the driver
alone, and its entries hold ASSEMBLED pages (every KV head: the JAX
tier's host arrays), so `/v1/kvhost` payloads keep the JAX keys and
shapes. The engine hands the tier two device programs, which every rank
of the gang runs in the driver's order: `stage` (a demotion: the tp
ranks' KV-head shards of the page gathered to the driver) and `write` (a
restore: the page sent from the driver, every rank writing its own
KV-head slice in place). On one device they are `stage_page` and
`write_page` below.

Failure containment rides three FaultLab sites, at the JAX tier's
boundaries: ``kvhost.dma`` (the demotion copy: a fault degrades to the
plain discard), ``kvhost.fetch`` (the host-to-device path: a fault is a
miss, the request re-prefills) and ``kvhost.corrupt`` (a stored block
that fails its checksum is dropped and counted, never restored). Every
degraded path ends in a re-prefill.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import time
import zlib

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from .. import faultlab
from ..parallel.mesh import AXES
from .paged_kv import chain_digest

__all__ = ["chain_digest", "prompt_digests", "PrefixBloom", "mesh_signature",
           "HostBlockTier", "HostEntry"]

# A page's leaves by name, in KVCache.leaves() order.
LEAF_NAMES = ("k", "v", "kscale", "vscale")
# Payload dtype names (numpy's and ml_dtypes' spellings, as the JAX tier
# writes them) -> torch dtypes.
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}


def prompt_digests(tokens: Sequence[int], block_len: int,
                   limit: int = 32) -> List[str]:
    """Cumulative chain digests for a prompt's full blocks (at most
    `limit`: 32 blocks of context is already a decisive routing signal)."""
    if block_len <= 0:
        return []
    out: List[str] = []
    parent = ""
    for off in range(0, (len(tokens) // block_len) * block_len, block_len):
        parent = chain_digest(parent, tokens[off:off + block_len])
        out.append(parent)
        if len(out) >= limit:
            break
    return out


def mesh_signature(mesh: Any, kv_tp: Optional[str],
                   backend: str = "torch") -> str:
    """Layout identity of a replica's paged pool: the backend, then (on a
    mesh) the mesh's axis sizes and the kv-head partition axis. Host
    entries restore only into the signature they were extracted under: a
    page from another backend or mesh is a MISS (re-prefill), never a read
    of KV that other kernels computed. `mesh` is None on one device, a
    ServingMesh (its `shape` the (dp, tp) pair: the JAX mesh of
    `MeshConfig(dp, tp)` over the five axes) or anything with a `shape`
    mapping of axis sizes."""
    if mesh is None:
        return f"backend={backend}"
    shape = mesh.shape
    if not isinstance(shape, Mapping):
        dp, tp = shape
        shape = {**{a: 1 for a in AXES}, "dp": dp, "tp": tp}
    axes = ",".join(f"{a}={n}" for a, n in sorted(shape.items()))
    return f"backend={backend}|{axes}|kv_tp={kv_tp or ''}"


def stage_page(cache, block_id: int) -> Dict[str, torch.Tensor]:
    """Page `block_id` of every leaf, copied out of the pool (one device):
    the demotion's stage, queued on the current stream."""
    return {n: t[:, block_id].clone()
            for n, t in zip(LEAF_NAMES, cache.leaves())}


def write_page(cache, block_id: int, arrays: Dict[str, torch.Tensor]
               ) -> None:
    """A page's host rows into pool page `block_id` in place (one device),
    queued on the current stream."""
    for name, pages in zip(LEAF_NAMES, cache.leaves()):
        pages[:, block_id].copy_(arrays[name], non_blocking=pages.is_cuda)


class PrefixBloom:
    """Fixed-size bloom filter over prefix digests, hex-serializable for
    the `/v1/metrics` gossip payload. Double hashing (Kirsch-Mitzenmacher)
    over sha256 halves: k positions from two 64-bit hashes. No false
    negatives (a warm replica is never skipped); a false positive costs
    one radix miss."""

    def __init__(self, bits: int = 4096, hashes: int = 4):
        if bits % 8 or bits <= 0:
            raise ValueError(f"bits {bits} must be a positive "
                             f"multiple of 8")
        if hashes <= 0:
            raise ValueError(f"hashes {hashes} must be >= 1")
        self.bits = int(bits)
        self.hashes = int(hashes)
        self._buf = bytearray(bits // 8)

    def _positions(self, digest: str) -> List[int]:
        raw = hashlib.sha256(digest.encode("ascii")).digest()
        h1 = int.from_bytes(raw[:8], "big")
        h2 = int.from_bytes(raw[8:16], "big") | 1
        return [(h1 + i * h2) % self.bits for i in range(self.hashes)]

    def add(self, digest: str) -> None:
        for p in self._positions(digest):
            self._buf[p >> 3] |= 1 << (p & 7)

    def __contains__(self, digest: str) -> bool:
        return all(self._buf[p >> 3] & (1 << (p & 7))
                   for p in self._positions(digest))

    def to_hex(self) -> str:
        return self._buf.hex()

    @classmethod
    def from_hex(cls, hex_str: str, bits: int,
                 hashes: int) -> "PrefixBloom":
        out = cls(bits=bits, hashes=hashes)
        buf = bytes.fromhex(hex_str)
        if len(buf) != bits // 8:
            raise ValueError(
                f"bloom payload {len(buf)}B does not match bits {bits}")
        out._buf = bytearray(buf)
        return out

    def match_depth(self, digests: Sequence[str]) -> int:
        """Longest CONTIGUOUS warm prefix: the count of leading digests in
        the filter (a deeper digest without its parents is unreachable by
        the radix match, so the walk stops at the first miss)."""
        depth = 0
        for d in digests:
            if d not in self:
                break
            depth += 1
        return depth


@dataclass
class HostEntry:
    """One offloaded full block: host copies of the pool's per-block rows
    by leaf name — k/v (L, BL, KH, D) and, for int8 caches, the f32 scale
    rows (L, BL, KH). `pending` holds the host buffers while their copy
    from the device may still run, with `event` recorded behind it (None
    on the CPU); `arrays` holds them once finalized."""
    digest: str
    parent_digest: str
    key: Tuple[int, ...]
    mesh_sig: str
    arrays: Optional[Dict[str, torch.Tensor]] = None
    pending: Optional[Dict[str, torch.Tensor]] = None
    event: Optional[Any] = None
    crc: int = 0
    dispatched_at: float = field(default_factory=time.perf_counter)


def _raw(t: torch.Tensor):
    """A host tensor's bytes in C order, as a buffer (no copy when it is
    contiguous): what the crc hashes and a payload ships. bf16 goes as
    its raw bytes, which numpy cannot type."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


class HostBlockTier:
    """LRU host-memory store of full KV blocks, keyed by chain digest.

    Single-threaded like the engine's other host bookkeeping (the serving
    lock serializes every mutation). `capacity` bounds the blocks held;
    past it the coldest entry is DISCARDED, so the tier's floor is the
    plain evict-to-nowhere behaviour. `page_layout` (leaf name -> (shape,
    dtype) of one assembled page; None: anything) makes `import_entry`
    reject a payload whose rows this pool cannot hold. `device` is the
    pool's. `mesh` and `kv_tp` (the JAX tier's) make the signature; `stage`
    (cache, block_id) -> {leaf name: the assembled page, a tensor of its
    own} and `write` (cache, block_id, host rows) are the demotion's and
    the restore's device work, `stage_page` and `write_page` by default
    (the module note)."""

    def __init__(self, *, capacity: int, block_len: int, device="cpu",
                 page_layout: Optional[Dict[str, Tuple[Tuple[int, ...],
                                                       torch.dtype]]] = None,
                 mesh: Any = None, kv_tp: Optional[str] = None,
                 stage: Optional[Callable] = None,
                 write: Optional[Callable] = None):
        if capacity <= 0:
            raise ValueError(f"host tier capacity {capacity} must be "
                             f">= 1 (0 disables the tier at the "
                             f"engine flag, not here)")
        self.capacity = int(capacity)
        self.block_len = int(block_len)
        self.device = torch.device(device)
        self.mesh = mesh
        self.kv_tp = kv_tp
        self.mesh_sig = mesh_signature(mesh, kv_tp)
        self.page_layout = page_layout
        self._stage = stage or stage_page
        self._write = write or write_page
        self._entries: "OrderedDict[str, HostEntry]" = OrderedDict()
        # Lifetime counters — the ktwe_serving_kvhost_* source.
        self.offloads_total = 0
        self.prefetches_total = 0
        self.hits_total = 0
        self.discards_total = 0
        self.corrupt_drops_total = 0
        self.dma_failures_total = 0
        self.dma_seconds_total = 0.0
        # Pages imported and exported through /v1/kvhost.
        self.imports_total = 0
        self.exports_total = 0
        # The card's side stream for the demotion copies (made on first
        # use), and host buffers whose copy may still run after their
        # entry left the tier (discarded, dropped, or restored from):
        # (event behind the copy, buffers), kept until the event is done.
        self._stream = None
        self._in_flight: List[Tuple[Any, tuple]] = []

    # -- stats --

    @property
    def blocks_used(self) -> int:
        return len(self._entries)

    def digests(self) -> List[str]:
        return list(self._entries.keys())

    def __contains__(self, digest: str) -> bool:
        return digest in self._entries

    def host_bytes(self) -> int:
        """Host bytes the entries hold (pinned on the card)."""
        return sum(t.numel() * t.element_size()
                   for e in self._entries.values()
                   for t in (e.arrays or e.pending or {}).values())

    # -- copies --

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _keep_until(self, event, buffers) -> None:
        """Hold `buffers` until `event` has completed (a pinned buffer
        freed under its running copy could be handed to another copy),
        pruning the ones whose copies are done."""
        self._in_flight = [(e, b) for e, b in self._in_flight
                           if not e.query()]
        if event is not None:
            self._in_flight.append((event, tuple(buffers)))

    def _retire(self, entry: HostEntry) -> None:
        """An entry leaves the tier: a copy it still waits on keeps its
        buffers alive."""
        if entry.pending is not None and entry.event is not None:
            self._keep_until(entry.event, entry.pending.values())

    def _dispatch_extract(self, cache, block_id: int):
        """Start copying page `block_id` of every leaf to the host:
        (name -> host tensor, event behind the copies or None)."""
        # Ordering without a device sync. The caller frees the page as soon
        # as this returns, and the same admission may hand it to its
        # prefill commit at once. So the page is first staged on the
        # compute stream (a copy, or on a mesh the tp gather): that runs
        # after every write already queued to the page and before any
        # write queued later.
        stage = self._stage(cache, block_id)
        if cache.k.device.type != "cuda":
            return stage, None
        # The side stream waits for the stage, then copies it to pinned
        # host memory while the compute stream goes on; the stage records
        # the side stream, so the allocator keeps it until that copy has
        # read it.
        compute = torch.cuda.current_stream(self.device)
        staged = torch.cuda.Event()
        staged.record(compute)
        side = self._side_stream()
        side.wait_event(staged)
        host = {}
        with torch.cuda.stream(side):
            for n, t in stage.items():
                t.record_stream(side)
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                host[n] = h
        done = torch.cuda.Event()
        done.record(side)
        return host, done

    def _finalize_entry(self, entry: HostEntry) -> None:
        """Land the demotion copy: wait its event, take the crc. The
        dma-seconds meter charges dispatch -> finalize wall time, as the
        JAX tier does."""
        if entry.pending is None:
            return
        if entry.event is not None:
            entry.event.synchronize()
        entry.arrays, entry.pending, entry.event = entry.pending, None, None
        entry.crc = self._crc(entry.arrays)
        self.dma_seconds_total += max(
            0.0, time.perf_counter() - entry.dispatched_at)

    @staticmethod
    def _crc(arrays: Dict[str, torch.Tensor]) -> int:
        """zlib.crc32 over each leaf's raw bytes in sorted leaf-name order
        (the JAX tier's, byte for byte)."""
        crc = 0
        for name in sorted(arrays):
            crc = zlib.crc32(_raw(arrays[name]), crc)
        return crc

    # -- the tier API --

    def offload(self, cache, block_id: int, digest: str,
                parent_digest: str, key: Sequence[int]) -> bool:
        """Demote one device block to the host tier (the radix eviction
        hook, just before the page is freed). Returns False, and stores
        nothing, when the copy faults; the caller proceeds with the plain
        discard either way."""
        if digest in self._entries:
            self._entries.move_to_end(digest)
            return True
        try:
            # FaultLab boundary: the device->host demotion copy. A fault
            # degrades to the plain discard: a re-arrival re-prefills.
            faultlab.site("kvhost.dma")
            pending, event = self._dispatch_extract(cache, block_id)
        except Exception:                      # noqa: BLE001 — contained
            self.dma_failures_total += 1
            return False
        entry = HostEntry(digest=digest, parent_digest=parent_digest,
                          key=tuple(int(t) for t in key),
                          mesh_sig=self.mesh_sig, pending=pending,
                          event=event)
        self._entries[digest] = entry
        self.offloads_total += 1
        self._trim()
        return True

    def _trim(self) -> None:
        while len(self._entries) > self.capacity:
            _, old = self._entries.popitem(last=False)
            self._retire(old)
            self.discards_total += 1

    def fetch(self, digest: str) -> Optional[HostEntry]:
        """Look up an offloaded block for prefetch. None = miss (absent,
        another signature, faulted, or corrupt: the caller re-prefills). A
        corrupt entry (crc mismatch, or the kvhost.corrupt drill) is
        DROPPED: stale KV must never restore."""
        entry = self._entries.get(digest)
        if entry is None:
            return None
        if entry.mesh_sig != self.mesh_sig:
            return None
        try:
            # FaultLab boundary: the host->device fetch path — a fault is a
            # miss (the entry is dropped, the request re-prefills).
            faultlab.site("kvhost.fetch")
            self._finalize_entry(entry)
        except Exception:                      # noqa: BLE001 — contained
            self.dma_failures_total += 1
            self._retire(self._entries.pop(digest))
            return None
        try:
            # FaultLab boundary: stored-block corruption — drop, never
            # restore.
            faultlab.site("kvhost.corrupt")
            if self._crc(entry.arrays) != entry.crc:
                raise ValueError(f"kvhost crc mismatch on {digest}")
        except Exception:                      # noqa: BLE001 — contained
            self.corrupt_drops_total += 1
            self._entries.pop(digest, None)
            return None
        self._entries.move_to_end(digest)
        self.hits_total += 1
        return entry

    def restore(self, cache, block_id: int, entry: HostEntry) -> None:
        """Host->device: write the entry's block into pool page `block_id`
        in place (the pool tensors keep their storage, so a captured decode
        graph reads the restored page), on the compute stream: the prefill
        queued after this returns reads it. The host buffers are held until
        the copy has read them, whatever becomes of the entry."""
        t0 = time.perf_counter()
        self._write(cache, block_id, entry.arrays)
        if cache.k.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            self._keep_until(done, entry.arrays.values())
        self.prefetches_total += 1
        self.dma_seconds_total += max(0.0, time.perf_counter() - t0)

    def drop(self, digest: str) -> None:
        entry = self._entries.pop(digest, None)
        if entry is not None:
            self._retire(entry)
            self.discards_total += 1

    def clear(self) -> None:
        """Discard every entry (a weight swap: their KV is the old
        weights')."""
        for digest in list(self._entries):
            self.drop(digest)

    # -- fleet page shipping (/v1/kvhost) --

    def export_entry(self, digest: str) -> Optional[dict]:
        """Serialize one block for a peer replica: a JSON-safe dict of
        base64 leaf payloads and the metadata a peer needs to import it,
        in the JAX tier's keys."""
        entry = self._entries.get(digest)
        if entry is None:
            return None
        self._finalize_entry(entry)
        if self._crc(entry.arrays) != entry.crc:
            self.corrupt_drops_total += 1
            self._entries.pop(digest, None)
            return None
        self.exports_total += 1
        return {
            "digest": entry.digest,
            "parent_digest": entry.parent_digest,
            "key": list(entry.key),
            "mesh_sig": entry.mesh_sig,
            "crc": entry.crc,
            "arrays": {
                n: {"b64": base64.b64encode(_raw(a)).decode(),
                    "dtype": str(a.dtype).rsplit(".", 1)[-1],
                    "shape": list(a.shape)}
                for n, a in entry.arrays.items()},
        }

    def import_entry(self, payload: dict) -> bool:
        """Install a peer's exported block. Rejects (False) payloads of
        another signature, corrupt payloads and payloads whose rows this
        pool cannot hold: an import can only ADD a warm block."""
        if payload.get("mesh_sig", "") != self.mesh_sig:
            return False
        try:
            arrays = {
                n: torch.frombuffer(
                    bytearray(base64.b64decode(spec["b64"],
                                               validate=True)),
                    dtype=_DTYPES[spec["dtype"]]).reshape(spec["shape"])
                for n, spec in payload["arrays"].items()}
            entry = HostEntry(
                digest=str(payload["digest"]),
                parent_digest=str(payload.get("parent_digest", "")),
                key=tuple(int(t) for t in payload.get("key", ())),
                mesh_sig=self.mesh_sig, arrays=arrays,
                crc=int(payload["crc"]))
            if self._crc(arrays) != entry.crc:
                self.corrupt_drops_total += 1
                return False
        except (KeyError, ValueError, TypeError, RuntimeError,
                binascii.Error):
            return False
        if self.page_layout is not None and {
                n: (tuple(a.shape), a.dtype) for n, a in arrays.items()
        } != self.page_layout:
            return False
        old = self._entries.pop(entry.digest, None)
        if old is not None:
            self._retire(old)
        self._entries[entry.digest] = entry
        self.imports_total += 1
        self._trim()
        return True
