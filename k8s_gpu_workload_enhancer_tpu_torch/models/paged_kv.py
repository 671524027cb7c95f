"""Host-side paged-KV bookkeeping: block pool + radix prefix tree.

Port of k8s_gpu_workload_enhancer_tpu/models/paged_kv.py, copied whole (the
module is plain Python), with its own copy of `chain_digest` from
models/kvhost.py so that nothing of the JAX package is imported.

The paged serving engine (models/serving.py with ``kv_block_len > 0``)
replaces the dense per-slot ``[slots, max_seq]`` KV cache with a pool of
``[num_blocks, block_len]`` pages per layer; each slot owns a *block
table* row mapping logical positions to physical pages. THIS module is the
host truth about who owns which page:

- **BlockPool** — the free list over physical block ids. Block 0 is the
  permanently-reserved TRASH block: parked slots are pointed at it so
  their ignored decode writes land there and never in another request's
  pages. Allocation is all-or-nothing (a request either gets its whole
  reservation or defers admission — no partially-admitted sequences to
  unwind).
- **RadixCache** — a prefix tree over FULL blocks of prompt tokens.
  Each node is one block: key = its ``block_len`` token ids, identity =
  the chain from the root (so two prompts share exactly their common
  full-block prefix). Nodes are refcounted by live requests, can be
  pinned, and are evicted cold-LRU (leaves only, ref == 0, pins == 0)
  under pool pressure. Only full blocks are ever shared; a request's
  partial tail block and its decode-time blocks stay private, so shared
  pages are **read-only after commit** — the copy-on-write primitive
  below exists for safety (and for future sequence-forking work), not
  as a hot path.

The tree matches on *content*, not ids: admission walks the prompt's
full blocks down the tree and reuses any committed chain.
"""

from __future__ import annotations

import hashlib
import heapq

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

TRASH_BLOCK = 0


def chain_digest(parent_digest: str, key: Sequence[int]) -> str:
    """Digest of the chain root -> ... -> the block holding `key`
    (its block_len token ids), given the parent chain's digest (""
    at the root). Content-addressed exactly like the radix tree's
    match — two replicas serving the same tokens at the same
    block_len compute the same digest, which is what makes the bloom
    gossip meaningful fleet-wide."""
    h = hashlib.blake2b(digest_size=16)
    h.update(parent_digest.encode("ascii"))
    h.update(b"|")
    h.update(",".join(str(int(t)) for t in key).encode("ascii"))
    return h.hexdigest()


class BlockPool:
    """Free-list allocator over physical KV block ids ``[1, num_blocks)``
    (block 0 is the trash page and is never handed out)."""

    def __init__(self, num_blocks: int, block_len: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks {num_blocks} must be >= 2 (block 0 is the "
                f"reserved trash page)")
        if block_len < 1:
            raise ValueError(f"block_len {block_len} must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_len = int(block_len)
        # LIFO free stack: recently-freed pages are re-used first (they
        # are the ones most likely still resident in cache hierarchies).
        # The set mirrors it for the O(1) double-free guard (free runs
        # on the serving engine's request-finish hot path).
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._free_set = set(self._free)

    @property
    def capacity(self) -> int:
        """Allocatable blocks (excludes the trash page)."""
        return self.num_blocks - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.capacity - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh block ids, or None (and NO side effect) when the pool
        cannot cover the whole request — all-or-nothing, so a deferred
        admission never holds a partial reservation."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        return out

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if not 0 < b < self.num_blocks:
                raise ValueError(f"free of invalid block id {b}")
            if b in self._free_set:
                raise ValueError(f"double free of block {b}")
            self._free.append(int(b))
            self._free_set.add(int(b))


@dataclass
class RadixNode:
    """One cached full block. `key` is its block_len token ids; identity
    is the chain root -> ... -> this node (children keyed by token
    tuple). `ref` counts live requests whose block table maps through
    this node; `pins` counts holders keeping it hot (register_prefix).
    `detached` nodes have been removed
    from the match index (a weight hot-swap invalidated their contents)
    and free their block to the pool when the last reference drops."""

    key: Tuple[int, ...]
    block: int
    parent: Optional["RadixNode"] = None
    children: Dict[Tuple[int, ...], "RadixNode"] = field(
        default_factory=dict)
    ref: int = 0
    pins: int = 0
    last_use: int = 0
    detached: bool = False
    # Content identity of the chain root -> this node (chain_digest
    # over the parent's digest + this block's key; "" at the root): the
    # key a host tier and the fleet's bloom gossip use — computed once
    # at insert, never rehashed.
    digest: str = ""


class RadixCache:
    """Content-addressed full-block prefix tree over a BlockPool.

    Not thread-safe on its own — the serving engine's single-threaded
    step loop (or the service lock above it) serializes all mutation,
    exactly like the rest of the engine's host bookkeeping.
    """

    def __init__(self, pool: BlockPool):
        self._pool = pool
        self._root = RadixNode(key=(), block=TRASH_BLOCK)
        self._tick = 0
        self._nodes = 0
        self.evictions_total = 0
        # Demotion hook (the host-RAM tier, models/kvhost.py): called with
        # each eviction victim BEFORE its page is freed, so a tier can
        # copy the block's KV out. MUST NOT raise — eviction semantics
        # are unchanged whether the hook stores the block or not (the
        # engine's demote wrapper contains its own faults).
        self.on_evict: Optional[Callable[[RadixNode], None]] = None

    @property
    def root(self) -> RadixNode:
        """The tree root (digest "", trash block) — the parent handle
        prefetch uses to graft restored chains from the front."""
        return self._root

    # -- stats --

    @property
    def cached_blocks(self) -> int:
        """Blocks held by the tree (shared + cold reusable)."""
        return self._nodes

    def shared_blocks(self) -> int:
        """Blocks actively mapped by >= 2 live requests right now."""
        n = 0
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            if node.ref >= 2:
                n += 1
            stack.extend(node.children.values())
        return n

    def pinned_blocks(self) -> int:
        """Blocks held hot by register_prefix pins — eviction can never
        reclaim them, so `pool.capacity - pinned_blocks()` is the true
        ceiling a single request's reservation can ever reach."""
        n = 0
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            if node.pins > 0:
                n += 1
            stack.extend(node.children.values())
        return n

    # -- matching / refcounts --

    def _touch(self, node: RadixNode) -> None:
        self._tick += 1
        node.last_use = self._tick

    def match(self, tokens: Sequence[int]) -> List[RadixNode]:
        """Longest committed chain covering the prompt's FULL blocks.
        Pure lookup: takes no references (callers `acquire` the chain
        they decide to use)."""
        bl = self._pool.block_len
        chain: List[RadixNode] = []
        node = self._root
        for off in range(0, (len(tokens) // bl) * bl, bl):
            key = tuple(int(t) for t in tokens[off:off + bl])
            child = node.children.get(key)
            if child is None:
                break
            chain.append(child)
            node = child
        return chain

    def acquire(self, chain: Sequence[RadixNode]) -> None:
        for node in chain:
            node.ref += 1
            self._touch(node)

    def release(self, chain: Sequence[RadixNode]) -> None:
        """Drop one live reference per node. Blocks stay CACHED in the
        tree (cold, evictable) — unless the node was detached by a
        weight swap, in which case the last reference frees it."""
        for node in chain:
            if node.ref <= 0:
                raise ValueError(
                    f"release of unreferenced block {node.block}")
            node.ref -= 1
            if node.detached and node.ref == 0:
                self._pool.free([node.block])

    def insert(self, parent: Optional[RadixNode], key: Sequence[int],
               block: int) -> RadixNode:
        """Commit one block under `parent` (None = root). The caller
        must have fully written the block's KV BEFORE inserting — a
        matching admission may gather it on the very next step. If an
        equivalent child already exists the existing node wins and the
        caller keeps its duplicate block private (ValueError would be
        wrong: concurrent identical prompts are normal)."""
        parent = parent or self._root
        key = tuple(int(t) for t in key)
        if len(key) != self._pool.block_len:
            raise ValueError(
                f"insert key of {len(key)} tokens; full blocks only "
                f"(block_len {self._pool.block_len})")
        existing = parent.children.get(key)
        if existing is not None:
            return existing
        node = RadixNode(key=key, block=int(block), parent=parent,
                         digest=chain_digest(parent.digest, key))
        parent.children[key] = node
        self._nodes += 1
        self._touch(node)
        return node

    # -- pinning (register_prefix) --

    def pin(self, chain: Sequence[RadixNode]) -> None:
        for node in chain:
            node.pins += 1
            self._touch(node)

    def unpin(self, chain: Sequence[RadixNode]) -> None:
        for node in chain:
            if node.pins <= 0:
                raise ValueError(f"unpin of unpinned block {node.block}")
            node.pins -= 1

    # -- eviction --

    def evictable_blocks(self) -> int:
        """How many blocks eviction could EVENTUALLY free: nodes whose
        entire subtree is cold (ref == 0, pins == 0 throughout —
        cascading leaf eviction reaches exactly those). Callers check
        this BEFORE evicting so an unsatisfiable allocation never wipes
        the warm cache for nothing (all-or-nothing eviction to match
        the all-or-nothing alloc)."""
        def count(node: RadixNode) -> Tuple[int, bool]:
            n, all_cold = 0, node.ref == 0 and node.pins == 0
            for child in node.children.values():
                cn, cc = count(child)
                n += cn
                all_cold = all_cold and cc
            return (n + 1 if all_cold else n), all_cold
        total = 0
        for child in self._root.children.values():
            total += count(child)[0]
        return total

    def _evictable_leaves(self) -> List[RadixNode]:
        out: List[RadixNode] = []
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif node.ref == 0 and node.pins == 0:
                out.append(node)
        return out

    def _drop(self, node: RadixNode) -> None:
        assert not node.children and node.ref == 0
        del node.parent.children[node.key]
        self._nodes -= 1
        self._pool.free([node.block])

    def evict(self, need: int) -> int:
        """Free up to `need` cold blocks back to the pool, LRU-first,
        leaves only (evicting a mid-chain node would break the
        contiguous-from-root invariant matching depends on). One tree
        walk total: candidates ride a min-heap on last_use, and
        dropping a leaf promotes its newly-exposed parent into the heap
        — O(tree + freed log tree), not a rewalk per freed block (this
        runs on the admission path under pool pressure, inside the
        serving lock)."""
        freed = 0
        heap = [(n.last_use, id(n), n)
                for n in self._evictable_leaves()]
        heapq.heapify(heap)
        while freed < need and heap:
            _, _, victim = heapq.heappop(heap)
            if self.on_evict is not None:
                # Demote-before-drop: the host tier copies the block's
                # KV out while the page still holds it. The hook never
                # raises (engine containment); eviction proceeds
                # identically whether the copy stuck or not.
                self.on_evict(victim)
            self._drop(victim)
            self.evictions_total += 1
            freed += 1
            parent = victim.parent
            if (parent is not None and parent is not self._root
                    and not parent.children
                    and parent.ref == 0 and parent.pins == 0):
                heapq.heappush(heap,
                               (parent.last_use, id(parent), parent))
        return freed

    def detach_all(self) -> None:
        """Remove EVERY node from the match index (weight hot-swap: the
        cached KV no longer matches the serving params). Unreferenced
        blocks free immediately; blocks still mapped by live requests
        free when their last reference drops (release())."""
        stack = list(self._root.children.values())
        self._root.children = {}
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            node.children = {}
            node.parent = None
            node.detached = True
            self._nodes -= 1
            if node.ref == 0:
                self._pool.free([node.block])

    # -- copy-on-write primitive --

    def cow(self, node: RadixNode) -> Optional[int]:
        """Copy-on-write: the WRITER gets a fresh private block and the
        tree keeps the original, so every other reader's block table
        stays valid without repair. Returns the fresh private block id
        (the caller device-copies node.block -> it, then points its own
        table at the copy), or None when the pool is exhausted.

        Shared pages are read-only after commit in the current engine
        (full-block sharing only), so no serving path calls this today;
        it is the tested safety primitive partial-block sharing or
        sequence forking would build on."""
        fresh = self._pool.alloc(1)
        if fresh is None:
            return None
        self._touch(node)
        return fresh[0]


def blocks_needed(total_tokens: int, block_len: int) -> int:
    """Pages covering `total_tokens` logical positions."""
    return -(-int(total_tokens) // int(block_len))
