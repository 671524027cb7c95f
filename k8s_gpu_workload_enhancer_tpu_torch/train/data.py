"""Training input pipeline: memory-mapped token shards with prefetch.

Port of k8s_gpu_workload_enhancer_tpu/train/data.py. The token shard
format, the windows and their order are the JAX package's, so a shard
written by either package is read by the other and both yield the same
batches from the same (seed, step):

- **Memory-mapped token files** (flat uint16/uint32 arrays behind an
  8-byte magic, a 1-byte item size and a uint64 count): no parsing on the
  hot path, the OS page cache is the shuffle buffer.
- **Deterministic windowed sampling**: an epoch-seeded permutation of
  sequence windows (`np.random.default_rng((seed, epoch))`), so every
  process computes its own batches from (seed, step) alone and a resume
  after preemption is exact: the step counter is the iterator state.
- **Per-process sharding**: process `i` of `n` reads windows
  `step*B*n + i*B + j` of the shuffled stream (B the per-process batch).
  With `grad_accum` = a > 1 it reads its block of B/a rows of each of
  the a microbatches of the step's global batch, windows
  `step*B*n + m*B*n/a + i*B/a + j`, so a gang's microbatch m is one
  process's microbatch m split over the ranks, as the FSDP step takes
  it (train/trainer.py). One process reads what the JAX pipeline reads;
  a gang at a > 1 deviates from it (the JAX pipeline gives each process
  whole microbatches of its own B rows).
- **Device prefetch**: the next batch's host-to-device copy is issued on a
  side stream from a pinned host tensor while the current step runs; the
  consuming stream waits on the copy's event before it uses the batch.

Batches reach the step as int64 token tensors, the dtype
`trainer.synthetic_batches` yields.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

MAGIC = b"KTWETOK1"


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Write a flat token array as a KTWE token shard (.bin)."""
    tokens = np.asarray(tokens)
    if tokens.dtype not in (np.uint16, np.uint32):
        if tokens.max(initial=0) < 2 ** 16:
            tokens = tokens.astype(np.uint16)
        else:
            tokens = tokens.astype(np.uint32)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(np.uint8(tokens.dtype.itemsize).tobytes())
        f.write(np.uint64(tokens.size).tobytes())
        f.write(tokens.tobytes())


def open_token_file(path: str) -> np.ndarray:
    """Memory-map a token shard; returns a read-only 1-D array."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != MAGIC:
            raise ValueError(f"{path}: not a KTWE token file")
        itemsize = int(np.frombuffer(f.read(1), np.uint8)[0])
        count = int(np.frombuffer(f.read(8), np.uint64)[0])
        offset = f.tell()
    dtype = np.uint16 if itemsize == 2 else np.uint32
    return np.memmap(path, dtype=dtype, mode="r", offset=offset,
                     shape=(count,))


@dataclass
class DataConfig:
    path: str
    batch_size: int            # per-process batch
    seq_len: int               # yields (B, seq_len + 1) for next-token loss
    seed: int = 0
    process_id: int = 0
    num_processes: int = 1
    grad_accum: int = 1        # yields (acc, B/acc, S+1) when > 1
    prefetch: bool = True


class TokenDataset:
    """Deterministic shuffled windows over a memory-mapped token shard."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.tokens = open_token_file(cfg.path)
        self.window = cfg.seq_len + 1
        self.num_windows = len(self.tokens) // self.window
        if self.num_windows < 1:
            raise ValueError(
                f"{cfg.path}: {len(self.tokens)} tokens < one window "
                f"({self.window})")
        # The epoch's permutation, computed once an epoch (the reference
        # recomputes it for every window; the windows are the same).
        self._perm_cache: Optional[Tuple[int, np.ndarray]] = None

    def _perm(self, epoch: int) -> np.ndarray:
        if self._perm_cache is None or self._perm_cache[0] != epoch:
            rng = np.random.default_rng((self.cfg.seed, epoch))
            self._perm_cache = (epoch, rng.permutation(self.num_windows))
        return self._perm_cache[1]

    def window_at(self, global_index: int) -> np.ndarray:
        """The global_index-th window of the infinite shuffled stream."""
        epoch, i = divmod(global_index, self.num_windows)
        w = int(self._perm(epoch)[i])
        start = w * self.window
        return np.asarray(self.tokens[start:start + self.window])

    def batches(self, start_step: int = 0) -> Iterator[np.ndarray]:
        """Infinite (B, S+1) int32 batches for THIS process, resumable
        from any step."""
        cfg = self.cfg
        per_step = cfg.batch_size * cfg.num_processes
        acc = cfg.grad_accum
        k = cfg.batch_size // acc          # this process's rows a microbatch
        step = start_step
        while True:
            # This process's block of k rows of each microbatch of the
            # step's global batch (per_step windows, acc microbatches).
            base = step * per_step + cfg.process_id * k
            rows = [self.window_at(base + m * (per_step // acc) + j)
                    for m in range(acc) for j in range(k)]
            batch = np.stack(rows).astype(np.int32)
            if acc > 1:
                batch = batch.reshape(acc, k, self.window)
            yield batch
            step += 1


def _as_tokens(batch: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(batch, dtype=np.int64))


def prefetch_to_device(batches: Iterator[np.ndarray],
                       device="cuda") -> Iterator[torch.Tensor]:
    """Keep one batch in flight: issue the NEXT host-to-device copy before
    yielding the current batch, so the copy overlaps the step that consumes
    the previous one. On the card each batch is copied into a pinned host
    tensor and sent `non_blocking` on a side stream; the stream that is
    current when a batch is yielded waits on that copy's event first. On
    the CPU it is a plain conversion."""
    device = torch.device(device)
    if device.type != "cuda":
        for b in batches:
            yield _as_tokens(b)
        return
    side = torch.cuda.Stream(device=device)
    cur = None
    for b in batches:
        host = _as_tokens(b).pin_memory()
        with torch.cuda.stream(side):
            dev = host.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        nxt = (dev, done)
        if cur is not None:
            yield _consume(*cur, device)
        cur = nxt
    if cur is not None:               # pragma: no cover - infinite iters
        yield _consume(*cur, device)


def _consume(dev: torch.Tensor, done: torch.cuda.Event,
             device: torch.device) -> torch.Tensor:
    stream = torch.cuda.current_stream(device)
    stream.wait_event(done)
    # The batch was allocated on the side stream: tell the allocator the
    # consuming stream uses it, so its memory is not reused too early.
    dev.record_stream(stream)
    return dev


def make_input_pipeline(cfg: DataConfig, start_step: int = 0,
                        device="cuda") -> Iterator[torch.Tensor]:
    """The shard's batches for this process from `start_step`, as int64
    token tensors on `device` (prefetched one ahead when cfg.prefetch)."""
    ds = TokenDataset(cfg)
    it = ds.batches(start_step)
    if cfg.prefetch:
        return prefetch_to_device(it, device)
    device = torch.device(device)
    return (_as_tokens(b).to(device) for b in it)
