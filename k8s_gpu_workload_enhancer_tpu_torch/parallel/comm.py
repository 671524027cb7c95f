"""The collectives of a serving gang, behind one small interface.

A `Comm` is one rank's handle on a group of ranks: its `rank` and the
group's `size`, a sum all-reduce, an all-gather on a dim, a tensor
broadcast and an object broadcast. Two implementations:

- `ProcessComm`: a `torch.distributed` group (gloo on the CPU, NCCL on the
  card), as `train/bootstrap.initialize` starts it: one process a rank.
  Its collectives carry the bootstrap's finite timeout, so a lost peer
  fails a collective instead of hanging it.
- `ThreadGroup`: `size` virtual ranks as threads of one process on one
  device (the card's counterpart of the JAX tests' virtual CPU devices).
  A collective is an exchange of references under a barrier with the
  same finite timeout; a rank whose thread fails aborts the barriers, so
  its peers raise instead of waiting. All virtual ranks share the device's
  default stream, so a rank's partial is enqueued before the barrier that
  lets another rank read it. Nothing here may run under graph capture.

Both sum in rank order on every rank (the ranks' blocks gathered, then
added one after another from rank 0), so every rank holds identical bits.
"""

from __future__ import annotations

import pickle
import threading
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# Longest wait of one collective (train/bootstrap.COLLECTIVE_TIMEOUT_S).
COLLECTIVE_TIMEOUT_S = 600.0


def _sum_in_order(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


def _concat(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    return torch.cat(list(parts), dim=dim)


class Comm:
    """One rank's handle on a group (see the module note)."""

    rank: int = 0
    size: int = 1

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' tensors concatenated on `dim`, in rank order."""
        raise NotImplementedError

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' tensors summed in rank order (a new tensor)."""
        if self.size == 1:
            return t
        parts = self.all_gather(t.unsqueeze(0), 0)
        return _sum_in_order(parts.unbind(0))

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """`src`'s tensor, written into `t` on every other rank."""
        raise NotImplementedError

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """`src`'s picklable object (numpy arrays, ints, tuples)."""
        raise NotImplementedError


class ProcessComm(Comm):
    """A torch.distributed group: `group` (None: the default group) and its
    ranks' global ids in group order (`ranks`)."""

    def __init__(self, group=None, ranks: Optional[Sequence[int]] = None,
                 device: Optional[torch.device] = None):
        self.group = group
        self.ranks = list(ranks) if ranks is not None else list(
            range(dist.get_world_size()))
        self.size = len(self.ranks)
        self.rank = self.ranks.index(dist.get_rank())
        # Where the object broadcast stages its bytes: the card for NCCL,
        # the host for gloo.
        self.device = device or torch.device("cpu")

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if self.size == 1:
            return t
        from .sharding import all_gather
        return all_gather(t, dim, self.group, self.size)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self.size > 1:
            dist.broadcast(t, src=self.ranks[src], group=self.group)
        return t

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """Two broadcasts: the pickle's length, then its bytes."""
        if self.size == 1:
            return obj
        mine = self.rank == src
        payload = pickle.dumps(obj) if mine else b""
        n = torch.tensor([len(payload)], dtype=torch.int64,
                         device=self.device)
        self.broadcast(n, src)
        buf = (torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
               .to(self.device) if mine
               else torch.empty(int(n.item()), dtype=torch.uint8,
                                device=self.device))
        self.broadcast(buf, src)
        return obj if mine else pickle.loads(buf.cpu().numpy().tobytes())


class ThreadGroup:
    """`size` virtual ranks in one process (see the module note); `comm(r)`
    is rank r's handle. Every rank must enter every collective, in the
    same order."""

    def __init__(self, size: int, timeout: float = COLLECTIVE_TIMEOUT_S):
        self.size = int(size)
        self._slots: List[Any] = [None] * self.size
        self._barrier = threading.Barrier(self.size, timeout=timeout)

    def comm(self, rank: int) -> "ThreadComm":
        return ThreadComm(self, rank)

    def abort(self) -> None:
        """Break the barrier: every rank waiting in (or later entering) a
        collective raises threading.BrokenBarrierError."""
        self._barrier.abort()

    def exchange(self, rank: int, value: Any) -> List[Any]:
        """Every rank's `value`, in rank order. The second wait keeps a
        rank from overwriting its slot before every rank has read it."""
        self._slots[rank] = value
        self._barrier.wait()
        out = list(self._slots)
        self._barrier.wait()
        return out


class ThreadComm(Comm):
    """Rank `rank`'s handle on a ThreadGroup."""

    def __init__(self, group: ThreadGroup, rank: int):
        self.group = group
        self.rank = int(rank)
        self.size = group.size

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if self.size == 1:
            return t
        return _concat(self.group.exchange(self.rank, t), dim)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self.size > 1:
            theirs = self.group.exchange(
                self.rank, t if self.rank == src else None)[src]
            if self.rank != src:
                t.copy_(theirs)
        return t

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        if self.size == 1:
            return obj
        return self.group.exchange(
            self.rank, obj if self.rank == src else None)[src]
