"""The port's one choke point for collectives, and a serving gang's
communicators.

Every collective the port runs goes through this module: the train step's
(`all_gather_into`, `reduce_scatter_into`, `all_reduce`, the ring's
`exchange`, called by parallel/sharding.py, parallel/ring_attention.py,
models/transformer.py and cmd/trainer.py; the expert-parallel MoE FFN's
token all-to-alls, through the layout's ep `Comm`; the pipeline's stage
handoffs and layer broadcasts, through the layout's pp `Comm`) and a
serving gang's (the `Comm` methods). Each call is noted, once, for whatever listens
(`listen`: the collective-budget gate, parallel/comm_gate.py) as (op,
bytes this rank sends), the op one of `OPS`: an all-gather sends the
rank's block, an all-reduce and a reduce-scatter the rank's whole input,
an all-to-all the rank's whole input (every rank's chunk of it, its own
included), a broadcast and an object broadcast their payload from the
source (0 elsewhere), a p2p exchange the tensor sent, a p2p send its
tensor and a p2p receive 0. A call made inside
another (the gathers behind a `Comm`'s rank-ordered sum, the two
broadcasts behind an object broadcast) is not noted again. Nothing is noted while nothing listens, and noting
changes no call: what is sent, and in what order, is the same.

A `Comm` is one rank's handle on a group of ranks: its `rank` and the
group's `size`, a sum and a max all-reduce, an all-gather on a dim (and
`all_gather_grad`, whose backward reduce-scatters the gradient: the sum
of the ranks' gradients, this rank's block), a sum reduce-scatter on a
dim (processes), an all-to-all on a dim (and `all_to_all_grad`, the same
exchange with the inverse exchange as its backward), a tensor broadcast,
an object broadcast, and the
pipeline's point-to-point pair: `send` a tensor to one rank and `recv`
one from another (the GPipe schedule's stage handoff,
parallel/pipeline.py). Two implementations:

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
  Its differentiable all-to-all, all-gather and copy are each one
  autograd node over every rank's tensors (rank 0 builds it), not one a
  rank: the autograd engine runs every backward node of a CUDA device on
  one thread of its own, so a rank's backward could never wait there for
  another's. A gang's ranks therefore run their forwards in their threads
  and one backward, from one thread, over the sum of their losses
  (`ThreadComm.all_to_all_grad`, `all_gather_grad`, and `copy_sum_grad`:
  each rank's tensor as it is, its gradient summed over the ranks,
  Megatron's f on a thread gang's tp ranks).
  Its `send` hands the receiver the tensor itself (a mailbox a pair of
  ranks, no barrier), so the ranks' autograd graphs join at a handoff
  (`Comm.shares_graph`): the pipeline's backward is then the same one
  backward over the ranks' losses, and no backward node waits on
  another rank.

Both sum in rank order on every rank (the ranks' blocks gathered, then
added one after another from rank 0), so every rank holds identical bits.
A `Comm` call on a group of one rank is no call and is not noted.
"""

from __future__ import annotations

import contextlib
import pickle
import threading
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# Longest wait of one collective (train/bootstrap.COLLECTIVE_TIMEOUT_S).
COLLECTIVE_TIMEOUT_S = 600.0

# The ops a listener sees.
OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
       "broadcast", "p2p", "object-broadcast")

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class _Sink:
    def __init__(self, calls: list, thread: Optional[int]):
        self.calls, self.thread = calls, thread


_sinks: List[_Sink] = []
_sinks_lock = threading.Lock()
_local = threading.local()


@contextlib.contextmanager
def listen(calls: list, this_thread: bool = False):
    """Append (op, bytes) to `calls` for every collective called inside
    the context: in any thread of the process, or with `this_thread` only
    in the calling one (a rank of a gang of threads)."""
    sink = _Sink(calls, threading.get_ident() if this_thread else None)
    with _sinks_lock:
        _sinks.append(sink)
    try:
        yield calls
    finally:
        with _sinks_lock:
            _sinks.remove(sink)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@contextlib.contextmanager
def _call(op: str, nbytes):
    """One collective call: noted for the listeners unless it runs inside
    another. `nbytes` may be a callable, asked only when someone listens."""
    depth = getattr(_local, "depth", 0)
    if depth == 0 and _sinks:
        me = threading.get_ident()
        n = int(nbytes() if callable(nbytes) else nbytes)
        for s in list(_sinks):
            if s.thread is None or s.thread == me:
                s.calls.append((op, n))
    _local.depth = depth + 1
    try:
        yield
    finally:
        _local.depth = depth


# -- torch.distributed, called nowhere else in the port --


def all_gather_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """The ranks' `inp` concatenated on dim 0 into `out`."""
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    with _call("all-gather", _nbytes(inp)):
        fn(out, inp, group=group)


def reduce_scatter_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """This rank's block of dim 0 of the ranks' `inp` summed, into `out`."""
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    with _call("reduce-scatter", _nbytes(inp)):
        fn(out, inp, op=dist.ReduceOp.SUM, group=group)


def all_reduce(t: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """`t` reduced (`op` "sum" or "max") over the group, in place."""
    with _call("all-reduce", _nbytes(t)):
        dist.all_reduce(t, op=_REDUCE_OPS[op], group=group)
    return t


def all_to_all(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """Chunk r of dim 0 of every rank's `inp` to rank r, the chunks
    received concatenated on dim 0 in rank order into `out`."""
    with _call("all-to-all", _nbytes(inp)):
        dist.all_to_all_single(out, inp, group=group)


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Global rank `src`'s `t`, written into `t` on every other rank."""
    with _call("broadcast", _nbytes(t) if dist.get_rank() == src else 0):
        dist.broadcast(t, src=src, group=group)
    return t


def exchange(t: torch.Tensor, send_to: int, recv_from: int, group
             ) -> torch.Tensor:
    """Send `t` to global rank `send_to` while receiving a tensor of its
    shape from `recv_from` (one batched p2p pair)."""
    t = t.contiguous()
    out = torch.empty_like(t)
    with _call("p2p", _nbytes(t)):
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, send_to, group),
            dist.P2POp(dist.irecv, out, recv_from, group)])
        for req in reqs:
            req.wait()
    return out


def send(t: torch.Tensor, dst: int, group) -> None:
    """`t` to global rank `dst` (blocking; one p2p call)."""
    t = t.contiguous()
    with _call("p2p", _nbytes(t)):
        dist.send(t, dst, group=group)


def recv(out: torch.Tensor, src: int, group) -> torch.Tensor:
    """A tensor of `out`'s shape from global rank `src`, into `out`."""
    with _call("p2p", 0):
        dist.recv(out, src, group=group)
    return out


def all_gather(shard: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The full tensor from the `n` ranks' blocks of `dim` (contiguous)."""
    shard = shard.contiguous()
    shape = list(shard.shape)
    # The ranks' blocks concatenated on dim 0 (the form every backend
    # takes), then moved into place.
    out = shard.new_empty([n * shape[0]] + shape[1:])
    all_gather_into(out, shard, group)
    full = list(shape)
    full[dim] *= n
    if dim == 0:
        return out
    return out.view([n] + shape).movedim(0, dim).reshape(full)


def _sum_in_order(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


def _concat(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    return torch.cat(list(parts), dim=dim)


def _chunks_to(parts: Sequence[torch.Tensor], rank: int, dim: int
               ) -> torch.Tensor:
    """Chunk `rank` of each of the ranks' tensors `parts`, concatenated on
    `dim` in rank order: what an all-to-all gives rank `rank`."""
    n = len(parts)
    return torch.cat([p.chunk(n, dim)[rank] for p in parts], dim=dim)


class _AllToAll(torch.autograd.Function):
    """A rank's all-to-all over `comm`; its backward is the same exchange
    of the gradients (the inverse all-to-all)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, comm: "Comm", dim: int):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_to_all(t, dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.comm.all_to_all(g, ctx.dim), None, None


class _GangAllToAll(torch.autograd.Function):
    """Every rank's all-to-all of a thread gang as one node: inputs the
    ranks' tensors, outputs what each rank receives; the backward gives
    each rank's input the chunks of the gradients the ranks received from
    it. The forward's exchanges are noted by the ranks' threads
    (`ThreadComm.all_to_all_grad`), the backward's once a rank in the
    thread that runs it."""

    @staticmethod
    def forward(ctx, dim: int, *parts: torch.Tensor):
        ctx.dim = dim
        return tuple(_chunks_to(parts, r, dim) for r in range(len(parts)))

    @staticmethod
    def backward(ctx, *grads: torch.Tensor):
        out = []
        for r in range(len(grads)):
            with _call("all-to-all", _nbytes(grads[r])):
                out.append(_chunks_to(grads, r, ctx.dim))
        return (None, *out)


class _AllGather(torch.autograd.Function):
    """A rank's all-gather on `dim` over `comm`; its backward is the
    reduce-scatter of the gradient (the ranks' gradients summed, this
    rank's block)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, comm: "Comm", dim: int):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather(t, dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.comm.reduce_scatter(g, ctx.dim), None, None


class _GangAllGather(torch.autograd.Function):
    """Every rank's all-gather of a thread gang as one node: inputs the
    ranks' tensors, outputs what each rank receives (the same
    concatenation); the backward gives each rank's input its block of the
    ranks' gradients summed in rank order, noting one reduce-scatter a
    rank (see `_GangAllToAll`)."""

    @staticmethod
    def forward(ctx, dim: int, *parts: torch.Tensor):
        ctx.dim = dim
        full = _concat(parts, dim)
        return tuple(full.clone() for _ in parts)

    @staticmethod
    def backward(ctx, *grads: torch.Tensor):
        n = len(grads)
        out = []
        for r in range(n):
            with _call("reduce-scatter", _nbytes(grads[r])):
                out.append(_sum_in_order([g.chunk(n, ctx.dim)[r]
                                          for g in grads]))
        return (None, *out)


class _GangCopy(torch.autograd.Function):
    """Every rank's `copy_sum_grad` of a thread gang as one node: each
    output is its rank's input; each input's gradient is the ranks'
    gradients summed in rank order, noting one all-reduce a rank."""

    @staticmethod
    def forward(ctx, *parts: torch.Tensor):
        return tuple(p.view_as(p) for p in parts)

    @staticmethod
    def backward(ctx, *grads: torch.Tensor):
        out = []
        for g in grads:
            with _call("all-reduce", _nbytes(g)):
                out.append(_sum_in_order(grads))
        return tuple(out)


class _LinkedHandoff(torch.autograd.Function):
    """A tensor a rank of a gang of threads received as it was sent: the
    identity, whose backward notes the two p2p calls a process gang makes
    to hand its cotangent back (this rank's send of it, the sender's
    receive), in the thread that runs the backward."""

    @staticmethod
    def forward(ctx, t: torch.Tensor):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        with _call("p2p", _nbytes(g)):
            pass
        with _call("p2p", 0):
            pass
        return g


class Comm:
    """One rank's handle on a group (see the module note). Subclasses give
    `_all_gather`, `_all_to_all`, `_broadcast`, `_broadcast_object`,
    `_send` and `_recv`; the public methods note each call. `shares_graph`:
    a received tensor is the sender's own (its autograd history included),
    as on a gang of threads."""

    rank: int = 0
    size: int = 1
    shares_graph: bool = False

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' tensors concatenated on `dim`, in rank order."""
        if self.size == 1:
            return t
        with _call("all-gather", _nbytes(t)):
            return self._all_gather(t, dim)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' tensors summed in rank order (a new tensor)."""
        if self.size == 1:
            return t
        with _call("all-reduce", _nbytes(t)):
            parts = self._all_gather(t.unsqueeze(0), 0)
            return _sum_in_order(parts.unbind(0))

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' tensors' elementwise max (a new tensor)."""
        if self.size == 1:
            return t
        with _call("all-reduce", _nbytes(t)):
            return self._all_gather(t.unsqueeze(0), 0).amax(0)

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of `dim` (`size` equal blocks) of the ranks'
        tensors summed (a new tensor; the backend's reduce-scatter)."""
        if self.size == 1:
            return t
        if t.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} cannot be "
                             f"split over {self.size} ranks")
        with _call("reduce-scatter", _nbytes(t)):
            return self._reduce_scatter(t, dim)

    def all_gather_grad(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """`all_gather`, differentiable: the backward reduce-scatters the
        gradient to this rank's block (the ranks' gradients summed)."""
        if self.size == 1:
            return t
        return _AllGather.apply(t, self, dim)

    def all_to_all(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Chunk r of `dim` of every rank's `t` (`size` equal chunks) to
        rank r: the chunks it receives concatenated on `dim`, in rank
        order (a new tensor of `t`'s shape)."""
        if self.size == 1:
            return t
        if t.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} cannot be "
                             f"split over {self.size} ranks")
        with _call("all-to-all", _nbytes(t)):
            return self._all_to_all(t, dim)

    def all_to_all_grad(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """`all_to_all`, differentiable: the backward is the inverse
        exchange, the gradients' all-to-all on the same dim."""
        if self.size == 1:
            return t
        return _AllToAll.apply(t, self, dim)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """`src`'s tensor, written into `t` on every other rank."""
        if self.size == 1:
            return t
        with _call("broadcast", _nbytes(t) if self.rank == src else 0):
            return self._broadcast(t, src)

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """`src`'s picklable object (numpy arrays, ints, tuples)."""
        if self.size == 1:
            return obj
        mine = self.rank == src
        with _call("object-broadcast",
                   (lambda: len(pickle.dumps(obj))) if mine else 0):
            return self._broadcast_object(obj, src)

    def send(self, t: torch.Tensor, dst: int) -> None:
        """`t` to rank `dst` of the group (one p2p call, its bytes)."""
        with _call("p2p", _nbytes(t)):
            self._send(t, dst)

    def recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        """The tensor rank `src` sends, of `like`'s shape, dtype and
        device (one p2p call of 0 bytes sent)."""
        with _call("p2p", 0):
            return self._recv(like, src)

    def _all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        raise NotImplementedError

    def _all_to_all(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        raise NotImplementedError

    def _reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        raise NotImplementedError

    def _send(self, t: torch.Tensor, dst: int) -> None:
        raise NotImplementedError

    def _recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        raise NotImplementedError

    def _broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        raise NotImplementedError

    def _broadcast_object(self, obj: Any, src: int) -> Any:
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

    def _all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return all_gather(t, dim, self.group, self.size)

    def _all_to_all(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        # The chunks on dim 0 (the form every backend takes), then back.
        inp = t.movedim(dim, 0).contiguous()
        out = torch.empty_like(inp)
        all_to_all(out, inp, self.group)
        return out.movedim(0, dim) if dim else out

    def _reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        # The blocks on dim 0 (the form every backend takes).
        inp = t.movedim(dim, 0).contiguous()
        out = inp.new_empty((inp.shape[0] // self.size, *inp.shape[1:]))
        reduce_scatter_into(out, inp, self.group)
        return out.movedim(0, dim).contiguous() if dim else out

    def _broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        return broadcast(t, self.ranks[src], self.group)

    def _send(self, t: torch.Tensor, dst: int) -> None:
        send(t, self.ranks[dst], self.group)

    def _recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        out = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        return recv(out, self.ranks[src], self.group)

    def _broadcast_object(self, obj: Any, src: int) -> Any:
        """Two broadcasts: the pickle's length, then its bytes."""
        mine = self.rank == src
        payload = pickle.dumps(obj) if mine else b""
        n = torch.tensor([len(payload)], dtype=torch.int64,
                         device=self.device)
        self._broadcast(n, src)
        buf = (torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
               .to(self.device) if mine
               else torch.empty(int(n.item()), dtype=torch.uint8,
                                device=self.device))
        self._broadcast(buf, src)
        return obj if mine else pickle.loads(buf.cpu().numpy().tobytes())


class ThreadGroup:
    """`size` virtual ranks in one process (see the module note); `comm(r)`
    is rank r's handle. Every rank must enter every collective, in the
    same order."""

    def __init__(self, size: int, timeout: float = COLLECTIVE_TIMEOUT_S):
        self.size = int(size)
        self.timeout = timeout
        self._slots: List[Any] = [None] * self.size
        self._barrier = threading.Barrier(self.size, timeout=timeout)
        # The point-to-point mailboxes: (src, dst) -> values in send order.
        self._mail: dict = {}
        self._mail_cv = threading.Condition()

    def comm(self, rank: int) -> "ThreadComm":
        return ThreadComm(self, rank)

    def abort(self) -> None:
        """Break the barrier: every rank waiting in (or later entering) a
        collective, or waiting for a sent value, raises
        threading.BrokenBarrierError."""
        self._barrier.abort()
        with self._mail_cv:
            self._mail_cv.notify_all()

    def post(self, src: int, dst: int, value: Any) -> None:
        """Rank `src`'s value for rank `dst`, taken in send order."""
        with self._mail_cv:
            self._mail.setdefault((src, dst), []).append(value)
            self._mail_cv.notify_all()

    def take(self, src: int, dst: int) -> Any:
        """The oldest value rank `src` posted for rank `dst`, waiting for
        one at most the group's timeout."""
        with self._mail_cv:
            box = self._mail.setdefault((src, dst), [])
            if not self._mail_cv.wait_for(
                    lambda: box or self._barrier.broken, self.timeout):
                raise TimeoutError(f"rank {dst} waited {self.timeout} s "
                                   f"for rank {src}'s handoff")
            if not box:
                raise threading.BrokenBarrierError
            return box.pop(0)

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

    shares_graph = True

    def __init__(self, group: ThreadGroup, rank: int):
        self.group = group
        self.rank = int(rank)
        self.size = group.size

    def _all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return _concat(self.group.exchange(self.rank, t), dim)

    def _all_to_all(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return _chunks_to(self.group.exchange(self.rank, t), self.rank, dim)

    def all_to_all_grad(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The gang's exchange as one autograd node (see the module note):
        rank 0 builds it over every rank's `t`, each rank takes its
        output. The backward runs once for all ranks, from the one
        backward over the sum of the ranks' losses."""
        if self.size == 1:
            return t
        if t.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} cannot be "
                             f"split over {self.size} ranks")
        with _call("all-to-all", _nbytes(t)):
            parts = self.group.exchange(self.rank, t)
            outs = (_GangAllToAll.apply(dim, *parts) if self.rank == 0
                    else None)
            return self.group.exchange(self.rank, outs)[0][self.rank]

    def all_gather_grad(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The gang's all-gather as one autograd node (as
        `all_to_all_grad`): its backward, once for all ranks, gives each
        rank its block of the ranks' gradients summed."""
        if self.size == 1:
            return t
        with _call("all-gather", _nbytes(t)):
            parts = self.group.exchange(self.rank, t)
            outs = (_GangAllGather.apply(dim, *parts) if self.rank == 0
                    else None)
            return self.group.exchange(self.rank, outs)[0][self.rank]

    def copy_sum_grad(self, t: torch.Tensor) -> torch.Tensor:
        """The gang's copies as one autograd node (as `all_to_all_grad`):
        each rank's tensor as it is, its gradient the ranks' summed."""
        if self.size == 1:
            return t
        parts = self.group.exchange(self.rank, t)
        outs = _GangCopy.apply(*parts) if self.rank == 0 else None
        return self.group.exchange(self.rank, outs)[0][self.rank]

    def _broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        theirs = self.group.exchange(
            self.rank, t if self.rank == src else None)[src]
        if self.rank != src:
            t.copy_(theirs)
        return t

    def _broadcast_object(self, obj: Any, src: int) -> Any:
        return self.group.exchange(
            self.rank, obj if self.rank == src else None)[src]

    def _send(self, t: torch.Tensor, dst: int) -> None:
        self.group.post(self.rank, dst, t)

    def _recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        t = self.group.take(src, self.rank)
        return _LinkedHandoff.apply(t) if t.requires_grad else t
