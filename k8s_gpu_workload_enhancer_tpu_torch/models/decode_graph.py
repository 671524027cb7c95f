"""The decode chunk as one CUDA graph.

The port's counterpart of the JAX engine's jitted `_decode_chunk` /
`_decode_chunk_paged` (k8s_gpu_workload_enhancer_tpu/models/serving.py):
JAX compiles a chunk of `decode_chunk` steps once and dispatches it as one
program; the port captures the same chunk once as a `torch.cuda.CUDAGraph`
and replays it, one launch from the host where the eager chunk issues
every kernel of every step from Python.

The captured program reads and writes only static storage: the engine's
device slot mirrors, its Gumbel noise buffer, the paged block table, the
cache (with an int8 cache's scales) and the params (models/serving.py
`_run_chunk`). The engine writes those in place between replays, on the
same stream, so stream order and no sync separates an admission's writes
from the chunks around it.

A speculative engine captures its verify round the same way, as one more
graph (`_run_verify`, the counterpart of the JAX engine's jitted
`_spec_verify_chunk[_paged]`): its inputs are the static (B, k+1) block,
whose draft columns the host fills before each replay, and the draft
lengths; it writes the packed round and the slot mirrors. No `.item()` or
host branch runs inside it.

The first replay captures. Its warm-up pass, run eagerly on a side stream
as CUDA graphs ask (libraries and workspaces initialise outside the
capture), IS the engine's first chunk: the state it advances is the real
state, and its kernel launches are real launches of the main path. The
capture pass itself executes nothing and launches nothing: the launch
counts it adds to `ops/kernels.launches` are taken back and kept as the
graph's per-replay counts, added once per replay, so `kernels.launches`
counts what ran. A capture or a replay that fails raises; nothing falls
back to eager launches. Each capture reports to the program-event
sentinel (analysis/compilewatch.py, inert unless enabled).
"""

from __future__ import annotations

import collections
import gc
import time
from typing import Callable, Optional

import torch

from ..analysis import compilewatch
from ..ops import kernels


class DecodeGraph:
    """A chunk program captured once as a CUDA graph on `device` and
    replayed. `replay(run)` takes the program (a closure over static
    storage, returning nothing) on every call and uses it only to capture,
    so the graph holds no reference to its owner. `captures` and
    `replays` count what happened (the warm-up pass is neither). The
    graph reads the storage it captured, so the owner writes new inputs,
    new weights included, into that storage in place. `name` labels the
    graph's captures for the sentinel."""

    def __init__(self, device: torch.device, name: str = "decode chunk"):
        self.device = device
        self.name = name
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        # Kernel launches of one replay, by wrapper name.
        self.launches: collections.Counter = collections.Counter()
        self.captures = 0
        self.replays = 0
        # Host ms of the last capture, its warm-up pass included.
        self.capture_ms = 0.0

    def replay(self, run: Callable[[], None]) -> None:
        """Run the chunk: capture `run` on the first call (its warm-up
        pass runs the chunk), replay the captured graph after."""
        if self._graph is None:
            self._capture(run)
            return
        self._graph.replay()
        self.replays += 1
        kernels.launches.update(self.launches)

    def reset(self) -> None:
        """Drop the captured graph: the storage it reads was replaced (a
        device-state rebuild), so the next replay captures again."""
        self._graph = None
        self.launches = collections.Counter()

    def _capture(self, run: Callable[[], None]) -> None:
        t0 = time.perf_counter()
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            run()                                # the warm-up: this chunk
        stream.wait_stream(side)
        before = collections.Counter(kernels.launches)
        graph = torch.cuda.CUDAGraph()
        capture_stream = torch.cuda.Stream(self.device)
        capture_stream.wait_stream(stream)
        # No garbage collection inside the capture: a collected object that
        # frees CUDA resources (an old engine's graph, pinned buffer or
        # event) would make a call the capture forbids. (torch.cuda.graph
        # would also collect, empty the allocator's cache and synchronize
        # first, costing more than the capture itself; none is needed.)
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(capture_stream):
                # thread_local: a weight load on another thread (the reload
                # route, the checkpoint watcher) must not void the capture.
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    run()
                finally:
                    graph.capture_end()
        finally:
            if gc_was_on:
                gc.enable()
            captured = collections.Counter(kernels.launches)
            captured.subtract(before)
            kernels.launches.clear()
            kernels.launches.update(before)
        self.launches = +captured                # positive counts only
        self._graph = graph
        self.captures += 1
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        compilewatch.record("capture", self.name, self.capture_ms / 1e3)
