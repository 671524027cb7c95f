"""Runtime program-event sentinel: after warm-up, a serving process must
never make a program again.

Port of k8s_gpu_workload_enhancer_tpu/analysis/compilewatch.py. The JAX
package counts XLA backend compiles through a `jax.monitoring` listener;
the port's programs are made by two things, which report here through one
hook call, `record(kind, what, seconds)`:

- `capture`: a CUDA-graph capture (models/decode_graph.py `DecodeGraph`:
  the decode chunk, the decode quantum, the verify round);
- `kernel_build` / `kernel_load`: a kernel library compiled by `nvcc`
  (ops/kernels.py `build`) or loaded into the process for the first time
  (`library`).

An engine's shape discipline promises a fixed set of them: after warm-up
(the first traffic through each path) a steady-state capture or build is
hundreds of milliseconds to seconds of dead air. The same gating as the
JAX module:

    from k8s_gpu_workload_enhancer_tpu_torch.analysis import compilewatch
    compilewatch.enable()          # or KTWE_COMPILE_SENTINEL=1
    ... warm the engine ...
    compilewatch.mark_warm("after warm-up")
    ... steady-state traffic ...
    compilewatch.verify()          # raises on any post-warm event

- with the env var unset and no `enable(force=True)` the hook is inert:
  one check a call, nothing recorded;
- every event AFTER `mark_warm()` is recorded with a short stack summary
  (the port's frames nearest the trigger); `verify()` raises
  `CompileSentinelError` listing them;
- under the env var an atexit hook fails the process (exit 71) if any
  was recorded, so soak rigs fail loudly.
"""

from __future__ import annotations

import atexit
import collections
import os
import sys
import threading
import traceback
from typing import Dict, List, Optional

ENV_VAR = "KTWE_COMPILE_SENTINEL"
_EXIT_CODE = 71   # the JAX package's locktrace exits 70; keep them apart
_PACKAGE = "k8s_gpu_workload_enhancer_tpu_torch"


class CompileSentinelError(AssertionError):
    pass


_guard = threading.Lock()
_forced = False
_registered_atexit = False
_total = 0
_by_kind: collections.Counter = collections.Counter()
_warm_note: Optional[str] = None
_post_warm: List[str] = []


def enabled() -> bool:
    return _forced or bool(os.environ.get(ENV_VAR))


def _stack_summary(limit: int = 4) -> str:
    frames = [f for f in traceback.extract_stack()
              if _PACKAGE in f.filename
              and "analysis/compilewatch" not in f.filename.replace(
                  "\\", "/")]
    tail = frames[-limit:] if frames else []
    return " <- ".join(
        f"{os.path.basename(f.filename)}:{f.lineno} in {f.name}"
        for f in reversed(tail)) or "(no repo frames on stack)"


def record(kind: str, what: str, seconds: float) -> None:
    """The hook: one program event (`capture`, `kernel_build`,
    `kernel_load`) of `what`, which took `seconds`. Inert unless
    enabled."""
    if not enabled():
        return
    global _total
    with _guard:
        _total += 1
        _by_kind[kind] += 1
        if _warm_note is not None:
            _post_warm.append(
                f"{kind} #{_total} of {what} ({seconds * 1e3:.1f} ms) after "
                f"warm mark {_warm_note!r}: {_stack_summary()}")


def enable(force: bool = True) -> None:
    """Turn the sentinel on for this process (idempotent)."""
    global _forced
    _forced = force
    if force or os.environ.get(ENV_VAR):
        _ensure_atexit()


def disable() -> None:
    global _forced
    _forced = False


def reset() -> None:
    """Drop counts and the warm mark (between test cases)."""
    global _total, _warm_note
    with _guard:
        _total = 0
        _by_kind.clear()
        _warm_note = None
        _post_warm.clear()


def mark_warm(note: str = "warmup complete") -> None:
    """Declare the engine warm: every event from here on is a
    steady-state one and a violation."""
    global _warm_note
    with _guard:
        _warm_note = note
        _post_warm.clear()


def compiles_total() -> int:
    """Every program event recorded while enabled."""
    with _guard:
        return _total


def counts() -> Dict[str, int]:
    """The recorded events by kind."""
    with _guard:
        return dict(_by_kind)


def post_warm_compiles() -> List[str]:
    with _guard:
        return list(_post_warm)


def verify() -> None:
    """Raise CompileSentinelError on any event recorded after
    mark_warm()."""
    bad = post_warm_compiles()
    if bad:
        raise CompileSentinelError(
            "steady-state capture(s) or kernel build(s) detected; the "
            "engine's fixed-program discipline is broken:\n"
            + "\n".join(bad))


def _ensure_atexit() -> None:
    global _registered_atexit
    if _registered_atexit or not os.environ.get(ENV_VAR):
        return   # atexit enforcement only under the env gate; test
    _registered_atexit = True   # suites call verify() explicitly.

    def _check() -> None:
        try:
            verify()
        except CompileSentinelError as e:
            print(f"[compilewatch] {e}", file=sys.stderr, flush=True)
            os._exit(_EXIT_CODE)

    atexit.register(_check)


# Arm on import when the env gate is already set, so processes launched
# with KTWE_COMPILE_SENTINEL=1 count from the first event.
if os.environ.get(ENV_VAR):
    enable(force=False)
