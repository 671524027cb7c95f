"""The collective-budget gate: the port's counterpart of the JAX package's
parallel/hlo_gate.py.

A sharding change that doubles a gather passes every numeric test: the
numbers stay right while the step pays extra traffic between cards. The
gate pins how many collectives of each op one step runs, at a pinned
configuration, and fails on any drift, up or down (fewer than pinned means
the pin is to be moved consciously, not silently), naming each op with
its expected and actual count, as JAX's does.

What differs from JAX: the JAX gate counts the STATIC collective
instructions of a compiled step's HLO, in which a loop body (a scan over
layers, a decode chunk's steps) appears once. The port has no HLO: every
collective is a call through parallel/comm.py, so the gate counts the
CALLS one step makes on one rank at a pinned configuration (`record`).
A count therefore scales with the layers and with a decode chunk's steps,
and each pin says how (`Pin`); a GPipe step's also with its microbatches
and the rank's stage (its handoffs, the first stage's embedding). Ops are
parallel/comm.OPS: all-gather, all-reduce, reduce-scatter, all-to-all
(the expert-parallel MoE FFN's token exchange), broadcast (the
layer-stack pipeline's layers from their stage, and the GPipe result
from the last), p2p (the ring's shift, the GPipe stage handoffs) and
object-broadcast (rank 0's program header on a serving mesh).

The size gate (JAX tests/unit/test_mesh_serving.py's): in a steady decode
chunk and a verify round nothing of KV-page or weight size moves between
ranks. Each call's bytes (what this rank sends, parallel/comm.py) stay
under a cap: JAX's 1024 B for a move (all-gather, broadcast, p2p, a
header) and 4096 B for a sum where the configuration's activations fit
them, and in any configuration `row_caps`, a number of activation rows:
a sum carries at most the program's token rows of d_model f32 values, a
move at most those rows of max(d_model, vocab / tp) f32 values (the
logits' vocab block), a header at most JAX's 1024 B. The tier's demotion
and restore (models/serving.py) are the only serving programs that move a
page; their bytes are pinned exactly (`tier_calls`). A GPipe handoff
carries at most one microbatch's activation (`handoff_caps`).

The pins live in one table, `BUDGETS`, as JAX keeps its pins beside the
mesh configs; the tests read the counts from the gang jobs that already
run these programs (tests/torch_gang.py, tests/torch_serve_gang.py).
"""

from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple, Union

from .comm import OPS, listen

Calls = List[Tuple[str, int]]

# JAX's benign caps (tests/unit/test_mesh_serving.py).
BENIGN_MOVE_BYTES = 1024
BENIGN_SUM_BYTES = 4096
SUM_OPS = ("all-reduce", "reduce-scatter")


@contextlib.contextmanager
def record(this_thread: bool = False):
    """The calls (op, bytes) of every collective inside the context: the
    process's, or with `this_thread` the calling thread's only (one rank
    of a gang of threads)."""
    calls: Calls = []
    with listen(calls, this_thread):
        yield calls


def collective_counts(calls: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Calls per op."""
    return dict(Counter(op for op, _ in calls))


def collective_sizes(calls: Iterable[Tuple[str, int]]) -> Calls:
    """[(op, bytes this rank sends)] per call, in call order."""
    return [(op, int(n)) for op, n in calls]


def assert_collective_budget(got: Union[Dict[str, int], Calls],
                             expected: Dict[str, int],
                             context: str) -> Dict[str, int]:
    """Exact-match gate on the counts (`got`: counts, or the calls); raises
    with the full diff on any drift."""
    if not isinstance(got, dict):
        got = collective_counts(got)
    got = {k: v for k, v in got.items() if v}
    want = {k: v for k, v in expected.items() if v}
    unknown = set(want) - set(OPS)
    if unknown:
        raise ValueError(f"unknown collective ops {sorted(unknown)}")
    if got != want:
        drift = {op: (want.get(op, 0), got.get(op, 0))
                 for op in sorted(set(want) | set(got))
                 if want.get(op, 0) != got.get(op, 0)}
        raise AssertionError(
            f"collective budget drift in {context}: "
            + ", ".join(f"{op} expected {w} got {g}"
                        for op, (w, g) in drift.items())
            + " — a sharding change altered the collectives; fix the "
              "layout or consciously re-pin the budget")
    return got


@dataclass(frozen=True)
class Pin:
    """Calls of one op in one program call: `once`, plus for each of its
    steps (a decode chunk's; 1 elsewhere) `per_step` and `per_layer` a
    layer; in a GPipe step `per_handoff` a microbatch and neighbouring
    stage (a stage has one neighbour at either end of the pipeline, two
    between) and `first_stage` more on stage 0."""
    once: int = 0
    per_step: int = 0
    per_layer: int = 0
    per_handoff: int = 0
    first_stage: int = 0

    def count(self, n_layers: int, steps: int = 1, microbatches: int = 0,
              stage: int = 0, stages: int = 1) -> int:
        neighbours = int(stage > 0) + int(stage < stages - 1)
        return (self.once + steps * (self.per_step + self.per_layer * n_layers)
                + self.per_handoff * microbatches * neighbours
                + (self.first_stage if stage == 0 else 0))


# Serving on a (dp, tp) gang with tp > 1, counted on the driver (rank 0:
# the header, then the program): the embedding's vocab-parallel sum, the
# attention's and the MLP's tp sums a layer, the logits' gather over tp.
_SERVE_STEP = {"object-broadcast": Pin(once=1),
               "all-reduce": Pin(per_step=1, per_layer=2),
               "all-gather": Pin(per_step=1)}

# A GPipe step on every rank: the stage's 7 stacked matrices gathered
# over dp once a step and the head, stage 0 also the embedding, and their
# reduce-scatters; the result broadcast from the last stage and the pp
# grads' from pp rank 0; the handoffs, one p2p call a microbatch and
# neighbour each way (each at most one microbatch's activation); the
# replicated leaves, the norm (over dp and pp) and the loss's mean.
_GPIPE_STEP = {"all-gather": Pin(once=8, first_stage=1),
               "reduce-scatter": Pin(once=8, first_stage=1),
               "all-reduce": Pin(once=4),
               "broadcast": Pin(once=2),
               "p2p": Pin(per_handoff=2)}

# What the stage's replication over tp (the schedule on a mesh with tp)
# adds to a rank's forward and backward: the stage's 7 matrices gathered
# whole over tp (their backward moves nothing); the vocab-parallel
# embedding's sum on stage 0 and the CE's four (the head input's copy in
# the backward, the max, the sum of exponentials, the gold logit).
_GPIPE_TP = {"all-gather": Pin(once=7),
             "all-reduce": Pin(once=4, first_stage=1)}


def _plus(*pins: Dict[str, Pin]) -> Dict[str, Pin]:
    """The op-wise sum of pins."""
    out: Dict[str, Pin] = {}
    for table in pins:
        for op, p in table.items():
            q = out.get(op, Pin())
            out[op] = Pin(q.once + p.once, q.per_step + p.per_step,
                          q.per_layer + p.per_layer,
                          q.per_handoff + p.per_handoff,
                          q.first_stage + p.first_stage)
    return out


# name -> op -> Pin. Training: one train step on every rank at the pinned
# mesh and 2-layer model, as totals (JAX pins its step's at one model
# too): tests/test_torch_model_parallel.py and tests/test_torch_fsdp.py.
# Serving: one program call on the driver of the (2, 4) gang
# (tests/test_torch_mesh_serving.py), by layer and step.
BUDGETS: Dict[str, Dict[str, Pin]] = {
    # dp=2, tp=2, sp=2, batch 4 of seq 32, ring attention over sp: the
    # dp gathers of the 7 matrices a layer and the embedding and head, and
    # their reduce-scatters; the tp sums and the tp copies' backward, the
    # vocab-parallel embedding and CE, the gradient, norm and metric
    # reductions; the ring's shift a layer, forward and backward.
    "train/dp2_tp2_sp2": {"all-gather": Pin(once=16),
                          "all-reduce": Pin(once=19),
                          "reduce-scatter": Pin(once=16),
                          "p2p": Pin(once=4)},
    # The same step with use_ring_attention False: each layer's K and V
    # gathered over sp in one all-gather, whose backward reduce-scatters
    # dK and dV, where the ring shifted them.
    "train/dp2_tp2_sp2/gathered": {"all-gather": Pin(once=18),
                                   "all-reduce": Pin(once=19),
                                   "reduce-scatter": Pin(once=18)},
    # FSDP over dp=2, batch 4 of seq 16, grad_accum 1: the same gathers
    # and reduce-scatters; the replicated leaves' gradients, the norm and
    # the loss's mean over dp.
    "train/fsdp_dp2": {"all-gather": Pin(once=16),
                       "all-reduce": Pin(once=3),
                       "reduce-scatter": Pin(once=16)},
    # MoE (4 experts) over dp=2, ep=2, batch 4 of seq 32, grad_accum 1, no
    # remat (tests/test_torch_expert_parallel.py): the dp gathers of the 8
    # matrices a layer (the router's too) and the embedding and head, and
    # their reduce-scatters; the replicated leaves' gradients, the norm
    # and the metrics over dp and over ep, and each MoE layer's
    # load-balance fractions over both; the token all-to-alls, two a layer
    # forward and two backward (remat would add the recompute's two), each
    # at most E * N_local * D values of the activation dtype (the rank's
    # dispatched tokens, N_local = its rows times its positions).
    "train/dp2_ep2/moe": {"all-gather": Pin(once=18),
                          "all-reduce": Pin(once=10),
                          "reduce-scatter": Pin(once=18),
                          "all-to-all": Pin(per_layer=4)},
    # The same MoE model over dp=2, ep=2, tp=2 (JAX's MoE mesh pin), batch
    # 4 of seq 32: the gathers and reduce-scatters; the tp sums and tp
    # copies' backward (an MoE layer's combine weights add one), the
    # vocab-parallel embedding and CE, the gradient, norm and metric
    # reductions over dp, ep and tp, the fractions' means; the
    # all-to-alls, at the same cap.
    "train/dp2_ep2_tp2/moe": {"all-gather": Pin(once=18),
                              "all-reduce": Pin(once=26),
                              "reduce-scatter": Pin(once=18),
                              "all-to-all": Pin(per_layer=4)},
    # Layer-stack pp (dense, no remat) over dp=2, pp=2, one layer a stage,
    # batch 8 of seq 32 (tests/test_torch_gpipe.py): FSDP's 16 gathers; the
    # reduce-scatters of the rank's own layer's 7 matrices and the
    # embedding and head (a received layer has no gradient to scatter);
    # each layer's 9 leaves broadcast from their stage, and the
    # pp-replicated leaves' gradients from pp rank 0; the norm adds its
    # sum over pp.
    "train/dp2_pp2": {"all-gather": Pin(once=16),
                      "all-reduce": Pin(once=4),
                      "reduce-scatter": Pin(once=9),
                      "broadcast": Pin(once=1, per_layer=9)},
    # The MoE model (4 experts) on dp=2, pp=2, ep=2, batch 8 of seq 32:
    # train/dp2_ep2/moe's collectives with the layers' reduce-scatters on
    # their stage only, 10 leaves a layer broadcast (the router's too),
    # the pp grads' broadcast and the norm's sum over pp.
    "train/dp2_pp2_ep2/moe": {"all-gather": Pin(once=18),
                              "all-reduce": Pin(once=11),
                              "reduce-scatter": Pin(once=10),
                              "all-to-all": Pin(per_layer=4),
                              "broadcast": Pin(once=1, per_layer=10)},
    # The explicit GPipe schedule (dense, M microbatches) on pp=2 and on
    # dp=2, pp=2 (a dp of 1 gathers and scatters over its group of one, so
    # both meshes make the same calls), batch 8 of seq 32.
    "train/gpipe/pp2": _GPIPE_STEP,
    "train/gpipe/dp2_pp2": _GPIPE_STEP,
    # The same on dp=2, pp=2, ep=2: the ep-replicated leaves' gradients,
    # the norm and the loss's mean over ep add three all-reduces.
    "train/gpipe/dp2_pp2_ep2": {**_GPIPE_STEP, "all-reduce": Pin(once=7)},
    # The schedule on pp=2, tp=2, sp=2 (the stage replicated over tp and
    # sp, as JAX's), batch 8 of seq 16: _GPIPE_STEP's calls and
    # _GPIPE_TP's, the norm's sum over tp and the loss's mean over sp. No
    # sp average of the gradients and no KV sum over tp.
    "train/gpipe/pp2_tp2_sp2": _plus(_GPIPE_STEP, _GPIPE_TP,
                                     {"all-reduce": Pin(once=2)}),
    # The same with one KV head (kv_replicated): wk and wv are whole on
    # every tp rank already, two gathers fewer.
    "train/gpipe/pp2_tp2_sp2/kv_replicated": _plus(
        _GPIPE_STEP, _GPIPE_TP, {"all-reduce": Pin(once=2),
                                 "all-gather": Pin(once=-2)}),
    # One rank's forward and backward through `gpipe_lm_loss` on a (pp=2,
    # tp=2) gang of threads (`StageLayout` with a tp `Comm`: the card's
    # virtual tp gang; no dp axis, no optimizer step): _GPIPE_TP's calls,
    # the result's broadcast from the last stage and the handoffs.
    "train/gpipe/pp2_tp2/threads": _plus(
        _GPIPE_TP, {"broadcast": Pin(once=1), "p2p": Pin(per_handoff=2)}),
    "serve/prefill_chunk": _SERVE_STEP,
    "serve/decode_chunk/paged": _SERVE_STEP,
    # MoE on a tp serving mesh: every rank holds every expert's MLP block,
    # the router whole; the dense route's partial output rides the MLP's
    # tp sum. No collective added.
    "serve/decode_chunk/paged/moe": _SERVE_STEP,
    # The dense engine's slots over dp: a chunk's packed tokens gathered
    # over dp once.
    "serve/decode_chunk/dense": {**_SERVE_STEP,
                                 "all-gather": Pin(once=1, per_step=1)},
    "serve/verify_round/paged": _SERVE_STEP,
    "serve/verify_round/dense": {**_SERVE_STEP,
                                 "all-gather": Pin(once=1, per_step=1)},
    # The host tier: a demotion gathers each leaf's KV-head shards over tp
    # (none under the GQA fallback); a restore broadcasts each leaf.
    "serve/kv_demote": {"object-broadcast": Pin(once=1),
                        "all-gather": Pin(once=2)},
    "serve/kv_demote/int8": {"object-broadcast": Pin(once=1),
                             "all-gather": Pin(once=4)},
    "serve/kv_demote/gqa": {"object-broadcast": Pin(once=1)},
    "serve/kv_restore": {"object-broadcast": Pin(once=1),
                         "broadcast": Pin(once=2)},
    "serve/kv_restore/int8": {"object-broadcast": Pin(once=1),
                              "broadcast": Pin(once=4)},
}


def expected(name: str, n_layers: int = 2, steps: int = 1,
             microbatches: int = 0, stage: int = 0, stages: int = 1
             ) -> Dict[str, int]:
    """The pinned counts of `name` at `n_layers` and `steps` (a GPipe
    step's: at `microbatches`, on stage `stage` of `stages`)."""
    return {op: pin.count(n_layers, steps, microbatches, stage, stages)
            for op, pin in BUDGETS[name].items()}


def handoff_caps(rows: int, seq: int, d_model: int, itemsize: int
                 ) -> Dict[str, int]:
    """A GPipe handoff's cap: one microbatch's activation, `rows` (the
    rank's rows of a microbatch) x `seq` x `d_model` values of
    `itemsize` bytes."""
    return {"p2p": rows * seq * d_model * itemsize}


def row_caps(rows: int, d_model: int, vocab: int, tp: int) -> Dict[str, int]:
    """Per-op byte caps of a serving program over `rows` token rows (slots
    times the tokens a step): a sum at most rows of d_model f32 values, a
    move at most rows of the wider of d_model and the vocab block, a
    header at most JAX's move cap."""
    move = rows * max(d_model, vocab // tp) * 4
    return {"all-reduce": rows * d_model * 4, "reduce-scatter":
            rows * d_model * 4, "all-gather": move, "broadcast": move,
            "p2p": move, "object-broadcast": BENIGN_MOVE_BYTES}


def jax_caps() -> Dict[str, int]:
    """JAX's caps: 4096 B for a sum, 1024 B for a move."""
    return {op: BENIGN_SUM_BYTES if op in SUM_OPS else BENIGN_MOVE_BYTES
            for op in OPS}


def assert_sizes_within(calls: Iterable[Tuple[str, int]],
                        caps: Dict[str, int], context: str) -> None:
    """Every call within its op's cap; raises naming the calls over it."""
    big = [(op, n) for op, n in calls if n > caps.get(op, 0)]
    if big:
        raise AssertionError(
            f"{context}: collective(s) of KV-page or weight magnitude {big} "
            f"over the caps {caps} — steady state must never move (or "
            f"reduce) pool pages or params between ranks")


def tier_calls(name: str, n_layers: int, block_len: int, kv_heads: int,
               head_dim: int, itemsize: int, tp: int,
               int8: bool = False) -> List[Tuple[str, int]]:
    """The tier's page traffic on the driver, sorted, without the header:
    a demotion's all-gathers of each leaf's tp shard, a restore's
    broadcasts of each assembled leaf. int8 pages carry their f32 scale
    rows as two more leaves."""
    rows = n_layers * block_len * kv_heads
    leaves = [rows * head_dim * itemsize] * 2
    if int8:
        leaves = [rows * head_dim] * 2 + [rows * 4] * 2
    if name == "serve/kv_demote":
        out = [("all-gather", n // tp) for n in leaves] if tp > 1 else []
    elif name == "serve/kv_restore":
        out = [("broadcast", n) for n in leaves]
    else:
        raise ValueError(name)
    return sorted(out)
