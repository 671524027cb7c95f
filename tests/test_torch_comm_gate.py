"""The port's collective-budget gate (parallel/comm_gate.py) and its choke
point (parallel/comm.py), the cases of the JAX package's
tests/unit/test_hlo_gate.py.

- Counts and sizes: a recording of known calls (every `Comm` op on a
  thread gang of two, and the dist-level calls on a gloo group of one)
  counts each op once, a call inside another once (a rank-ordered sum's
  gathers, an object broadcast's two broadcasts), with the bytes the rank
  sends; a thread gang's ranks each see their own calls; nothing is noted
  outside a recording.
- Drift raises both ways, naming each op with its expected and actual
  count as JAX's message does; the budget table's pins scale with layers
  and steps as stated; the tier's page bytes and the row caps.
- The choke point: no port module outside parallel/comm.py calls a
  torch.distributed collective (a grep, in the manner of
  tests/test_torch_isolation.py).
"""

import datetime
import pathlib
import re
import socket
import threading

import pytest
import torch
import torch.distributed as dist

from k8s_gpu_workload_enhancer_tpu.parallel import hlo_gate as jgate
from k8s_gpu_workload_enhancer_tpu_torch.parallel import comm, comm_gate
from k8s_gpu_workload_enhancer_tpu_torch.parallel.comm import ThreadGroup

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "k8s_gpu_workload_enhancer_tpu_torch"

# The JAX test's snippet and the calls a recording of the same program
# gives here.
SNIPPET = """
  %ag = f32[8,16] all-gather(%p0), replica_groups={...}
  %ar.1 = f32[8] all-reduce(%x), to_apply=%sum
  %cps = (f32[4], f32[4]) collective-permute-start(%y)
  %cpd = f32[4] collective-permute-done(%cps)
  %rs = f32[2,16] reduce-scatter(%z), dimensions={0}
"""
CALLS = [("all-gather", 8 * 16 * 4), ("all-reduce", 8 * 4),
         ("p2p", 2 * 4 * 4), ("reduce-scatter", 2 * 16 * 4)]
JAX_NAMES = {"all-gather": "all-gather", "all-reduce": "all-reduce",
             "p2p": "collective-permute", "reduce-scatter": "reduce-scatter"}


def on_threads(n: int, fn):
    group = ThreadGroup(n, timeout=30)
    out, errors = [None] * n, []

    def one(r):
        try:
            out[r] = fn(group.comm(r))
        except BaseException as e:            # noqa: BLE001 — reported
            errors.append(e)
            group.abort()
    threads = [threading.Thread(target=one, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errors:
        raise errors[0]
    return out


def test_counts_and_sizes_match_the_jax_parse_of_the_same_program():
    """The JAX gate's counts and result sizes of its snippet equal the
    port's of the calls of the same collectives."""
    jcounts = jgate.collective_counts(SNIPPET)
    jsizes = dict(jgate.collective_result_sizes(SNIPPET))
    got = comm_gate.collective_counts(CALLS)
    assert {JAX_NAMES[k]: v for k, v in got.items()} == jcounts
    assert {JAX_NAMES[op]: n for op, n in
            comm_gate.collective_sizes(CALLS)} == jsizes


def test_a_thread_gangs_calls_are_counted_once_with_their_bytes():
    """Every Comm op on a thread gang of two: one call each, the bytes the
    rank sends (a broadcast's and an object broadcast's on the source
    only, an all-to-all's whole input); the sum's gathers and nothing
    outside the recording noted."""
    def rank(c):
        t = torch.arange(6, dtype=torch.float32).reshape(2, 3) + c.rank
        c.all_reduce_sum(t)                    # outside: not noted
        with comm_gate.record(this_thread=True) as calls:
            s = c.all_reduce_sum(t)
            g = c.all_gather(t, 1)
            a = c.all_to_all(t, 0)
            b = c.broadcast(t.clone(), 0)
            o = c.broadcast_object(("hdr", c.rank), 0)
        return calls, s, g, a, b, o
    out = on_threads(2, rank)
    for r, (calls, s, g, a, b, o) in enumerate(out):
        assert comm_gate.collective_counts(calls) == {
            "all-reduce": 1, "all-gather": 1, "all-to-all": 1,
            "broadcast": 1, "object-broadcast": 1}
        sizes = dict(calls)
        assert sizes["all-reduce"] == sizes["all-gather"] == \
            sizes["all-to-all"] == 24
        assert sizes["broadcast"] == (24 if r == 0 else 0)
        assert (sizes["object-broadcast"] > 0) == (r == 0)
        base = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        assert torch.equal(s, base + (base + 1))
        assert g.shape == (2, 6) and torch.equal(b, base)
        # Rank r's row r of each rank's t, in rank order.
        assert torch.equal(a, torch.stack([base[r], base[r] + 1]))
        assert o == ("hdr", 0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_the_dist_level_calls_on_a_group_of_one():
    """The choke point's torch.distributed calls on a gloo group of one:
    one call each, the bytes sent, a ProcessComm's object broadcast once
    (not its two tensor broadcasts), a process-wide recording. (gloo has
    no p2p to itself: the ring's exchanges are counted in the training
    gang's budget, tests/test_torch_model_parallel.py.)"""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        t = torch.ones(4, 8)
        out = torch.empty(4, 8)
        with comm_gate.record() as calls:
            comm.all_reduce(t)
            comm.all_reduce(t, op="max")
            comm.all_gather_into(out, t, None)
            comm.reduce_scatter_into(out, t, None)
            comm.broadcast(t, 0)
            comm.all_to_all(out, t, None)
            pc = comm.ProcessComm()
            pc.size = 2               # a group of one speaking as two
            pc.broadcast_object({"k": 1}, 0)
        assert comm_gate.collective_sizes(calls)[:6] == [
            ("all-reduce", 128), ("all-reduce", 128), ("all-gather", 128),
            ("reduce-scatter", 128), ("broadcast", 128), ("all-to-all", 128)]
        assert torch.equal(out, t)
        assert comm_gate.collective_counts(calls) == {
            "all-reduce": 2, "all-gather": 1, "reduce-scatter": 1,
            "all-to-all": 1, "broadcast": 1, "object-broadcast": 1}
    finally:
        dist.destroy_process_group()


def test_budget_drift_raises_both_directions():
    ok = {"all-gather": 1, "all-reduce": 1, "p2p": 1, "reduce-scatter": 1}
    assert comm_gate.assert_collective_budget(CALLS, ok, "t") == ok
    assert comm_gate.assert_collective_budget(
        comm_gate.collective_counts(CALLS), ok, "t") == ok
    with pytest.raises(AssertionError, match="all-gather expected 2 got 1"):
        comm_gate.assert_collective_budget(CALLS, {**ok, "all-gather": 2},
                                           "t")
    with pytest.raises(AssertionError, match="p2p expected 0 got 1"):
        comm_gate.assert_collective_budget(CALLS, {**ok, "p2p": 0}, "t")
    with pytest.raises(AssertionError, match=r"collective budget drift in "
                       r"ctx: broadcast expected 1 got 0, reduce-scatter "
                       r"expected 0 got 1"):
        comm_gate.assert_collective_budget(
            CALLS, {**ok, "reduce-scatter": 0, "broadcast": 1}, "ctx")
    with pytest.raises(ValueError, match="unknown collective ops"):
        comm_gate.assert_collective_budget(CALLS, {"ragged-all-to-all": 1},
                                           "t")


def test_pins_scale_with_layers_and_steps():
    """A decode chunk of 8 steps at 3 layers: the header once, a tp sum
    for the embedding and two a layer, the logits' gather, each step; a
    dense chunk gathers its packed tokens over dp once more."""
    assert comm_gate.expected("serve/decode_chunk/paged", 3, 8) == {
        "object-broadcast": 1, "all-reduce": 8 * 7, "all-gather": 8}
    assert comm_gate.expected("serve/decode_chunk/dense", 3, 8)[
        "all-gather"] == 9
    assert comm_gate.expected("serve/verify_round/paged", 2) == \
        comm_gate.expected("serve/prefill_chunk", 2) == {
            "object-broadcast": 1, "all-reduce": 5, "all-gather": 1}
    assert comm_gate.expected("train/fsdp_dp2") == {
        "all-gather": 16, "all-reduce": 3, "reduce-scatter": 16}
    # The ep steps' all-to-alls scale with the MoE layers: 4 a layer.
    assert comm_gate.expected("train/dp2_ep2/moe", 3)["all-to-all"] == 12
    assert set(op for pins in comm_gate.BUDGETS.values()
               for op in pins) <= set(comm.OPS)


def test_tier_calls_and_caps():
    """The tier's page bytes: a demotion's per-leaf tp shards, a restore's
    whole leaves, int8 pages with their f32 scale rows; the row caps."""
    assert comm_gate.tier_calls("serve/kv_demote", 2, 8, 4, 8, 4, 4) == [
        ("all-gather", 512)] * 2
    assert comm_gate.tier_calls("serve/kv_demote", 2, 8, 2, 8, 4, 1) == []
    assert comm_gate.tier_calls("serve/kv_restore", 2, 8, 4, 8, 4, 4,
                                int8=True) == sorted(
        [("broadcast", 512)] * 2 + [("broadcast", 256)] * 2)
    caps = comm_gate.row_caps(8, 2048, 32768, 4)
    assert caps["all-reduce"] == 8 * 2048 * 4
    assert caps["all-gather"] == 8 * 8192 * 4
    assert caps["object-broadcast"] == comm_gate.BENIGN_MOVE_BYTES
    comm_gate.assert_sizes_within([("all-reduce", 4096)],
                                  comm_gate.jax_caps(), "t")
    with pytest.raises(AssertionError, match="KV-page or weight magnitude"):
        comm_gate.assert_sizes_within([("all-gather", 1025)],
                                      comm_gate.jax_caps(), "t")


# torch.distributed's collectives and p2p calls, by name.
_COLLECTIVES = (r"all_reduce\w*|all_gather\w*|reduce_scatter\w*|broadcast\w*"
                r"|batch_isend_irecv|isend|irecv|send|recv|P2POp|reduce|gather"
                r"|scatter\w*|all_to_all\w*|barrier|monitored_barrier")
_CALL = re.compile(r"\b(?:dist|torch\.distributed)\.(" + _COLLECTIVES
                   + r")\b")
_IMPORT = re.compile(r"from\s+torch\.distributed(?:\.distributed_c10d)?\s+"
                     r"import\s+[^\n]*\b(" + _COLLECTIVES + r")\b")


def test_no_port_module_calls_a_collective_outside_the_choke_point():
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        if path == PORT / "parallel" / "comm.py":
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("#", 1)[0]
            if _CALL.search(code) or _IMPORT.search(code):
                offenders.append(f"{path.relative_to(ROOT)}:{i}: {line}")
    assert not offenders, "\n".join(offenders)
    # The grep sees a direct call where one is written.
    assert _CALL.search("    dist.all_reduce(x, group=g)")
    assert _CALL.search("torch.distributed.batch_isend_irecv(ops)")
    assert not _CALL.search("dist.get_rank(group)")
