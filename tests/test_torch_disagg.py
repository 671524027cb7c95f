"""Chunked prefill with the decode quantum, the disaggregated prefill/decode
roles and the drain grace on the port, held to the JAX package.

- `prefill_chunk_tokens` replaces prefill_len as the prompt slice and drops
  decode to the quantum, max(1, decode_chunk // 4) steps, while a prefill
  backlog exists: the port's chunked engine gives the JAX engine's greedy
  tokens, prefill chunks, decode steps and KV bookkeeping exactly, dense and
  paged (4-token slices over 8-token pages included); the quantum is exactly
  2 steps under a backlog, then full chunks resume; the quantum runs its own
  graph (a CPU stand-in for the card's) and a preempt drops a victim's
  quantum in flight as it drops a full chunk.
- `handoff_first_token` (the prefill role): each request leaves after
  exactly its first token as a reason "handoff" resume state, counted, with
  no decode step and no graph; a decode engine continues it to the JAX
  engine's uninterrupted tokens; a request of one token finishes normally.
  The port's ServeService advertises the role, and the JAX FleetRouter
  splices a torch prefill replica's stream onto a torch decode replica over
  HTTP with no migration budget.
- The serve main: `--prefill-chunk-tokens` refused as the JAX main refuses
  it (same messages, exit 2), `--disagg`, `--prefill-chunk-tokens` and
  `--drain-eject-grace` from `--config` (a bare `off` is the choice "off"),
  the grace against the JAX main's arithmetic, and a SIGTERM run whose
  stream gets its migrate frame at the grace, long before the drain's
  deadline.

tests/torch_parity.py dims, f32, on the CPU.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from k8s_gpu_workload_enhancer_tpu.autopilot import knobs as jknobs
from k8s_gpu_workload_enhancer_tpu.cmd import serve as jserve
from k8s_gpu_workload_enhancer_tpu.fleet.registry import ReplicaRegistry
from k8s_gpu_workload_enhancer_tpu.fleet.router import FleetRouter
from k8s_gpu_workload_enhancer_tpu.fleet.wire import validate_frame
from k8s_gpu_workload_enhancer_tpu.models import serving as jsrv
from k8s_gpu_workload_enhancer_tpu_torch.cmd import serve
from k8s_gpu_workload_enhancer_tpu_torch.models import serving as tsrv
from k8s_gpu_workload_enhancer_tpu_torch.utils.config import parse_with_config

import test_torch_serve_fleet as fleet
import torch_parity as tp
from test_torch_serve_fleet import Replica

REPO = Path(__file__).resolve().parents[1]
PROMPT = [40, 2, 7, 1, 3]
N = 40
KINDS = [False, True]
KIND_IDS = ["dense", "paged"]


@pytest.fixture(scope="module")
def model():
    return tp.model()


def port_engine(model, *, paged=False, **kw):
    _, _, cfg, params = model
    kw = {"num_slots": 2, "decode_chunk": 4, "prefill_len": 8, **kw}
    if paged:
        kw["kv_block_len"] = 8
    return tsrv.ContinuousBatchEngine(params, cfg, device="cpu", **kw)


def jax_engine(model, *, paged=False, **kw):
    jcfg, jp, _, _ = model
    kw = {"num_slots": 2, "decode_chunk": 4, "prefill_len": tp.PREFILL_LEN,
          **kw}
    if paged:
        kw["kv_block_len"] = 8
    return jsrv.ContinuousBatchEngine(jp, jcfg, **kw)


def uninterrupted(eng, prompt=PROMPT, n=N):
    rid = eng.submit(prompt, n)
    eng.run()
    return eng.result(rid).tokens


def bookkeeping(eng) -> dict:
    m = eng.metrics()
    return {"lifetime": {k: m["lifetime"][k] for k in
                         ("completed", "tokens", "decode_steps",
                          "prefill_chunks")},
            "kv_cache": m["kv_cache"], "migration": m["migration"]}


# ------------------------------------------------------- chunked prefill

STAGGERED = ([[3, 17, 29, 5], list(range(2, 34)), [40, 2, 77]], [12, 10, 9])


def staggered(eng):
    """The JAX pin's arrivals: r0 decoding when the long prompt arrives,
    a third request a step later."""
    prompts, lens = STAGGERED
    r0 = eng.submit(prompts[0], lens[0])
    eng.step()
    r1 = eng.submit(prompts[1], lens[1])
    eng.step()
    r2 = eng.submit(prompts[2], lens[2])
    eng.run()
    return [eng.result(r).tokens for r in (r0, r1, r2)]


@pytest.mark.parametrize("paged", KINDS, ids=KIND_IDS)
def test_chunked_prefill_outputs_bitwise_identical(model, paged):
    """prefill_chunk_tokens moves the schedule, never the tokens: the
    port's plain and chunked engines give the JAX engine's greedy tokens,
    and the chunked engine's prefill chunks, decode steps and KV
    bookkeeping equal the JAX chunked engine's. Paged: 4-token slices over
    8-token pages, the grid the flag makes reachable."""
    kw = dict(num_slots=2, prefill_len=16, decode_chunk=4, paged=paged)
    jplain, jchunked = (jax_engine(model, **kw),
                        jax_engine(model, prefill_chunk_tokens=4, **kw))
    want = staggered(jplain)
    assert staggered(jchunked) == want
    plain = port_engine(model, **kw)
    chunked = port_engine(model, prefill_chunk_tokens=4, **kw)
    assert staggered(plain) == want
    assert staggered(chunked) == want, "chunked prefill must not move tokens"
    assert chunked.prefill_len == 4 and chunked._decode_quantum == 1
    assert bookkeeping(chunked) == bookkeeping(jchunked)
    assert bookkeeping(plain) == bookkeeping(jplain)
    assert chunked.metrics()["lifetime"]["prefill_chunks"] > \
        plain.metrics()["lifetime"]["prefill_chunks"]


def chunk_lengths(eng) -> list:
    """Record the length of every chunk `eng` dispatches."""
    seen = []
    dispatch = eng._dispatch_chunk

    def recorded():
        inflight = dispatch()
        seen.append(inflight.n)
        return inflight
    eng._dispatch_chunk = recorded
    return seen


@pytest.mark.parametrize("paged", KINDS, ids=KIND_IDS)
def test_chunked_prefill_uses_short_decode_quantum_under_backlog(model,
                                                                 paged):
    """While a prefill backlog coexists with a decoding slot, a dispatch
    decodes the quantum, decode_chunk // 4 = 2 steps, as on the JAX
    engine; once the backlog clears, full chunks resume. Tokens, decode
    steps and prefill chunks equal the JAX engine's."""
    kw = dict(prefill_len=8, decode_chunk=8, prefill_chunk_tokens=8,
              paged=paged)
    runs = []
    port = port_engine(model, overlap_commit=False, **kw)
    seen = chunk_lengths(port)
    for eng in (port, jax_engine(model, overlap=False, **kw)):
        r0 = eng.submit([5, 6, 7], 24)
        eng.step()                       # r0 admitted + a full chunk
        steps0 = eng._decode_steps_total
        r1 = eng.submit(list(range(1, 30)), 8)    # a 4-slice prompt
        eng.step()                       # the backlog is live: a quantum
        assert eng._decode_steps_total - steps0 == eng._decode_quantum == 2
        eng.run()
        assert eng._decode_steps_total >= 24
        runs.append(([eng.result(r).tokens for r in (r0, r1)],
                     bookkeeping(eng)["lifetime"]))
    assert runs[0] == runs[1]
    assert seen[:2] == [8, 2] and 2 in seen
    last_quantum = max(i for i, n in enumerate(seen) if n == 2)
    assert seen[last_quantum + 1:] and set(seen[last_quantum + 1:]) == {8}


class StandInGraph:
    """The card's DecodeGraph on the CPU: the first replay captures (its
    warm-up runs the chunk), later ones replay; it records the chunk
    lengths it ran."""

    def __init__(self):
        self.captures = self.replays = 0
        self.steps = set()

    def replay(self, run):
        if self.captures:
            self.replays += 1
        else:
            self.captures = 1
        self.steps.add(run.args[0])
        run()


@pytest.mark.parametrize("paged", KINDS, ids=KIND_IDS)
def test_the_quantum_runs_its_own_graph(model, paged):
    """A chunked engine that meets a backlog captures two graphs, one a
    chunk length, each once; a plain engine one. The tokens stay the
    plain engine's."""
    kw = dict(num_slots=2, prefill_len=16, decode_chunk=4, paged=paged)
    engines = {}
    for name, extra in (("plain", {}), ("chunked",
                                         {"prefill_chunk_tokens": 4})):
        eng = port_engine(model, **kw, **extra)
        eng._graph = StandInGraph()
        if extra:
            eng._quantum_graph = StandInGraph()
        engines[name] = (eng, staggered(eng))
    (plain, want), (chunked, got) = engines["plain"], engines["chunked"]
    assert got == want
    assert plain._graph.steps == {4}
    assert plain.metrics()["hotpath"]["graphs_captured"] == 1
    assert (chunked._graph.steps, chunked._quantum_graph.steps) == ({4}, {1})
    hp = chunked.metrics()["hotpath"]
    assert hp["graphs_captured"] == 2
    assert hp["graph_replays"] == (chunked._graph.replays
                                   + chunked._quantum_graph.replays) > 0


@pytest.mark.parametrize("paged", KINDS, ids=KIND_IDS)
def test_preempt_drops_a_quantum_in_flight(model, paged):
    """A queued batch request keeps the backlog live, so a decoding batch
    request's chunks are quanta; an interactive arrival preempts it with a
    quantum in flight, whose tokens for it are dropped at commit. The
    resume continues the JAX engine's uninterrupted greedy tokens."""
    want = uninterrupted(jax_engine(model, paged=paged), [4, 5, 6], 20)
    eng = port_engine(model, paged=paged, num_slots=1, decode_chunk=8,
                      prefill_chunk_tokens=8)
    b = eng.submit([4, 5, 6], 20, priority="batch")
    eng.submit([8, 8], 4, priority="batch")          # waits: a backlog
    for _ in range(100):
        eng.step()
        if len(eng.result(b).tokens) >= 3:
            break
    assert eng._inflight is not None and eng._inflight.n == 2
    assert [r.req_id for _, r in eng._inflight.snapshot] == [b]
    i = eng.submit([9, 9], 4)
    eng.step()                                       # the admission preempts
    st = eng.result(b).resume_state
    assert st is not None and st["reason"] == "preempt"
    eng.run()
    assert eng.result(b).tokens == st["committed"]
    assert st["committed"] == want[:len(st["committed"])]
    assert eng.result(i).finish_reason == "length"
    dst = port_engine(model, paged=paged)
    rid = dst.submit(st["prompt"], st["maxNewTokens"],
                     committed=st["committed"], prng_key=st["prngKey"],
                     priority="batch", preempted=st["preempted"])
    dst.run()
    assert dst.result(rid).tokens == want


# ------------------------------------------------ the prefill role (handoff)


@pytest.mark.parametrize("paged", KINDS, ids=KIND_IDS)
def test_first_token_handoff_bitwise_identical(model, paged):
    """A prefill-role engine emits exactly token #1 as a reason "handoff"
    resume state, with the JAX prefill engine's bookkeeping, no decode
    step and no graph; a decode engine continues it to the JAX engine's
    uninterrupted tokens."""
    want = uninterrupted(jax_engine(model, paged=paged))
    jpf = jax_engine(model, paged=paged, handoff_first_token=True)
    jpf.submit(PROMPT, N)
    jpf.run()
    pf = port_engine(model, paged=paged, handoff_first_token=True)
    pf._graph = StandInGraph()
    rid = pf.submit(PROMPT, N)
    pf.run()
    req = pf.result(rid)
    assert req.finish_reason == "migrated"
    state = req.resume_state
    assert state["reason"] == "handoff" and state["preempted"] == 0
    assert state["committed"] == want[:1], \
        "a prefill engine's share is exactly the first token"
    m = pf.metrics()
    assert m["migration"]["handoffs_total"] == 1
    assert m["migration"]["ejected_total"] == 1
    assert pf.slots_busy == 0, "handoff must free the slot"
    assert m["lifetime"]["decode_steps"] == 0, \
        "a prefill-role engine must never dispatch decode work"
    assert pf._graph.captures == 0 and m["hotpath"]["graphs_captured"] == 0
    got, ref = bookkeeping(pf), bookkeeping(jpf)
    del got["lifetime"]["prefill_chunks"], ref["lifetime"]["prefill_chunks"]
    assert got == ref
    dsts = (port_engine(model, paged=paged, seed=77, num_slots=3),
            jax_engine(model, paged=paged, seed=77, num_slots=3))
    for dst in dsts:
        r2 = dst.submit(state["prompt"], state["maxNewTokens"],
                        committed=state["committed"],
                        prng_key=state["prngKey"])
        dst.run()
        res = dst.result(r2)
        assert res.tokens == want, "handoff splice diverged"
        assert res.emit_from == 1
    got, ref = (bookkeeping(d) for d in dsts)
    del got["lifetime"]["prefill_chunks"], ref["lifetime"]["prefill_chunks"]
    assert got == ref and got["migration"]["resumed_total"] == 1


@pytest.mark.parametrize("paged", KINDS, ids=KIND_IDS)
def test_handoff_engine_completes_single_token_requests(model, paged):
    """maxNewTokens 1 on a prefill engine finishes normally: the first
    token is the whole generation, nothing to hand off."""
    want = uninterrupted(jax_engine(model, paged=paged))
    eng = port_engine(model, paged=paged, handoff_first_token=True)
    rid = eng.submit(PROMPT, 1)
    eng.run()
    req = eng.result(rid)
    assert req.finish_reason == "length" and req.tokens == want[:1]
    assert eng.metrics()["migration"]["handoffs_total"] == 0
    assert eng.metrics()["lifetime"]["decode_steps"] == 0


def test_serve_service_emits_handoff_frames(model):
    """The port's ServeService on a prefill-role engine: a stream delivers
    token #1, then a migrate frame whose resume carries reason "handoff";
    the role rides /v1/metrics; a decode service continues the stream."""
    want = uninterrupted(jax_engine(model))
    svc = serve.ServeService(port_engine(model, handoff_first_token=True),
                             role="prefill")
    svc2 = serve.ServeService(port_engine(model, seed=13), role="decode")
    try:
        lines = list(svc.generate({"prompt": PROMPT, "maxNewTokens": N,
                                   "stream": True, "timeoutSeconds": 30}))
        assert [x["tokens"] for x in lines[:-1]] == [want[:1]]
        final = lines[-1]
        validate_frame(final, "final")
        assert final["status"] == "migrate"
        resume = final["resume"]
        validate_frame(resume, "resume")
        assert resume["reason"] == "handoff"
        assert resume["committed"] == want[:1]
        assert svc.metrics({})["metrics"]["role"] == "prefill"
        assert svc2.metrics({})["metrics"]["role"] == "decode"
        assert svc.prometheus_series()["ktwe_serving_handoffs_total"] == 1.0
        out = svc2.generate({"resumeFrom": resume, "timeoutSeconds": 30})
        assert out["status"] == "ok"
        assert out["tokens"] == want
        assert out["committedOffset"] == 1
    finally:
        svc.stop()
        svc2.stop()


def test_fleet_router_splices_a_torch_handoff_without_budget():
    """The JAX FleetRouter over a registry of a torch prefill replica and
    a torch decode replica: a fresh stream lands on the prefill replica,
    which hands it off after token #1; the router splices the
    continuation onto the decode replica. The client sees the
    uninterrupted stream with contiguous offsets, and no migration budget
    is spent (max_migrations=0)."""
    pf = Replica(["--disagg", "prefill"])
    dec = Replica(["--disagg", "decode"])
    mixed = Replica()
    reg = ReplicaRegistry(probe_interval_s=0.1, probe_timeout_s=2.0)
    try:
        want = fleet.uninterrupted(mixed.url)
        assert len(want) == fleet.N
        for r in (pf, dec):
            reg.add(r.url)
        reg.probe_all()
        roles = {r.base_url: r.load.role for r in reg.replicas()}
        assert roles == {pf.url: "prefill", dec.url: "decode"}
        router = FleetRouter(reg, hedge_enabled=False, max_migrations=0)
        lines = list(router.generate({
            "prompt": fleet.PROMPT, "maxNewTokens": fleet.N, "stream": True,
            "timeoutSeconds": 60}))
        toks = [t for x in lines if "status" not in x
                and "finishReason" not in x for t in x.get("tokens", [])]
        assert toks == want
        fleet._offsets_contiguous([x for x in lines
                                   if "finishReason" not in x], 0)
        assert lines[-1]["finishReason"] == "length"
        assert "migrate" not in {x.get("status") for x in lines}
        assert router.handoffs_total == 1
        assert router.migrations_total == 0
        assert router.migrations_failed_total == 0
        mp, md = (fleet.call(r.url, "/v1/metrics")[1]["metrics"]
                  for r in (pf, dec))
        assert mp["role"] == "prefill" and md["role"] == "decode"
        assert mp["lifetime"]["decode_steps"] == 0
        assert mp["hotpath"]["graphs_captured"] == 0
        assert mp["migration"]["handoffs_total"] == 1
        assert md["migration"]["resumed_total"] == 1
        assert md["migration"]["resume_committed_tokens_total"] == 1
    finally:
        reg.stop()
        for r in (pf, dec, mixed):
            r.close()


# ------------------------------------------------------------ the serve main


@pytest.mark.parametrize("extra", [
    ["--max-seq", "64", "--prefill-chunk-tokens", "24"],
    ["--max-seq", "64", "--prefill-chunk-tokens", "16", "--disagg",
     "prefill"]], ids=["not-a-divisor", "prefill-role"])
def test_prefill_chunk_tokens_refused_as_the_jax_main_refuses(extra, capsys):
    """Both refusals exit 2 with the JAX serve main's message."""
    errors = []
    for main in (serve.main, jserve.main):
        with pytest.raises(SystemExit) as e:
            main(["--device", "cpu"] * (main is serve.main) + extra)
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.rsplit("error: ", 1)[1])
    assert errors[0] == errors[1]
    assert "--prefill-chunk-tokens" in errors[0]


@pytest.mark.parametrize("text,want", [
    ("disagg: off\n", {"disagg": "off"}),
    ("disagg: prefill\n", {"disagg": "prefill"}),
    ("disagg: decode\n  prefill_chunk_tokens: 32\n",
     {"disagg": "decode", "prefill_chunk_tokens": 32}),
    ("drain_eject_grace: 2.5\n", {"drain_eject_grace": 2.5}),
    ("disagg: both\n", None)],
    ids=["off", "prefill", "chunk-tokens", "grace", "bad-choice"])
def test_config_takes_the_disagg_keys(tmp_path, capsys, text, want):
    """The knob file's serve.disagg, prefill_chunk_tokens and
    drain_eject_grace set the flags as the JAX knob registry reads them
    (a bare `off` is the choice "off", never False); a value outside
    --disagg's choices is a parser error naming the key and the choices
    (exit 2), where the JAX registry raises the same message."""
    cfg = tmp_path / "ktwe.yaml"
    cfg.write_text("serve:\n  " + text)
    argv = ["--config", str(cfg)]
    if want is None:
        with pytest.raises(SystemExit) as e:
            parse_with_config(serve.build_parser(), "serve", argv)
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert "serve.disagg: 'both' not in ['off', 'prefill', 'decode']" \
            in err
        with pytest.raises(ValueError, match="serve.disagg: 'both' not in"):
            jknobs.parse_with_config(jserve.build_parser(), "serve", argv)
        return
    args = parse_with_config(serve.build_parser(), "serve", argv)
    jargs = jknobs.parse_with_config(jserve.build_parser(), "serve", argv)
    for key, value in want.items():
        assert getattr(args, key) == getattr(jargs, key) == value
        assert type(getattr(args, key)) is type(value)


def jax_eject_grace(drain_timeout, drain_eject_grace):
    """The JAX serve main's arithmetic (cmd/serve.py, its drain), copied."""
    flush_reserve = min(2.0, drain_timeout / 2)
    latest = max(0.5, drain_timeout - flush_reserve)
    return (min(drain_eject_grace, latest) if drain_eject_grace > 0
            else latest)


@pytest.mark.parametrize("timeout", [1.0, 4.0, 30.0])
@pytest.mark.parametrize("grace", [0.0, 1.0, 100.0])
def test_eject_grace_is_the_jax_arithmetic(timeout, grace):
    assert serve.eject_grace_s(timeout, grace) == \
        jax_eject_grace(timeout, grace)


def test_sigterm_ejects_at_the_drain_grace():
    """A serve main with --drain-timeout 20 --drain-eject-grace 1 streams a
    long generation; SIGTERM: the stream's migrate frame arrives about a
    second later, long before the 18 s the drain would otherwise wait,
    and the process exits 0."""
    argv = [sys.executable, "-m", "k8s_gpu_workload_enhancer_tpu_torch.cmd.serve",
            "--device", "cpu", "--port", "0", "--vocab-size", "8192",
            "--d-model", "1024", "--n-layers", "4", "--n-heads", "4",
            "--d-ff", "4096", "--max-seq", "512", "--num-slots", "1",
            "--prefill-len", "16", "--decode-chunk", "1",
            "--drain-timeout", "20", "--drain-eject-grace", "1"]
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    out = []
    try:
        port = None
        for line in proc.stdout:
            out.append(line)
            if "up on :" in line:
                port = int(line.split("up on :")[1].split()[0])
                break
        assert port is not None, "".join(out)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/generate",
            data=json.dumps({"prompt": [1, 2, 3], "maxNewTokens": 480,
                             "stream": True,
                             "timeoutSeconds": 120}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            first = json.loads(resp.readline())
            assert first["offset"] == 0
            t0 = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            lines = [json.loads(raw) for raw in resp]
        waited = time.monotonic() - t0
        final = lines[-1]
        assert final["status"] == "migrate", final
        assert final["resume"]["reason"] == "eject"
        assert 0 < len(final["resume"]["committed"]) < 480
        assert 0.9 <= waited < 4.0, waited
        rest, _ = proc.communicate(timeout=60)
        out.append(rest)
        assert proc.returncode == 0, "".join(out)
        assert "drain grace expired; ejected 1 live requests" in "".join(out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
