"""The port's serve surface as the fleet calls it, over HTTP on the CPU.

- `/v1/prefix` (register, release, 404, the registry-full 429 without
  Retry-After and the paged pool's 429 with one), `/v1/cancel`,
  `/v1/result` (GET and POST, pending, 404), and `/v1/admin/eject`, which
  ends a streaming client's stream with a migrate frame whose resume state
  another replica continues: the spliced stream is the uninterrupted one.
- Every frame the torch serve emits, and every body sent to it, passes the
  JAX package's `fleet.wire.validate_frame` under its kind (error bodies
  under "final", the kind that carries "error" and "reason").
- `/v1/metrics` parses through the JAX `ReplicaRegistry._parse_load`.
- The JAX `FleetRouter` over a `ReplicaRegistry` of two torch replicas
  splices a stream that one of them ejects mid-flight: the client's tokens
  are the uninterrupted transcript, offsets contiguous, one migration.
- `--metrics-port`: every family served has its name in the JAX
  `SERVING_FAMILIES` and the value that table computes from `/v1/metrics`.
- The JAX `FleetRouter` splices a torch replica's preemption: a batch
  stream preempted for an interactive request continues on the other
  replica as batch with one hop, and the registry reads A's queue depth
  split by class.
- `--config`: the `serve:` section sets flags, the command line wins, a
  key without a flag is an error naming it, a scalar `tenant_budget` is
  one budget.

Replicas whose engine loop is parked are stepped by hand, so that an eject
or a poll lands at a known point of a generation.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import pytest

from k8s_gpu_workload_enhancer_tpu import faultlab as jfaultlab
from k8s_gpu_workload_enhancer_tpu.cmd.serve import \
    SERVING_FAMILIES as JAX_FAMILIES
from k8s_gpu_workload_enhancer_tpu.fleet.registry import ReplicaRegistry
from k8s_gpu_workload_enhancer_tpu.fleet.router import FleetRouter
from k8s_gpu_workload_enhancer_tpu.fleet.wire import validate_frame
from k8s_gpu_workload_enhancer_tpu_torch import faultlab
from k8s_gpu_workload_enhancer_tpu_torch.cmd import serve
from k8s_gpu_workload_enhancer_tpu_torch.utils.config import parse_with_config

import torch_parity  # noqa: F401  (one intra-op thread a process)

ARGS = ["--device", "cpu", "--port", "0", "--seed", "5", "--vocab-size",
        "128", "--d-model", "64", "--n-layers", "2", "--n-heads", "2",
        "--d-ff", "128", "--max-seq", "64", "--num-slots", "2",
        "--prefill-len", "16", "--decode-chunk", "4", "--drain-timeout", "5"]
PAGED = ["--kv-block-len", "8"]
PROMPT = [3, 17, 29, 5, 8, 100, 7, 7, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10]
N = 40
TRACEPARENT = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"


class Replica:
    """A ServeService on the serve main's engine and routes, behind an
    HTTP server on a free port. `parked`: its engine loop is stopped and
    `step()` advances the engine by hand."""

    def __init__(self, extra=(), parked=False):
        args = serve.build_parser().parse_args(ARGS + list(extra))
        self.svc = serve.ServeService(
            serve.build_engine(args),
            role="mixed" if args.disagg == "off" else args.disagg)
        self.engine = self.svc._engine
        if parked:
            self.svc._stop.set()
            self.svc._wake.set()
            self.svc._thread.join(10)
        self.server = ThreadingHTTPServer(("127.0.0.1", 0),
                                          serve.make_handler(self.svc))
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def step(self, n=1):
        for _ in range(n):
            with self.svc._lock:
                self.engine.step()

    def close(self):
        self.svc.stop()
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(10)


@pytest.fixture
def replicas():
    made = []

    def make(extra=(), parked=False):
        made.append(Replica(extra, parked))
        return made[-1]
    yield make
    for r in made:
        r.close()


def _kind(path, frame):
    if frame.get("status") == "error":
        return "final"
    if path.split("?")[0] in ("/v1/generate", "/v1/result"):
        return "final"
    return "admin"


def _check(path, frame):
    validate_frame(frame, _kind(path, frame))
    if isinstance(frame.get("resume"), dict):
        validate_frame(frame["resume"], "resume")


def call(url, path, body=None, headers=None):
    """(status, reply, Retry-After) of a POST (GET when body is None); the
    reply and the body are held to the wire schema."""
    if body is not None:
        validate_frame(body, "request")
        if isinstance(body.get("resumeFrom"), dict):
            validate_frame(body["resumeFrom"], "resume")
    req = urllib.request.Request(
        url + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            code, out, retry = resp.status, json.loads(resp.read()), \
                resp.headers.get("Retry-After")
    except urllib.error.HTTPError as e:
        code, out, retry = e.code, json.loads(e.read()), \
            e.headers.get("Retry-After")
    _check(path, out)
    return code, out, retry


class Stream:
    """A streamed /v1/generate read line by line; each line is held to the
    wire schema ("stream" for token lines, "final" for the last)."""

    def __init__(self, url, body, headers=None):
        body = dict(body, stream=True)
        validate_frame(body, "request")
        req = urllib.request.Request(
            url + "/v1/generate", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json", **(headers or {})},
            method="POST")
        self.resp = urllib.request.urlopen(req, timeout=60)
        self.lines = []

    def next(self):
        line = json.loads(self.resp.readline())
        validate_frame(line, "final" if "status" in line else "stream")
        if isinstance(line.get("resume"), dict):
            validate_frame(line["resume"], "resume")
        self.lines.append(line)
        return line

    def tokens(self):
        return [t for x in self.lines if "status" not in x
                for t in x["tokens"]]

    def finish(self):
        while "status" not in (self.lines[-1] if self.lines else {}):
            self.next()
        self.resp.close()
        return self.lines[-1]


def _offsets_contiguous(lines, start):
    seen = start
    for x in lines:
        if "status" not in x:
            assert x["offset"] == seen
            seen += len(x["tokens"])
    return seen


def uninterrupted(url, prompt=PROMPT, n=N, **kw):
    code, out, _ = call(url, "/v1/generate", {"prompt": prompt,
                                              "maxNewTokens": n, **kw})
    assert code == 200 and out["status"] == "ok", out
    return out["tokens"]


def test_prefix_route_registers_releases_and_refuses(replicas):
    r = replicas(["--max-prefixes", "1"])
    prefix = list(range(1, 21))                  # one 16-token chunk cached
    code, out, _ = call(r.url, "/v1/prefix", {"tokens": prefix})
    assert code == 200 and out == {"status": "ok", "prefixId": 0,
                                   "cachedTokens": 16}
    want = uninterrupted(r.url, prefix + [50, 51], 10)
    for _ in range(2):
        code, got, _ = call(r.url, "/v1/generate", {
            "prompt": [50, 51], "prefixId": 0, "maxNewTokens": 10})
        assert code == 200 and got["tokens"] == want
    code, out, retry = call(r.url, "/v1/prefix", {"tokens": [1, 2, 3]})
    assert code == 429 and retry is None and "prefix cache full" in \
        out["error"]
    code, out, _ = call(r.url, "/v1/prefix", {"tokens": [999]})
    assert code == 400
    code, out, _ = call(r.url, "/v1/prefix", {"releaseId": 0})
    assert code == 200 and out == {"status": "ok", "released": 0}
    code, out, _ = call(r.url, "/v1/prefix", {"releaseId": 0})
    assert code == 404
    m = call(r.url, "/v1/metrics")[1]["metrics"]
    assert m["prefix_cache"] == {"registered": 0, "hits": 2,
                                 "prompt_tokens_saved": 32}


def test_paged_prefix_pins_pages_and_a_full_pool_is_retryable(replicas):
    r = replicas(PAGED + ["--kv-num-blocks", "6"])       # 5 pages
    prefix = list(range(1, 21))
    code, out, _ = call(r.url, "/v1/prefix", {"tokens": prefix})
    assert code == 200 and out["cachedTokens"] == 16
    kv = call(r.url, "/v1/metrics")[1]["metrics"]["kv_cache"]
    assert kv["blocks_used"] == kv["blocks_cached"] == 2
    code, out, retry = call(r.url, "/v1/prefix",
                            {"tokens": list(range(30, 62))})   # 4 pages
    assert code == 429 and retry is not None and "kv pool" in out["error"]
    code, got, _ = call(r.url, "/v1/generate", {
        "prompt": [50, 51], "prefixId": 0, "maxNewTokens": 6})
    assert got["tokens"] == uninterrupted(r.url, prefix + [50, 51], 6)
    assert call(r.url, "/v1/prefix", {"releaseId": 0})[0] == 200
    assert r.engine._radix.pinned_blocks() == 0


def test_result_and_cancel_routes(replicas):
    r = replicas(parked=True)
    s0 = Stream(r.url, {"prompt": PROMPT, "maxNewTokens": N})
    s1 = Stream(r.url, {"prompt": [9, 9, 9], "maxNewTokens": N})
    time.sleep(0.05)
    for rid in (0, 1):
        code, out, _ = call(r.url, f"/v1/result?requestId={rid}")
        assert code == 200 and out == {"status": "pending",
                                       "requestId": rid, "tokensSoFar": 0}
    r.step(2)                       # both prefilled, one chunk committed
    code, out, _ = call(r.url, "/v1/result", {"requestId": 0})
    assert out["status"] == "pending" and out["tokensSoFar"] == 5
    code, out, _ = call(r.url, "/v1/cancel", {"requestId": 0})
    assert code == 200 and out == {"status": "ok", "requestId": 0,
                                   "cancelled": True}
    final = s0.finish()
    assert final["status"] == "cancelled" and s0.tokens() == final["tokens"]
    code, out, _ = call(r.url, "/v1/result?requestId=0")
    assert out["status"] == "cancelled" and len(out["tokens"]) == 5
    assert call(r.url, "/v1/cancel", {"requestId": 0})[1]["cancelled"] \
        is False
    # A queued request: cancelled before admission, nothing generated.
    s2 = Stream(r.url, {"prompt": [4, 4], "maxNewTokens": 8})
    time.sleep(0.05)
    assert call(r.url, "/v1/cancel", {"requestId": 2})[1]["cancelled"]
    assert s2.finish()["tokens"] == []
    assert call(r.url, "/v1/result?requestId=999")[0] == 404
    assert call(r.url, "/v1/cancel", {"requestId": 999})[0] == 404
    # A blocking request past its deadline answers a timeout frame.
    code, out, _ = call(r.url, "/v1/generate", {
        "prompt": [7], "maxNewTokens": 4, "timeoutSeconds": 0.05})
    assert code == 200 and out["status"] == "timeout"
    r.step(40)
    assert s1.finish()["status"] == "ok" and len(s1.tokens()) == N
    assert r.engine.pending == 0


@pytest.mark.parametrize("extra", [[], PAGED], ids=["dense", "paged"])
def test_admin_eject_ends_a_stream_with_a_migrate_frame(replicas, extra):
    a = replicas(extra, parked=True)
    b = replicas(extra)
    want = uninterrupted(b.url)
    hdr = {"traceparent": TRACEPARENT}
    s = Stream(a.url, {"prompt": PROMPT, "maxNewTokens": N}, headers=hdr)
    a.step(3)                       # prefill + 2 chunks committed: 9 tokens
    while len(s.tokens()) < 9:
        s.next()
    code, out, _ = call(a.url, "/v1/admin/eject", {})
    assert code == 200 and out == {"status": "ok", "ejected": 1,
                                   "requestIds": [0]}
    final = s.finish()
    assert final["status"] == "migrate"
    assert final["finishReason"] == "migrated"
    assert final["traceparent"] == TRACEPARENT
    resume = final["resume"]
    assert s.tokens() == resume["committed"] == want[:9]
    _offsets_contiguous(s.lines, 0)
    # Blocking, and streamed: the stream starts at the committed offset.
    code, out, _ = call(b.url, "/v1/generate", {"resumeFrom": resume},
                        headers=hdr)
    assert out["tokens"] == want and out["committedOffset"] == 9
    assert out["traceparent"] == TRACEPARENT
    s2 = Stream(b.url, {"resumeFrom": resume})
    final2 = s2.finish()
    assert final2["status"] == "ok" and final2["committedOffset"] == 9
    assert s2.lines[0]["offset"] == 9
    assert _offsets_contiguous(s2.lines, 9) == N
    assert resume["committed"] + s2.tokens() == want
    assert call(a.url, "/v1/result?requestId=0")[1]["status"] == "migrate"
    ma = call(a.url, "/v1/metrics")[1]["metrics"]
    mb = call(b.url, "/v1/metrics")[1]["metrics"]
    assert ma["migration"]["ejected_total"] == 1
    assert ma["lifetime"]["completed"] == 0
    assert mb["migration"]["resumed_total"] == 2
    assert mb["migration"]["resume_committed_tokens_total"] == 18
    if extra:
        kv = ma["kv_cache"]
        assert kv["blocks_free"] + kv["blocks_cached"] == kv["blocks_total"]
        assert mb["kv_cache"]["matched_tokens_total"] > 0


@pytest.mark.parametrize("extra", [[], PAGED], ids=["dense", "paged"])
def test_metrics_parse_through_the_registry(replicas, extra):
    r = replicas(extra)
    uninterrupted(r.url, n=6)
    code, out, _ = call(r.url, "/v1/metrics")
    snap = ReplicaRegistry._parse_load(out["metrics"])
    assert snap.slots == 2 and snap.slots_busy == 0 and snap.queued == 0
    assert snap.role == "mixed" and snap.requests_completed == 1
    assert snap.request_p95_ms > 0 and snap.ttft_p95_ms > 0
    assert snap.kv_block_len == (8 if extra else 0)


def _router_stream(router, body, out):
    out["lines"] = list(router.generate(body))


def test_fleet_router_splices_a_torch_replica_migration(replicas):
    """The JAX FleetRouter in front of two torch replicas (both stepped by
    hand): the replica serving a stream ejects it after 9 tokens; the
    router resumes it on a healthy replica and the client sees one
    stream."""
    reps = [replicas(parked=True), replicas(parked=True)]
    want = uninterrupted(replicas().url)
    reg = ReplicaRegistry(probe_interval_s=0.1, probe_timeout_s=2.0)
    try:
        for r in reps:
            reg.add(r.url)
        reg.probe_all()
        router = FleetRouter(reg, hedge_enabled=False)
        out = {}
        th = threading.Thread(target=_router_stream, args=(router, {
            "prompt": PROMPT, "maxNewTokens": N, "stream": True,
            "timeoutSeconds": 60}, out), daemon=True)
        th.start()
        deadline = time.time() + 30
        while not any(r.engine.active for r in reps):
            assert time.time() < deadline
            time.sleep(0.01)
        victim = next(r for r in reps if r.engine.active)
        while len(victim.engine.result(0).tokens) < 9:
            victim.step()
        time.sleep(0.1)             # let the stream deliver some lines
        code, ej, _ = call(victim.url, "/v1/admin/eject", {})
        assert code == 200 and ej["ejected"] == 1
        while th.is_alive():
            assert time.time() < deadline
            for r in reps:
                if r.engine.active:
                    r.step()
            time.sleep(0.005)
        lines = out["lines"]
        toks = [t for x in lines if "status" not in x
                and "finishReason" not in x for t in x.get("tokens", [])]
        assert toks == want
        _offsets_contiguous([x for x in lines if "finishReason" not in x],
                            0)
        assert lines[-1]["finishReason"] == "length"
        assert "migrate" not in {x.get("status") for x in lines}
        assert router.migrations_total == 1
        assert router.migrations_failed_total == 0
        resumed = [r for r in reps
                   if r.engine.metrics()["migration"]["resumed_total"]]
        assert len(resumed) == 1
    finally:
        reg.stop()


def test_fleet_router_splices_a_torch_replica_preemption(replicas):
    """The JAX FleetRouter sends a batch stream to torch replica A (one
    slot, stepped by hand). A batch and an interactive request queue on A
    behind it, which the registry's snapshot of A shows split by class.
    The interactive head preempts the stream; the router splices the
    reason "preempt" frame onto replica B, the client sees the
    uninterrupted tokens, and B runs the stream as batch with one hop."""
    a = replicas(["--num-slots", "1"], parked=True)
    b = replicas()
    want = uninterrupted(b.url)
    reg = ReplicaRegistry(probe_interval_s=0.1, probe_timeout_s=2.0)
    try:
        reg.add(a.url, "a")
        reg.probe_all()
        router = FleetRouter(reg, hedge_enabled=False)
        out = {}
        th = threading.Thread(target=_router_stream, args=(router, {
            "prompt": PROMPT, "maxNewTokens": N, "stream": True,
            "timeoutSeconds": 60, "tenant": "bulk", "priority": "batch"},
            out), daemon=True)
        th.start()
        deadline = time.time() + 30
        while not a.engine.active:
            assert time.time() < deadline
            time.sleep(0.01)
        while len(a.engine.result(0).tokens) < 9:
            a.step()
        assert a.engine.result(0).priority == "batch"
        queued = [Stream(a.url, {"prompt": [9, 9, 9], "maxNewTokens": 4,
                                 "priority": "batch"}),
                  Stream(a.url, {"prompt": [4, 4], "maxNewTokens": 4},
                         headers={"x-ktwe-priority": "interactive"})]
        while a.engine.metrics()["queued"] != 2:
            assert time.time() < deadline
            time.sleep(0.01)
        reg.add(b.url, "b")
        reg.probe_all()
        load = reg.get("a").load
        assert (load.queued, load.queued_interactive, load.queued_batch) \
            == (2, 1, 1)
        a.step()                    # the interactive admission preempts
        assert a.engine.result(0).finish_reason == "migrated"
        assert a.engine.result(0).resume_state["reason"] == "preempt"
        while th.is_alive() or a.engine.active:
            assert time.time() < deadline
            if a.engine.active:
                a.step()
            time.sleep(0.005)
        lines = out["lines"]
        toks = [t for x in lines if "status" not in x
                and "finishReason" not in x for t in x.get("tokens", [])]
        assert toks == want
        _offsets_contiguous([x for x in lines if "finishReason" not in x],
                            0)
        assert lines[-1]["finishReason"] == "length"
        assert "migrate" not in {x.get("status") for x in lines}
        assert router.preempt_frames_total == 1
        assert router.preempt_resumes_total == 1
        assert router.migrations_failed_total == 0
        resumed = b.engine.result(1)
        assert resumed.emit_from > 0 and resumed.tokens == want
        assert (resumed.tenant, resumed.priority, resumed.preempted) == \
            ("bulk", "batch", 1)
        assert [s.finish()["status"] for s in queued] == ["ok", "ok"]
        assert a.engine.metrics()["migration"]["preempted_total"] == 1
    finally:
        reg.stop()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_main(args):
    stop, ready, port, result = (threading.Event(), threading.Event(), {},
                                 {})

    def on_ready(p):
        port["p"] = p
        ready.set()
    th = threading.Thread(target=lambda: result.update(rc=serve.main(
        args, stop=stop, on_ready=on_ready)), daemon=True)
    th.start()
    assert ready.wait(60), "serve main did not come up"
    return port["p"], stop, th, result


def _scrape(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as resp:
        text = resp.read().decode()
    series = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            name, kind = line.split()[2:4]
            assert kind == ("counter" if name.endswith("_total")
                            else "gauge")
        elif line.strip():
            name, value = line.split()
            series[name] = float(value)
    return series


def test_metrics_port_and_config(tmp_path):
    """The serve main from a knob file (slots and queue from `serve:`, the
    page size from the command line over the file's), with --metrics-port:
    traffic through a prefix and a resume, then every scraped family has
    its JAX name and the JAX table's value of /v1/metrics."""
    # Each package's FaultLab counts injections process-wide, and the JAX
    # table reads the JAX one: start both at zero, whatever an earlier test
    # in this process injected (activation resets the counts).
    for fl in (jfaultlab, faultlab):
        fl.activate(fl.TargetedPlan({}))
        fl.deactivate()
    mport = _free_port()
    cfg = tmp_path / "ktwe.yaml"
    cfg.write_text("serve:\n  num_slots: 3\n  max_queue: 7  # comment\n"
                   "  kv_block_len: 16\n  metrics_port: %d\n"
                   "router:\n  hedge: true\n" % mport)
    i = ARGS.index("--num-slots")
    args = ARGS[:i] + ARGS[i + 2:]
    port, stop, th, result = _run_main(args + ["--config", str(cfg),
                                               "--kv-block-len", "8"])
    url = f"http://127.0.0.1:{port}"
    try:
        pid = call(url, "/v1/prefix", {"tokens": list(range(1, 21))})[1]
        want = uninterrupted(url, list(range(1, 21)) + [5], 12)
        got = call(url, "/v1/generate", {"prompt": [5], "maxNewTokens": 12,
                                         "prefixId": pid["prefixId"]})[1]
        assert got["tokens"] == want
        resume = {"prompt": list(range(1, 21)) + [5], "committed": want[:4],
                  "maxNewTokens": 12}
        assert call(url, "/v1/generate",
                    {"resumeFrom": resume})[1]["tokens"] == want
        time.sleep(0.1)
        series = _scrape(mport)
        m = call(url, "/v1/metrics")[1]["metrics"]
    finally:
        stop.set()
        th.join(30)
    assert result.get("rc") == 0
    assert m["slots"] == 3 and m["kv_cache"]["block_len"] == 8
    assert series and set(series) <= set(JAX_FAMILIES)
    for name, value in series.items():
        assert value == float(JAX_FAMILIES[name](m, m["slots_busy"],
                                                 m["slots"])), name
    assert series["ktwe_serving_resume_requests_total"] == 1
    assert series["ktwe_serving_resume_committed_tokens_total"] == 4
    assert series["ktwe_serving_prefixes_registered"] == 1
    assert series["ktwe_serving_prefix_hits_total"] >= 1
    with pytest.raises(urllib.error.URLError):
        _scrape(mport)              # the metrics server stopped with main


def test_config_sets_flags_and_refuses_keys_without_one(tmp_path, capsys):
    cfg = tmp_path / "ktwe.yaml"
    cfg.write_text("serve:\n  num_slots: 3\n  max_queue: 7\n"
                   "  enable_top_p: true\n  device: 'cpu'\n")
    parser = serve.build_parser()
    args = parse_with_config(parser, "serve",
                             ["--config", str(cfg), "--max-queue", "9"])
    assert (args.num_slots, args.max_queue, args.enable_top_p,
            args.device) == (3, 9, True, "cpu")
    assert serve.build_parser().parse_args([]).num_slots == 8
    cfg.write_text("serve:\n  spec_k: 2\n")
    assert parse_with_config(serve.build_parser(), "serve",
                             ["--config", str(cfg)]).spec_k == 2
    cfg.write_text("serve:\n  kv_host_blocks: 2\n")
    assert parse_with_config(serve.build_parser(), "serve",
                             ["--config", str(cfg)]).kv_host_blocks == 2
    for bad, named in (("  tokenizer: 'tok.json'\n", "serve.tokenizer"),
                       ("  num_slots: lots\n", "serve.num_slots"),
                       ("  int8: 3\n", "serve.int8")):
        cfg.write_text("serve:\n" + bad)
        with pytest.raises(SystemExit) as e:
            parse_with_config(serve.build_parser(), "serve",
                              ["--config", str(cfg)])
        assert e.value.code == 2 and named in capsys.readouterr().err
    cfg.write_text("servr:\n  num_slots: 3\n")
    with pytest.raises(SystemExit):
        parse_with_config(serve.build_parser(), "serve",
                          ["--config", str(cfg)])
    assert "unknown component section 'servr'" in capsys.readouterr().err


def test_config_takes_a_scalar_tenant_budget_as_one_item(tmp_path):
    """The JAX knob file's `tenant_budget` (a strlist knob) may be one
    scalar: it becomes a one-item list, as the JAX strlist cast makes it,
    never a string the serve iterates character by character; a flag on
    the command line adds to it."""
    cfg = tmp_path / "ktwe.yaml"
    cfg.write_text('serve:\n  tenant_budget: "a=0.5"\n'
                   '  budget_period: weekly\n  chip_hour_rate: 2.5\n'
                   '  default_tenant: team\n  preempt_cap: 0\n')
    parser = serve.build_parser()
    args = parse_with_config(parser, "serve", ["--config", str(cfg)])
    assert args.tenant_budget == ["a=0.5"]
    assert (args.budget_period, args.chip_hour_rate, args.default_tenant,
            args.preempt_cap) == ("weekly", 2.5, "team", 0)
    meter = serve.build_meter(args, parser)
    assert meter.chip_hour_rate == 2.5 and meter.admission("a")[0]
    meter.record("a", "batch", 1, 0.5 / 2.5 * 3600)       # $0.50
    ok, reason, retry = meter.admission("a")
    assert not ok and "tenant-a" in reason and retry > 0
    args = parse_with_config(serve.build_parser(), "serve",
                             ["--config", str(cfg), "--tenant-budget",
                              "b=1"])
    assert args.tenant_budget == ["a=0.5", "b=1"]
    assert serve.build_parser().parse_args([]).tenant_budget == []
