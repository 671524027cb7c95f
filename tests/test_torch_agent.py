"""The port's node agent, its file-table client and its exporter families,
held to the JAX package's on the same metrics tables (the JAX side is
`NativeTPUClient` over the built native library, skipped where that
library is unavailable, as tests/unit/test_native.py skips).

- `get_utilization` / `get_health` equal field by field (timestamps
  aside) on tables with comments, an empty line, short rows, rows missing
  power, temperature or health, a degraded and an unhealthy row, and a
  rewrite between reads; a row whose total is 0 reports 0 on the port
  (the recorded deviation: JAX substitutes its generation's capacity);
- `NodeAgent.collect_and_push`: the same summaries, and the same points
  pushed to a recording optimizer;
- the `AgentServer` routes answer the same codes and JSON, with and
  without a bearer token;
- a port agent main with `--optimizer-url` reaches the JAX optimizer's
  handler, and the JAX `OptimizerService` ingests the point the JAX agent
  sends;
- the port exporter main's `/metrics`, parsed with
  `prometheus_client.parser`, has the eight chip families of the JAX
  `PrometheusExporter` fed by `DiscoveryService` over `NativeTPUClient`:
  names, types, label sets and values, before and after a rewrite;
- the agent main: `auto` falls to the file table where there is no NVML,
  exits with JAX's message where there is no source, `libtpu` is refused
  naming `nvml`; `--fake-topology` reports what the JAX fake reports.
"""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import pytest
from prometheus_client.parser import text_string_to_metric_families

from k8s_gpu_workload_enhancer_tpu.agent import agent as jagent
from k8s_gpu_workload_enhancer_tpu.agent.optimizer_client import \
    HTTPOptimizerClient as JHTTPOptimizerClient
from k8s_gpu_workload_enhancer_tpu.cmd import optimizer as jopt_main
from k8s_gpu_workload_enhancer_tpu.discovery.discovery import (
    DiscoveryConfig, DiscoveryService)
from k8s_gpu_workload_enhancer_tpu.discovery.fakes import (
    FakeKubernetesClient, FakeSliceSpec, FakeTPUClient)
from k8s_gpu_workload_enhancer_tpu.discovery.native_client import \
    NativeTPUClient
from k8s_gpu_workload_enhancer_tpu.monitoring.exporter import (
    ExporterConfig as JExporterConfig, PrometheusExporter)
from k8s_gpu_workload_enhancer_tpu.native import bindings
from k8s_gpu_workload_enhancer_tpu.optimizer.workload_optimizer import \
    OptimizerService
from k8s_gpu_workload_enhancer_tpu_torch.agent import agent as tagent
from k8s_gpu_workload_enhancer_tpu_torch.cmd.agent import nvml_answers
from k8s_gpu_workload_enhancer_tpu_torch.discovery.fakes import FakeGPUClient
from k8s_gpu_workload_enhancer_tpu_torch.discovery.native_client import \
    NativeGPUClient
from k8s_gpu_workload_enhancer_tpu_torch.monitoring import exporter as texp

import torch_parity  # noqa: F401  (one intra-op thread a process)

NODE = "n0"
PYTHON = sys.executable
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TABLE = """\
# index duty tc_util hbm_used hbm_total power temp health
0 91.5 85.0 12.5 16.0 170.0 55.0 0
1 40 30 4 16 120 48 1
2 5.5 1 2 16 90
3 0 0 1 16

4 77 66 10 16 150 60 2
9 1 2 3
   # an indented comment is a row too short to keep
5 12.5 3 1.25 16 101.5 44.5
"""
REWRITE = """\
0 10 9 1 16 100 40 0
1 99 98 15.5 16 300 80.5 2
2 50 40 8 16 200 60 1
3 0.25 0 0.5 16 61 33 0
4 1e1 5 2.5e0 16 110 41 0
5 33 22 3 16 150 50 0
"""
FAMILIES = ["ktwe_chip_duty_cycle_percent",
            "ktwe_chip_tensorcore_utilization_percent",
            "ktwe_chip_hbm_used_gb", "ktwe_chip_hbm_total_gb",
            "ktwe_chip_power_watts", "ktwe_chip_temperature_celsius",
            "ktwe_chip_healthy", "ktwe_cluster_chips_total"]


@pytest.fixture
def native():
    """The JAX native library, as tests/unit/test_native.py requires it."""
    if not bindings.available():
        pytest.skip("native library unavailable")


@pytest.fixture
def table(tmp_path):
    path = tmp_path / "chip-metrics"
    path.write_text(TABLE)
    return path


def clients(path):
    j = NativeTPUClient(NODE, f"file:{path}")
    t = NativeGPUClient(NODE, f"file:{path}")
    j.initialize()
    t.initialize()
    return j, t


def fields(d, drop):
    out = {}
    for chip, v in d.items():
        row = dataclasses.asdict(v)
        for k in drop:
            row.pop(k)
        if "status" in row:
            row["status"] = row["status"].value
        out[chip] = row
    return out


def assert_reads_equal(j, t):
    ju, tu = j.get_utilization(NODE), t.get_utilization(NODE)
    assert fields(tu, ["timestamp"]) == fields(ju, ["timestamp"])
    jh, th = j.get_health(NODE), t.get_health(NODE)
    assert fields(th, ["last_checked"]) == fields(jh, ["last_checked"])
    return tu, th


def test_reads_equal_jax_on_the_same_tables(native, table):
    j, t = clients(table)
    try:
        u, h = assert_reads_equal(j, t)
        assert sorted(u) == [f"{NODE}-chip-{i}" for i in range(6)]
        assert (u["n0-chip-2"].power_watts, u["n0-chip-2"].temperature_c,
                u["n0-chip-3"].power_watts) == (90.0, 0.0, 0.0)
        assert [h[f"n0-chip-{i}"].status.value for i in (1, 4, 5)] == [
            "Degraded", "Unhealthy", "Healthy"]
        assert h["n0-chip-4"].reasons == ["shim health=2"]
        table.write_text(REWRITE)       # re-read on every read
        u, _ = assert_reads_equal(j, t)
        assert u["n0-chip-4"].duty_cycle_pct == 10.0
        table.write_text(TABLE + "7 1 2 3 4 5 6 1\n")
        u, _ = assert_reads_equal(j, t)
        assert len(u) == 7
    finally:
        j.shutdown()
        t.shutdown()


def test_a_row_with_total_zero_reports_zero(native, tmp_path):
    path = tmp_path / "t"
    path.write_text("0 50 40 1 0 100 40 0\n")
    j, t = clients(path)
    try:
        assert t.get_utilization(NODE)["n0-chip-0"].hbm_total_gb == 0.0
        # The recorded deviation: JAX gives its TPU generation's capacity.
        assert j.get_utilization(NODE)["n0-chip-0"].hbm_total_gb > 0
    finally:
        j.shutdown()


class Recorder:
    def __init__(self):
        self.points = []

    def ingest_telemetry(self, point):
        self.points.append(dict(point))


def agents(path, **cfg):
    j, t = clients(path)
    jrec, trec = Recorder(), Recorder()
    ja = jagent.NodeAgent(j, jagent.AgentConfig(node_name=NODE, **cfg),
                          optimizer_service=jrec)
    ta = tagent.NodeAgent(t, tagent.AgentConfig(node_name=NODE, **cfg),
                          optimizer_service=trec)
    return ja, ta, jrec, trec


def untimed(points):
    return [{k: v for k, v in p.items() if k != "timestamp"} for p in points]


def test_collect_and_push_equals_jax(native, table):
    ja, ta, jrec, trec = agents(table)
    for a in (ja, ta):
        a.assign_chips("wl-a", ["n0-chip-0", "n0-chip-1", "n0-chip-2"])
        a.assign_chips("wl-b", ["n0-chip-4"])
        a.assign_chips("wl-c", ["n0-chip-7"])      # no such chip
    assert ta.collect_and_push() == ja.collect_and_push()
    table.write_text(REWRITE)
    for a in (ja, ta):
        a.release_chips(["n0-chip-0", "n0-chip-4"])
        a.assign_chips("wl-b", ["n0-chip-5", "n0-chip-3"])
    summary = ta.collect_and_push()
    assert summary == ja.collect_and_push()
    assert set(summary) == {"wl-a", "wl-b"}
    assert untimed(trec.points) == untimed(jrec.points)
    assert len(trec.points) == 4 and ta.samples_pushed == ja.samples_pushed
    assert set(trec.points[0]) == {"workload_id", "timestamp",
                                   "duty_cycle_pct", "hbm_used_pct", "chips"}


def call(port, path, body=None, token=""):
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", headers=headers,
        data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            return e.code, json.loads(raw)
        except ValueError:
            return e.code, None


def one_pass(agent):
    """What one pass of the agent's loop leaves behind."""
    summary = agent.collect_and_push()
    with agent._lock:
        agent._last_summary = summary
        agent._last_summary_ts = time.time()


@pytest.mark.parametrize("token", ["", "s3cret"])
def test_agent_server_routes_equal_jax(native, table, token):
    ja, ta, _, _ = agents(table, shim_source=f"file:{table}")
    js, ts = jagent.AgentServer(ja), tagent.AgentServer(ta)
    js.start(0, auth_token=token)
    ts.start(0, auth_token=token)
    try:
        script = [("/health", None, token), ("/v1/telemetry", None, token),
                  ("/v1/assign", {"workloadUid": "wl",
                                  "chipIds": ["n0-chip-0", "n0-chip-1"]},
                   token),
                  ("pass", None, None),
                  ("/v1/telemetry", None, token), ("/health", None, token),
                  ("/v1/release", {"chipIds": ["n0-chip-0"]}, token),
                  ("pass", None, None), ("/v1/telemetry", None, token),
                  ("/v1/assign", {"chipIds": []}, token),
                  ("/v1/release", {}, token), ("/v1/nope", {}, token),
                  ("/v1/telemetry", None, ""), ("/v1/assign", {}, ""),
                  ("/health", None, "")]
        for path, body, tok in script:
            if path == "pass":
                one_pass(ja)
                one_pass(ta)
                continue
            got = call(ts.port, path, body, tok)
            want = call(js.port, path, body, tok)
            for out in (got, want):
                if isinstance(out[1], dict):
                    out[1].pop("timestamp", None)
                    age = out[1].pop("last_telemetry_age_s", None)
                    assert age is None or 0 <= age < 60
            assert got == want, path
        assert call(ts.port, "/v1/telemetry", token=token)[1]["workloads"] \
            == {"wl": ta.collect_and_push()["wl"]}
        if token:
            assert call(ts.port, "/v1/telemetry")[0] == 401
    finally:
        js.stop()
        ts.stop()
        ja.stop()
        ta.stop()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_main(module, args):
    proc = subprocess.Popen([PYTHON, "-m", module, *args], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    deadline = time.time() + 30
    line = ""
    while time.time() < deadline:
        line = proc.stdout.readline()
        if " up on " in line or not line:
            break
    if " up on " not in line:
        stop_main(proc)
        raise AssertionError(f"{module} never came up: {line!r}")
    return proc, line


def stop_main(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        assert proc.wait(timeout=10) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def wait_for(cond, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError("timed out")


def test_agent_main_reaches_the_jax_optimizer(native, table):
    svc = OptimizerService()
    seen = []
    ingest = svc.optimizer.ingest_telemetry
    svc.optimizer.ingest_telemetry = lambda wid, p: (seen.append((wid, p)),
                                                     ingest(wid, p))
    server = ThreadingHTTPServer(("127.0.0.1", 0),
                                 jopt_main.make_handler(svc, "tok"))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    chips = ["n0-chip-0", "n0-chip-2", "n0-chip-5"]
    try:
        j = NativeTPUClient(NODE, f"file:{table}")
        j.initialize()
        ja = jagent.NodeAgent(j, jagent.AgentConfig(node_name=NODE),
                              optimizer_service=JHTTPOptimizerClient(url,
                                                                     "tok"))
        ja.assign_chips("wl", chips)
        ja.collect_and_push()
        assert len(seen) == 1
        port = free_port()
        proc, _ = start_main(
            "k8s_gpu_workload_enhancer_tpu_torch.cmd.agent",
            ["--node-name", NODE, "--shim-source", f"file:{table}",
             "--telemetry-interval", "0.2", "--port", str(port),
             "--auth-token", "tok", "--optimizer-url", url])
        try:
            assert call(port, "/v1/assign", {"workloadUid": "wl",
                                             "chipIds": chips}, "tok") == (
                200, {"status": "ok"})
            wait_for(lambda: len(seen) >= 2)
            assert call(port, "/health", token="tok")[1]["shim_source"] == \
                f"file:{table}"
        finally:
            stop_main(proc)
    finally:
        server.shutdown()
        server.server_close()
    (jwid, jpoint), (twid, tpoint) = seen[0], seen[1]
    assert twid == jwid == "wl"
    assert dataclasses.replace(tpoint, timestamp=0) == \
        dataclasses.replace(jpoint, timestamp=0)
    assert tpoint.chips == 3 and tpoint.duty_cycle_pct > 0


def parse(text):
    out = {}
    for fam in text_string_to_metric_families(text):
        if fam.name in FAMILIES:
            out[fam.name] = (fam.type, {
                (s.name, tuple(sorted(s.labels.items()))): s.value
                for s in fam.samples})
    return out


def scrape(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        return r.read().decode()


def test_exporter_families_equal_jax(native, table):
    j = NativeTPUClient(NODE, f"file:{table}")
    j.initialize()
    disc = DiscoveryService(j, FakeKubernetesClient([NODE]),
                            DiscoveryConfig(enable_node_watch=False))
    disc.refresh_topology()
    jexp = PrometheusExporter(disc, config=JExporterConfig(
        enable_http=False))
    jexp.collect_once()
    want = parse(jexp.render().decode())
    assert set(want) == set(FAMILIES)
    proc, line = start_main(
        "k8s_gpu_workload_enhancer_tpu_torch.cmd.exporter",
        ["--shim-source", f"file:{table}", "--node-name", NODE,
         "--port", "0", "--collect-interval", "0.1"])
    try:
        port = int(line.rsplit(":", 1)[1])
        got = wait_for(lambda: (lambda p: p if p["ktwe_chip_healthy"][1]
                                else None)(parse(scrape(port))))
        assert got == want
        assert got["ktwe_cluster_chips_total"][1] == {
            ("ktwe_cluster_chips_total", (("state", "healthy"),)): 5.0,
            ("ktwe_cluster_chips_total", (("state", "unhealthy"),)): 1.0}
        table.write_text(REWRITE)
        disc.refresh_utilization()
        jexp.collect_once()
        want = parse(jexp.render().decode())
        got = wait_for(lambda: (lambda p: p if p == want else None)(
            parse(scrape(port))))
        assert got == want
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=10) as r:
            assert json.loads(r.read()) == {"status": "ok"}
    finally:
        stop_main(proc)
        disc.stop()
    assert [f"ktwe_{name}" for name, _, _ in texp.FAMILIES] == FAMILIES


# `auto` takes NVML first wherever its driver answers; these two cases
# hold the fall-through on a host without it.
no_nvml = pytest.mark.skipif(
    nvml_answers(), reason="NVML answers on this host, so auto picks nvml")


@no_nvml
def test_agent_main_auto_falls_back_to_file_table(tmp_path):
    table = tmp_path / "chip-metrics"
    table.write_text("0 91.5 85.0 12.5 16.0 170.0 55.0 0\n")
    port = free_port()
    proc, line = start_main(
        "k8s_gpu_workload_enhancer_tpu_torch.cmd.agent",
        ["--node-name", NODE, "--shim-source", "auto", "--file-table",
         str(table), "--telemetry-interval", "0.5", "--port", str(port)])
    try:
        assert line.strip() == f"ktwe-agent up on {NODE} (:{port})"
        assert call(port, "/health")[1]["shim_source"] == f"file:{table}"
    finally:
        stop_main(proc)


@no_nvml
def test_agent_main_auto_without_any_source_exits_with_message(tmp_path):
    proc = subprocess.run(
        [PYTHON, "-m", "k8s_gpu_workload_enhancer_tpu_torch.cmd.agent",
         "--node-name", NODE, "--shim-source", "auto",
         "--file-table", str(tmp_path / "absent")],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert "no metrics table" in proc.stderr


def test_agent_main_refuses_libtpu_naming_nvml():
    proc = subprocess.run(
        [PYTHON, "-m", "k8s_gpu_workload_enhancer_tpu_torch.cmd.agent",
         "--node-name", NODE, "--shim-source", "libtpu", "--port", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert "'nvml'" in proc.stderr and "libtpu" in proc.stderr
    with pytest.raises(ValueError, match="nvml"):
        NativeGPUClient(NODE, "libtpu").initialize()
    with pytest.raises(ValueError, match="nvml"):
        NativeGPUClient(NODE, "tpu").initialize()


def test_fake_topology_reports_what_the_jax_fake_reports():
    for shape in ("2x4", "4", "2x2x2"):
        j = FakeTPUClient([FakeSliceSpec(NODE, topology=shape)])
        t = FakeGPUClient(NODE, shape)
        assert fields(t.get_utilization(NODE), ["timestamp"]) == \
            fields(j.get_utilization(NODE), ["timestamp"])
        assert fields(t.get_health(NODE), ["last_checked"]) == \
            fields(j.get_health(NODE), ["last_checked"])
