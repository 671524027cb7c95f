"""The port's FaultLab against the JAX package's.

- The schedule: the port's `FaultPlan.decide` equals the JAX plan's for the
  same (seed, site, occurrence) over 1000 draws a site, and so do
  `TargetedPlan`, `from_env` and the counters `site` keeps.
- The engine's sites sit at the JAX engine's boundaries: an inert plan
  counts as many crossings of each site on the port's engine as on the JAX
  engine in one scenario, dense and paged.
- Containment: under the same `TargetedPlan` at each engine site, the
  port's engine and the JAX engine (its XLA attention, the engine being the
  subject) give every request the same finish reason and error, the same
  error counts by cause and the same tokens; the requests no fault touched
  get the unfaulted engine's tokens, and a request after the fault too.
- The serve main activates a plan from `KTWE_FAULT_*`, prints it, counts
  the injections in /v1/metrics' `faultlab` block and serves
  `ktwe_fault_injections_total`.
"""

import json
import socket
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu import faultlab as jfl
from k8s_gpu_workload_enhancer_tpu.cmd.serve import \
    SERVING_FAMILIES as JAX_FAMILIES
from k8s_gpu_workload_enhancer_tpu.models import serving as jsrv
from k8s_gpu_workload_enhancer_tpu.models import transformer as jtf
from k8s_gpu_workload_enhancer_tpu_torch import faultlab as tfl
from k8s_gpu_workload_enhancer_tpu_torch.cmd import serve
from k8s_gpu_workload_enhancer_tpu_torch.models import serving as tsrv
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf

import torch_parity  # noqa: F401  (one intra-op thread a process)

DIMS = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
            d_ff=64, max_seq=64)
ENGINE = dict(num_slots=2, prefill_len=8, decode_chunk=3)
KINDS = [0, 8]
KIND_IDS = ["dense", "paged"]
ENGINE_SITES = ("engine.dispatch", "engine.collect", "engine.commit",
                "engine.paged_admit", "engine.prefill")
# Crossed only on a serving mesh (tests/test_torch_mesh_serving.py).
MESH_SITES = ("engine.device_loss",)
# The host KV tier's sites (tests/test_torch_kvhost.py drives them).
KVHOST_SITES = ("kvhost.dma", "kvhost.fetch", "kvhost.corrupt")
CAUSES = ("dispatch", "collect", "commit", "prefill", "watchdog")


@pytest.fixture(scope="module")
def model():
    jcfg = jtf.TransformerConfig(**DIMS, dtype=jnp.float32, use_flash=False,
                                 use_ring_attention=False)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = ttf.TransformerConfig(**DIMS, dtype=torch.float32)
    return jcfg, jp, tcfg, ttf.params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


@pytest.fixture(autouse=True)
def inert_after():
    yield
    jfl.deactivate()
    tfl.deactivate()


def engines(model, block_len):
    jcfg, jp, tcfg, params = model
    return (jsrv.ContinuousBatchEngine(jp, jcfg, kv_block_len=block_len,
                                       **ENGINE),
            tsrv.ContinuousBatchEngine(params, tcfg, device="cpu",
                                       kv_block_len=block_len, **ENGINE))


# ---------------------------------------------------------------- schedule


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_schedule_equals_jax(seed):
    for rate in (0.05, 0.5):
        jp_, tp_ = jfl.FaultPlan(seed, rate=rate), tfl.FaultPlan(seed,
                                                                 rate=rate)
        for name in list(jfl.SITES) + ["engine.unlisted"]:
            got = [tp_.decide(name, i) for i in range(1000)]
            assert got == [jp_.decide(name, i) for i in range(1000)], name
            assert 0 < sum(got) < 1000
    tgt = {"engine.commit": [0, 3], "engine.prefill": [2]}
    jt, tt = jfl.TargetedPlan(tgt), tfl.TargetedPlan(tgt)
    for name in ENGINE_SITES:
        assert ([tt.decide(name, i) for i in range(8)]
                == [jt.decide(name, i) for i in range(8)])
    # The port keeps the engine's (the mesh's device loss included) and the
    # host tier's sites only, each of JAX's kind.
    assert set(tfl.SITES) == set(ENGINE_SITES + MESH_SITES + KVHOST_SITES)
    for name, (kind, _) in tfl.SITES.items():
        assert kind == jfl.SITES[name][0] == (
            "device-loss" if name in MESH_SITES else "error"), name
    assert (tfl.ENV_SEED, tfl.ENV_RATE, tfl.ENV_SITES) == (
        jfl.ENV_SEED, jfl.ENV_RATE, jfl.ENV_SITES)


def test_from_env_and_site_counters_equal_jax(monkeypatch):
    assert tfl.from_env() is None and jfl.from_env() is None
    monkeypatch.setenv("KTWE_FAULT_SEED", "41")
    monkeypatch.setenv("KTWE_FAULT_RATE", "0.3")
    monkeypatch.setenv("KTWE_FAULT_SITES", "engine.commit,engine.dispatch")
    seen = []
    for fl in (jfl, tfl):
        plan = fl.activate(fl.from_env())
        trail = [(plan.seed, plan.rate, plan.sites)]
        for i in range(60):
            name = ENGINE_SITES[i % len(ENGINE_SITES)]
            try:
                fl.site(name)
                trail.append(None)
            except fl.InjectedFault as e:
                trail.append(str(e))
        trail.append(fl.snapshot())
        trail.append(fl.injections_total())
        fl.deactivate()
        trail.append(fl.snapshot()["active"])
        seen.append(trail)
    assert seen[0] == seen[1]
    assert seen[1][-2] > 0


# ------------------------------------------------------------------ engine


def scenario(eng, plan=None, fl=None):
    """Three staggered requests through two slots (a 20-token prompt takes
    three prefill chunks), then a fourth after they finished. Returns
    every request's outcome and the errors by cause."""
    if plan is not None:
        fl.activate(plan)
    r0 = eng.submit([3, 17, 29, 5], 12)
    eng.step()
    r1 = eng.submit([(5 * i + 2) % 128 for i in range(20)], 9)
    r2 = eng.submit([40, 2, 77], 7)
    eng.run()
    r3 = eng.submit([9, 8, 7, 6, 5], 8)
    eng.run()
    out = [(eng.result(r).finish_reason, eng.result(r).error,
            eng.result(r).tokens) for r in (r0, r1, r2, r3)]
    errors = eng.metrics()["resilience"]["errors"]
    errors = {c: errors.get(c, 0) for c in CAUSES}
    return out, errors


@pytest.mark.parametrize("block_len", KINDS, ids=KIND_IDS)
def test_sites_cross_as_often_as_jax(model, block_len):
    """An inert plan (no site fires) counts every crossing: the port's
    engine crosses each site as often as the JAX engine does."""
    counts = []
    for eng, fl in zip(engines(model, block_len), (jfl, tfl)):
        scenario(eng, fl.FaultPlan(0, rate=0.0, sites={}), fl)
        occ = fl.snapshot()["occurrences_by_site"]
        counts.append({s: occ.get(s, 0) for s in ENGINE_SITES})
        fl.deactivate()
    assert counts[0] == counts[1]
    assert counts[1]["engine.dispatch"] > 2
    assert counts[1]["engine.paged_admit"] == (4 if block_len else 0)


CONTAINMENT = [("engine.dispatch", 2, 0), ("engine.dispatch", 2, 8),
               ("engine.collect", 2, 0), ("engine.collect", 2, 8),
               ("engine.commit", 1, 0), ("engine.commit", 1, 8),
               ("engine.prefill", 1, 0), ("engine.prefill", 1, 8),
               ("engine.paged_admit", 1, 8)]


@pytest.mark.parametrize(
    "site,occurrence,block_len", CONTAINMENT,
    ids=[f"{s.split('.')[1]}-{KIND_IDS[b > 0]}" for s, _, b in CONTAINMENT])
def test_containment_matches_jax(model, site, occurrence, block_len):
    (jeng, teng), (jclean, _) = (engines(model, block_len),
                                 engines(model, block_len))
    clean, _ = scenario(jclean)
    want, jerr = scenario(jeng, jfl.TargetedPlan({site: [occurrence]}), jfl)
    got, terr = scenario(teng, tfl.TargetedPlan({site: [occurrence]}), tfl)
    assert tfl.injections_total() == jfl.injections_total() == 1
    assert terr == jerr
    assert got == want
    touched = [i for i, (reason, _, _) in enumerate(got) if reason == "error"]
    if site == "engine.paged_admit":
        # The head stays queued and is admitted on the next step.
        assert touched == [] and terr["prefill"] == 1
    else:
        assert touched and f"site={site}" in got[touched[0]][1]
    for i, (reason, _, toks) in enumerate(got):
        if i not in touched:
            assert (reason, toks) == (clean[i][0], clean[i][2])
    assert got[3][0] == "length", "the engine must keep serving"
    if block_len:
        kv = teng.metrics()["kv_cache"]
        assert kv["blocks_free"] + kv["blocks_cached"] == kv["blocks_total"]


# -------------------------------------------------------------- serve main


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_main_counts_injections(monkeypatch, capsys):
    """KTWE_FAULT_* at start: the plan is printed, every commit fails (an
    error view naming the site), and /v1/metrics' faultlab block and
    ktwe_fault_injections_total on the metrics port count the injections
    (a family the JAX serve has under the same name)."""
    monkeypatch.setenv("KTWE_FAULT_SEED", "3")
    monkeypatch.setenv("KTWE_FAULT_RATE", "1.0")
    monkeypatch.setenv("KTWE_FAULT_SITES", "engine.commit")
    args = ["--device", "cpu", "--port", "0", "--vocab-size", "128",
            "--d-model", "32", "--n-layers", "1", "--n-heads", "2",
            "--d-ff", "64", "--max-seq", "32", "--num-slots", "1",
            "--prefill-len", "8", "--decode-chunk", "2", "--drain-timeout",
            "2", "--metrics-port", str(_free_port())]
    stop, ready, port, result = (threading.Event(), threading.Event(), {},
                                 {})

    def on_ready(p):
        port["p"] = p
        ready.set()
    th = threading.Thread(target=lambda: result.update(rc=serve.main(
        args, stop=stop, on_ready=on_ready)), daemon=True)
    th.start()
    try:
        assert ready.wait(60)
        base = f"http://127.0.0.1:{port['p']}"
        req = urllib.request.Request(
            f"{base}/v1/generate", method="POST",
            data=json.dumps({"prompt": [1, 2, 3], "maxNewTokens": 6,
                             "timeoutSeconds": 30}).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            view = json.loads(resp.read())
        assert view["status"] == "error" and view["finishReason"] == "error"
        assert "site=engine.commit" in view["error"]
        with urllib.request.urlopen(f"{base}/v1/metrics", timeout=30) as r:
            m = json.loads(r.read())["metrics"]
        block = m["faultlab"]
        assert block["active"] and block["seed"] == 3
        assert block["injections_by_site"] == {"engine.commit": 1}
        assert m["errors"]["commit"] == 1
        assert block["last"] == "engine.commit#0"
        fam = "ktwe_fault_injections_total"
        assert fam in serve.SERVING_FAMILIES and fam in JAX_FAMILIES
        mport = int(args[args.index("--metrics-port") + 1])
        with urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics",
                                    timeout=30) as r:
            lines = r.read().decode().splitlines()
        assert f"{fam} 1.0" in lines
    finally:
        stop.set()
        th.join(30)
    assert result.get("rc") == 0
    out = capsys.readouterr().out
    assert "[faultlab] ACTIVE: FaultPlan(seed=3, rate=1.0, sites=" \
           "{'engine.commit': 1.0})" in out
