"""The serve and generate mains on a serving mesh, held to the JAX package
on the CPU.

- `parse_mesh_flag` against the JAX serve's on its cases; `ServeService`'s
  `mesh` block and the `ktwe_serving_mesh_*` series on a thread gang of
  (dp=2, tp=4) running the paged engine (JAX test_mesh_serving.py:223-280),
  and a single-device replica's block equal to the JAX one's; the peak
  behind the serve's MFU gauge and the trainer's MFU, one constant.
- The serve main's --mesh flag errors (tp dividing --n-heads and --d-ff
  among them, and, as on one device, --kv-host-blocks without
  --kv-block-len) exit 2 before any model loads; --mesh 1,2 with the host
  tier passes them. Like the JAX serve it has no MoE flag: the engine
  refuses MoE on a mesh (test_torch_mesh_serving.py).
- The host tier behind ServeService on a (1, 2) thread gang: the
  `kvhost` block and the ktwe_serving_kvhost_* series equal a
  single-device replica's after the same traffic.
- A 2-rank gloo gang of the serve main started from the launcher env
  (COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID) with --mesh 1,2: rank 0
  answers /v1/generate as a single-device replica does, its /v1/metrics
  `mesh` block reads dp 1, tp 2 (the JAX registry parses 2 devices), and
  both ranks exit 0 on SIGTERM.
- The generate main: --tensor-parallel 2 on a 2-rank gang prints the
  tokens of --tensor-parallel 1; --tensor-parallel 3 exits 2 with the JAX
  main's divisibility error.
"""

import contextlib
import io
import json
import os
import pathlib
import signal
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.cmd import serve as jserve
from k8s_gpu_workload_enhancer_tpu.fleet.registry import ReplicaRegistry
from k8s_gpu_workload_enhancer_tpu_torch.cmd import generate
from k8s_gpu_workload_enhancer_tpu_torch.cmd import serve
from k8s_gpu_workload_enhancer_tpu_torch.cmd import trainer as trainer_cli
from k8s_gpu_workload_enhancer_tpu_torch.models import decode as tdecode
from k8s_gpu_workload_enhancer_tpu_torch.models import serving as tsrv
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.train import profiling

import torch_gang
import torch_parity  # noqa: F401  (one intra-op thread a process)
from test_torch_mesh_serving import on_thread_gang

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--d-model", "64", "--n-layers", "2",
        "--n-heads", "2", "--d-ff", "128", "--vocab-size", "256",
        "--max-seq", "64", "--prefill-len", "16", "--num-slots", "2"]
GEN = ["--device", "cpu", "--batch-size", "2", "--prompt-len", "8",
       "--gen-len", "6", "--d-model", "64", "--n-layers", "2",
       "--n-heads", "2", "--d-ff", "128", "--vocab-size", "256"]
DIMS = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
            d_ff=64, max_seq=64)
GANG_ENV = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")


@pytest.fixture(autouse=True)
def no_gang_env(monkeypatch):
    for k in GANG_ENV + ("KTWE_MESH",):
        monkeypatch.delenv(k, raising=False)


# ------------------------------------------------------------ ServeService


def test_parse_mesh_flag_is_the_jax_parse():
    for v in ("", "1", "1,1", "2,4", "4", "1,2", " 2,2 "):
        assert serve.parse_mesh_flag(v) == jserve.parse_mesh_flag(v), v
    assert serve.parse_mesh_flag("4") == (1, 4)          # bare N = tp=N
    for bad in ("2,4,1", "banana", "0,2", "2,-1"):
        with pytest.raises(ValueError):
            jserve.parse_mesh_flag(bad)
        with pytest.raises(ValueError):
            serve.parse_mesh_flag(bad)


def test_serve_service_reports_mesh_shape_and_mfu():
    """A paged engine on a thread gang of (2, 4) behind ServeService: the
    `mesh` block (devices 8, dp 2, tp 4, a live MFU) and the mesh series."""
    cfg = ttf.TransformerConfig(**DIMS, dtype=torch.float32)
    full = ttf.init_params(torch.Generator().manual_seed(0), cfg)

    def rank(mesh):
        eng = tsrv.ContinuousBatchEngine(
            tdecode.shard_params_for_serving(full, cfg, mesh), cfg,
            device="cpu", mesh=mesh, num_slots=2, prefill_len=8,
            decode_chunk=3, kv_block_len=8)
        if not mesh.is_driver:
            eng.follow()
            return None
        svc = serve.ServeService(eng, mesh_shape=(2, 4))
        try:
            out = svc.generate({"prompt": [3, 5, 7], "maxNewTokens": 6,
                                "timeoutSeconds": 60})
            return out, svc.metrics({})["metrics"], svc.prometheus_series()
        finally:
            svc.stop()
            eng.stop_followers()
    out, m, series = on_thread_gang(2, 4, rank)[0]
    assert out["status"] == "ok" and len(out["tokens"]) == 6
    assert m["mesh"]["devices"] == 8
    assert m["mesh"]["dp"] == 2 and m["mesh"]["tp"] == 4
    assert m["mesh"]["shape"] == "dp=2,tp=4" and m["mesh"]["degraded"] == 0
    assert m["mesh"]["per_slice_mfu_pct"] > 0.0
    assert series["ktwe_serving_mesh_devices"] == 8.0
    assert series["ktwe_serving_mesh_dp"] == 2.0
    assert series["ktwe_serving_mesh_tp"] == 4.0
    assert series["ktwe_serving_mesh_degraded"] == 0.0
    assert series["ktwe_serving_evacuated_requests_total"] == 0.0
    assert series["ktwe_serving_request_errors_device_loss_total"] == 0.0
    assert series["ktwe_serving_mesh_per_slice_mfu_pct"] >= 0.0
    assert ReplicaRegistry._parse_load(m).mesh_devices == 8


def test_single_device_mesh_block_is_the_jax_one():
    cfg = ttf.TransformerConfig(**DIMS, dtype=torch.float32)
    eng = tsrv.ContinuousBatchEngine(
        ttf.init_params(torch.Generator().manual_seed(0), cfg), cfg,
        device="cpu", num_slots=2, prefill_len=8, decode_chunk=3)
    svc = serve.ServeService(eng)
    try:
        assert svc.metrics({})["metrics"]["mesh"] == {
            "devices": 1, "dp": 1, "tp": 1, "shape": "dp=1,tp=1",
            "degraded": 0, "per_slice_mfu_pct": 0.0}
    finally:
        svc.stop()


def test_one_definition_of_the_peak():
    """The serve's MFU gauge and the trainer's MFU read the one H100 peak
    (train/profiling.py); on the CPU the gauge reads the JAX serve's token
    0.4."""
    peak = profiling.H100_BF16_PEAK_TFLOPS
    assert serve.peak_tflops_per_device(torch.device("cuda")) == peak
    assert serve.H100_BF16_PEAK_TFLOPS is peak
    assert trainer_cli.H100_BF16_PEAK_TFLOPS is peak
    assert profiling.StepTimer().peak_tflops == peak
    assert serve.peak_tflops_per_device(torch.device("cpu")) == \
        jserve.peak_tflops_per_device() == 0.4


# --------------------------------------------------------- the serve main


@pytest.mark.parametrize("argv,procs,msg", [
    (["--mesh", "banana"], 1, "--mesh must be 'dp,tp' integers, got "
                              "'banana'"),
    (["--mesh", "2,4"], 1, "--mesh 2,4 needs 8 devices; this gang has 1"),
    (["--mesh", "1,3"], 3, "--mesh tp=3 must divide --n-heads (2)"),
    (["--mesh", "3,1", "--num-slots", "2"], 3,
     "--mesh dp=3 must divide --num-slots (2)"),
    (["--mesh", "1,2", "--kv-host-blocks", "4"], 2,
     "--kv-host-blocks requires --kv-block-len > 0"),
    (["--mesh", "1,2", "--d-ff", "129"], 2,
     "--mesh tp=2 must divide --d-ff (129)"),
], ids=["malformed", "devices", "tp-divides", "dp-divides", "host-tier",
        "tp-divides-d-ff"])
def test_mesh_flag_errors_exit_2(monkeypatch, capsys, argv, procs, msg):
    """Each in flag language before the gang or the model comes up."""
    if procs > 1:
        monkeypatch.setenv("NUM_PROCESSES", str(procs))
    with pytest.raises(SystemExit) as e:
        serve.main(TINY + argv)
    assert e.value.code == 2
    assert msg in capsys.readouterr().err


def test_mesh_flag_takes_the_host_tier(monkeypatch):
    """--mesh 1,2 --kv-block-len 8 --kv-host-blocks 4 is no longer an
    error: the flags give the mesh, and the tier serves on it."""
    monkeypatch.setenv("NUM_PROCESSES", "2")
    parser = serve.build_parser()
    args = parser.parse_args(TINY + ["--mesh", "1,2", "--kv-block-len", "8",
                                     "--kv-host-blocks", "4"])
    assert serve.check_mesh(args, parser, 2) == (1, 2)


def test_mesh_kvhost_block_and_series_are_one_devices():
    """ServeService over the paged engine with the host tier on a (1, 2)
    thread gang: after a request, an eviction into the tier and the
    request again (restored from it), the `kvhost` block (less its wall
    clock) and every ktwe_serving_kvhost_* series equal a single-device
    replica's after the same traffic."""
    cfg = ttf.TransformerConfig(**DIMS, dtype=torch.float32)
    full = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    kw = dict(num_slots=2, prefill_len=8, decode_chunk=3, kv_block_len=8,
              kv_num_blocks=16, kv_host_blocks=8)
    body = {"prompt": list(range(1, 28)), "maxNewTokens": 6,
            "timeoutSeconds": 60}

    def traffic(eng, mesh_shape=None):
        svc = serve.ServeService(eng, mesh_shape=mesh_shape)
        try:
            first = svc.generate(dict(body))
            with svc._lock:
                eng._radix.evict(eng.metrics()["kv_cache"]["blocks_cached"])
            second = svc.generate(dict(body))
            kv = dict(svc.metrics({})["metrics"]["kvhost"])
            kv.pop("dma_seconds_total")
            series = {k: v for k, v in svc.prometheus_series().items()
                      if k.startswith("ktwe_serving_kvhost_")
                      and "dma_seconds" not in k}
            return first["tokens"], second["tokens"], kv, series
        finally:
            svc.stop()

    def rank(mesh):
        eng = tsrv.ContinuousBatchEngine(
            tdecode.shard_params_for_serving(full, cfg, mesh), cfg,
            device="cpu", mesh=mesh, **kw)
        if not mesh.is_driver:
            eng.follow()
            return None
        try:
            return traffic(eng, (1, 2))
        finally:
            eng.stop_followers()
    got = on_thread_gang(1, 2, rank)[0]
    want = traffic(tsrv.ContinuousBatchEngine(full, cfg, device="cpu", **kw))
    assert got == want
    assert got[0] == got[1] and got[2]["prefetches_total"] == 3
    assert got[3]["ktwe_serving_kvhost_offloads_total"] == 3.0


def _spawn(module: str, argv: list, world: int, port: int) -> list:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT),
               COORDINATOR_ADDRESS=f"localhost:{port}",
               NUM_PROCESSES=str(world))
    return [subprocess.Popen(
        [sys.executable, "-m", module] + argv,
        env=dict(env, PROCESS_ID=str(r)), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _http(url: str, body=None, timeout: float = 60):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_serve_gang_of_two_answers_as_one_device():
    """rank 0 of a --mesh 1,2 gang answers as a single-device replica of
    the same seed and widths; both ranks exit 0 on SIGTERM."""
    body = {"prompt": [5, 6, 7, 8, 9], "maxNewTokens": 8,
            "timeoutSeconds": 120}
    args = serve.build_parser().parse_args(TINY + ["--port", "0"])
    one = serve.ServeService(serve.build_engine(args))
    try:
        want = one.generate(dict(body))
    finally:
        one.stop()
    http = torch_gang.free_port()
    procs = _spawn("k8s_gpu_workload_enhancer_tpu_torch.cmd.serve",
                   TINY + ["--port", str(http), "--mesh", "1,2"], 2,
                   torch_gang.free_port())
    url = f"http://127.0.0.1:{http}"
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                _http(url + "/health", timeout=2)
                break
            except OSError:
                if time.monotonic() > deadline or any(
                        p.poll() is not None for p in procs):
                    raise
                time.sleep(0.2)
        got = _http(url + "/v1/generate", body)
        m = _http(url + "/v1/metrics")["metrics"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        outs = [p.communicate(timeout=60) for p in procs]
    assert got["status"] == "ok"
    assert got["tokens"] == want["tokens"]
    assert m["mesh"] == dict(m["mesh"], devices=2, dp=1, tp=2,
                             shape="dp=1,tp=2", degraded=0)
    assert ReplicaRegistry._parse_load(m).mesh_devices == 2
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:]
                                                     for o in outs]
    assert "rank 1 stopped" in outs[1][0]


# ------------------------------------------------------ the generate main


def _generate_line(argv: list) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert generate.main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_generate_tensor_parallel_prints_the_tp1_tokens():
    want = _generate_line(GEN + ["--tensor-parallel", "1"])
    procs = _spawn("k8s_gpu_workload_enhancer_tpu_torch.cmd.generate",
                   GEN + ["--tensor-parallel", "2"], 2,
                   torch_gang.free_port())
    outs = [p.communicate(timeout=180) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:]
                                                     for o in outs]
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    assert outs[1][0].strip() == ""          # rank 0 prints the line
    assert got["sample_tail"] == want["sample_tail"]
    assert got["tensor_parallel"] == 2 and got["devices"] == 2


def test_generate_tensor_parallel_must_divide(capsys):
    with pytest.raises(SystemExit) as e:
        generate.main(GEN + ["--tensor-parallel", "3"])
    assert e.value.code == 2
    assert ("--tensor-parallel 3 must divide the device count (1), "
            "n_heads, d_ff, and vocab_size") in capsys.readouterr().err



@pytest.mark.parametrize("int8", [False, True], ids=["plain", "int8"])
def test_params_are_finished_and_cut_leaf_by_leaf(int8):
    """The serve main's params reach a rank's card leaf by leaf: the seeded
    init with each leaf finished and cut to the rank's block as it is
    drawn (the random init), and a tree finished on the host with the
    rank's blocks placed after (a checkpoint on a mesh), both equal the
    rank's blocks of the whole tree cast and quantized at once."""
    from k8s_gpu_workload_enhancer_tpu_torch.ops.quant import quantize_params
    from test_torch_mesh_serving import same_tree
    args = serve.build_parser().parse_args(TINY + (["--int8"] * int8))
    cfg = serve.serve_config(args, torch.device("cpu"))

    def drawn(**kw):
        return ttf.init_params(torch.Generator().manual_seed(args.seed), cfg,
                               **kw)
    whole = tsrv._map_leaves(lambda t: t.to(cfg.dtype), drawn())
    whole = quantize_params(whole) if int8 else whole

    def rank(mesh):
        want = tdecode.shard_params_for_serving(whole, cfg, mesh)
        init = drawn(finish=lambda name, t: serve._finish_leaf(
            name, t, cfg, int8, mesh=mesh))
        host = tdecode.shard_params_for_serving(
            serve._finish_params(drawn(), cfg, int8), cfg, mesh,
            torch.device("cpu"))
        return same_tree(init, want), same_tree(host, want)
    assert on_thread_gang(1, 2, rank) == [(True, True)] * 2
