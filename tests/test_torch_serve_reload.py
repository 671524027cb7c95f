"""The port's weight hot-swap against the JAX package's pins.

- `ContinuousBatchEngine.swap_params` (tests/unit/test_serving.py of the
  JAX package, `test_swap_params_live_and_validated`,
  `test_swap_params_mid_flight_requests_survive`): a matching tree swaps
  and later requests decode the new weights, giving the JAX
  `decode.generate` tokens on them exactly (f32); a mismatched tree is
  refused before anything changes; requests in flight survive.
- The paged engine (tests/unit/test_paged_kv.py,
  `test_swap_with_shared_prefix_heads_leaks_no_page`,
  `test_swap_mid_prefill_never_publishes_mixed_blocks`): swaps leak no
  page, and a prefill in flight across a swap never publishes its blocks.
- `ServeService.reload` and `POST /v1/admin/reload`
  (`test_serve_service_reload_route`,
  `test_serve_service_reload_maps_restore_failures`): 200 with the step
  and pause, 503 without a checkpoint source, 404 when none is found, 409
  for a failed restore or a mismatched tree (the old weights keep
  serving), 500 for any other swap failure; the serve main restores its
  params from --checkpoint-dir, and --watch-checkpoints swaps once the
  trainer writes a new step.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.models import decode as jdec
from k8s_gpu_workload_enhancer_tpu_torch.cmd import serve
from k8s_gpu_workload_enhancer_tpu_torch.cmd import trainer as tcli
from k8s_gpu_workload_enhancer_tpu_torch.models import decode as tdec
from k8s_gpu_workload_enhancer_tpu_torch.models import serving as tsrv
from k8s_gpu_workload_enhancer_tpu_torch.utils.httpjson import StatusError

import torch_parity as tp

PROMPT = [3, 17, 29, 5]


@pytest.fixture(scope="module")
def models():
    """(cfg, (jax A, port A), (jax B, port B)): two seeded weight sets."""
    _, ja, cfg, ta = tp.model(seed=0)
    jcfg, jb, _, tb = tp.model(seed=42)
    return jcfg, cfg, (ja, ta), (jb, tb)


def jax_tokens(jcfg, jparams, prompt, n):
    out = jdec.generate(jparams, jnp.asarray([prompt], jnp.int32), n, jcfg,
                        max_seq=jcfg.max_seq)
    return np.asarray(out)[0, len(prompt):].tolist()


def engine(params, cfg, **kw):
    kw = {"num_slots": 2, "prefill_len": 8, "decode_chunk": 3, **kw}
    return tsrv.ContinuousBatchEngine(params, cfg, device="cpu", **kw)


def paged(params, cfg, **kw):
    return engine(params, cfg, **{"decode_chunk": 4, "kv_block_len": 8, **kw})


def run(eng, prompt, n):
    rid = eng.submit(prompt, n)
    eng.run()
    return eng.result(rid).tokens


def test_swap_params_live_and_validated(models):
    jcfg, cfg, (ja, ta), (jb, tb) = models
    eng = engine(ta, cfg)
    want_a = jax_tokens(jcfg, ja, PROMPT, 8)
    assert run(eng, PROMPT, 8) == want_a
    with pytest.raises(ValueError, match="dtype"):
        eng.swap_params({k: (v.to(torch.bfloat16) if torch.is_tensor(v)
                             else {n: t.to(torch.bfloat16)
                                   for n, t in v.items()})
                         for k, v in tb.items()})
    with pytest.raises(ValueError, match="structure"):
        eng.swap_params({"not": "a", "param": "tree"})
    with pytest.raises(ValueError, match="shape"):
        eng.swap_params(dict(tb, final_ln=tb["final_ln"][:-1]))
    assert run(eng, PROMPT, 8) == want_a, \
        "rejected swaps must leave the old weights serving"
    assert eng.metrics()["resilience"]["weight_swaps"] == 0
    pause_ms = eng.swap_params(tb)
    assert pause_ms >= 0.0
    assert run(eng, PROMPT, 8) == jax_tokens(jcfg, jb, PROMPT, 8)
    m = eng.metrics()["resilience"]
    assert m["weight_swaps"] == 1
    assert m["swap_pause_ms_last"] == pytest.approx(pause_ms)
    assert m["swap_pause_ms_total"] == pytest.approx(pause_ms)
    assert set(m) >= {"errors", "weight_swaps", "swap_pause_ms_total",
                      "swap_pause_ms_last", "draining"}


def test_swap_params_mid_flight_requests_survive(models):
    _, cfg, (_, ta), (_, tb) = models
    eng = engine(ta, cfg, decode_chunk=2)
    rids = [eng.submit([3 + i, 17, 29], 10) for i in range(4)]
    eng.step()
    eng.step()                                   # some live, some queued
    eng.swap_params(tb)
    eng.run()
    for rid in rids:
        req = eng.result(rid)
        assert req.done and req.finish_reason == "length"
        assert len(req.tokens) == 10


def test_paged_swaps_with_shared_prefixes_leak_no_page(models):
    """Two requests sharing a 2-block prefix, a swap, the same pair on the
    new weights, a swap back: the second of each pair rides the first's
    pages, every answer is the JAX tokens of the weights it ran on, and
    each swap hands every unreferenced page back."""
    jcfg, cfg, (ja, ta), (jb, tb) = models
    eng = paged(ta, cfg)
    head = list(range(1, 17))
    pair = [head + [50, 51, 52], head + [60, 61]]
    free0 = eng._pool.free_count
    for jp, tp_ in ((ja, None), (jb, tb)):
        if tp_ is not None:
            eng.swap_params(tp_)
            assert eng._pool.free_count == free0
            assert eng._radix.match(pair[0]) == []
        matched0 = eng.metrics()["kv_cache"]["matched_tokens_total"]
        for prompt in pair:
            assert run(eng, prompt, 6) == jax_tokens(jcfg, jp, prompt, 6)
        assert eng.metrics()["kv_cache"]["matched_tokens_total"] \
            == matched0 + len(head)
    eng.swap_params(ta)
    kv = eng.metrics()["kv_cache"]
    assert eng._pool.free_count == free0
    assert kv["blocks_used"] == kv["blocks_cached"] == 0


def test_swap_mid_prefill_never_publishes_mixed_blocks(models):
    jcfg, cfg, (_, ta), (jb, tb) = models
    eng = paged(ta, cfg, prefill_interleave=1)
    decoy = eng.submit([9, 9], 40)          # keeps prefill throttled
    eng.step()
    prompt = list(range(1, 38))             # multi-chunk prefill
    victim = eng.submit(prompt, 4)
    eng.step()                              # mid-prefill
    assert eng._prefill is not None and eng._prefill.req.req_id == victim
    eng.swap_params(tb)
    eng.cancel(decoy)
    eng.run()
    assert eng.result(victim).done
    # Nothing of the straddling prompt entered the new-weights tree...
    assert eng._radix.match(prompt) == []
    # ...and every page came back (no root-unreachable leaks).
    m = eng.metrics()["kv_cache"]
    assert m["blocks_used"] == m["blocks_cached"]
    # A post-swap request with the same prompt is pure new-weights.
    assert run(eng, prompt, 4) == jax_tokens(jcfg, jb, prompt, 4)


def test_serve_service_reload_route(models):
    jcfg, cfg, (_, ta), (jb, tb) = models
    want_b = jax_tokens(jcfg, jb, PROMPT, 6)
    loads = []

    def loader(ckpt_dir=None):
        loads.append(ckpt_dir)
        return tb, 123

    svc = serve.ServeService(engine(ta, cfg, decode_chunk=2),
                             load_params=loader)
    try:
        out = svc.reload({"checkpointDir": "/some/dir"})
        assert out["status"] == "ok" and out["step"] == 123
        assert out["swapPauseMs"] >= 0 and svc.last_swapped_step == 123
        assert loads == ["/some/dir"]
        req = {"prompt": PROMPT, "maxNewTokens": 6, "timeoutSeconds": 60}
        assert svc.generate(dict(req))["tokens"] == want_b

        svc._load_params = lambda ckpt_dir=None: ({"wrong": "tree"}, 124)
        with pytest.raises(StatusError) as exc:
            svc.reload({})
        assert exc.value.code == 409
        assert svc.generate(dict(req))["tokens"] == want_b, \
            "rejected swap keeps the last weights"
        assert svc.last_swapped_step == 123

        svc._load_params = None
        with pytest.raises(StatusError) as exc:
            svc.reload({})
        assert exc.value.code == 503
    finally:
        svc.stop()


def test_serve_service_reload_maps_restore_failures(models):
    _, cfg, (_, ta), (_, tb) = models
    eng = engine(ta, cfg, decode_chunk=2)

    def broken_loader(ckpt_dir=None):
        raise RuntimeError("corrupt leaf 3: truncated array")

    svc = serve.ServeService(eng, load_params=broken_loader)
    try:
        with pytest.raises(StatusError) as exc:
            svc.reload({})
        assert exc.value.code == 409 and "corrupt" in str(exc.value)

        def missing_loader(ckpt_dir=None):
            raise FileNotFoundError("no checkpoint in /nowhere")

        svc._load_params = missing_loader
        with pytest.raises(StatusError) as exc:
            svc.reload({})
        assert exc.value.code == 404

        def failing_swap(new_params):
            raise RuntimeError("device lost mid copy")

        svc._load_params = lambda ckpt_dir=None: (tb, 5)
        eng.swap_params = failing_swap
        with pytest.raises(StatusError) as exc:
            svc.reload({})
        assert exc.value.code == 500 and "old weights" in str(exc.value)
        assert svc.last_swapped_step is None
        out = svc.generate({"prompt": [3, 5], "maxNewTokens": 4,
                            "timeoutSeconds": 60})
        assert out["status"] == "ok", "old weights keep serving"
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# The serve main over HTTP, on checkpoints the trainer main wrote
# ---------------------------------------------------------------------------

DIMS = ["--vocab-size", "256", "--d-model", "64", "--n-layers", "2",
        "--n-heads", "2", "--d-ff", "128"]
SERVE = ["--device", "cpu", "--port", "0", "--max-seq", "64",
         "--num-slots", "2", "--prefill-len", "16", "--decode-chunk", "4",
         "--drain-timeout", "5"] + DIMS


def train(ckpt, steps, *extra):
    """The trainer main to `steps`, resuming from `ckpt`; a learning rate
    high enough that one step changes the greedy tokens."""
    assert tcli.main(["--device", "cpu", "--batch-size", "2", "--seq-len",
                      "32", "--steps", str(steps), "--checkpoint-dir", ckpt,
                      "--resume", "--learning-rate", "50"] + DIMS
                     + list(extra)) == 0


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """dir a: step 1; dir b: steps 1 and 2 (the same run); dir x: another
    model width."""
    root = tmp_path_factory.mktemp("reload")
    a, b, x = (str(root / n) for n in "abx")
    train(a, 1)
    train(b, 1)
    train(b, 2)
    assert tcli.main(["--device", "cpu", "--batch-size", "2", "--seq-len",
                      "32", "--steps", "1", "--checkpoint-dir", x,
                      "--vocab-size", "256", "--d-model", "32",
                      "--n-layers", "2", "--n-heads", "2", "--d-ff",
                      "64"]) == 0
    return a, b, x


def expected(ckpt, prompt, n, step=None):
    args = serve.build_parser().parse_args(SERVE)
    cfg = serve.serve_config(args, torch.device("cpu"))
    params, got_step = serve.make_params_loader(
        cfg, ckpt, False, torch.device("cpu"))()
    assert step is None or got_step == step
    out = tdec.generate(params, torch.as_tensor([prompt]), n, cfg)
    return out[0, len(prompt):].tolist()


def running(args):
    stop, ready, port, result = (threading.Event(), threading.Event(), {},
                                 {})

    def on_ready(p):
        port["p"] = p
        ready.set()

    th = threading.Thread(target=lambda: result.update(
        rc=serve.main(args, stop=stop, on_ready=on_ready)), daemon=True)
    th.start()
    assert ready.wait(60), "serve main did not come up"
    return port["p"], stop, th, result


def finish(stop, th, result):
    stop.set()
    th.join(30)
    assert not th.is_alive() and result.get("rc") == 0


def call(port, path, body=None, token=None):
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", headers=headers,
        data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def generate(port, token=None):
    code, out = call(port, "/v1/generate", {"prompt": PROMPT,
                                            "maxNewTokens": 8,
                                            "timeoutSeconds": 60}, token)
    assert code == 200, out
    return out["tokens"]


@pytest.mark.parametrize("kv_block_len", [0, 8])
def test_reload_route_over_http(ckpts, kv_block_len, capsys):
    a, b, x = ckpts
    args = SERVE + ["--checkpoint-dir", a, "--auth-token", "s3cret",
                    "--kv-block-len", str(kv_block_len)]
    port, stop, th, result = running(args)
    try:
        assert "restored params from step 1" in capsys.readouterr().out
        assert generate(port, "s3cret") == expected(a, PROMPT, 8, step=1)
        code, _ = call(port, "/v1/admin/reload", {})
        assert code == 401                    # behind the bearer
        code, out = call(port, "/v1/admin/reload", {"checkpointDir": b},
                         "s3cret")
        assert code == 200 and out["status"] == "ok" and out["step"] == 2
        assert out["swapPauseMs"] >= 0
        want_b = expected(b, PROMPT, 8, step=2)
        assert generate(port, "s3cret") == want_b != expected(a, PROMPT, 8)
        code, out = call(port, "/v1/admin/reload",
                         {"checkpointDir": b + "-missing"}, "s3cret")
        assert code == 404, out
        code, out = call(port, "/v1/admin/reload", {"checkpointDir": x},
                         "s3cret")
        assert code == 409 and "shape" in out["error"]
        assert generate(port, "s3cret") == want_b
        code, m = call(port, "/v1/metrics", token="s3cret")
        assert m["metrics"]["resilience"]["weight_swaps"] == 1
        if kv_block_len:
            kv = m["metrics"]["kv_cache"]
            assert kv["blocks_used"] == kv["blocks_cached"]
    finally:
        finish(stop, th, result)


def test_reload_without_a_checkpoint_source_is_503():
    port, stop, th, result = running(SERVE)
    try:
        code, out = call(port, "/v1/admin/reload", {})
        assert code == 503 and "checkpoint" in out["error"]
    finally:
        finish(stop, th, result)


def test_watcher_swaps_once_the_trainer_writes_a_new_step(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    train(ckpt, 1)
    train(ckpt + "-1", 1)                   # the same step 1, kept
    port, stop, th, result = running(
        SERVE + ["--checkpoint-dir", ckpt, "--watch-checkpoints", "0.05"])
    try:
        time.sleep(0.3)                     # ticks on an unchanged step
        code, m = call(port, "/v1/metrics")
        assert m["metrics"]["resilience"]["weight_swaps"] == 0
        train(ckpt, 2)
        deadline = time.time() + 30
        while time.time() < deadline:
            code, m = call(port, "/v1/metrics")
            if m["metrics"]["resilience"]["weight_swaps"]:
                break
            time.sleep(0.05)
        time.sleep(0.3)                     # and no second swap after it
        code, m = call(port, "/v1/metrics")
        assert m["metrics"]["resilience"]["weight_swaps"] == 1
        want = expected(ckpt, PROMPT, 8, step=2)
        assert generate(port) == want != expected(ckpt + "-1", PROMPT, 8)
    finally:
        finish(stop, th, result)
