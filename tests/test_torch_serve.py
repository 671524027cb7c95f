"""The port's serve main over HTTP on --device cpu at tiny dims:
/v1/generate (blocking and streamed) returns the port's `generate` tokens
on the same seeded weights, /health and /v1/metrics answer, bad requests
get 400, and a drain turns new submits and /health into 503. With
--kv-block-len the server runs the paged engine: the same greedy tokens as
the dense one, and a `kv_cache` block in /v1/metrics."""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from k8s_gpu_workload_enhancer_tpu_torch.cmd import serve
from k8s_gpu_workload_enhancer_tpu_torch.models import decode

import torch_parity  # noqa: F401  (one intra-op thread a process)

ARGS = ["--device", "cpu", "--port", "0", "--seed", "5", "--vocab-size",
        "128", "--d-model", "64", "--n-layers", "2", "--n-heads", "2",
        "--d-ff", "128", "--max-seq", "64", "--num-slots", "2",
        "--prefill-len", "16", "--decode-chunk", "4", "--drain-timeout", "5"]


def _serve(args):
    """Run serve.main(args) in a thread; yields its port, then drains it."""
    stop = threading.Event()
    ready = threading.Event()
    port = {}
    result = {}

    def on_ready(p):
        port["p"] = p
        ready.set()

    th = threading.Thread(target=lambda: result.update(
        rc=serve.main(args, stop=stop, on_ready=on_ready)), daemon=True)
    th.start()
    assert ready.wait(60), "serve main did not come up"
    yield port["p"]
    stop.set()
    th.join(30)
    assert not th.is_alive() and result.get("rc") == 0


@pytest.fixture(scope="module")
def server():
    yield from _serve(ARGS)


@pytest.fixture(scope="module")
def paged_server():
    yield from _serve(ARGS + ["--kv-block-len", "8"])


def _expected(prompt, n):
    """The port's generate on the weights the server built."""
    eng = serve.build_engine(serve.build_parser().parse_args(ARGS))
    out = decode.generate(eng.params, torch.as_tensor([prompt]), n, eng.cfg)
    return out[0, len(prompt):].tolist()


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=60)


def test_generate_blocking_and_streamed_match_generate(server):
    prompt = [3, 17, 29, 5, 8, 100, 7, 7, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    want = _expected(prompt, 12)
    with _post(server, {"prompt": prompt, "maxNewTokens": 12}) as resp:
        reply = json.loads(resp.read())
    assert reply["status"] == "ok" and reply["tokens"] == want
    assert reply["finishReason"] == "length" and reply["ttftMs"] > 0
    assert len(reply["logprobs"]) == 12
    with _post(server, {"prompt": prompt, "maxNewTokens": 12,
                        "stream": True}) as resp:
        assert resp.headers["Content-Type"] == "application/x-ndjson"
        lines = [json.loads(x) for x in resp.read().decode().splitlines()]
    final = lines[-1]
    assert final["status"] == "ok" and final["tokens"] == want
    assert [t for x in lines[:-1] for t in x["tokens"]] == want
    assert [x["offset"] for x in lines[:-1]] == [
        sum(len(y["tokens"]) for y in lines[:i]) for i in range(len(lines) - 1)]


def test_health_metrics_and_bad_request(server):
    with urllib.request.urlopen(f"http://127.0.0.1:{server}/health",
                                timeout=30) as resp:
        assert resp.status == 200
    with urllib.request.urlopen(f"http://127.0.0.1:{server}/v1/metrics",
                                timeout=30) as resp:
        m = json.loads(resp.read())["metrics"]
    assert m["slots"] == 2 and m["device"] == "cpu"
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, {"prompt": [1, 2], "maxNewTokens": 64})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, {"prompt": [500], "maxNewTokens": 4})   # id > vocab
    assert e.value.code == 400


def test_drain_refuses_new_work():
    eng = serve.build_engine(serve.build_parser().parse_args(ARGS))
    svc = serve.ServeService(eng, drain_timeout=5)
    try:
        rid_reply = svc.generate({"prompt": [1, 2, 3], "maxNewTokens": 3})
        assert rid_reply["status"] == "ok"
        svc.begin_drain()
        with pytest.raises(serve.StatusError) as e:
            svc.health({})
        assert e.value.code == 503
        with pytest.raises(serve.StatusError) as e:
            svc.generate({"prompt": [1, 2, 3], "maxNewTokens": 3})
        assert e.value.code == 503 and e.value.retry_after >= 1
        assert svc.wait_drained(5)
    finally:
        svc.stop()


def test_timeout_cancels_and_queue_full_is_429():
    eng = serve.build_engine(serve.build_parser().parse_args(
        ARGS + ["--max-queue", "1"]))
    svc = serve.ServeService(eng)
    svc.stop()                              # no step loop: the queue stays
    reply = svc.generate({"prompt": [1], "maxNewTokens": 2,
                          "timeoutSeconds": 0})
    assert reply["status"] == "timeout" and not eng.active
    eng.submit([2], 2)
    with pytest.raises(serve.StatusError) as e:
        svc.generate({"prompt": [3], "maxNewTokens": 2})
    assert e.value.code == 429 and e.value.reason == "queue-pressure"


def test_kv_num_blocks_without_block_len_is_a_parser_error():
    with pytest.raises(SystemExit) as e:
        serve.main(ARGS + ["--kv-num-blocks", "9"])
    assert e.value.code == 2


def test_max_seq_not_a_multiple_of_the_block_len_raises():
    args = serve.build_parser().parse_args(ARGS + ["--kv-block-len", "24"])
    with pytest.raises(ValueError, match="multiple of kv_block_len"):
        serve.build_engine(args)


def test_paged_server_matches_dense_and_reports_kv_cache(paged_server):
    prompt = [3, 17, 29, 5, 8, 100, 7, 7, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    want = _expected(prompt, 12)
    for _ in range(2):                   # the second reuses 2 full blocks
        with _post(paged_server, {"prompt": prompt,
                                  "maxNewTokens": 12}) as resp:
            reply = json.loads(resp.read())
        assert reply["status"] == "ok" and reply["tokens"] == want
    with urllib.request.urlopen(f"http://127.0.0.1:{paged_server}/v1/metrics",
                                timeout=30) as resp:
        kv = json.loads(resp.read())["metrics"]["kv_cache"]
    assert kv["paged"] and kv["block_len"] == 8
    assert kv["blocks_total"] == 2 * 64 // 8
    assert kv["matched_tokens_total"] == 16 and kv["prefix_hit_rate"] > 0
    assert kv["blocks_used"] == kv["blocks_cached"] == 2


def _metrics(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/metrics",
                                timeout=30) as resp:
        return json.loads(resp.read())["metrics"]


def _sampled(port, key):
    body = {"prompt": [3, 17, 29, 5], "maxNewTokens": 10,
            "temperature": 1.0, "prngKey": key}
    with _post(port, body) as resp:
        reply = json.loads(resp.read())
    assert reply["status"] == "ok" and len(reply["tokens"]) == 10
    return reply["tokens"]


def test_prng_key_gives_one_sampled_stream_on_both_engines(server,
                                                           paged_server):
    streams = {}
    for name, port in (("dense", server), ("paged", paged_server)):
        first = _sampled(port, [7, 11])
        assert _sampled(port, [7, 11]) == first        # the same key, again
        assert _sampled(port, [8, 11]) != first        # another key
        streams[name] = first
    assert streams["dense"] == streams["paged"]


@pytest.mark.parametrize("field,value", [
    ("prngKey", [1, 2, 3]), ("prngKey", "ab"), ("prefixId", 0),
    ("stopText", ["</s>"]), ("text", "hello"),
    ("resumeFrom", {"prompt": [1, 2], "committed": [3, 4, 5, 6],
                    "maxNewTokens": 4})])
def test_refused_fields_get_a_400_naming_them(server, field, value):
    """A malformed prngKey, the tokenizer fields, an unregistered prefixId
    and a resume whose committed tokens fill maxNewTokens: each a 400
    naming the field, the engine untouched."""
    before = _metrics(server)
    body = {"prompt": [1, 2, 3], "maxNewTokens": 4, field: value}
    if field == "resumeFrom":
        del body["prompt"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, body)
    assert e.value.code == 400
    error = json.loads(e.value.read())["error"]
    assert field in error
    if field == "prefixId":
        assert "0 is not a registered prefix" in error
    if field == "resumeFrom":
        assert "nothing left to generate" in error
    after = _metrics(server)
    assert after["slots_busy"] == 0 and after["queued"] == 0
    assert after["lifetime"] == before["lifetime"]


def test_overlap_commit_and_watchdog_flags_reach_the_engine(tmp_path):
    from k8s_gpu_workload_enhancer_tpu_torch.utils.config import \
        parse_with_config
    default = serve.build_engine(serve.build_parser().parse_args(ARGS))
    assert default.overlap_commit and default.watchdog_timeout is None
    eng = serve.build_engine(serve.build_parser().parse_args(
        ARGS + ["--overlap-commit", "0", "--watchdog-timeout", "7.5"]))
    assert not eng.overlap_commit and eng.watchdog_timeout == 7.5
    cfg = tmp_path / "ktwe.yaml"
    cfg.write_text("serve:\n  overlap_commit: 0\n  watchdog_timeout: 3\n")
    args = parse_with_config(serve.build_parser(), "serve",
                             ARGS + ["--config", str(cfg)])
    assert (args.overlap_commit, args.watchdog_timeout) == (0, 3.0)
    eng = serve.build_engine(args)
    assert not eng.overlap_commit and eng.watchdog_timeout == 3.0


def test_hot_path_families_on_the_metrics_port():
    """--overlap-commit 0 and --watchdog-timeout on the serve main: a
    generate, then the hot-path and error families on --metrics-port say
    the commit ran on the sync path and nothing tripped."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        mport = s.getsockname()[1]
    gen = _serve(ARGS + ["--metrics-port", str(mport), "--overlap-commit",
                         "0", "--watchdog-timeout", "30"])
    port = next(gen)
    try:
        want = _expected([3, 17, 29, 5], 9)
        with _post(port, {"prompt": [3, 17, 29, 5],
                          "maxNewTokens": 9}) as resp:
            assert json.loads(resp.read())["tokens"] == want
        with urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics",
                                    timeout=30) as resp:
            series = dict(line.split() for line in resp.read().decode()
                          .splitlines() if line and not line.startswith("#"))
    finally:
        next(gen, None)
    series = {k: float(v) for k, v in series.items()}
    assert series["ktwe_serving_overlap_commit"] == 0.0
    assert series["ktwe_serving_commit_rounds_total"] >= 2
    assert series["ktwe_serving_commit_seconds_total"] > 0.0
    assert series["ktwe_serving_commit_overlapped_seconds_total"] == 0.0
    assert series["ktwe_serving_fetch_sync_seconds_total"] > 0.0
    for name in ("watchdog_trips_total", "request_errors_dispatch_total",
                 "request_errors_collect_total", "request_errors_commit_total",
                 "request_errors_watchdog_total"):
        assert series[f"ktwe_serving_{name}"] == 0.0, name
