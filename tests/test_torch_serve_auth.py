"""The port's serve main on --device cpu at d 64: bearer auth as the JAX
serve resolves and enforces it (--auth-token, $KTWE_AUTH_TOKEN,
$KTWE_AUTH_TOKEN_FILE; 401 with the JAX handler's status and body, /health
open, an unreadable token file stops startup), and no reference cycle that
keeps the engine alive after main() returns."""

import gc
import json
import threading
import urllib.error
import urllib.request
import weakref
from http.server import ThreadingHTTPServer

import pytest

from k8s_gpu_workload_enhancer_tpu.utils import httpjson as jax_httpjson
from k8s_gpu_workload_enhancer_tpu_torch.cmd import serve

from test_torch_serve import ARGS, _serve

import torch_parity  # noqa: F401  (one intra-op thread a process)

TOKEN = "s3cret-token"


def _request(port, path, body=None, token=None):
    """(status, parsed JSON body) of one request; POST when `body`."""
    headers = {"Content-Type": "application/json"}
    if token is not None:
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


@pytest.fixture(scope="module")
def jax_refusal():
    """What the JAX handler answers to a generate without the bearer."""
    handler = jax_httpjson.make_json_handler(
        {"/v1/generate": lambda req: {"status": "ok"}}, auth_token=TOKEN)
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        yield _request(server.server_address[1], "/v1/generate",
                       {"prompt": [1]})
    finally:
        server.shutdown()
        server.server_close()
        th.join()


@pytest.fixture(scope="module")
def auth_server():
    yield from _serve(ARGS + ["--auth-token", TOKEN])


GENERATE = {"prompt": [3, 17, 29, 5], "maxNewTokens": 4}


def test_missing_or_wrong_bearer_is_401_as_in_jax(auth_server, jax_refusal):
    want_code, want_body = jax_refusal
    assert want_code == 401
    for token in (None, "wrong", TOKEN + "x"):
        for path, body in (("/v1/generate", GENERATE),
                           ("/v1/metrics", None)):
            code, got = _request(auth_server, path, body, token=token)
            assert code == want_code
            assert sorted(got) == sorted(want_body)
            assert got == want_body


def test_bearer_is_served_and_health_stays_open(auth_server):
    code, reply = _request(auth_server, "/v1/generate", GENERATE, TOKEN)
    assert code == 200 and reply["status"] == "ok"
    assert len(reply["tokens"]) == 4
    code, reply = _request(auth_server, "/v1/metrics", token=TOKEN)
    assert code == 200 and reply["status"] == "ok"
    assert _request(auth_server, "/health") == (200, {"status": "ok"})


@pytest.mark.parametrize("source", ["env", "file"])
def test_token_from_the_environment(source, monkeypatch, tmp_path):
    if source == "env":
        monkeypatch.setenv("KTWE_AUTH_TOKEN", TOKEN)
    else:
        path = tmp_path / "token"
        path.write_text(TOKEN + "\n")
        monkeypatch.setenv("KTWE_AUTH_TOKEN_FILE", str(path))
    for port in _serve(ARGS):
        assert _request(port, "/v1/generate", GENERATE)[0] == 401
        assert _request(port, "/v1/generate", GENERATE, TOKEN)[0] == 200
        assert _request(port, "/health")[0] == 200


def test_unreadable_token_file_stops_startup(monkeypatch, tmp_path):
    monkeypatch.setenv("KTWE_AUTH_TOKEN_FILE", str(tmp_path / "missing"))
    built = []
    monkeypatch.setattr(serve, "build_engine",
                        lambda args: built.append(args))
    with pytest.raises(OSError):
        serve.main(ARGS, stop=threading.Event())
    assert not built


def test_resolve_auth_token_order_matches_jax(monkeypatch, tmp_path):
    from k8s_gpu_workload_enhancer_tpu_torch.utils import httpjson
    path = tmp_path / "token"
    path.write_text("from-file\n")
    cases = [("cli", {"KTWE_AUTH_TOKEN": "env",
                      "KTWE_AUTH_TOKEN_FILE": str(path)}),
             ("", {"KTWE_AUTH_TOKEN": "env",
                   "KTWE_AUTH_TOKEN_FILE": str(path)}),
             ("", {"KTWE_AUTH_TOKEN_FILE": str(path)}),
             ("", {})]
    for cli, env in cases:
        for name in ("KTWE_AUTH_TOKEN", "KTWE_AUTH_TOKEN_FILE"):
            monkeypatch.delenv(name, raising=False)
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        assert (httpjson.resolve_auth_token(cli)
                == jax_httpjson.resolve_auth_token(cli))


def test_engine_is_freed_when_main_returns_without_gc(monkeypatch):
    engines = []
    build = serve.build_engine

    def build_and_watch(args, mesh=None):
        engine = build(args, mesh)
        engines.append(weakref.ref(engine))
        return engine
    monkeypatch.setattr(serve, "build_engine", build_and_watch)
    gc.collect()
    gc.disable()
    try:
        for port in _serve(ARGS):
            assert _request(port, "/v1/generate", GENERATE)[0] == 200
        assert len(engines) == 1
        assert engines[0]() is None, "engine outlived serve.main"
    finally:
        gc.enable()
