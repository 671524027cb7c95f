"""The port's continuous-batching engine: the engine pins of the JAX
package's tests/unit/test_serving.py re-run on the port, and greedy
tokens identical to the JAX package's `decode.generate` and its engine on
the same weights (MHA and GQA, f32 and int8 weights)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.models import decode as jdec
from k8s_gpu_workload_enhancer_tpu.models import serving as jsrv
from k8s_gpu_workload_enhancer_tpu_torch.models import decode as tdec
from k8s_gpu_workload_enhancer_tpu_torch.models import serving as tsrv

import torch_parity as tp


def engine(params, cfg, **kw):
    kw = {"num_slots": 2, "prefill_len": tp.PREFILL_LEN, "decode_chunk": 4,
          **kw}
    return tsrv.ContinuousBatchEngine(params, cfg, device="cpu", **kw)


def reference(params, cfg, prompt, n):
    """Isolated single-stream greedy continuation (the port's generate)."""
    out = tdec.generate(params, torch.as_tensor([prompt]), n, cfg)
    return out[0, len(prompt):].tolist()


@pytest.fixture(scope="module")
def model():
    _, _, cfg, params = tp.model()
    return cfg, params


def test_single_request_matches_generate(model):
    cfg, params = model
    prompt = [3, 17, 29, 5]
    want = reference(params, cfg, prompt, 12)
    eng = engine(params, cfg)
    rid = eng.submit(prompt, 12)
    eng.run()
    r = eng.result(rid)
    assert r.tokens == want and r.finish_reason == "length"
    assert len(r.logprobs) == len(r.token_lat_s) == 12


def test_staggered_requests_isolated_and_slots_reused(model):
    """Three requests through TWO slots at different chunk boundaries:
    each matches its isolated generation (per-slot positions, masking and
    slot reuse do not leak across requests)."""
    cfg, params = model
    prompts = [[3, 17, 29, 5], [40, 2, 77], [9, 9, 10, 11, 12]]
    lens = [12, 9, 7]
    want = [reference(params, cfg, p, n) for p, n in zip(prompts, lens)]
    eng = engine(params, cfg, decode_chunk=3)
    r0 = eng.submit(prompts[0], lens[0])
    eng.step()
    r1 = eng.submit(prompts[1], lens[1])
    eng.step()
    r2 = eng.submit(prompts[2], lens[2])        # queued until a slot frees
    eng.run()
    for rid, w in zip((r0, r1, r2), want):
        assert eng.result(rid).tokens == w, f"request {rid} diverged"
    m = eng.metrics()
    assert m["requests_completed"] == 3 and m["tokens"] == sum(lens)
    assert m["aggregate_tokens_per_s"] > 0 and m["ttft_p50_ms"] > 0
    assert m["token_lat_p99_ms"] >= m["token_lat_p50_ms"] > 0


def test_queue_depth_beyond_slots_drains(model):
    cfg, params = model
    eng = engine(params, cfg)
    rids = [eng.submit([1 + i, 2 + i], 6) for i in range(5)]
    eng.run()
    assert eng.pending == 0 and not eng.active
    for i, rid in enumerate(rids):
        r = eng.result(rid)
        assert r.done and r.tokens == reference(params, cfg, [1 + i, 2 + i], 6)


def test_long_prompt_chunked_prefill_matches_generate(model):
    cfg, params = model
    prompt = tp.tokens(45, seed=5).tolist()           # chunks 32 + 13
    want = reference(params, cfg, prompt, 10)
    eng = engine(params, cfg)
    rid = eng.submit(prompt, 10)
    eng.run()
    assert eng.result(rid).tokens == want
    assert eng.metrics()["lifetime"]["prefill_chunks"] == 2


def test_prefill_interleave_bounds_admission(model):
    """While a slot decodes, one step admits at most prefill_interleave
    prefill chunks."""
    cfg, params = model
    eng = engine(params, cfg, num_slots=3, prefill_interleave=1)
    eng.submit([1, 2, 3], 20)
    eng.step()                                     # admit + first chunk
    eng.submit(tp.tokens(40, seed=6).tolist(), 4)  # two prefill chunks
    before = eng.metrics()["lifetime"]["prefill_chunks"]
    eng.step()
    assert eng.metrics()["lifetime"]["prefill_chunks"] == before + 1
    eng.run()


def test_queue_full_and_validation(model):
    cfg, params = model
    eng = engine(params, cfg, max_queue=2)
    eng.submit([1], 4)
    eng.submit([2], 4)
    with pytest.raises(tsrv.QueueFull):
        eng.submit([3], 4)
    with pytest.raises(ValueError):
        eng.submit([], 4)
    with pytest.raises(ValueError):
        eng.submit(list(range(61)), 4)                # 61 + 4 > max_seq
    eng.run()
    eng.drain()
    with pytest.raises(tsrv.Draining):
        eng.submit([1], 4)


def test_cancel_queued_and_decoding(model):
    cfg, params = model
    eng = engine(params, cfg, num_slots=1)
    a = eng.submit([5, 6, 7], 30)
    b = eng.submit([8, 9], 5)                         # waits for the slot
    eng.step()
    assert eng.cancel(b) and eng.result(b).finish_reason == "cancelled"
    eng.step()                    # commits a's first chunk (one step behind)
    assert eng.cancel(a)
    assert eng.result(a).finish_reason == "cancelled"
    partial = list(eng.result(a).tokens)
    assert 0 < len(partial) < 30
    eng.run()                     # the chunk in flight drops a's tokens
    assert eng.result(a).tokens == partial
    assert not eng.active and eng.slots_busy == 0
    assert not eng.cancel(a)                          # already finished
    # The freed slot serves a fresh request exactly.
    c = eng.submit([3, 17, 29, 5], 6)
    eng.run()
    assert eng.result(c).tokens == reference(params, cfg, [3, 17, 29, 5], 6)
    eng.release(c)
    with pytest.raises(KeyError):
        eng.result(c)


def test_eos_evicts_early(model):
    cfg, params = model
    toks = reference(params, cfg, [3, 17, 29, 5], 8)
    eos = toks[2]
    eng = engine(params, cfg, num_slots=1, eos_id=eos)
    rid = eng.submit([3, 17, 29, 5], 8)
    eng.run()
    got = eng.result(rid).tokens
    assert got[-1] == eos and len(got) == toks.index(eos) + 1 < 8
    assert eng.result(rid).finish_reason == "eos"


def test_stop_sequence_trimmed(model):
    cfg, params = model
    toks = reference(params, cfg, [3, 17, 29, 5], 10)
    eng = engine(params, cfg)
    rid = eng.submit([3, 17, 29, 5], 10, stop=[toks[3:5]])
    eng.run()
    r = eng.result(rid)
    assert r.finish_reason == "stop" and r.tokens == toks[:3]


def test_sampled_stream_is_a_function_of_key_and_index(model):
    """A sampled request's tokens do not depend on the requests decoding
    beside it; another engine seed gives another stream."""
    cfg, params = model

    def run(seed, neighbour):
        eng = engine(params, cfg, seed=seed)
        rid = eng.submit([4, 5, 6], 10, temperature=0.8)
        if neighbour:
            eng.submit([9, 9, 9], 10)             # greedy, in the next slot
        eng.run()
        return eng.result(rid).tokens

    assert run(3, False) == run(3, True)
    assert run(3, False) != run(4, False)


def test_packed_logprob_bitcast_round_trip():
    toks = torch.tensor([[1, 2], [3, 40000]])
    lps = torch.tensor([[-0.5, -1e-30], [float("-inf"), -123.456]])
    toks_h, lps_h = tsrv._unpack(tsrv._pack(toks, lps).numpy())
    assert toks_h.tolist() == toks.tolist()
    assert lps_h.dtype == np.float32
    assert lps_h.tobytes() == lps.numpy().tobytes()   # bit-exact


def _scenario(eng):
    """Staggered admissions incl. a chunked prefill, through 2 slots."""
    prompts = [[3, 17, 29, 5], tp.tokens(40, seed=7).tolist(), [40, 2, 77]]
    lens = [12, 10, 9]
    r0 = eng.submit(prompts[0], lens[0])
    eng.step()
    r1 = eng.submit(prompts[1], lens[1])
    eng.step()
    r2 = eng.submit(prompts[2], lens[2])
    eng.run()
    return prompts, lens, [eng.result(r) for r in (r0, r1, r2)]


@pytest.mark.parametrize("n_kv_heads,int8", [(2, False), (1, False),
                                             (2, True), (1, True)])
def test_engine_matches_jax_engine_and_generate(n_kv_heads, int8):
    jcfg, jp, tcfg, params = tp.model(n_kv_heads, int8)
    jeng = jsrv.ContinuousBatchEngine(jp, jcfg, num_slots=2,
                                      prefill_len=tp.PREFILL_LEN,
                                      decode_chunk=4)
    prompts, lens, want = _scenario(jeng)
    _, _, got = _scenario(engine(params, tcfg))
    for p, n, w, g in zip(prompts, lens, want, got):
        assert g.tokens == w.tokens
        ref = np.asarray(jdec.generate(jp, jnp.asarray([p], jnp.int32), n,
                                       jcfg, max_seq=64))[0, len(p):]
        assert g.tokens == ref.tolist()
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4,
                                   rtol=1e-4)
