"""Zero-loss migration on the port's engine: the pins of the JAX
package's tests/unit/test_resume.py re-run on the port, and resume across
the two backends.

A generation ejected anywhere (decoding, queued) and resumed on a fresh
engine with another seed and slot count continues the uninterrupted stream
exactly: greedy, dense and paged; sampled with the carried `prngKey`
(the port's sampler is a function of (key, index), so the first resumed
token must sample at index len(committed)). Stop state rides the committed
tokens; `eject_live` sweeps everything and returns every page; a second
eject returns the cached state; a paged resume rides the radix tree. The
state has the JAX state's keys, and a state ejected from the port resumes
on the JAX engine (and the other way round) with the same greedy tokens
(tests/torch_parity.py dims, f32).
"""

import pytest

from k8s_gpu_workload_enhancer_tpu.models import serving as jsrv
from k8s_gpu_workload_enhancer_tpu_torch.models import serving as tsrv

import torch_parity as tp

PROMPT = [40, 2, 7, 1, 3]
N = 40


@pytest.fixture(scope="module")
def model():
    return tp.model()


def make_engine(model, *, paged=False, seed=0, num_slots=2, jax=False,
                **kw):
    jcfg, jp, cfg, params = model
    kw = {"num_slots": num_slots, "decode_chunk": 4, "seed": seed,
          "prefill_len": tp.PREFILL_LEN if jax else 8, **kw}
    if paged:
        kw["kv_block_len"] = 8
    if jax:
        return jsrv.ContinuousBatchEngine(jp, jcfg, **kw)
    return tsrv.ContinuousBatchEngine(params, cfg, device="cpu", **kw)


def run_uninterrupted(model, prompt=PROMPT, n=N, temperature=None, **kw):
    eng = make_engine(model, **kw)
    rid = eng.submit(prompt, n, temperature=temperature)
    eng.run()
    return eng.result(rid).tokens


def eject_mid_generation(eng, rid, min_tokens=3):
    for _ in range(64):
        eng.step()
        if len(eng.result(rid).tokens) >= min_tokens:
            break
    state = eng.eject(rid)
    assert state is not None
    return state


def resume(eng, state, **kw):
    rid = eng.submit(state["prompt"], state["maxNewTokens"],
                     committed=state["committed"],
                     prng_key=state["prngKey"],
                     temperature=state["temperature"], stop=state["stop"],
                     **kw)
    eng.run()
    return eng.result(rid)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_greedy_resume_bitwise_identical(model, paged):
    want = run_uninterrupted(model, paged=paged)
    assert len(want) == N
    src = make_engine(model, paged=paged)
    rid = src.submit(PROMPT, N)
    state = eject_mid_generation(src, rid)
    k = len(state["committed"])
    assert 0 < k < N and state["committed"] == want[:k]
    assert state["maxNewTokens"] == N and state["remaining"] == N - k
    assert state["prngPos"] == k
    assert src.result(rid).finish_reason == "migrated"
    assert src.result(rid).resume_state is state
    dst = make_engine(model, paged=paged, seed=99, num_slots=3)
    res = resume(dst, state)
    assert res.tokens == want and res.finish_reason == "length"
    assert res.emit_from == k
    sm, dm = src.metrics(), dst.metrics()
    assert sm["migration"]["ejected_total"] == 1
    assert sm["lifetime"]["completed"] == 0
    assert sm["requests_completed"] == 0
    assert dm["migration"] == {"resumed_total": 1,
                               "resume_committed_tokens_total": k,
                               "ejected_total": 0, "preempted_total": 0,
                               "handoffs_total": 0}
    # Only the tokens generated here count on the resuming replica.
    assert dm["lifetime"]["tokens"] == dm["tokens"] == N - k
    assert dm["lifetime"]["completed"] == 1


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_sampled_resume_reproduces_stream_with_carried_key(model, paged):
    want = run_uninterrupted(model, n=20, temperature=1.0, seed=7,
                             paged=paged)
    assert run_uninterrupted(model, n=20, temperature=1.0, seed=7,
                             paged=paged) == want
    src = make_engine(model, seed=7, paged=paged)
    rid = src.submit(PROMPT, 20, temperature=1.0)
    state = eject_mid_generation(src, rid, min_tokens=4)
    k = len(state["committed"])
    assert state["committed"] == want[:k]
    dst = make_engine(model, seed=12345, num_slots=4, paged=paged)
    assert resume(dst, state).tokens == want, \
        "sampled resume diverged despite the carried key"
    # Without the key the continuation is another (valid) stream.
    dst2 = make_engine(model, seed=12345, num_slots=4, paged=paged)
    r = dst2.submit(state["prompt"], 20, committed=state["committed"],
                    temperature=1.0)
    dst2.run()
    cont = dst2.result(r).tokens
    assert cont[:k] == want[:k] and len(cont) == 20 and cont != want


def test_stop_state_carries_across_migration(model):
    base = run_uninterrupted(model)
    stop = [base[8], base[9]]                 # completes at token 10
    ref = make_engine(model)
    rr = ref.submit(PROMPT, N, stop=[stop])
    ref.run()
    want = ref.result(rr)
    assert want.finish_reason == "stop"
    src = make_engine(model)
    rid = src.submit(PROMPT, N, stop=[stop])
    state = eject_mid_generation(src, rid)
    assert len(state["committed"]) < 9, "the eject must precede the stop"
    assert state["stop"] == [stop]
    res = resume(make_engine(model, seed=5), state)
    assert res.finish_reason == "stop" and res.tokens == want.tokens


def test_eject_queued_request_resumes_from_zero(model):
    want = run_uninterrupted(model)
    eng = make_engine(model, num_slots=1)
    blocker = eng.submit([9, 9], 30)
    queued = eng.submit(PROMPT, N)
    eng.step()                                # admits only the blocker
    state = eng.eject(queued)
    assert state is not None and state["committed"] == []
    assert not eng.result(blocker).done
    dst = make_engine(model)
    r = dst.submit(state["prompt"], state["maxNewTokens"],
                   committed=state["committed"] or None,
                   prng_key=state["prngKey"])
    dst.run()
    assert dst.result(r).tokens == want
    assert dst.metrics()["migration"]["resumed_total"] == 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_eject_live_sweeps_everything_and_returns_every_page(model, paged):
    eng = make_engine(model, num_slots=2, paged=paged)
    rids = [eng.submit(tp.tokens(3 + 9 * i, seed=i).tolist(), 20)
            for i in range(4)]
    for _ in range(3):
        eng.step()
    assert eng.slots_busy == 2 and eng.metrics()["queued"] > 0
    states = eng.eject_live()
    assert [s["requestId"] for s in states] == rids
    assert all(eng.result(r).finish_reason == "migrated" for r in rids)
    m = eng.metrics()
    assert m["migration"]["ejected_total"] == 4
    assert m["requests_completed"] == 0 and m["lifetime"]["completed"] == 0
    assert eng.pending == 0 and eng.slots_busy == 0
    if paged:
        kv = m["kv_cache"]
        assert kv["blocks_used"] == kv["blocks_cached"]
        assert kv["blocks_free"] + kv["blocks_cached"] == kv["blocks_total"]
    eng.run()
    assert not eng.active


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_second_eject_returns_the_same_state(model, paged):
    eng = make_engine(model, paged=paged)
    rid = eng.submit(PROMPT, N)
    first = eject_mid_generation(eng, rid)
    assert eng.eject(rid) is first
    assert eng.eject_live() == []
    assert eng.metrics()["migration"]["ejected_total"] == 1
    done = eng.submit([5, 6], 3)
    eng.run()
    assert eng.eject(done) is None            # finished for real


def test_resume_validation(model):
    eng = make_engine(model)
    with pytest.raises(ValueError, match="nothing left"):
        eng.submit(PROMPT, 4, committed=[1, 2, 3, 4])
    with pytest.raises(ValueError, match="prngKey"):
        eng.submit(PROMPT, 8, prng_key=[1, 2, 3])
    assert eng.metrics()["queued"] == 0


def test_resume_rides_radix_tree_on_paged_engine(model):
    want = run_uninterrupted(model, paged=True)
    src = make_engine(model, paged=True)
    rid = src.submit(PROMPT, N)
    state = eject_mid_generation(src, rid, min_tokens=16)
    dst = make_engine(model, paged=True, seed=3)
    assert resume(dst, state).tokens == want
    cold = dst.metrics()["kv_cache"]["matched_tokens_total"]
    assert resume(dst, state).tokens == want
    warm = dst.metrics()["kv_cache"]["matched_tokens_total"]
    # The first resume published prompt + committed; the second matches
    # every full block of it.
    assert warm - cold == (len(PROMPT) + len(state["committed"])) // 8 * 8
    assert warm > cold


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_eject_state_has_the_jax_state_keys(model, paged):
    states = []
    for jax in (True, False):
        eng = make_engine(model, paged=paged, jax=jax)
        rid = eng.submit(PROMPT, N, temperature=0.5, stop=[[1, 2]])
        states.append(eject_mid_generation(eng, rid))
    jstate, tstate = states
    assert set(tstate) == set(jstate)
    for k in ("prompt", "maxNewTokens", "temperature", "topP", "stop",
              "reason", "tenant", "priority", "preempted", "requestId"):
        assert tstate[k] == jstate[k], k
    assert tstate["prngPos"] == len(tstate["committed"])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("src_jax", [False, True],
                         ids=["port-to-jax", "jax-to-port"])
def test_resume_across_backends(model, paged, src_jax):
    want = run_uninterrupted(model, paged=paged)
    src = make_engine(model, paged=paged, jax=src_jax)
    rid = src.submit(PROMPT, N)
    state = eject_mid_generation(src, rid, min_tokens=6)
    assert state["committed"] == want[:len(state["committed"])]
    dst = make_engine(model, paged=paged, jax=not src_jax, seed=17)
    res = resume(dst, state)
    assert res.tokens == want and res.finish_reason == "length"
