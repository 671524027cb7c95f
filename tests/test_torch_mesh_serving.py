"""Serving meshes on the port, held on the CPU to the JAX package on the same
numpy weights (f32, `params_from_numpy`).

One gloo gang of eight ranks (tests/torch_serve_gang.py), a (dp=2, tp=4)
serving mesh through `bootstrap.initialize_serving`, runs the engine on
every case while the references compile: the paged engine plain, with the
int8 KV cache and with speculation (an oracle drafter whose last draft a
round is wrong, so verify rounds accept and reject), the dense engine with
speculation (slots over dp), GQA with two KV
heads at tp=4 (the KV projections and cache replicated over tp), an eject
on the mesh and a resume on it of a single-device engine's eject, and the
device-loss evacuation (JAX tests/integration/test_faultlab_recovery.py).
Transcripts and KV/page/lease bookkeeping are held exactly to the JAX
engine on one device and to the port's single-device engine, the paged
plain case also to the JAX engine on the same (2, 4) mesh of the
harness's 8 virtual devices; logprobs to rtol 5e-4, atol 5e-5.

In process: `shard_params_for_serving` block for block against the JAX
function's addressable shards on the same mesh (an int8 tree with two KV
heads, and the plain tree); the meshed forward's logits on a thread gang
against the JAX forward; the thread gang's transcripts against the gloo
gang's (bitwise: both sum in rank order); a dense engine's num_slots % dp
refused with the JAX message.
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.models import decode as jdecode
from k8s_gpu_workload_enhancer_tpu.models import serving as jsrv
from k8s_gpu_workload_enhancer_tpu.models import transformer as jtf
from k8s_gpu_workload_enhancer_tpu.ops.quant import quantize_params as jquant
from k8s_gpu_workload_enhancer_tpu.parallel import mesh as jmesh
from k8s_gpu_workload_enhancer_tpu_torch.models import decode as tdecode
from k8s_gpu_workload_enhancer_tpu_torch.models import serving as tsrv
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.parallel.mesh import ServingMesh

import torch_gang
import torch_parity  # noqa: F401  (one intra-op thread a process)
from torch_serve_gang import OracleDrafter

DIMS = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
            d_ff=64, max_seq=64)
GQA_DIMS = dict(DIMS, n_kv_heads=2)
INT8KV_DIMS = dict(DIMS, kv_cache_int8=True)
ENGINE = dict(num_slots=2, prefill_len=8, decode_chunk=3)
PAGED = dict(ENGINE, kv_block_len=8)
# A sub-chunk prompt, a multi-chunk one (prefill offsets 0 and 8) and a
# repeating one. On random weights the n-gram drafter drafts nothing (the
# model does not continue the cycle), so the spec cases draft through an
# oracle of the spec-off transcripts, each round's last draft wrong.
PROMPTS = [[3, 17, 29, 5, 7], list(range(1, 12)), [5, 6] * 4]
GENS = [10, 8, 12]
RESUME_PROMPT, RESUME_N = [40, 2, 7, 1, 3], 20
EVAC_PROMPTS, EVAC_N = [[3, 17, 29, 5], [9, 9, 10], [5, 6] * 3], 12
LOGITS_TOL = dict(rtol=5e-4, atol=5e-5)
KV_KEYS = ("blocks_total", "blocks_free", "blocks_used", "blocks_shared",
           "blocks_cached", "evictions_total", "deferrals_total",
           "prompt_tokens_total", "matched_tokens_total")

# name -> (dims, engine kwargs): the transcript cases.
CASES = {
    "paged_plain": (DIMS, PAGED),
    "paged_int8kv": (INT8KV_DIMS, PAGED),
    "paged_spec": (DIMS, dict(PAGED, spec_k=3)),
    "dense_spec": (DIMS, dict(ENGINE, spec_k=3)),
    "paged_gqa": (GQA_DIMS, PAGED),
}


def jax_cfg(dims: dict) -> jtf.TransformerConfig:
    return jtf.TransformerConfig(**dims, dtype=jnp.float32, use_flash=False,
                                 use_ring_attention=False)


def torch_cfg(dims: dict) -> ttf.TransformerConfig:
    return ttf.TransformerConfig(**dims, dtype=torch.float32)


def jax_params(dims: dict, int8: bool = False):
    """The JAX init of `dims` at key 0 (the JAX mesh tests' weights)."""
    p = jtf.init_params(jax.random.PRNGKey(0), jax_cfg(dims))
    return jquant(p) if int8 else p


def numpy_tree(jp) -> dict:
    return jax.tree.map(np.asarray, jp)


def port_params(dims: dict, int8: bool = False):
    return ttf.params_from_numpy(numpy_tree(jax_params(dims, int8)),
                                 torch_cfg(dims), "cpu")


def port_engine(dims: dict, kw: dict, **extra):
    return tsrv.ContinuousBatchEngine(port_params(dims), torch_cfg(dims),
                                      device="cpu", **kw, **extra)


def oracle_pairs() -> list:
    """(prompt, spec-off greedy transcript) of PROMPTS on one device."""
    out = run(port_engine(DIMS, PAGED))
    return [[p, t] for p, t in zip(PROMPTS, out["tokens"])]


def drafter_kw(kw: dict, pairs: list) -> dict:
    return (dict(kw, drafter=OracleDrafter(pairs, DIMS["vocab_size"]))
            if kw.get("spec_k") else kw)


def run(eng, prompts=PROMPTS, gens=GENS) -> dict:
    rids = [eng.submit(list(p), n) for p, n in zip(prompts, gens)]
    eng.run()
    reqs = [eng.result(r) for r in rids]
    return {"tokens": [list(map(int, r.tokens)) for r in reqs],
            "logprobs": [list(r.logprobs) for r in reqs],
            "metrics": eng.metrics()}


def jax_run(dims: dict, kw: dict, mesh=None) -> dict:
    kw = drafter_kw(kw, oracle_pairs())
    jcfg = jax_cfg(dims)
    jp = jax_params(dims)
    if mesh is not None:
        jp = jdecode.shard_params_for_serving(jp, jcfg, mesh)
    return run(jsrv.ContinuousBatchEngine(jp, jcfg, mesh=mesh, **kw))


def eject_state(eng, min_tokens: int = 3) -> dict:
    rid = eng.submit(list(RESUME_PROMPT), RESUME_N)
    for _ in range(64):
        eng.step()
        if len(eng.result(rid).tokens) >= min_tokens:
            break
    return eng.eject(rid)


def case(name: str, kind: str, dims: dict, engine: dict, **kw) -> dict:
    return dict(name=name, kind=kind, model=dims, engine=engine,
                params="mha" if dims["n_kv_heads"] == 4 else "gqa", **kw)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The gang of eight on its cases, started before the references
    compile; the single-device eject it resumes is taken first."""
    job_dir = tmp_path_factory.mktemp("mesh_serving")
    state = eject_state(port_engine(DIMS, PAGED))
    inputs = {}
    for key, dims in (("mha", DIMS), ("gqa", GQA_DIMS)):
        inputs.update({f"{key}{k}": v for k, v in torch_gang.flat(
            numpy_tree(jax_params(dims))).items()})
    pairs = oracle_pairs()
    cases = [case(name, "transcripts", dims, kw, prompts=PROMPTS, gens=GENS,
                  oracle=pairs if kw.get("spec_k") else None)
             for name, (dims, kw) in CASES.items()]
    cases += [
        case("eject", "eject", DIMS, PAGED, prompt=RESUME_PROMPT,
             n=RESUME_N, min_tokens=3),
        case("resume", "resume", DIMS, dict(PAGED, seed=99), state=state),
        case("evacuate", "evacuate", DIMS, ENGINE, prompts=EVAC_PROMPTS,
             n=EVAC_N, mesh_shape=[2, 4]),
    ]
    g = torch_gang.Gang(job_dir, 8, [dict(mesh=[2, 4], cases=cases)], inputs,
                        script=str(torch_gang.ROOT / "tests"
                                   / "torch_serve_gang.py"))
    g.state = state
    yield g
    g.close()


def gang_out(gang, name: str) -> dict:
    gang.result()
    return json.loads((gang.dir / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def tp_mesh():
    return jmesh.make_mesh(jmesh.MeshConfig(dp=2, tp=4),
                           devices=jax.devices()[:8])


def thread_meshes(dp: int = 2, tp: int = 4):
    return ServingMesh.thread_gang(dp, tp)[0]


def on_thread_gang(dp: int, tp: int, fn):
    """fn(rank's mesh) on every rank of a thread gang; the ranks' results
    in rank order (a failing rank aborts the gang and raises here)."""
    meshes, groups = ServingMesh.thread_gang(dp, tp)
    out, errors = [None] * (dp * tp), []

    def one(r):
        try:
            out[r] = fn(meshes[r])
        except BaseException as e:            # noqa: BLE001 — reported
            errors.append(e)
            for g in groups:
                g.abort()
    threads = [threading.Thread(target=one, args=(r,)) for r in range(dp * tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errors:
        raise errors[0]
    return out


def gang_engine_run(dims: dict, kw: dict, dp: int = 2, tp: int = 4) -> dict:
    """The transcripts of a thread gang's engine on `dims` and `kw`."""
    cfg, full = torch_cfg(dims), port_params(dims)
    kw = drafter_kw(kw, oracle_pairs())

    def rank(mesh):
        eng = tsrv.ContinuousBatchEngine(
            tdecode.shard_params_for_serving(full, cfg, mesh), cfg,
            device="cpu", mesh=mesh, **kw)
        if not mesh.is_driver:
            eng.follow()
            return None
        try:
            return run(eng)
        finally:
            eng.stop_followers()
    return on_thread_gang(dp, tp, rank)[0]


# ------------------------------------------------------------ the layout


@pytest.mark.parametrize("int8,dims", [(False, DIMS), (True, GQA_DIMS)],
                         ids=["plain", "int8-gqa"])
def test_shard_params_for_serving_matches_jax(tp_mesh, int8, dims):
    """Each rank's blocks on (dp=2, tp=4) are the matching addressable
    shards of the JAX function on the same mesh: heads, MLP and vocab over
    tp, KV replicated at two KV heads, int8 scales replicated on their
    contracted axes."""
    jcfg, tcfg = jax_cfg(dims), torch_cfg(dims)
    jp = jax_params(dims, int8)
    sharded = jdecode.shard_params_for_serving(jp, jcfg, tp_mesh)
    full = ttf.params_from_numpy(numpy_tree(jp), tcfg, "cpu")
    devices = tp_mesh.devices.reshape(2, 4)
    jflat = torch_gang.flat(sharded)
    for m in thread_meshes():
        got = torch_gang.flat(tdecode.shard_params_for_serving(full, tcfg,
                                                               m))
        assert set(got) == set(jflat)
        dev = devices[m.dp_rank, m.tp_rank]
        for path, arr in jflat.items():
            want = [np.asarray(s.data) for s in arr.addressable_shards
                    if s.device == dev]
            assert len(want) == 1, path
            np.testing.assert_array_equal(got[path].numpy(), want[0],
                                          err_msg=f"rank {m.rank} {path}")
    if int8:
        assert tdecode.kv_replicated(tcfg, thread_meshes()[0])


@pytest.mark.parametrize("dims,int8", [(DIMS, False), (GQA_DIMS, True)],
                         ids=["mha", "int8-gqa"])
def test_meshed_forward_logits_match_jax(dims, int8):
    """forward_cached on a thread gang of (2, 4), a prefill and a decode
    step into the rank's cache, against the JAX forward on one device."""
    jcfg, tcfg = jax_cfg(dims), torch_cfg(dims)
    jp = jax_params(dims, int8)
    full = ttf.params_from_numpy(numpy_tree(jp), tcfg, "cpu")
    toks = np.random.default_rng(3).integers(0, 128, (2, 12)).astype(
        np.int32)
    jcache = jdecode.init_cache(jcfg, 2, 64)
    want, jcache = jdecode.forward_cached(jp, jnp.asarray(toks), jcache, 0,
                                          jcfg)
    want2, _ = jdecode.forward_cached(jp, jnp.asarray(toks[:, :1]), jcache,
                                      12, jcfg)

    def rank(mesh):
        p = tdecode.shard_params_for_serving(full, tcfg, mesh)
        cache = tdecode.init_cache(tcfg, 2, 64, mesh=mesh)
        a, cache = tdecode.forward_cached(p, torch.from_numpy(toks).long(),
                                          cache, 0, tcfg, mesh=mesh)
        b, _ = tdecode.forward_cached(
            p, torch.from_numpy(toks[:, :1]).long(), cache, 12, tcfg,
            mesh=mesh)
        return a.numpy(), b.numpy()
    out = on_thread_gang(2, 4, rank)
    for a, b in out:
        np.testing.assert_allclose(a, np.asarray(want), **LOGITS_TOL)
        np.testing.assert_allclose(b, np.asarray(want2), **LOGITS_TOL)
        np.testing.assert_array_equal(a, out[0][0])


def test_dense_slots_must_divide_over_dp():
    """The JAX engine's check: the dense cache's slot axis shards over
    dp."""
    m = thread_meshes()[0]
    with pytest.raises(ValueError, match=r"num_slots 3 must divide over the "
                                         r"mesh's batch axes \(dp\*ep = 2\)"):
        tsrv.ContinuousBatchEngine(
            tdecode.shard_params_for_serving(port_params(DIMS),
                                             torch_cfg(DIMS), m),
            torch_cfg(DIMS), device="cpu", mesh=m, num_slots=3,
            prefill_len=8)


# ---------------------------------------------------------- the gloo gang


@pytest.mark.parametrize("name", ["paged_plain", "paged_int8kv",
                                  "paged_spec", "dense_spec", "paged_gqa"])
def test_mesh_engine_matches_jax_and_one_device(gang, name):
    """Greedy transcripts on the (2, 4) gang equal the JAX engine's on one
    device and the port's single-device engine's exactly; the KV, page and
    lease bookkeeping equals the port's single device's; logprobs within
    tolerance. Spec cases run verify rounds."""
    dims, kw = CASES[name]
    want = jax_run(dims, kw)
    one = run(port_engine(dims, drafter_kw(kw, oracle_pairs())))
    got = gang_out(gang, name)
    assert got["finish"] == ["length"] * len(PROMPTS)
    assert got["tokens"] == want["tokens"] == one["tokens"]
    for a, b in zip(got["logprobs"], one["logprobs"]):
        np.testing.assert_allclose(a, b, **LOGITS_TOL)
    for k in KV_KEYS:
        assert got["kv_cache"][k] == one["metrics"]["kv_cache"][k], k
    if kw.get("kv_block_len"):
        assert got["kv_cache"]["blocks_free"] == \
            want["metrics"]["kv_cache"]["blocks_free"]
    if kw.get("spec_k"):
        assert got["spec"]["rounds_total"] > 0
        assert 0 < got["spec"]["draft_accepted_total"] < \
            got["spec"]["draft_proposed_total"]
        for k in ("rounds_total", "tokens_total", "draft_proposed_total",
                  "draft_accepted_total"):
            assert got["spec"][k] == one["metrics"]["spec"][k], k


def test_paged_mesh_matches_jax_on_the_same_mesh(gang, tp_mesh):
    """The paged plain case against the JAX paged engine on the same
    (dp=2, tp=4) mesh."""
    want = jax_run(DIMS, PAGED, tp_mesh)
    assert gang_out(gang, "paged_plain")["tokens"] == want["tokens"]


@pytest.mark.parametrize("src_meshed", [True, False],
                         ids=["mesh-to-single", "single-to-mesh"])
def test_resume_carry_is_mesh_agnostic(gang, src_meshed):
    """A request ejected on the meshed paged engine resumes bitwise on a
    single-device one, and a single-device eject resumes on the mesh (JAX
    test_mesh_serving.py:127-161)."""
    base = port_engine(DIMS, PAGED)
    rid = base.submit(list(RESUME_PROMPT), RESUME_N)
    base.run()
    want = base.result(rid).tokens
    assert len(want) == RESUME_N
    if src_meshed:
        state = gang_out(gang, "eject")["state"]
        dst = port_engine(DIMS, PAGED, seed=99)
        r2 = dst.submit(state["prompt"], state["maxNewTokens"],
                        committed=state["committed"],
                        prng_key=state["prngKey"])
        dst.run()
        tokens, emit_from = dst.result(r2).tokens, dst.result(r2).emit_from
    else:
        state = gang.state
        out = gang_out(gang, "resume")
        tokens, emit_from = out["tokens"], out["emit_from"]
    assert 0 < len(state["committed"])
    assert state["committed"] == want[:len(state["committed"])]
    assert tokens == want, "resume across the mesh boundary diverged"
    assert emit_from == len(state["committed"])


def test_device_loss_evacuates_and_serves_degraded(gang):
    """The JAX drill on (2, 4): an injected device loss under a meshed
    dispatch ejects every live request (two decoding, one queued) as a
    reason="evacuate" frame that resumes bitwise on another engine; the
    engine serves on one device after, exactly; the serve's `mesh` block
    drops to one device, degraded."""
    def uninterrupted(p):
        e = port_engine(DIMS, ENGINE)
        r = e.submit(list(p), EVAC_N)
        e.run()
        return e.result(r).tokens
    wants = [uninterrupted(p) for p in EVAC_PROMPTS]
    out = gang_out(gang, "evacuate")
    assert out["queued"]
    assert out["finish"] == ["migrated"] * 3
    assert [f["reason"] for f in out["frames"]] == ["evacuate"] * 3
    res = out["resilience"]
    assert res["errors"]["device_loss"] == 1
    assert res["evacuated_total"] == 3
    assert res["mesh_degraded"] is True
    for frame, want in zip(out["frames"], wants):
        dst = port_engine(DIMS, ENGINE, seed=7)
        r2 = dst.submit(frame["prompt"], frame["maxNewTokens"],
                        committed=frame["committed"],
                        prng_key=frame["prngKey"])
        dst.run()
        assert dst.result(r2).tokens == want
    assert out["after"] == wants[0]
    assert out["mesh_none"]
    assert out["mesh"]["devices"] == 1 and out["mesh"]["degraded"] == 1
    assert out["mesh"]["shape"] == "degraded"


@pytest.mark.parametrize("name", ["dense_spec", "paged_plain"])
def test_thread_group_gives_the_gloo_gangs_transcripts(gang, name):
    """A gang of threads on one device computes what the gloo gang does,
    bit for bit (both sum in rank order)."""
    dims, kw = CASES[name]
    got = gang_engine_run(dims, kw)
    want = gang_out(gang, name)
    assert got["tokens"] == want["tokens"]
    assert got["logprobs"] == want["logprobs"]


# ----------------------------------------- refusals, swaps and rebuilds


@pytest.mark.parametrize("what", ["moe", "host-tier"])
def test_engine_refuses_what_a_mesh_does_not_serve_yet(what):
    """MoE (ROADMAP A11c: expert parallelism) and the host KV tier (A11b,
    second part) on a mesh above one rank raise before anything is built.
    The serve main has no MoE flag (the JAX one has none either), so this
    is the MoE refusal; the host tier the main refuses with exit 2 too."""
    mesh = thread_meshes(1, 2)[0]
    dims = dict(DIMS, n_experts=2) if what == "moe" else DIMS
    kw = dict(PAGED, kv_num_blocks=32, kv_host_blocks=4
              ) if what == "host-tier" else ENGINE
    cfg = torch_cfg(dims)
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match=("ROADMAP A11c" if what == "moe"
                                          else "ROADMAP A11b, second part")):
        tsrv.ContinuousBatchEngine(params, cfg, device="cpu", mesh=mesh, **kw)


def same_tree(a, b) -> bool:
    fa, fb = tsrv._flat_leaves(a), tsrv._flat_leaves(b)
    return ([p for p, _ in fa] == [p for p, _ in fb]
            and all(torch.equal(x, y) for (_, x), (_, y) in zip(fa, fb)))


@pytest.mark.parametrize("dims,int8", [(DIMS, False), (GQA_DIMS, True)],
                         ids=["plain", "int8-gqa"])
def test_swap_params_on_a_mesh_keeps_each_ranks_blocks(dims, int8):
    """A hot swap on a (2, 4) thread gang: the driver's full tree, left on
    the host, goes out leaf by leaf; every rank then holds exactly its
    blocks of the new tree, and the transcripts after the swap are a
    single-device engine's on the new tree."""
    from k8s_gpu_workload_enhancer_tpu_torch.ops.quant import quantize_params
    cfg = torch_cfg(dims)
    old = port_params(dims, int8)
    new = ttf.init_params(torch.Generator().manual_seed(1), cfg)
    new = quantize_params(new) if int8 else new
    want = run(tsrv.ContinuousBatchEngine(new, cfg, device="cpu", **PAGED))

    def rank(mesh):
        eng = tsrv.ContinuousBatchEngine(
            tdecode.shard_params_for_serving(old, cfg, mesh), cfg,
            device="cpu", mesh=mesh, **PAGED)
        if not mesh.is_driver:
            eng.follow()
            return same_tree(eng.params, tdecode.shard_params_for_serving(
                new, cfg, mesh)), None
        try:
            eng.swap_params(new)
            got = run(eng)
        finally:
            eng.stop_followers()
        return same_tree(eng.params, tdecode.shard_params_for_serving(
            new, cfg, mesh)), got
    out = on_thread_gang(2, 4, rank)
    assert all(ok for ok, _ in out)
    assert out[0][1]["tokens"] == want["tokens"]
    assert out[0][1]["metrics"]["resilience"]["weight_swaps"] == 1


class StubGraph:
    """A decode graph's interface on the CPU: replay runs the program, and
    the resets are counted."""

    def __init__(self):
        self.resets = self.replays = self.captures = 0

    def reset(self):
        self.resets += 1

    def replay(self, run):
        self.replays += 1
        run()


def test_device_loss_on_a_mesh_of_one_drops_the_decode_graphs():
    """A (1, 1) mesh runs the single-device programs, on the card through
    CUDA graphs that read the engine's cache. A device loss there rebuilds
    the cache, so the graph is dropped (captured again on its next replay)
    and the degraded engine serves what one device does."""
    from k8s_gpu_workload_enhancer_tpu_torch import faultlab
    cfg, full = torch_cfg(DIMS), port_params(DIMS)
    want = run(port_engine(DIMS, ENGINE), EVAC_PROMPTS[:1], [EVAC_N])

    def rank(mesh):
        eng = tsrv.ContinuousBatchEngine(full, cfg, device="cpu", mesh=mesh,
                                         **ENGINE)
        graph = eng._graph = StubGraph()
        r0 = eng.submit(list(EVAC_PROMPTS[0]), EVAC_N)
        for _ in range(64):
            eng.step()
            if len(eng.result(r0).tokens) >= 3:
                break
        replays = graph.replays
        faultlab.activate(faultlab.TargetedPlan({"engine.device_loss": [0]}))
        try:
            eng.step()
        finally:
            faultlab.deactivate()
        got = run(eng, EVAC_PROMPTS[:1], [EVAC_N])
        return (replays, graph.resets, graph.replays - replays,
                eng.result(r0).finish_reason, eng.mesh, got)
    replays, resets, after, finish, mesh, got = on_thread_gang(1, 1, rank)[0]
    assert replays > 0 and resets == 1 and after > 0
    assert finish == "migrated" and mesh is None
    assert got["tokens"] == want["tokens"]
