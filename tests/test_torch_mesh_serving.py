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

The host KV tier on the mesh (the same gang, more cases): the paged
engine with `kv_host_blocks` under the tier's traffic (eviction into the
tier, prefetches, a short pool's evictions by admission, a partial
re-arrival), plain, with int8 KV, under the GQA fallback (KV heads
replicated over tp: a demotion moves nothing) and with one FaultLab fault
at each `kvhost.*` site: tokens, the `kvhost` block (bloom included, less
its wall clock), the radix tree, leases and free pages after every phase
equal the JAX engine's on the same (2, 4) mesh and on one device, with
the JAX `HostBlockTier`; logprobs within tolerance; every restored page
holds what was demoted, bit for bit.

The collective-budget gate (parallel/comm_gate.py): every device program
the gang's driver ran (prefill chunks, dense and paged decode chunks,
dense and paged verify rounds, the tier's demotions and restores) made
exactly its pinned collectives, the followers the same less the header
(a demotion none on the other dp replica); the tier's page bytes are
pinned exactly; and in a steady decode chunk and verify round no call
moves more than JAX's caps or the programs' activation rows, which are at
least 4x below one page and 8x below a weight leaf.

In process: `shard_params_for_serving` block for block against the JAX
function's addressable shards on the same mesh (an int8 tree with two KV
heads, and the plain tree); the meshed forward's logits on a thread gang
against the JAX forward; the thread gang's transcripts against the gloo
gang's (bitwise: both sum in rank order); a dense engine's num_slots % dp
refused with the JAX message; the tier's signature on thread gangs against
the JAX tier's on the same meshes; a (1, 2) engine's `/v1/kvhost` export
imported and restored by another (1, 2) engine and refused by a (1, 4)
and a single-device one; demote-ahead at the watermark on a (1, 2) gang
as on one device; the dp replicas' pools equal bit for bit after the
tier's traffic.
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu import faultlab as jfl
from k8s_gpu_workload_enhancer_tpu.models import decode as jdecode
from k8s_gpu_workload_enhancer_tpu.models import kvhost as jkv
from k8s_gpu_workload_enhancer_tpu.models import serving as jsrv
from k8s_gpu_workload_enhancer_tpu.models import transformer as jtf
from k8s_gpu_workload_enhancer_tpu.ops.quant import quantize_params as jquant
from k8s_gpu_workload_enhancer_tpu.parallel import mesh as jmesh
from k8s_gpu_workload_enhancer_tpu_torch import faultlab as tfl
from k8s_gpu_workload_enhancer_tpu_torch.models import decode as tdecode
from k8s_gpu_workload_enhancer_tpu_torch.models import kvhost as tkv
from k8s_gpu_workload_enhancer_tpu_torch.models import serving as tsrv
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.parallel import comm_gate
from k8s_gpu_workload_enhancer_tpu_torch.parallel.mesh import ServingMesh

import torch_gang
import torch_parity  # noqa: F401  (one intra-op thread a process)
import torch_serve_gang as tsg
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
# The host tier: a pool of 9 pages under a tier of 16 blocks.
TIER = dict(PAGED, kv_num_blocks=9, kv_host_blocks=16)
KVHOST_SITES = ("kvhost.dma", "kvhost.fetch", "kvhost.corrupt")
# name -> (dims, FaultLab site or None): the tier cases.
TIER_CASES = {
    "kv_plain": (DIMS, None),
    "kv_int8": (INT8KV_DIMS, None),
    "kv_gqa": (GQA_DIMS, None),
    **{f"kv_fault_{s.split('.')[1]}": (DIMS, s) for s in KVHOST_SITES},
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
    cases += [case(name, "kvhost", dims, TIER, fault=site)
              for name, (dims, site) in TIER_CASES.items()]
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


def gang_programs(gang, name: str, rank: int = 0) -> list:
    """[program, steps, calls] of each device program rank `rank` ran on
    case `name` (the driver's with its header)."""
    gang.result()
    return json.loads((gang.dir / f"{name}-rank{rank}.json").read_text())


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
    """Neither is refused any more. MoE on a mesh above one rank: the
    engine builds on a (1, 2) gang (every rank every expert's block of the
    MLP dim) and serves the unmeshed engine's greedy tokens; the serve
    main has no MoE flag (the JAX one has none either). The host KV tier:
    the engine builds it on the mesh, the driver's alone, keyed by the
    mesh's signature, and the followers hold none."""
    dims = dict(DIMS, n_experts=2) if what == "moe" else DIMS
    kw = dict(PAGED, kv_num_blocks=32, kv_host_blocks=4
              ) if what == "host-tier" else ENGINE
    cfg = torch_cfg(dims)
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    if what == "moe":
        want = run(tsrv.ContinuousBatchEngine(params, cfg, device="cpu",
                                              **kw))["tokens"]

        def serve(mesh):
            eng = tsrv.ContinuousBatchEngine(
                tdecode.shard_params_for_serving(params, cfg, mesh), cfg,
                device="cpu", mesh=mesh, **kw)
            if not mesh.is_driver:
                eng.follow()
                return None
            try:
                return run(eng)["tokens"]
            finally:
                eng.stop_followers()
        assert on_thread_gang(1, 2, serve)[0] == want
        return

    def rank(mesh):
        eng = tsrv.ContinuousBatchEngine(
            tdecode.shard_params_for_serving(params, cfg, mesh), cfg,
            device="cpu", mesh=mesh, **kw)
        if not mesh.is_driver:
            tier = eng._host_tier
            eng.follow()
            return tier
        eng.stop_followers()
        return eng._host_tier
    tier, follower = on_thread_gang(1, 2, rank)
    assert follower is None
    assert tier.capacity == 4 and tier.mesh_sig == (
        "backend=torch|dp=1,ep=1,pp=1,sp=1,tp=2|kv_tp=tp")


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


# ------------------------------------------------------ the host KV tier


def jax_tier_run(dims: dict, site, mesh=None) -> list:
    """The tier's traffic on the JAX paged engine (one device, or `mesh`)
    with the JAX HostBlockTier."""
    jcfg = jax_cfg(dims)
    jp = jax_params(dims)
    if mesh is not None:
        jp = jdecode.shard_params_for_serving(jp, jcfg, mesh)
    eng = jsrv.ContinuousBatchEngine(jp, jcfg, mesh=mesh, **TIER)
    if site is None:
        return tsg.kv_traffic(eng)
    return tsg.kv_fault_traffic(eng, site, jfl)


@pytest.fixture(autouse=True)
def inert_faultlab():
    """Both FaultLabs inert, their process-wide counters zeroed after each
    test (activating a plan clears them), so no later test in the process
    reads this one's injections."""
    yield
    for fl in (jfl, tfl):
        fl.activate(fl.FaultPlan(0, rate=0.0))
        fl.deactivate()


@pytest.mark.parametrize("name", list(TIER_CASES))
def test_mesh_tier_matches_jax_on_the_mesh_and_one_device(gang, tp_mesh,
                                                          name):
    """The paged engine with the host tier on the (2, 4) gloo gang against
    the JAX engine with the JAX tier on the same mesh and on one device:
    tokens, the kvhost block, the radix tree, leases and free pages after
    every phase exactly; logprobs within tolerance; every restored page
    what was demoted."""
    dims, site = TIER_CASES[name]
    got = gang_out(gang, name)
    one = jax_tier_run(dims, site)
    on_mesh = jax_tier_run(dims, site, tp_mesh)
    kv_tp = "tp" if dims["n_kv_heads"] % 4 == 0 else None
    assert got["mesh_sig"] == "backend=torch|" + jkv.mesh_signature(
        tp_mesh, kv_tp)
    for i, (g, w, m) in enumerate(zip(got["phases"], one, on_mesh)):
        for ref in (w, m):
            if "tokens" in g:
                assert g["tokens"] == ref["tokens"], (name, i)
                np.testing.assert_allclose(g["logprobs"], ref["logprobs"],
                                           **LOGITS_TOL)
            if "state" in g:
                want = dict(ref["state"], nodes=[list(n) for n in
                                                 ref["state"]["nodes"]])
                assert g["state"] == want, (name, i)
            if "injections" in g:
                # The kvhost sites' crossings (a meshed dispatch also
                # crosses engine.device_loss, which one device does not).
                assert g["injections"] == ref["injections"]
                assert {k: v for k, v in g["occurrences"].items()
                        if k.startswith("kvhost.")} == \
                    {k: v for k, v in ref["occurrences"].items()
                     if k.startswith("kvhost.")}
    kv = got["phases"][-1 if site is None else 1]["state"]["kvhost"]
    if site is None:
        assert kv["offloads_total"] >= 3 and kv["prefetches_total"] >= 5
        assert got["restored"] == kv["prefetches_total"] == \
            got["restored_equal"]
    elif site == "kvhost.corrupt":
        assert kv["corrupt_drops_total"] == 1
    else:
        assert kv["dma_failures_total"] == 1
    assert got["kv_cache"]["blocks_used"] == got["kv_cache"]["blocks_cached"]


def assert_program(calls, name: str, steps: int = 1, header: bool = True):
    want = comm_gate.expected(name, DIMS["n_layers"], steps)
    if not header:
        want.pop("object-broadcast", None)
    comm_gate.assert_collective_budget(calls, want, name)


def test_mesh_programs_hold_the_pinned_budget(gang):
    """Each device program the gang ran made exactly its pinned
    collectives (parallel/comm_gate.BUDGETS): on the driver its header and
    the program's, on the followers the program's, a demotion none on the
    other dp replica; the tier's page bytes exactly, per leaf."""
    seen = set()
    for case_name, kind in (("paged_plain", "paged"), ("dense_spec", "dense"),
                            ("paged_spec", "paged"), ("kv_plain", "paged")):
        for prog, steps, calls in gang_programs(gang, case_name):
            if prog in ("prefill_step", "prefill_final"):
                assert_program(calls, "serve/prefill_chunk")
            elif prog == "chunk":
                assert_program(calls, f"serve/decode_chunk/{kind}", steps)
            elif prog == "verify":
                assert_program(calls, f"serve/verify_round/{kind}")
            elif prog in ("kv_demote", "kv_restore"):
                assert_program(calls, f"serve/{prog}")
            else:
                # A temp cache's making and a park: the header alone.
                comm_gate.assert_collective_budget(
                    calls, {"object-broadcast": 1}, prog)
            seen.add((prog, kind))
    assert {("chunk", "paged"), ("chunk", "dense"), ("verify", "paged"),
            ("verify", "dense"), ("kv_demote", "paged"),
            ("kv_restore", "paged"), ("prefill_final", "paged")} <= seen
    hd = DIMS["d_model"] // DIMS["n_heads"]
    for case_name, variant, dims, int8 in (
            ("kv_plain", "", DIMS, False), ("kv_int8", "/int8", DIMS, True),
            ("kv_gqa", "", GQA_DIMS, False)):
        kv_heads, tp = dims["n_kv_heads"], 4 if dims["n_kv_heads"] == 4 else 1
        for prog in ("kv_demote", "kv_restore"):
            name = f"serve/{prog}" + ("/gqa" if case_name == "kv_gqa"
                                      and prog == "kv_demote" else variant)
            mine = [c for p, _, c in gang_programs(gang, case_name)
                    if p == prog]
            assert mine, (case_name, prog)
            page = comm_gate.tier_calls(
                f"serve/{prog}", DIMS["n_layers"], 8, kv_heads, hd, 4, tp,
                int8)
            for calls in mine:
                assert_program(calls, name)
                assert sorted(c for c in map(tuple, calls)
                              if c[0] != "object-broadcast") == page
            for r in range(1, 8):
                theirs = [c for p, _, c in gang_programs(gang, case_name, r)
                          if p == prog]
                assert len(theirs) == len(mine)
                for calls in theirs:
                    if prog == "kv_demote" and (r >= 4 or tp == 1):
                        assert calls == []
                    else:
                        assert_program(calls, name, header=False)


def test_steady_programs_move_nothing_of_page_or_weight_size(gang):
    """The size gate (JAX test_mesh_serving.py's): in every decode chunk
    and verify round of the gang no call moves more than JAX's caps (1024 B
    a move, 4096 B a sum) nor more than the program's activation rows
    (`comm_gate.row_caps`), and those caps are at least 4x below one page
    (its K and V leaves, every layer and KV head) and 8x below a weight
    leaf (d_model x d_ff f32, JAX's calibration)."""
    hd = DIMS["d_model"] // DIMS["n_heads"]
    page = 2 * DIMS["n_layers"] * 8 * DIMS["n_kv_heads"] * hd * 4
    weight = DIMS["d_model"] * DIMS["d_ff"] * 4
    checked = 0
    for case_name in ("paged_plain", "dense_spec", "paged_spec"):
        spec_k = CASES[case_name][1].get("spec_k", 0)
        for prog, _, calls in gang_programs(gang, case_name):
            if prog not in ("chunk", "verify"):
                continue
            rows = ENGINE["num_slots"] * (spec_k + 1 if prog == "verify"
                                          else 1)
            caps = comm_gate.row_caps(rows, DIMS["d_model"],
                                      DIMS["vocab_size"], 4)
            assert max(caps.values()) * 4 <= page
            assert max(caps.values()) * 8 <= weight
            comm_gate.assert_sizes_within(calls, caps, f"{case_name} {prog}")
            comm_gate.assert_sizes_within(calls, comm_gate.jax_caps(),
                                          f"{case_name} {prog}")
            checked += 1
    assert checked >= 10
    # A page moved in a steady program would fail the gate.
    with pytest.raises(AssertionError, match="KV-page or weight magnitude"):
        comm_gate.assert_sizes_within([("all-gather", page // 2)],
                                      comm_gate.row_caps(2, 32, 128, 4), "t")


def tier_engine_rank(dims: dict, fn, kw: dict = TIER):
    """A rank of a thread gang running the tier engine on `dims`: the
    driver returns fn(engine), a follower None."""
    cfg, full = torch_cfg(dims), port_params(dims)

    def rank(mesh):
        eng = tsrv.ContinuousBatchEngine(
            tdecode.shard_params_for_serving(full, cfg, mesh), cfg,
            device="cpu", mesh=mesh, **kw)
        if not mesh.is_driver:
            eng.follow()
            return eng
        try:
            return fn(eng)
        finally:
            eng.stop_followers()
    return rank


@pytest.mark.parametrize("dp,tp,dims", [(2, 4, DIMS), (1, 4, DIMS),
                                        (2, 4, GQA_DIMS), (1, 1, DIMS)],
                         ids=["2x4", "1x4", "gqa", "1x1"])
def test_tier_signature_is_the_jax_tiers_on_the_same_mesh(dp, tp, dims):
    """"backend=torch|" and then the JAX tier's signature for the JAX mesh
    of MeshConfig(dp, tp) and the same KV-head axis (None under the GQA
    fallback; "tp" on a (1, 1) mesh, as the JAX engine passes it)."""
    got = on_thread_gang(dp, tp, tier_engine_rank(
        dims, lambda eng: eng._host_tier.mesh_sig))[0]
    jmesh_ = jmesh.make_mesh(jmesh.MeshConfig(dp=dp, tp=tp),
                             devices=jax.devices()[:dp * tp])
    jcfg = jax_cfg(dims)
    assert got == "backend=torch|" + jkv.mesh_signature(
        jmesh_, jdecode._kv_tp_axis(jcfg, jmesh_))
    if dims is GQA_DIMS:
        assert got.endswith("|kv_tp=")


def test_export_moves_between_meshes_of_one_shape_only():
    """A (1, 2) engine's /v1/kvhost export (assembled pages, the JAX
    tier's keys and shapes) imports into another (1, 2) engine, whose
    admission restores it and serves the exporter's tokens; a (1, 4) and a
    single-device engine refuse it (another signature: never resharded)."""
    prompt = tsg.KV_PROMPT
    digests = tkv.prompt_digests(prompt, 8)

    def export(eng):
        want = tsg.kv_run(eng, prompt, 8)["tokens"]
        tsg.evict_all(eng)
        return want, json.loads(json.dumps(eng.kvhost_export(digests)))
    want, payloads = on_thread_gang(1, 2, tier_engine_rank(DIMS, export))[0]
    assert len(payloads) == 3
    hd = DIMS["d_model"] // DIMS["n_heads"]
    assert payloads[0]["arrays"]["k"]["shape"] == [DIMS["n_layers"], 8,
                                                   DIMS["n_kv_heads"], hd]

    def imports(eng):
        n = eng.kvhost_import(payloads)
        got = tsg.kv_run(eng, prompt, 8)
        return n, got["tokens"], got["state"]["kvhost"]
    n, tokens, kv = on_thread_gang(1, 2, tier_engine_rank(DIMS, imports))[0]
    assert n == 3 and tokens == want
    assert kv["imports_total"] == 3 and kv["prefetches_total"] == 3
    assert on_thread_gang(1, 4, tier_engine_rank(
        DIMS, lambda eng: eng.kvhost_import(payloads)))[0] == 0
    assert port_engine(DIMS, TIER).kvhost_import(payloads) == 0


def test_demote_ahead_on_a_mesh_is_one_devices():
    """Under the kv_offload_watermark an admission demotes cold blocks
    ahead of its need; on a (1, 2) thread gang the traffic's tokens and
    tier state equal the single-device engine's with the same watermark."""
    kw = dict(TIER, kv_offload_watermark=0.5)
    got = on_thread_gang(1, 2, tier_engine_rank(DIMS, tsg.kv_traffic, kw))[0]
    want = tsg.kv_traffic(port_engine(DIMS, kw))
    assert [p.get("tokens") for p in got] == [p.get("tokens") for p in want]
    assert [p["state"] for p in got] == [p["state"] for p in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.get("logprobs", []),
                                   w.get("logprobs", []), **LOGITS_TOL)
    assert want[-1]["state"]["kvhost"]["offloads_total"] > 0


def test_dp_replicas_hold_the_same_pool_after_the_tier_traffic():
    """The paged pool is replicated over dp and a demotion gathers over
    the driver's replica alone: after the tier's traffic on a (2, 4) thread
    gang every rank's pool equals its dp peer's bit for bit, and the
    transcripts and tier state are the single-device engine's."""
    out = on_thread_gang(2, 4, tier_engine_rank(
        DIMS, lambda eng: (tsg.kv_traffic(eng), eng)))
    phases, driver = out[0]
    engines = [driver] + out[1:]
    for r in range(4):
        for a, b in zip(engines[r]._cache.leaves(),
                        engines[r + 4]._cache.leaves()):
            assert torch.equal(a, b), r
    want = tsg.kv_traffic(port_engine(DIMS, TIER))
    assert [p.get("tokens") for p in phases] == \
        [p.get("tokens") for p in want]
    assert [p["state"] for p in phases] == [p["state"] for p in want]
