"""One rank of a gloo serving gang for the port's serving-mesh tests
(tests/test_torch_mesh_serving.py).

    python tests/torch_serve_gang.py JOB_DIR RANK

JOB_DIR/job.json names the world size and a list of phases, each a
serving mesh ([dp, tp]), a rendezvous port and its cases; JOB_DIR/
inputs.npz holds the numpy param trees the cases name. For each phase the
rank joins the gang through the port's `bootstrap.initialize_serving`
(gloo on the CPU, the launcher env of the serve main); for each case it
builds the engine on its blocks of the case's params (f32,
`decode.shard_params_for_serving`) with the case's engine arguments and
its ServingMesh. Rank 0 drives the case's scenario and writes what it saw
to JOB_DIR/<case name>.json; every other rank follows the programs rank 0
broadcasts until it stops them (or degrades to one device). A case's
"oracle" ([prompt, transcript] pairs) drafts for a spec engine
(`OracleDrafter`). Scenarios:
"transcripts" (the requests, run to the end: tokens, logprobs and the
engine's metrics), "eject" (one request ejected once it has committed
`min_tokens`: its resume state), "resume" (a resume state continued) and
"evacuate" (a device loss armed once the first request has 3 tokens: the
frames, the counters, a request served after it and the serve's `mesh`
block) and "kvhost" (the host KV tier's traffic, `kv_traffic`, under
eviction, or with a `fault` site one FaultLab fault at its first crossing,
`kv_fault_traffic`: each phase's tokens and `kv_state`; the pages demoted,
and whether each restored page holds what was demoted, bit for bit). On every case rank 0 records the
collectives of each device program it drives (parallel/comm_gate.record:
the header and the program), and on a "kvhost" case every rank those of
the programs it runs, to JOB_DIR/<case name>-rank<r>.json. Imports torch
and the port only: no jax.
"""

import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from k8s_gpu_workload_enhancer_tpu_torch import faultlab  # noqa: E402
from k8s_gpu_workload_enhancer_tpu_torch.cmd.serve import ServeService  # noqa: E402,E501
from k8s_gpu_workload_enhancer_tpu_torch.models import (  # noqa: E402
    decode, serving, transformer as tf)
from k8s_gpu_workload_enhancer_tpu_torch.parallel import comm_gate  # noqa: E402,E501
from k8s_gpu_workload_enhancer_tpu_torch.train import bootstrap  # noqa: E402

import torch_gang  # noqa: E402

torch.set_num_threads(1)


class OracleDrafter:
    """A drafter (context, k) -> tokens that proposes a request's known
    greedy continuation (`pairs`: each prompt and its transcript), the
    last of two or more drafts made wrong, so a verify round accepts all
    but one and rejects one."""

    def __init__(self, pairs, vocab: int):
        self.pairs = [(list(p), list(w)) for p, w in pairs]
        self.vocab = int(vocab)

    def __call__(self, context, k: int):
        ctx = list(context)
        for prompt, want in self.pairs:
            n = len(ctx) - len(prompt)
            if n >= 0 and ctx[:len(prompt)] == prompt and \
                    ctx[len(prompt):] == want[:n]:
                out = want[n:n + k]
                if len(out) >= 2:
                    out[-1] = (out[-1] + 1) % self.vocab
                return out
        return []


def transcripts(eng, case: dict) -> dict:
    rids = [eng.submit(list(p), n) for p, n in zip(case["prompts"],
                                                    case["gens"])]
    eng.run()
    reqs = [eng.result(r) for r in rids]
    m = eng.metrics()
    return {"tokens": [r.tokens for r in reqs],
            "logprobs": [r.logprobs for r in reqs],
            "finish": [r.finish_reason for r in reqs],
            "spec": m["spec"], "kv_cache": m["kv_cache"]}


def eject(eng, case: dict) -> dict:
    rid = eng.submit(list(case["prompt"]), case["n"])
    for _ in range(64):
        eng.step()
        if len(eng.result(rid).tokens) >= case["min_tokens"]:
            break
    return {"state": eng.eject(rid)}


def resume(eng, case: dict) -> dict:
    st = case["state"]
    rid = eng.submit(st["prompt"], st["maxNewTokens"],
                     committed=st["committed"], prng_key=st["prngKey"])
    eng.run()
    req = eng.result(rid)
    return {"tokens": req.tokens, "emit_from": req.emit_from}


def evacuate(eng, case: dict) -> dict:
    rids = [eng.submit(list(p), case["n"]) for p in case["prompts"]]
    for _ in range(64):
        eng.step()
        if len(eng.result(rids[0]).tokens) >= 3:
            break
    queued = not eng.result(rids[-1]).done
    faultlab.activate(faultlab.TargetedPlan({"engine.device_loss": [0]}))
    try:
        eng.step()
    finally:
        faultlab.deactivate()
    reqs = [eng.result(r) for r in rids]
    out = {"queued": queued, "finish": [r.finish_reason for r in reqs],
           "frames": [r.resume_state for r in reqs],
           "resilience": eng.metrics()["resilience"]}
    r3 = eng.submit(list(case["prompts"][0]), case["n"])
    eng.run()
    out["after"] = eng.result(r3).tokens
    out["mesh_none"] = eng.mesh is None
    svc = ServeService(eng, mesh_shape=tuple(case["mesh_shape"]))
    try:
        out["mesh"] = svc.metrics({})["metrics"]["mesh"]
    finally:
        svc.stop()
    return out


# The host tier's traffic (tests/test_torch_kvhost.py's, at the mesh
# tests' widths): a 27-token prompt (3 full blocks of 8, 3 tokens over),
# three prompts of other prefixes that evict it from a pool of 9 pages,
# and a partial re-arrival of its first two blocks.
KV_PROMPT = list(range(1, 28))
KV_OTHERS = [[40 + i, 41 + i] + list(range(60 + 9 * i, 79 + 9 * i))
             for i in range(3)]
KV_TAIL = KV_PROMPT[:16] + [99, 98, 97, 96, 95]


def kv_state(eng) -> dict:
    """The kvhost block less its wall clock, the radix tree node by node,
    the leases and the free pages (the JAX engine's too)."""
    kv = dict(eng.metrics()["kvhost"])
    kv.pop("dma_seconds_total")
    nodes, stack = [], list(eng._radix.root.children.values())
    while stack:
        n = stack.pop()
        nodes.append([n.digest, n.block, n.ref, n.pins])
        stack.extend(n.children.values())
    return dict(kvhost=kv, nodes=sorted(nodes), leases=sorted(eng._leases),
                free=eng._pool.free_count)


def kv_run(eng, prompt, n: int) -> dict:
    rid = eng.submit(list(prompt), n)
    eng.run()
    r = eng.result(rid)
    return {"tokens": [int(t) for t in r.tokens],
            "logprobs": [float(x) for x in r.logprobs],
            "finish": r.finish_reason, "state": kv_state(eng)}


def evict_all(eng) -> None:
    eng._radix.evict(eng.metrics()["kv_cache"]["blocks_cached"])


def kv_traffic(eng) -> list:
    """The tier's phases: each phase's request (None for an eviction) and
    the state after it."""
    out = [kv_run(eng, KV_PROMPT, 8)]
    evict_all(eng)
    out.append({"state": kv_state(eng)})
    out.append(kv_run(eng, KV_PROMPT, 8))
    out += [kv_run(eng, p, 10) for p in KV_OTHERS]
    out.append(kv_run(eng, KV_PROMPT, 8))
    out.append(kv_run(eng, KV_TAIL, 6))
    return out


def kv_fault_traffic(eng, site: str, fl) -> list:
    """One fault at the first crossing of `site` (FaultLab `fl`): at the
    demotion of an eviction (kvhost.dma) or at the prefetch after it."""
    out = [kv_run(eng, KV_PROMPT, 8)]
    if site != "kvhost.dma":
        evict_all(eng)
    fl.activate(fl.TargetedPlan({site: [0]}))
    try:
        if site == "kvhost.dma":
            evict_all(eng)
        out.append(kv_run(eng, KV_PROMPT, 8))
        snap = fl.snapshot()
    finally:
        fl.deactivate()
    out.append({"injections": snap["injections_by_site"],
                "occurrences": snap["occurrences_by_site"]})
    return out


def watch_pages(eng) -> dict:
    """Every page the tier demotes (assembled, as it stores it) by digest;
    after every restore of one, whether the driver's pool page holds its
    KV-head shard of it bit for bit. The tier runs unchanged."""
    seen = {"demoted": {}, "restored": 0, "equal": 0}
    tier = eng._host_tier
    offload, restore, stage = tier.offload, tier.restore, tier._stage
    current = {}

    def on_offload(cache, blk, digest, *rest):
        current["digest"] = digest
        return offload(cache, blk, digest, *rest)

    def on_stage(cache, blk):
        page = stage(cache, blk)
        seen["demoted"][current["digest"]] = {n: t.clone()
                                              for n, t in page.items()}
        return page

    def on_restore(cache, blk, entry):
        restore(cache, blk, entry)
        want = seen["demoted"][entry.digest]
        mine = dict(zip(want, (t[:, blk] for t in eng._cache.leaves())))
        seen["restored"] += 1
        seen["equal"] += all(torch.equal(mine[n], want[n].narrow(
            2, 0, mine[n].shape[2])) for n in want)
    tier.offload, tier.restore, tier._stage = on_offload, on_restore, \
        on_stage
    return seen


def kvhost(eng, case: dict) -> dict:
    seen = watch_pages(eng)
    site = case.get("fault")
    phases = (kv_fault_traffic(eng, site, faultlab) if site
              else kv_traffic(eng))
    return {"phases": phases, "mesh_sig": eng._host_tier.mesh_sig,
            "demoted": len(seen["demoted"]), "restored": seen["restored"],
            "restored_equal": seen["equal"],
            "kv_cache": eng.metrics()["kv_cache"]}


SCENARIOS = {"transcripts": transcripts, "eject": eject, "resume": resume,
             "evacuate": evacuate, "kvhost": kvhost}


def record_programs(eng, driver: bool) -> list:
    """[program name, steps (a chunk's; else None), calls] for each device
    program this rank runs from now on: the driver's `_prog` (its header
    and the program), a follower's `_p_<name>` (the program)."""
    seen = []

    def wrap(fn, name=None):
        def run(*args):
            prog = name or args[0]
            with comm_gate.record() as calls:
                out = fn(*args)
            steps = (args[1] if name is None else args[0]) \
                if prog == "chunk" else None
            seen.append([prog, steps, calls])
            return out
        return run
    if driver:
        eng._prog = wrap(eng._prog)
    else:
        for name in ("prefill_step", "prefill_final", "chunk", "verify",
                     "kv_demote", "kv_restore"):
            setattr(eng, "_p_" + name, wrap(getattr(eng, "_p_" + name),
                                            name))
    return seen


def run_case(case: dict, inputs: dict, mesh, job_dir: pathlib.Path) -> None:
    cfg = tf.TransformerConfig(**case["model"], dtype=torch.float32)
    full = tf.params_from_numpy(torch_gang.unflat(inputs, case["params"]),
                                cfg, "cpu")
    kw = dict(case["engine"])
    if case.get("oracle"):
        kw["drafter"] = OracleDrafter(case["oracle"], cfg.vocab_size)
    eng = serving.ContinuousBatchEngine(
        decode.shard_params_for_serving(full, cfg, mesh), cfg, device="cpu",
        mesh=mesh, **kw)
    rank_file = job_dir / f"{case['name']}-rank{mesh.rank}.json"
    if not mesh.is_driver:
        programs = record_programs(eng, False)
        eng.follow()
        if case["kind"] == "kvhost":
            rank_file.write_text(json.dumps(programs))
        return
    programs = record_programs(eng, True)
    try:
        out = SCENARIOS[case["kind"]](eng, case)
    finally:
        eng.stop_followers()
    rank_file.write_text(json.dumps(programs))
    (job_dir / f"{case['name']}.json").write_text(json.dumps(out))


def main(job_dir: str, rank: int) -> None:
    job_dir = pathlib.Path(job_dir)
    spec = json.loads((job_dir / "job.json").read_text())
    inputs = dict(np.load(job_dir / "inputs.npz"))
    for phase in spec["phases"]:
        env = {"COORDINATOR_ADDRESS": f"localhost:{phase['port']}",
               "NUM_PROCESSES": str(spec["world"]), "PROCESS_ID": str(rank)}
        ctx, mesh = bootstrap.initialize_serving(tuple(phase["mesh"]), env,
                                                 device="cpu")
        try:
            for case in phase["cases"]:
                run_case(case, inputs, mesh, job_dir)
        finally:
            ctx.close()
    (job_dir / f"rank{rank}.json").write_text(json.dumps({"rank": rank}))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
