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
block). Imports torch and the port only: no jax.
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


SCENARIOS = {"transcripts": transcripts, "eject": eject, "resume": resume,
             "evacuate": evacuate}


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
    if not mesh.is_driver:
        eng.follow()
        return
    try:
        out = SCENARIOS[case["kind"]](eng, case)
    finally:
        eng.stop_followers()
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
