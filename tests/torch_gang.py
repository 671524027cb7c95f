"""One rank of a gloo gang for the port's FSDP tests (tests/test_torch_fsdp.py).

    python tests/torch_gang.py JOB_DIR RANK

JOB_DIR/job.json names the world size, the rendezvous port and a list of
jobs; JOB_DIR/inputs.npz holds the numpy params and token batches they
use. The rank joins the gang through the port's `bootstrap.initialize`
(gloo on the CPU), runs the jobs in order and writes what it saw to
JOB_DIR/rank{RANK}.json (metrics, its blocks' sizes) and, on rank 0, the
full gathered trees to JOB_DIR/<job name>.npz. Imports torch and the port
only: no jax.
"""

import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as tf  # noqa: E402
from k8s_gpu_workload_enhancer_tpu_torch.train import (  # noqa: E402
    bootstrap, checkpoint, trainer)

torch.set_num_threads(1)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def unflat(arrays: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, value in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def configs(job: dict):
    model = tf.TransformerConfig(**job["model"], dtype=torch.float32)
    train = trainer.TrainConfig(**job["train"])
    return model, train


def state_from(job, inputs, model, train, mesh):
    """A TrainState on `mesh` from the job's numpy params (all ranks hold
    the same full arrays and keep their blocks), or seeded."""
    if "params" not in job:
        gen = torch.Generator().manual_seed(job.get("seed", 0))
        return trainer.init_state(model, train, gen, mesh)
    full = tf.params_from_numpy(unflat(inputs, job["params"]), model, "cpu")
    state = trainer.init_state(model, train, torch.Generator().manual_seed(0),
                               mesh)
    full = state.fsdp.shard_tree(full)
    state.params = trainer.tree_map(lambda p: p.requires_grad_(True), full)
    state.opt_state = trainer.make_optimizer(train).init(state.params)
    return state


def full_arrays(state) -> dict:
    fsdp = state.fsdp
    trees = {"params": state.params, "mu": state.opt_state["mu"],
             "nu": state.opt_state["nu"]}
    return {f"{name}{k}": v.numpy() for name, tree in trees.items()
            for k, v in flat(fsdp.full_tree(tree)).items()}


def block_sizes(state) -> dict:
    trees = {"params": state.params, "mu": state.opt_state["mu"],
             "nu": state.opt_state["nu"]}
    return {f"{name}{k}": list(v.shape) for name, tree in trees.items()
            for k, v in flat(tree).items()}


def run_job(job, inputs, ctx, job_dir: pathlib.Path) -> dict:
    model, train = configs(job)
    state = state_from(job, inputs, model, train, ctx.mesh)
    if job.get("restore"):
        state = checkpoint.CheckpointManager(
            str(job_dir / job["restore"])).restore(None, state)
    step = trainer.make_train_step(model, train)
    metrics = []
    for i in range(job.get("steps", 0)):
        toks = torch.from_numpy(inputs[f"{job['batches']}/{i}"]).long()
        state, m = step(state, state.fsdp.rank_rows(toks, train.grad_accum))
        metrics.append({k: float(m[k]) for k in
                        ("loss", "nll", "aux", "grad_norm")})
    if job.get("save"):
        checkpoint.CheckpointManager(str(job_dir / job["save"])).save(
            state.step, state, wait=True)
    arrays = full_arrays(state)
    if ctx.is_primary:
        np.savez(job_dir / f"{job['name']}.npz", **arrays)
    return {"metrics": metrics, "step": state.step,
            "count": state.opt_state["count"],
            "blocks": block_sizes(state), "dims": flat(state.fsdp.dims)}


def main(job_dir: str, rank: int) -> None:
    job_dir = pathlib.Path(job_dir)
    spec = json.loads((job_dir / "job.json").read_text())
    inputs = dict(np.load(job_dir / "inputs.npz"))
    env = {"COORDINATOR_ADDRESS": f"localhost:{spec['port']}",
           "NUM_PROCESSES": str(spec["world"]), "PROCESS_ID": str(rank),
           "KTWE_STRATEGY": "FSDP"}
    ctx = bootstrap.initialize(env, device="cpu")
    try:
        out = {job["name"]: run_job(job, inputs, ctx, job_dir)
               for job in spec["jobs"]}
    finally:
        ctx.close()
    (job_dir / f"rank{rank}.json").write_text(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
