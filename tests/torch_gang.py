"""One rank of a gloo gang for the port's mesh tests (tests/test_torch_fsdp.py,
tests/test_torch_ring.py, tests/test_torch_model_parallel.py).

    python tests/torch_gang.py JOB_DIR RANK

JOB_DIR/job.json names the world size and either a rendezvous port and a
list of jobs (an FSDP mesh) or a list of phases, each a mesh
(`mesh_axes`, KTWE_MESH_AXES's form), a port and its jobs, and optionally
its own `world` (the ranks from it on skip the phase); JOB_DIR/
inputs.npz holds the numpy params, token batches and tensors they use.
The rank joins the gang of each phase through the port's
`bootstrap.initialize` (gloo on the CPU), runs its jobs in order, leaves
the group, and writes what it saw to JOB_DIR/rank{RANK}.json (metrics, the
collectives of each train step (parallel/comm_gate.record), its blocks'
sizes, its mesh coordinates) and, on rank 0, the full gathered
trees to JOB_DIR/<job name>.npz. A job of kind "train" (the default)
trains, saves and restores; "forward" writes the rank's block of the
logits (and, for an MoE model, the aux loss), "grads" the loss and the
full gradient tree, "ring" the rank's
ring attention output and gradients, "tanh" the GPipe schedule's output
and its stage's gradients on a tanh layer (parallel/pipeline.py, the
JAX test's toy stage), each rank to JOB_DIR/<job
name>-rank{RANK}.npz. A train or grads job with "gpipe": M trains
through the explicit GPipe schedule (`pipeline.gpipe_lm_loss`, M
microbatches), each rank on its rows by the schedule's batch axes.
Imports torch and the port only: no jax.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as tf  # noqa: E402
from k8s_gpu_workload_enhancer_tpu_torch.parallel import (  # noqa: E402
    comm_gate, pipeline, ring_attention as ring)
from k8s_gpu_workload_enhancer_tpu_torch.parallel.comm import (  # noqa: E402
    ProcessComm)
from k8s_gpu_workload_enhancer_tpu_torch.parallel.sharding import (  # noqa: E402
    StageLayout)
from k8s_gpu_workload_enhancer_tpu_torch.train import (  # noqa: E402
    bootstrap, checkpoint, trainer)

torch.set_num_threads(1)

GANG_TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Gang:
    """`world` ranks of `script` (default this one) started in the
    background on `phases` (each {"mesh_axes": ..., "jobs": [...]} here;
    tests/torch_serve_gang.py reads its own), each given a free port, with
    `inputs` (name -> numpy array) in JOB_DIR/inputs.npz. `result()` waits
    for every rank, each with one deadline, and raises if one failed or is
    still running then (all are killed); `close()` kills what still runs."""

    def __init__(self, job_dir: pathlib.Path, world: int, phases: list,
                 inputs: dict, timeout: float = GANG_TIMEOUT_S,
                 script: str = __file__):
        self.dir, self.world, self.timeout = job_dir, world, timeout
        np.savez(job_dir / "inputs.npz", **inputs)
        phases = [dict(p, port=free_port()) for p in phases]
        (job_dir / "job.json").write_text(json.dumps(
            {"world": world, "phases": phases}))
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
        self.procs = [subprocess.Popen(
            [sys.executable, str(pathlib.Path(script).resolve()),
             str(job_dir), str(r)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
        self._out = None

    def result(self) -> list:
        if self._out is None:
            deadline = time.monotonic() + self.timeout
            try:
                for r, p in enumerate(self.procs):
                    _, err = p.communicate(
                        timeout=max(1.0, deadline - time.monotonic()))
                    if p.returncode:
                        raise RuntimeError(f"gang rank {r} failed:\n"
                                           f"{err[-4000:]}")
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"a gang rank did not finish within "
                                   f"{self.timeout} s") from None
            finally:
                self.close()
            self._out = [json.loads((self.dir / f"rank{r}.json").read_text())
                         for r in range(self.world)]
        return self._out

    def arrays(self, name: str) -> dict:
        """What rank 0 wrote for job `name`."""
        self.result()
        return dict(np.load(self.dir / f"{name}.npz"))

    def rank_arrays(self, name: str) -> list:
        """What each rank wrote for job `name`, with its mesh coordinates."""
        out = self.result()
        return [(out[r][name]["coords"],
                 dict(np.load(self.dir / f"{name}-rank{r}.npz")))
                for r in range(self.world)]

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


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


def coords(ctx) -> dict:
    return {a: ctx.mesh.get_local_rank(a)
            for a in ("dp", "pp", "ep", "tp", "sp")}


def loss_of(job):
    """The job's loss override: the GPipe schedule's with "gpipe": M."""
    if not job.get("gpipe"):
        return None
    m = job["gpipe"]
    return lambda p, t, c, f: pipeline.gpipe_lm_loss(p, t, c, f, m)


def rows_of(job, fsdp, tokens, grad_accum=1):
    """This rank's rows of a global batch: by (dp, ep), or on the GPipe
    path by the schedule's batch axes."""
    split = None
    if job.get("gpipe"):
        micro = tokens.shape[0 if grad_accum == 1 else 1] // job["gpipe"]
        split = pipeline.batch_split(fsdp, micro)
    return fsdp.rank_rows(tokens, grad_accum, split)


def run_tanh(job, inputs, ctx, out_path: pathlib.Path) -> dict:
    """`gpipe` of the tanh stage over this rank's pp group (its stage's
    layers of the job's w and b, the whole xs on every rank), and the
    gradients of mean(out^2) for its stage's w and b."""
    group = ctx.mesh.get_group("pp")
    layout = StageLayout(ProcessComm(
        group, torch.distributed.get_process_group_ranks(group)))
    full = {k: torch.from_numpy(inputs[f"{job['tensors']}/{k}"])
            for k in ("w", "b")}
    mine = {k: v.clone().requires_grad_(True)
            for k, v in layout.stage_block(full).items()}
    xs = torch.from_numpy(inputs[f"{job['tensors']}/xs"])

    def layer(x, lp):
        return torch.tanh(x @ lp["w"] + lp["b"])
    with comm_gate.record() as calls:
        out = pipeline.gpipe(pipeline.stack_stage_fn(layer), mine, xs,
                             layout)
        (out ** 2).mean().backward()
    np.savez(out_path, out=out.detach().numpy(), w=mine["w"].grad.numpy(),
             b=mine["b"].grad.numpy())
    return {"coords": coords(ctx), "collectives": calls}


def run_ring(job, inputs, ctx, out_path: pathlib.Path) -> dict:
    """Ring attention of this rank's sp shard of the job's q, k, v (its dp
    rows), the gradients of sum(o * do) for its shard of do."""
    mesh = ctx.mesh
    group = mesh.get_group("sp")
    sp, r = mesh["sp"].size(), mesh.get_local_rank("sp")
    dp, dr = mesh["dp"].size(), mesh.get_local_rank("dp")

    def local(name):
        t = torch.from_numpy(inputs[f"{job['tensors']}/{name}"])
        b, s = t.shape[0] // dp, t.shape[1] // sp
        return t[dr * b:(dr + 1) * b, r * s:(r + 1) * s].clone()
    q, k, v = (local(n).requires_grad_(True) for n in ("q", "k", "v"))
    o = ring.ring_attention(q, k, v, group, causal=job["causal"],
                            use_flash=job["flash"])
    (o * local("do")).sum().backward()
    np.savez(out_path, o=o.detach().numpy(), dq=q.grad.numpy(),
             dk=k.grad.numpy(), dv=v.grad.numpy())
    return {"coords": coords(ctx),
            "flash": ring.ring_uses_flash(q, repeat(k, q), job["causal"],
                                          job["flash"])}


def repeat(k, q):
    return k.repeat_interleave(q.shape[2] // k.shape[2], dim=2)


def run_forward(job, inputs, state, model, out_path: pathlib.Path) -> dict:
    """This rank's block of the logits of each of the job's token arrays
    (its (dp, ep) rows, sp positions, tp vocab columns), and for an MoE
    model the layers' summed aux loss (of the global batch)."""
    out = {}
    fsdp = state.fsdp
    with torch.no_grad():
        for name in job["tokens"]:
            toks = torch.from_numpy(inputs[name]).long()
            rows = fsdp.rank_rows(toks)
            out[name] = tf.forward(state.params, rows, model,
                                   fsdp=fsdp).numpy()
            if model.is_moe:
                _, aux = (tf._forward_hidden_mp(state.params, rows, model,
                                                fsdp) if fsdp.model_parallel
                          else tf._forward_hidden_aux(state.params, rows,
                                                      model, fsdp=fsdp))
                out[name + "/aux"] = aux.numpy()
    np.savez(out_path, **out)
    return {}


def run_grads(job, inputs, state, model, ctx, job_dir) -> dict:
    """The loss and the full gradient tree of one global batch, the
    gradients finished as the train step finishes them."""
    fsdp = state.fsdp
    toks = torch.from_numpy(inputs[job["batch"]]).long()
    rows = rows_of(job, fsdp, toks)
    gpipe = loss_of(job)
    with comm_gate.record() as calls:
        total, parts = (tf.loss_fn(state.params, rows, model, fsdp=fsdp)
                        if gpipe is None else
                        gpipe(state.params, rows, model, fsdp))
    leaves = trainer.tree_leaves(state.params)
    with comm_gate.record() as more:
        grads = trainer._grad(total, state.params)
        fsdp.reduce_grads_(grads)
    calls += more
    norm = float(trainer.global_norm(grads, fsdp))
    full = fsdp.full_tree(grads)
    if ctx.is_primary:
        np.savez(job_dir / f"{job['name']}.npz",
                 **{f"grads{k}": v.numpy() for k, v in flat(full).items()})
    return {"loss": float(fsdp.mean(total.detach())), "grad_norm": norm,
            "rows": list(rows.shape), "coords": coords(ctx),
            "collectives": calls}


def run_job(job, inputs, ctx, job_dir: pathlib.Path) -> dict:
    kind = job.get("kind", "train")
    rank_file = job_dir / f"{job['name']}-rank{dist_rank()}.npz"
    if kind == "ring":
        return run_ring(job, inputs, ctx, rank_file)
    if kind == "tanh":
        return run_tanh(job, inputs, ctx, rank_file)
    model, train = configs(job)
    state = state_from(job, inputs, model, train, ctx.mesh)
    if kind == "forward":
        return dict(run_forward(job, inputs, state, model, rank_file),
                    coords=coords(ctx))
    if kind == "grads":
        return run_grads(job, inputs, state, model, ctx, job_dir)
    if job.get("restore"):
        state = checkpoint.CheckpointManager(
            str(job_dir / job["restore"])).restore(None, state)
    step = trainer.make_train_step(model, train, loss_of(job))
    metrics, collectives = [], []
    for i in range(job.get("steps", 0)):
        toks = torch.from_numpy(inputs[f"{job['batches']}/{i}"]).long()
        with comm_gate.record() as calls:
            state, m = step(state, rows_of(job, state.fsdp, toks,
                                           train.grad_accum))
        metrics.append({k: float(m[k]) for k in
                        ("loss", "nll", "aux", "grad_norm")})
        collectives.append(calls)
    if job.get("save"):
        checkpoint.CheckpointManager(str(job_dir / job["save"])).save(
            state.step, state, wait=True)
    arrays = full_arrays(state)
    if ctx.is_primary:
        np.savez(job_dir / f"{job['name']}.npz", **arrays)
    return {"metrics": metrics, "step": state.step,
            "count": state.opt_state["count"], "collectives": collectives,
            "blocks": block_sizes(state), "dims": flat(state.fsdp.dims),
            "tp_dims": flat(state.fsdp.tp_dims),
            "ep_dims": flat(state.fsdp.ep_dims),
            "pp_dims": flat(state.fsdp.pp_dims), "coords": coords(ctx)}


def dist_rank() -> int:
    return torch.distributed.get_rank()


def main(job_dir: str, rank: int) -> None:
    job_dir = pathlib.Path(job_dir)
    spec = json.loads((job_dir / "job.json").read_text())
    inputs = dict(np.load(job_dir / "inputs.npz"))
    phases = spec.get("phases") or [
        {"port": spec["port"], "jobs": spec["jobs"]}]
    out = {}
    for phase in phases:
        world = phase.get("world", spec["world"])
        if rank >= world:
            continue
        env = {"COORDINATOR_ADDRESS": f"localhost:{phase['port']}",
               "NUM_PROCESSES": str(world), "PROCESS_ID": str(rank),
               "KTWE_STRATEGY": "FSDP",
               "KTWE_MESH_AXES": phase.get("mesh_axes", "")}
        ctx = bootstrap.initialize(env, device="cpu")
        try:
            out.update({job["name"]: run_job(job, inputs, ctx, job_dir)
                        for job in phase["jobs"]})
        finally:
            ctx.close()
    (job_dir / f"rank{rank}.json").write_text(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
