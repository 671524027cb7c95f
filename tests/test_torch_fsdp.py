"""FSDP training on the port, held on the CPU to the JAX trainer on a dp=2
mesh and to the port's own single-process run.

Gangs of two processes run the port (tests/torch_gang.py, or the trainer
main), each joining a gloo process group through the port's
`bootstrap.initialize` at a free port, each with its own timeout, so a hung
collective fails its test. The model is small (vocab 128, d_model 64, 2
layers, 2 heads, d_ff 128, seq 16, global batch 4, f32) and the same numpy
weights and token batches go to every run:

- three steps at grad_accum 1 and 2 (bf16 accumulator): loss, nll,
  grad_norm and the final params equal the JAX step's on
  `make_mesh(MeshConfig(dp=2))` (atol 1e-5, rtol 1e-4) and the port's
  single-process step on the same global batch, and with remat the
  same trajectory; each step's collectives hold their pinned budget
  (parallel/comm_gate.py);
- the MoE model (4 experts, 1 layer) at dp=2, grad_accum 1 and 2, equals
  the JAX MoE there, aux included: both take the dense expert route on a
  mesh of two devices;
- each rank holds half of every `embed`-sharded leaf and of its Adam
  moments, and a replicated norm scale whole;
- a checkpoint saved at world 2 restores at world 1 to the same state, and
  one saved at world 1 restores at world 2;
- the trainer main as a gang of two prints the lines one process prints on
  the same global batch, synthetic or from a token shard (at grad_accum 1
  and 2: a rank reads its block of every microbatch), and a SIGTERM
  drains both ranks after one agreed step with one marker.
"""

import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.models import transformer as jtf
from k8s_gpu_workload_enhancer_tpu.parallel import mesh as jmesh
from k8s_gpu_workload_enhancer_tpu.train import trainer as jtrainer
from k8s_gpu_workload_enhancer_tpu_torch.cmd import trainer as cli
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.parallel import comm_gate
from k8s_gpu_workload_enhancer_tpu_torch.train import checkpoint as tckpt
from k8s_gpu_workload_enhancer_tpu_torch.train import data as tdata
from k8s_gpu_workload_enhancer_tpu_torch.train import trainer as ttrainer

import torch_parity  # noqa: F401  (one intra-op thread a process)

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = pathlib.Path(__file__).resolve().parent / "torch_gang.py"
DIMS = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=2, n_kv_heads=2,
            d_ff=128, max_seq=16)
TRAIN = dict(warmup_steps=1, total_steps=5, batch_size=4, seq_len=16,
             grad_accum_dtype="bf16")
# (name, model settings over DIMS, grad_accum, lr): lr 1e-3 with the bf16
# accumulator, as tests/test_torch_train.py sets it (an element whose
# microbatch halves cancel keeps few bits, and last-bit differences then
# move its update). Only dense_acc1 has two layers (it holds the gathers
# of each layer's slices); one layer halves the others' JAX compile.
ONE = dict(n_layers=1)
MOE = dict(ONE, n_experts=4)
RUNS = (("dense_acc1", {}, 1, 1e-2), ("dense_acc2", ONE, 2, 1e-3),
        ("moe_acc1", MOE, 1, 1e-2), ("moe_acc2", MOE, 2, 1e-3))
STEPS = 3
TOL = dict(atol=1e-5, rtol=1e-4)
GANG_TIMEOUT_S = 180
TINY = ["--device", "cpu", "--seq-len", "16", "--d-model", "64",
        "--n-layers", "2", "--n-heads", "2", "--d-ff", "128",
        "--vocab-size", "128"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def gang_env(rank: int, world: int, port: int) -> dict:
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT),
                COORDINATOR_ADDRESS=f"localhost:{port}",
                NUM_PROCESSES=str(world), PROCESS_ID=str(rank),
                KTWE_STRATEGY="FSDP")


def finish(procs, timeout: float = GANG_TIMEOUT_S) -> list:
    """(returncode, stdout, stderr) of every process; kills them all and
    fails if one is still running after `timeout` seconds."""
    deadline = time.monotonic() + timeout
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            out.append((p.returncode, o, e))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a gang rank did not finish within {timeout} s")
    return out


def spawn(argv, world: int, port: int, cwd=ROOT) -> list:
    return [subprocess.Popen(argv(rank), env=gang_env(rank, world, port),
                             cwd=cwd, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for rank in range(world)]


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def jax_cfg(model: dict) -> jtf.TransformerConfig:
    return jtf.TransformerConfig(**dict(DIMS, **model), dtype=jnp.float32,
                                 use_flash=False, use_ring_attention=False)


def torch_cfg(model: dict) -> ttf.TransformerConfig:
    return ttf.TransformerConfig(**dict(DIMS, **model), dtype=torch.float32)


def inputs_of(model: dict, acc: int):
    """The numpy params (the port's init of seed 0) and STEPS global token
    batches (numpy, seed 1) of one run."""
    params = ttf.init_params(torch.Generator().manual_seed(0),
                             torch_cfg(model))
    params = {k: ({n: t.numpy() for n, t in v.items()}
                  if isinstance(v, dict) else v.numpy())
              for k, v in params.items()}
    rng = np.random.default_rng(1)
    shape = ((TRAIN["batch_size"], TRAIN["seq_len"] + 1) if acc == 1 else
             (acc, TRAIN["batch_size"] // acc, TRAIN["seq_len"] + 1))
    return params, [rng.integers(0, DIMS["vocab_size"], shape
                                 ).astype(np.int32) for _ in range(STEPS)]


def to_torch(params: dict, model: dict):
    return ttf.params_from_numpy(params, torch_cfg(model), "cpu")


class Gang:
    """A gang of two tests/torch_gang.py ranks started in the background;
    `result()` waits for it."""

    def __init__(self, job_dir: pathlib.Path, jobs: list, inputs: dict):
        self.dir = job_dir
        np.savez(job_dir / "inputs.npz", **inputs)
        port = free_port()
        (job_dir / "job.json").write_text(json.dumps(
            {"world": 2, "port": port, "jobs": jobs}))
        self.procs = spawn(lambda r: [sys.executable, str(WORKER),
                                      str(job_dir), str(r)], 2, port)
        self._out = None

    def result(self):
        if self._out is None:
            for rc, _, err in finish(self.procs):
                assert rc == 0, err[-4000:]
            self._out = [json.loads((self.dir / f"rank{r}.json").read_text())
                         for r in range(2)]
        return self._out

    def arrays(self, name: str) -> dict:
        self.result()
        return dict(np.load(self.dir / f"{name}.npz"))


def single_process(params: dict, batches, model: dict, acc: int, lr: float,
                   steps: int = STEPS):
    """The port's one-device run of the same global batches."""
    tcfg = ttrainer.TrainConfig(**TRAIN, grad_accum=acc, learning_rate=lr)
    p = ttrainer.tree_map(lambda t: t.requires_grad_(True),
                          to_torch(params, model))
    state = ttrainer.TrainState(p, ttrainer.make_optimizer(tcfg).init(p), 0)
    step = ttrainer.make_train_step(torch_cfg(model), tcfg)
    metrics = []
    for toks in batches[:steps]:
        state, m = step(state, torch.from_numpy(toks.copy()).long())
        metrics.append({k: float(m[k]) for k in
                        ("loss", "nll", "aux", "grad_norm")})
    return state, metrics


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """One gang of two running every job of the module, started before the
    tests compile their JAX steps: the RUNS (each saving its state at step
    STEPS), dense_acc1 again with remat, and a restore of a checkpoint
    written here by one process."""
    job_dir = tmp_path_factory.mktemp("gang")
    inputs, jobs, runs = {}, [], {}
    for name, model, acc, lr in RUNS:
        params, batches = inputs_of(model, acc)
        runs[name] = (params, batches, model, acc, lr)
        inputs.update({f"{name}/params{k}": v
                       for k, v in flat(params).items()})
        inputs.update({f"{name}/batches/{i}": b
                       for i, b in enumerate(batches)})
        jobs.append(dict(name=name, model=dict(DIMS, **model),
                         train=dict(TRAIN, grad_accum=acc,
                                    learning_rate=lr),
                         params=f"{name}/params", batches=f"{name}/batches",
                         steps=STEPS, save=f"ckpt-{name}"))
    jobs.append(dict(jobs[0], name="dense_acc1_remat", save=None,
                     model=dict(DIMS, remat=True)))
    # World 1 -> 2: two steps of the dense run in this process, saved.
    params, batches, model, acc, lr = runs["dense_acc1"]
    state, _ = single_process(params, batches, model, acc, lr, steps=2)
    tckpt.CheckpointManager(str(job_dir / "ckpt-world1")).save(2, state)
    jobs.append(dict(name="restore_world1", model=dict(DIMS),
                     train=dict(TRAIN, learning_rate=lr),
                     restore="ckpt-world1", seed=7))
    g = Gang(job_dir, jobs, inputs)
    g.runs, g.world1_state = runs, state
    yield g
    for p in g.procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def jax_run(params: dict, batches, model: dict, acc: int, lr: float):
    mesh = jmesh.make_mesh(jmesh.MeshConfig(dp=2), devices=jax.devices()[:2])
    cfg = jax_cfg(model)
    tc = jtrainer.TrainConfig(**TRAIN, grad_accum=acc, learning_rate=lr)
    # init_state's state, from the numpy params: sharded by the trainer's
    # rules, optax's zero moments, step 0.
    p = jax.device_put(params, jtrainer.param_shardings(cfg, mesh))
    state = jtrainer.TrainState(
        params=p, opt_state=jtrainer.make_optimizer(tc).init(p),
        step=jnp.zeros((), jnp.int32))
    step = jtrainer.make_train_step(cfg, tc, mesh)
    metrics = []
    for toks in batches:
        state, m = step(state, jnp.asarray(toks))
        metrics.append({k: float(m[k]) for k in
                        ("loss", "nll", "aux", "grad_norm")})
    return metrics, jax.tree.map(np.asarray, state.params)


def assert_metrics(got: list, want: list, what: str) -> None:
    assert len(got) == len(want) == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("loss", "nll", "aux", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key],
                                       err_msg=f"{what} step {i} {key}",
                                       **TOL)


def assert_params(arrays: dict, want: dict, what: str) -> None:
    want = flat(want)
    got = {k[len("params"):]: v for k, v in arrays.items()
           if k.startswith("params/")}
    assert set(got) == set(want)
    for k, w in want.items():
        w = w.detach().numpy() if isinstance(w, torch.Tensor) else w
        np.testing.assert_allclose(got[k], np.asarray(w),
                                   err_msg=f"{what} {k}", **TOL)


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_gang_matches_jax_on_a_dp2_mesh(gang, name):
    """Loss, nll, aux, grad_norm and the final params of the gang of two
    equal the JAX trainer's on a dp=2 mesh of the same weights and
    batches (the MoE model on the dense expert route in both)."""
    params, batches, model, acc, lr = gang.runs[name]
    want, want_params = jax_run(params, batches, model, acc, lr)
    out = gang.result()
    assert out[0][name]["metrics"] == out[1][name]["metrics"]
    assert_metrics(out[0][name]["metrics"], want, f"{name} vs JAX")
    assert_params(gang.arrays(name), want_params, f"{name} vs JAX")
    if "n_experts" in model:
        assert all(m["aux"] > 0.5 for m in want)
    assert out[0][name]["step"] == out[0][name]["count"] == STEPS


@pytest.mark.parametrize("name", ["dense_acc1", "dense_acc2"])
def test_gang_matches_the_single_process_run(gang, name):
    """The gang's trajectory equals one process's on the same global
    batch (the rows split over two ranks, the gradients reduce-scattered
    a microbatch at a time)."""
    params, batches, model, acc, lr = gang.runs[name]
    state, want = single_process(params, batches, model, acc, lr)
    assert_metrics(gang.result()[0][name]["metrics"], want,
                   f"{name} vs one process")
    assert_params(gang.arrays(name), state.params, f"{name} vs one process")


def test_fsdp_step_collectives_hold_the_pinned_budget(gang):
    """Both ranks' FSDP steps (dp=2, dense_acc1: two layers, grad_accum 1)
    make exactly the pinned collectives (parallel/comm_gate.BUDGETS): a
    layer's gathers, their reduce-scatters, the replicated leaves' and the
    metrics' all-reduces."""
    want = comm_gate.expected("train/fsdp_dp2", DIMS["n_layers"])
    for r, out in enumerate(gang.result()):
        steps = out["dense_acc1"]["collectives"]
        assert len(steps) == STEPS
        for i, calls in enumerate(steps):
            comm_gate.assert_collective_budget(
                calls, want, f"rank {r} fsdp step {i} on dp=2")


def test_remat_keeps_the_gang_trajectory(gang):
    """Recomputing each layer in the backward (the gathered weights are the
    checkpointed layer's inputs) changes nothing."""
    out = gang.result()[0]
    assert_metrics(out["dense_acc1_remat"]["metrics"],
                   out["dense_acc1"]["metrics"], "remat vs not")
    want = gang.arrays("dense_acc1")
    for k, v in gang.arrays("dense_acc1_remat").items():
        np.testing.assert_allclose(v, want[k], err_msg=k, **TOL)


def test_each_rank_holds_half_of_every_embed_leaf_and_its_moments(gang):
    out = gang.result()
    for name, model, _, _ in RUNS:
        axes = flat(ttf.param_logical_axes(torch_cfg(model)))
        shapes = flat(ttf.param_shapes(torch_cfg(model)))
        for rank in range(2):
            got = out[rank][name]
            assert got["dims"] == {k: (ax.index("embed") if "embed" in ax
                                       else None) for k, ax in axes.items()}
            for key, shape in shapes.items():
                want = list(shape)
                if "embed" in axes[key]:
                    want[axes[key].index("embed")] //= 2
                for tree in ("params", "mu", "nu"):
                    assert got["blocks"][tree + key] == want, (name, rank,
                                                               tree + key)
    # The norm scales are replicated, everything else has an embed axis.
    assert sorted(k for k, d in out[0]["dense_acc1"]["dims"].items()
                  if d is None) == ["/final_ln", "/layers/ln1", "/layers/ln2"]


def test_checkpoint_saved_at_world_2_restores_at_world_1(gang):
    gang.result()
    name = "dense_acc1"
    params, batches, model, acc, lr = gang.runs[name]
    tcfg = ttrainer.TrainConfig(**TRAIN, learning_rate=lr)
    target = ttrainer.init_state(torch_cfg(model), tcfg,
                                 torch.Generator().manual_seed(3))
    state = tckpt.CheckpointManager(str(gang.dir / f"ckpt-{name}")).restore(
        None, target)
    assert state.step == state.opt_state["count"] == STEPS
    want = gang.arrays(name)
    trees = {"params": state.params, "mu": state.opt_state["mu"],
             "nu": state.opt_state["nu"]}
    for tree, t in trees.items():
        for k, v in flat(t).items():
            np.testing.assert_array_equal(v.detach().numpy(), want[tree + k])
    # and trains on from there on one device
    step = ttrainer.make_train_step(torch_cfg(model), tcfg)
    _, m = step(state, torch.from_numpy(batches[0].copy()).long())
    assert np.isfinite(float(m["loss"]))


def test_checkpoint_saved_at_world_1_restores_at_world_2(gang):
    out = gang.result()
    want = gang.world1_state
    arrays = gang.arrays("restore_world1")
    trees = {"params": want.params, "mu": want.opt_state["mu"],
             "nu": want.opt_state["nu"]}
    for tree, t in trees.items():
        for k, v in flat(t).items():
            np.testing.assert_array_equal(arrays[tree + k],
                                          v.detach().numpy())
    assert [o["restore_world1"]["step"] for o in out] == [2, 2]
    assert [o["restore_world1"]["count"] for o in out] == [2, 2]


def _json_lines(text: str) -> list:
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def test_trainer_main_gang_prints_the_single_process_lines(tmp_path, capsys):
    """`python -m ...cmd.trainer` as two processes with the launcher's gang
    env, on synthetic data and on a token shard at grad_accum 1 and 2
    (rank r reads its rows of every microbatch of the global batch): the
    primary prints the step and final lines one process prints for the
    same global batch (losses equal to f32 rounding), the other rank
    prints none, and one checkpoint is written."""
    shard = str(tmp_path / "tokens.bin")
    tdata.write_token_file(shard, np.random.default_rng(2).integers(
        0, DIMS["vocab_size"], 17 * 48))
    argv = TINY + ["--batch-size", "4", "--steps", "10"]
    sources = {"synthetic": [], "shard": ["--data-file", shard],
               "shard_acc2": ["--data-file", shard, "--grad-accum", "2"]}
    gangs = {src: spawn(lambda r, extra=extra: [
        sys.executable, "-m", "k8s_gpu_workload_enhancer_tpu_torch.cmd.trainer",
        *argv, *extra, "--checkpoint-dir", str(tmp_path / src)],
        2, free_port()) for src, extra in sources.items()}
    want = {}
    for src, extra in sources.items():
        assert cli.main(argv + extra) == 0
        want[src] = _json_lines(capsys.readouterr().out)
    assert want["shard"][0]["loss"] != want["synthetic"][0]["loss"]
    assert want["shard_acc2"][0]["loss"] != want["shard"][0]["loss"]
    for src, procs in gangs.items():
        (rc0, out0, err0), (rc1, out1, err1) = finish(procs)
        assert rc0 == 0 and rc1 == 0, (err0[-3000:], err1[-3000:])
        got = _json_lines(out0)
        assert _json_lines(out1) == []
        assert [set(x) for x in got] == [set(x) for x in want[src]]
        assert got[0]["step"] == want[src][0]["step"] == 10
        np.testing.assert_allclose(got[0]["loss"], want[src][0]["loss"],
                                   rtol=1e-5, err_msg=src)
        assert got[1]["final"] is True
        assert got[1]["steps"] == want[src][1]["steps"]
        assert sorted(os.listdir(tmp_path / src)) == ["ckpt-10.pt"]


@pytest.mark.parametrize("acc", [1, 2])
def test_a_process_reads_its_block_of_every_microbatch(tmp_path, acc):
    """The token pipeline split over two processes gives each its block of
    the rows of every microbatch one process reads for the same global
    batch (the rows `Fsdp.rank_rows` takes), from any step."""
    shard = str(tmp_path / "tokens.bin")
    tdata.write_token_file(shard, np.random.default_rng(3).integers(
        0, DIMS["vocab_size"], 17 * 40))
    kw = dict(path=shard, seq_len=16, seed=5, grad_accum=acc)

    def take(n, **more):
        it = tdata.TokenDataset(tdata.DataConfig(**kw, **more)).batches(3)
        return [next(it) for _ in range(n)]
    whole = take(4, batch_size=8)
    halves = [take(4, batch_size=4, process_id=r, num_processes=2)
              for r in range(2)]
    axis = 0 if acc == 1 else 1
    for step, want in enumerate(whole):
        for r in range(2):
            np.testing.assert_array_equal(
                halves[r][step], np.split(want, 2, axis=axis)[r])


def test_sigterm_drains_both_ranks_after_one_agreed_step(tmp_path):
    """SIGTERM to rank 1, then to rank 0: both finish the same step (each
    step ends in a MAX all-reduce of the drain flag, so the rank that
    saw its signal later drains with the other), the primary saves it,
    writes one marker and prints the drained line."""
    ckpt = tmp_path / "ckpt"
    argv = TINY + ["--batch-size", "4", "--steps", "100000",
                   "--checkpoint-dir", str(ckpt), "--checkpoint-every", "2"]
    procs = spawn(lambda r: [sys.executable, "-m",
                             "k8s_gpu_workload_enhancer_tpu_torch.cmd.trainer",
                             *argv], 2, free_port())
    try:
        deadline = time.monotonic() + GANG_TIMEOUT_S
        while not (ckpt / "ckpt-2.pt").exists():
            if time.monotonic() > deadline or any(
                    p.poll() is not None for p in procs):
                break
            time.sleep(0.05)
        procs[1].send_signal(signal.SIGTERM)
        procs[0].send_signal(signal.SIGTERM)
    finally:
        results = finish(procs)
    (rc0, out0, err0), (rc1, out1, err1) = results
    assert rc0 == 0 and rc1 == 0, (err0[-3000:], err1[-3000:])
    drained = _json_lines(out0)[-1]
    assert drained["drained"] is True and drained["step"] >= 2
    assert _json_lines(out1) == []
    marker = tckpt.read_drain_marker(str(ckpt))
    assert marker["step"] == drained["step"]
    assert f"ckpt-{drained['step']}.pt" in os.listdir(ckpt)
    assert [f for f in os.listdir(ckpt) if f.startswith("drain")] == [
        tckpt.DRAIN_MARKER]


def test_moe_routes_dense_on_a_mesh_of_two(monkeypatch):
    """The ragged dispatch runs only on a mesh of one device (the JAX
    gate, `mesh.size == 1`); on two the dense route runs, and the aux
    loss's fractions go through the mesh's `global_means`."""
    cfg = torch_cfg(MOE)
    params = ttrainer.tree_map(lambda t: t, ttf.init_params(
        torch.Generator().manual_seed(0), cfg))
    lp = ttf.layer_params(params, 0)
    x = torch.randn(2, 4, DIMS["d_model"],
                    generator=torch.Generator().manual_seed(1))
    seen = []

    class Mesh:
        """A dp mesh of `world` ranks, as far as the MoE FFN asks: its
        size (the whole mesh's, which the route gate reads), no ep or tp
        axis."""
        ep = 1

        def __init__(self, world):
            self.world = self.size = world

        def global_means(self, a, b):
            seen.append(self.world)
            return a, b

        def tp_copy(self, x):
            return x
        tp_sum = tp_copy

    calls = []
    real = ttf.ragged_dispatch
    monkeypatch.setattr(ttf, "ragged_dispatch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    y1, aux1 = ttf._moe_ffn(x, lp, cfg, Mesh(1))
    assert calls == [1]
    y2, aux2 = ttf._moe_ffn(x, lp, cfg, Mesh(2))
    assert calls == [1] and seen == [1, 2]
    y0, aux0 = ttf._moe_ffn(
        x, lp, torch_cfg(dict(MOE, moe_ragged_dispatch=False)))
    torch.testing.assert_close(y2, y0)
    torch.testing.assert_close(aux2, aux0)
