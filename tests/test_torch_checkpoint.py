"""The port's checkpoints (train/checkpoint.py) and the JAX converter
(scripts/convert_jax_checkpoint.py), held to the JAX package.

- Converter: the JAX trainer (`init_state` + `make_train_step` on one
  device) trains 2 steps on a token shard and saves through its orbax
  `CheckpointManager`; the converter writes the port's file; every leaf
  is the JAX leaf exactly; the port's serve loader and engine give the
  greedy tokens of the JAX `decode.generate` on those params exactly (f32),
  the prefill logits within 1e-4 (the model parity tolerance), and one more
  train step from the converted state matches one JAX step on the same
  shard batch within 1e-4 (`test_train_steps_match_jax`'s TOL) in loss,
  grad norm, params and both Adam moments, with the same count.
- Manager: a save/restore round trip resumes bit for bit, a background save
  holds the state of the save (not one the next step tore), old files go
  past max_to_keep, unfinished files are never a step, an empty directory
  is FileNotFoundError, KTWE_RESUME=1 resumes the trainer main.
- Drain: the marker the port writes is the JAX package's, read by its own
  `read_drain_marker`, and the other way round.
"""

import importlib.util
import json
import os
import pathlib
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.models import decode as jdec
from k8s_gpu_workload_enhancer_tpu.parallel import mesh as jmesh
from k8s_gpu_workload_enhancer_tpu.train import checkpoint as jckpt
from k8s_gpu_workload_enhancer_tpu.train import data as jdata
from k8s_gpu_workload_enhancer_tpu.train import trainer as jtrainer
from k8s_gpu_workload_enhancer_tpu_torch.cmd import serve as tserve
from k8s_gpu_workload_enhancer_tpu_torch.cmd import trainer as tcli
from k8s_gpu_workload_enhancer_tpu_torch.models import decode as tdec
from k8s_gpu_workload_enhancer_tpu_torch.models import serving as tsrv
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
from k8s_gpu_workload_enhancer_tpu_torch.train import checkpoint as tckpt
from k8s_gpu_workload_enhancer_tpu_torch.train import data as tdata
from k8s_gpu_workload_enhancer_tpu_torch.train import trainer as ttrainer

import torch_parity as tp

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-4, rtol=1e-4)
SEQ = tp.TRAIN_DIMS["max_seq"]
TC = dict(learning_rate=1e-2, warmup_steps=1, total_steps=5, batch_size=4,
          seq_len=SEQ)
DIM_FLAGS = ["--vocab-size", str(tp.TRAIN_DIMS["vocab_size"]),
             "--d-model", str(tp.TRAIN_DIMS["d_model"]),
             "--n-layers", str(tp.TRAIN_DIMS["n_layers"]),
             "--n-heads", str(tp.TRAIN_DIMS["n_heads"]),
             "--d-ff", str(tp.TRAIN_DIMS["d_ff"]), "--max-seq", str(SEQ)]


def _converter():
    spec = importlib.util.spec_from_file_location(
        "convert_jax_checkpoint", ROOT / "scripts" / "convert_jax_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shard(path, vocab, windows=24, seed=4):
    jdata.write_token_file(path, np.random.default_rng(seed).integers(
        0, vocab, windows * (SEQ + 1)))
    return path


def _jax_batches(path, start):
    return jdata.TokenDataset(jdata.DataConfig(
        path=path, batch_size=TC["batch_size"], seq_len=SEQ)).batches(start)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """Two JAX train steps on a shard, saved by orbax and converted."""
    tmp = tmp_path_factory.mktemp("convert")
    shard = _shard(str(tmp / "tokens.bin"), tp.TRAIN_DIMS["vocab_size"])
    jcfg = tp.train_jax_cfg()
    mesh = jmesh.single_device_mesh()
    state = jtrainer.init_state(jcfg, jtrainer.TrainConfig(**TC), mesh)
    step = jtrainer.make_train_step(jcfg, jtrainer.TrainConfig(**TC), mesh)
    batches = _jax_batches(shard, 0)
    for _ in range(2):
        state, _ = step(state, jnp.asarray(next(batches)))
    jdir, tdir = str(tmp / "jax"), str(tmp / "torch")
    mgr = jckpt.CheckpointManager(jdir)
    mgr.save(2, state, wait=True)
    mgr.close()
    host = jax.tree.map(np.array, state)
    assert _converter().main(["--jax-dir", jdir, "--out-dir", tdir]
                             + DIM_FLAGS) == 0
    return dict(host=host, jdir=jdir, tdir=tdir, shard=shard, jcfg=jcfg,
                mesh=mesh, step=step)


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want),
                                  err_msg=path)


def _assert_tree_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], f"{path}/{k}")
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=path, **TOL)


def test_converter_copies_every_leaf(converted):
    host = converted["host"]
    data = torch.load(os.path.join(converted["tdir"], "ckpt-2.pt"),
                      weights_only=True)
    adam = host.opt_state[1][0]
    assert data["step"] == 2 and data["opt_state"]["count"] == 2
    assert int(adam.count) == int(host.opt_state[1][2].count) == 2
    _assert_tree_equal(data["params"], host.params)
    _assert_tree_equal(data["opt_state"]["mu"], adam.mu)
    _assert_tree_equal(data["opt_state"]["nu"], adam.nu)
    assert all(t.dtype == torch.float32 for t in
               ttrainer.tree_leaves(data["params"]))


def test_converter_refuses_disagreeing_counts(converted):
    conv = _converter()
    host = converted["host"]
    adam, empty, sched = host.opt_state[1]
    bad = host.replace(opt_state=(host.opt_state[0], (
        adam, empty, sched._replace(count=np.int32(7)))))
    with pytest.raises(SystemExit, match="counts disagree"):
        conv.to_port_state(bad, tp.train_torch_cfg())


def test_converter_carries_a_jax_moe_checkpoint(tmp_path):
    """A JAX MoE TrainState (the trainer's --n-experts 4: router and expert
    banks) after one step, saved by orbax, converts with --n-experts 4:
    every param and Adam moment is the JAX leaf exactly, and the port
    resumes it into an MoE TrainState of the same shapes."""
    import dataclasses
    jcfg = dataclasses.replace(tp.train_jax_cfg(), n_experts=4)
    tc = jtrainer.TrainConfig(**TC)
    mesh = jmesh.single_device_mesh()
    state = jtrainer.init_state(jcfg, tc, mesh)
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (TC["batch_size"], SEQ + 1)).astype(np.int32)
    state, _ = jtrainer.make_train_step(jcfg, tc, mesh)(state,
                                                        jnp.asarray(toks))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    mgr = jckpt.CheckpointManager(jdir)
    mgr.save(1, state, wait=True)
    mgr.close()
    host = jax.tree.map(np.array, state)
    assert _converter().main(["--jax-dir", jdir, "--out-dir", tdir,
                              "--n-experts", "4"] + DIM_FLAGS) == 0
    data = torch.load(os.path.join(tdir, "ckpt-1.pt"), weights_only=True)
    adam = host.opt_state[1][0]
    assert data["params"]["layers"]["router"].shape == (2, 256, 4)
    _assert_tree_equal(data["params"], host.params)
    _assert_tree_equal(data["opt_state"]["mu"], adam.mu)
    _assert_tree_equal(data["opt_state"]["nu"], adam.nu)
    tcfg = dataclasses.replace(tp.train_torch_cfg(), n_experts=4)
    target = ttrainer.init_state(tcfg, ttrainer.TrainConfig(**TC),
                                 torch.Generator().manual_seed(0))
    got = tckpt.CheckpointManager(tdir).restore(None, target)
    assert got.step == 1 and got.opt_state["count"] == 1
    _assert_tree_equal(got.params, host.params)


def test_converted_checkpoint_serves_jax_greedy_tokens(converted):
    """The serve loader on the converted file, then the engine: greedy
    tokens equal the JAX decode.generate on the JAX params, exactly."""
    cfg = tp.train_torch_cfg()
    load = tserve.make_params_loader(cfg, converted["tdir"], False,
                                     torch.device("cpu"))
    params, step = load()
    assert step == 2
    eng = tsrv.ContinuousBatchEngine(params, cfg, num_slots=2,
                                     prefill_len=16, decode_chunk=4,
                                     device="cpu")
    jparams = jax.tree.map(jnp.asarray, converted["host"].params)
    for prompt, n in (([3, 17, 29, 5], 12), (list(range(40, 60)), 10)):
        want = np.asarray(jdec.generate(
            jparams, jnp.asarray([prompt], jnp.int32), n,
            converted["jcfg"], max_seq=SEQ))[0, len(prompt):].tolist()
        rid = eng.submit(prompt, n)
        eng.run()
        assert eng.result(rid).tokens == want


def test_converted_prefill_logits_match_jax(converted):
    cfg = tp.train_torch_cfg()
    params, _ = tserve.make_params_loader(cfg, converted["tdir"], False,
                                          torch.device("cpu"))()
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 24))
    got, _ = tdec.forward_cached(params, torch.as_tensor(prompt),
                                 tdec.init_cache(cfg, 2), 0, cfg)
    jcfg = converted["jcfg"]
    want, _ = jdec.forward_cached(
        jax.tree.map(jnp.asarray, converted["host"].params),
        jnp.asarray(prompt, jnp.int32), jdec.init_cache(jcfg, 2, SEQ), 0,
        jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_converted_checkpoint_trains_one_step_like_jax(converted):
    """Step 3 from the converted state (the port) and from the orbax state
    (JAX) on the shard's step-2 batch."""
    jcfg, mesh = converted["jcfg"], converted["mesh"]
    jtarget = jtrainer.init_state(jcfg, jtrainer.TrainConfig(**TC), mesh)
    mgr = jckpt.CheckpointManager(converted["jdir"])
    jstate = mgr.restore(None, jtarget)
    mgr.close()
    jstate, jm = converted["step"](
        jstate, jnp.asarray(next(_jax_batches(converted["shard"], 2))))
    cfg = tp.train_torch_cfg()
    tcfg = ttrainer.TrainConfig(**TC)
    target = ttrainer.init_state(cfg, tcfg, torch.Generator().manual_seed(1))
    state = tckpt.CheckpointManager(converted["tdir"]).restore(None, target)
    assert state.step == 2 and state.opt_state["count"] == 2
    batch = next(tdata.make_input_pipeline(tdata.DataConfig(
        path=converted["shard"], batch_size=TC["batch_size"], seq_len=SEQ),
        start_step=2, device="cpu"))
    state, tm = ttrainer.make_train_step(cfg, tcfg)(state, batch)
    for key in ("loss", "nll", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   err_msg=key, **TOL)
    assert state.step == int(jstate.step) == 3
    adam = jstate.opt_state[1][0]
    assert state.opt_state["count"] == int(adam.count) == 3
    _assert_tree_close(state.params, jstate.params, "params")
    _assert_tree_close(state.opt_state["mu"], adam.mu, "mu")
    _assert_tree_close(state.opt_state["nu"], adam.nu, "nu")
    assert sum(kernels.launches.values()) == 0


# ---------------------------------------------------------------------------
# The manager (port only, tiny dims)
# ---------------------------------------------------------------------------

TINY = ttf.TransformerConfig(vocab_size=256, d_model=64, n_layers=2,
                             n_heads=2, n_kv_heads=2, d_ff=128, max_seq=32,
                             dtype=torch.float32)
TINY_TC = ttrainer.TrainConfig(batch_size=2, seq_len=32, warmup_steps=1,
                               learning_rate=1e-2)


@pytest.fixture(scope="module")
def tiny_shard(tmp_path_factory):
    return _shard(str(tmp_path_factory.mktemp("tiny") / "tokens.bin"), 256)


def _fresh(seed=0):
    return ttrainer.init_state(TINY, TINY_TC,
                               torch.Generator().manual_seed(seed))


def _batches(shard, start):
    return tdata.make_input_pipeline(tdata.DataConfig(
        path=shard, batch_size=2, seq_len=32), start_step=start,
        device="cpu")


def _host_tree(state):
    return {"params": ttrainer.tree_map(lambda t: t.detach().clone(),
                                        state.params),
            "mu": ttrainer.tree_map(torch.clone, state.opt_state["mu"]),
            "nu": ttrainer.tree_map(torch.clone, state.opt_state["nu"]),
            "count": state.opt_state["count"], "step": state.step}


def _assert_states_equal(a, b):
    assert a["count"] == b["count"] and a["step"] == b["step"]
    for key in ("params", "mu", "nu"):
        for x, y in zip(ttrainer.tree_leaves(a[key]),
                        ttrainer.tree_leaves(b[key])):
            assert torch.equal(x, y), key


def test_save_restore_resume_is_bit_for_bit(tiny_shard, tmp_path):
    step = ttrainer.make_train_step(TINY, TINY_TC)
    straight, it = _fresh(), _batches(tiny_shard, 0)
    for _ in range(3):
        straight, m_straight = step(straight, next(it))
    part, it = _fresh(), _batches(tiny_shard, 0)
    for _ in range(2):
        part, _ = step(part, next(it))
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(part.step, part, wait=True)
    resumed = mgr.restore(None, _fresh(seed=9))
    assert all(p.requires_grad and p.is_leaf
               for p in ttrainer.tree_leaves(resumed.params))
    resumed, m_resumed = step(resumed, next(_batches(tiny_shard, 2)))
    for key in ("loss", "nll", "grad_norm"):
        assert float(m_resumed[key]) == float(m_straight[key]), key
    _assert_states_equal(_host_tree(resumed), _host_tree(straight))


def test_background_save_holds_the_state_of_the_save(tiny_shard, tmp_path):
    step = ttrainer.make_train_step(TINY, TINY_TC)
    state, it = _fresh(), _batches(tiny_shard, 0)
    state, _ = step(state, next(it))
    want = _host_tree(state)
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, state, wait=False)
    state, _ = step(state, next(it))        # updates params/moments in place
    mgr.close()
    got = mgr.restore(1, _fresh(seed=3))
    _assert_states_equal(_host_tree(got), want)
    assert not torch.equal(state.params["embed"], got.params["embed"])


def test_max_to_keep_and_unfinished_files(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    state = _fresh()
    for s in range(1, 5):
        state.step = s
        mgr.save(s, state, wait=s % 2 == 0)
    mgr.close()
    assert sorted(os.listdir(tmp_path)) == ["ckpt-3.pt", "ckpt-4.pt"]
    (tmp_path / "ckpt-9.pt.tmp").write_bytes(b"half written")
    (tmp_path / "ckpt-x.pt").write_bytes(b"")
    assert mgr.latest_step() == 4
    assert mgr.restore(None, _fresh()).step == 4
    params, s = mgr.load_params()
    assert s == 4 and set(params) == set(state.params)
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in ttrainer.tree_leaves(params))


def test_empty_directory_and_mismatched_trees(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path / "none"))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(None, _fresh())
    with pytest.raises(FileNotFoundError):
        mgr.load_params()
    mgr.save(1, _fresh(), wait=True)
    other = ttrainer.init_state(
        ttf.TransformerConfig(vocab_size=256, d_model=32, n_layers=2,
                              n_heads=2, n_kv_heads=2, d_ff=64, max_seq=32,
                              dtype=torch.float32),
        TINY_TC, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, other)


def test_restore_takes_the_targets_dtypes(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path))
    state = _fresh()
    mgr.save(0, state, wait=True)
    target = _fresh(seed=1)
    target.opt_state["mu"] = ttrainer.tree_map(lambda t: t.double(),
                                               target.opt_state["mu"])
    got = mgr.restore(0, target)
    assert all(t.dtype == torch.float64
               for t in ttrainer.tree_leaves(got.opt_state["mu"]))
    assert torch.equal(got.opt_state["mu"]["embed"].float(),
                       state.opt_state["mu"]["embed"])


CLI = ["--device", "cpu", "--batch-size", "2", "--seq-len", "32",
       "--d-model", "64", "--n-layers", "2", "--n-heads", "2", "--d-ff",
       "128", "--vocab-size", "256"]


def _lines(out):
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def test_ktwe_resume_env_resumes_the_trainer_main(tmp_path, monkeypatch,
                                                  capsys):
    ckpt = str(tmp_path / "ckpt")
    assert tcli.main(CLI + ["--steps", "2", "--checkpoint-dir", ckpt]) == 0
    monkeypatch.setenv("KTWE_RESUME", "1")
    seen = []
    assert tcli.main(CLI + ["--steps", "3", "--checkpoint-dir", ckpt],
                     callback=lambda i, m: seen.append(i)) == 0
    assert "resumed from step 2" in capsys.readouterr().out
    assert seen == [2]
    assert tckpt.CheckpointManager(ckpt).latest_step() == 3


def test_periodic_saves_in_the_background(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    assert tcli.main(CLI + ["--steps", "5", "--checkpoint-dir", ckpt,
                            "--checkpoint-every", "2"]) == 0
    assert sorted(os.listdir(ckpt)) == ["ckpt-2.pt", "ckpt-4.pt",
                                        "ckpt-5.pt"]
    capsys.readouterr()


def test_drained_trainer_leaves_a_checkpoint_and_the_jax_marker(tmp_path,
                                                                 capsys):
    ckpt = str(tmp_path / "ckpt")

    def on_step(i, metrics):
        if i == 2:
            os.kill(os.getpid(), signal.SIGTERM)
    assert tcli.main(CLI + ["--steps", "50", "--checkpoint-dir", ckpt],
                     callback=on_step) == 0
    drained = _lines(capsys.readouterr().out)[-1]
    assert drained["drained"] is True and drained["step"] == 3
    marker = jckpt.read_drain_marker(ckpt)
    assert marker["step"] == 3 and isinstance(marker["drained_at"], float)
    assert tckpt.CheckpointManager(ckpt).latest_step() == 3
    assert tckpt.read_drain_marker(ckpt) == marker
    assert not os.path.exists(os.path.join(ckpt, tckpt.DRAIN_MARKER + ".tmp"))
    # The other way round, and the clear helpers of both packages.
    jckpt.write_drain_marker(ckpt, 7, {"reason": "evict"})
    assert tckpt.read_drain_marker(ckpt)["step"] == 7
    assert tckpt.read_drain_marker(ckpt)["reason"] == "evict"
    tckpt.clear_drain_marker(ckpt)
    assert jckpt.read_drain_marker(ckpt) is None
    tckpt.clear_drain_marker(ckpt)
    assert tckpt.DRAIN_MARKER == jckpt.DRAIN_MARKER
