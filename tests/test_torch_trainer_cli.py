"""The port's trainer main on the CPU: its JSON step and final lines, the
SIGTERM drain, resuming from a checkpoint, training from a token shard,
and the flags it refuses (exit code 2) instead of ignoring."""

import json
import os
import signal

import pytest

from k8s_gpu_workload_enhancer_tpu_torch.cmd import trainer as cli
from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels

import torch_parity  # noqa: F401  (one intra-op thread a process)

TINY = ["--device", "cpu", "--batch-size", "2", "--seq-len", "32",
        "--d-model", "64", "--n-layers", "2", "--n-heads", "2", "--d-ff",
        "128", "--vocab-size", "256"]


def _lines(out: str):
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def test_trainer_main_prints_step_and_final_lines(capsys):
    kernels.reset_launches()
    seen = []
    rc = cli.main(TINY + ["--steps", "10"],
                  callback=lambda i, m: seen.append((i, float(m["loss"]),
                                                     float(m["grad_norm"]))))
    assert rc == 0
    lines = _lines(capsys.readouterr().out)
    assert [set(x) for x in lines] == [
        {"step", "loss", "tokens_per_s", "mfu_pct"},
        {"final", "steps", "avg_step_s", "tokens_per_s", "achieved_tflops",
         "mfu_pct"}]
    step, final = lines
    assert step["step"] == 10 and step["loss"] == seen[-1][1]
    assert final["final"] is True and final["steps"] == 9   # warm-up skipped
    assert final["tokens_per_s"] > 0 and 0 < final["mfu_pct"] < 100
    assert [i for i, _, _ in seen] == list(range(10))
    assert all(g > 0 for _, _, g in seen)
    # Synthetic data is uniform over the vocab: the loss starts near ln V.
    assert abs(seen[0][1] - 5.545) < 0.5
    assert sum(kernels.launches.values()) == 0     # CPU: plain versions only


def test_trainer_main_grad_accum_and_remat(capsys):
    rc = cli.main(TINY + ["--steps", "3", "--batch-size", "4",
                          "--grad-accum", "2", "--remat"])
    assert rc == 0
    (final,) = _lines(capsys.readouterr().out)
    assert final["final"] is True and final["steps"] == 2


def test_trainer_main_is_deterministic_from_its_seed(capsys):
    losses = {}
    for seed in (0, 0, 1):
        got = []
        cli.main(TINY + ["--steps", "2", "--seed", str(seed)],
                 callback=lambda i, m: got.append(float(m["loss"])))
        losses.setdefault(seed, []).append(got)
    assert losses[0][0] == losses[0][1]
    assert losses[1][0] != losses[0][0]
    capsys.readouterr()


def test_sigterm_drains_after_the_step_in_flight(capsys):
    def on_step(i, metrics):
        if i == 1:
            os.kill(os.getpid(), signal.SIGTERM)
    before = signal.getsignal(signal.SIGTERM)
    rc = cli.main(TINY + ["--steps", "50"], callback=on_step)
    assert rc == 0
    lines = _lines(capsys.readouterr().out)
    assert lines[-1]["drained"] is True and lines[-1]["step"] == 2
    assert signal.getsignal(signal.SIGTERM) == before


@pytest.mark.parametrize("flags", [
    ["--pipeline-microbatches", "2"],
])
def test_unported_flags_exit_2(flags, capsys):
    """--pipeline-microbatches is ported; without a pp axis it fails as the
    JAX trainer does, with its message (tests/test_torch_gpipe.py trains
    it on a pp gang)."""
    with pytest.raises(SystemExit, match=r"--pipeline-microbatches needs a "
                       r"pp>1 mesh axis \(got meshAxes \[single-device\]\)"):
        cli.main(TINY + ["--steps", "1"] + flags)
    assert "ROADMAP" not in capsys.readouterr().err


def test_trainer_main_trains_moe_and_prints_aux(capsys):
    """--n-experts 4 trains the MoE model (the JAX trainer's config: top-1
    through the ragged dispatch) and its final line carries the last
    step's load-balance aux; a dense run's lines carry none."""
    seen = []
    rc = cli.main(TINY + ["--steps", "2", "--n-experts", "4"],
                  callback=lambda i, m: seen.append(
                      (float(m["loss"]), float(m["nll"]), float(m["aux"]),
                       float(m["grad_norm"]))))
    assert rc == 0
    (final,) = _lines(capsys.readouterr().out)
    assert final["final"] is True and final["steps"] == 1
    assert final["aux"] == seen[-1][2]
    for loss, nll, aux, gnorm in seen:
        # Switch aux is E * sum(frac_tokens * frac_probs): 1 when balanced.
        assert 0.5 < aux < 4.0 and gnorm > 0
        assert loss == pytest.approx(nll + 0.01 * aux, rel=1e-6)
    cli.main(TINY + ["--steps", "1"])
    assert "aux" not in _lines(capsys.readouterr().out)[-1]


def test_main_resumes_and_prints_resumed_from_step(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    first, second = [], []
    assert cli.main(TINY + ["--steps", "2", "--checkpoint-dir", ckpt],
                    callback=lambda i, m: first.append(i)) == 0
    assert "resumed" not in capsys.readouterr().out
    assert cli.main(TINY + ["--steps", "4", "--checkpoint-dir", ckpt,
                            "--resume"],
                    callback=lambda i, m: second.append(i)) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out.splitlines()
    assert (first, second) == ([0, 1], [2, 3])
    assert _lines(out)[-1]["final"] is True
    assert sorted(os.listdir(ckpt)) == ["ckpt-2.pt", "ckpt-4.pt"]


def test_resume_without_a_directory_trains_from_step_0(capsys):
    """As in the JAX trainer, --resume alone has nothing to restore."""
    seen = []
    assert cli.main(TINY + ["--steps", "2", "--resume"],
                    callback=lambda i, m: seen.append(i)) == 0
    assert seen == [0, 1]
    assert "resumed" not in capsys.readouterr().out


def test_main_trains_from_a_token_shard(tmp_path, capsys):
    """--data-file: the first step's loss is the model loss of the seeded
    init on the shard's first batch (not on synthetic data)."""
    import numpy as np
    import torch
    from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as tf
    from k8s_gpu_workload_enhancer_tpu_torch.train import data, trainer
    path = str(tmp_path / "tokens.bin")
    data.write_token_file(path, np.random.default_rng(2).integers(
        0, 256, 33 * 8))
    losses = {}
    for source in (["--data-file", path], []):
        got = []
        assert cli.main(TINY + ["--steps", "2"] + source,
                        callback=lambda i, m: got.append(float(m["loss"]))
                        ) == 0
        losses[bool(source)] = got
    cfg = tf.TransformerConfig(vocab_size=256, d_model=64, n_layers=2,
                               n_heads=2, n_kv_heads=2, d_ff=128, max_seq=32,
                               dtype=torch.float32)
    tcfg = trainer.TrainConfig(batch_size=2, seq_len=32)
    state = trainer.init_state(cfg, tcfg, torch.Generator().manual_seed(0))
    batch = next(data.TokenDataset(data.DataConfig(
        path=path, batch_size=2, seq_len=32)).batches(0))
    with torch.no_grad():
        want, _ = tf.loss_fn(state.params, torch.from_numpy(batch).long(),
                             cfg)
    assert losses[True][0] == float(want)
    assert losses[True] != losses[False]
    capsys.readouterr()


def test_trainer_flags_match_the_jax_trainer():
    from k8s_gpu_workload_enhancer_tpu.cmd import trainer as jcli
    port = {a.dest: a.default for a in cli.build_parser()._actions}
    ref = {a.dest: a.default for a in jcli.build_parser()._actions}
    assert set(port) - set(ref) == {"device", "seed"}
    assert {k: port[k] for k in ref} == ref
    assert port["device"] == "cuda"
