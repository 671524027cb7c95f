"""The port's trainer main on the CPU: its JSON step and final lines, the
SIGTERM drain, and the flags it refuses (exit code 2) instead of
ignoring."""

import json
import os
import signal

import pytest

from k8s_gpu_workload_enhancer_tpu_torch.cmd import trainer as cli
from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels

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
    ["--checkpoint-dir", "ckpt"],
    ["--resume"],
    ["--data-file", "tokens.bin"],
    ["--pipeline-microbatches", "2"],
    ["--n-experts", "4"],
])
def test_unported_flags_exit_2(flags, capsys):
    assert cli.main(TINY + ["--steps", "1"] + flags) == cli.EXIT_REFUSED
    err = capsys.readouterr().err
    assert "not ported yet" in err and "ROADMAP A1" in err


def test_trainer_flags_match_the_jax_trainer():
    from k8s_gpu_workload_enhancer_tpu.cmd import trainer as jcli
    port = {a.dest: a.default for a in cli.build_parser()._actions}
    ref = {a.dest: a.default for a in jcli.build_parser()._actions}
    assert set(port) - set(ref) == {"device", "seed"}
    assert {k: port[k] for k in ref} == ref
    assert port["device"] == "cuda"
