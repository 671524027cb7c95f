"""The port's collective bench (cmd/icibench.py) against the JAX package's
cmd/icibench.py.

- One process (a group of one on localhost, gloo): `main` prints one JSON
  line with exactly the JAX bench's keys (the JAX main run here on the
  harness's virtual devices), devices and axis size 1, and 0.0 GB/s at
  one rank, as the JAX bench reports one chip.
- A gang of two processes from the launcher env (COORDINATOR_ADDRESS,
  NUM_PROCESSES, PROCESS_ID; gloo with --device cpu): only rank 0 prints,
  n = 2, positive ms and bandwidth; --axis names a live axis (dp) or one
  of size 1 (tp), which folds both ranks onto one group.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest

from k8s_gpu_workload_enhancer_tpu.cmd import icibench as jbench
from k8s_gpu_workload_enhancer_tpu_torch.cmd import icibench

ROOT = pathlib.Path(__file__).resolve().parent.parent
GANG_ENV = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
            "KTWE_MESH_AXES", "KTWE_STRATEGY")


@pytest.fixture(autouse=True)
def no_gang_env(monkeypatch):
    for k in GANG_ENV:
        monkeypatch.delenv(k, raising=False)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_single_rank_prints_the_jax_keys(capsys):
    assert icibench.main(["--mb", "1", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jbench.main(["--mb", "1"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(want)
    assert got["devices"] == got["axis_size"] == 1
    assert got["payload_mb_per_chip"] == 1
    for op in ("allreduce", "allgather", "ppermute"):
        assert got[f"{op}_ms"] > 0.0
        assert got[f"{op}_gbps_per_chip"] == 0.0


@pytest.mark.parametrize("axis", ["dp", "tp"])
def test_gang_of_two_prints_once_with_two_ranks(axis):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT),
               COORDINATOR_ADDRESS=f"localhost:{port}", NUM_PROCESSES="2",
               KTWE_STRATEGY="FSDP")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "k8s_gpu_workload_enhancer_tpu_torch.cmd."
         "icibench", "--mb", "1", "--device", "cpu", "--axis", axis],
        env=dict(env, PROCESS_ID=str(r)), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert outs[1].strip() == ""
    got = json.loads(outs[0].strip().splitlines()[-1])
    assert got["devices"] == got["axis_size"] == 2
    for op in ("allreduce", "allgather", "ppermute"):
        assert got[f"{op}_ms"] > 0.0
        assert got[f"{op}_gbps_per_chip"] > 0.0
