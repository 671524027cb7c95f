"""The port's program-event sentinel (analysis/compilewatch.py), the
`KTWE_COMPILE_SENTINEL` contract of the JAX package's module, through its
own hook (`record`), on the CPU:

- inert unless enabled (the env var or `enable(force=True)`): nothing is
  counted, nothing raises;
- events before `mark_warm` count, events after it are violations that
  `verify` raises with the port's frames nearest the trigger;
- `reset` and `disable`; the capture and kernel-build sites report
  through the hook (a stand-in capture on the CPU);
- under `KTWE_COMPILE_SENTINEL=1` a process with a post-warm event exits
  71 at exit, and one without exits 0.
"""

import os
import subprocess
import sys
import textwrap

import pytest

from k8s_gpu_workload_enhancer_tpu_torch.analysis import compilewatch as cw

import torch_parity  # noqa: F401  (one intra-op thread a process)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    monkeypatch.delenv(cw.ENV_VAR, raising=False)
    cw.disable()
    cw.reset()
    yield
    cw.disable()
    cw.reset()


def test_inert_unless_enabled():
    assert not cw.enabled()
    cw.mark_warm("warm")
    cw.record("capture", "decode chunk", 0.01)
    assert cw.compiles_total() == 0 and cw.counts() == {}
    assert cw.post_warm_compiles() == []
    cw.verify()


def test_counts_before_warm_and_raises_after_with_the_stack():
    cw.enable(force=True)
    assert cw.enabled()
    cw.record("kernel_build", "rms", 4.2)
    cw.record("kernel_load", "rms", 4.3)
    cw.record("capture", "decode chunk", 0.25)
    assert cw.compiles_total() == 3
    assert cw.counts() == {"kernel_build": 1, "kernel_load": 1, "capture": 1}
    cw.verify()                                   # nothing after warm
    cw.mark_warm("after the census")

    def steady_state_capture():                   # a frame of this file
        cw.record("capture", "verify round", 0.5)
    steady_state_capture()
    bad = cw.post_warm_compiles()
    assert len(bad) == 1 and cw.compiles_total() == 4
    assert "capture #4 of verify round (500.0 ms)" in bad[0]
    assert "'after the census'" in bad[0]
    with pytest.raises(cw.CompileSentinelError, match="verify round"):
        cw.verify()
    cw.mark_warm("again")                         # a new mark clears
    cw.verify()
    cw.reset()
    assert cw.compiles_total() == 0 and cw.counts() == {}
    cw.disable()
    cw.record("capture", "decode chunk", 0.1)
    assert cw.compiles_total() == 0


def test_a_post_warm_kernel_build_names_the_port_frames(tmp_path,
                                                       monkeypatch):
    """A kernel library built after the warm mark (a stand-in compiler on
    the CPU, into a scratch build directory) is a violation whose stack
    summary names the port's frame that built it."""
    from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "a = sys.argv\nopen(a[a.index('-o') + 1], 'w').write('')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "kernels")
    cw.enable(force=True)
    kernels.build(["rms"])
    assert cw.counts() == {"kernel_build": 1}
    cw.verify()
    cw.mark_warm("kernels built")
    assert kernels.build(["rms"]) == {"rms": 0.0}   # built: no event
    cw.verify()
    kernels.build(["rope"])
    (bad,) = cw.post_warm_compiles()
    assert bad.startswith("kernel_build #2 of rope")
    assert "kernels.py:" in bad and "in build" in bad
    with pytest.raises(cw.CompileSentinelError, match="rope"):
        cw.verify()


def test_the_capture_and_build_sites_report_through_the_hook():
    """The two program-event sites call the one hook: the graph capture
    and the kernel library build and first load."""
    import inspect

    from k8s_gpu_workload_enhancer_tpu_torch.models import decode_graph
    from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
    assert 'compilewatch.record("capture"' in inspect.getsource(
        decode_graph.DecodeGraph._capture)
    assert 'compilewatch.record("kernel_build"' in inspect.getsource(
        kernels.build)
    assert 'compilewatch.record("kernel_load"' in inspect.getsource(
        kernels.library)


@pytest.mark.parametrize("after_warm,rc", [(True, 71), (False, 0)])
def test_exit_71_at_exit_under_the_env_var(after_warm, rc):
    code = textwrap.dedent(f"""
        from k8s_gpu_workload_enhancer_tpu_torch.analysis import compilewatch
        assert compilewatch.enabled()
        compilewatch.record("kernel_build", "rope", 3.0)
        compilewatch.mark_warm("soak")
        if {after_warm}:
            compilewatch.record("capture", "decode chunk", 0.2)
        print("total", compilewatch.compiles_total())
    """)
    env = dict(os.environ, **{cw.ENV_VAR: "1"})
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == rc, proc.stderr
    assert proc.stdout.split() == ["total", "2" if after_warm else "1"]
    assert ("[compilewatch]" in proc.stderr) == after_warm
    if after_warm:
        assert "capture #2 of decode chunk" in proc.stderr
