"""The PyTorch port stands alone: no module of it (and not chip_smoke.py)
imports jax or the JAX package, importing it loads no jax, its entry
points refuse device "cuda" without a card instead of carrying on on the
CPU, and its kernel wrappers take their plain versions only for CPU
tensors, launching nothing."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from k8s_gpu_workload_enhancer_tpu_torch.cmd import generate, serve
from k8s_gpu_workload_enhancer_tpu_torch.cmd import trainer as trainer_cli
from k8s_gpu_workload_enhancer_tpu_torch.models import serving
from k8s_gpu_workload_enhancer_tpu_torch.ops import (
    flash_attention, kernels, paged_attention, rms, rope)
from k8s_gpu_workload_enhancer_tpu_torch.utils.device import resolve_device

import torch_parity as tp

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "k8s_gpu_workload_enhancer_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax",
             "k8s_gpu_workload_enhancer_tpu"}


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_name(path: pathlib.Path) -> str:
    rel = path.relative_to(ROOT).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.relative_to(ROOT)} imports {name}")


def test_importing_the_port_loads_no_jax():
    modules = [_module_name(p) for p in sorted(PORT.rglob("*.py"))]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr(sorted(FORBIDDEN)) + ")\n"
            + "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    _, _, cfg, params = tp.model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.ContinuousBatchEngine(params, cfg)          # default: cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_engine(serve.build_parser().parse_args([]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main(["--d-model", "64", "--n-layers", "1", "--n-heads",
                       "2", "--d-ff", "64", "--vocab-size", "64"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer_cli.main(["--d-model", "64", "--n-layers", "1", "--n-heads",
                          "2", "--d-ff", "64", "--vocab-size", "64"])
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    kernels.reset_launches()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 16, 2, 32, generator=g)
    w = torch.randn(32, generator=g)
    c, s = torch.randn(16, 16, generator=g), torch.randn(16, 16, generator=g)
    assert torch.equal(rms.rms_norm(x, w), rms.rms_norm_plain(x, w))
    assert torch.equal(rope.rope_rotate(x, c, s),
                       rope.rope_rotate_plain(x, c, s))
    assert torch.equal(flash_attention.flash_attention(x, x, x, True, 3),
                       flash_attention.flash_attention_plain(x, x, x, True,
                                                             3))
    pages = torch.randn(5, 4, 2, 32, generator=g)
    table = torch.tensor([[1, 2], [4, 3]], dtype=torch.int32)
    pos = torch.tensor([5, 2], dtype=torch.int32)
    assert torch.equal(
        paged_attention.paged_decode_attention(x[:2, 0], pages, pages, table,
                                               pos, block_len=4),
        paged_attention.paged_decode_attention_plain(
            x[:2, 0], pages, pages, table, pos, block_len=4))
    _, _, cfg, params = tp.model()
    for kv_block_len in (0, 8):
        eng = serving.ContinuousBatchEngine(params, cfg, num_slots=2,
                                            prefill_len=32, device="cpu",
                                            kv_block_len=kv_block_len)
        rid = eng.submit([1, 2, 3], 5)
        eng.run()
        assert len(eng.result(rid).tokens) == 5
    assert sum(kernels.launches.values()) == 0
    with pytest.raises(ValueError):     # a CUDA-only entry refuses CPU input
        rms._rms_norm_cuda(x, w, 1e-6)


def test_cpu_backward_takes_the_plain_versions_and_launches_nothing():
    kernels.reset_launches()
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, 2, 32, generator=g)
    w = torch.randn(32, generator=g)
    got = rms.rms_norm_backward(x, w, x)
    want = rms.rms_norm_backward_plain(x, w, x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    o, lse = flash_attention.flash_attention(x, x, x, True, return_lse=True)
    got = flash_attention.flash_attention_backward(x, x, x, o, lse, x)
    want = flash_attention.flash_attention_backward_plain(x, x, x, o, lse, x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    xg = x.clone().requires_grad_()
    c, s = torch.randn(16, 16, generator=g), torch.randn(16, 16, generator=g)
    (dx,) = torch.autograd.grad(rope.rope_rotate(xg, c, s), (xg,), x)
    assert torch.equal(dx, rope.rope_rotate_plain(x, c, -s))
    assert sum(kernels.launches.values()) == 0
    with pytest.raises(ValueError):     # the CUDA-only wrappers refuse CPU
        flash_attention.flash_bwd_dq(x, x, x, x, lse,
                                     flash_attention.backward_delta(o, x))


def test_params_on_another_device_are_refused():
    _, _, cfg, params = tp.model()
    moved = dict(params, embed=params["embed"].to("meta"))
    with pytest.raises(ValueError, match="params live on"):
        serving.ContinuousBatchEngine(moved, cfg, device="cpu")
