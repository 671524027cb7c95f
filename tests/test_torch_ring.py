"""Ring attention and the flash LSE entry point on the port, held on the CPU
to the JAX package (parallel/ring_attention.py, ops/flash_attention.py
`flash_attention_lse`).

- `flash_attention_lse`'s plain path against the JAX kernel in interpret
  mode at a flash-supported shape (1, 256, 2, 128), causal and not: O, LSE
  and the gradients for random cotangents of both outputs (f32: rtol 1e-5,
  atol 1e-6).
- `ring_attention` on a gloo gang of four ranks (tests/torch_gang.py), on
  an sp=4 mesh and on dp=2, sp=2 (two rings of two), against the JAX
  `ring_attention` on the same mesh and against dense attention: causal
  and not, MHA and GQA, the plain f32 block route and the flash route
  (`use_flash=True`: `flash_attention_lse`, its plain version here, at
  shards of 64 rows of head_dim 128); outputs within JAX's ring limits
  (rtol 2e-4, atol 2e-5), gradients within its limits for them (rtol
  5e-4, atol 2e-5).
- Causality at the shard boundaries: a perturbed last K/V position leaves
  every earlier output bit for bit as it was.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from k8s_gpu_workload_enhancer_tpu.ops import flash_attention as jflash
from k8s_gpu_workload_enhancer_tpu.ops.attention import attention_reference
from k8s_gpu_workload_enhancer_tpu.parallel import mesh as jmesh
from k8s_gpu_workload_enhancer_tpu.parallel.ring_attention import (
    ring_attention as jring)
from k8s_gpu_workload_enhancer_tpu_torch.ops import flash_attention as tflash
from k8s_gpu_workload_enhancer_tpu_torch.parallel import (
    ring_attention as tring)

import torch_gang
import torch_parity  # noqa: F401  (one intra-op thread a process)

LSE_TOL = dict(rtol=1e-5, atol=1e-6)
OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=2e-5)
# (name, causal, kv heads, flash route, head_dim, sequence a shard): the
# block route at head_dim 16, the flash route where the shard passes
# `flash_supported` (head_dim 128, 64 rows).
CASES = (("causal", True, 2, False, 16, 16),
         ("noncausal", False, 2, False, 16, 16),
         ("causal_gqa", True, 1, False, 16, 16),
         ("flash_causal", True, 2, True, 128, 64),
         ("flash_noncausal_gqa", False, 1, True, 128, 64))
MESHES = (("sp4", "sp=4", dict(sp=4)), ("dp2sp2", "dp=2,sp=2",
                                        dict(dp=2, sp=2)))
BATCH, HEADS = 2, 2


def case_inputs(kh: int, d: int, s: int, sp: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    n = s * sp

    def draw(h):
        return rng.standard_normal((BATCH, n, h, d)).astype(np.float32)
    q, k, v, do = draw(HEADS), draw(kh), draw(kh), draw(HEADS)
    return dict(q=q, k=k, v=v, do=do)


def perturbed(x: dict) -> dict:
    """The same inputs with the last position's K and V changed."""
    y = dict(x)
    for name in ("k", "v"):
        y[name] = x[name].copy()
        y[name][:, -1] += 3.0
    return y


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """One gang of four running every case on both meshes, and the
    causality case, started before the JAX references compile."""
    job_dir = tmp_path_factory.mktemp("ring")
    inputs, phases, cases = {}, [], {}
    for mesh_name, axes, sizes in MESHES:
        jobs = []
        for i, (name, causal, kh, flash, d, s) in enumerate(CASES):
            key = f"{mesh_name}-{name}"
            x = case_inputs(kh, d, s, sizes["sp"], seed=i)
            cases[key] = (x, causal, flash, sizes)
            inputs.update({f"{key}/{k}": v for k, v in x.items()})
            jobs.append(dict(name=key, kind="ring", tensors=key,
                             causal=causal, flash=flash))
        phases.append(dict(mesh_axes=axes, jobs=jobs))
    x = cases["sp4-causal"][0]
    inputs.update({f"sp4-perturbed/{k}": v
                   for k, v in perturbed(x).items()})
    phases[0]["jobs"].append(dict(name="sp4-perturbed", kind="ring",
                                  tensors="sp4-perturbed", causal=True,
                                  flash=False))
    g = torch_gang.Gang(job_dir, 4, phases, inputs)
    g.cases = cases
    yield g
    g.close()


def assemble(blocks: list, axis_sizes: dict, key: str) -> np.ndarray:
    """The global (B, S, H, D) array from the ranks' (dp rows, sp
    positions) blocks."""
    dp, sp = axis_sizes.get("dp", 1), axis_sizes["sp"]
    rows = []
    for i in range(dp):
        shards = [None] * sp
        for coords, arrays in blocks:
            if coords["dp"] == i:
                shards[coords["sp"]] = arrays[key]
        rows.append(np.concatenate(shards, axis=1))
    return np.concatenate(rows, axis=0)


def jax_ring(x: dict, causal: bool, flash: bool, sizes: dict):
    mesh = jmesh.make_mesh(jmesh.MeshConfig(**sizes),
                           devices=jax.devices()[:4])
    q, k, v, do = (jnp.asarray(x[n]) for n in ("q", "k", "v", "do"))

    def loss(q, k, v):
        o = jring(q, k, v, mesh=mesh, causal=causal, use_flash=flash)
        return jnp.sum(o * do), o
    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return o, grads


def dense(x: dict, causal: bool):
    q, k, v, do = (jnp.asarray(x[n]) for n in ("q", "k", "v", "do"))

    def loss(q, k, v):
        o = attention_reference(q, k, v, causal=causal)
        return jnp.sum(o * do), o
    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return o, grads


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_lse_matches_jax_in_interpret_mode(causal):
    """O, LSE and the gradients for cotangents of both outputs (the LSE's
    folded into the backward's delta) equal the JAX kernel's."""
    rng = np.random.default_rng(7)
    q, k, v, go = (rng.standard_normal((1, 256, 2, 128)).astype(np.float32)
                   for _ in range(4))
    gl = rng.standard_normal((1, 2, 256)).astype(np.float32)
    (jo, jl), vjp = jax.vjp(lambda a, b, c: jflash.flash_attention_lse(
        a, b, c, causal), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp((jnp.asarray(go), jnp.asarray(gl)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o, lse = tflash.flash_attention_lse(tq, tk, tv, causal)
    assert lse.dtype == torch.float32 and lse.shape == (1, 2, 256)
    grads = torch.autograd.grad(
        (o * torch.from_numpy(go)).sum() + (lse * torch.from_numpy(gl)).sum(),
        (tq, tk, tv))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **LSE_TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jl),
                               **LSE_TOL)
    for name, got, want in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"d{name}", **LSE_TOL)


def test_lse_cotangent_folds_into_delta():
    """The LSE's cotangent alone gives ds = p * g_lse: dq, dk, dv equal
    autograd through the plain logsumexp (f64 reference)."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 16, 2, 8)))
               .float().requires_grad_(True) for _ in range(3))
    gl = torch.from_numpy(rng.standard_normal((2, 2, 16))).float()
    _, lse = tflash.flash_attention_lse(q, k, v, True)
    got = torch.autograd.grad((lse * gl).sum(), (q, k, v))
    qd, kd, vd = (t.detach().double().requires_grad_(True)
                  for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * 8 ** -0.5
    s = s.masked_fill(~torch.ones(16, 16, dtype=torch.bool).tril(), -1e30)
    want = torch.autograd.grad((torch.logsumexp(s, -1) * gl.double()).sum(),
                               (qd, kd, vd), allow_unused=True)
    for g, w in zip(got, want):
        w = torch.zeros_like(g.double()) if w is None else w
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("mesh_name", [m[0] for m in MESHES])
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_ring_attention_matches_jax_and_dense(gang, mesh_name, case):
    key = f"{mesh_name}-{case}"
    x, causal, flash, sizes = gang.cases[key]
    blocks = gang.rank_arrays(key)
    assert all(r[key]["flash"] == flash for r in gang.result())
    got = {n: assemble(blocks, sizes, n) for n in ("o", "dq", "dk", "dv")}
    jo, jgrads = jax_ring(x, causal, flash, sizes)
    do, dgrads = dense(x, causal)
    for want_o, want_grads, what in ((jo, jgrads, "JAX ring"),
                                     (do, dgrads, "dense")):
        np.testing.assert_allclose(got["o"], np.asarray(want_o),
                                   err_msg=f"{key} o vs {what}", **OUT_TOL)
        for name, want in zip(("dq", "dk", "dv"), want_grads):
            np.testing.assert_allclose(got[name], np.asarray(want),
                                       err_msg=f"{key} {name} vs {what}",
                                       **GRAD_TOL)


def test_ring_respects_causality_at_shard_boundaries(gang):
    """Changing the last position's K and V changes no earlier output:
    the shards before it bit for bit, and the last shard's earlier rows."""
    sizes = {"sp": 4}
    o = assemble(gang.rank_arrays("sp4-causal"), sizes, "o")
    o2 = assemble(gang.rank_arrays("sp4-perturbed"), sizes, "o")
    np.testing.assert_array_equal(o[:, :-1], o2[:, :-1])
    assert not np.allclose(o[:, -1], o2[:, -1])


def test_ring_step_schedule_is_static_per_step():
    """`ring_step` on one process with the shift replaced by indexing
    into the held shards: the diagonal block causal, past blocks
    unmasked, future blocks skipped (their gradient zero), equal to the
    whole sequence's attention on both routes."""
    rng = np.random.default_rng(9)
    sp, s = 4, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((1, sp * s, 2, 128)))
               .float().requires_grad_(True) for _ in range(3))
    want = tflash.flash_attention_plain(q, k, v, True)
    gw = torch.autograd.grad(want.sum(), (q, k, v))
    for flash in (False, True):
        outs = []
        for r in range(sp):
            qs = q[:, r * s:(r + 1) * s]
            part = tring.init_partials(qs)
            for step in range(sp):
                src = (r - step) % sp
                part = tring.ring_step(qs, k[:, src * s:(src + 1) * s],
                                       v[:, src * s:(src + 1) * s], part, r,
                                       src, True, flash)
            outs.append(tring.finish(part, q.dtype))
        got = torch.cat(outs, dim=1)
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), **OUT_TOL)
        for g, w in zip(torch.autograd.grad(got.sum(), (q, k, v)), gw):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)
