"""Speculative decoding's module on the port (models/speculative.py and the
decode writes it needs), held to the JAX package on the same weights and
inputs (CPU, f32; tests/unit/test_speculative.py's sizes: vocab 128,
d_model 32, 2 layers, max_seq 96, and 128 at the engine's).

- The drafters and the acceptance arithmetic: `ngram_propose` (its
  pinned cases and seeded random contexts), `NGramDrafter`'s validation,
  `accept_counts`, `spec_write_rows` and `scatter_rows` equal the JAX
  functions; `DraftModelDrafter` proposes the JAX drafter's tokens.
- `generate_speculative` gives the JAX function's tokens and rounds, and
  the port's `decode.generate` tokens, for a perfect draft, a weak one, a
  smaller one and the early-exit self-draft, at several k; its bounds and
  refusals are JAX's.
- The generate main's `--speculate-*`: the JAX main's usage errors, and a
  "speculative" result whose keys are the JAX main's and whose tokens are
  the plain greedy ones.

Every generation asserts that verify rounds ran.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.cmd import generate as jgen
from k8s_gpu_workload_enhancer_tpu.models import decode as jdec
from k8s_gpu_workload_enhancer_tpu.models import speculative as jspec
from k8s_gpu_workload_enhancer_tpu.models import transformer as jtf
from k8s_gpu_workload_enhancer_tpu_torch.cmd import generate as tgen
from k8s_gpu_workload_enhancer_tpu_torch.models import decode as tdec
from k8s_gpu_workload_enhancer_tpu_torch.models import speculative as tspec
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf

import torch_parity  # noqa: F401  (one intra-op thread a process)

DIMS = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
            d_ff=64, max_seq=96)


def model(seed=0, **kw):
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    dims = {**DIMS, **kw}
    jcfg = jtf.TransformerConfig(**dims, dtype=jnp.float32, use_flash=False,
                                 use_ring_attention=False)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    tcfg = ttf.TransformerConfig(**dims, dtype=torch.float32)
    return jcfg, jp, tcfg, ttf.params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


@pytest.fixture(scope="module")
def target():
    return model()


# ----------------------------------------------------- drafters, arithmetic

PINNED = [([1, 2, 3, 9, 1, 2, 3, 7, 8, 1, 2, 3], 2),
          ([1, 2, 3, 9, 1, 2, 3, 7, 8, 1, 2, 3], 1),
          ([1, 2, 3, 4, 5], 4), ([], 4), ([5], 4),
          ([1, 2, 3, 9, 1, 2, 3, 7, 8, 1, 2, 3], 0),
          ([7, 4, 4, 4], 4), ([9, 3, 5, 3, 5, 3, 5], 4)]


@pytest.mark.parametrize("seed", range(6))
def test_ngram_propose_equals_jax(seed):
    rng = np.random.default_rng(seed)
    cases = list(PINNED)
    for _ in range(40):
        # Small alphabets make matches (and cycles) common.
        ctx = rng.integers(0, 2 + seed, int(rng.integers(0, 30))).tolist()
        cases.append((ctx, int(rng.integers(0, 7))))
    hits = 0
    for ctx, k in cases:
        for max_n, min_n in ((3, 1), (1, 1), (4, 2)):
            got = tspec.ngram_propose(ctx, k, max_n=max_n, min_n=min_n)
            assert got == jspec.ngram_propose(ctx, k, max_n=max_n,
                                              min_n=min_n), (ctx, k)
            hits += bool(got)
    assert hits > 0
    assert tspec.ngram_propose(PINNED[0][0], 2) == [7, 8]
    assert tspec.ngram_propose([9, 3, 5, 3, 5, 3, 5], 4) == [3, 5, 3, 5]


@pytest.mark.parametrize("max_n,min_n", [(0, 1), (2, 3), (2, 1), (3, 1)])
def test_ngram_drafter_validates_and_binds_window(max_n, min_n):
    try:
        want = jspec.NGramDrafter(max_n=max_n, min_n=min_n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tspec.NGramDrafter(max_n=max_n, min_n=min_n)
        assert str(got.value) == str(e)
        return
    got = tspec.NGramDrafter(max_n=max_n, min_n=min_n)
    for ctx in ([1, 9, 1, 9, 1], [5, 6, 7, 5, 6, 7, 5], [1, 2]):
        assert got(ctx, 3) == want(ctx, 3)
    assert tspec.NGramDrafter(max_n=2)([1, 9, 1, 9, 1], 2) == [9, 1]


@pytest.mark.parametrize("seed", range(4))
def test_accept_counts_equals_jax(seed):
    rng = np.random.default_rng(seed)
    b, k = 9, 1 + seed
    drafts = rng.integers(0, 3, (b, k))
    outs = rng.integers(0, 3, (b, k + 1))
    outs[0, :k] = drafts[0]                   # all accepted + bonus
    dlen = rng.integers(0, k + 1, b)
    dlen[0] = k
    want = np.asarray(jspec.accept_counts(
        jnp.asarray(drafts, jnp.int32), jnp.asarray(outs, jnp.int32),
        jnp.asarray(dlen, jnp.int32)))
    got = tspec.accept_counts(torch.from_numpy(drafts),
                              torch.from_numpy(outs), torch.from_numpy(dlen))
    assert got.dtype == torch.int64
    assert got.tolist() == want.tolist()
    assert want[0] == k + 1 and ((1 <= want) & (want <= k + 1)).all()
    pinned = tspec.accept_counts(
        torch.tensor([[5, 6, 7]] * 3 + [[1, 1, 1]]),
        torch.tensor([[5, 6, 7, 9], [5, 9, 9, 9], [9, 9, 9, 9],
                      [1, 1, 1, 1]]), torch.tensor([3, 3, 3, 0]))
    assert pinned.tolist() == [4, 2, 1, 1]


@pytest.mark.parametrize("pos", [[0, 5, 9], [14, 15, 3], [13, 0, 15]],
                         ids=["inside", "clamped", "mixed"])
def test_spec_write_rows_and_scatter_rows_equal_jax(pos):
    t, s_max = 4, 16
    rows = tdec.spec_write_rows(torch.tensor(pos), t, s_max)
    want_rows = np.asarray(jdec.spec_write_rows(jnp.asarray(pos, jnp.int32),
                                                t, s_max))
    assert rows.tolist() == want_rows.tolist()
    rng = np.random.default_rng(len(pos))
    leaf = rng.standard_normal((3, s_max, 2, 5)).astype(np.float32)
    vals = rng.standard_normal((3, t, 2, 5)).astype(np.float32)
    want = np.asarray(jdec.scatter_rows(jnp.asarray(leaf), jnp.asarray(vals),
                                        jnp.asarray(want_rows)))
    got = torch.from_numpy(leaf.copy())
    tdec.scatter_rows(got, torch.from_numpy(vals), rows)
    # The spill row's winner among duplicate writes is a don't-care.
    keep = np.ones(s_max, bool)
    keep[s_max - 1] = False
    np.testing.assert_array_equal(got.numpy()[:, keep], want[:, keep])
    for b, p in enumerate(pos):
        live = [r for r in range(p, p + t) if r < s_max - 1]
        np.testing.assert_array_equal(got.numpy()[b, live],
                                      vals[b, :len(live)])


def test_draft_model_drafter_equals_jax(target):
    jcfg, jp, tcfg, tp = target
    jd, td = jspec.DraftModelDrafter(jp, jcfg), tspec.DraftModelDrafter(tp,
                                                                        tcfg)
    for ctx, k in (([3, 17, 29, 5], 3), ([9] * 10, 4), (list(range(90)), 8)):
        got = td(ctx, k)
        assert got == jd(ctx, k) and len(got) == k
    assert td([3, 17], 0) == [] and td([], 3) == []


# ------------------------------------------------------ generate_speculative

def _draft(kind, target):
    """(jax draft params, jax cfg, port draft params, port cfg)."""
    jcfg, jp, tcfg, tp = target
    if kind == "perfect":
        return jp, jcfg, tp, tcfg
    if kind == "weak":
        j, jpp, t, tpp = model(seed=7)
        return jpp, j, tpp, t
    if kind == "smaller":
        j, jpp, t, tpp = model(seed=3, d_model=16, n_layers=1, d_ff=32,
                               n_heads=1, n_kv_heads=1)
        return jpp, j, tpp, t
    # The generate main's early exit: the first layer, shared leaves.
    jd = {k: v for k, v in jp.items() if k != "layers"}
    jd["layers"] = jax.tree.map(lambda a: a[:1], jp["layers"])
    td, tcfg1 = tgen.early_exit_draft(tp, tcfg, 1)
    return jd, dataclasses.replace(jcfg, n_layers=1), td, tcfg1


SPEC_CASES = [("perfect", 4, [3, 17, 29, 5], 24),
              ("weak", 1, [9, 9, 10, 11], 20),
              ("weak", 3, [9, 9, 10, 11], 20),
              ("weak", 5, [9, 9, 10, 11], 20),
              ("smaller", 4, [40, 2, 77], 16),
              ("early-exit", 4, [3, 17, 29, 5], 16)]


@pytest.mark.parametrize(
    "kind,k,prompt,n", SPEC_CASES,
    ids=[f"{c[0]}-k{c[1]}" for c in SPEC_CASES])
def test_generate_speculative_equals_jax_and_plain(target, kind, k, prompt,
                                                   n):
    jcfg, jp, tcfg, tp = target
    jd, jdc, td, tdc = _draft(kind, target)
    jtoks, jrounds = jspec.generate_speculative(
        jp, jcfg, jd, jdc, jnp.asarray([prompt], jnp.int32), n, k=k,
        max_seq=jcfg.max_seq)
    toks, rounds = tspec.generate_speculative(
        tp, tcfg, td, tdc, torch.tensor([prompt]), n, k=k,
        max_seq=tcfg.max_seq)
    plain = tdec.generate(tp, torch.tensor([prompt]), n, tcfg)
    assert toks.tolist() == plain.tolist() == np.asarray(jtoks).tolist()
    assert rounds == int(jrounds) > 0
    assert math.ceil((n - 1) / (k + 1)) <= rounds <= n - 1
    if kind == "perfect":
        assert rounds <= -(-(n - 1) // (k + 1)) + 1
    st = tspec.spec_stats(rounds, n)
    assert (st.rounds, st.tokens) == (rounds, n - 1)
    assert st.tokens_per_round == jspec.spec_stats(jrounds, n).tokens_per_round


def test_generate_speculative_bounds_and_refusals(target):
    jcfg, jp, tcfg, tp = target
    prompt = torch.tensor([[5, 6]])
    toks, rounds = tspec.generate_speculative(tp, tcfg, tp, tcfg, prompt, 1,
                                              k=4)
    assert toks.tolist() == tdec.generate(tp, prompt, 1, tcfg).tolist()
    assert rounds == 0          # the prefill sample covers the one token
    assert tspec.generate_speculative(tp, tcfg, tp, tcfg, prompt, 0)[1] == 0
    refusals = [
        (dict(num_steps=tcfg.max_seq), "max_seq"),
        (dict(prompt=torch.tensor([[5, 6], [7, 8]])), "per-stream"),
        (dict(cfg_draft=dataclasses.replace(tcfg, vocab_size=64)),
         "vocabulary"),
        (dict(cfg_target=dataclasses.replace(tcfg, kv_cache_int8=True)),
         "kv_cache_int8"),
        (dict(k=0), None)]
    for change, match in refusals:
        kw = dict(params_target=tp, cfg_target=tcfg, params_draft=tp,
                  cfg_draft=tcfg, prompt=prompt, num_steps=8, k=4)
        kw.update(change)
        with pytest.raises(AssertionError, match=match):
            tspec.generate_speculative(**kw)
    with pytest.raises(AssertionError, match="max_seq"):
        jspec.generate_speculative(jp, jcfg, jp, jcfg,
                                   jnp.asarray([[5, 6]], jnp.int32),
                                   jcfg.max_seq, k=4)


# ---------------------------------------------------------- generate main

TINY = ["--prompt-len", "8", "--gen-len", "12", "--d-model", "32",
        "--n-layers", "3", "--n-heads", "2", "--d-ff", "64",
        "--vocab-size", "128"]
USAGE = [["--batch-size", "2", "--speculate-draft-layers", "1"],
         ["--batch-size", "1", "--temperature", "0.5",
          "--speculate-draft-layers", "1"],
         ["--batch-size", "1", "--speculate-draft-layers", "3"],
         ["--batch-size", "1", "--speculate-draft-layers", "1",
          "--speculate-k", "0"]]


@pytest.mark.parametrize("argv", USAGE,
                         ids=["batch", "sampled", "not-early", "k0"])
def test_generate_main_refuses_as_the_jax_main(argv, capsys):
    errs = []
    for main, extra in ((jgen.main, []), (tgen.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(TINY + argv + extra)
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[0].split(": error: ")[1] == errs[1].split(": error: ")[1]


def test_generate_main_speculative_result(capsys):
    argv = TINY + ["--batch-size", "1", "--speculate-draft-layers", "1",
                   "--speculate-k", "3"]
    assert jgen.main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tgen.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) - {"device_name"} == set(want)
    assert set(got["speculative"]) == set(want["speculative"])
    spec = got["speculative"]
    assert (spec["draft_layers"], spec["k"]) == (1, 3)
    assert 1 <= spec["rounds"] <= 11
    assert spec["tokens_per_round"] == round(11 / spec["rounds"], 2)
    # The main's speculative tokens are the plain greedy ones (f32).
    args = tgen.build_parser().parse_args(argv + ["--device", "cpu"])
    cfg = ttf.TransformerConfig(vocab_size=128, d_model=32, n_layers=3,
                                n_heads=2, n_kv_heads=2, d_ff=64,
                                max_seq=20, dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = ttf.init_params(gen, cfg)
    prompt = torch.randint(0, 128, (1, 8), generator=gen)
    stats, toks = tgen._run_speculative(args, cfg, params, prompt)
    assert toks.tolist() == tdec.generate(params, prompt, 12, cfg).tolist()
    assert got["sample_tail"] == toks[0, -5:].tolist()
    assert stats["rounds"] == spec["rounds"]
