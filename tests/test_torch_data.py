"""The port's token-shard input pipeline (train/data.py) against the JAX
package's: the same shard gives the same batches from any start step, for
each of several processes and with gradient accumulation; a shard written
by either package is read by the other; the prefetched tensors are the
numpy batches as int64 tokens. Everything is integer data, so every
comparison is exact."""

import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.train import data as jdata
from k8s_gpu_workload_enhancer_tpu_torch.train import data as tdata

import torch_parity  # noqa: F401  (one intra-op thread a process)

SEQ = 16
WINDOWS = 11                   # a prime: batches straddle epoch ends


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("shard") / "tokens.bin")
    toks = np.random.default_rng(3).integers(0, 1000, WINDOWS * (SEQ + 1) + 5)
    jdata.write_token_file(path, toks)
    return path


def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("start_step,procs,accum", [
    (0, 1, 1), (5, 1, 1), (0, 2, 1), (5, 2, 1), (0, 1, 2), (5, 1, 2)],
    ids=lambda v: str(v))
def test_batches_match_jax(shard, start_step, procs, accum):
    for pid in range(procs):
        kw = dict(path=shard, batch_size=4, seq_len=SEQ, seed=7,
                  process_id=pid, num_processes=procs, grad_accum=accum)
        want = _take(jdata.TokenDataset(jdata.DataConfig(**kw))
                     .batches(start_step), 6)
        got = _take(tdata.TokenDataset(tdata.DataConfig(**kw))
                    .batches(start_step), 6)
        for w, g in zip(want, got):
            assert g.dtype == w.dtype == np.int32
            assert g.shape == w.shape == (
                (4, SEQ + 1) if accum == 1 else (accum, 4 // accum, SEQ + 1))
            np.testing.assert_array_equal(g, w)


def test_window_at_matches_jax_in_any_order(shard):
    """The port caches one permutation an epoch; jumping between epochs
    must still give the reference's windows."""
    cfg = dict(path=shard, batch_size=1, seq_len=SEQ, seed=2)
    j = jdata.TokenDataset(jdata.DataConfig(**cfg))
    t = tdata.TokenDataset(tdata.DataConfig(**cfg))
    for i in (0, 30, 3, 12, 11, 57, 10, 0):
        np.testing.assert_array_equal(t.window_at(i), j.window_at(i))


@pytest.mark.parametrize("writer,high", [("jax", 1000), ("port", 1000),
                                         ("jax", 70000), ("port", 70000)])
def test_token_files_cross_read(tmp_path, writer, high):
    toks = np.random.default_rng(1).integers(0, high, 300)
    path = str(tmp_path / "t.bin")
    (jdata if writer == "jax" else tdata).write_token_file(path, toks)
    for reader in (jdata, tdata):
        got = reader.open_token_file(path)
        assert got.dtype == (np.uint16 if high < 2 ** 16 else np.uint32)
        np.testing.assert_array_equal(got, toks)
    other = str(tmp_path / "u.bin")
    (tdata if writer == "jax" else jdata).write_token_file(other, toks)
    assert open(path, "rb").read() == open(other, "rb").read()


def test_bad_shards_raise(tmp_path):
    path = str(tmp_path / "bad.bin")
    with open(path, "wb") as f:
        f.write(b"NOTATOKN" + bytes(20))
    with pytest.raises(ValueError, match="not a KTWE token file"):
        tdata.open_token_file(path)
    tdata.write_token_file(path, np.arange(SEQ))
    with pytest.raises(ValueError, match="one window"):
        tdata.TokenDataset(tdata.DataConfig(path=path, batch_size=1,
                                            seq_len=SEQ))


@pytest.mark.parametrize("prefetch", [True, False])
def test_pipeline_yields_the_numpy_batches(shard, prefetch):
    cfg = tdata.DataConfig(path=shard, batch_size=4, seq_len=SEQ, seed=7,
                           grad_accum=2, prefetch=prefetch)
    want = _take(tdata.TokenDataset(cfg).batches(3), 5)
    got = _take(tdata.make_input_pipeline(cfg, start_step=3, device="cpu"), 5)
    for w, g in zip(want, got):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.int64
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w)


def test_prefetch_on_the_cpu_converts_every_batch_in_order():
    it = tdata.prefetch_to_device(
        (np.full((2, 3), i, np.int32) for i in range(4)), "cpu")
    got = list(it)
    assert [t.dtype for t in got] == [torch.int64] * 4
    assert [t.tolist() for t in got] == [[[i] * 3] * 2 for i in range(4)]
