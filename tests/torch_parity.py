"""Shared setup of the PyTorch port's parity tests (tests/test_torch_*.py).

One small KTWE-LM configuration built for both packages: vocab 512,
d_model 512, 2 heads of 256 (so the JAX package's RoPE and flash Pallas
kernels engage, in interpret mode on the CPU), d_ff 1024, 2 layers,
max_seq 64, f32. The JAX params are made once from a seed and handed to the
port as numpy arrays, so both packages compute the same function.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from k8s_gpu_workload_enhancer_tpu.models import transformer as jtf
from k8s_gpu_workload_enhancer_tpu.ops.quant import quantize_params as jquant
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf

DIMS = dict(vocab_size=512, d_model=512, n_layers=2, n_heads=2, d_ff=1024,
            max_seq=64)
PREFILL_LEN = 32


def jax_cfg(n_kv_heads: int = 2) -> jtf.TransformerConfig:
    return jtf.TransformerConfig(**DIMS, n_kv_heads=n_kv_heads,
                                 dtype=jnp.float32, use_flash=True,
                                 use_ring_attention=False)


def torch_cfg(n_kv_heads: int = 2) -> ttf.TransformerConfig:
    return ttf.TransformerConfig(**DIMS, n_kv_heads=n_kv_heads,
                                 dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def model(n_kv_heads: int = 2, int8: bool = False, seed: int = 0):
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    jcfg = jax_cfg(n_kv_heads)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    if int8:
        jp = jquant(jp)
    tree = jax.tree.map(np.asarray, jp)
    tcfg = torch_cfg(n_kv_heads)
    return jcfg, jp, tcfg, ttf.params_from_numpy(tree, tcfg, "cpu")


def tokens(shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, DIMS["vocab_size"], shape).astype(np.int32)


# The training parity configuration: head_dim 128 (so the JAX package's
# flash forward and backward Pallas kernels engage, in interpret mode, while
# its RoPE takes the XLA branch, as at the trainer's defaults), a vocab of
# 320 over CE chunks of 128 (a clamped, ragged last chunk), seq 32, f32.
TRAIN_DIMS = dict(vocab_size=320, d_model=256, n_layers=2, n_heads=2,
                  d_ff=512, max_seq=32)
TRAIN_CE_CHUNK = 128


def train_jax_cfg() -> jtf.TransformerConfig:
    return jtf.TransformerConfig(**TRAIN_DIMS, n_kv_heads=2,
                                 dtype=jnp.float32, use_flash=True,
                                 use_ring_attention=False,
                                 ce_chunk=TRAIN_CE_CHUNK)


def train_torch_cfg() -> ttf.TransformerConfig:
    return ttf.TransformerConfig(**TRAIN_DIMS, n_kv_heads=2,
                                 dtype=torch.float32,
                                 ce_chunk=TRAIN_CE_CHUNK)


def to_torch_tree(tree) -> dict:
    """A JAX param tree as the port's f32 CPU tensors, leaf for leaf."""
    return ttf.params_from_numpy(jax.tree.map(np.asarray, tree),
                                 train_torch_cfg(), "cpu")
