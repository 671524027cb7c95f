"""The flagship training configuration, as the port's own copy.

The JAX package defines it twice: `FLAGSHIP_MODEL` / `FLAGSHIP_TRAIN` in
scripts/_probe_common.py and the single-chip branch of bench.py's
training run: vocab 32768, d_model 2048, 3 layers, 4 heads of 512, d_ff
16384, seq 2048, bf16, a single-chunk LM-head CE with cached logits, and
a global batch of 256 as 32 microbatches of 8. At these shapes both
kernel paths of the reference engage: the t-layout RoPE and flash
attention (head_dim 512) and the fused LM-head CE.

Two of the reference dict's fields have no counterpart in the port's
TransformerConfig and are left out: `use_flash` (the port always runs the
flash kernels) and `scan_layers` (the port's layers are an unrolled loop,
which is what the flagship's False asks for). `use_ring_attention` is
carried as the reference sets it (False); only an sp axis above 1 reads
it, and the flagship runs on one device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.transformer import TransformerConfig
from .trainer import TrainConfig

FLAGSHIP_MODEL = dict(
    vocab_size=32768, d_model=2048, n_layers=3, n_heads=4, n_kv_heads=4,
    d_ff=16384, max_seq=2048, dtype=torch.bfloat16, remat=False,
    ce_chunk=32768, ce_cache_logits=True, use_ring_attention=False)
FLAGSHIP_TRAIN = dict(batch_size=256, seq_len=2048, warmup_steps=10,
                      total_steps=1000, grad_accum=32)


def flagship_configs(**train_overrides) -> Tuple[TransformerConfig,
                                                 TrainConfig]:
    """(model config, train config) of the flagship, with the train
    config's fields overridden by keyword (a run shorter than the
    reference's batch of 256, say)."""
    return (TransformerConfig(**FLAGSHIP_MODEL),
            TrainConfig(**{**FLAGSHIP_TRAIN, **train_overrides}))
