"""Convert a JAX trainer checkpoint (orbax) into the PyTorch port's format.

Reads one step of a checkpoint directory written by the JAX package's
trainer (`k8s_gpu_workload_enhancer_tpu.train.checkpoint.CheckpointManager`)
into an abstract template built from the model-dimension flags (as the JAX
serve's loader builds it, so nothing is materialized on a device), and
writes the port's `ckpt-{step}.pt` (`k8s_gpu_workload_enhancer_tpu_torch.
train.checkpoint`) into --out-dir. The param tree is the same in both
packages, so params are copied leaf for leaf. The optax state of the JAX
trainer is

    (EmptyState,                                  # clip_by_global_norm
     (ScaleByAdamState(count, mu, nu),            # adamw: scale_by_adam
      EmptyState,                                 #   add_decayed_weights
      ScaleByScheduleState(count)))               #   the lr schedule

and maps to the port's {"count", "mu", "nu"}; the two counts must agree.

This script imports jax and orbax, so it runs where the JAX package is
installed, not on a machine that has only the port.

    python scripts/convert_jax_checkpoint.py --jax-dir ckpt-jax \\
        --out-dir ckpt-torch --vocab-size 32768 --d-model 2048 \\
        --n-layers 8 --n-heads 16 --d-ff 8192

A checkpoint of the MoE model (the JAX trainer's --n-experts N) converts
with the same --n-experts N: the router and the expert banks are leaves
of the same tree.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from k8s_gpu_workload_enhancer_tpu.models import transformer as jtf  # noqa: E402
from k8s_gpu_workload_enhancer_tpu.train import trainer as jtrainer  # noqa: E402
from k8s_gpu_workload_enhancer_tpu.train.checkpoint import (  # noqa: E402
    CheckpointManager as JaxCheckpointManager)
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf  # noqa: E402
from k8s_gpu_workload_enhancer_tpu_torch.train import trainer as ttrainer  # noqa: E402
from k8s_gpu_workload_enhancer_tpu_torch.train.checkpoint import (  # noqa: E402
    CheckpointManager)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="convert-jax-checkpoint")
    p.add_argument("--jax-dir", required=True,
                   help="the JAX trainer's --checkpoint-dir")
    p.add_argument("--out-dir", required=True,
                   help="where the port's ckpt-{step}.pt is written")
    p.add_argument("--step", type=int, default=None,
                   help="the step to convert (default: the latest)")
    p.add_argument("--vocab-size", type=int, default=32768)
    p.add_argument("--d-model", type=int, default=2048)
    p.add_argument("--n-layers", type=int, default=8)
    p.add_argument("--n-heads", type=int, default=16)
    p.add_argument("--n-kv-heads", type=int, default=0,
                   help="0 = same as --n-heads")
    p.add_argument("--d-ff", type=int, default=8192)
    p.add_argument("--max-seq", type=int, default=2048)
    p.add_argument("--n-experts", type=int, default=0,
                   help="MoE experts a layer (0 = the dense model), as the "
                        "JAX trainer's --n-experts")
    return p


def restore_jax_state(jax_dir: str, step, jcfg: jtf.TransformerConfig):
    """The JAX TrainState of `step` (None = latest), host-side."""
    p_shapes = jax.eval_shape(
        # ktwe-lint: allow[prng-key] -- abstract template key, never materialized
        lambda: jtf.init_params(jax.random.PRNGKey(0), jcfg))
    tcfg = jtrainer.TrainConfig(batch_size=1, seq_len=jcfg.max_seq)
    o_shapes = jax.eval_shape(jtrainer.make_optimizer(tcfg).init, p_shapes)
    template = jtrainer.TrainState(
        params=p_shapes, opt_state=o_shapes,
        step=jax.ShapeDtypeStruct((), jnp.int32))
    mgr = JaxCheckpointManager(jax_dir)
    try:
        return mgr.restore(step, template)
    finally:
        mgr.close()


def to_port_state(jstate, tcfg: ttf.TransformerConfig) -> ttrainer.TrainState:
    """The port's TrainState (f32 host tensors) of a JAX TrainState."""
    adam, _, sched = jstate.opt_state[1]
    count = int(np.asarray(adam.count))
    if count != int(np.asarray(sched.count)):
        raise SystemExit(f"optax counts disagree: scale_by_adam {count}, "
                         f"schedule {int(np.asarray(sched.count))}")

    def tree(t):
        return ttf.params_from_numpy(jax.tree.map(np.asarray, t), tcfg, "cpu")

    return ttrainer.TrainState(
        params=tree(jstate.params),
        opt_state={"count": count, "mu": tree(adam.mu), "nu": tree(adam.nu)},
        step=int(np.asarray(jstate.step)))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dims = dict(vocab_size=args.vocab_size, d_model=args.d_model,
                n_layers=args.n_layers, n_heads=args.n_heads,
                n_kv_heads=args.n_kv_heads or args.n_heads, d_ff=args.d_ff,
                max_seq=args.max_seq, n_experts=args.n_experts)
    jstate = restore_jax_state(args.jax_dir, args.step,
                               jtf.TransformerConfig(**dims))
    state = to_port_state(jstate, ttf.TransformerConfig(**dims))
    mgr = CheckpointManager(args.out_dir)
    mgr.save(state.step, state, wait=True)
    mgr.close()
    print(f"converted step {state.step} (count {state.opt_state['count']}) "
          f"to {os.path.join(mgr.directory, f'ckpt-{state.step}.pt')}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
