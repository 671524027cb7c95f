"""KTWE in PyTorch and CUDA, for NVIDIA Hopper (H100).

The port of the JAX package `k8s_gpu_workload_enhancer_tpu`, which stays
beside it as the reference: the port's tests hold every ported module to
its JAX counterpart on the same weights and inputs. The port imports
torch, numpy and the standard library only — never jax, and nothing of the
JAX package; where it needs one of that package's jax-free helpers it keeps
its own copy (utils/).

Layout mirrors the JAX package: `ops/` (plain tensor math plus the
hand-written CUDA kernels of `csrc/`, built on first use), `models/`
(KTWE-LM, KV-cached decoding, the continuous-batching engine), `train/`
(single-device training), `cmd/` (serve, generate and trainer mains) and
`utils/`. Entry points run on the card
unless the caller passes device "cpu".
"""
