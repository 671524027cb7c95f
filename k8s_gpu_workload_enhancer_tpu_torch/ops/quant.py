"""Weight-only int8 quantization for serving.

Port of k8s_gpu_workload_enhancer_tpu/ops/quant.py. Quantized leaves are
plain dicts {"q8": int8, "scale": f32} with the same leading (layer) axes
as the weight they replace; `as_compute` dequantizes one on use.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

QuantLeaf = Dict[str, torch.Tensor]        # {"q8": int8, "scale": f32}


def quantize_int8(w: torch.Tensor,
                  contract_axes: Tuple[int, ...]) -> QuantLeaf:
    """Symmetric int8: w ~= q8 * scale, the scale shared along the axes the
    consuming matmul sums over and per element along every other axis."""
    w32 = w.float()
    axes = tuple(a % w32.dim() for a in contract_axes)
    amax = torch.amax(torch.abs(w32), dim=axes, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q8 = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q8": q8, "scale": scale.float()}


def is_quantized(v: Any) -> bool:
    return isinstance(v, dict) and "q8" in v and "scale" in v


def as_compute(v: Union[torch.Tensor, QuantLeaf],
               dtype: torch.dtype) -> torch.Tensor:
    """Weight leaf -> compute-dtype tensor; dequantizes int8 leaves."""
    if is_quantized(v):
        return v["q8"].to(dtype) * v["scale"].to(dtype)
    return v.to(dtype)


def dequantize(v: QuantLeaf) -> torch.Tensor:
    return v["q8"].float() * v["scale"]


def _contract_axes(name: str, ndim: int) -> Tuple[int, ...]:
    """Contraction axes of each KTWE-LM matmul weight (stacked, layer
    axis 0, which is never contracted, so scales stay per layer)."""
    if name in ("wq", "wk", "wv"):       # (L, d, h, hd) — contract d
        return (1,)
    if name == "wo":                     # (L, h, hd, d) — contract h, hd
        return (1, 2)
    if name in ("w_gate", "w_up", "w_down"):   # (L, d, f) / (L, f, d)
        return (ndim - 2,)
    if name == "lm_head":                # (d, v)
        return (0,)
    raise KeyError(name)


# The large matmul operands. Norm scales and embeddings stay high precision.
QUANTIZABLE = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "lm_head"}


def quantize_leaf(name: str, v: torch.Tensor) -> Any:
    """The leaf `name` of a KTWE-LM param tree for int8 serving: a matmul
    weight quantized, any other leaf as it is."""
    if name in QUANTIZABLE:
        return quantize_int8(v, _contract_axes(name, v.dim()))
    return v


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize a KTWE-LM param tree's matmul weights to int8 for serving.
    Returns a new tree; unquantized leaves are shared, not copied."""
    return {k: (quantize_params(v) if isinstance(v, dict)
                else quantize_leaf(k, v)) for k, v in params.items()}
