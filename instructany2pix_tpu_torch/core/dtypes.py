"""Dtype policy for the PyTorch port.

Same defaults as the JAX package's policy: parameters and activations in
bfloat16 (tensor-core inputs with fp32 accumulation), normalization
statistics, softmax and scheduler math in float32. The port's models run
their activations in the weights' dtype and always take norms, softmax
and scheduler steps in float32, so the weights' dtype is the one setting.
`FP32` runs every model in float32 and is what the parity tests use.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """param_dtype: storage dtype of weights, and so of activations."""

    param_dtype: torch.dtype = torch.bfloat16


DEFAULT = DTypePolicy()
FP32 = DTypePolicy(param_dtype=torch.float32)
