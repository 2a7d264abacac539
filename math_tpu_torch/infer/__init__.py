"""Inference: chain-batched NUTS with pooled warmup
(counterpart: ``math_tpu/infer``)."""

from math_tpu_torch.infer.nuts import (  # noqa: F401
    ChainNoise,
    IntegratorState,
    LogpGrad,
    NutsStats,
    nuts_kernel,
)
from math_tpu_torch.infer.pooled import PooledResult, run_pooled_chains  # noqa: F401
