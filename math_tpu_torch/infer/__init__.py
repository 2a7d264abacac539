"""Inference: chain-batched NUTS with pooled or per-chain warmup, the
checkpointed sampler, ADVI and tempered SMC (counterpart: ``math_tpu/infer``)."""

from math_tpu_torch.infer.nuts import (  # noqa: F401
    ChainNoise,
    IntegratorState,
    LogpGrad,
    Metric,
    NutsStats,
    nuts_kernel,
)
from math_tpu_torch.infer.pooled import PooledResult, run_pooled_chains, run_pooled_chains_chunked  # noqa: F401
from math_tpu_torch.infer.sample import ChainResult, sample_nuts  # noqa: F401
from math_tpu_torch.infer.advi import ADVIResult, advi, advi_sample  # noqa: F401
from math_tpu_torch.infer.smc import SMCResult, smc_tempered, smc_tempered_stagewise  # noqa: F401
from math_tpu_torch.infer.resume import sample_nuts_checkpointed  # noqa: F401
from math_tpu_torch.infer.optimize import LaplaceResult, OptimizeResult, laplace_sample, map_estimate  # noqa: F401
from math_tpu_torch.infer.pathfinder import PathfinderResult, pathfinder  # noqa: F401
from math_tpu_torch.infer import adapt  # noqa: F401
