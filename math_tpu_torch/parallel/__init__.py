"""Sharded inference over a ``torch.distributed`` mesh (counterpart: ``math_tpu/parallel``)."""

from math_tpu_torch.parallel.mesh import (  # noqa: F401
    chain_mesh,
    initialize_multihost,
    sample_nuts_sharded,
    sharded_data_logdensity,
)
