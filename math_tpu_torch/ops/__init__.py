"""Hand-written CUDA kernels with their plain PyTorch versions, and the
linear algebra, GP kernels and segment ops (counterpart: ``math_tpu/ops``;
the same package-level names but the TPU-only ``cholesky_blocked_pallas``)."""

from math_tpu_torch.ops import gp  # noqa: F401
from math_tpu_torch.ops import linalg  # noqa: F401
from math_tpu_torch.ops.linalg import *  # noqa: F401,F403
from math_tpu_torch.ops.gp import (  # noqa: F401
    gp_dot_prod_cov,
    gp_exp_quad_cov,
    gp_exponential_cov,
    gp_matern32_cov,
    gp_matern52_cov,
    gp_periodic_cov,
)
from math_tpu_torch.ops.cholesky import (  # noqa: F401
    cholesky_blocked,
    cholesky_decompose_tpu,
)
from math_tpu_torch.ops.chol_blocked import chol_inv_block  # noqa: F401
from math_tpu_torch.ops.segment import (  # noqa: F401
    onehot_matrix,
    segment_gather,
    segment_sum,
)
