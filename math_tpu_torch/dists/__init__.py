"""Log densities (counterpart: ``math_tpu/dists``)."""

from math_tpu_torch.dists.continuous import *  # noqa: F401,F403
from math_tpu_torch.dists.discrete import *  # noqa: F401,F403
from math_tpu_torch.dists.glm import *  # noqa: F401,F403
from math_tpu_torch.dists.multivariate import *  # noqa: F401,F403
