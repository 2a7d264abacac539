"""Distribution library: ``*_lpdf/_lpmf/_cdf/_lcdf/_lccdf/_rng`` free
functions under their Stan Math names (counterpart: ``math_tpu/dists``)."""

from math_tpu_torch.dists.continuous import *  # noqa: F401,F403
from math_tpu_torch.dists.discrete import *  # noqa: F401,F403
from math_tpu_torch.dists.multivariate import *  # noqa: F401,F403
from math_tpu_torch.dists.glm import *  # noqa: F401,F403
from math_tpu_torch.dists.more import *  # noqa: F401,F403
from math_tpu_torch.dists.deprecated import *  # noqa: F401,F403
