"""Distribution library: ``*_lpdf/_lpmf/_cdf/_lcdf/_lccdf/_rng`` free
functions under their Stan Math names (counterpart: ``math_tpu/dists``)."""

from math_tpu_torch.dists.continuous import *  # noqa: F401,F403
from math_tpu_torch.dists.discrete import *  # noqa: F401,F403
from math_tpu_torch.dists.multivariate import *  # noqa: F401,F403
from math_tpu_torch.dists.glm import *  # noqa: F401,F403
from math_tpu_torch.dists.more import *  # noqa: F401,F403
from math_tpu_torch.dists.deprecated import *  # noqa: F401,F403

# The helpers the JAX package's namespace carries through its star imports.
from math_tpu_torch.dists._util import (  # noqa: F401,E402
    bcast,
    fdtype,
    finish,
    finish_prod,
    ok_ordered,
    ok_pos,
    ok_simplex,
    safe,
)
from math_tpu_torch.special import inc_beta, lbeta, lchoose, log1m, log1m_exp, log_diff_exp, log_i0, owens_t  # noqa: F401,E402
from math_tpu_torch.utils.propto import include_summand  # noqa: F401,E402
