"""math_tpu_torch — the PyTorch/CUDA port of ``math_tpu``.

A second package beside the JAX package, which stays the reference.  Module
names mirror ``math_tpu`` one to one so a reader finds the counterpart
(``math_tpu_torch/infer/nuts.py`` <-> ``math_tpu/infer/nuts.py``); inside,
the code is plain PyTorch: functions on tensors, an explicit device, an
explicit ``torch.Generator``, ``torch.autograd.Function`` around each
hand-written CUDA kernel.

Chain-batched convention (there is no ``vmap`` here): every parameter block
carries a LEADING chain axis; ``LogDensity.logp`` maps ``(C, dim) -> (C,)``;
the gradient is ``torch.autograd.grad(logp.sum(), z)`` because chains are
independent.  Densities keep the JAX names and signatures and add one
keyword, ``batch_ndims=0``: the sum runs over all axes after the first
``batch_ndims``.

Entry points run on the GPU unless the caller asks for the CPU
(``device=`` argument, default ``get_config().device == "cuda"``).

Layout:

- ``math_tpu_torch.special``     — scalar special functions (``special/basic.py``)
- ``math_tpu_torch.transforms``  — constraint transforms (every class of ``math_tpu``)
- ``math_tpu_torch.dists``       — log densities
- ``math_tpu_torch.ops``         — hand-written CUDA kernels + their plain versions
- ``math_tpu_torch.model``       — log-density program layer
- ``math_tpu_torch.infer``       — chain-batched NUTS (pooled or per-chain warmup,
  checkpointed), ADVI, tempered SMC
- ``math_tpu_torch.io``          — checkpoints and the native draw store
- ``math_tpu_torch.diagnostics`` — ESS / R-hat
- ``math_tpu_torch.convert``     — data and sampler state shared with ``math_tpu``
- ``math_tpu_torch.functional``  — higher-order AD entry points on ``torch.func``;
  ``stan`` the flat Stan-Math names; ``testing`` the finite-difference AD harness
"""

__version__ = "0.1.0"

from math_tpu_torch import special  # noqa: F401
from math_tpu_torch import transforms  # noqa: F401
from math_tpu_torch import dists  # noqa: F401
from math_tpu_torch.config import get_config, update_config  # noqa: F401
from math_tpu_torch.utils.propto import include_summand, is_autodiff  # noqa: F401
