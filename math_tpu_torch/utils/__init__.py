"""Small helpers shared by every layer (counterpart: ``math_tpu/utils``)."""

from math_tpu_torch.utils.propto import include_summand, is_autodiff  # noqa: F401
