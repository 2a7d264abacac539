"""Canonical models (counterpart: ``math_tpu/models``)."""

from math_tpu_torch.models import eight_schools, glm_logistic, gp_regression, lotka_volterra, radon  # noqa: F401
