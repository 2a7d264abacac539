"""Canonical models (counterpart: ``math_tpu/models``)."""
