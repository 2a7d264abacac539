"""Small helpers shared by every layer (counterpart: ``math_tpu/utils``)."""
