"""Hand-written CUDA kernels with their plain PyTorch versions
(counterpart: ``math_tpu/ops``)."""
