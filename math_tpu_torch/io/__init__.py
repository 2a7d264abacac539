"""Sampler state and output on disk: checkpoints and the native draw store
(counterpart: ``math_tpu/io``)."""

from math_tpu_torch.io.checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint  # noqa: F401
from math_tpu_torch.io.draw_store import DrawStore, native_available, read_draws  # noqa: F401
