"""Sampler state and output on disk: checkpoints, the native draw store and
CmdStan-format CSV (counterpart: ``math_tpu/io``)."""

from math_tpu_torch.io.checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint  # noqa: F401
from math_tpu_torch.io.draw_store import DrawStore, native_available, read_draws  # noqa: F401
from math_tpu_torch.io.stan_csv import read_stan_csv, write_stan_csv  # noqa: F401
