"""Analog of Stan's ``include_summand`` constant-term pruning.

Counterpart: ``math_tpu/utils/propto.py``.  Reference behavior
(``prim/scal/meta/include_summand.hpp``): when a density is evaluated with
``propto=true``, any summand whose operands are all plain ``double``s is
dropped.  Here *host constants* (Python numbers, numpy arrays) play the role
of ``double`` and floating ``torch.Tensor``s the role of ``var``: data passed
as numpy arrays gets its constant terms pruned exactly as in the JAX package.
"""

from __future__ import annotations

import torch


def is_autodiff(x) -> bool:
    """True when ``x`` is a value that could carry gradients: a floating
    ``torch.Tensor``.  Python floats, numpy arrays and integer tensors do not
    count (ref: ``prim/scal/meta/is_constant.hpp``)."""
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def include_summand(propto: bool, *args) -> bool:
    """Whether a term depending only on ``args`` must be kept.

    ``include_summand(propto)`` with no args gates pure normalization
    constants (e.g. ``-0.5*log(2*pi)``).
    """
    if not propto:
        return True
    return any(is_autodiff(a) for a in args)
