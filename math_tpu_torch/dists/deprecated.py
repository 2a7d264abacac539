"""Deprecated Stan 2.x-style aliases (ref: ``prim/*/prob/*_log.hpp``).

Counterpart: ``math_tpu/dists/deprecated.py``.

``<family>_log   -> <family>_lpdf / _lpmf``
``<family>_cdf_log  -> <family>_lcdf``
``<family>_ccdf_log -> <family>_lccdf``

Generated mechanically at import so alias coverage always tracks the
modern API (the reference likewise implements each ``*_log`` as a
forwarding inline function).
"""

from __future__ import annotations

from math_tpu_torch.dists import continuous, discrete, glm, more, multivariate

__all__ = []


def _register(namespace):
    g = globals()
    for name in dir(namespace):
        fn = getattr(namespace, name)
        if not callable(fn):
            continue
        alias = None
        if name.endswith("_lpdf") or name.endswith("_lpmf"):
            alias = name[: -len("_lpdf")] + "_log"
        elif name.endswith("_lcdf"):
            alias = name[: -len("_lcdf")] + "_cdf_log"
        elif name.endswith("_lccdf"):
            alias = name[: -len("_lccdf")] + "_ccdf_log"
        if alias and alias not in g:
            g[alias] = fn
            __all__.append(alias)


for _ns in (continuous, discrete, multivariate, glm, more):
    _register(_ns)
