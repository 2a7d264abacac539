"""Whether the result of a kernel Function's rule will be differentiated again.

A ``backward`` rule of ``ops/glm_fused.py`` and ``ops/chol_blocked.py`` reads
its coefficients off what the forward launch already made (the GLM kernels'
partials, the blocked factor's block inverses), and so does a ``jvp`` rule.
Those coefficients are outputs that are not differentiable.  When the rule's
result will be differentiated again (a second order: ``create_graph=True``,
``torch.func.hessian``, ``torch.func.grad`` over a ``jvp``, or autograd of
inputs that require grad around a transform) the rule takes its coefficients
from a differentiable version instead (ref: pallas_glm.py:220-237, the
level-1 ``custom_jvp``).  A first-order ``torch.func.grad`` or ``jvp`` reads
the kernel's own.
"""

from __future__ import annotations

import torch
from torch._C._functorch import TransformType
from torch._functorch.pyfunctorch import retrieve_all_functorch_interpreters

from math_tpu_torch.utils.batch import plain_tensor

_DIFFERENTIATING = (TransformType.Grad, TransformType.Jvp)


def differentiated_again(*saved):
    """True where the result of the ``backward`` or ``jvp`` rule now running
    will be differentiated again: by a differentiating ``torch.func`` level
    other than the rule's own, or by plain autograd of the unwrapped
    ``saved`` inputs (grad mode on and one of them requiring grad).  The
    rule's own level, where it is still live, is the top of the stack (a
    ``jvp`` rule, a backward under ``torch.func.grad``); the backward of a
    ``vjp`` / ``jacrev`` runs after its level has exited."""
    stack = [i.key() for i in retrieve_all_functorch_interpreters()]
    if stack and stack[-1] in _DIFFERENTIATING:
        stack.pop()
    if any(k in _DIFFERENTIATING for k in stack):
        return True
    return torch.is_grad_enabled() and any(t is not None and plain_tensor(t).requires_grad for t in saved)


def forward_levels():
    """The number of ``jvp`` levels on the ``torch.func`` stack."""
    return sum(i.key() == TransformType.Jvp for i in retrieve_all_functorch_interpreters())

