"""Gradients through the kernels: one ``torch.autograd.Function``.

Every kernel of the port computes a map that is linear in its planes
(K4 is linear in its input and, apart, in its filter), so its backward
is another transform: the adjoint, which each wrapper names as a call of
itself or of a sibling wrapper in another mode (the inverse direction,
the other DCT type, the conjugate filter).  The backward calls that
wrapper as it stands, so on a CPU tensor it runs the plain version and
on a CUDA tensor it launches the kernel or raises, and a second
derivative goes through this Function again, as under JAX.

A wrapper enters here only when :func:`needs_grad` says so; otherwise
it runs the code it ran before, with no ``apply``, and its result has
no ``grad_fn``.  A linear map saves no tensor: the backward needs the
cotangents alone.
"""
from __future__ import annotations

import torch

from ..utils import profiling

__all__ = ["needs_grad", "linear", "bilinear"]


def needs_grad(*tensors) -> bool:
    """Whether autograd records a call on ``tensors``: grad mode is on and
    one of them (None is skipped) requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class _Map(torch.autograd.Function):
    """``op(*inputs)`` with the backward ``adjoint(*grads)``, or, for a map
    that is linear in each input apart (``keep``), ``adjoint(grads,
    inputs, needs)`` with the inputs saved and ``needs`` the inputs'
    ``needs_input_grad``."""

    @staticmethod
    def forward(ctx, op, adjoint, keep, *inputs):
        ctx.adjoint = adjoint
        ctx.keep = keep
        if keep:
            ctx.save_for_backward(*inputs)
        return op(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        with profiling.span("cfftpack.adjoint"):
            if ctx.keep:
                out = ctx.adjoint(grads, ctx.saved_tensors,
                                  ctx.needs_input_grad[3:])
            else:
                out = ctx.adjoint(*grads)
        return (None, None, None) + (out if isinstance(out, tuple)
                                     else (out,))


def linear(op, adjoint, *planes):
    """``op(*planes)`` for a map linear in its planes, recorded so that
    the backward returns ``adjoint(*grads)`` (a tensor a plane)."""
    return _Map.apply(op, adjoint, False, *planes)


def bilinear(op, adjoint, *inputs):
    """``op(*inputs)`` for a map linear in each input apart, recorded with
    the inputs saved: the backward returns ``adjoint(grads, inputs,
    needs)``, a tensor or None for each input."""
    return _Map.apply(op, adjoint, True, *inputs)
