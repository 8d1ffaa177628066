"""Sums of terms into indexed targets in a fixed order: the port's
``index_add_`` off the CPU.

``index_add_`` on a CUDA tensor adds with atomics, whose order changes from
run to run, so a target of three or more terms can come out with other last
bits in the next run.  On the CPU ``index_add_`` adds the terms one after
another in stored order.  :func:`scatter_sum` and :func:`scatter_add_` are
``index_add_`` on the CPU and, on any other device, add each target's terms
in that same order without atomics (one gather and one add a term slot of
the target with the most terms, :class:`SumPlan`), so every run gives the
CPU's bits.  A plan depends on the indices alone: callers build it once per
matrix or plan and keep it (:func:`cached`).
"""

from __future__ import annotations

import dataclasses
import weakref

import torch

__all__ = [
    "SumPlan",
    "cached",
    "fixed_order",
    "ordered_add_",
    "ordered_sum",
    "scatter_add_",
    "scatter_sum",
    "sum_plan",
]


@dataclasses.dataclass(frozen=True)
class SumPlan:
    """How terms add into their targets: ``order`` sorts the terms by
    target, stably (None when they already are); ``targets`` are the
    targets with at least one term, most terms first; ``first`` the sorted
    position of each one's first term; ``widths[j]`` how many of them have
    more than j terms."""

    order: torch.Tensor | None
    targets: torch.Tensor
    first: torch.Tensor
    widths: tuple


def sum_plan(index, device) -> SumPlan:
    """The :class:`SumPlan` of terms whose targets are ``index`` (a host
    array or a tensor), on ``device``."""
    t = torch.as_tensor(index).to(device=device, dtype=torch.int64).reshape(-1)
    order = None
    if t.numel() > 1 and bool((t[1:] < t[:-1]).any()):
        t, order = torch.sort(t, stable=True)
    targets, counts = torch.unique_consecutive(t, return_counts=True)
    first = torch.cumsum(counts, 0) - counts
    counts, by_count = torch.sort(counts, descending=True, stable=True)
    # widths[j] = targets with more than j terms
    widths = torch.bincount(counts).flip(0).cumsum(0).flip(0)[1:] if counts.numel() else counts
    return SumPlan(order=order, targets=targets[by_count], first=first[by_count],
                   widths=tuple(widths.tolist()))


def fixed_order(device) -> bool:
    """True where :func:`scatter_sum` and :func:`scatter_add_` take the
    fixed-order sum: every device but the CPU."""
    return torch.device(device).type != "cpu"


def _ordered(src, plan: SumPlan, acc):
    """acc[r] + the terms of plan.targets[r], one after another in stored
    order."""
    if plan.order is not None:
        src = src[plan.order]
    for j, w in enumerate(plan.widths):
        acc[:w] += src[plan.first[:w] + j]
    return acc


def ordered_sum(src, plan: SumPlan, length):
    """The fixed-order sum into ``length`` zero rows, on any device."""
    out = src.new_zeros((length,) + tuple(src.shape[1:]))
    acc = src.new_zeros((plan.targets.numel(),) + out.shape[1:])
    out[plan.targets] = _ordered(src, plan, acc)
    return out


def ordered_add_(out, src, plan: SumPlan):
    """The fixed-order sum into ``out``'s rows, in place, on any device."""
    out[plan.targets] = _ordered(src, plan, out[plan.targets])
    return out


def scatter_sum(src, index, length, plan: SumPlan | None = None):
    """out[t] = the sum of the rows of ``src`` whose ``index`` is t, added
    one after another from zero in stored order; ``length`` rows.  On the
    CPU ``torch.zeros(...).index_add_(0, index, src)``; elsewhere
    :func:`ordered_sum` with ``plan`` (built from ``index`` when None),
    which gives the CPU's bits."""
    if not fixed_order(src.device):
        shape = (length,) + tuple(src.shape[1:])
        return torch.zeros(shape, dtype=src.dtype, device=src.device).index_add_(0, index, src)
    return ordered_sum(src, sum_plan(index, src.device) if plan is None else plan, length)


def scatter_add_(out, index, src, plan: SumPlan | None = None):
    """``out.index_add_(0, index, src)`` in place and returned: each
    target's value, then its terms one after another in stored order.  On
    the CPU ``index_add_`` itself; elsewhere :func:`ordered_add_` with
    ``plan`` (built from ``index`` when None), which gives the CPU's
    bits."""
    if not fixed_order(out.device):
        return out.index_add_(0, index, src)
    return ordered_add_(out, src, sum_plan(index, out.device) if plan is None else plan)


_CACHE: dict = {}


def cached(tensors, key, build):
    """``build()``, computed once for these tensors (by identity, while
    they live) and ``key``: for plans of a plan's or a matrix's own index
    arrays, which are never written after they are made."""
    ident = tuple(id(t) for t in tensors) + tuple(key)
    hit = _CACHE.get(ident)
    if hit is not None and all(r() is t for r, t in zip(hit[0], tensors)):
        return hit[1]
    value = build()
    refs = [weakref.ref(t, lambda _, i=ident: _CACHE.pop(i, None)) for t in tensors]
    _CACHE[ident] = (refs, value)
    return value
