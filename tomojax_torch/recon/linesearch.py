"""Backtracking line searches, batched over views (counterpart of
``tomojax.recon.linesearch``).

tomojax runs each search as a ``lax.while_loop`` and batches views with
``vmap``; here one host loop advances every view whose search is still
running, and a view's result is what that view alone would give (the
semantics of ``vmap`` over ``while_loop``). Each search takes

- ``f(x, idx)``: the costs (len(idx),) of the views ``idx`` (an index
  tensor into the batch) at parameters ``x`` (len(idx), P), so that only
  the views still searching are evaluated;
- ``x``, ``direction``, ``grad``: (V, P); ``f0``: (V,); ``alpha0``: a
  scalar or (V,).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class LineSearchResult(NamedTuple):
    alpha: torch.Tensor    # (V,) accepted (or last) step
    f_new: torch.Tensor    # (V,) cost at the last trial
    success: torch.Tensor  # (V,) bool
    n_evals: torch.Tensor  # (V,) int32 trials made


def _start(f0, alpha0):
    alpha = torch.broadcast_to(torch.as_tensor(alpha0, dtype=f0.dtype,
                                               device=f0.device),
                               f0.shape).clone()
    return (alpha, torch.full_like(f0, float("inf")),
            torch.zeros(f0.shape, dtype=torch.int32, device=f0.device),
            torch.zeros(f0.shape, dtype=torch.bool, device=f0.device))


def _dot(a, b):
    return (a * b).sum(-1)


def armijo(f: Callable, x, direction, grad, f0, *, alpha0=1.0, c1=1e-4,
           shrink=0.5, max_backtracks: int = 30) -> LineSearchResult:
    """Armijo backtracking: find α with f(x + α d) ≤ f0 + c1 α ⟨g, d⟩."""
    gd = _dot(grad, direction)
    alpha, f_new, n, ok = _start(f0, alpha0)
    while True:
        idx = torch.nonzero(~ok & (n < max_backtracks)).flatten()
        if idx.numel() == 0:
            break
        a = alpha[idx]
        fv = f(x[idx] + a[:, None] * direction[idx], idx)
        good = fv <= f0[idx] + c1 * a * gd[idx]
        f_new[idx] = fv
        n[idx] += 1
        ok[idx] = good
        alpha[idx] = torch.where(good, a, a * shrink)
    return LineSearchResult(alpha=alpha, f_new=f_new, success=ok, n_evals=n)


def wolfe(f: Callable, grad_f: Callable, x, direction, grad, f0, *,
          alpha0=1.0, c1=1e-4, c2=0.9, shrink=0.5,
          max_backtracks: int = 25) -> LineSearchResult:
    """Backtracking search enforcing both Wolfe conditions (sufficient
    decrease and curvature); ``grad_f(x, idx)`` returns the gradients
    (len(idx), P), one extra gradient per trial step."""
    gd = _dot(grad, direction)
    alpha, f_new, n, ok = _start(f0, alpha0)
    while True:
        idx = torch.nonzero(~ok & (n < max_backtracks)).flatten()
        if idx.numel() == 0:
            break
        a = alpha[idx]
        x_new = x[idx] + a[:, None] * direction[idx]
        fv = f(x_new, idx)
        armijo_ok = fv <= f0[idx] + c1 * a * gd[idx]
        curvature_ok = _dot(grad_f(x_new, idx), direction[idx]) >= \
            c2 * gd[idx]
        good = armijo_ok & curvature_ok
        f_new[idx] = fv
        n[idx] += 1
        ok[idx] = good
        alpha[idx] = torch.where(good, a, a * shrink)
    return LineSearchResult(alpha=alpha, f_new=f_new, success=ok, n_evals=n)


def brute_backoff(f: Callable, x, direction, f0, *, alpha0=1.0,
                  shrink=0.1, min_alpha=1e-15) -> LineSearchResult:
    """The reference's line-search failure fallback: divide the step by 10
    until the cost decreases or the step underflows."""
    alpha, f_new, n, ok = _start(f0, alpha0)
    while True:
        idx = torch.nonzero(~ok & (alpha > min_alpha)).flatten()
        if idx.numel() == 0:
            break
        a = alpha[idx] * shrink
        fv = f(x[idx] + a[:, None] * direction[idx], idx)
        alpha[idx] = a
        f_new[idx] = fv
        n[idx] += 1
        ok[idx] = fv < f0[idx]
    return LineSearchResult(alpha=alpha, f_new=f_new, success=ok, n_evals=n)
