"""Plain CGLS arithmetic (Björck's CGLS on ‖A x − b‖), one iteration at a
time, for following a solver step by step from its own state.

From ``(x, r, p, γ)`` with ``γ = ‖Aᵀr‖²``: ``q = A p``, ``α = γ / ‖q‖²``,
``x' = x + α p``, ``r' = r − α q``, ``s = Aᵀ r'``, ``β = ‖s‖² / γ``,
``p' = s + β p``. A re-initialization from ``x`` is ``r = b − A x``, ``p
= Aᵀ r``. Norms and scalars are taken in float64.
"""

from __future__ import annotations

import torch


def sqnorm(a) -> float:
    a = a.reshape(-1).double()
    return float(torch.dot(a, a))


def direction(s, p, gamma: float):
    """``p' = s + (‖s‖² / γ) p`` given ``s = Aᵀ r'``."""
    return s.double() + (sqnorm(s) / gamma) * p.double()


def solve(A, AT, b, iters: int):
    """``iters`` CGLS iterations from x = 0 (float32 vectors, float64
    scalars): the iterate."""
    r = b.clone()
    s = AT(r)
    p, gamma = s, sqnorm(s)
    x = torch.zeros_like(s)
    for _ in range(iters):
        q = A(p).reshape(r.shape)
        alpha = gamma / sqnorm(q)
        x = x + alpha * p
        r = r - alpha * q
        s = AT(r)
        gamma, g0 = sqnorm(s), gamma
        p = s + (gamma / g0) * p
    return x
