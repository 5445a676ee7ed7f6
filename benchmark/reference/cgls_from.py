"""Plain CGLS from a start ``x0`` with the divergence guard of the
program's solver, as the alternating driver runs it each outer (warm
started from the previous outer's volume).

Björck's CGLS on ‖A x − b‖ (float32 vectors, float64 scalars, as
:mod:`benchmark.reference.cgls`): ``r = b − A x0``, ``p = Aᵀ r``, ``γ =
‖p‖²``; per iteration ``q = A p``, ``α = γ / ‖q‖²``, ``x' = x + α p``,
``r' = r − α q``. The guard: from the second iteration on, where ``‖r'‖``
exceeds the previous iteration's ``‖r'‖`` by more than the slack ``tol``,
the update is dropped and the recursion restarts from ``x`` (``r = b − A
x``, ``p = Aᵀ r``), unless the previous iteration restarted too: then the
update is kept and the solve ends there.
"""

from __future__ import annotations

import torch

from benchmark.reference.cgls import sqnorm


def solve_from(A, AT, b, x0, iters: int, tol: float = 0.0):
    """``iters`` guarded CGLS iterations from ``x0``: the iterate."""
    def start(x):
        r = b - A(x).reshape(b.shape)
        p = AT(r)
        return r, p, sqnorm(p)

    x = x0.clone()
    r, p, gamma = start(x)
    prev, restarted = None, -10
    for k in range(iters):
        q = A(p).reshape(b.shape)
        alpha = gamma / sqnorm(q)
        x_new = x + alpha * p
        r_new = r - alpha * q
        conv = sqnorm(r_new) ** 0.5
        worse = prev is not None and conv > (1.0 + tol) * prev
        prev = conv
        if worse and restarted + 1 != k:
            r, p, gamma = start(x)
            restarted = k
            continue
        s = AT(r_new)
        gamma, g0 = sqnorm(s), gamma
        x, r, p = x_new, r_new, s + (gamma / g0) * p
        if worse:
            break
    return x
