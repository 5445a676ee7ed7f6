"""Plain SIRT from a start ``x0``, as the alternating driver runs it each
outer (warm started from the previous outer's volume), with positivity and
the semi-convergence stop on the data's residual.

The published update (the reference project's ``sirt``): ``W = 1/(A·1)``
and ``V = 1/(Aᵀ·1)`` (a zero sum inverts to zero); per iteration ``k`` the
residual ``r = b − A x`` and ``x ← max(x + V ⊙ Aᵀ(W ⊙ r), 0)``; with no
ground truth its error is ``e_k = ‖r‖ / ‖b‖``, and the solve stops after
the first iteration ``k > 0`` whose ``e_k`` exceeds ``e_{k−1}`` (that
iteration's update kept).

:func:`iterates` runs every one of ``iters`` iterations, past the stop,
and yields each iterate with its error, so that a caller can read the
iterate at any count; :func:`stop_count` gives the count at which the
stop rule ends the solve. ``rounding`` (identity by default) is applied to
every vector the recursion makes, which computes it in a lower precision.
This file imports nothing of the program.
"""

from __future__ import annotations

import torch


def _safe_inv(a):
    zero = a == 0.0
    return torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, a))


def iterates(A, AT, b, x0, iters: int, positivity: bool = True,
             rounding=lambda t: t):
    """Yield ``(n, x_n, e_{n−1})`` for ``n = 1 … iters``: the iterate after
    ``n`` updates and the error of the residual that update read."""
    q = rounding
    ones_x = torch.ones_like(x0)
    W = q(_safe_inv(q(A(ones_x)).reshape(b.shape)))
    V = q(_safe_inv(q(AT(torch.ones_like(b))).reshape(x0.shape)))
    norm_b = torch.linalg.norm(b)
    x = q(x0)
    for n in range(1, iters + 1):
        res = q(b - q(A(x)).reshape(b.shape))
        x = q(x + q(V * q(AT(q(W * res))).reshape(x0.shape)))
        if positivity:
            x = torch.clamp_min(x, 0.0)
        yield n, x, float(torch.linalg.norm(res) / norm_b)


def stop_count(errors) -> int:
    """The number of iterations after which the stop rule ends a solve
    whose errors are ``errors`` (all of them where it never fires)."""
    for k in range(1, len(errors)):
        if errors[k] > errors[k - 1]:
            return k + 1
    return len(errors)
