"""L1-regularized least squares (lasso) by ISTA and accelerated ISTA
(counterpart of ``tomojax.recon.lasso``):

    x* = argmin ½‖Ax − b‖² + λ‖x‖₁

Per iteration: the gradient of the fidelity term, a proximal backtracking
search (the Beck–Teboulle majorization test ``g ≤ g0 − ⟨∇g0, Gt⟩ +
‖Gt‖²/(2t)``), the soft-threshold prox, optionally Nesterov momentum
``v = x1 + (k−2)/(k+1)(x1 − x0)`` from iterates ``x0``/``x1`` that start
at zero (not at ``x0=``), and the semi-convergence stop from the third
iteration on. These follow tomojax's behaviour exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tomojax_torch.core.operators import TomoOperator
from tomojax_torch.recon.tikhonov import _dot, _setup


class LassoResult(NamedTuple):
    x: torch.Tensor
    rms_error: torch.Tensor
    convergence: torch.Tensor
    step_size: torch.Tensor
    n_iter: int
    stop_reason: int  # 0 budget, 1 semi-convergence, 3 ls failure


def soft_thresholding(x, lam):
    """sgn(x)·max(|x| − λ, 0)."""
    return torch.sign(x) * (x.abs() - lam).clamp_min(0.0)


def _backtrack(op, b, x, grad, g0, lam, t0, shrink, min_t=1e-16):
    """Proximal backtracking: the first trial at ``t0``; after a failure
    the loop starts at ``t0·shrink`` and shrinks while the test fails and
    ``t > min_t``. Returns ``(x_prox, t, success)``."""
    def trial(t):
        xp = soft_thresholding(x - t * grad, t * lam)
        Gt = x - xp
        r = op.A(xp) - b
        g = 0.5 * _dot(r, r)
        gp = g0 - _dot(grad, Gt) + (0.5 / t) * _dot(Gt, Gt)
        return xp, bool(g <= gp)

    t = torch.as_tensor(t0, dtype=x.dtype, device=x.device)
    xp, ok = trial(t)
    if not ok:
        t = t * shrink
    while not ok and bool(t > min_t):
        xp, ok = trial(t)
        if not ok:
            t = t * shrink
    return xp, t, ok


def _lasso(op: TomoOperator, b, *, niter, reg_param, alpha0, shrink, x0,
           ground_truth, accelerated: bool) -> LassoResult:
    b, x, gt, norm_factor = _setup(op, b, x0, ground_truth)
    lam = torch.as_tensor(reg_param, dtype=op.dtype, device=op.device)
    x_prev = x_last = torch.zeros_like(x)
    conv = torch.zeros((niter,), dtype=op.dtype, device=op.device)
    rms, steps = torch.zeros_like(conv), torch.zeros_like(conv)
    k, stop = 0, 0
    while k < niter and stop == 0:
        res = op.A(x) - b
        grad = op.AT(res)
        _, t, ok = _backtrack(op, b, x, grad, 0.5 * _dot(res, res), lam,
                              alpha0, shrink)
        if accelerated:
            v = x_last + (k - 2.0) / (k + 1.0) * (x_last - x_prev)
            x = soft_thresholding(v - t * grad, t * lam)
            x_prev, x_last = x_last, x
        else:
            x = soft_thresholding(x - t * grad, t * lam)
        conv[k] = torch.linalg.norm(res)
        rms[k] = (conv[k] / norm_factor if gt is None
                  else torch.linalg.norm(x.reshape(-1) - gt) / norm_factor)
        steps[k] = t
        semi = 1 if (k > 1 and bool(rms[k] > rms[k - 1])) else 0
        stop = max(semi, 0 if ok else 3)
        k += 1
    return LassoResult(x=x, rms_error=rms, convergence=conv, step_size=steps,
                       n_iter=k, stop_reason=stop)


@torch.no_grad()
def lasso_ista(op: TomoOperator, b, *, niter: int = 100,
               reg_param: float = 1.0, alpha0: float = 1.0,
               shrink: float = 0.5, x0=None, ground_truth=None
               ) -> LassoResult:
    """Plain ISTA."""
    return _lasso(op, b, niter=niter, reg_param=reg_param, alpha0=alpha0,
                  shrink=shrink, x0=x0, ground_truth=ground_truth,
                  accelerated=False)


@torch.no_grad()
def lasso_fista(op: TomoOperator, b, *, niter: int = 100,
                reg_param: float = 1.0, alpha0: float = 1.0,
                shrink: float = 0.5, x0=None, ground_truth=None
                ) -> LassoResult:
    """Accelerated ISTA."""
    return _lasso(op, b, niter=niter, reg_param=reg_param, alpha0=alpha0,
                  shrink=shrink, x0=x0, ground_truth=ground_truth,
                  accelerated=True)
