"""Tikhonov-regularized least squares by gradient descent with a line
search (counterpart of ``tomojax.recon.tikhonov``):

    x* = argmin ½‖Ax − b‖² + ½λ‖x‖²

Per iteration: the gradient Aᵀ(Ax − b) + λx, an Armijo (or Wolfe) search
on the exact objective, an optional positivity clamp, and the
semi-convergence stop (from the third iteration on, quit as soon as the
RMS error rises). On a failed search ``fail_alpha=None`` stops
(``stop_reason`` 3) and a float takes that step instead. The searches are
``recon.linesearch``'s, with one row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tomojax_torch.core.operators import TomoOperator
from tomojax_torch.recon.linesearch import armijo, wolfe


class TikhonovResult(NamedTuple):
    x: torch.Tensor
    rms_error: torch.Tensor
    convergence: torch.Tensor
    n_iter: int
    stop_reason: int  # 0 budget, 1 semi-convergence, 3 ls failure


def _setup(op: TomoOperator, b, x0, ground_truth):
    """``(b, x, gt, norm_factor)`` on the operator's dtype and device."""
    kw = dict(dtype=op.dtype, device=op.device)
    b = torch.as_tensor(b, **kw).reshape(op.geom.n_proj, op.geom.n_det)
    x = (torch.zeros(op.vol_shape, **kw) if x0 is None
         else torch.as_tensor(x0, **kw).reshape(op.vol_shape))
    gt = (None if ground_truth is None
          else torch.as_tensor(ground_truth, **kw).reshape(-1))
    return b, x, gt, torch.linalg.norm(b if gt is None else gt)


def _dot(a, b):
    return (a * b).sum()


@torch.no_grad()
def tikhonov_gd(op: TomoOperator, b, *, niter: int = 100,
                reg_param: float = 1.0, positivity: bool = False, x0=None,
                ground_truth=None, fail_alpha: float | None = None,
                step_search: str = "armijo") -> TikhonovResult:
    """Run Tikhonov gradient descent for up to ``niter`` iterations.

    :param step_search: ``"armijo"`` or ``"wolfe"`` (one extra gradient
        per trial step).
    """
    b, x, gt, norm_factor = _setup(op, b, x0, ground_truth)
    lam = torch.as_tensor(reg_param, dtype=op.dtype, device=op.device)
    shape = op.vol_shape

    def objective(xs, idx):
        x1 = xs.reshape(shape)
        r = op.A(x1) - b
        return (0.5 * (_dot(r, r) + lam * _dot(x1, x1))).reshape(1)

    def objective_grad(xs, idx):
        x1 = xs.reshape(shape)
        return (op.AT(op.A(x1) - b) + lam * x1).reshape(1, -1)

    conv = torch.zeros((niter,), dtype=op.dtype, device=op.device)
    rms = torch.zeros_like(conv)
    k, stop = 0, 0
    while k < niter and stop == 0:
        res = b - op.A(x)
        grad = -op.AT(res) + lam * x
        f0 = (0.5 * (_dot(res, res) + lam * _dot(x, x))).reshape(1)
        row = (x.reshape(1, -1), -grad.reshape(1, -1), grad.reshape(1, -1))
        if step_search == "wolfe":
            ls = wolfe(objective, objective_grad, *row, f0)
        else:
            ls = armijo(objective, *row, f0)
        ok = bool(ls.success[0])
        alpha = ls.alpha[0] if ok or fail_alpha is None else fail_alpha
        ls_stop = 3 if not ok and fail_alpha is None else 0
        x = x - alpha * grad
        if positivity:
            x = x.clamp_min(0.0)
        conv[k] = torch.linalg.norm(res)
        rms[k] = (conv[k] / norm_factor if gt is None
                  else torch.linalg.norm(x.reshape(-1) - gt) / norm_factor)
        semi = 1 if (k > 1 and bool(rms[k] > rms[k - 1])) else 0
        stop = max(semi, ls_stop)
        k += 1
    return TikhonovResult(x=x, rms_error=rms, convergence=conv, n_iter=k,
                          stop_reason=stop)
