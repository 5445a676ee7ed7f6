"""TV-regularized reconstruction by FISTA forward–backward splitting
(counterpart of ``tomojax.recon.fista_tv``):

    x* = argmin ½‖Ax − b‖² + β_tv · TV(x)

Per iteration:

1. gradient step  x_tmp = x + γ Aᵀ(b − A x),  γ = 1/hyper;
2. TV prox        u = denoise_fista(x_tmp, γ β_tv, niter_tv);
3. momentum       t ← (1 + √(1+4t²))/2,  x = u + (t_old−1)/t (u − u_old);

and the semi-convergence stop from the second iteration on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tomojax_torch.core.operators import TomoOperator
from tomojax_torch.recon import tv
from tomojax_torch.recon.tikhonov import _dot, _setup


class FistaTVResult(NamedTuple):
    x: torch.Tensor
    rms_error: torch.Tensor
    total_cost: torch.Tensor
    data_fidelity: torch.Tensor
    n_iter: int
    stop_reason: int  # 0 budget, 1 semi-convergence


@torch.no_grad()
def estimate_lipschitz(op: TomoOperator, n_power_iter: int = 12,
                       seed: int = 0):
    """‖AᵀA‖₂ by power iteration, from a standard normal start drawn by a
    CPU ``torch.Generator`` seeded with ``seed`` and moved to the
    operator's device, so that every device starts from the same vector
    (tomojax draws from ``jax.random.PRNGKey(seed)``, another stream).

    :returns: 0-d tensor in the operator's dtype.
    """
    gen = torch.Generator().manual_seed(seed)
    v = torch.randn(op.vol_shape, generator=gen, dtype=op.dtype
                    ).to(op.device)
    for _ in range(n_power_iter):
        v = op.AT(op.A(v / torch.linalg.norm(v)))
    return torch.linalg.norm(v)


@torch.no_grad()
def fista_tv(op: TomoOperator, b, *, niter: int = 100,
             hyper: float | None = 1e4, beta_tv: float = 1.0,
             niter_tv: int = 20, x0=None, ground_truth=None
             ) -> FistaTVResult:
    """``hyper=None`` sets the step to 1/(1.05·‖AᵀA‖) by power iteration;
    otherwise γ = 1/hyper."""
    dt = op.dtype
    if hyper is None:
        hyper = 1.05 * estimate_lipschitz(op)
    b, x, gt, norm_factor = _setup(op, b, x0, ground_truth)
    gamma = torch.as_tensor(1.0 / hyper, dtype=dt, device=op.device)
    beta = torch.as_tensor(beta_tv, dtype=dt, device=op.device)
    u_old = x
    t = torch.ones((), dtype=dt, device=op.device)
    rms = torch.zeros((niter,), dtype=dt, device=op.device)
    total, fid = torch.zeros_like(rms), torch.zeros_like(rms)
    k, stop = 0, 0
    while k < niter and stop == 0:
        res = b - op.A(x)
        u = tv.denoise_fista(x + gamma * op.AT(res), weight=gamma * beta,
                             niter=niter_tv)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        x = u + (t - 1.0) / t_new * (u - u_old)
        u_old, t = u, t_new
        fid[k] = 0.5 * _dot(res, res)
        total[k] = fid[k] + beta * tv.tv_norm_3d(x)
        rms[k] = (torch.sqrt(2.0 * fid[k]) / norm_factor if gt is None
                  else torch.linalg.norm(x.reshape(-1) - gt) / norm_factor)
        stop = 1 if (k > 0 and bool(rms[k] > rms[k - 1])) else 0
        k += 1
    return FistaTVResult(x=x, rms_error=rms, total_cost=total,
                         data_fidelity=fid, n_iter=k, stop_reason=stop)
