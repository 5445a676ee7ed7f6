"""CGLS — conjugate gradient on the normal equations, as a host loop.

Counterpart of ``tomojax.recon.cgls`` (a Python loop takes the place of
``lax.while_loop``), with the same semantics:

- classic CGLS recursion: γ = ‖Aᵀr‖², α = γ/‖Ap‖², β = γ_new/γ_old;
- divergence guard: if the residual norm rises, re-initialize (r, p, γ)
  cleanly from the current iterate; quit (``stop_reason`` 2) after
  re-initializing at two consecutive iterations;
- per-iteration metrics: residual norm (``convergence``) and RMS error
  against ground truth if given (‖x − gt‖/‖gt‖), else ‖r‖/‖b‖.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from tomojax_torch.core.operators import TomoOperator
from tomojax_torch.utils import profiling


class CGLSResult(NamedTuple):
    x: torch.Tensor            # reconstruction, vol_shape
    rms_error: torch.Tensor    # (niter,) valid up to n_iter
    convergence: torch.Tensor  # (niter,) residual norms
    n_iter: int                # iterations actually run
    stop_reason: int           # 0 = budget, 2 = double-reinit quit


@dataclasses.dataclass
class CGLSState:
    """Full CG recursion state, carried across :func:`cgls_steps` calls so
    conjugacy survives a chunked run."""

    x: torch.Tensor          # iterate, vol_shape
    r: torch.Tensor          # residual b - A x, (n_proj, n_det)
    p: torch.Tensor          # search direction, vol_shape
    gamma: torch.Tensor      # ‖Aᵀr‖², 0-d
    k: int = 0               # global iteration counter
    stop: int = 0            # 0 = running, 2 = double-reinit quit
    reinit_iter: int = -10   # iteration of the last re-initialization
    conv_prev: torch.Tensor | float = 0.0  # residual norm at k-1


def _as_b(op: TomoOperator, b):
    return torch.as_tensor(b, dtype=op.dtype, device=op.device).reshape(
        op.geom.n_proj, op.geom.n_det)


def _sqnorm(a):
    return torch.dot(a.reshape(-1), a.reshape(-1))


def _initialize(op: TomoOperator, b, x):
    r = b - op.A(x)
    p = op.AT(r)
    return r, p, _sqnorm(p)


def cgls_init(op: TomoOperator, b, x0=None) -> CGLSState:
    """Initialize (or re-initialize) the CG state from iterate ``x0``."""
    with profiling.span("cgls.init"):
        b = _as_b(op, b)
        x = (torch.zeros(op.vol_shape, dtype=op.dtype, device=op.device)
             if x0 is None else torch.as_tensor(x0, dtype=op.dtype,
                                                device=op.device)
             .reshape(op.vol_shape))
        r, p, gamma = _initialize(op, b, x)
        return CGLSState(x=x, r=r, p=p, gamma=gamma,
                         conv_prev=torch.zeros((), dtype=op.dtype,
                                               device=op.device))


@torch.no_grad()
def cgls_steps(op: TomoOperator, b, state: CGLSState, *, nsteps: int,
               niter: int, ground_truth=None, reinit_tol: float = 0.0):
    """Advance CGLS by up to ``nsteps`` iterations (``niter`` is the global
    budget).

    :returns: ``(state', conv, rms)``; ``conv``/``rms`` are ``(nsteps,)``
        tensors of this chunk's metrics, valid where ``j < state'.k -
        state.k``."""
    b = _as_b(op, b)
    gt = None if ground_truth is None else torch.as_tensor(
        ground_truth, dtype=op.dtype, device=op.device).reshape(-1)
    norm_factor = torch.linalg.norm(b if gt is None else gt)
    conv = torch.zeros((nsteps,), dtype=op.dtype, device=op.device)
    rms = torch.zeros((nsteps,), dtype=op.dtype, device=op.device)
    s = dataclasses.replace(state)
    k0 = s.k
    while s.k < niter and s.k < k0 + nsteps and s.stop == 0:
        with profiling.span("cgls.iter"):
            k = s.k
            q = op.A(s.p)
            alpha = s.gamma / _sqnorm(q)
            x_new = s.x + alpha * s.p
            r_new = s.r - alpha * q
            conv_k = torch.linalg.norm(r_new)

            worse = False
            if k > 0:
                # the iteration's one host sync: the guard's bool
                profiling.count("host_sync.cgls.guard")
                worse = bool(conv_k > (1.0 + reinit_tol) * s.conv_prev)
            consecutive = s.reinit_iter + 1 == k
            stop = 2 if (worse and consecutive) else 0
            if worse and not consecutive:
                # revert the update and restart CG from the current iterate
                r2, p2, gamma2 = _initialize(op, b, s.x)
                x2 = s.x
                reinit_iter = k
            else:
                p_new = op.AT(r_new)
                gamma_new = _sqnorm(p_new)
                beta = gamma_new / s.gamma
                x2, r2, p2 = x_new, r_new, p_new + beta * s.p
                gamma2 = gamma_new
                reinit_iter = s.reinit_iter

            if gt is None:
                rms_k = torch.linalg.norm(r2) / norm_factor
            else:
                rms_k = (torch.linalg.norm(x2.reshape(-1) - gt)
                         / norm_factor)
            conv[k - k0] = conv_k
            rms[k - k0] = rms_k
            s = CGLSState(x=x2, r=r2, p=p2, gamma=gamma2, k=k + 1,
                          stop=stop, reinit_iter=reinit_iter,
                          conv_prev=conv_k)
    return s, conv, rms


def cgls(op: TomoOperator, b, *, niter: int = 100, x0=None,
         ground_truth=None, reinit_tol: float = 0.0) -> CGLSResult:
    """Run CGLS on ``min_x ‖A x − b‖``.

    :param reinit_tol: relative slack on the divergence guard — re-initialize
        only when ``conv_k > (1 + reinit_tol) * conv_{k-1}``.
    """
    state = cgls_init(op, b, x0)
    state, conv, rms = cgls_steps(op, b, state, nsteps=niter, niter=niter,
                                  ground_truth=ground_truth,
                                  reinit_tol=reinit_tol)
    return CGLSResult(x=state.x, rms_error=rms, convergence=conv,
                      n_iter=state.k, stop_reason=state.stop)
