"""SIRT — simultaneous iterative reconstruction, as a host loop.

Counterpart of ``tomojax.recon.sirt``. The update is

    x ← x + V ⊙ Aᵀ(W ⊙ (b − A x))

with W = 1/(A·1), V = 1/(Aᵀ·1) computed matrix-free (zero sums invert to
zero), an optional positivity clamp, and the semi-convergence stop: quit
(``stop_reason`` 1) as soon as the RMS error rises. Spans: ``sirt.init``
(the two sums), ``sirt.iter`` per iteration; the stop rule's read of the
error is the host sync ``host_sync.sirt.stop``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tomojax_torch.core.operators import TomoOperator
from tomojax_torch.utils import profiling


class SIRTResult(NamedTuple):
    x: torch.Tensor
    rms_error: torch.Tensor
    convergence: torch.Tensor
    n_iter: int
    stop_reason: int  # 0 = budget, 1 = semi-convergence


def _safe_inv(a):
    zero = a == 0.0
    return torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, a))


@torch.no_grad()
def sirt(op: TomoOperator, b, *, niter: int = 100, x0=None,
         ground_truth=None, positivity: bool = False) -> SIRTResult:
    """Run SIRT for up to ``niter`` iterations."""
    dev, dt = op.device, op.dtype
    b = torch.as_tensor(b, dtype=dt, device=dev).reshape(op.geom.n_proj,
                                                         op.geom.n_det)
    x = (torch.zeros(op.vol_shape, dtype=dt, device=dev) if x0 is None
         else torch.as_tensor(x0, dtype=dt, device=dev).reshape(op.vol_shape))
    gt = None if ground_truth is None else torch.as_tensor(
        ground_truth, dtype=dt, device=dev).reshape(-1)
    norm_factor = torch.linalg.norm(b if gt is None else gt)

    with profiling.span("sirt.init"):
        W = _safe_inv(op.row_sums())   # (n_proj, n_det)
        V = _safe_inv(op.col_sums())   # vol_shape
    conv = torch.zeros((niter,), dtype=dt, device=dev)
    rms = torch.zeros((niter,), dtype=dt, device=dev)
    k, stop = 0, 0
    while k < niter and stop == 0:
        with profiling.span("sirt.iter"):
            res = b - op.A(x)
            x = x + V * op.AT(W * res)
            if positivity:
                x = torch.clamp_min(x, 0.0)
            conv[k] = torch.linalg.norm(res)
            if gt is None:
                rms[k] = conv[k] / norm_factor
            else:
                rms[k] = torch.linalg.norm(x.reshape(-1) - gt) / norm_factor
            if k > 0:
                profiling.count("host_sync.sirt.stop")
                stop = 1 if bool(rms[k] > rms[k - 1]) else 0
            k += 1
    return SIRTResult(x=x, rms_error=rms, convergence=conv, n_iter=k,
                      stop_reason=stop)
