"""Relative distances of a program's output from the reference's, in
float64."""

from __future__ import annotations

import torch


def rel(got, want) -> float:
    """``‖got − want‖ / ‖want‖`` in float64."""
    d = (got.double() - want.double()).reshape(-1)
    return float(torch.linalg.norm(d) / torch.linalg.norm(want.double()))


def worst_row_rel(got, want) -> float:
    """The largest :func:`rel` over the rows (views) of two ``(V, ...)``
    arrays."""
    g = got.reshape(got.shape[0], -1).double()
    w = want.reshape(want.shape[0], -1).double()
    num = torch.linalg.norm(g - w, dim=1)
    den = torch.linalg.norm(w, dim=1)
    return float((num / den).max())
