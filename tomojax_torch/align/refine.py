"""Per-view refinement types (counterpart of ``tomojax.align.refine``).

Only the parameter-subset masks and the result type are ported; the
exact-family cost, gradient and LM of that module are ROADMAP Queue 1
item 14.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Boolean masks over (tx, ty, tz, phi, alpha, beta), one per reference
# cost/gradient wrapper pair (tomojax/align/refine.py:38).
PARAM_SETS = {
    "xzpab": (True, False, True, True, True, True),
    "xzab": (True, False, True, False, True, True),
    "xz": (True, False, True, False, False, False),
    "x": (True, False, False, False, False, False),
    "z": (False, False, True, False, False, False),
    "ab": (False, False, False, False, True, True),
    "a": (False, False, False, False, True, False),
    "b": (False, False, False, False, False, True),
    "xzb": (True, False, True, False, False, True),
    "all": (True, True, True, True, True, True),
}


class RefineResult(NamedTuple):
    theta6: torch.Tensor     # refined absolute 6-DoF parameters (n, 6)
    cost: torch.Tensor       # final ½‖residual‖² per view (n,)
    n_iter: torch.Tensor     # iterations run per view
    converged: torch.Tensor  # per-view flag
