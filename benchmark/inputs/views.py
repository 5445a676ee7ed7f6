"""Seeded views of a configuration: angles spread evenly over the
configured arc, and each view's rigid jitter drawn from the seed.

Every seed gives the same angles, so the same orientation groups and the
same work; only the jitter differs.
"""

from __future__ import annotations

import numpy as np

# any whole seed, negative ones too, as numpy's non-negative seed
MASK = (1 << 64) - 1


def jittered(cfg: dict, seed: int):
    """``(phi (V,), t (V, 3))`` in float64: ``phi`` over ``[0,
    phi_end_deg]`` (both ends included), ``tx`` and ``tz`` uniform in
    ``±shift_px``; ``ty`` (along the beam) is 0."""
    n = cfg["n_proj"]
    rng = np.random.default_rng(seed & MASK)
    phi = np.linspace(0.0, np.deg2rad(cfg["phi_end_deg"]), n)
    t = np.zeros((n, 3))
    t[:, 0] = rng.uniform(-cfg["shift_px"], cfg["shift_px"], n)
    t[:, 2] = rng.uniform(-cfg["shift_px"], cfg["shift_px"], n)
    return phi, t
