"""Seeded views with all six rigid parameters: angles spread evenly over
the configured arc, and each view's translation and tilt jitter drawn from
the seed.

Every seed gives the same angles, so the same orientation groups and the
same work; only the jitter differs.
"""

from __future__ import annotations

import numpy as np

from benchmark.inputs.views import MASK


def jittered6(cfg: dict, seed: int) -> np.ndarray:
    """``θ (V, 6)`` in float64, columns ``(tx, ty, tz, φ, α, β)``: ``φ``
    over ``[0, phi_end_deg]`` (both ends included), ``tx`` and ``tz``
    uniform in ``±shift_px``, ``α`` and ``β`` uniform in ``±angle_deg``
    (radians), ``ty`` (along the beam) 0."""
    n = cfg["n_proj"]
    rng = np.random.default_rng(seed & MASK)
    theta = np.zeros((n, 6))
    theta[:, 3] = np.linspace(0.0, np.deg2rad(cfg["phi_end_deg"]), n)
    for col, half in ((0, cfg["shift_px"]), (2, cfg["shift_px"]),
                      (4, np.deg2rad(cfg["angle_deg"])),
                      (5, np.deg2rad(cfg["angle_deg"]))):
        theta[:, col] = rng.uniform(-half, half, n)
    return theta
