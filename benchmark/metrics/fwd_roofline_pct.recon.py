"""The solver's forward applies (K1, or K1b) as a share of the plane
apply's roofline, from CUDA events around each apply."""

from benchmark.readers import apply_roofline_pct


def read(run):
    return apply_roofline_pct(run, "A_ms", "plane")
