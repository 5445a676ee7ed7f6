"""The solver's adjoint applies (K2, or K2b) as a share of the plane
apply's roofline, from CUDA events around each apply."""

from benchmark.readers import apply_roofline_pct


def read(run):
    return apply_roofline_pct(run, "AT_ms", "plane")
