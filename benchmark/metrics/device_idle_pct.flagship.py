"""The device's idle share over the traced outer, in %."""

from benchmark.readers import idle_pct


def read(run):
    return idle_pct(run)
