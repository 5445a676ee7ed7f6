"""The program's own spans and counters in a traced run, for the readers
of per-layer metrics: what ``tomojax_torch.utils.profiling`` recorded
while the harness's profiler ran, which is the traced steps alone."""

from __future__ import annotations


def recorded(run):
    """``(spans, counters)`` that ``tomojax_torch.utils.profiling.records``
    gives for ``run``'s traced steps, or None: where the trace holds no
    device time (a CPU run, in which the host waits on no card), where the
    program has no recorder, or where it recorded nothing."""
    tr = run.trace
    if not tr or tr["busy_s"] <= 0:
        return None
    from tomojax_torch.utils import profiling

    records = getattr(profiling, "records", None)
    if records is None:
        return None
    spans, counters = records()
    if not spans and not counters:
        return None
    return spans, counters

