"""Host microseconds per view registered by the CC chain: the program's
``cc.view`` spans in the traced chain (correlation, upsampled-DFT
refinement and Fourier shift of one view, under the profiler) over its
``cc.views`` counter."""

from benchmark.program_records import recorded


def read(run):
    rec = recorded(run)
    if rec is None:
        return None
    spans, counters = rec
    views = counters.get("cc.views", 0)
    if not views:
        return None
    return 1e6 * sum(s.t1 - s.t0 for s in spans if s.name == "cc.view") / views
