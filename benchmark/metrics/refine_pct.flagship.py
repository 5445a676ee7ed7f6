"""The refinement's share of the traced outer, in %: the program's
``align.refine`` span (the exact LM of every view, ending in a host sync,
so its device work is inside) over its ``align.outer`` span less the
``align.callback`` inside it (where the benchmark holds the job between
steps)."""

from benchmark.program_records import recorded


def read(run):
    rec = recorded(run)
    if rec is None:
        return None
    spans = rec[0]
    outer = sum(s.t1 - s.t0 for s in spans if s.name == "align.outer")
    held = sum(s.t1 - s.t0 for s in spans if s.name == "align.callback")
    refine = sum(s.t1 - s.t0 for s in spans if s.name == "align.refine")
    if outer - held <= 0:
        return None
    return 100.0 * refine / (outer - held)
