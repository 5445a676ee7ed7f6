"""The refinement's share of the alignment outers, in %: the program's
``align.refine`` spans (the batched LM and the flip rescue, each ending in
a host sync, so its device work is inside) over its ``align.outer`` spans
in the traced job."""

from benchmark.program_records import recorded


def read(run):
    rec = recorded(run)
    if rec is None:
        return None
    spans = rec[0]
    outer = sum(s.t1 - s.t0 for s in spans if s.name == "align.outer")
    refine = sum(s.t1 - s.t0 for s in spans if s.name == "align.refine")
    if outer <= 0:
        return None
    return 100.0 * refine / outer
