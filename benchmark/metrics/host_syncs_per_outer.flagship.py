"""Host syncs per alignment outer: the program's ``host_sync.*`` counters
(each a place where the host waits on the card: SIRT's stop rule, the
LM's active views and solves, the ray setup's host copies, the driver's
bounds and moments) summed over the traced outer, divided by its
outers."""

from benchmark.program_records import recorded


def read(run):
    rec = recorded(run)
    first, count = run.cell.mix["trace_steps"]
    outers = sum(s.get("outers", 0) for s in run.steps[first:first + count])
    if rec is None or not outers:
        return None
    syncs = sum(n for name, n in rec[1].items()
                if name.startswith("host_sync."))
    return syncs / outers
