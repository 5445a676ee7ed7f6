"""Host syncs per solver pair: the program's ``host_sync.*`` counters
(each a place where the host waits on the card: the solver's guard, the
operator's row copies) summed over the traced steps, divided by their
pairs."""

from benchmark.program_records import recorded


def read(run):
    rec = recorded(run)
    first, count = run.cell.mix["trace_steps"]
    pairs = sum(s.get("pairs", 0) for s in run.steps[first:first + count])
    if rec is None or not pairs:
        return None
    syncs = sum(n for name, n in rec[1].items()
                if name.startswith("host_sync."))
    return syncs / pairs
