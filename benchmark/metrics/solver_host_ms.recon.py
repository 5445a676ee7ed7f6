"""Milliseconds per solver pair outside its forward and adjoint: the
window's time per pair (less the trace's reduction) less the mean
CUDA-event time of its applies."""


def read(run):
    a, at = run.extra.get("A_ms"), run.extra.get("AT_ms")
    pairs = run.total("pairs")
    if not a or not at or not pairs:
        return None
    busy_ms = 1e3 * (run.window_s - run.total("pause_s"))
    return (busy_ms - sum(a) - sum(at)) / pairs
