"""Views registered by the cross-correlation chain per second over the
window."""


def read(run):
    return run.total("views") / run.window_s
