"""Projections through the solver per second: views × forward-adjoint
pairs completed over the window's seconds."""


def read(run):
    return run.total("proj") / run.window_s
