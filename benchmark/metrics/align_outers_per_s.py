"""Alignment outers completed per second over the window: each outer is
an arc CGLS reconstruction, a batched LM refinement of every view and the
moment hook; the window closes at a job boundary, so the outers' unequal
costs (the flip rescue's) average over whole jobs."""


def read(run):
    return run.total("outers") / run.window_s
