"""Layer dispatch (H2D copies and kernel enqueue: ``ops/wire``, the fronts,
the pair search, ``models/decision``): the share of job time the calling
thread spends shipping and enqueueing blocks (``phase_s["dispatch"]``)."""


def read(ctx):
    jobs = ctx["jobs"]
    wall = sum(j["job"] for j in jobs)
    if not wall:
        return None
    return sum(j["phase_s"]["dispatch"] for j in jobs) / wall
