"""Layer readback (the D2H wait and ``decision.unpack_block``): the share
of job time the calling thread spends in the one readback, which waits for
the device, and in unpacking (``phase_s["fetch"]``)."""


def read(ctx):
    jobs = ctx["jobs"]
    wall = sum(j["job"] for j in jobs)
    if not wall:
        return None
    return sum(j["phase_s"]["fetch"] for j in jobs) / wall
