"""Layer dispatch, the front of the block step (fast mode: the count
table's ``scatter_add_``s, the LUT contraction and the pass-1 GL table;
exact mode: the K2' call): the share of job time the calling thread spends
enqueueing it (``phase_s["dispatch.front"]``, a span inside
``phase_s["dispatch"]``)."""


def read(ctx):
    jobs = ctx["jobs"]
    wall = sum(j["job"] for j in jobs)
    if not wall or any("dispatch.front" not in j["phase_s"] for j in jobs):
        return None
    return sum(j["phase_s"]["dispatch.front"] for j in jobs) / wall
