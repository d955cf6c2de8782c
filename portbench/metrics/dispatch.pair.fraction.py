"""Layer dispatch, its exact-mode pair route (the g gather, K3' or K7'
with K6', the mirror of the symmetric plane, the decision pass and the
packing): the share of job time the calling thread spends enqueueing it
(``phase_s["dispatch.pair"]``, a span inside ``phase_s["dispatch"]``)."""


def read(ctx):
    jobs = ctx["jobs"]
    wall = sum(j["job"] for j in jobs)
    if not wall or any("dispatch.pair" not in j["phase_s"] for j in jobs):
        return None
    return sum(j["phase_s"]["dispatch.pair"] for j in jobs) / wall
