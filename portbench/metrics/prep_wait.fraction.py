"""Layer host block prep (``native/prep`` on the engine's prefetch pool):
the share of job time the calling thread waits for a prepared block
(``phase_s["prep_wait"]``)."""


def read(ctx):
    jobs = ctx["jobs"]
    wall = sum(j["job"] for j in jobs)
    if not wall:
        return None
    return sum(j["phase_s"]["prep_wait"] for j in jobs) / wall
