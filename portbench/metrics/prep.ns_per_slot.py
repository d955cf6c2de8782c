"""Layer host block prep (``native/prep`` on the engine's prefetch pool):
host nanoseconds of block packing, summed over the pool's threads (the
engine's ``phase_s["prep"]``), per covered (cell, SNP) slot of the jobs'
libraries (``sizes[lib]["slots"]``)."""


def read(ctx):
    jobs = ctx["jobs"]
    real = sum(ctx["sizes"][j["lib"]]["slots"] for j in jobs)
    if not real or any("prep" not in j["phase_s"] for j in jobs):
        return None
    return 1e9 * sum(j["phase_s"]["prep"] for j in jobs) / real
