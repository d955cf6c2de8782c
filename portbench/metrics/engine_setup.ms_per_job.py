"""Layer engine set-up (``models/engine.py``): host milliseconds a job
spends constructing the engine and its pileup (the benchmark's span), in
``run_compact``'s set-up (the engine's ``phase_s["setup"]``: wire config,
tables, blocking) and in ``cell_stats`` (the benchmark's span)."""


def read(ctx):
    jobs = ctx["jobs"]
    if not jobs:
        return None
    return 1e3 * sum(j["engine_ctor"] + j["phase_s"]["setup"]
                     + j["cell_stats"] for j in jobs) / len(jobs)
