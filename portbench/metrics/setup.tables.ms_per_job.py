"""Layer engine set-up, its tables: host milliseconds a job spends
building the run's device tables and placing them on the card (the
engine's ``phase_s["setup.tables"]``, a span of ``run_compact``'s
set-up)."""


def read(ctx):
    jobs = ctx["jobs"]
    if not jobs or any("setup.tables" not in j["phase_s"] for j in jobs):
        return None
    return 1e3 * sum(j["phase_s"]["setup.tables"] for j in jobs) / len(jobs)
