"""Layer engine set-up, its passes over all observations: host
milliseconds a job spends in ``n_snps_all`` and in the wire-v2 config's
code pass (the engine's ``phase_s["setup.nsnp"]`` and
``phase_s["setup.wire_cfg"]``, spans of ``run_compact``'s set-up)."""

KEYS = ("setup.nsnp", "setup.wire_cfg")


def read(ctx):
    jobs = ctx["jobs"]
    if not jobs or any(k not in j["phase_s"] for j in jobs for k in KEYS):
        return None
    return 1e3 * sum(j["phase_s"][k] for j in jobs for k in KEYS) / len(jobs)
