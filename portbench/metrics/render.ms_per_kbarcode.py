"""Layer render (``models/outputs.py`` and ``native/render``): host
milliseconds of the benchmark's span around ``write_single`` and
``write_pass2_compact`` per 1,000 barcodes rendered."""


def read(ctx):
    jobs = ctx["jobs"]
    n = sum(j["barcodes"] for j in jobs)
    return 1e3 * sum(j["render"] for j in jobs) / (n / 1e3) if n else None
