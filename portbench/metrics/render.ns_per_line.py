"""Layer render (``models/outputs.py`` and ``native/render``): host
nanoseconds of the benchmark's span around ``write_single`` and
``write_pass2_compact`` per line written. A barcode that covers a SNP
(every barcode the generator makes) has V lines in .single and in .sing2
and one in .best, and each file has a header: the one render figure that
compares pools of different sizes."""


def read(ctx):
    jobs = ctx["jobs"]
    V = ctx["config"]["donors"]
    lines = sum(j["barcodes"] * (2 * V + 1) + 3 for j in jobs)
    return 1e9 * sum(j["render"] for j in jobs) / lines if jobs else None
