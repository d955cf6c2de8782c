"""Layer H2D wire (``host/wire.py``, ``native/prep``): bytes the engine
ships to the device per barcode (its ``h2d_bytes`` counter)."""


def read(ctx):
    jobs = ctx["jobs"]
    n = sum(j["barcodes"] for j in jobs)
    return sum(j["h2d_bytes"] for j in jobs) / n if n else None
