"""Layer kernels, the exact pair route on the card: device milliseconds of
the pair search's kernels (K3' ``csrc/pair_exact.cu``, or K7'
``csrc/pair_tiled_exact.cu`` with K6' ``csrc/extras_exact.cu``: the
kernels ``pair_roofline`` reads) and of the g gather's kernel (the
``index_select`` of ``ops/front_exact.exact_pair``, which torch runs on
the card as ``aten::gather``: its gather kernel, not the scatter kernel
of the same template), from the traced window's kernel times, per 1,000
barcodes of the window's jobs."""

# each kernel whose name contains one of these
KERNELS = ("pair_exact_kernel", "pair_tiled_exact_kernel",
           "extras_exact_kernel",
           "_cuda_scatter_gather_internal_kernel<false")


def read(ctx):
    trace = ctx.get("trace")
    n = sum(j["barcodes"] for j in ctx["jobs"])
    if trace is None or not n:
        return None
    dev_s = sum(s for name, s in trace["kernel_s"].items()
                if any(k in name for k in KERNELS))
    if dev_s <= 0.0:
        return None
    return 1e3 * dev_s / (n / 1e3)
