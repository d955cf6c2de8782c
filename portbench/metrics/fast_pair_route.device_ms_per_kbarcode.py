"""Layer kernels, the fast pair route on the card: device milliseconds of
the fast pair search's kernels (K1 ``csrc/pair_fast.cu``, or K5'
``csrc/pair_tiled_fast.cu`` with K4' ``csrc/extras_fast.cu``: the kernels
``fast_pair_roofline`` reads) and of the g gather's kernel (the
``index_select`` of ``ops/front.pair_half``, which torch runs on the card
as ``aten::gather``: the ``<false, OpaqueType<4>, long>`` gather kernel,
not the front's ``<true, float, long>`` count scatter of the same
template), from the traced window's kernel times, per 1,000 barcodes of
the window's jobs: the fast counterpart of
``pair_route.device_ms_per_kbarcode``."""

# each kernel whose name contains one of these
KERNELS = ("pair_fast_kernel", "pair_tiled_fast_kernel",
           "extras_fast_kernel",
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
