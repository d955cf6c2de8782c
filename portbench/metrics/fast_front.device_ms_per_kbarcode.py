"""Layer kernels, the fast route's front on the card: device milliseconds
of its count table's ``scatter_add_``s and of its LUT contraction's GEMM
(``ops/front.front_half``), from the traced window's kernel times, per
1,000 barcodes of the window's jobs.

The kernels are matched by fragments of their names as the card's trace
gives them (torch 2.11, NVIDIA H100 80GB HBM3): the f32 scatter is
``_scatter_gather_elementwise_kernel<128, 8,
_cuda_scatter_gather_internal_kernel<true, float, long>::operator()
<ReduceAdd>`` (the wire decode's int64 ``scatter_add`` is the ``<true,
long, long>`` one, the g gather the ``<false, OpaqueType<4>, long>``
one); the GEMM is cuBLAS's ``cutlass_80_simt_sgemm_128x32_8x5_nt_align1``,
or ``sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_...`` on small blocks (TF32 is
off, so no tensor-core kernel runs); fast mode runs no other f32 GEMM.
"""

# each kernel whose name contains one of these
KERNELS = ("_cuda_scatter_gather_internal_kernel<true, float,", "_sgemm_",
           "gemm_f32f32")


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
