"""Layer kernels, the exact pair search with the singlet term (K3'
``csrc/pair_exact.cu``, or on pools with V*V*A > 384 K7'
``csrc/pair_tiled_exact.cu`` with K6' ``csrc/extras_exact.cu``): its least
time over the device time of the kernels below, in %. Work from the
library's sizes (``roofline.pair_work_of``)."""

from portbench import roofline

KERNELS = ("pair_exact_kernel", "pair_tiled_exact_kernel",
           "extras_exact_kernel")


def read(ctx):
    return roofline.roofline_pct(ctx, roofline.pair_work_of, KERNELS)
