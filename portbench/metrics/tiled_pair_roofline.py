"""Layer kernels, the tiled exact pair search with the singlet term (K7'
``csrc/pair_tiled_exact.cu`` with K6' ``csrc/extras_exact.cu``): its least
time over the device time of those kernels, in %, the yardstick of
``pair_roofline`` on the cells that take the tiled route. Work from the
library's sizes (``roofline.pair_work_of``)."""

from portbench import roofline

KERNELS = ("pair_tiled_exact_kernel", "extras_exact_kernel")


def read(ctx):
    if not ctx["jobs"]:
        return None
    return roofline.roofline_pct(ctx, roofline.pair_work_of, KERNELS)
