"""Layer kernels, the exact front K2' (``csrc/front_exact.cu``): the
front's least time over the device time of the kernels below, in %.
Work from the library's sizes (``roofline.front_work``)."""

from portbench import roofline

KERNELS = ("front_exact_kernel",)


def read(ctx):
    return roofline.roofline_pct(ctx, roofline.front_work, KERNELS)
