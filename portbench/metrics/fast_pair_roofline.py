"""Layer kernels, the fast route's pair search (K1 ``csrc/pair_fast.cu``,
or on pools with V*V*A > 384 K5' ``csrc/pair_tiled_fast.cu`` with K4'
``csrc/extras_fast.cu``): its least time at the f32 peak over the device
time of those kernels, in %. Work from the library's sizes, without the
singlet term, which torch computes outside the kernels
(``roofline_fast.pair_work_of``)."""

from portbench import roofline_fast


def read(ctx):
    return roofline_fast.pair_roofline_pct(ctx)
