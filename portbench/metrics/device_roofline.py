"""Layer device, every stage together: the least times of the front, the
pair search and the decision pass (``roofline``), over the device's busy
time in the traced window, in %. It stands whatever kernels do the work:
a stage merged or removed leaves it comparable."""

from portbench import roofline

STAGES = (roofline.front_work, roofline.pair_work_of, roofline.decision_work)


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or trace["busy_s"] <= 0.0:
        return None
    least = sum(roofline.window_least_s(ctx, w) for w in STAGES)
    return 100.0 * least / trace["busy_s"]
