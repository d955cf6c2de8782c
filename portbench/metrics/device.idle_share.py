"""Layer device: the share of the traced window in which no kernel, memcpy
or memset ran on the device (one minus the union of their intervals over
the window)."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or trace["window_s"] <= 0.0:
        return None
    return 1.0 - trace["busy_s"] / trace["window_s"]
