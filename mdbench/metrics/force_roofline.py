"""``force_roofline``: the least time one force evaluation's essential
work needs (``work.py``) over the device-busy time of one force
evaluation: the union of the device activity launched inside the
profiled stretch's force spans, over their number."""


def read(ctx):
    device_s, spans = ctx.trace.get('span_device', {}).get('force', (0, 0))
    if not device_s or not spans or not ctx.least_force_s:
        return None
    return 100.0 * ctx.least_force_s / (device_s / spans)
