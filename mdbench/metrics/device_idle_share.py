"""``device_idle_share``: 100 x (1 - the device's busy seconds a step over
the wall seconds a step). The busy seconds are the union of the device's
activity intervals in the profiled stretch, over its steps; the wall
seconds a step are the measured window's, which runs without the
profiler. The profiler slows the host about twofold, and the device's
work a step is the same with it or without it, so the profiled stretch's
own wall time would overstate the idle share."""


def read(ctx):
    busy, steps = ctx.trace.get('busy_s'), ctx.trace_steps
    if not busy or not steps or not ctx.step_ms:
        return None
    return 100.0 * (1.0 - (busy / steps) / (ctx.step_ms * 1e-3))
