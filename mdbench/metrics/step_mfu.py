"""``step_mfu``: the least time of the one useful force evaluation a step
needs (``work.py``) over the wall time per step of the measured window,
which runs untraced."""


def read(ctx):
    if not ctx.least_force_s or not ctx.step_ms:
        return None
    return 100.0 * ctx.least_force_s / (ctx.step_ms * 1e-3)
