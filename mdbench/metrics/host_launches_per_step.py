"""``host_launches_per_step``: CUDA runtime and driver launch calls
(kernels, graphs, async copies and memsets) on the host in the profiled
stretch, over its MD steps."""


def read(ctx):
    launches = ctx.trace.get('launches')
    if not launches or not ctx.trace_steps:
        return None
    return launches / ctx.trace_steps
