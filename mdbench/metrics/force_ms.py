"""``force_ms``: mean wall ms of the harness's span around each force
evaluation against a frozen selection (``force_fn_of_sel``) in the span
stretch; each span starts and ends with a device sync."""
import statistics


def read(ctx):
    spans = ctx.spans.get('force')
    return statistics.fmean(spans) if spans else None
