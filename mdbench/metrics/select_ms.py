"""``select_ms``: mean wall ms of the harness's span around each neighbor
selection (``select_fn``) in the span stretch; each span starts and ends
with a device sync."""
import statistics


def read(ctx):
    spans = ctx.spans.get('select')
    return statistics.fmean(spans) if spans else None
