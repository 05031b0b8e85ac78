"""The port's own spans in a ``torch.profiler`` Chrome trace.

The port opens a ``record_function`` range named ``nnpops.<name>``
around each of its phases while a profiler runs
(``nnpops_tpu_torch.utils.profiling.span``). For each name this reads,
over the profiled stretch (``mdbench.stretch``) where the trace has one
and over the whole trace otherwise:

* ``count``: the number of ranges;
* ``wall_s``: their summed wall time;
* ``self_s``: the wall time no other ``nnpops.*`` range on the same
  thread, nested inside, covers;
* ``device_s``: the union of the device activity launched inside the
  ranges, joined by correlation id, the launch on any thread (the rule of
  ``tracing.read``'s span device time: a backward's launches run on the
  autograd thread);
* ``idle_s``: the ranges' time in which the device ran nothing.

``metrics`` turns these and the port's upload counters into the
per-layer numbers they serve. Run on a trace file (for instance the
``trace.json`` that ``nnpops_tpu_torch.utils.profiling.trace`` writes)
it prints the table, then the numbers the spans alone give:

    python3 mdbench/program_spans.py <trace.json>
"""
from __future__ import annotations

import bisect
import json
import sys
from collections import defaultdict
from pathlib import Path

if __name__ == '__main__':
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from mdbench.tracing import DEVICE_CATS, STRETCH, length, union  # noqa: E402

PREFIX = 'nnpops.'


def _covered(ranges, begins, s, e) -> float:
    """Length of the union of ``ranges`` (merged, sorted) within
    ``[s, e]``."""
    k = max(bisect.bisect_right(begins, s) - 1, 0)
    total = 0.0
    while k < len(ranges) and ranges[k][0] < e:
        total += max(0.0, min(e, ranges[k][1]) - max(s, ranges[k][0]))
        k += 1
    return total


def read(path) -> dict:
    """``{name: {count, wall_s, self_s, device_s, idle_s}}`` for every
    ``nnpops.*`` name in the Chrome trace at ``path`` (names without the
    prefix); empty when the trace holds none."""
    with open(path) as f:
        events = [e for e in json.load(f)['traceEvents']
                  if e.get('ph') == 'X']
    stretch = [e for e in events if e.get('cat') == 'user_annotation'
               and e['name'] == STRETCH]
    lo, hi = ((stretch[0]['ts'], stretch[0]['ts'] + stretch[0]['dur'])
              if stretch else (float('-inf'), float('inf')))
    spans = [e for e in events if e.get('cat') == 'user_annotation'
             and e['name'].startswith(PREFIX) and lo <= e['ts'] < hi]
    if not spans:
        return {}
    device = [e for e in events if e.get('cat') in DEVICE_CATS]
    busy = union((e['ts'], e['ts'] + e['dur']) for e in device)
    busy_begins = [b[0] for b in busy]
    by_corr = defaultdict(list)
    for e in device:
        by_corr[e.get('args', {}).get('correlation')].append(
            (e['ts'], e['ts'] + e['dur']))
    calls = sorted(((e['ts'], e.get('args', {}).get('correlation'))
                    for e in events
                    if e.get('cat') in ('cuda_runtime', 'cuda_driver')),
                   key=lambda c: c[0])
    call_ts = [c[0] for c in calls]
    by_tid = defaultdict(list)
    for e in spans:
        by_tid[e['tid']].append((e['ts'], e['ts'] + e['dur']))
    for ranges in by_tid.values():
        ranges.sort(key=lambda r: (r[0], -r[1]))

    by_name = defaultdict(list)
    for e in spans:
        by_name[e['name'][len(PREFIX):]].append(e)
    out = {}
    for name, evs in by_name.items():
        self_s = 0.0
        for e in evs:
            s, t = e['ts'], e['ts'] + e['dur']
            inner = [r for r in by_tid[e['tid']]
                     if s <= r[0] and r[1] <= t and r != (s, t)]
            self_s += (t - s) - length(union(inner))
        merged = union((e['ts'], e['ts'] + e['dur']) for e in evs)
        acts = []
        for s, t in merged:
            k = bisect.bisect_left(call_ts, s)
            while k < len(calls) and calls[k][0] < t:
                acts += by_corr.get(calls[k][1], ())
                k += 1
        wall = sum(e['dur'] for e in evs)
        span_len = length(merged)
        busy_in = sum(_covered(busy, busy_begins, s, t) for s, t in merged)
        out[name] = {'count': len(evs), 'wall_s': wall * 1e-6,
                     'self_s': self_s * 1e-6,
                     'device_s': length(union(acts)) * 1e-6,
                     'idle_s': (span_len - busy_in) * 1e-6}
    return out


def metrics(spans: dict, counters, steps: int) -> dict:
    """The per-layer numbers read from the spans and the upload counters
    (``None`` before the port had them): device idle ms inside
    ``nnpops.select`` a selection; device ms launched inside each force
    phase a force call; uploaded bytes a step. A number whose source is
    missing is left out."""
    out = {}
    select = spans.get('select')
    if select and select['count']:
        out['select_idle_ms'] = 1e3 * select['idle_s'] / select['count']
    force = spans.get('force')
    if force and force['count']:
        for metric, phase in (('aev_ms', 'force.aev'),
                              ('ensemble_ms', 'force.ensemble'),
                              ('force_backward_ms', 'force.backward')):
            if phase in spans:
                out[metric] = 1e3 * spans[phase]['device_s'] / force['count']
    if counters is not None and steps:
        out['upload_bytes_per_step'] = counters['upload_bytes'] / steps
    return out


def table(spans: dict) -> str:
    """One line a span, by wall time: ranges, and the mean wall, self,
    device and idle ms of a range."""
    lines = [f'{"span":<28}{"ranges":>8}{"wall ms":>12}{"self ms":>12}'
             f'{"device ms":>12}{"idle ms":>12}']
    for name, v in sorted(spans.items(), key=lambda kv: -kv[1]['wall_s']):
        n = v['count']
        lines.append(f'{PREFIX + name:<28}{n:>8}'
                     + ''.join(f'{1e3 * v[k] / n:>12.4f}' for k in
                               ('wall_s', 'self_s', 'device_s', 'idle_s')))
    return '\n'.join(lines)


if __name__ == '__main__':
    if len(sys.argv) != 2:
        sys.exit(f'usage: {sys.argv[0]} <trace.json>')
    found = read(sys.argv[1])
    if not found:
        sys.exit(f'no {PREFIX}* spans in {sys.argv[1]}')
    print(table(found))
    print(json.dumps(metrics(found, None, 0)))
