"""Reading a ``torch.profiler`` trace of the profiled stretch.

The stretch runs under ``torch.profiler`` with the harness's spans as
``record_function`` ranges (``mdbench.stretch`` around it all,
``mdbench.select``, ``mdbench.force``, ``mdbench.counts`` around the calls
into the program). The Chrome trace it exports is read here:

* device activity: kernels, copies and memsets; their union over the
  stretch is the busy time (kernels on concurrent streams counted once,
  which a sum of kernel times would count twice);
* host launches: the CUDA runtime and driver calls that launch work on the
  device (kernels, graphs, async copies and memsets), a driver call
  nested in a runtime call counted once;
* the device time of each span: the union of the activity whose launch
  lies inside one of the span's ranges (launch and activity share a
  correlation id);
* the breakdown: device operations by time, and the device's idle gaps
  named by the harness span and the innermost host operation open at each
  gap's middle.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')
LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC',
                'cudaLaunchCooperativeKernel', 'cuLaunchKernel',
                'cuLaunchKernelEx', 'cudaGraphLaunch', 'cuGraphLaunch',
                'cudaMemcpyAsync', 'cudaMemcpy2DAsync', 'cudaMemsetAsync',
                'cuMemcpyAsync', 'cuMemcpyHtoDAsync_v2',
                'cuMemcpyDtoHAsync_v2', 'cuMemsetD8Async',
                'cuMemsetD32Async')
STRETCH = 'mdbench.stretch'
TOP = 10


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.replace('(anonymous namespace)', 'anon')
    name = name[5:] if name.startswith('void ') else name
    depth = 0
    for k, c in enumerate(name):
        if c == '<':
            depth += 1
        elif c == '>':
            depth -= 1
        elif c == '(' and depth == 0 and k > 0:
            return name[:k].strip()[:160]
    return name[:160]


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def length(merged) -> float:
    return sum(e - s for s, e in merged)


def clip(merged, lo, hi):
    return [[max(s, lo), min(e, hi)] for s, e in merged if e > lo and s < hi]


def _innermost(host, queries):
    """For each query time (sorted), the stack of host events (outermost
    first) open at it; ``host`` is one thread's events sorted by start."""
    out, stack, k = [], [], 0
    for t in queries:
        while k < len(host) and host[k][0] <= t:
            s, e, name = host[k]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append(host[k])
            k += 1
        live = [ev for ev in stack if ev[1] > t]
        out.append([ev[2] for ev in live])
    return out


def read(path) -> dict:
    """The profiled stretch's numbers (seconds) from a Chrome trace file."""
    with open(path) as f:
        events = [e for e in json.load(f)['traceEvents']
                  if e.get('ph') == 'X']
    stretch = [e for e in events if e.get('cat') == 'user_annotation'
               and e['name'] == STRETCH]
    if not stretch:
        return {}
    st = stretch[0]
    lo, hi = st['ts'], st['ts'] + st['dur']
    tid = st['tid']
    device = [e for e in events if e.get('cat') in DEVICE_CATS]
    busy = clip(union((e['ts'], e['ts'] + e['dur']) for e in device), lo, hi)
    by_corr = defaultdict(list)
    for e in device:
        by_corr[e.get('args', {}).get('correlation')].append(e)
    host = sorted(((e['ts'], e['ts'] + e['dur'], e['name']) for e in events
                   if e.get('cat') in HOST_CATS and e['tid'] == tid
                   and lo <= e['ts'] < hi), key=lambda h: (h[0], -h[1]))
    # Launch calls: every runtime launch, and every driver launch that no
    # runtime call on its thread encloses.
    runtime = sorted((e for e in events if e.get('cat') == 'cuda_runtime'),
                     key=lambda e: e['ts'])
    starts = [e['ts'] for e in runtime]
    n_launch = 0
    for e in events:
        if e.get('cat') not in ('cuda_runtime', 'cuda_driver') \
                or e['name'] not in LAUNCH_CALLS or not lo <= e['ts'] < hi:
            continue
        if e['cat'] == 'cuda_driver':
            k = bisect.bisect_right(starts, e['ts']) - 1
            while k >= 0 and runtime[k]['tid'] != e['tid']:
                k -= 1
            if k >= 0 and runtime[k]['ts'] + runtime[k]['dur'] >= \
                    e['ts'] + e['dur']:
                continue
        n_launch += 1
    # Device time of each harness span, by the launches inside its ranges.
    spans = defaultdict(list)
    for e in events:
        if (e.get('cat') == 'user_annotation' and e['name'] != STRETCH
                and e['name'].startswith('mdbench.')):
            spans[e['name'][len('mdbench.'):]].append(
                (e['ts'], e['ts'] + e['dur']))
    span_device = {}
    calls = [e for e in events
             if e.get('cat') in ('cuda_runtime', 'cuda_driver')]
    for name, ranges in spans.items():
        ranges.sort()
        begins = [r[0] for r in ranges]
        acts = []
        for e in calls:
            k = bisect.bisect_right(begins, e['ts']) - 1
            if k >= 0 and e['ts'] < ranges[k][1]:
                acts += [(a['ts'], a['ts'] + a['dur'])
                         for a in by_corr.get(e.get('args', {}).get(
                             'correlation'), ())]
        span_device[name] = (length(union(acts)) * 1e-6, len(ranges))
    # Breakdown.
    ops = defaultdict(float)
    for e in device:
        if lo <= e['ts'] < hi:
            ops[short_name(e['name'])] += e['dur'] * 1e-6
    gaps = [(busy[k][1], busy[k + 1][0]) for k in range(len(busy) - 1)]
    if busy:
        gaps = [(lo, busy[0][0])] + gaps + [(busy[-1][1], hi)]
    gaps = [g for g in gaps if g[1] > g[0]]
    mids = sorted((0.5 * (s + e), e - s) for s, e in gaps)
    named = defaultdict(float)
    for (t, dur), stack in zip(mids, _innermost(host, [m for m, _ in mids])):
        harness = [n for n in stack
                   if n.startswith('mdbench.') and n != STRETCH]
        head = harness[-1][len('mdbench.'):] if harness else 'loop'
        inner = stack[-1] if stack else 'no host op'
        if inner.startswith('mdbench.'):
            named[head] += dur * 1e-6
        else:
            named[f'{head}/{inner}'] += dur * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),  # noqa: E731
                                               key=lambda kv: -kv[1])[:TOP]]
    return {'window_s': (hi - lo) * 1e-6, 'busy_s': length(busy) * 1e-6,
            'launches': n_launch,
            'device_activities': sum(1 for e in device
                                     if lo <= e['ts'] < hi),
            'span_device': span_device,
            'breakdown': {'device_ops': top(ops), 'idle_gaps': top(named)}}
