"""One run of one cell: set-up, the measured window of MD blocks, the
traced stretches, and the comparison with the plain reference.

A block is one call of the port's ``md.integrators.run_md_sticky_counts``
for ``refresh`` steps: a fresh selection, the forces at the block's start,
``refresh`` BAOAB steps and the overflow counts. After each block the
device is synchronised and the counts are read against the capacities
(with the energy and positions' finiteness) in one copy; a block fails on
any count over its capacity or anything not finite. Every
``segment_steps`` steps the trajectory restarts from the frame, moved and
given velocities from the seed (untimed, between blocks).

Everything that belongs to one configuration, traffic mix, model kind or
per-layer metric is found by name: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``models/<kind>.py`` (the program's entry
points), ``reference/<kind>.py`` (the plain reference) and
``metrics/<metric>.py`` (a reader).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import statistics
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from mdbench import inputs, tracing, work
from mdbench.reference import md as ref_md

HERE = Path(__file__).resolve().parent
CHECK = 4            # sub_seed tag of the segment sample


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f'mdbench_{path.parent.name}_{path.stem}'.replace('.', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f'{name}.json').read_text())


def make_setup(cfg: dict, traffic: dict, seed: int, device) -> SimpleNamespace:
    """The inputs both sides are handed, on ``device``."""
    frame = inputs.water_frame(traffic['molecules'], traffic['frame_seed'])
    dev = torch.device(device)
    edge = float(frame.box[0, 0])
    grid = max(16, 2 ** math.ceil(math.log2(edge)))
    return SimpleNamespace(
        device=dev, atomic_numbers=frame.atomic_numbers,
        frame_positions=frame.positions, frame_box=frame.box,
        frame=torch.tensor(frame.positions, device=dev),
        box=torch.tensor(frame.box, device=dev),
        charges=cfg.get('charge_scale', 1.0) * torch.tensor(frame.charges,
                                                            device=dev),
        masses=inputs.masses_of(frame.atomic_numbers, cfg['masses'], dev),
        weights=inputs.make_weights(seed, cfg['layer_dims'],
                                    cfg['aev_length'], cfg['num_models'],
                                    cfg['bias_scale'], dev),
        pme_grid=(grid, grid, grid))


class Runner:
    """Drives the program block by block and keeps, for the comparison, a
    sample drawn from the seed of the measured window's segments (copies
    of the program's block-end states, taken after the block's time, so a
    program that returns the same buffers every block is judged
    rightly)."""

    def __init__(self, system, setup, cfg: dict, traffic: dict, seed: int,
                 check_segments: int):
        from nnpops_tpu_torch.md import integrators
        self.integrators = integrators
        self.system, self.setup, self.seed = system, setup, seed
        self.refresh = int(traffic.get('refresh', cfg['refresh']))
        self.seg_blocks = int(traffic['segment_steps']) // self.refresh
        self.displacement = float(traffic['displacement'])
        self.integ = cfg['integrator']
        self.cuda = setup.device.type == 'cuda'
        self.segment, self.block_no = -1, self.seg_blocks
        self.keys = self.caps = None
        self.recording, self.record = False, None
        self.kept, self.seen, self.k = [], 0, check_segments
        self.rng = np.random.default_rng(inputs.sub_seed(seed, CHECK))
        self.failures = []

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def factory(self, force_fn):
        i = self.integ
        return self.integrators.langevin_baoab(
            force_fn, self.setup.masses, i['dt'], i['friction'], i['kT'])

    def restart(self):
        self._offer()
        self.segment += 1
        self.block_no = 0
        r = inputs.restart(self.seed, self.segment, self.setup.frame,
                           self.setup.masses, self.integ['kT'],
                           self.displacement)
        zeros = torch.zeros_like(r.positions)
        self.state = self.integrators.MDState(
            r.positions, r.velocities, zeros, zeros.new_zeros(()),
            r.generator, torch.zeros((), dtype=torch.int32,
                                     device=zeros.device))
        self.record = [] if self.recording else None
        self.sync()

    def _offer(self):
        """Reservoir sampling of the recorded segments."""
        rec, self.record = self.record, None
        if not rec:
            return
        item = (self.segment, rec)
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = item
        self.seen += 1

    def _ok(self, stats: dict, state) -> bool:
        if self.keys is None:
            self.keys = list(stats)
            caps = self.system.capacities
            self.caps = torch.cat([torch.tensor(np.broadcast_to(
                np.asarray(caps[k]), tuple(stats[k].shape)).reshape(-1),
                dtype=torch.int64) for k in self.keys]).to(
                    self.setup.device)
        vec = torch.cat([stats[k].reshape(-1).to(torch.int64)
                         for k in self.keys])
        good = (torch.all(vec <= self.caps) & torch.isfinite(state.energy)
                & torch.all(torch.isfinite(state.positions)))
        if bool(good):
            return True
        host = {k: stats[k].detach().cpu().numpy() for k in self.keys}
        self.failures.append({
            'segment': self.segment, 'block': self.block_no,
            'over': {k: host[k].tolist() for k in self.keys
                     if np.any(host[k] > np.asarray(
                         self.system.capacities[k]))},
            'finite': bool(torch.isfinite(state.energy))})
        return False

    def block(self, fns) -> tuple:
        """One timed block: (wall seconds, ok)."""
        if self.block_no >= self.seg_blocks:
            self.restart()
        t0 = time.perf_counter()
        state, _, stats = self.integrators.run_md_sticky_counts(
            fns.select, fns.force, self.factory, self.state, self.refresh,
            self.refresh, fns.counts)
        ok = self._ok(stats, state)
        seconds = time.perf_counter() - t0
        self.block_no += 1
        if ok:
            self.state = state
            if self.record is not None:
                self.record.append(ref_md.BlockEnd(
                    state.positions.clone(), state.velocities.clone(),
                    state.energy.clone(), state.forces.clone()))
        else:
            self.block_no = self.seg_blocks
            self.record = None
        return seconds, ok

    def new_segment(self):
        """Make the next block start a segment."""
        self.block_no = self.seg_blocks

    def close(self):
        self._offer()


ENTRIES = ('select', 'force', 'counts')


def wrapped(system, wrap=lambda name, fn: fn) -> SimpleNamespace:
    """The entry points the MD loop drives, each through ``wrap``."""
    return SimpleNamespace(**{name: wrap(name, getattr(system, name))
                              for name in ENTRIES})


def profiled(name, fn):
    """``fn`` inside a ``record_function`` range."""
    def call(*args):
        with torch.profiler.record_function(f'mdbench.{name}'):
            return fn(*args)
    return call


def synced_spans(runner, spans: dict):
    """A wrap timing ``fn`` on the host clock between two device syncs."""
    def wrap(name, fn):
        def call(*args):
            runner.sync()
            t0 = time.perf_counter()
            out = fn(*args)
            runner.sync()
            spans[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call
    return wrap


def verdict(cfg: dict, out: dict):
    """(correct, checks): every compared number beside its limit; correct
    when no block failed and every number is within its limit."""
    limits = cfg.get('limits', {})
    checks = {k: {'value': v, 'limit': limits.get(k)}
              for k, v in out['numbers'].items()}
    correct = out['failed'] == 0 and all(
        c['limit'] is not None and c['value'] <= c['limit']
        for c in checks.values())
    return correct, checks


def quantile95(values) -> float:
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20, method='inclusive')[-1]


def run_cell(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
             device, t_start: float, per_layer=(), log=print) -> dict:
    """One run. Returns the numbers the result line is made of."""
    cuda = torch.device(device).type == 'cuda'
    kind = cfg['kind']
    setup = make_setup(cfg, traffic, seed, device)
    system = load_module(HERE / 'models' / f'{kind}.py').build(cfg, setup)
    runner = Runner(system, setup, cfg, traffic, seed,
                    int(traffic['check_segments']))
    fns = wrapped(system)
    for _ in range(int(traffic['warm_blocks'])):
        _, ok = runner.block(fns)
        if not ok:
            raise RuntimeError(f'a warm-up block failed: {runner.failures}')
    runner.new_segment()
    runner.recording = True
    runner.restart()
    start = time.perf_counter()
    setup_s = start - t_start
    times, failed = [], 0
    while True:
        dt, ok = runner.block(fns)
        times.append(dt)
        failed += not ok
        if time.perf_counter() - start >= seconds:
            break
    window_wall = time.perf_counter() - start
    runner.recording = False
    runner.close()
    steps = len(times) * runner.refresh
    out = {'attempted': len(times), 'failed': failed,
           'failures': runner.failures[:5],
           'step_ms': 1e3 * sum(times) / steps,
           'block_ms_p95': 1e3 * quantile95(times),
           'block_ms_median': 1e3 * statistics.median(times),
           'setup_s': setup_s, 'window_wall_s': window_wall,
           'blocks': len(times), 'steps': steps}
    log(f'window: {len(times)} blocks, {steps} steps in {window_wall:.3f} s, '
        f'step_ms {out["step_ms"]:.4f}, block p50 '
        f'{out["block_ms_median"]:.4f} p95 {out["block_ms_p95"]:.4f} ms, '
        f'setup {setup_s:.3f} s, failed {failed}')
    stretches = traced(runner, system, log) if trace else None
    out['memory_peak_bytes'] = (torch.cuda.max_memory_allocated()
                                if cuda else 0)
    # The program's state goes before the reference runs.
    kept = runner.kept
    del system, runner, fns
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = load_module(HERE / 'reference' / f'{kind}.py').make(cfg, setup)
    if trace:
        out.update(per_layer_metrics(ref, cfg, setup, stretches, per_layer,
                                     out['step_ms'], log))
    out['numbers'] = compare(ref, cfg, traffic, setup, seed, kept, log)
    return out


def traced(runner, system, log) -> SimpleNamespace:
    """The profiled stretch and the span stretch, a segment each."""
    from torch.profiler import ProfilerActivity, profile
    blocks = runner.seg_blocks
    runner.new_segment()
    runner.restart()
    acts = [ProfilerActivity.CPU]
    if runner.cuda:
        acts.append(ProfilerActivity.CUDA)
    fns = wrapped(system, profiled)
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(tracing.STRETCH):
                t0 = time.perf_counter()
                for _ in range(blocks):
                    runner.block(fns)
                traced_wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        path = Path(tmp) / 'trace.json'
        prof.export_chrome_trace(str(path))
        tr = tracing.read(path)
        read_s = time.perf_counter() - t1
    steps = blocks * runner.refresh
    log(f'traced stretch: {steps} steps in {traced_wall:.3f} s, busy '
        f'{tr.get("busy_s")} s of {tr.get("window_s")} s profiled '
        f'({1e3 * traced_wall / steps:.4f} ms/step under the profiler), '
        f'trace read in {read_s:.3f} s; device activities '
        f'{tr.get("device_activities")}, launches {tr.get("launches")}, '
        f'span device s {tr.get("span_device")}')
    spans = {name: [] for name in ENTRIES}
    runner.new_segment()
    runner.restart()
    fns = wrapped(system, synced_spans(runner, spans))
    for _ in range(blocks):
        runner.block(fns)
    log('spans (ms, mean of): ' + ', '.join(
        f'{k} {statistics.fmean(v):.4f} ({len(v)})' for k, v in spans.items()
        if v))
    return SimpleNamespace(trace=tr, spans=spans, steps=steps)


def per_layer_metrics(ref, cfg, setup, stretches, per_layer, step_ms,
                      log) -> dict:
    """Each per-layer metric's reader on the stretches and the work."""
    counts = ref.work_counts(setup.frame)
    need = ref.work(cfg, counts)
    least = work.least_time(need)
    log(f'work per force evaluation: {counts}; class seconds '
        f'{work.class_times(need)}; least {least * 1e3:.5f} ms')
    tr = stretches.trace
    ctx = SimpleNamespace(spans=stretches.spans, trace=tr,
                          trace_steps=stretches.steps, least_force_s=least,
                          step_ms=step_ms, work=need, counts=counts)
    metrics = {}
    for name in per_layer:
        value = load_module(HERE / 'metrics' / f'{name}.py').read(ctx)
        if value is not None:
            metrics[name] = value
    return {'per_layer': metrics, 'busy_s': tr.get('busy_s'),
            'window_s': tr.get('window_s'),
            'breakdown': tr.get('breakdown')}


def compare(ref, cfg, traffic, setup, seed, kept, log) -> dict:
    """The reference replays each sampled segment from its start; the
    widest gaps over them."""
    refresh = int(traffic.get('refresh', cfg['refresh']))
    i = cfg['integrator']
    numbers = {}
    t0 = time.perf_counter()
    for segment, records in kept:
        r = inputs.restart(seed, segment, setup.frame, setup.masses, i['kT'],
                           float(traffic['displacement']))
        ends = ref_md.trajectory(ref.energy_forces_and_ani, r.positions,
                                 r.velocities, r.generator, setup.masses,
                                 i['dt'], i['friction'], i['kT'],
                                 len(records), refresh)
        where = []
        for k, v in ref_md.compare(records, ends, where).items():
            numbers[k] = max(numbers.get(k, 0.0), v)
        log(f'segment {segment}: largest force error at block, atom, '
            f'program, reference: {where}')
    log(f'reference: {len(kept)} segments '
        f'({[(s, len(r)) for s, r in kept]}) in '
        f'{time.perf_counter() - t0:.3f} s')
    if not kept:
        numbers = {}
    log(f'position_gap (reported, not compared): '
        f'{numbers.get("position_gap", float("inf"))!r}')
    return held(cfg, numbers)


def held(cfg: dict, numbers: dict) -> dict:
    """The numbers the configuration's limits name; one not computed
    reads infinite."""
    return {k: numbers.get(k, float('inf')) for k in cfg['limits']}


def control_gaps(ref, cfg, traffic, setup, seed, control=True) -> dict:
    """The control's gaps: the reference one precision step lower
    (``control``, as the reference takes it) against the reference itself,
    over segment 0 of ``seed``."""
    refresh = int(traffic.get('refresh', cfg['refresh']))
    blocks = int(traffic['segment_steps']) // refresh
    i = cfg['integrator']
    ends = {}
    for side in (False, control):
        r = inputs.restart(seed, 0, setup.frame, setup.masses, i['kT'],
                           float(traffic['displacement']))
        ends[side] = ref_md.trajectory(
            lambda x: ref.energy_forces_and_ani(x, control=side),
            r.positions, r.velocities, r.generator, setup.masses, i['dt'],
            i['friction'], i['kT'], blocks, refresh)
    return held(cfg, ref_md.compare(ends[control], ends[False]))
