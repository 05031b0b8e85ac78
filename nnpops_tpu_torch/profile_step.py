"""Where the time of the port's MD force step goes, on one CUDA GPU.

Builds the smoke configuration of ``chip_smoke.py`` (ANI-2x at full width,
8 random models, bf16 fused ensemble, skin 0.25 A, margin 1.15) on
``make_water_box(867)``, 2,601 atoms (``--molecules 8670`` for the
26,010-atom box), in the window configuration (the default; ``--impl
pallas`` for the species-blocked one; ``--impl combined`` for BASELINE
config 5, ANI + PME as ``models.combined.config5`` builds it, margin 1.2),
and measures, in one process:

1. the force step on a frozen selection, unprofiled: CUDA events and the
   host clock (synchronised), 3 runs of 8 steps;
2. the selection (``ANIModel.select``), the same two clocks, and with
   ``--impl combined`` the overflow counts a sticky run takes per block
   (CUDA events);
3. 8 force steps under ``torch.profiler``: device kernel time and
   device kernels per step, and the kernels that take the most time. The
   device busy share is that kernel time over the unprofiled CUDA-event
   step time of phase 1 (the profiler slows the host, so its own wall time
   is not the step's); the forward and backward device time per step and
   their share of the step's of the angular kernel (B.3), the window radial
   kernel (B.2) and, with ``--impl combined``, the PME window kernel
   (B.5);
4. the neighbor gather and its autograd adjoint at this run's shapes (the
   payload gather of 'pallas', the angular tiers' gathers of 'window'),
   with ``index_select`` (an ``index_add`` adjoint, what the port uses)
   against advanced indexing (``slots[idx]``, a sort-based accumulating
   adjoint), timed in the order A, B, B, A;
5. with ``--impl combined``, the step's parts each alone (energy and
   position gradient of the ANI part, of the PME direct window and of the
   reciprocal and self terms): CUDA-event time (taken with phases 1-2,
   before any profiler session), and under ``torch.profiler`` device
   kernel time and kernels per call, which split the step's;
6. the fused ensemble's call alone (``ensemble_energy_grouped_rows_fused``
   and its input gradient on the step's own AEV rows, as the step makes
   it): the host time for a call to return, not synchronised between
   calls (what a host-paced step pays for it), 3 runs of 20 calls, and its
   CUDA-event time (taken with phases 1-2). Any tree of the port with that
   entry point can be measured this way by running this file in it.

With ``--impl window``, ``--radial-impl pair`` or ``cluster`` runs the
window path's opt-in radial (the z-pair kernel B.9, or the cluster-pair
kernel B.8 with its planner, which needs a box of about 1,000 waters or
more): phase 3 then reports that kernel's forward and backward device
time and share per step in place of B.2's, and for ``pair`` a phase 7
profiles the pair path's host side alone on the step's own shapes (the
z-triple build with its adjoint, the fold of the neighbour side with its
adjoint, the sum of the backward's five planes): device time and kernels
per call.

With ``--impl window`` a phase 8 compares the selection's two
compactions at this run's shapes: ``select_window(compact_impl='kernel')``
(the left-pack of slot keys, B.1) and ``'mask'`` (the slot-space mask,
B.7a, and the lane left-pack, B.7b), each with the arguments
``ANIModel.select`` passes. For each, the CUDA-event ms of 3 runs (taken
in turns), and under ``torch.profiler`` the device kernel ms and kernels
a selection, with the device ms of B.1, B.7a and B.7b.

``--impl cfconv`` measures the SchNet/CFConv path instead: one iteration
of the 26,010-atom 6-layer CFConv stack of ``chip_smoke.py`` phase 8
(``models.schnet.periodic_stack_grads``: select with mirror, distance
payload, 6 layers, gradients of the sum), its CUDA-event time (3 runs)
and under ``torch.profiler`` its device kernel time, device kernels and
busy share (device time over the median event time), then each part
alone, CUDA-event time and device time and kernels under the profiler:
the selection with the mirror, the distance payload, the 6 forwards
(the fused forward kernel, no grad), the 6 backward kernels (B.6) on the inputs recorded from an
iteration, and the mirror position adjoint (a random cotangent on the
valid lanes).

``--impl dense`` and ``--impl payload`` measure the two ANI paths that
launch no kernel (BASELINE configs 1 and 3; 8 random models, self
energies ``linspace(-40, -1, 7)``): ``dense`` the largest ligand of
``tests/data/ligands.npz`` (``1hvk``, 116 atoms) through
``ANIModel.energy_and_forces``, ``payload`` the water box through
``energy_and_forces_from_selection`` on a frozen ``SlotSelection``
(cell-list capacity 96, ``angular_capacity=32``, ``--aev-chunk-size``
rows a block, none by default). For the call, its CUDA-event time (3 runs
of 4 calls) and under ``torch.profiler`` its device kernel time, kernels
per call, busy share (device time over the median event time) and the
kernels that take the most time; for ``payload`` the same for the
selection and for ``energy_and_forces_fused`` (selection inline).

Prints one JSON object as its last line; with ``--out-dir`` also writes
the profiler's kernel table and a Chrome trace there. Run from the
repository root on a machine with a CUDA GPU:

    python3 -m nnpops_tpu_torch.profile_step --impl window --out-dir chiprun_out/profile
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import pathlib
import statistics
import subprocess
import time

import numpy as np
import torch

from . import ANIBasis, _kernels
from .models import ani as ani_module
from .models.ani import ANIModel, init_ani_params
from .models.combined import C5_SELF_ENERGIES, config5
from .models.schnet import periodic_stack, periodic_stack_grads
from .neighbors.cell_list import CellList
from .neighbors.window import select_window
from .ops import cuda_cfconv, cuda_zpair
from .utils import make_water_box

MOLECULES = 867
CFCONV_ATOMS = 26010
STEPS = 8
REPEATS = 3
SEED = 0
TOP = 12
NN_CALLS = 20


def _event_ms(fn, n):
    """Mean CUDA-event time of ``fn`` over ``n`` calls, in ms."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _host_ms(fn, n):
    """Mean host-clock time of ``fn`` over ``n`` calls, synchronised, ms."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _submit_ms(fn, n):
    """Mean host-clock time for ``fn`` to return over ``n`` calls, not
    synchronised between them (the device may still run), ms."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / n


def _kernel_events(prof):
    """The device-kernel events of a finished profile, as (name, us)."""
    out = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(evt, 'self_device_time_total', None)
            if us is None:
                us = evt.self_cuda_time_total
            out.append((evt.name, float(us)))
    return out


def _profile(fn, n):
    """(device kernel ms per call, kernels per call) of ``n`` calls of
    ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _host_ms(fn, n)
    kernels = _kernel_events(prof)
    return sum(us for _, us in kernels) / 1e3 / n, len(kernels) / n


def _grad_of(energy_fn, pos):
    """A call that takes ``energy_fn``'s value and position gradient."""
    def run():
        p = pos.detach().requires_grad_(True)
        return torch.autograd.grad(energy_fn(p), p)
    return run


def _combined_parts(ff, params, pos, charges, box, cell_list, sel):
    """The config-5 step's three parts, each as a call that takes its energy
    and position gradient."""
    return {
        'ani': _grad_of(lambda p: ff.ani.energy_from_selection(
            params, p, box, cell_list, sel), pos),
        'pme_direct': _grad_of(lambda p: ff._pme_direct(p, charges, box),
                               pos),
        'pme_reciprocal': _grad_of(
            lambda p: ff._pme_reciprocal(p, charges, box), pos),
    }


def _cfconv(dev, card, out_dir):
    """``--impl cfconv``: one iteration of the 26k CFConv stack and its
    parts (see the module doc)."""
    w = periodic_stack(CFCONV_ATOMS, device=dev)
    cl, box = w.cell_list, w.box
    _kernels.library()
    calls = []
    with recording(cuda_cfconv, 'cfconv_bwd', calls):
        periodic_stack_grads(w)
    # Detached: the saved inputs require grad.
    bwd_args = [(tuple(a.detach() for a in c[0]),
                 *(a.detach() for a in c[1:6]), *c[6:]) for c, _ in calls]
    del calls
    pos = w.positions.detach().requires_grad_(True)
    sel = cl.select(pos, box, build_mirror=True)
    d, idx, m = cl.payload_distances_from_selection(pos, box, sel)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cot = torch.where(m, torch.randn(d.shape, device=dev, generator=gen),
                      0.0)

    def forwards():
        with torch.no_grad():
            return w.stack.apply_distances(w.params, d, idx, m, w.inputs,
                                           w.chunk_size)

    def backwards():
        return [cuda_cfconv.cfconv_bwd(*a) for a in bwd_args]

    parts = {
        'select': lambda: cl.select(pos, box, build_mirror=True),
        'distance_payload': lambda: cl.payload_distances_from_selection(
            pos, box, sel),
        'forwards': forwards,
        'backwards': backwards,
        'mirror_adjoint': lambda: torch.autograd.grad(d, pos, cot,
                                                      retain_graph=True),
    }
    iteration = lambda: periodic_stack_grads(w)  # noqa: E731
    res = {'card': card, 'impl': 'cfconv', 'atoms': CFCONV_ATOMS,
           'layers': w.stack.num_layers, 'capacity': cl.capacity,
           'max_neighbors': int(sel.max_neighbors),
           'valid_pairs': int(m.sum())}
    iteration()
    res['iteration_ms_events'] = [_event_ms(iteration, 1)
                                  for _ in range(REPEATS)]
    res['parts'] = {}
    for name, fn in parts.items():
        fn()
        res['parts'][name] = {'ms_events': _event_ms(fn, 2)}
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _host_ms(iteration, 1)
    kernels = _kernel_events(prof)
    device_ms = sum(us for _, us in kernels) / 1e3
    res['device_kernel_ms'] = device_ms
    res['device_kernels'] = len(kernels)
    res['busy_share'] = device_ms / statistics.median(
        res['iteration_ms_events'])
    for name, fn in parts.items():
        part_ms, part_kernels = _profile(fn, 1)
        res['parts'][name].update(
            device_kernel_ms=part_ms, kernels=part_kernels,
            share_of_iteration_device_ms=part_ms / device_ms)
    res['launches_per_iteration'] = len(bwd_args)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / 'kernels.txt').write_text(
            prof.key_averages().table(sort_by='self_cuda_time_total',
                                      row_limit=40))
        prof.export_chrome_trace(str(out_dir / 'iteration_trace.json'))
    print(json.dumps(res))
    return res


def _no_kernel_path(impl, dev, card, molecules, chunk, out_dir):
    """``--impl dense`` or ``payload`` (see the module doc)."""
    basis = ANIBasis.ani2x()
    params = init_ani_params(
        torch.Generator(device=dev).manual_seed(SEED), basis, num_models=8,
        self_energies=C5_SELF_ENERGIES, device=dev)
    if impl == 'dense':
        data = np.load(pathlib.Path(__file__).resolve().parents[1] / 'tests'
                       / 'data' / 'ligands.npz')
        z = data['1hvk_atomic_numbers']
        model = ANIModel.from_atomic_numbers(z, basis)
        pos = torch.tensor(data['1hvk_positions'], dtype=torch.float32,
                           device=dev)
        call = lambda: model.energy_and_forces(params, pos)  # noqa: E731
        parts = {}
        res = {'molecule': '1hvk'}
    else:
        water = make_water_box(molecules, seed=SEED)
        model = ANIModel.from_atomic_numbers(
            water.atomic_numbers, basis, angular_capacity=32,
            aev_chunk_size=chunk)
        cl = CellList.create(water.box, basis.radial_cutoff, capacity=96)
        pos = torch.tensor(water.positions, device=dev)
        box = torch.tensor(water.box, device=dev)
        sel = model.select(pos, box, cl)
        call = lambda: model.energy_and_forces_from_selection(  # noqa: E731
            params, pos, box, cl, sel)
        parts = {'select': lambda: model.select(pos, box, cl),
                 'fused': lambda: model.energy_and_forces_fused(
                     params, pos, box, cl)}
        res = {'aev_chunk_size': chunk}
    res = {'card': card, 'impl': impl, 'atoms': model.num_atoms, **res}
    timed = {'call': call, **parts}
    for name, fn in timed.items():
        fn()
        events = [_event_ms(fn, 4) for _ in range(REPEATS)]
        device_ms, kernels = _profile(fn, 2)
        res[name] = {'ms_events': events, 'device_kernel_ms': device_ms,
                     'kernels': kernels,
                     'busy_share': device_ms / statistics.median(events)}
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _host_ms(call, 1)
    top = {}
    for name, us in _kernel_events(prof):
        top[name[:80]] = top.get(name[:80], 0.0) + us / 1e3
    res['call']['top_kernels_ms'] = dict(
        sorted(top.items(), key=lambda kv: -kv[1])[:TOP])
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / 'kernels.txt').write_text(
            prof.key_averages().table(sort_by='self_cuda_time_total',
                                      row_limit=40))
    print(json.dumps(res))
    return res


def _pair_host(step, n):
    """Device ms and kernels per call of the pair path's host side, each
    part alone with its adjoint on one step's shapes: the z-triple build
    (``_build_z3``), the fold of the neighbour side (``_fold_b``) and the
    sum of the backward's five dz planes."""
    inputs, kernel = [], []
    with recording(cuda_zpair, 'pair_inputs', inputs), \
            recording(cuda_zpair, 'pair_radial', kernel):
        step()
    slots, box, ncells3, caps = inputs[0][0]
    slots = slots.detach()
    geo = cuda_zpair._geometry(tuple(int(x) for x in ncells3),
                               tuple(int(x) for x in caps))
    out_w = geo.npres * len(kernel[0][0][5])
    gen = torch.Generator(device=slots.device).manual_seed(SEED)
    z3 = cuda_zpair._build_z3(slots, box, geo.ncells3, geo.cell_caps)
    g_z3 = torch.rand(z3.shape, device=slots.device, generator=gen)
    out_b = torch.rand(geo.ncells, 4, out_w, geo.ll, device=slots.device,
                       generator=gen)
    g_fold = torch.rand(geo.ncells, geo.c, out_w, device=slots.device,
                        generator=gen)
    dz5 = torch.rand(5, geo.ncells, 3, geo.ll, device=slots.device,
                     generator=gen)

    def build():
        p = slots.requires_grad_(True)
        return torch.autograd.grad(
            cuda_zpair._build_z3(p, box, geo.ncells3, geo.cell_caps), p, g_z3)

    def fold():
        b = out_b.requires_grad_(True)
        return torch.autograd.grad(
            cuda_zpair._fold_b(b, geo.ncells3, geo.cell_caps, out_w), b,
            g_fold)

    parts = {'z3_build': build, 'fold_b': fold,
             'dz5_sum': lambda: dz5.sum(0)}
    out = {}
    for name, fn in parts.items():
        for _ in range(3):
            fn()
        ms, kernels = _profile(fn, n)
        out[name] = {'device_kernel_ms': ms, 'kernels': kernels,
                     'ms_events': _event_ms(fn, n)}
    return out


# Kernel names of the compactions, as the profiler reports them.
COMPACTION_KERNELS = {'left_pack': 'left_pack_kernel',
                      'window_mask': 'window_mask_kernel',
                      'left_pack_lanes': 'left_pack_lanes_kernel'}


def _compactions(model, pos, box, cell_list, n):
    """Phase 8: the window selection with compact_impl 'kernel' and
    'mask' (see the module doc); ``n`` profiled selections each."""
    from torch.profiler import ProfilerActivity, profile
    g = model.grouping
    layout = model.blocked_layout

    def select(impl):
        return select_window(
            cell_list, pos, box, model.species_array, layout,
            model.basis.radial_cutoff, model.basis.angular_cutoff,
            grouping_order=g.order,
            present_counts=tuple(g.counts[s] for s in layout.present),
            need_shift_planes=model.window_radial == 'window',
            cluster_plan=(layout.cluster_plan
                          if model.window_radial == 'cluster' else None),
            compact_impl=impl)

    impls = ('kernel', 'mask')
    for impl in impls:
        select(impl)
    out = {impl: {'ms_events': []} for impl in impls}
    for rep in range(REPEATS):
        for impl in impls if rep % 2 == 0 else impls[::-1]:
            out[impl]['ms_events'].append(
                _event_ms(functools.partial(select, impl), 1))
    for impl in impls:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _host_ms(functools.partial(select, impl), n)
        kernels = _kernel_events(prof)
        out[impl]['device_kernel_ms'] = sum(us for _, us in kernels) / 1e3 / n
        out[impl]['device_kernels'] = len(kernels) / n
        for key, tag in COMPACTION_KERNELS.items():
            out[impl][f'{key}_ms'] = sum(
                us for name, us in kernels if tag in name) / 1e3 / n
    return out


@contextlib.contextmanager
def recording(module, name, calls):
    """Wrap ``module.name`` so that every call's ``(args, kwargs)`` is
    appended to ``calls``; the wrapped function still runs."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--impl', choices=('window', 'pallas', 'combined',
                                       'cfconv', 'dense', 'payload'),
                    default='window')
    ap.add_argument('--molecules', type=int, default=MOLECULES,
                    help='waters in the box of the ANI paths')
    ap.add_argument('--radial-impl', choices=('window', 'pair', 'cluster'),
                    default='window',
                    help="the window path's radial (with --impl window)")
    ap.add_argument('--aev-chunk-size', type=int, default=None,
                    help='rows a block of the payload AEV (--impl payload)')
    ap.add_argument('--out-dir', type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_step: needs a CUDA GPU')
    dev = torch.device('cuda', 0)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    if args.impl == 'cfconv':
        return _cfconv(dev, card, args.out_dir)
    if args.impl in ('dense', 'payload'):
        return _no_kernel_path(args.impl, dev, card, args.molecules,
                               args.aev_chunk_size, args.out_dir)
    radial = args.radial_impl
    if radial != 'window' and args.impl != 'window':
        raise SystemExit('profile_step: --radial-impl needs --impl window')

    water = make_water_box(args.molecules, seed=SEED)
    basis = ANIBasis.ani2x()
    combined = args.impl == 'combined'
    impl = 'window' if combined else args.impl
    if combined:
        model, cell_list, pos, box, charges, _ = config5(water, basis,
                                                         device=dev)
    else:
        model = ANIModel.from_atomic_numbers(
            water.atomic_numbers, basis, nn_dtype='bfloat16',
            nn_impl='fused').with_blocked_layout(
                water.positions, water.box, margin=1.15, impl=impl,
                skin=0.25,
                radial_impl='cluster' if radial == 'cluster' else 'window')
        if model.aev_impl != impl:
            raise SystemExit(f'profile_step: {impl} fell back to '
                             f'{model.aev_impl}')
        if radial == 'pair':
            model = dataclasses.replace(model, window_radial='pair')
        if model.window_radial != radial:
            raise SystemExit(f'profile_step: the {radial} radial fell back '
                             f'to {model.window_radial}')
        box = torch.tensor(water.box, device=dev)
        pos = torch.tensor(water.positions, device=dev)
        cell_list = model.create_cell_list(water.box, skin=0.25)
    params = init_ani_params(
        torch.Generator(device=dev).manual_seed(SEED), basis, num_models=8,
        self_energies=C5_SELF_ENERGIES if combined else None, device=dev)
    _kernels.library()
    sel = model.select(pos, box, cell_list)

    def step():
        if combined:
            return model.energy_and_forces_from_selection(
                params, pos, charges, box, cell_list, sel)
        return model.energy_and_forces_from_selection(params, pos, box,
                                                      cell_list, sel)

    for _ in range(3):
        step()
    res = {'card': card, 'impl': args.impl, 'radial_impl': radial,
           'atoms': len(water.positions), 'steps': STEPS}

    # 1-2: unprofiled step and selection times.
    res['step_ms_events'] = [_event_ms(step, STEPS) for _ in range(REPEATS)]
    res['step_ms_host'] = [_host_ms(step, STEPS) for _ in range(REPEATS)]
    select = lambda: model.select(pos, box, cell_list)  # noqa: E731
    select()
    res['select_ms_events'] = _event_ms(select, 5)
    res['select_ms_host'] = _host_ms(select, 5)
    if combined:
        counts = lambda: model.overflow_counts(  # noqa: E731
            pos, charges, box, cell_list, sel)
        counts()
        res['overflow_counts_ms_events'] = _event_ms(counts, 5)
        parts = _combined_parts(model, params, pos, charges, box, cell_list,
                                sel)
        res['parts'] = {}
        for name, fn in parts.items():
            for _ in range(3):
                fn()
            res['parts'][name] = {'ms_events': _event_ms(fn, STEPS)}

    # 6: the fused ensemble's call alone, on the step's own rows.
    calls = []
    with recording(ani_module, 'ensemble_energy_grouped_rows_fused', calls):
        step()
    fused = ani_module.ensemble_energy_grouped_rows_fused
    ens, feat, nn_counts = calls[0][0]

    def nn_call():
        a = feat.detach().requires_grad_(True)
        return torch.autograd.grad(fused(ens, a, nn_counts), a)

    for _ in range(3):
        nn_call()
    res['nn_call_submit_ms'] = [_submit_ms(nn_call, NN_CALLS)
                                for _ in range(REPEATS)]
    res['nn_call_ms_events'] = _event_ms(nn_call, NN_CALLS)

    # 3: the profiled steps.
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = _host_ms(step, STEPS)
    kernels = _kernel_events(prof)
    device_ms = sum(us for _, us in kernels) / 1e3 / STEPS
    step_ms = statistics.median(res['step_ms_events'])
    by_name = {}
    for name, us in kernels:
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + us, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    res['profiled_wall_ms_per_step'] = wall
    res['device_kernel_ms_per_step'] = device_ms
    res['device_kernels_per_step'] = len(kernels) / STEPS
    res['busy_share'] = device_ms / step_ms
    noted = ['angular', f'{radial}_radial'] + (['pme_window'] if combined
                                               else [])
    for kernel in noted:
        for part in ('fwd', 'bwd'):
            tag = f'{kernel}_{part}_kernel'
            tot, cnt = map(sum, zip(*[v for k, v in by_name.items()
                                      if tag in k] or [(0.0, 0)]))
            res[f'{kernel}_{part}'] = {
                'ms_per_step': tot / 1e3 / STEPS,
                'share': tot / 1e3 / STEPS / device_ms,
                'per_step': cnt / STEPS}
    res['top_kernels'] = [
        {'name': name[:90], 'ms_per_step': tot / 1e3 / STEPS,
         'share': tot / 1e3 / STEPS / device_ms,
         'per_step': cnt / STEPS}
        for name, (tot, cnt) in top]
    if args.out_dir is not None:
        args.out_dir.mkdir(parents=True, exist_ok=True)
        (args.out_dir / 'kernels.txt').write_text(
            prof.key_averages().table(sort_by='self_cuda_time_total',
                                      row_limit=40))
        prof.export_chrome_trace(str(args.out_dir / 'step_trace.json'))

    # 5: the config-5 step's parts, each alone.
    if combined:
        for name, fn in parts.items():
            part_ms, part_kernels = _profile(fn, STEPS)
            res['parts'][name].update(
                device_kernel_ms=part_ms, kernels=part_kernels,
                share_of_step_device_ms=part_ms / device_ms)

    # 7: the pair path's host side alone, on the step's own shapes.
    if radial == 'pair':
        res['pair_host'] = _pair_host(step, STEPS)

    # 8: the selection's two compactions.
    if args.impl == 'window':
        res['compaction'] = _compactions(model, pos, box, cell_list, 3)

    # 4: the neighbor gather's adjoint, index_select against advanced
    # indexing.
    if impl == 'window':
        # The angular tiers gather from the angular grid's slots (+2 rows
        # for the dropped and empty sentinels).
        idx = torch.cat([t.reshape(-1) for t in sel.tier.idx])
        n_slots = int(sel.ang.slot_to_atom.shape[0]) + 1
    else:
        idx = sel.nbr_rad.reshape(-1)
        n_slots = (cell_list.num_cells * cell_list.cell_capacity + 1
                   if cell_list.use_cells else model.num_atoms + 1)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    slots = torch.rand(n_slots, 3, device=dev, generator=gen).requires_grad_(True)
    cot = torch.rand(idx.numel(), 3, device=dev, generator=gen)
    gathers = {'index_select': lambda: slots.index_select(0, idx),
               'advanced': lambda: slots[idx]}
    grads = {k: torch.autograd.grad(g(), slots, cot)[0]
             for k, g in gathers.items()}
    # Normwise: the padding slot takes ~10^5 duplicate adds, so the two
    # summation orders differ there far above f32 epsilon in absolute terms.
    res['gather_adjoint_rel_diff'] = float(
        (grads['index_select'] - grads['advanced']).abs().max()
        / grads['advanced'].abs().max())
    times = {k: [] for k in gathers}
    for k in ('advanced', 'index_select', 'index_select', 'advanced'):
        times[k].append(_event_ms(
            lambda: torch.autograd.grad(gathers[k](), slots, cot), 20))
    res['gather_fwd_bwd_ms'] = times
    res['gather_indices'] = idx.numel()
    print(json.dumps(res))
    return res


if __name__ == '__main__':
    main()
