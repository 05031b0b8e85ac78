"""Where the time of the port's MD force step goes, on one CUDA GPU.

Builds the smoke configuration of ``chip_smoke.py`` (ANI-2x at full width,
8 random models, bf16 fused ensemble, skin 0.25 A, margin 1.15) on
``make_water_box(867)``, 2,601 atoms, in the window configuration (the
default; ``--impl pallas`` for the species-blocked one; ``--impl
combined`` for BASELINE config 5, ANI + PME as ``models.combined.config5``
builds it, margin 1.2), and measures, in one process:

1. the force step on a frozen selection, unprofiled: CUDA events and the
   host clock (synchronised), 3 runs of 8 steps;
2. the selection (``ANIModel.select``), the same two clocks, and with
   ``--impl combined`` the overflow counts a sticky run takes per block
   (CUDA events);
3. 8 force steps under ``torch.profiler``: device kernel time and
   device kernels per step, and the kernels that take the most time. The
   device busy share is that kernel time over the unprofiled CUDA-event
   step time of phase 1 (the profiler slows the host, so its own wall time
   is not the step's);
4. the neighbor gather and its autograd adjoint at this run's shapes (the
   payload gather of 'pallas', the angular tiers' gathers of 'window'),
   with ``index_select`` (an ``index_add`` adjoint, what the port uses)
   against advanced indexing (``slots[idx]``, a sort-based accumulating
   adjoint), timed in the order A, B, B, A;
5. with ``--impl combined``, the step's parts each alone (energy and
   position gradient of the ANI part, of the PME direct window and of the
   reciprocal and self terms): CUDA-event time (taken with phases 1-2,
   before any profiler session), and under ``torch.profiler`` device
   kernel time and kernels per call, which split the step's.

Prints one JSON object as its last line; with ``--out-dir`` also writes
the profiler's kernel table and a Chrome trace there. Run from the
repository root on a machine with a CUDA GPU:

    python3 -m nnpops_tpu_torch.profile_step --impl window --out-dir chiprun_out/profile
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import time

import torch

from . import ANIBasis, _kernels
from .models.ani import ANIModel, init_ani_params
from .models.combined import C5_SELF_ENERGIES, config5
from .utils import make_water_box

MOLECULES = 867
STEPS = 8
REPEATS = 3
SEED = 0
TOP = 12


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--impl', choices=('window', 'pallas', 'combined'),
                    default='window')
    ap.add_argument('--out-dir', type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_step: needs a CUDA GPU')
    dev = torch.device('cuda', 0)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)

    water = make_water_box(MOLECULES, seed=SEED)
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
                skin=0.25)
        if model.aev_impl != impl:
            raise SystemExit(f'profile_step: {impl} fell back to '
                             f'{model.aev_impl}')
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
    res = {'card': card, 'impl': args.impl, 'atoms': len(water.positions),
           'steps': STEPS}

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
