"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's ANI-2x MD force step (``nnpops_tpu_torch``, the 'pallas'
configuration: species-blocked selection, angular CUDA kernel, fused-NN CUDA
kernel, bf16 ensemble) on a 2,601-atom periodic water box at full ANI-2x
width with 8 random models made from a seed:

1. requires CUDA and prints the card's name and power limit;
2. builds the kernels from ``nnpops_tpu_torch/csrc`` (nvcc, sm_90a);
3. holds every kernel against its plain PyTorch version on the card at the
   main path's shapes, and times both with CUDA events;
4. runs the main path: 2 selection blocks x 8 force steps with the force
   nudge ``pos += 1e-6 * f``, ``check_overflow`` after each block, then the
   final frame's energy without gradients; asserts finite output, the
   kernels' launch counts, and E/F against the same step through the plain
   versions;
5. prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` as
   the last line.

Any failure raises (non-zero exit). Run from the repository root:

    python3 chip_smoke.py
"""
import json
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    print('chip_smoke: torch.cuda.is_available() is false', file=sys.stderr)
    sys.exit(1)

from nnpops_tpu_torch import ANIBasis, _kernels  # noqa: E402
from nnpops_tpu_torch.models.ani import (ANIModel, init_ani_params,  # noqa: E402
                                         plain_energy_and_forces)
from nnpops_tpu_torch.neighbors.blocked import payload_from_blocked  # noqa: E402
from nnpops_tpu_torch.ops.aev_blocked import compute_aev_blocked  # noqa: E402
from nnpops_tpu_torch.ops import cuda_aev, cuda_nn  # noqa: E402
from nnpops_tpu_torch.utils import make_water_box  # noqa: E402

MOLECULES = 867          # 2,601 atoms, box 29.6 A
SKIN = 0.25
REFRESH = 8
BLOCKS = 2
SEED = 0
DEV = torch.device('cuda', 0)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a, b):
    return float((a - b).abs().max())


def check_close(name, got, want, rtol, atol):
    """Elementwise |got - want| <= atol + rtol |want|."""
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f'{name}: {m}')


def check_normwise(name, got, want, rtol):
    """max |got - want| <= rtol * max |want|."""
    err, scale = max_abs(got, want), float(want.abs().max())
    if not err <= rtol * scale:
        raise AssertionError(f'{name}: max|diff| {err} > {rtol} * {scale}')


def main():
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    torch.cuda.set_device(DEV)

    t0 = time.perf_counter()
    _kernels.library()
    print(f'kernel build/load: {time.perf_counter() - t0:.1f} s '
          f'({_kernels.library_path().name})')

    water = make_water_box(MOLECULES, seed=SEED)
    basis = ANIBasis.ani2x()
    model = ANIModel.from_atomic_numbers(
        water.atomic_numbers, basis, nn_dtype='bfloat16',
        nn_impl='fused').with_blocked_layout(
            water.positions, water.box, margin=1.15, impl='pallas', skin=SKIN)
    layout = model.blocked_layout
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    params = init_ani_params(gen, basis, num_models=8, device=DEV)
    box = torch.tensor(water.box, device=DEV)
    pos = torch.tensor(water.positions, device=DEV)
    cell_list = model.create_cell_list(water.box, skin=SKIN)
    print(f'atoms {model.num_atoms}, layout rad_caps {layout.rad_caps} '
          f'ang_caps {layout.ang_caps}, cells {cell_list.ncells} x '
          f'{cell_list.cell_capacity}')

    # ---- Phase 3: every kernel against its plain version, main-path shapes.
    sel = model.select(pos, box, cell_list)
    order, _ = model._device_arrays(DEV)
    payload = payload_from_blocked(cell_list, pos, box, sel, rad_only=True,
                                   layout=layout,
                                   row_order=sel.inv_order[order])
    deltas = payload.rad_deltas.detach().contiguous()
    mask = payload.ang_mask.contiguous()
    width = deltas.shape[2]
    spec = cuda_aev._spec(basis, layout, width, DEV)
    print(f'angular input {tuple(deltas.shape)}, lanes {layout.ang_total}, '
          f'triples {len(spec.jj)}, segments {spec.n_seg}')
    kernels = []

    raw_k = cuda_aev.angular_fwd_cuda(deltas, mask, spec)
    raw_p = cuda_aev.angular_aev_plain(deltas, mask, basis, layout, width)
    a_k = cuda_aev.place_angular(raw_k, basis, layout)
    a_p = cuda_aev.place_angular(raw_p, basis, layout)
    check_close('angular fwd', a_k, a_p, rtol=3e-5, atol=3e-6)
    kernels.append(dict(
        name='angular_aev_fwd', route='cuda',
        source='nnpops_tpu_torch/csrc/angular_aev.cu',
        replaces='nnpops_tpu/ops/pallas_aev.py:409',
        max_abs_err=max_abs(a_k, a_p),
        ms=cuda_ms(lambda: cuda_aev.angular_fwd_cuda(deltas, mask, spec)),
        plain_ms=cuda_ms(lambda: cuda_aev.angular_aev_plain(
            deltas, mask, basis, layout, width))))

    # Gradient of sum(a^2), the JAX suite's angular gradient check.
    d_k = deltas.clone().requires_grad_(True)
    (g_k,) = torch.autograd.grad(
        cuda_aev.angular_aev(d_k, mask, basis, layout, width).square().sum(), d_k)
    d_p = deltas.clone().requires_grad_(True)
    raw_pg = cuda_aev.angular_aev_plain(d_p, mask, basis, layout, width)
    (g_p,) = torch.autograd.grad(
        cuda_aev.place_angular(raw_pg, basis, layout).square().sum(), d_p,
        retain_graph=True)
    check_close('angular bwd', g_k, g_p, rtol=2e-4, atol=2e-5)
    # Both backward times take the same cotangent of the kernel's raw
    # [N, n_seg * 32] output, so they time the same work.
    raw_req = raw_k.detach().requires_grad_(True)
    (raw_cot,) = torch.autograd.grad(
        cuda_aev.place_angular(raw_req, basis, layout).square().sum(), raw_req)
    raw_cot = raw_cot.contiguous()
    kernels.append(dict(
        name='angular_aev_bwd', route='cuda',
        source='nnpops_tpu_torch/csrc/angular_aev.cu',
        replaces='nnpops_tpu/ops/pallas_aev.py:565',
        max_abs_err=max_abs(g_k, g_p),
        ms=cuda_ms(lambda: cuda_aev.angular_bwd_cuda(deltas, mask, raw_cot, spec)),
        plain_ms=cuda_ms(lambda: torch.autograd.grad(
            raw_pg, d_p, raw_cot, retain_graph=True))))

    feat = torch.cat(compute_aev_blocked(payload, basis, layout, 'plain'),
                     1).detach()
    counts = model.grouping.counts
    nn_rows = []
    start = 0
    for s, count in enumerate(counts):
        if count:
            nn_rows.append((params.ensemble.networks[s],
                            feat[start:start + count].contiguous()))
            start += count
    stats = {'fwd': [0.0, 0.0, 0.0], 'fwdgrad': [0.0, 0.0, 0.0]}
    for net, x in nn_rows:
        packed = cuda_nn.pack_species_net(net)
        e_k, _ = cuda_nn.launch_packed(x, packed, False)
        e_p, _ = cuda_nn.fused_species_net_plain(x, net)
        # Normwise: a bf16 operand can round the other way when the f32
        # accumulation order differs, which moves a near-zero atom's energy
        # by far more than 1e-3 of itself but not of the block's scale.
        check_normwise('fused nn fwd', e_k, e_p, rtol=1e-3)
        e_kg, dx_k = cuda_nn.launch_packed(x, packed, True)
        e_pg, dx_p = cuda_nn.fused_species_net_plain(x, net, with_grad=True)
        check_normwise('fused nn fwdgrad e', e_kg, e_pg, rtol=1e-3)
        check_normwise('fused nn fwdgrad dx', dx_k, dx_p, rtol=1e-2)
        for key, err, fk, fp in (
                ('fwd', max_abs(e_k, e_p),
                 lambda: cuda_nn.launch_packed(x, packed, False),
                 lambda: cuda_nn.fused_species_net_plain(x, net)),
                ('fwdgrad', max(max_abs(e_kg, e_pg), max_abs(dx_k, dx_p)),
                 lambda: cuda_nn.launch_packed(x, packed, True),
                 lambda: cuda_nn.fused_species_net_plain(x, net, True))):
            st = stats[key]
            st[0] = max(st[0], err)
            st[1] += cuda_ms(fk)
            st[2] += cuda_ms(fp)
        print(f'fused nn rows {x.shape[0]} dims {packed.dims}: '
              f'max|de| {max_abs(e_kg, e_pg):.3g} (max|e| '
              f'{float(e_pg.abs().max()):.3g}) max|ddx| '
              f'{max_abs(dx_k, dx_p):.3g} (max|dx| {float(dx_p.abs().max()):.3g})')
    for key, line in (('fwd', 105), ('fwdgrad', 136)):
        err, ms, plain_ms = stats[key]
        kernels.append(dict(
            name=f'fused_nn_{key}', route='cuda',
            source='nnpops_tpu_torch/csrc/fused_nn.cu',
            replaces=f'nnpops_tpu/ops/pallas_nn.py:{line}',
            max_abs_err=err, ms=ms, plain_ms=plain_ms))
    for k in kernels:
        print(f"{k['name']}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} "
              f"ms, max|err| {k['max_abs_err']:.3g}")
    del d_p, raw_pg, g_p, raw_p, a_p

    # ---- Phase 4: the main path.
    def force_block(p):
        sel = model.select(p, box, cell_list)
        energies = []
        for _ in range(REFRESH):
            e, f = model.energy_and_forces_from_selection(params, p, box,
                                                          cell_list, sel)
            energies.append(e)
            p = p + 1e-6 * f
        return p, sel, f, torch.stack(energies)

    force_block(pos)                                  # warm-up, not counted
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    p = pos
    start.record()
    for _ in range(BLOCKS):
        p, sel, f, energies = force_block(p)
        model.check_overflow(p, box, cell_list, sel)
    end.record()
    torch.cuda.synchronize()
    ms_per_step = start.elapsed_time(end) / (BLOCKS * REFRESH)
    with torch.no_grad():
        e_final = model.energy_from_selection(params, p, box, cell_list, sel)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    print(f'main path: {BLOCKS * REFRESH} steps, {ms_per_step:.3f} ms/step '
          f'(CUDA events, selection included), launches {launches}')
    if not (torch.isfinite(energies).all() and torch.isfinite(f).all()
            and torch.isfinite(e_final)):
        raise AssertionError('non-finite energy or forces')
    if tuple(f.shape) != (model.num_atoms, 3):
        raise AssertionError(f'forces shape {tuple(f.shape)}')
    steps = BLOCKS * REFRESH
    need = {'angular_aev_fwd': steps, 'angular_aev_bwd': steps,
            'fused_nn_fwdgrad': 2 * steps, 'fused_nn_fwd': 1}
    for name, n in need.items():
        if launches[name] < n:
            raise AssertionError(f'{name}: {launches[name]} launches < {n}')
    for k in kernels:
        k['launches'] = launches[k['name']]

    # One step through the kernels against the same step through the plain
    # versions, on the card.
    e_k, f_k = model.energy_and_forces_from_selection(params, p, box,
                                                      cell_list, sel)
    e_p, f_p = plain_energy_and_forces(model, params, p, box, cell_list, sel)
    check_close('step energy', e_k, e_p, rtol=1e-3, atol=0.0)
    check_normwise('step forces', f_k, f_p, rtol=5e-3)
    print(f'step vs plain: E {float(e_k):.6f} vs {float(e_p):.6f}, '
          f'max|dF| {max_abs(f_k, f_p):.3g} (max|F| {float(f_p.abs().max()):.3g})')

    print(json.dumps({'kernels': [
        {key: k[key] for key in ('name', 'route', 'source', 'replaces',
                                 'launches', 'max_abs_err', 'ms', 'plain_ms')}
        for k in kernels]}))
    print(smi[0])
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
