"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's ANI-2x MD force step (``nnpops_tpu_torch``, bf16 fused
ensemble, 8 random models made from a seed, full ANI-2x width, skin
0.25 A, refresh 8, margin 1.15) on periodic water boxes:

1. requires CUDA and prints the card's name and power limit;
2. builds the kernels from ``nnpops_tpu_torch/csrc`` (nvcc, sm_90a);
3. the 'pallas' configuration at 2,601 atoms (species-blocked selection,
   angular kernel, fused-NN kernel): the angular and fused-NN kernels
   against their plain PyTorch versions at its shapes, then 2 selection
   blocks x 8 force steps with the force nudge ``pos += 1e-6 * f``,
   ``check_overflow`` after each block, and the launch counts;
4. the window configuration at 2,601 atoms, the main path: every kernel
   it launches (left-pack, window radial forward and backward, angular
   forward and backward per row tier, fused NN forward and fwdgrad) against
   its plain version at the shapes the path gives it, recorded from one
   selection and one step, plus the window radial kernel with forced
   cell-occupancy bucketing; each kernel timed on the device (20 calls
   captured in a CUDA graph, replayed between CUDA events) beside its plain
   version (CUDA events around 20 eager calls) and its bound;
5. the window main path: 2 selection blocks x 8 force steps as in 3, the
   final frame's energy without gradients, the launch counts (every step
   launches the window radial forward and backward and the angular kernel
   once per tier, every selection the left-pack), and one step against the
   same step through the plain versions;
6. one selection and 4 steps of the window path at 26,010 atoms, where the
   planner turns on bucketing and four angular tiers: finite output, no
   overflow, ms/step;
7. BASELINE config 5, ANI + PME Langevin MD (``models.combined.ANIWithPME``
   with ``md.integrators``), on the JAX example's settings
   (``examples/run_configs.py`` ``config5``: window ANI-2x, bf16 fused
   ensemble, skin 0.25, margin 1.2, refresh 5, self energies
   ``linspace(-40, -1, 7)``; PME grid the next power of two of the box
   edge (at least 16), order 5, alpha 0.6, coulomb 1389.35457, exclusions
   ``full((n, 1), -1)``, cutoff 5.0, bucketed window plan; charges x 0.2,
   masses O 16 and H 1; BAOAB with dt 2e-4, friction 5, kT 0.596):
   (a) at 2,601 atoms the PME window kernel's forward and backward against
   their plain version on the inputs of one force step, timed, plus one
   call with a forced bucketed plan and the intramolecular exclusions;
   (b) the config-5 MD at 2,601 atoms: one warm-up block, then 8 blocks of
   5 steps between CUDA events (ms/step, selection and PME included), the
   count maxima against their capacities, ``check_overflow``, the launch
   counts, and one step against the same step through the plain versions;
   (c) config 5 at 26,010 atoms (bucketed PME plan, four angular tiers):
   one warm-up block, then 2 blocks of 5 steps: finite, no overflow,
   ms/step;
8. SchNet/CFConv, the JAX package's ``bench_cfconv_periodic`` chain at
   full width (``models.schnet.periodic_stack``: 26,010 atoms at density
   0.1, width 128, 50 Gaussians, 10 A cutoff, 6 layers, a 6x6x6 cell grid,
   640 neighbor lanes, 2048-row chunks): (a) the CFConv backward kernel
   against its plain version on the inputs of one layer's backward, timed,
   plus one small call with the tanh activation; (b) 1 warm-up and 2 timed
   iterations (select with mirror, distance payload, 6 layers, gradients
   of the sum with respect to positions, inputs and weights; ms/iteration,
   no overflow, 6 kernel launches an iteration), then one iteration
   against the same iteration through the plain backward; (c) the pair
   path, which has no kernel: config 2 (``SchNetModel``, 21 atoms, 3
   interactions) and the O(N^2) harness (the stack over
   ``build_cfconv_neighbors`` at 1,000 atoms);
9. the window path's opt-in switches (the z-pair and cluster-pair radial
   kernels, the 'mask' compaction): (a) each of their kernels against its
   plain version at the shapes its path gives it, timed: the z-pair
   forward and backward at 2,601 and 26,010 atoms, the cluster-pair
   forward and backward per i-species at 26,010, the mask and lane
   left-pack on the 26,010-atom angular grid; (b) ``window_radial='pair'``
   at 2,601 atoms, 2 selection blocks x 8 steps as in 5 (launch counts
   read just after), and on a frozen 26,010-atom selection, each step
   against its plain step and against the 'window' step; (c)
   ``with_blocked_layout(radial_impl='cluster')`` at 26,010 atoms (the
   planner's time printed): one selection and 4 frozen steps with the
   counts set to 0 just before, no overflow, one step against its plain
   step and the 'window' step; (d) ``select_window(compact_impl='mask')``
   at 26,010 atoms, twice with the counts set to 0 just before, equal to
   the 'kernel' selection field by field and timed beside it;
10. prints the wall time, the kernels' JSON line, the card line again,
   then ``{"ok": true, "device": ...}`` as the last line.

Any failure raises (non-zero exit). Run from the repository root:

    python3 chip_smoke.py
"""
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print('chip_smoke: torch.cuda.is_available() is false', file=sys.stderr)
    sys.exit(1)

from nnpops_tpu_torch import ANIBasis, _kernels  # noqa: E402
from nnpops_tpu_torch.md import (initialize, langevin_baoab,  # noqa: E402
                                 run_md_sticky_counts)
from nnpops_tpu_torch.models import combined as combined_mod  # noqa: E402
from nnpops_tpu_torch.models.combined import (  # noqa: E402
    C5_DT, C5_FRICTION, C5_KT, C5_REFRESH, C5_SELF_ENERGIES)
from nnpops_tpu_torch.models import ani as ani_mod  # noqa: E402
from nnpops_tpu_torch.models import schnet as schnet_mod  # noqa: E402
from nnpops_tpu_torch.models.ani import (ANIModel, init_ani_params,  # noqa: E402
                                         plain_energy_and_forces)
from nnpops_tpu_torch.neighbors import clusters as clusters_mod  # noqa: E402
from nnpops_tpu_torch.neighbors import window as window_mod  # noqa: E402
from nnpops_tpu_torch.neighbors.blocked import payload_from_blocked  # noqa: E402
from nnpops_tpu_torch.ops import (cuda_aev, cuda_cfconv,  # noqa: E402
                                  cuda_cluster, cuda_nn, cuda_pme,
                                  cuda_select, cuda_window, cuda_zpair)
from nnpops_tpu_torch.ops.cfconv import build_cfconv_neighbors  # noqa: E402
from nnpops_tpu_torch.ops.pme import PME  # noqa: E402
from nnpops_tpu_torch.ops.aev_blocked import compute_aev_blocked  # noqa: E402
from nnpops_tpu_torch.profile_step import recording  # noqa: E402
from nnpops_tpu_torch.utils import make_water_box  # noqa: E402

MOLECULES = 867          # 2,601 atoms, box 29.6 A
LARGE_MOLECULES = 8670   # 26,010 atoms, box 63.8 A
SKIN = 0.25
MARGIN = 1.15
REFRESH = 8
BLOCKS = 2
LARGE_STEPS = 4
SEED = 0
DEV = torch.device('cuda', 0)

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 operations/s
# outside the tensor cores, bf16 tensor-core operations/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# Operations per unit of work, counted from the CUDA sources (an FMA counts
# two, a sqrt, exp or log one): angular_aev.cu per triple whose two lanes
# are inside the cutoff; window_radial.cu per (real center, window lane)
# pair tested and per pair inside the cutoff, R = 16 Gaussians.
ANG_FWD_OPS = 175
ANG_BWD_OPS = 420
RAD_TEST_OPS = 10
RAD_FWD_OPS = 135
RAD_BWD_OPS = 205
# pme_window.cu per (real center, window lane) pair tested and per pair
# inside the cutoff (one evaluation per pair; its backward makes two).
PME_TEST_OPS = 10
PME_FWD_OPS = 22
PME_BWD_OPS = 38
# pair_radial.cu and cluster_radial.cu per (real center, lane) pair tested
# and per pair inside the cutoff (R = 16 Gaussians; the pair kernel's one
# evaluation serves both atoms of the pair); window_mask.cu per (center,
# lane) pair; left_pack_lanes per mask byte.
PAIR_TEST_OPS = 10
PAIR_FWD_OPS = 100
PAIR_BWD_OPS = 150
CLUSTER_TEST_OPS = 10
CLUSTER_FWD_OPS = 120
CLUSTER_BWD_OPS = 200
MASK_OPS = 10
LANE_PACK_OPS = 3

# Depth of the config-5 runs (its settings are models.combined's).
C5_BLOCKS = 8
C5_LARGE_BLOCKS = 2
# Timed iterations of the 26k CFConv stack (models.schnet.periodic_stack)
# and the atoms of the O(N^2) CFConv harness.
CFCONV_ITERS = 2
CFCONV_PAIR_ATOMS = 1000

REPLACES = {
    'angular_aev_fwd': 'nnpops_tpu/ops/pallas_aev.py:614',
    'angular_aev_bwd': 'nnpops_tpu/ops/pallas_aev.py:626',
    'fused_nn_fwd': 'nnpops_tpu/ops/pallas_nn.py:183',
    'fused_nn_fwdgrad': 'nnpops_tpu/ops/pallas_nn.py:194',
    'left_pack': 'nnpops_tpu/ops/pallas_select.py:139',
    'window_radial_fwd': 'nnpops_tpu/ops/pallas_window.py:361',
    'window_radial_bwd': 'nnpops_tpu/ops/pallas_window.py:378',
    # One pl.pallas_call (:288 with the cell map, :292 without) runs both
    # kernels of B.5; each entry names its kernel body.
    'pme_window_fwd': 'nnpops_tpu/ops/pallas_pme.py:177',
    'pme_window_bwd': 'nnpops_tpu/ops/pallas_pme.py:199',
    'cfconv_bwd': 'nnpops_tpu/ops/pallas_cfconv.py:182',
    'window_mask': 'nnpops_tpu/ops/pallas_select.py:244',
    'left_pack_lanes': 'nnpops_tpu/ops/pallas_select.py:334',
    'cluster_radial_fwd': 'nnpops_tpu/ops/pallas_cluster.py:180',
    'cluster_radial_bwd': 'nnpops_tpu/ops/pallas_cluster.py:191',
    'pair_radial_fwd': 'nnpops_tpu/ops/pallas_zpair.py:219',
    'pair_radial_bwd': 'nnpops_tpu/ops/pallas_zpair.py:233',
}
SOURCES = {
    'angular_aev': 'nnpops_tpu_torch/csrc/angular_aev.cu',
    'cfconv_bwd': 'nnpops_tpu_torch/csrc/cfconv_bwd.cu',
    'cluster_radial': 'nnpops_tpu_torch/csrc/cluster_radial.cu',
    'pair_radial': 'nnpops_tpu_torch/csrc/pair_radial.cu',
    'window_mask': 'nnpops_tpu_torch/csrc/window_mask.cu',
    'fused_nn': 'nnpops_tpu_torch/csrc/fused_nn.cu',
    'left_pack': 'nnpops_tpu_torch/csrc/left_pack.cu',
    'pme_window': 'nnpops_tpu_torch/csrc/pme_window.cu',
    'window_radial': 'nnpops_tpu_torch/csrc/window_radial.cu',
}


def cuda_ms(fn, iters=20, warmup=3):
    """Mean time of ``fn`` in ms from CUDA events around ``iters`` eager
    calls: for a call of many small kernels (the plain versions) the host's
    launch rate is part of it."""
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


def graph_ms(fn, iters=20, replays=5):
    """Mean device time of one call of a kernel's wrapper ``fn`` in ms:
    ``iters`` calls captured in one CUDA graph (the wrappers launch on the
    current stream, which the capture redirects), replayed ``replays`` times
    between CUDA events, so the host's launch rate stays out of the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode='relaxed'):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def max_abs(a, b):
    return float((a - b).detach().abs().max())


def check_close(name, got, want, rtol, atol):
    """Elementwise |got - want| <= atol + rtol |want|."""
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f'{name}: {m}')


def check_normwise(name, got, want, rtol):
    """max |got - want| <= rtol * max |want|."""
    err, scale = max_abs(got, want), float(want.detach().abs().max())
    if not err <= rtol * scale:
        raise AssertionError(f'{name}: max|diff| {err} > {rtol} * {scale}')


def entry(name, source, err, kernel_fn, plain_fn, nbytes, ops, ops_per_s,
          calls=20):
    """One kernel's JSON entry: ``ms`` the kernel's device time
    (:func:`graph_ms` over ``calls`` calls), ``event_ms`` the same calls
    launched eagerly (not in the JSON line), ``plain_ms`` the plain
    version's; the bound is the larger of the bytes over the memory rate
    and the operations over the peak for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return dict(name=name, route='cuda', source=SOURCES[source],
                replaces=REPLACES[name], max_abs_err=err,
                ms=graph_ms(kernel_fn, iters=calls),
                event_ms=cuda_ms(kernel_fn, iters=calls),
                plain_ms=cuda_ms(plain_fn, iters=calls),
                bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations',
                library_ms=None)


def merge(entries):
    """Sum entries of one kernel over several launches (tiers, species)."""
    out = dict(entries[0])
    for key in ('ms', 'event_ms', 'plain_ms', 'bound_ms'):
        out[key] = sum(e[key] for e in entries)
    out['max_abs_err'] = max(e['max_abs_err'] for e in entries)
    return out


def build(molecules, impl, basis):
    water = make_water_box(molecules, seed=SEED)
    model = ANIModel.from_atomic_numbers(
        water.atomic_numbers, basis, nn_dtype='bfloat16',
        nn_impl='fused').with_blocked_layout(
            water.positions, water.box, margin=MARGIN, impl=impl, skin=SKIN)
    if model.aev_impl != impl:
        raise AssertionError(f'{impl} layout fell back to {model.aev_impl}')
    box = torch.tensor(water.box, device=DEV)
    pos = torch.tensor(water.positions, device=DEV)
    return water, model, model.create_cell_list(water.box, skin=SKIN), pos, box


# ---------------------------------------------------------------------------
# Kernel checks: each kernel against its plain version on the same inputs.
# ---------------------------------------------------------------------------

def angular_entries(deltas, mask, basis, layout, width):
    """(fwd, bwd) entries of the angular kernel on one input."""
    spec = cuda_aev._spec(basis, layout, width, DEV)
    raw_k = cuda_aev.angular_fwd_cuda(deltas, mask, spec)
    raw_p = cuda_aev.angular_aev_plain(deltas, mask, basis, layout, width)
    a_k = cuda_aev.place_angular(raw_k, basis, layout)
    a_p = cuda_aev.place_angular(raw_p, basis, layout)
    check_close('angular fwd', a_k, a_p, rtol=3e-5, atol=3e-6)
    # Gradient of sum(a^2), the JAX suite's angular gradient check.
    d_k = deltas.clone().requires_grad_(True)
    (g_k,) = torch.autograd.grad(
        cuda_aev.angular_aev(d_k, mask, basis, layout, width).square().sum(),
        d_k)
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
    # Work: the triples whose two lanes are inside the cutoff.
    d = deltas[:, :, spec.lane_pos.long()]
    inside = mask & (d.square().sum(0).sqrt() < basis.angular_cutoff)
    triples = int((inside[:, spec.jj.long()] & inside[:, spec.kk.long()]).sum())
    io = deltas.numel() * 4 + mask.numel()
    fwd = entry('angular_aev_fwd', 'angular_aev', max_abs(a_k, a_p),
                lambda: cuda_aev.angular_fwd_cuda(deltas, mask, spec),
                lambda: cuda_aev.angular_aev_plain(deltas, mask, basis,
                                                   layout, width),
                io + raw_k.numel() * 4, triples * ANG_FWD_OPS, F32_OPS_PER_S)
    bwd = entry('angular_aev_bwd', 'angular_aev', max_abs(g_k, g_p),
                lambda: cuda_aev.angular_bwd_cuda(deltas, mask, raw_cot, spec),
                lambda: torch.autograd.grad(raw_pg, d_p, raw_cot,
                                            retain_graph=True),
                io + raw_cot.numel() * 4 + deltas.numel() * 4,
                triples * ANG_BWD_OPS, F32_OPS_PER_S)
    print(f'angular rows {deltas.shape[1]} lanes {spec.kat} triples '
          f'{len(spec.jj)} (inside the cutoff {triples}): fwd {fwd["ms"]:.4f} '
          f'ms, bwd {bwd["ms"]:.4f} ms')
    return fwd, bwd


def nn_entries(params, feat, counts):
    """(fwd, fwdgrad) entries of the fused-NN kernel over the species row
    blocks of species-grouped AEV rows."""
    fwds, grads = [], []
    start = 0
    for s, count in enumerate(counts):
        if not count:
            continue
        net = params.ensemble.networks[s]
        x = feat[start:start + count].contiguous()
        start += count
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
        macs = net.weights[0].shape[0] * sum(w.shape[1] * w.shape[2]
                                             for w in net.weights)
        w_bytes = 2 * macs + 4 * sum(b.numel() for b in net.biases)
        flops = 2 * count * macs
        fwds.append(entry(
            'fused_nn_fwd', 'fused_nn', max_abs(e_k, e_p),
            lambda: cuda_nn.launch_packed(x, packed, False),
            lambda: cuda_nn.fused_species_net_plain(x, net),
            x.numel() * 4 + w_bytes + count * 4, flops, BF16_OPS_PER_S))
        grads.append(entry(
            'fused_nn_fwdgrad', 'fused_nn',
            max(max_abs(e_kg, e_pg), max_abs(dx_k, dx_p)),
            lambda: cuda_nn.launch_packed(x, packed, True),
            lambda: cuda_nn.fused_species_net_plain(x, net, True),
            2 * x.numel() * 4 + w_bytes + count * 4, 2 * flops,
            BF16_OPS_PER_S))
        print(f'fused nn rows {count} dims {packed.dims}: max|de| '
              f'{max_abs(e_kg, e_pg):.3g} (max|e| {float(e_pg.abs().max()):.3g})'
              f' max|ddx| {max_abs(dx_k, dx_p):.3g} (max|dx| '
              f'{float(dx_p.abs().max()):.3g})')
    return merge(fwds), merge(grads)


def left_pack_entry(keys, widths, caps):
    packed, counts = cuda_select.left_pack_cuda(keys, widths, caps)
    p_packed, p_counts = cuda_select.left_pack_plain(keys, widths, caps)
    if not (torch.equal(packed, p_packed) and torch.equal(counts, p_counts)):
        raise AssertionError('left_pack: kernel and plain version differ')
    e = entry('left_pack', 'left_pack', 0.0,
              lambda: cuda_select.left_pack_cuda(keys, widths, caps),
              lambda: cuda_select.left_pack_plain(keys, widths, caps),
              4 * (keys.numel() + packed.numel() + counts.numel()),
              3 * keys.numel(), F32_OPS_PER_S)
    print(f'left_pack keys {tuple(keys.shape)} widths {tuple(widths)} caps '
          f'{tuple(caps)}: {e["ms"]:.4f} ms, plain {e["plain_ms"]:.4f} ms')
    return e


def radial_entries(args, kwargs):
    """(fwd, bwd) entries of the window radial kernel on one recorded call
    of ``window_radial(candx, candy, candz, centers, rc, eta, rs, cell_caps,
    torchani, center_caps=...)``."""
    cx, cy, cz, ctr = (t.detach().contiguous() for t in args[:4])
    rc, eta, rs, caps, torchani = args[4:9]
    center_caps = kwargs.get('center_caps')
    spec = cuda_window._spec(
        tuple(int(x) for x in caps),
        None if center_caps is None else tuple(int(x) for x in center_caps),
        float(rc), tuple(float(x) for x in eta), tuple(float(x) for x in rs),
        bool(torchani))
    out_k = cuda_window.window_radial_fwd_cuda(cx, cy, cz, ctr, spec)
    ins = [t.clone().requires_grad_(True) for t in (cx, cy, cz, ctr)]
    out_p = cuda_window.window_radial_plain(*ins, *args[4:9],
                                            center_caps=center_caps)
    check_normwise('window radial fwd', out_k, out_p, rtol=1e-5)
    g = (2.0 * out_p).detach().contiguous()       # cotangent of sum(out^2)
    grads_k = cuda_window.window_radial_bwd_cuda(cx, cy, cz, ctr, g, spec)
    grads_p = torch.autograd.grad(out_p, ins, g, retain_graph=True)
    for name, a, b in zip(('dcandx', 'dcandy', 'dcandz', 'dcenters'),
                          grads_k, grads_p):
        check_normwise(f'window radial bwd {name}', a, b, rtol=1e-4)
    # Work: the pairs of real centers with window lanes, and those inside
    # the cutoff (the self lane excluded).
    geo = spec.geo
    real = ctr[:, :, 0] < cuda_window.EMPTY_ROW
    d2 = sum((c[:, None, :] - ctr[:, :, i:i + 1]).square()
             for i, c in enumerate((cx, cy, cz)))
    lane = torch.arange(geo.kk, device=DEV)
    self_lane = torch.as_tensor(geo.self_lane, device=DEV)
    inside = int(((d2 < float(rc) ** 2) & (lane != self_lane[:, None])
                  & real[:, :, None]).sum())
    tested = int(real.sum()) * geo.kk
    io = 4 * (3 * cx.numel() + ctr.numel())
    fwd = entry('window_radial_fwd', 'window_radial', max_abs(out_k, out_p),
                lambda: cuda_window.window_radial_fwd_cuda(cx, cy, cz, ctr,
                                                           spec),
                lambda: cuda_window.window_radial_plain(
                    cx, cy, cz, ctr, *args[4:9], center_caps=center_caps),
                io + 4 * out_k.numel(),
                tested * RAD_TEST_OPS + inside * RAD_FWD_OPS, F32_OPS_PER_S)
    bwd = entry('window_radial_bwd', 'window_radial',
                max(max_abs(a, b) for a, b in zip(grads_k, grads_p)),
                lambda: cuda_window.window_radial_bwd_cuda(cx, cy, cz, ctr, g,
                                                           spec),
                lambda: torch.autograd.grad(out_p, ins, g, retain_graph=True),
                2 * io + 4 * g.numel(),
                tested * RAD_TEST_OPS + inside * RAD_BWD_OPS, F32_OPS_PER_S)
    print(f'window radial cells {cx.shape[0]} center rows {ctr.shape[1]} '
          f'lanes {geo.kk} (pairs tested {tested}, inside {inside}): fwd '
          f'{fwd["ms"]:.4f} ms (plain {fwd["plain_ms"]:.4f}), bwd '
          f'{bwd["ms"]:.4f} ms (plain {bwd["plain_ms"]:.4f})')
    return fwd, bwd


# ---------------------------------------------------------------------------
# Driving a path.
# ---------------------------------------------------------------------------

def force_blocks(model, params, pos, box, cell_list, blocks, steps):
    """``blocks`` selections of ``steps`` nudged force steps each, with
    ``check_overflow`` after each block; (pos, sel, f, energies)."""
    p = pos
    for _ in range(blocks):
        sel = model.select(p, box, cell_list)
        energies = []
        for _ in range(steps):
            e, f = model.energy_and_forces_from_selection(params, p, box,
                                                          cell_list, sel)
            energies.append(e)
            p = p + 1e-6 * f
        model.check_overflow(p, box, cell_list, sel)
    return p, sel, f, torch.stack(energies)


def drive(label, model, params, pos, box, cell_list):
    """The path's main run: counts set to 0 just before, read just after.
    Returns (launches, pos, sel)."""
    force_blocks(model, params, pos, box, cell_list, 1, REFRESH)   # warm-up
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    p, sel, f, energies = force_blocks(model, params, pos, box, cell_list,
                                       BLOCKS, REFRESH)
    end.record()
    torch.cuda.synchronize()
    with torch.no_grad():
        e_final = model.energy_from_selection(params, p, box, cell_list, sel)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    print(f'{label} main path: {BLOCKS * REFRESH} steps, '
          f'{start.elapsed_time(end) / (BLOCKS * REFRESH):.3f} ms/step (CUDA '
          f'events, selection included), launches {launches}')
    if not (torch.isfinite(energies).all() and torch.isfinite(f).all()
            and torch.isfinite(e_final)):
        raise AssertionError(f'{label}: non-finite energy or forces')
    if tuple(f.shape) != (model.num_atoms, 3):
        raise AssertionError(f'{label}: forces shape {tuple(f.shape)}')
    return launches, p, sel


def require_launches(label, launches, need):
    for name, n in need.items():
        if launches[name] < n:
            raise AssertionError(f'{label}: {name} launched {launches[name]}'
                                 f' times, expected at least {n}')


def step_vs_plain(label, model, params, p, box, cell_list, sel):
    """One step through the kernels against the same step through the
    plain versions, on the card."""
    e_k, f_k = model.energy_and_forces_from_selection(params, p, box,
                                                      cell_list, sel)
    e_p, f_p = plain_energy_and_forces(model, params, p, box, cell_list, sel)
    check_close(f'{label} step energy', e_k, e_p, rtol=1e-3, atol=0.0)
    check_normwise(f'{label} step forces', f_k, f_p, rtol=5e-3)
    print(f'{label} step vs plain: E {float(e_k):.6f} vs {float(e_p):.6f}, '
          f'max|dF| {max_abs(f_k, f_p):.3g} (max|F| '
          f'{float(f_p.abs().max()):.3g})')


def pallas_phase(basis, params):
    """Phase 3: the 'pallas' configuration (the first slice's path)."""
    water, model, cell_list, pos, box = build(MOLECULES, 'pallas', basis)
    layout = model.blocked_layout
    print(f'pallas: atoms {model.num_atoms}, rad_caps {layout.rad_caps} '
          f'ang_caps {layout.ang_caps}, cells {cell_list.ncells} x '
          f'{cell_list.cell_capacity}')
    sel = model.select(pos, box, cell_list)
    order, _ = model._device_arrays(DEV)
    payload = payload_from_blocked(cell_list, pos, box, sel, rad_only=True,
                                   layout=layout,
                                   row_order=sel.inv_order[order])
    deltas = payload.rad_deltas.detach().contiguous()
    angular_entries(deltas, payload.ang_mask.contiguous(), basis, layout,
                    deltas.shape[2])
    feat = torch.cat(compute_aev_blocked(payload, basis, layout, 'plain'),
                     1).detach()
    nn_entries(params, feat, model.grouping.counts)
    launches, p, sel = drive('pallas', model, params, pos, box, cell_list)
    steps = BLOCKS * REFRESH
    require_launches('pallas', launches, {
        'angular_aev_fwd': steps, 'angular_aev_bwd': steps,
        'fused_nn_fwdgrad': 2 * steps, 'fused_nn_fwd': 1})
    step_vs_plain('pallas', model, params, p, box, cell_list, sel)


def bucketed(model, water, cell_list):
    """The model with cell-occupancy bucketing forced: small-class caps one
    under the median per-(cell, species) occupancy."""
    layout = model.blocked_layout
    grid = np.asarray(layout.cell_grid)
    frac = water.positions.astype(np.float64) @ np.linalg.inv(water.box)
    c3 = np.minimum(((frac - np.floor(frac)) * grid).astype(int), grid - 1)
    cid = (c3[:, 0] * grid[1] + c3[:, 1]) * grid[2] + c3[:, 2]
    occ = np.stack([np.bincount(cid[model.species_array == s],
                                minlength=cell_list.num_cells)
                    for s in layout.present], 1)
    small = tuple(int(x) for x in np.maximum(np.median(occ, 0) - 1, 1))
    n_big = int((occ > np.asarray(small)).any(1).sum())
    return dataclasses.replace(model, blocked_layout=dataclasses.replace(
        layout, small_caps=small,
        num_big_cells=min(-(-(n_big + 8) // 8) * 8, cell_list.num_cells)))


def window_kernel_phase(basis, params):
    """Phase 4: every kernel of the window path against its plain version,
    on the inputs one selection and one step give it."""
    water, model, cell_list, pos, box = build(MOLECULES, 'window', basis)
    layout = model.blocked_layout
    print(f'window: atoms {model.num_atoms}, grid {layout.cell_grid} '
          f'cell_caps {layout.cell_caps}, angular grid {layout.ang_cell_grid} '
          f'caps {layout.ang_cell_caps}, ang_caps {layout.ang_caps}, tiers '
          f'{layout.ang_tier_caps} rows {layout.ang_tier_rows}, bucketing '
          f'{layout.small_caps} / {layout.num_big_cells}')
    packs, radials, angulars, feats = [], [], [], []
    with recording(window_mod, 'left_pack', packs):
        sel = model.select(pos, box, cell_list)
    with recording(window_mod, 'window_radial', radials), \
            recording(cuda_aev, 'angular_aev', angulars), \
            recording(ani_mod, 'ensemble_energy_grouped_rows_fused', feats):
        model.energy_and_forces_from_selection(params, pos, box, cell_list,
                                               sel)
    big = bucketed(model, water, cell_list)
    big_radials = []
    with recording(window_mod, 'window_radial', big_radials):
        big_sel = big.select(pos, box, cell_list)
        big.check_overflow(pos, box, cell_list, big_sel)
        big.energy_and_forces_from_selection(params, pos, box, cell_list,
                                             big_sel)
    ntiers = 1 + len(layout.ang_tier_caps or ())
    if not (len(packs) == 1 and len(radials) == 1 and len(big_radials) == 2
            and len(angulars) == ntiers and len(feats) == 1):
        raise AssertionError('unexpected kernel calls: '
                             f'{len(packs)} {len(radials)} {len(big_radials)}'
                             f' {len(angulars)} {len(feats)}')
    (args, _), = packs
    kernels = {'left_pack': left_pack_entry(*args)}
    fwd, bwd = radial_entries(*radials[0])
    print(f'bucketed radial (small_caps {big.blocked_layout.small_caps}, '
          f'num_big_cells {big.blocked_layout.num_big_cells}):')
    for args, kwargs in big_radials:
        b_fwd, b_bwd = radial_entries(args, kwargs)
        fwd['max_abs_err'] = max(fwd['max_abs_err'], b_fwd['max_abs_err'])
        bwd['max_abs_err'] = max(bwd['max_abs_err'], b_bwd['max_abs_err'])
    kernels.update(window_radial_fwd=fwd, window_radial_bwd=bwd)
    ang = [angular_entries(a[0].detach().contiguous(), a[1].contiguous(),
                           *a[2:5]) for a, _ in angulars]
    kernels['angular_aev_fwd'] = merge([f for f, _ in ang])
    kernels['angular_aev_bwd'] = merge([b for _, b in ang])
    (args, _), = feats
    kernels['fused_nn_fwd'], kernels['fused_nn_fwdgrad'] = nn_entries(
        params, args[1].detach(), args[2])
    for k in kernels.values():
        print(f"{k['name']}: kernel {k['ms']:.4f} ms (CUDA graph; eager "
              f"launches {k['event_ms']:.4f} ms), plain "
              f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']}), max|err| {k['max_abs_err']:.3g}")
    return model, cell_list, pos, box, kernels


def window_large_phase(basis, params):
    """Phase 6: one selection and 4 steps at 26,010 atoms."""
    _, model, cell_list, pos, box = build(LARGE_MOLECULES, 'window', basis)
    layout = model.blocked_layout
    print(f'window 26k: atoms {model.num_atoms}, grid {layout.cell_grid} '
          f'cell_caps {layout.cell_caps}, bucketing {layout.small_caps} / '
          f'{layout.num_big_cells}, tiers {layout.ang_tier_caps}')
    if layout.small_caps is None or len(layout.ang_tier_caps or ()) != 3:
        raise AssertionError('26k plan: expected bucketing and four tiers')
    t0 = time.perf_counter()
    sel = model.select(pos, box, cell_list)
    model.check_overflow(pos, box, cell_list, sel)
    torch.cuda.synchronize()
    select_s = time.perf_counter() - t0
    model.energy_and_forces_from_selection(params, pos, box, cell_list, sel)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    p = pos
    start.record()
    for _ in range(LARGE_STEPS):
        e, f = model.energy_and_forces_from_selection(params, p, box,
                                                      cell_list, sel)
        p = p + 1e-6 * f
    end.record()
    torch.cuda.synchronize()
    model.check_overflow(p, box, cell_list, sel)
    if not (torch.isfinite(e) and torch.isfinite(f).all()):
        raise AssertionError('26k: non-finite energy or forces')
    print(f'window 26k: first selection {1e3 * select_s:.1f} ms (host clock, '
          f'with check_overflow), {start.elapsed_time(end) / LARGE_STEPS:.3f} '
          f'ms/step over {LARGE_STEPS} steps (CUDA events, frozen selection),'
          f' E {float(e):.4f}')


# ---------------------------------------------------------------------------
# BASELINE config 5: ANI + PME Langevin MD.
# ---------------------------------------------------------------------------

def pme_entries(args, label):
    """(fwd, bwd) entries of the PME window kernel on one recorded call of
    ``pme_window(candx, candy, candz, candq, centers, excl, ncells3,
    cutoff, alpha, coulomb)``; the backward takes the main path's cotangent
    (ones: the energy is the sum of the rows)."""
    planes = [t.detach().contiguous() for t in args[:5]]
    excl = args[5].contiguous()
    ncells3, cutoff, alpha, coulomb = args[6:10]
    spec = cuda_pme._PmeSpec(ncells3, planes[4].shape[1], excl.shape[2],
                             cutoff, alpha, coulomb)
    out_k = cuda_pme.pme_window_fwd_cuda(*planes, excl, spec)
    ins = [t.clone().requires_grad_(True) for t in planes]
    out_p = cuda_pme.pme_window_plain(*ins, excl, *args[6:10])
    check_close(f'{label} pme window fwd energy', out_k.sum(),
                out_p.detach().sum(),
                rtol=1e-5, atol=0.0)
    g = torch.ones_like(out_k)
    grads_k = cuda_pme.pme_window_bwd_cuda(*planes, excl, g, spec)
    grads_p = torch.autograd.grad(out_p, ins, g, retain_graph=True)
    for name, a, b in zip(('dcandx', 'dcandy', 'dcandz', 'dcandq',
                           'dcenters'), grads_k, grads_p):
        check_normwise(f'{label} pme window bwd {name}', a, b, rtol=1e-4)
    # Work: every real center against its cell's window lanes, and the
    # pairs inside the cutoff that are neither self nor excluded.
    cx, cy, cz, _, ctr = planes
    real = ctr[:, :, 0] < cuda_pme.EMPTY_ROW
    d2 = sum((c[:, None, :] - ctr[:, :, i:i + 1]).square()
             for i, c in enumerate((cx, cy, cz)))
    slot = cuda_pme._lane_slots(ncells3, spec.c, DEV)
    self_slot = (torch.arange(spec.ncells, device=DEV)[:, None] * spec.c
                 + torch.arange(spec.c, device=DEV)[None, :])
    pairs = ((d2 < float(cutoff) ** 2) & real[:, :, None]
             & (slot[:, None, :] != self_slot[:, :, None]))
    for e in range(excl.shape[2]):
        pairs &= excl[:, :, e:e + 1] != slot[:, None, :]
    inside = int(pairs.sum())
    tested = int(real.sum()) * spec.kk
    io = 4 * (4 * cx.numel() + ctr.numel() + excl.numel())
    fwd = entry('pme_window_fwd', 'pme_window', max_abs(out_k, out_p),
                lambda: cuda_pme.pme_window_fwd_cuda(*planes, excl, spec),
                lambda: cuda_pme.pme_window_plain(*planes, excl, *args[6:10]),
                io + 4 * out_k.numel(),
                tested * PME_TEST_OPS + inside * PME_FWD_OPS, F32_OPS_PER_S)
    bwd = entry('pme_window_bwd', 'pme_window',
                max(max_abs(a, b) for a, b in zip(grads_k, grads_p)),
                lambda: cuda_pme.pme_window_bwd_cuda(*planes, excl, g, spec),
                lambda: torch.autograd.grad(out_p, ins, g, retain_graph=True),
                # Every input read once; the four planes' and the centers'
                # cotangents written once.
                io + 4 * (4 * cx.numel() + ctr.numel() + g.numel()),
                tested * PME_TEST_OPS + inside * PME_BWD_OPS, F32_OPS_PER_S)
    print(f'{label} pme window cells {spec.ncells} capacity {spec.c} lanes '
          f'{spec.kk} exclusions {excl.shape[2]} (pairs tested {tested}, '
          f'inside {inside}): fwd {fwd["ms"]:.4f} ms (eager '
          f'{fwd["event_ms"]:.4f}, plain {fwd["plain_ms"]:.4f}), bwd '
          f'{bwd["ms"]:.4f} ms (eager {bwd["event_ms"]:.4f}, plain '
          f'{bwd["plain_ms"]:.4f}), energy {float(out_k.sum()):.4f} vs '
          f'{float(out_p.detach().sum()):.4f}')
    return fwd, bwd


class Config5:
    """BASELINE config 5 on ``make_water_box(molecules)``: the combined
    model, its cell list, tensors on the card and the MD functions."""

    def __init__(self, molecules, basis, params):
        water = make_water_box(molecules, seed=SEED)
        self.water, self.params = water, params
        (self.ff, self.cells, self.pos, self.box, self.charges,
         self.masses) = combined_mod.config5(water, basis, device=DEV)
        self.ani = self.ff.ani
        layout = self.ani.blocked_layout
        print(f'config 5 at {len(water.positions)} atoms: PME grid '
              f'{self.ff.pme.config.grid_shape}, window plan '
              f'{self.ff.pme_window_plan}; ANI grid {layout.cell_grid} '
              f'cell_caps {layout.cell_caps}, bucketing {layout.small_caps} '
              f'/ {layout.num_big_cells}, tiers {layout.ang_tier_caps}')

    def select(self, p):
        return self.ff.select(p, self.box, self.cells)

    def forces(self, sel, p):
        return self.ff.energy_and_forces_from_selection(
            self.params, p, self.charges, self.box, self.cells, sel)

    def counts(self, sel, p):
        return self.ff.overflow_counts(p, self.charges, self.box, self.cells,
                                       sel)

    def initial_state(self):
        return initialize(lambda p: self.forces(self.select(p), p), self.pos,
                          self.masses, C5_KT,
                          torch.Generator(device=DEV).manual_seed(SEED + 1))

    def run(self, state, blocks):
        return run_md_sticky_counts(
            self.select, self.forces,
            lambda f: langevin_baoab(f, self.masses, C5_DT,
                                     C5_FRICTION, C5_KT),
            state, blocks * C5_REFRESH, C5_REFRESH, self.counts)

    def timed_run(self, label, blocks):
        """One warm-up block, then ``blocks`` blocks between CUDA events,
        the launch counts set to 0 just before; checks and prints."""
        state, _, _ = self.run(self.initial_state(), 1)
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        final, energies, stats = self.run(state, blocks)
        end.record()
        torch.cuda.synchronize()
        launches = dict(_kernels.LAUNCHES)
        steps = blocks * C5_REFRESH
        self.ff.check_counts(stats, self.cells)
        self.ff.check_overflow(final.positions, self.charges, self.box,
                               self.cells)
        if not (torch.isfinite(energies).all()
                and torch.isfinite(final.positions).all()
                and torch.isfinite(final.velocities).all()):
            raise AssertionError(f'{label}: non-finite MD state')
        host = {k: v.cpu().tolist() for k, v in stats.items()}
        print(f'{label}: {steps} Langevin steps, '
              f'{start.elapsed_time(end) / steps:.3f} ms/step (CUDA events, '
              f'selection every {C5_REFRESH} steps and PME included), energy '
              f'{float(energies[0]):.4f} -> {float(energies[-1]):.4f}, count '
              f'maxima {host} within {self.ff.capacities(self.cells)}, '
              f'launches {launches}')
        return final, launches


def config5_phase(basis):
    """Phase 7: BASELINE config 5 at 2,601 and 26,010 atoms. Returns the
    PME window kernel's entries with their launches from (b)."""
    params = init_ani_params(torch.Generator(device=DEV).manual_seed(SEED),
                             basis, num_models=8,
                             self_energies=C5_SELF_ENERGIES,
                             device=DEV)
    c5 = Config5(MOLECULES, basis, params)
    ff = c5.ff

    # (a) The PME window kernel on the inputs of one force step.
    calls = []
    sel = c5.select(c5.pos)
    with recording(cuda_pme, 'pme_window', calls):
        c5.forces(sel, c5.pos)
    if len(calls) != 1:
        raise AssertionError(f'pme_window called {len(calls)} times a step')
    fwd, bwd = pme_entries(calls[0][0], 'config 5')
    water = c5.water
    n = len(water.positions)
    excl = np.full((n, 2), -1, np.int32)
    for m in range(n // 3):
        o, h1, h2 = 3 * m, 3 * m + 1, 3 * m + 2
        excl[o], excl[h1], excl[h2] = [h1, h2], [o, h2], [o, h1]
    cfg = ff.pme.config
    pme_x = PME(*cfg.grid_shape, cfg.order, cfg.alpha, cfg.coulomb, excl,
                device=DEV)
    grid3, cap = ff.pme_window_plan[:2]
    bplan = (grid3, cap, max(8, cap - 8), int(np.prod(grid3)) // 2)
    if int(pme_x.direct_window_overflow(c5.pos, c5.box, bplan)) > cap:
        raise AssertionError('forced bucketed PME plan overflows')
    calls = []
    with recording(cuda_pme, 'pme_window', calls):
        pme_x.compute_direct_window(c5.pos, c5.charges, ff.pme_cutoff,
                                    c5.box, bplan)
    print(f'bucketed PME plan {bplan}, 2 exclusions per atom:')
    b_fwd, b_bwd = pme_entries(calls[0][0], 'bucketed')
    fwd['max_abs_err'] = max(fwd['max_abs_err'], b_fwd['max_abs_err'])
    bwd['max_abs_err'] = max(bwd['max_abs_err'], b_bwd['max_abs_err'])

    # (b) The config-5 MD at 2,601 atoms.
    final, launches = c5.timed_run('config 5 at 2,601 atoms', C5_BLOCKS)
    steps = C5_BLOCKS * C5_REFRESH
    ntiers = 1 + len(c5.ani.blocked_layout.ang_tier_caps or ())
    require_launches('config 5', launches, {
        'pme_window_fwd': steps, 'pme_window_bwd': steps,
        'left_pack': C5_BLOCKS, 'window_radial_fwd': steps,
        'window_radial_bwd': steps, 'angular_aev_fwd': ntiers * steps,
        'angular_aev_bwd': ntiers * steps, 'fused_nn_fwdgrad': 2 * steps})
    p = final.positions
    sel = c5.select(p)
    e_k, f_k = c5.forces(sel, p)
    e_p, f_p = combined_mod.plain_energy_and_forces(
        ff, params, p, c5.charges, c5.box, c5.cells, sel)
    check_close('config 5 step energy', e_k, e_p, rtol=1e-3, atol=0.0)
    check_normwise('config 5 step forces', f_k, f_p, rtol=5e-3)
    print(f'config 5 step vs plain: E {float(e_k):.6f} vs {float(e_p):.6f}, '
          f'max|dF| {max_abs(f_k, f_p):.3g} (max|F| '
          f'{float(f_p.abs().max()):.3g})')
    fwd['launches'] = launches['pme_window_fwd']
    bwd['launches'] = launches['pme_window_bwd']

    # (c) Config 5 at 26,010 atoms.
    big = Config5(LARGE_MOLECULES, basis, params)
    plan = big.ff.pme_window_plan
    if (plan is None or plan[2] is None
            or len(big.ani.blocked_layout.ang_tier_caps or ()) != 3):
        raise AssertionError('config 5 at 26k: expected a bucketed PME plan '
                             'and four angular tiers')
    big.timed_run('config 5 at 26,010 atoms', C5_LARGE_BLOCKS)
    return fwd, bwd


# ---------------------------------------------------------------------------
# SchNet / CFConv: the periodic 6-layer stack and the pair path.
# ---------------------------------------------------------------------------

def cfconv_pair_ops(width, gaussians):
    """Operations per valid pair of the CFConv backward kernel, counted from
    ``csrc/cfconv_bwd.cu`` (an FMA counts two): the four filter products
    and the two weight-gradient outer products, 3 W^2 + 3 G W FMAs, plus
    the Gaussians (11 G), the activation, its derivative and the d_y1 /
    d_x / d_fc terms (18 W) and the cutoff (6)."""
    return 2 * (3 * width * width + 3 * gaussians * width) \
        + 11 * gaussians + 18 * width + 6


def cfconv_bwd_check(label, args, cfg, chunk):
    """The kernel against its plain version on one recorded call of
    ``cfconv_bwd(params, dist, mask, idx, x, g, config, ...)``; normwise
    gates: 1e-4 of the reference's scale on d_dist and d_x, 1e-3 on the
    weight gradients (sums over every pair)."""
    params, dist, mask, idx, x, g = args[:6]
    got = cuda_cfconv.cfconv_bwd_cuda(params, dist, mask, idx, x, g, cfg)
    want = cuda_cfconv.cfconv_bwd_plain(params, dist, mask, idx, x, g, cfg,
                                        chunk)
    (gw, gd, gx), (ww, wd, wx) = got, want
    for name, a, b, tol in ([('d_dist', gd, wd, 1e-4), ('d_x', gx, wx, 1e-4)]
                            + [(f'd_{n}', a, b, 1e-3) for n, a, b in
                               zip(('w1', 'b1', 'w2', 'b2'), gw, ww)]):
        check_normwise(f'{label} cfconv bwd {name}', a, b, tol)
    if bool(gd[~mask].any()):
        raise AssertionError(f'{label}: nonzero d_dist on a masked lane')
    err = max(max_abs(a, b) for a, b in zip((*gw, gd, gx), (*ww, wd, wx)))
    print(f'{label} cfconv bwd rows {dist.shape[0]} lanes {dist.shape[1]} '
          f'({cfg.activation}): max|d d_dist| {max_abs(gd, wd):.3g} (max '
          f'{float(wd.abs().max()):.3g}), max|d d_x| {max_abs(gx, wx):.3g} '
          f'(max {float(wx.abs().max()):.3g}), max|d dW| '
          f'{max(max_abs(a, b) for a, b in zip(gw, ww)):.3g} (max '
          f'{max(float(b.abs().max()) for b in ww):.3g})')
    return err


def cfconv_phase():
    """Phase 8: the SchNet/CFConv path. (a) the CFConv backward kernel (B.6)
    against its plain version on one layer's inputs of the 26,010-atom
    stack, timed, plus one small call with the tanh activation; (b) the
    stack (``models.schnet.periodic_stack``: select with mirror, distance
    payload, 6 layers, gradients of the sum with respect to positions,
    inputs and weights), 1 warm-up and 2 timed iterations, then one
    iteration against the same iteration through the plain backward; (c)
    the pair path, which has no kernel: config 2 and the O(N^2) harness.
    Returns the kernel's entry with its launches from (b)."""
    w = schnet_mod.periodic_stack(LARGE_MOLECULES * 3, device=DEV)
    cfg = w.stack.config
    cl = w.cell_list
    print(f'cfconv stack: atoms {w.positions.shape[0]}, box '
          f'{float(w.box[0, 0]):.2f} A, width {cfg.width}, {cfg.num_gaussians}'
          f' Gaussians, cutoff {cfg.cutoff}, {w.stack.num_layers} layers, '
          f'cells {cl.ncells} x {cl.cell_capacity}, capacity {cl.capacity}, '
          f'chunk {w.chunk_size}')
    if cl.ncells != (6, 6, 6) or cl.capacity != 640:
        raise AssertionError('cfconv 26k: expected a 6x6x6 grid, K = 640')

    # (b, warm-up) One iteration, recording the kernel's calls.
    calls = []
    with recording(cuda_cfconv, 'cfconv_bwd', calls):
        schnet_mod.periodic_stack_grads(w)
    if len(calls) != w.stack.num_layers:
        raise AssertionError(f'cfconv_bwd called {len(calls)} times')

    # (a) B.6 on the last layer's backward inputs (the first call).
    # Detached: the saved inputs require grad, and the plain version would
    # otherwise keep every chunk's intermediates for autograd.
    params = tuple(a.detach() for a in calls[0][0][0])
    args = (params,) + tuple(a.detach() for a in calls[0][0][1:6])
    del calls
    params, dist, mask, idx, x, g = args
    err = cfconv_bwd_check('26k', args, cfg, w.chunk_size)
    # A small call with the tanh activation: the first 37 rows, their
    # lanes to other atoms masked out.
    m37 = mask[:37] & (idx[:37] < 37)
    err = max(err, cfconv_bwd_check(
        'tanh', (params, torch.where(m37, dist[:37], 0.0), m37,
                 torch.where(m37, idx[:37], 37), x[:37].contiguous(),
                 g[:37].contiguous()),
        dataclasses.replace(cfg, activation='tanh'), w.chunk_size))
    pairs = int(mask.sum())
    n, k = dist.shape
    wd, ng = cfg.width, cfg.num_gaussians
    size = ng * wd + wd + wd * wd + wd
    # Every input read once (dist, mask, idx, x, g, weights, centers), every
    # output written once (d_dist, d_x, the four weight gradients).
    nbytes = n * k * (4 + 1 + 4) + 2 * 4 * n * wd + 4 * (size + ng) \
        + 4 * n * k + 4 * n * wd + 4 * size
    ops = pairs * cfconv_pair_ops(wd, ng)
    # Two calls a measurement: one takes tens of milliseconds.
    e = entry('cfconv_bwd', 'cfconv_bwd', err,
              lambda: cuda_cfconv.cfconv_bwd_cuda(params, dist, mask, idx, x,
                                                  g, cfg),
              lambda: cuda_cfconv.cfconv_bwd_plain(params, dist, mask, idx, x,
                                                   g, cfg, w.chunk_size),
              nbytes, ops, F32_OPS_PER_S, calls=2)
    del args, params, dist, mask, idx, x, g
    print(f"cfconv_bwd: rows {n} lanes {k}, valid pairs {pairs}: kernel "
          f"{e['ms']:.4f} ms (CUDA graph; eager {e['event_ms']:.4f} ms), "
          f"plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
          f"({e['bound_by']}: {nbytes} bytes, {ops} operations), max|err| "
          f"{err:.3g}")

    # (b) The stack: 2 timed iterations, selection included.
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CFCONV_ITERS):
        value, d_pos, d_x, dw, sel = schnet_mod.periodic_stack_grads(w)
    end.record()
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    ms = start.elapsed_time(end) / CFCONV_ITERS
    max_nbr, max_occ = int(sel.max_neighbors), int(sel.max_cell_occupancy)
    print(f'cfconv stack 26k: {CFCONV_ITERS} iterations, {ms:.3f} '
          f'ms/iteration (CUDA events, selection included), max_neighbors '
          f'{max_nbr} <= {cl.capacity}, max_cell_occupancy {max_occ} <= '
          f'{cl.cell_capacity}, value {float(value):.6f}, launches {launches}')
    if max_nbr > cl.capacity or max_occ > cl.cell_capacity:
        raise AssertionError('cfconv 26k: selection overflow')
    if not all(bool(torch.isfinite(t).all())
               for t in (value, d_pos, d_x, *[a for p in dw for a in p])):
        raise AssertionError('cfconv 26k: non-finite value or gradients')
    if tuple(d_pos.shape) != tuple(w.positions.shape) or \
            tuple(d_x.shape) != tuple(w.inputs.shape):
        raise AssertionError('cfconv 26k: gradient shapes')
    require_launches('cfconv', launches,
                     {'cfconv_bwd': CFCONV_ITERS * w.stack.num_layers})
    e['launches'] = launches['cfconv_bwd']
    before = launches['cfconv_bwd']
    p_value, p_pos, p_x, p_dw, _ = schnet_mod.periodic_stack_grads(w, True)
    if _kernels.LAUNCHES['cfconv_bwd'] != before:
        raise AssertionError('the plain iteration launched the kernel')
    check_close('cfconv stack value', value, p_value, rtol=1e-5, atol=0.0)
    check_normwise('cfconv stack d_positions', d_pos, p_pos, 1e-3)
    check_normwise('cfconv stack d_inputs', d_x, p_x, 1e-3)
    for i, (a, b) in enumerate(zip(dw, p_dw)):
        for name, ga, gb in zip(('w1', 'b1', 'w2', 'b2'), a, b):
            check_normwise(f'cfconv stack layer {i} d_{name}', ga, gb, 1e-3)
    print(f'cfconv stack vs plain: value {float(value):.6f} vs '
          f'{float(p_value):.6f}, max|d d_pos| {max_abs(d_pos, p_pos):.3g} '
          f'(max {float(p_pos.abs().max()):.3g}), max|d d_x| '
          f'{max_abs(d_x, p_x):.3g} (max {float(p_x.abs().max()):.3g})')
    del w, d_pos, d_x, dw, p_pos, p_x, p_dw, sel

    # (c) The pair path: config 2 and the O(N^2) harness.
    rng = np.random.RandomState(0)
    pos = torch.tensor(rng.rand(21, 3).astype(np.float32) * 6, device=DEV)
    species = torch.tensor(rng.randint(0, 3, 21), dtype=torch.int32,
                           device=DEV)
    model = schnet_mod.SchNetModel(cfg, num_species=3, num_interactions=3)
    sparams = model.init(torch.Generator(device=DEV).manual_seed(SEED + 1),
                         device=DEV)
    energy, forces = model.energy_and_forces(sparams, pos, species)
    if not (torch.isfinite(energy) and bool(torch.isfinite(forces).all())
            and tuple(forces.shape) == (21, 3)):
        raise AssertionError('config 2: non-finite energy or forces')
    print(f'config 2 (SchNet, 21 atoms, 3 interactions): E '
          f'{float(energy):.4f}, max|F| {float(forces.abs().max()):.4f}')
    n_pair = CFCONV_PAIR_ATOMS
    side = (n_pair / 0.1) ** (1 / 3)
    rng = np.random.RandomState(0)
    pos = torch.tensor(rng.rand(n_pair, 3).astype(np.float32) * side,
                       device=DEV)
    x = torch.tensor(rng.randn(n_pair, cfg.width).astype(np.float32),
                     device=DEV)
    stack = schnet_mod.CFConvStack(cfg, num_layers=6)
    sparams = stack.init(torch.Generator(device=DEV).manual_seed(SEED),
                         device=DEV)

    def harness():
        p = pos.detach().requires_grad_(True)
        xx = x.detach().requires_grad_(True)
        out = stack(sparams, build_cfconv_neighbors(p, cfg.cutoff), xx).sum()
        return (out.detach(), *torch.autograd.grad(out, (p, xx)))

    value, d_pos, d_x = harness()
    if not all(bool(torch.isfinite(t).all()) for t in (value, d_pos, d_x)):
        raise AssertionError('O(N^2) harness: non-finite value or gradients')
    print(f'cfconv O(N^2) harness ({n_pair} atoms, 6 layers, build + '
          f'backprop): {cuda_ms(harness, iters=3, warmup=1):.3f} ms/iteration'
          f' (CUDA events), value {float(value):.4f}')
    return e


# ---------------------------------------------------------------------------
# Phase 9: the window path's opt-in switches (z-pair and cluster-pair
# radial kernels, the 'mask' compaction).
# ---------------------------------------------------------------------------

def deterministic(label, first, again):
    """Two launches on the same inputs give bitwise equal outputs."""
    for a, b in zip(first, again):
        if not torch.equal(a, b):
            raise AssertionError(f'{label}: two launches differ')


def pair_entries(args, label):
    """(fwd, bwd) entries of the z-pair kernel on one recorded call of
    ``pair_radial(ctr, z3, shift, rc, eta, rs, ncells3, cell_caps,
    torchani)``; the backward takes the cotangents of sum(out_a^2) +
    sum(out_b^2)."""
    ctr, z3, shift = (t.detach().contiguous() for t in args[:3])
    rest = args[3:9]
    rc, eta, rs, ncells3, caps, torchani = rest
    spec = cuda_zpair._spec(
        tuple(int(x) for x in ncells3), tuple(int(x) for x in caps),
        float(rc), tuple(float(x) for x in eta), tuple(float(x) for x in rs),
        bool(torchani))
    out_k = cuda_zpair.pair_radial_fwd_cuda(ctr, z3, shift, spec)
    ins = [t.clone().requires_grad_(True) for t in (ctr, z3, shift)]
    out_p = cuda_zpair.pair_radial_plain(*ins, *rest)
    for name, a, b in zip(('out_a', 'out_b'), out_k, out_p):
        check_normwise(f'{label} pair fwd {name}', a, b, rtol=1e-5)
    g = tuple((2.0 * o).detach().contiguous() for o in out_p)
    grads_k = cuda_zpair.pair_radial_bwd_cuda(ctr, z3, shift, *g, spec)
    grads_p = torch.autograd.grad(out_p, ins, g, retain_graph=True)
    for name, a, b in zip(('dctr', 'dz3', 'dshift'), grads_k, grads_p):
        check_normwise(f'{label} pair bwd {name}', a, b, rtol=1e-4)
    deterministic(f'{label} pair fwd', out_k,
                  cuda_zpair.pair_radial_fwd_cuda(ctr, z3, shift, spec))
    deterministic(f'{label} pair bwd', grads_k,
                  cuda_zpair.pair_radial_bwd_cuda(ctr, z3, shift, *g, spec))
    # Work: real center rows against the 5 z-triples, and the pairs inside
    # the cutoff (the self lanes of the own column excluded).
    geo = spec.geo
    cols = torch.as_tensor(cuda_zpair._column_cells(geo.ncells3), device=DEV)
    lanes = z3.index_select(0, cols.reshape(-1)).reshape(
        5, geo.ncells, 3, geo.ll).permute(1, 0, 2, 3)
    lanes = lanes + torch.cat([shift.new_zeros(geo.ncells, 1, 3), shift],
                              1)[..., None]
    d2 = sum((lanes[:, None, :, k, :] - ctr[:, :, None, k:k + 1]).square()
             for k in range(3))                        # [ncells, c, 5, L]
    real = ctr[:, :, 0] < cuda_window.EMPTY_ROW
    own = torch.arange(geo.ll, device=DEV)[None, :] == torch.as_tensor(
        geo.self_lane, device=DEV)[:, None]            # [c, L]
    self_pair = torch.zeros_like(d2, dtype=torch.bool)
    self_pair[:, :, 0] = own[None]
    inside = int(((d2 < float(rc) ** 2) & real[:, :, None, None]
                  & ~self_pair).sum())
    tested = int(real.sum()) * 5 * geo.ll
    io = 4 * (ctr.numel() + z3.numel() + shift.numel())
    fwd = entry('pair_radial_fwd', 'pair_radial',
                max(max_abs(a, b) for a, b in zip(out_k, out_p)),
                lambda: cuda_zpair.pair_radial_fwd_cuda(ctr, z3, shift, spec),
                lambda: cuda_zpair.pair_radial_plain(ctr, z3, shift, *rest),
                io + 4 * sum(o.numel() for o in out_k),
                tested * PAIR_TEST_OPS + inside * PAIR_FWD_OPS, F32_OPS_PER_S)
    bwd = entry('pair_radial_bwd', 'pair_radial',
                max(max_abs(a, b) for a, b in zip(grads_k, grads_p)),
                lambda: cuda_zpair.pair_radial_bwd_cuda(ctr, z3, shift, *g,
                                                        spec),
                lambda: torch.autograd.grad(out_p, ins, g, retain_graph=True),
                2 * io + 4 * sum(t.numel() for t in g),
                tested * PAIR_TEST_OPS + inside * PAIR_BWD_OPS, F32_OPS_PER_S)
    print(f'{label} pair radial cells {geo.ncells} center rows {geo.c} lanes '
          f'5 x {geo.ll} (pairs tested {tested}, inside {inside}): fwd '
          f'{fwd["ms"]:.4f} ms (eager {fwd["event_ms"]:.4f}, plain '
          f'{fwd["plain_ms"]:.4f}, bound {fwd["bound_ms"]:.5f} '
          f'{fwd["bound_by"]}), bwd {bwd["ms"]:.4f} ms (eager '
          f'{bwd["event_ms"]:.4f}, plain {bwd["plain_ms"]:.4f}, bound '
          f'{bwd["bound_ms"]:.5f} {bwd["bound_by"]}), max|err| '
          f'{fwd["max_abs_err"]:.3g} / {bwd["max_abs_err"]:.3g}')
    return fwd, bwd


def cluster_entries(args, label):
    """(fwd, bwd) entries of the cluster-pair kernel on one recorded call of
    ``cluster_radial(jx, jy, jz, centers, rc, eta, rs, cl, lane_caps,
    self_block, torchani)`` (one i-species); the backward takes the
    cotangent of sum(out^2)."""
    planes = [t.detach().contiguous() for t in args[:4]]
    rest = args[4:11]
    rc, eta, rs, cl, lane_caps, self_block, torchani = rest
    spec = cuda_cluster._spec(
        int(cl), tuple(int(x) for x in lane_caps), int(self_block),
        float(rc), tuple(float(x) for x in eta), tuple(float(x) for x in rs),
        bool(torchani))
    out_k = cuda_cluster.cluster_radial_fwd_cuda(*planes, spec)
    ins = [t.clone().requires_grad_(True) for t in planes]
    out_p = cuda_cluster.cluster_radial_plain(*ins, *rest)
    check_normwise(f'{label} cluster fwd', out_k, out_p, rtol=1e-5)
    g = (2.0 * out_p).detach().contiguous()
    grads_k = cuda_cluster.cluster_radial_bwd_cuda(*planes, g, spec)
    grads_p = torch.autograd.grad(out_p, ins, g, retain_graph=True)
    for name, a, b in zip(('djx', 'djy', 'djz', 'dcenters'), grads_k,
                          grads_p):
        check_normwise(f'{label} cluster bwd {name}', a, b, rtol=1e-4)
    deterministic(f'{label} cluster fwd', (out_k,),
                  (cuda_cluster.cluster_radial_fwd_cuda(*planes, spec),))
    deterministic(f'{label} cluster bwd', grads_k,
                  cuda_cluster.cluster_radial_bwd_cuda(*planes, g, spec))
    geo = spec.geo
    jx, jy, jz, ctr = planes
    d2 = sum((c[:, None, :] - ctr[:, :, i:i + 1]).square()
             for i, c in enumerate((jx, jy, jz)))      # [ncl, cl, lanes]
    real = ctr[:, :, 0] < cuda_window.EMPTY_ROW
    lane = torch.arange(geo.lanes, device=DEV)
    row = torch.arange(geo.cl, device=DEV)
    inside = int(((d2 < float(rc) ** 2) & real[:, :, None]
                  & (lane[None, :] != row[:, None] + geo.self_off)).sum())
    tested = int(real.sum()) * geo.lanes
    io = 4 * (3 * jx.numel() + ctr.numel())
    fwd = entry('cluster_radial_fwd', 'cluster_radial', max_abs(out_k, out_p),
                lambda: cuda_cluster.cluster_radial_fwd_cuda(*planes, spec),
                lambda: cuda_cluster.cluster_radial_plain(*planes, *rest),
                io + 4 * out_k.numel(),
                tested * CLUSTER_TEST_OPS + inside * CLUSTER_FWD_OPS,
                F32_OPS_PER_S)
    bwd = entry('cluster_radial_bwd', 'cluster_radial',
                max(max_abs(a, b) for a, b in zip(grads_k, grads_p)),
                lambda: cuda_cluster.cluster_radial_bwd_cuda(*planes, g,
                                                             spec),
                lambda: torch.autograd.grad(out_p, ins, g, retain_graph=True),
                2 * io + 4 * g.numel(),
                tested * CLUSTER_TEST_OPS + inside * CLUSTER_BWD_OPS,
                F32_OPS_PER_S)
    print(f'{label} cluster radial i-species block {int(self_block)}: '
          f'{jx.shape[0]} clusters x {geo.lanes} lanes (pairs tested '
          f'{tested}, inside {inside}): fwd {fwd["ms"]:.4f} ms (eager '
          f'{fwd["event_ms"]:.4f}, plain {fwd["plain_ms"]:.4f}, bound '
          f'{fwd["bound_ms"]:.5f} {fwd["bound_by"]}), bwd {bwd["ms"]:.4f} '
          f'ms (eager {bwd["event_ms"]:.4f}, plain {bwd["plain_ms"]:.4f}, '
          f'bound {bwd["bound_ms"]:.5f} {bwd["bound_by"]})')
    return fwd, bwd


def mask_entries(mask_args, pack_args):
    """Entries of the mask kernel and the lane left-pack on one recorded
    'mask' selection; both must equal their plain versions exactly."""
    cx, cy, cz, centers = (t.contiguous() for t in mask_args[:4])
    w2, caps = mask_args[4:6]
    m_k = cuda_select.window_mask_cuda(cx, cy, cz, centers, w2, caps)
    m_p = cuda_select.window_mask_plain(cx, cy, cz, centers, w2, caps)
    if not torch.equal(m_k, m_p):
        raise AssertionError(f'window_mask: kernel and plain differ in '
                             f'{int((m_k != m_p).sum())} of {m_k.numel()}')
    m_atom, widths, a_caps = pack_args
    m_atom = m_atom.contiguous()
    lanes, counts = cuda_select.left_pack_lanes_cuda(m_atom, widths, a_caps)
    p_lanes, p_counts = cuda_select.left_pack_lanes_plain(m_atom, widths,
                                                          a_caps)
    if not (torch.equal(lanes, p_lanes) and torch.equal(counts, p_counts)):
        raise AssertionError('left_pack_lanes: kernel and plain differ')
    ncells, c, kk = m_k.shape
    mask = entry('window_mask', 'window_mask', 0.0,
                 lambda: cuda_select.window_mask_cuda(cx, cy, cz, centers,
                                                      w2, caps),
                 lambda: cuda_select.window_mask_plain(cx, cy, cz, centers,
                                                       w2, caps),
                 4 * (3 * cx.numel() + centers.numel()) + m_k.numel(),
                 MASK_OPS * m_k.numel(), F32_OPS_PER_S)
    pack = entry('left_pack_lanes', 'window_mask', 0.0,
                 lambda: cuda_select.left_pack_lanes_cuda(m_atom, widths,
                                                          a_caps),
                 lambda: cuda_select.left_pack_lanes_plain(m_atom, widths,
                                                           a_caps),
                 m_atom.numel() + 4 * (lanes.numel() + counts.numel()),
                 LANE_PACK_OPS * m_atom.numel(), F32_OPS_PER_S)
    print(f'window_mask cells {ncells} rows {c} lanes {kk} (valid '
          f'{int(m_k.sum())}): {mask["ms"]:.4f} ms (eager '
          f'{mask["event_ms"]:.4f}, plain {mask["plain_ms"]:.4f}, bound '
          f'{mask["bound_ms"]:.5f} {mask["bound_by"]}); left_pack_lanes '
          f'rows {m_atom.shape[0]} widths {tuple(widths)} caps '
          f'{tuple(a_caps)}: {pack["ms"]:.4f} ms (eager '
          f'{pack["event_ms"]:.4f}, plain {pack["plain_ms"]:.4f}, bound '
          f'{pack["bound_ms"]:.5f} {pack["bound_by"]})')
    return mask, pack


def step_vs_window(label, model, window, params, p, box, cell_list, sel):
    """One step of an opt-in radial path against the default 'window' step
    at the same positions, at the force gate."""
    e_k, f_k = model.energy_and_forces_from_selection(params, p, box,
                                                      cell_list, sel)
    e_w, f_w = window.energy_and_forces_from_selection(
        params, p, box, cell_list, window.select(p, box, cell_list))
    check_close(f'{label} vs window energy', e_k, e_w, rtol=1e-3, atol=0.0)
    check_normwise(f'{label} vs window forces', f_k, f_w, rtol=5e-3)
    print(f'{label} step vs window step: E {float(e_k):.6f} vs '
          f'{float(e_w):.6f}, max|dF| {max_abs(f_k, f_w):.3g} (max|F| '
          f'{float(f_w.abs().max()):.3g})')


def frozen_steps(label, model, params, pos, box, cell_list, sel):
    """LARGE_STEPS nudged steps on a frozen selection between CUDA events;
    returns (positions, ms/step)."""
    model.energy_and_forces_from_selection(params, pos, box, cell_list, sel)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    p = pos
    start.record()
    for _ in range(LARGE_STEPS):
        e, f = model.energy_and_forces_from_selection(params, p, box,
                                                      cell_list, sel)
        p = p + 1e-6 * f
    end.record()
    torch.cuda.synchronize()
    model.check_overflow(p, box, cell_list, sel)
    if not (torch.isfinite(e) and torch.isfinite(f).all()):
        raise AssertionError(f'{label}: non-finite energy or forces')
    ms = start.elapsed_time(end) / LARGE_STEPS
    print(f'{label}: {ms:.3f} ms/step over {LARGE_STEPS} steps (CUDA events, '
          f'frozen selection), E {float(e):.4f}')
    return p, ms


def opt_in_phase(basis, params):
    """Phase 9: the z-pair radial at 2,601 and 26,010 atoms, the
    cluster-pair radial and the 'mask' compaction at 26,010. Returns the
    six kernels' entries with their launches."""
    kernels = {}
    steps = BLOCKS * REFRESH

    # (a, b) window_radial='pair' at 2,601 atoms.
    _, window, cell_list, pos, box = build(MOLECULES, 'window', basis)
    pair = dataclasses.replace(window, window_radial='pair')
    calls = []
    with recording(cuda_zpair, 'pair_radial', calls):
        sel = pair.select(pos, box, cell_list)
        pair.energy_and_forces_from_selection(params, pos, box, cell_list,
                                              sel)
    if len(calls) != 1 or tuple(sel.shift_planes.shape) != (1, 1, 1):
        raise AssertionError(f'pair step: {len(calls)} kernel calls, shift '
                             f'planes {tuple(sel.shift_planes.shape)}')
    fwd, bwd = pair_entries(calls[0][0], 'pair 2.6k')
    launches, p, sel = drive('pair', pair, params, pos, box, cell_list)
    require_launches('pair', launches, {
        'pair_radial_fwd': steps, 'pair_radial_bwd': steps,
        'left_pack': BLOCKS, 'angular_aev_fwd': steps,
        'angular_aev_bwd': steps, 'fused_nn_fwdgrad': 2 * steps})
    if launches['window_radial_fwd'] or launches['window_radial_bwd']:
        raise AssertionError('the pair path launched the window radial kernel')
    step_vs_plain('pair 2.6k', pair, params, p, box, cell_list, sel)
    step_vs_window('pair 2.6k', pair, window, params, p, box,
                   cell_list, sel)
    fwd['launches'] = launches['pair_radial_fwd']
    bwd['launches'] = launches['pair_radial_bwd']
    kernels['pair_radial_fwd'], kernels['pair_radial_bwd'] = fwd, bwd
    del window, pair, sel, p, calls

    # The 26,010-atom models: window, pair and cluster.
    water, window, cell_list, pos, box = build(LARGE_MOLECULES, 'window',
                                               basis)
    base = ANIModel.from_atomic_numbers(water.atomic_numbers, basis,
                                        nn_dtype='bfloat16', nn_impl='fused')
    t0 = time.perf_counter()
    cluster = base.with_blocked_layout(water.positions, water.box,
                                       margin=MARGIN, impl='window',
                                       skin=SKIN, radial_impl='cluster')
    plan_s = time.perf_counter() - t0
    plan = cluster.blocked_layout.cluster_plan
    if cluster.window_radial != 'cluster' or plan is None:
        raise AssertionError('26k: the cluster planner refused the box')
    if dataclasses.replace(cluster.blocked_layout,
                           cluster_plan=None) != window.blocked_layout:
        raise AssertionError('26k: the cluster layout differs from window')
    print(f'cluster plan 26k ({plan_s:.1f} s host, with_blocked_layout '
          f'included): ncl {plan.ncl}, jcaps {plan.jcaps}, cand_caps '
          f'{plan.cand_caps}, kmir {plan.kmir}, col_grid {plan.col_grid}')

    # (b) The pair step on a frozen 26k selection.
    pair = dataclasses.replace(window, window_radial='pair')
    calls = []
    with recording(cuda_zpair, 'pair_radial', calls):
        sel = pair.select(pos, box, cell_list)
        pair.energy_and_forces_from_selection(params, pos, box, cell_list,
                                              sel)
    big_fwd, big_bwd = pair_entries(calls[0][0], 'pair 26k')
    fwd['max_abs_err'] = max(fwd['max_abs_err'], big_fwd['max_abs_err'])
    bwd['max_abs_err'] = max(bwd['max_abs_err'], big_bwd['max_abs_err'])
    del calls
    p, _ = frozen_steps('pair 26k', pair, params, pos, box, cell_list, sel)
    step_vs_plain('pair 26k', pair, params, p, box, cell_list, sel)
    step_vs_window('pair 26k', pair, window, params, p, box,
                   cell_list, sel)
    del pair, sel

    # (a, c) The cluster step: one selection and frozen steps, the counts
    # set to 0 just before.
    calls = []
    with recording(clusters_mod, 'cluster_radial', calls):
        sel = cluster.select(pos, box, cell_list)
        cluster.energy_and_forces_from_selection(params, pos, box, cell_list,
                                                 sel)
    if len(calls) != len(plan.present):
        raise AssertionError(f'cluster_radial called {len(calls)} times')
    ents = [cluster_entries(args, '26k') for args, _ in calls]
    del calls
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sel = cluster.select(pos, box, cell_list)
    cluster.check_overflow(pos, box, cell_list, sel)
    torch.cuda.synchronize()
    select_s = time.perf_counter() - t0
    p, _ = frozen_steps('cluster 26k', cluster, params, pos, box, cell_list,
                        sel)
    launches = dict(_kernels.LAUNCHES)
    print(f'cluster 26k: selection {1e3 * select_s:.1f} ms (host clock, with '
          f'check_overflow), launches {launches}')
    need = (LARGE_STEPS + 1) * len(plan.present)
    require_launches('cluster', launches, {
        'cluster_radial_fwd': need, 'cluster_radial_bwd': need})
    if launches['window_radial_fwd'] or launches['pair_radial_fwd']:
        raise AssertionError('the cluster path launched another radial '
                             'kernel')
    step_vs_plain('cluster 26k', cluster, params, p, box, cell_list, sel)
    step_vs_window('cluster 26k', cluster, window, params, p, box,
                   cell_list, sel)
    for i, name in enumerate(('cluster_radial_fwd', 'cluster_radial_bwd')):
        kernels[name] = merge([e[i] for e in ents])
        kernels[name]['launches'] = launches[name]
    del cluster, sel, ents

    # (a, d) select_window(compact_impl='mask') against 'kernel'.
    g = window.grouping
    layout = window.blocked_layout
    kw = dict(species=window.species_array, layout=layout,
              radial_cutoff=basis.radial_cutoff,
              angular_cutoff=basis.angular_cutoff,
              grouping_order=g.order,
              present_counts=tuple(g.counts[s] for s in layout.present),
              need_shift_planes=True)
    masks, packs = [], []
    with recording(window_mod, 'window_mask', masks), \
            recording(window_mod, 'left_pack_lanes', packs):
        window_mod.select_window(cell_list, pos, box, compact_impl='mask',
                                 **kw)
    mask, pack = mask_entries(masks[0][0], packs[0][0])
    del masks, packs
    times = {'kernel': [], 'mask': []}
    sels = {}
    for impl in ('kernel', 'mask', 'mask', 'kernel'):
        torch.cuda.synchronize()
        if impl == 'mask' and 'mask' not in sels:
            _kernels.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sels[impl] = window_mod.select_window(cell_list, pos, box,
                                              compact_impl=impl, **kw)
        end.record()
        torch.cuda.synchronize()
        times[impl].append(start.elapsed_time(end))
        if impl == 'mask' and len(times['mask']) == 2:
            launches = dict(_kernels.LAUNCHES)
    require_launches('mask', launches, {'window_mask': 2,
                                        'left_pack_lanes': 2})
    if launches['left_pack']:
        raise AssertionError("the 'mask' selection launched the left-pack")
    k_sel, m_sel = sels['kernel'], sels['mask']
    fields = [('ang.' + f, getattr(k_sel.ang, f), getattr(m_sel.ang, f))
              for f in ('order', 'slot_of_sorted', 'nbr_rad', 'rad_mask',
                        'max_rad', 'max_ang', 'ang_in_rad')]
    if k_sel.tier is not None:
        for t in range(len(k_sel.tier.idx)):
            fields += [(f'tier.{f}[{t}]', getattr(k_sel.tier, f)[t],
                        getattr(m_sel.tier, f)[t]) for f in ('idx', 'mask')]
        fields += [('tier.' + f, getattr(k_sel.tier, f),
                    getattr(m_sel.tier, f))
                   for f in ('row_atom', 'tier_counts', 'concat_pos')]
    for name, a, b in fields:
        if not torch.equal(a, b):
            raise AssertionError(f"26k 'mask' selection differs from "
                                 f"'kernel' in {name}")
    print(f"select_window 26k (CUDA events, kernel, mask, mask, kernel): "
          f"'kernel' {times['kernel']} ms, 'mask' {times['mask']} ms; "
          f'equal in {len(fields)} fields; launches {launches}')
    mask['launches'] = launches['window_mask']
    pack['launches'] = launches['left_pack_lanes']
    kernels['window_mask'], kernels['left_pack_lanes'] = mask, pack
    return kernels


def main():
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    torch.cuda.set_device(DEV)

    t_start = t0 = time.perf_counter()
    _kernels.library()
    print(f'kernel build/load: {time.perf_counter() - t0:.1f} s '
          f'({_kernels.library_path().name})')

    basis = ANIBasis.ani2x()
    params = init_ani_params(torch.Generator(device=DEV).manual_seed(SEED),
                             basis, num_models=8, device=DEV)
    pallas_phase(basis, params)
    model, cell_list, pos, box, kernels = window_kernel_phase(basis, params)

    # Phase 5: the window main path.
    launches, p, sel = drive('window', model, params, pos, box, cell_list)
    steps = BLOCKS * REFRESH
    ntiers = 1 + len(model.blocked_layout.ang_tier_caps or ())
    require_launches('window', launches, {
        'left_pack': BLOCKS, 'window_radial_fwd': steps,
        'window_radial_bwd': steps, 'angular_aev_fwd': ntiers * steps,
        'angular_aev_bwd': ntiers * steps, 'fused_nn_fwdgrad': 2 * steps,
        'fused_nn_fwd': 1})
    step_vs_plain('window', model, params, p, box, cell_list, sel)
    for k in kernels.values():
        k['launches'] = launches[k['name']]

    window_large_phase(basis, params)
    kernels['pme_window_fwd'], kernels['pme_window_bwd'] = config5_phase(basis)
    kernels['cfconv_bwd'] = cfconv_phase()
    kernels.update(opt_in_phase(basis, params))

    print(f'chip_smoke wall time: {time.perf_counter() - t_start:.1f} s '
          '(the kernels\' build included)')
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
    print(json.dumps({'kernels': [{key: k[key] for key in keys}
                                  for k in kernels.values()]}))
    print(smi[0])
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
