"""Per-kernel table of the PyTorch/CUDA port on one NVIDIA GPU.

For every kernel of ``nnpops_tpu_torch._kernels.LAUNCHES`` this script
records the kernel's inputs from the path that launches it (one selection
and one step, through ``utils.profiling.recording``), holds the kernel
against its plain PyTorch version on them at the gates of the card tests,
checks two launches bitwise equal, and times both: the kernel as 20 calls
captured in a CUDA graph and replayed 5 times between CUDA events (2 calls
for the CFConv kernels, whose call takes milliseconds), the plain version
as eager calls between CUDA events. Beside the times it prints the
kernel's bound, the larger of its bytes over the memory rate and its
operations over the peak of their type (FP32, SFU or bf16 tensor cores;
the rates of ``mdbench/peaks.json``), and, for the fused ensemble's two
GEMM stages, cuBLAS bf16 products at their shapes (the yardstick; the
port never calls them).

Shapes (ANI-2x at full width, 8 random models from the seed, bf16 fused
ensemble, window layout with skin 0.25 A and margin 1.15, on
``make_water_box``):

* water-2.6k (867 waters): the left-pack (B.1), the window radial kernel
  (B.2), the angular kernel over its row tiers (B.3), the fused
  ensemble's stage kernels (B.4; the forward stages from the energy
  without gradients), and the z-pair radial kernel (B.9) of
  ``window_radial='pair'``;
* config5-2.6k and -26k: the PME window kernel (B.5) in one force step of
  BASELINE config 5 (``models.combined.config5``);
* cfconv-26k: the CFConv backward (B.6), its forces-only kernel and the
  fused CFConv forward on the layers of the JAX package's
  ``bench_cfconv_periodic`` chain (:func:`periodic_stack`: 26,010 atoms
  at density 0.1, width 128, 50 Gaussians, 10 A cutoff, 6 layers, a
  6x6x6 cell grid, 640 neighbor lanes), checked on layers 1 and 6 (the
  forward) and on the last layer's backward, timed on one layer; the
  forces-only kernel's inputs come from an iteration whose weights need
  no gradient (the MD case);
* painn-26k (8,670 waters, 26,010 atoms): PaiNN's fused message backward
  on the inputs of the first backward of one force call at its published
  widths (F 128, 20 radial functions, 5 A, 3 blocks, K 128), against the
  plain chunked backward;
* water-26k (8,670 waters): the mask kernel and the lane left-pack (B.7)
  of ``select_window(compact_impl='mask')``, the cluster-pair radial
  kernel (B.8) of ``radial_impl='cluster'`` per i-species, and the
  left-pack and the z-pair kernel again at this size.

Prints one line a kernel, the kernels' JSON line (one entry per key of
``LAUNCHES``; ``launches`` counts the kernel's launches in the one
selection and step its inputs came from, the CFConv kernels' in one
iteration of the chain), then the card line and ``{"ok": true, "device":
...}`` as the last line. Whether the paths are right on the card is
``tests/test_torch_cuda.py``'s question; how fast a cell runs is
``mdbench``'s. Any failure raises (non-zero exit). Run from the repository
root:

    python3 chip_smoke.py
"""
import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from nnpops_tpu_torch import ANIBasis, _kernels
from nnpops_tpu_torch.config import CFConvConfig, PaiNNConfig
from nnpops_tpu_torch.models import ani as ani_mod
from nnpops_tpu_torch.models import combined as combined_mod
from nnpops_tpu_torch.models.ani import ANIModel, init_ani_params
from nnpops_tpu_torch.models.painn import PaiNNModel
from nnpops_tpu_torch.models.schnet import CFConvStack, conv_chunk
from nnpops_tpu_torch.neighbors import clusters as clusters_mod
from nnpops_tpu_torch.neighbors import window as window_mod
from nnpops_tpu_torch.neighbors.cell_list import CellList
from nnpops_tpu_torch.ops import (cuda_aev, cuda_cfconv, cuda_cluster,
                                  cuda_nn, cuda_pme, cuda_select,
                                  cuda_window, cuda_zpair)
from nnpops_tpu_torch.ops import painn as painn_ops
from nnpops_tpu_torch.ops.aev_blocked import triple_tables
from nnpops_tpu_torch.ops.batched_nn import resolve_device
from nnpops_tpu_torch.ops.cfconv import CFConvParams
from nnpops_tpu_torch.utils import make_water_box
from nnpops_tpu_torch.utils.profiling import recording
from mdbench.reference.painn_cell_list import PAIR_BWD_PER_F, PAIR_BWD_PER_R

MOLECULES = 867          # 2,601 atoms, box 29.6 A
LARGE_MOLECULES = 8670   # 26,010 atoms, box 63.8 A
SKIN = 0.25
MARGIN = 1.15
SEED = 0
DEV = torch.device('cuda', 0)
PEAKS = Path(__file__).resolve().parent / 'mdbench' / 'peaks.json'

# Operations per unit of work, counted from the CUDA sources (an FMA counts
# two, a sqrt, exp or log one): angular_aev.cu per triple whose two lanes
# are inside the cutoff, at the (8, 4) grid, FP32 operations and MUFU
# operations apart (rcp, rsqrt, 4 lg2 + 12 ex2 in either direction; the
# kernel's SASS holds each of these once); window_radial.cu per (real
# center, window lane) pair tested (the distance and its test, FP32) and
# per pair inside the cutoff, R = 16 Gaussians, FP32 and MUFU apart (one
# rsqrt and 16 ex2 in either direction). The work stays every real center
# times kk lanes tested, whatever lanes the kernel skips.
ANG_FWD_OPS = 172
ANG_BWD_OPS = 341
ANG_SFU = 18
RAD_TEST_OPS = 9
RAD_FWD_OPS = 110
RAD_BWD_OPS = 190
RAD_SFU = 17
# pme_window.cu per (real center, window lane) pair tested and per pair
# inside the cutoff (one evaluation per pair in either direction; MUFU:
# rsqrt, ex2 and rcp).
PME_TEST_OPS = 9
PME_FWD_OPS = 28
PME_BWD_OPS = 48
PME_SFU = 3
# pair_radial.cu and cluster_radial.cu per (real center, lane) pair tested
# (the distance and its test) and per pair inside the cutoff, R = 16
# Gaussians, FP32 and MUFU apart: the z-pair kernel's one evaluation of a
# pair adds each term to both of its sums (forward 102, backward 174 with
# the three cotangent sums); the cluster kernel's forward 86, backward 155;
# MUFU rsqrt, cos and 16 ex2 forward, and sin backward. The work stays
# every real center times every lane tested, whatever lanes the kernels
# skip; window_mask.cu per (center, lane) pair; left_pack_lanes per mask
# byte.
PAIR_TEST_OPS = 9
PAIR_FWD_OPS = 102
PAIR_BWD_OPS = 174
CLUSTER_TEST_OPS = 9
CLUSTER_FWD_OPS = 86
CLUSTER_BWD_OPS = 155
PAIR_SFU = {'fwd': 18, 'bwd': 19}      # both kernels, per pair inside
MASK_OPS = 10
LANE_PACK_OPS = 3

REPLACES = {
    'angular_aev_fwd': 'nnpops_tpu/ops/pallas_aev.py:614',
    'angular_aev_bwd': 'nnpops_tpu/ops/pallas_aev.py:626',
    # B.4's stages: the fwd pl.pallas_call (:183) runs as layer1 + hidden,
    # the fwdgrad one (:194) as layer1 + hidden + dx.
    'fused_nn_fwd_layer1': 'nnpops_tpu/ops/pallas_nn.py:183',
    'fused_nn_fwd_hidden': 'nnpops_tpu/ops/pallas_nn.py:183',
    'fused_nn_fwdgrad_layer1': 'nnpops_tpu/ops/pallas_nn.py:194',
    'fused_nn_fwdgrad_hidden': 'nnpops_tpu/ops/pallas_nn.py:194',
    'fused_nn_fwdgrad_dx': 'nnpops_tpu/ops/pallas_nn.py:194',
    'left_pack': 'nnpops_tpu/ops/pallas_select.py:139',
    'window_radial_fwd': 'nnpops_tpu/ops/pallas_window.py:361',
    'window_radial_bwd': 'nnpops_tpu/ops/pallas_window.py:378',
    # One pl.pallas_call (:288 with the cell map, :292 without) runs both
    # kernels of B.5; each entry names its kernel body.
    'pme_window_fwd': 'nnpops_tpu/ops/pallas_pme.py:177',
    'pme_window_bwd': 'nnpops_tpu/ops/pallas_pme.py:199',
    'cfconv_bwd': 'nnpops_tpu/ops/pallas_cfconv.py:182',
    # B.6 without the weight gradients: the same pl.pallas_call's work as
    # MD asks for it.
    'cfconv_bwd_forces': 'nnpops_tpu/ops/pallas_cfconv.py:182',
    'cfconv_fwd': 'none: the JAX package left the forward to XLA '
                  '(nnpops_tpu/ops/cfconv.py _fwd_rows)',
    'painn_bwd': 'none: the JAX package has no PaiNN',
    'window_mask': 'nnpops_tpu/ops/pallas_select.py:244',
    'left_pack_lanes': 'nnpops_tpu/ops/pallas_select.py:334',
    'cluster_radial_fwd': 'nnpops_tpu/ops/pallas_cluster.py:180',
    'cluster_radial_bwd': 'nnpops_tpu/ops/pallas_cluster.py:191',
    'pair_radial_fwd': 'nnpops_tpu/ops/pallas_zpair.py:219',
    'pair_radial_bwd': 'nnpops_tpu/ops/pallas_zpair.py:233',
}


@functools.cache
def peak(name):
    """A rate of ``mdbench/peaks.json`` (H100 SXM, data sheet, dense):
    'hbm_bytes', 'fp32_flops', 'bf16_tensor_flops' or 'sfu_ops' a
    second."""
    return float(json.loads(PEAKS.read_text())[name])


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


def deterministic(label, first, again):
    """Two launches on the same inputs give bitwise equal outputs."""
    for a, b in zip(first, again):
        if not torch.equal(a, b):
            raise AssertionError(f'{label}: two launches differ')


def entry(name, source, err, kernel_fn, plain_fn, nbytes, ops, rate,
          calls=20):
    """One kernel's JSON entry: ``ms`` the kernel's device time
    (:func:`graph_ms` over ``calls`` calls), ``event_ms`` the same calls
    launched eagerly (not in the JSON line), ``plain_ms`` the plain
    version's; the bound is the larger of the bytes over the memory rate
    and ``ops`` over ``rate``, the peak for their type. ``source`` names a
    file of ``_kernels.SOURCES`` without its suffix."""
    if f'{source}.cu' not in _kernels.SOURCES:
        raise KeyError(f'{source}.cu is not a kernel source')
    t_bytes, t_ops = nbytes / peak('hbm_bytes'), ops / rate
    return dict(name=name, route='cuda',
                source=f'nnpops_tpu_torch/csrc/{source}.cu',
                replaces=REPLACES[name], launches=None, max_abs_err=err,
                ms=graph_ms(kernel_fn, iters=calls),
                event_ms=cuda_ms(kernel_fn, iters=calls),
                plain_ms=cuda_ms(plain_fn, iters=calls),
                bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations',
                library_ms=None)


def sfu_bound(tested, test_ops, inside, ops, sfu):
    """(operations, rate, bound_by label, FP32-only bound ms) of the larger
    of a kernel's FP32 work (``test_ops`` per pair tested, ``ops`` per pair
    inside the cutoff or triple) and its SFU work (``sfu`` per pair inside
    or triple)."""
    f32 = (tested * test_ops + inside * ops, peak('fp32_flops'), 'FP32')
    mufu = (inside * sfu, peak('sfu_ops'), 'SFU')
    return max(f32, mufu, key=lambda b: b[0] / b[1]) + (1e3 * f32[0] / f32[1],)


def bound_kind(e, bound):
    """What bounds an entry whose operations bound is ``sfu_bound``'s."""
    return 'bytes' if e['bound_by'] == 'bytes' else bound[2]


def times_text(fwd, bwd, bounds):
    """The printed times and bounds of a kernel's two directions."""
    return ', '.join(
        f'{name} {e["ms"]:.5f} ms (eager {e["event_ms"]:.5f}, plain '
        f'{e["plain_ms"]:.4f}), bound {e["bound_ms"]:.5f} ms '
        f'({bound_kind(e, bounds[name])}; FP32 only {bounds[name][3]:.5f})'
        for name, e in (('fwd', fwd), ('bwd', bwd)))


def merge(entries):
    """Sum entries of one kernel over several launches (tiers, species)."""
    out = dict(entries[0])
    for key in ('ms', 'event_ms', 'plain_ms', 'bound_ms'):
        out[key] = sum(e[key] for e in entries)
    out['max_abs_err'] = max(e['max_abs_err'] for e in entries)
    return out


def record(fn, *targets):
    """Run ``fn()`` with the launch counts set to 0 and the calls of every
    ``(module, name)`` of ``targets`` recorded; returns (a list of calls
    for each target, the launches)."""
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    calls = [[] for _ in targets]
    with contextlib.ExitStack() as stack:
        for (module, name), into in zip(targets, calls):
            stack.enter_context(recording(module, name, into))
        fn()
    torch.cuda.synchronize()
    return calls, dict(_kernels.LAUNCHES)


def build(molecules, basis, **layout):
    """The window-path model on ``make_water_box(molecules)``, its cell
    list, positions and box on the card."""
    water = make_water_box(molecules, seed=SEED)
    model = ANIModel.from_atomic_numbers(
        water.atomic_numbers, basis, nn_dtype='bfloat16',
        nn_impl='fused').with_blocked_layout(
            water.positions, water.box, margin=MARGIN, impl='window',
            skin=SKIN, **layout)
    if model.aev_impl != 'window':
        raise AssertionError(f'the window layout fell back to '
                             f'{model.aev_impl}')
    box = torch.tensor(water.box, device=DEV)
    pos = torch.tensor(water.positions, device=DEV)
    return model, model.create_cell_list(water.box, skin=SKIN), pos, box


def select_and_step(model, params, pos, box, cell_list):
    """One selection and one force step of ``model``."""
    sel = model.select(pos, box, cell_list)
    model.energy_and_forces_from_selection(params, pos, box, cell_list, sel)
    return sel


# ---------------------------------------------------------------------------
# Each kernel against its plain version on one recorded input, timed.
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
    d = deltas[:, :, torch.as_tensor(cuda_aev._lane_positions(layout, width),
                                     device=DEV).long()]
    inside = mask & (d.square().sum(0).sqrt() < basis.angular_cutoff)
    tables = triple_tables(layout)
    jj, kk = (torch.as_tensor(t, device=DEV).long()
              for t in (tables.jj, tables.kk))
    triples = int((inside[:, jj] & inside[:, kk]).sum())
    io = deltas.numel() * 4 + mask.numel()
    fwd_bytes = io + raw_k.numel() * 4
    bwd_bytes = io + raw_cot.numel() * 4 + deltas.numel() * 4
    # The bound: the larger of the bytes, the FP32 operations and the SFU
    # operations; the FP32-only bound printed beside it.
    bounds = {name: sfu_bound(0, 0, triples, ops, ANG_SFU)
              for name, ops in (('fwd', ANG_FWD_OPS), ('bwd', ANG_BWD_OPS))}
    fwd = entry('angular_aev_fwd', 'angular_aev', max_abs(a_k, a_p),
                lambda: cuda_aev.angular_fwd_cuda(deltas, mask, spec),
                lambda: cuda_aev.angular_aev_plain(deltas, mask, basis,
                                                   layout, width),
                fwd_bytes, *bounds['fwd'][:2])
    bwd = entry('angular_aev_bwd', 'angular_aev', max_abs(g_k, g_p),
                lambda: cuda_aev.angular_bwd_cuda(deltas, mask, raw_cot, spec),
                lambda: torch.autograd.grad(raw_pg, d_p, raw_cot,
                                            retain_graph=True),
                bwd_bytes, *bounds['bwd'][:2])
    deterministic('angular fwd', [raw_k],
                  [cuda_aev.angular_fwd_cuda(deltas, mask, spec)])
    deterministic('angular bwd',
                  [cuda_aev.angular_bwd_cuda(deltas, mask, raw_cot, spec)],
                  [cuda_aev.angular_bwd_cuda(deltas, mask, raw_cot, spec)])
    print(f'angular rows {deltas.shape[1]} lanes {spec.kat} static triples '
          f'{len(tables.jj)} (inside the cutoff {triples}): ' + ', '.join(
              f'{name} {e["ms"]:.5f} ms, bound {e["bound_ms"]:.5f} ms '
              f'({bound_kind(e, bounds[name])}; FP32 only '
              f'{bounds[name][3]:.5f})'
              for name, e in (('fwd', fwd), ('bwd', bwd)))
          + '; two launches bitwise equal')
    return fwd, bwd


def nn_entries(ens, feat, counts):
    """Entries of the fused ensemble's stage kernels on species-grouped AEV
    rows (one launch set for every species): each stage kernel against its
    plain version on the same inputs, two launches of the whole function
    bitwise equal, the stages' times and the cuBLAS yardstick."""
    counts = tuple(int(c) for c in counts)
    n = sum(counts)
    pe = cuda_nn.pack_ensemble(ens)
    x = feat[:n].detach().contiguous()
    x16 = cuda_nn.to_bf16_input(x, pe)
    rows = cuda_nn.species_rows(pe, counts)
    ws = cuda_nn.workspace(pe, counts, True)
    buf = torch.empty(ws.nbytes, dtype=torch.uint8, device=DEV)
    h1, d1, g1, epart, cnt = cuda_nn.workspace_views(buf, ws, pe, n)
    h1_p, d1_p = cuda_nn.layer1_plain(x16, pe, counts, True)
    e_p, g1_p = cuda_nn.hidden_plain(h1_p, d1_p, pe, counts, True)
    dx_p = cuda_nn.dx_plain(g1_p, pe, counts)

    def cols(a, b, name, rtol):
        err = 0.0
        for _, r0, r1, ksp in rows:
            check_normwise(name, a[r0:r1, :ksp].float(),
                           b[r0:r1, :ksp].float(), rtol)
            err = max(err, max_abs(a[r0:r1, :ksp].float(),
                                   b[r0:r1, :ksp].float()))
        return err

    # Each stage kernel on its plain version's inputs. Normwise gates: a
    # bf16 result can round the other way when the f32 accumulation order
    # differs.
    cuda_nn.layer1_cuda(x16, pe, counts, h1, d1, cnt)
    err_l1 = max(cols(h1, h1_p, 'layer1 H1', 1e-2),
                 cols(d1, d1_p, 'layer1 D1', 1e-2))
    h1f = torch.empty_like(h1)
    cuda_nn.layer1_cuda(x16, pe, counts, h1f, None, cnt)
    err_l1f = cols(h1f, h1_p, 'layer1 fwd H1', 1e-2)
    h1.copy_(h1_p)
    d1.copy_(d1_p)
    e_h = torch.empty(n, 1, device=DEV)
    cuda_nn.hidden_cuda(h1, d1, pe, counts, g1, epart, cnt, e_h)
    check_normwise('hidden e', e_h, e_p, 1e-3)
    err_h = max(max_abs(e_h, e_p), cols(g1, g1_p, 'hidden G1', 1e-2))
    e_hf = torch.empty(n, 1, device=DEV)
    cuda_nn.hidden_cuda(h1, None, pe, counts, None, epart, cnt, e_hf)
    check_normwise('hidden fwd e', e_hf, e_p, 1e-3)
    g1.copy_(g1_p)
    dx = torch.empty(n, pe.in_actual, device=DEV)
    cuda_nn.dx_cuda(g1, pe, counts, dx)
    check_normwise('dx', dx, dx_p, 1e-4)
    for grad, outs in ((True, 2), (False, 1)):    # (e, dx) or (e,)
        deterministic(f'fused nn {"fwdgrad" if grad else "fwd"}',
                      cuda_nn.ensemble_cuda(x, pe, counts, grad)[:outs],
                      cuda_nn.ensemble_cuda(x, pe, counts, grad)[:outs])

    # Work, from the packed widths (the ANI-2x widths need no padding).
    m = pe.num_models
    l1_macs = sum((r1 - r0) * pe.in_pad * ksp for _, r0, r1, ksp in rows)
    hid_macs = sum((r1 - r0) * m * (sum(a * b for a, b in zip(
        pe.nets[s].dims[1:-2], pe.nets[s].dims[2:-1]))
        + pe.nets[s].dims[-2]) for s, r0, r1, _ in rows)
    dx_macs = sum((r1 - r0) * ksp * pe.in_actual for _, r0, r1, ksp in rows)
    k_rows = sum((r1 - r0) * ksp for _, r0, r1, ksp in rows)
    w1_bytes = sum(ksp * (pe.in_pad * 2 + 4) for _, _, _, ksp in rows)
    hid_w_bytes = sum(pe.nets[s].wbuf.numel() * 2 + pe.nets[s].fbuf.numel() * 4
                      for s, _, _, _ in rows)
    io = x16.numel() * 2
    bf16 = peak('bf16_tensor_flops')
    s1 = [(x16[r0:r1], pe.nets[s].w1) for s, r0, r1, _ in rows]
    s3 = [(g1[r0:r1, :ksp], pe.nets[s].w1) for s, r0, r1, ksp in rows]
    ents = {
        'fused_nn_fwd_layer1': entry(
            'fused_nn_fwd_layer1', 'fused_nn', err_l1f,
            lambda: cuda_nn.layer1_cuda(x16, pe, counts, h1f, None, cnt),
            lambda: cuda_nn.layer1_plain(x16, pe, counts, False),
            io + w1_bytes + 2 * k_rows, 2 * l1_macs, bf16),
        'fused_nn_fwd_hidden': entry(
            'fused_nn_fwd_hidden', 'fused_nn', max_abs(e_hf, e_p),
            lambda: cuda_nn.hidden_cuda(h1, None, pe, counts, None, epart,
                                        cnt, e_hf),
            lambda: cuda_nn.hidden_plain(h1_p, None, pe, counts, False),
            2 * k_rows + hid_w_bytes + 4 * n, 2 * hid_macs, bf16),
        'fused_nn_fwdgrad_layer1': entry(
            'fused_nn_fwdgrad_layer1', 'fused_nn', err_l1,
            lambda: cuda_nn.layer1_cuda(x16, pe, counts, h1, d1, cnt),
            lambda: cuda_nn.layer1_plain(x16, pe, counts, True),
            io + w1_bytes + 6 * k_rows, 2 * l1_macs, bf16),
        'fused_nn_fwdgrad_hidden': entry(
            'fused_nn_fwdgrad_hidden', 'fused_nn', err_h,
            lambda: cuda_nn.hidden_cuda(h1, d1, pe, counts, g1, epart, cnt,
                                        e_h),
            lambda: cuda_nn.hidden_plain(h1_p, d1_p, pe, counts, True),
            8 * k_rows + hid_w_bytes + 4 * n, 4 * hid_macs, bf16),
        'fused_nn_fwdgrad_dx': entry(
            'fused_nn_fwdgrad_dx', 'fused_nn', max_abs(dx, dx_p),
            lambda: cuda_nn.dx_cuda(g1, pe, counts, dx),
            lambda: cuda_nn.dx_plain(g1_p, pe, counts),
            2 * k_rows + w1_bytes + 4 * n * pe.in_actual, 2 * dx_macs,
            bf16),
    }
    # Yardstick: cuBLAS bf16 products at the stage-1 and stage-3 shapes
    # (timed here only; the port never calls them).
    lib1 = graph_ms(lambda: [torch.matmul(a, w.t()) for a, w in s1])
    lib3 = graph_ms(lambda: [torch.matmul(a, w) for a, w in s3])
    for name in ('fused_nn_fwd_layer1', 'fused_nn_fwdgrad_layer1'):
        ents[name]['library_ms'] = lib1
    ents['fused_nn_fwdgrad_dx']['library_ms'] = lib3
    print(f'fused nn (rows {counts}): cuBLAS bf16 layer-1 products '
          f'{lib1:.5f} ms, dx products {lib3:.5f} ms; staged intermediates '
          f'{ws.nbytes / 1e6:.1f} MB; two launches bitwise equal')
    return ents


def left_pack_entry(keys, widths, caps, label='left_pack'):
    """The left-pack's entry on one recorded call: the kernel must equal
    its plain version exactly, and two launches each other."""
    packed, counts = cuda_select.left_pack_cuda(keys, widths, caps)
    p_packed, p_counts = cuda_select.left_pack_plain(keys, widths, caps)
    again = cuda_select.left_pack_cuda(keys, widths, caps)
    if not (torch.equal(packed, p_packed) and torch.equal(counts, p_counts)):
        raise AssertionError(f'{label}: kernel and plain version differ')
    deterministic(label, (packed, counts), again)
    e = entry('left_pack', 'left_pack', 0.0,
              lambda: cuda_select.left_pack_cuda(keys, widths, caps),
              lambda: cuda_select.left_pack_plain(keys, widths, caps),
              4 * (keys.numel() + packed.numel() + counts.numel()),
              3 * keys.numel(), peak('fp32_flops'))
    print(f'{label} keys {tuple(keys.shape)} widths {tuple(widths)} caps '
          f'{tuple(caps)} (valid {int((keys >= 0).sum())}): {e["ms"]:.5f} ms '
          f'(eager {e["event_ms"]:.5f}, plain {e["plain_ms"]:.4f}), bound '
          f'{e["bound_ms"]:.5f} ms ({e["bound_by"]}); two launches bitwise '
          'equal')
    return e


def radial_entries(args, kwargs):
    """(fwd, bwd) entries of the window radial kernel on one recorded call
    of ``window_radial(candx, candy, candz, centers, rc, eta, rs, cell_caps,
    torchani, center_caps=...)``; the bound the larger of the bytes, the FP32
    and the SFU operations (the FP32-only bound printed beside)."""
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
    deterministic('window radial fwd', [out_k],
                  [cuda_window.window_radial_fwd_cuda(cx, cy, cz, ctr, spec)])
    deterministic('window radial bwd', grads_k,
                  cuda_window.window_radial_bwd_cuda(cx, cy, cz, ctr, g, spec))
    bounds = {name: sfu_bound(tested, RAD_TEST_OPS, inside, ops, RAD_SFU)
              for name, ops in (('fwd', RAD_FWD_OPS), ('bwd', RAD_BWD_OPS))}
    fwd = entry('window_radial_fwd', 'window_radial', max_abs(out_k, out_p),
                lambda: cuda_window.window_radial_fwd_cuda(cx, cy, cz, ctr,
                                                           spec),
                lambda: cuda_window.window_radial_plain(
                    cx, cy, cz, ctr, *args[4:9], center_caps=center_caps),
                io + 4 * out_k.numel(), *bounds['fwd'][:2])
    bwd = entry('window_radial_bwd', 'window_radial',
                max(max_abs(a, b) for a, b in zip(grads_k, grads_p)),
                lambda: cuda_window.window_radial_bwd_cuda(cx, cy, cz, ctr, g,
                                                           spec),
                lambda: torch.autograd.grad(out_p, ins, g, retain_graph=True),
                2 * io + 4 * g.numel(), *bounds['bwd'][:2])
    print(f'window radial cells {cx.shape[0]} center rows '
          f'{ctr.shape[1]} lanes {geo.kk} (pairs tested {tested}, inside '
          f'{inside}): ' + times_text(fwd, bwd, bounds)
          + '; two launches bitwise equal')
    return fwd, bwd


def pme_entries(args, label, calls=20):
    """(fwd, bwd) entries of the PME window kernel on one recorded call of
    ``pme_window(candx, candy, candz, candq, centers, excl, ncells3,
    cutoff, alpha, coulomb)``; the backward takes the main path's cotangent
    (ones: the energy is the sum of the rows). The bound the larger of the
    bytes, the FP32 and the SFU operations (the FP32-only bound printed
    beside)."""
    planes = [t.detach().contiguous() for t in args[:5]]
    excl = args[5].contiguous()
    ncells3, cutoff, alpha, coulomb = args[6:10]
    spec = cuda_pme._PmeSpec(ncells3, planes[4].shape[1], excl.shape[2],
                             cutoff, alpha, coulomb)
    out_k = cuda_pme.pme_window_fwd_cuda(*planes, excl, spec)
    ins = [t.clone().requires_grad_(True) for t in planes]
    out_p = cuda_pme.pme_window_plain(*ins, excl, *args[6:10])
    check_close(f'{label} pme window fwd energy', out_k.sum(),
                out_p.detach().sum(), rtol=1e-5, atol=0.0)
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
    deterministic(f'{label} pme window fwd', [out_k],
                  [cuda_pme.pme_window_fwd_cuda(*planes, excl, spec)])
    deterministic(f'{label} pme window bwd', grads_k,
                  cuda_pme.pme_window_bwd_cuda(*planes, excl, g, spec))
    bounds = {name: sfu_bound(tested, PME_TEST_OPS, inside, ops, PME_SFU)
              for name, ops in (('fwd', PME_FWD_OPS), ('bwd', PME_BWD_OPS))}
    fwd = entry('pme_window_fwd', 'pme_window', max_abs(out_k, out_p),
                lambda: cuda_pme.pme_window_fwd_cuda(*planes, excl, spec),
                lambda: cuda_pme.pme_window_plain(*planes, excl, *args[6:10]),
                io + 4 * out_k.numel(), *bounds['fwd'][:2], calls=calls)
    bwd = entry('pme_window_bwd', 'pme_window',
                max(max_abs(a, b) for a, b in zip(grads_k, grads_p)),
                lambda: cuda_pme.pme_window_bwd_cuda(*planes, excl, g, spec),
                lambda: torch.autograd.grad(out_p, ins, g, retain_graph=True),
                # Every input read once; the four planes' and the centers'
                # cotangents written once.
                io + 4 * (4 * cx.numel() + ctr.numel() + g.numel()),
                *bounds['bwd'][:2], calls=calls)
    print(f'{label} pme window cells {spec.ncells} capacity {spec.c} lanes '
          f'{spec.kk} exclusions {excl.shape[2]} (pairs tested {tested}, '
          f'inside {inside}): ' + times_text(fwd, bwd, bounds)
          + f'; energy {float(out_k.sum()):.4f} vs '
          f'{float(out_p.detach().sum()):.4f}; two launches bitwise equal')
    return fwd, bwd


def cfconv_pair_ops(width, gaussians, weight_grads=True):
    """Operations per valid pair of the CFConv backward, counted from
    ``csrc/cfconv_bwd.cu`` (an FMA counts two): ``(products, elementwise)``,
    the four filter products and the two weight-gradient products, 3 W^2 +
    3 G W FMAs (the kernels run each three times, in bf16 passes; without
    ``weight_grads`` the four filter products alone, 2 W^2 + 2 G W), and
    the Gaussians (11 G), the activation, its derivative and the d_y1 /
    d_x / d_fc terms (18 W) and the cutoff (6)."""
    products = 3 if weight_grads else 2
    return (2 * products * (width * width + gaussians * width),
            11 * gaussians + 18 * width + 6)


def cfconv_fwd_check(label, args, cfg, chunk):
    """The fused forward against its plain version on one recorded call of
    ``cfconv_fwd(params, dist, mask, idx, x, config, ...)``: normwise 1e-6
    of the reference's scale (both true f32)."""
    params, dist, mask, idx, x = args
    got = cuda_cfconv.cfconv_fwd_cuda(params, dist, mask, idx, x, cfg)
    want = cuda_cfconv.conv_fwd_plain(params, dist, mask, idx, x, cfg, chunk)
    check_normwise(f'{label} cfconv fwd', got, want, 1e-6)
    err = max_abs(got, want)
    print(f'{label} cfconv fwd rows {dist.shape[0]} lanes {dist.shape[1]}: '
          f'max|d out| {err:.3g} (max {float(want.abs().max()):.3g}, '
          f'normwise {err / float(want.abs().max()):.3g})')
    return err


def cfconv_fwd_entry(calls, cfg, chunk):
    """The fused forward kernel on the recorded forwards of the stack's 6
    layers: checked on layers 1 and 6, timed on layer 1's inputs. Bound:
    the filter products, 2 (G W + W^2) operations a valid pair, at the f32
    FFMA rate (the configuration computes in true f32), or the bytes."""
    rec = [(tuple(a.detach() for a in c[0][0]),)
           + tuple(a.detach() for a in c[0][1:5]) for c in calls]
    err = max(cfconv_fwd_check('26k layer 1', rec[0], cfg, chunk),
              cfconv_fwd_check('26k layer 6', rec[-1], cfg, chunk))
    params, dist, mask, idx, x = rec[0]
    del rec
    pairs = int(mask.sum())
    n, k = dist.shape
    wd, ng = cfg.width, cfg.num_gaussians
    # dist, mask, idx, x and the weights read once, out written once.
    nbytes = n * k * (4 + 1 + 4) + 2 * 4 * n * wd \
        + 4 * (ng * wd + wd + wd * wd + wd + ng)
    ops = pairs * 2 * (ng * wd + wd * wd)
    f32 = peak('fp32_flops')
    kernel = lambda: cuda_cfconv.cfconv_fwd_cuda(  # noqa: E731
        params, dist, mask, idx, x, cfg)
    e = entry('cfconv_fwd', 'cfconv_fwd', err, kernel,
              lambda: cuda_cfconv.conv_fwd_plain(params, dist, mask, idx, x,
                                                 cfg, chunk),
              nbytes, ops, f32, calls=2)
    deterministic('cfconv_fwd', [kernel()], [kernel()])
    print(f"cfconv_fwd: rows {n} lanes {k}, valid pairs {pairs}: kernel "
          f"{e['ms']:.4f} ms (CUDA graph; eager {e['event_ms']:.4f} ms), "
          f"plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
          f"({e['bound_by']}: {ops} FFMA operations at {f32:.3g}/s, "
          f"{nbytes} bytes), {100 * e['bound_ms'] / e['ms']:.1f} % of it "
          f"({ops / e['ms'] / 1e9:.1f} TFLOP/s); max|err| {err:.3g}")
    return e


def cfconv_bwd_entry(call, cfg, chunk):
    """B.6 against its plain version on one recorded call of
    ``cfconv_bwd(params, dist, mask, idx, x, g, config, ...)`` (normwise
    gates: 1e-4 of the reference's scale on d_dist and d_x, 1e-3 on the
    weight gradients, sums over every pair), timed. Bound: the three bf16
    passes of its products on the tensor cores, or the elementwise work at
    the f32 rate if that takes longer (it does not at these widths), or the
    bytes; the f32 bound of all its operations printed beside."""
    # Detached: the saved inputs require grad, and the plain version would
    # otherwise keep every chunk's intermediates for autograd.
    params = tuple(a.detach() for a in call[0][0])
    dist, mask, idx, x, g = (a.detach() for a in call[0][1:6])
    got = cuda_cfconv.cfconv_bwd_cuda(params, dist, mask, idx, x, g, cfg)
    want = cuda_cfconv.cfconv_bwd_plain(params, dist, mask, idx, x, g, cfg,
                                        chunk)
    (gw, gd, gx), (ww, wd, wx) = got, want
    for name, a, b, tol in ([('d_dist', gd, wd, 1e-4), ('d_x', gx, wx, 1e-4)]
                            + [(f'd_{n}', a, b, 1e-3) for n, a, b in
                               zip(('w1', 'b1', 'w2', 'b2'), gw, ww)]):
        check_normwise(f'26k cfconv bwd {name}', a, b, tol)
    if bool(gd[~mask].any()):
        raise AssertionError('26k: nonzero d_dist on a masked lane')
    err = max(max_abs(a, b) for a, b in zip((*gw, gd, gx), (*ww, wd, wx)))
    del got, want, gw, gd, gx, ww, wd, wx
    pairs = int(mask.sum())
    n, k = dist.shape
    width, ng = cfg.width, cfg.num_gaussians
    size = ng * width + width + width * width + width
    # Every input read once (dist, mask, idx, x, g, weights, centers), every
    # output written once (d_dist, d_x, the four weight gradients).
    nbytes = n * k * (4 + 1 + 4) + 2 * 4 * n * width + 4 * (size + ng) \
        + 4 * n * k + 4 * n * width + 4 * size
    prod, elem = (pairs * o for o in cfconv_pair_ops(width, ng))
    f32, bf16 = peak('fp32_flops'), peak('bf16_tensor_flops')
    tc_bound = 3 * prod / bf16 >= elem / f32
    ops, rate = (3 * prod, bf16) if tc_bound else (elem, f32)
    kernel = lambda: cuda_cfconv.cfconv_bwd_cuda(  # noqa: E731
        params, dist, mask, idx, x, g, cfg)
    e = entry('cfconv_bwd', 'cfconv_bwd', err, kernel,
              lambda: cuda_cfconv.cfconv_bwd_plain(params, dist, mask, idx, x,
                                                   g, cfg, chunk),
              nbytes, ops, rate, calls=2)
    first, again = kernel(), kernel()
    deterministic('cfconv_bwd', [*first[0], *first[1:]],
                  [*again[0], *again[1:]])
    f32_bound = 1e3 * max(nbytes / peak('hbm_bytes'), (prod + elem) / f32)
    print(f"cfconv_bwd: rows {n} lanes {k}, valid pairs {pairs}: kernel "
          f"{e['ms']:.4f} ms (CUDA graph; eager {e['event_ms']:.4f} ms), "
          f"plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
          f"({'tensor cores: 3 bf16 passes of' if tc_bound else 'f32'} "
          f"{ops} operations at {rate:.3g}/s; {elem} elementwise "
          f"operations, {nbytes} bytes), {100 * e['bound_ms'] / e['ms']:.1f} "
          f"% of it; the f32 bound of all {prod + elem} operations "
          f"{f32_bound:.4f} ms; max|err| {err:.3g}; two launches bitwise "
          f"equal")
    return e


def cfconv_bwd_forces_entry(call, cfg, chunk):
    """B.6's forces-only kernel on one recorded call of ``cfconv_bwd(...,
    weight_grads=False)``: against its plain version (normwise 1e-4 on
    d_dist and d_x) and against the full kernel's d_dist and d_x (bitwise:
    the same products and f32 epilogues in the same order), timed. Bound:
    its four filter products' three bf16 passes on the tensor cores (two
    thirds of B.6's), or the bytes."""
    if call[1].get('weight_grads') is not False:
        raise AssertionError('the recorded backward asks for weight '
                             'gradients')
    params = tuple(a.detach() for a in call[0][0])
    dist, mask, idx, x, g = (a.detach() for a in call[0][1:6])
    kernel = lambda: cuda_cfconv.cfconv_bwd_cuda(  # noqa: E731
        params, dist, mask, idx, x, g, cfg, weight_grads=False)
    got = kernel()
    want = cuda_cfconv.cfconv_bwd_plain(params, dist, mask, idx, x, g, cfg,
                                        chunk, weight_grads=False)
    full = cuda_cfconv.cfconv_bwd_cuda(params, dist, mask, idx, x, g, cfg)
    for i, name in ((1, 'd_dist'), (2, 'd_x')):
        check_normwise(f'26k cfconv bwd forces {name}', got[i], want[i],
                       1e-4)
        if not torch.equal(got[i], full[i]):
            raise AssertionError(f'26k cfconv bwd forces {name}: not the '
                                 'full kernel\'s')
    if got[0] is not None or bool(got[1][~mask].any()):
        raise AssertionError('26k forces: weight gradients, or a nonzero '
                             'd_dist on a masked lane')
    err = max(max_abs(got[1], want[1]), max_abs(got[2], want[2]))
    del got, want, full
    pairs = int(mask.sum())
    n, k = dist.shape
    width, ng = cfg.width, cfg.num_gaussians
    # Every input read once (dist, mask, idx, x, g, weights, centers), every
    # output written once (d_dist, d_x).
    nbytes = n * k * (4 + 1 + 4) + 2 * 4 * n * width \
        + 4 * (ng * width + width + width * width + width + ng) \
        + 4 * n * k + 4 * n * width
    prod, elem = (pairs * o for o in cfconv_pair_ops(width, ng, False))
    ops, rate = 3 * prod, peak('bf16_tensor_flops')
    if elem / peak('fp32_flops') > ops / rate:
        raise AssertionError('cfconv forces: the elementwise work bounds it')
    e = entry('cfconv_bwd_forces', 'cfconv_bwd', err, kernel,
              lambda: cuda_cfconv.cfconv_bwd_plain(
                  params, dist, mask, idx, x, g, cfg, chunk,
                  weight_grads=False),
              nbytes, ops, rate, calls=2)
    deterministic('cfconv_bwd_forces', kernel()[1:], kernel()[1:])
    print(f"cfconv_bwd_forces: rows {n} lanes {k}, valid pairs {pairs}: "
          f"kernel {e['ms']:.4f} ms (CUDA graph; eager {e['event_ms']:.4f} "
          f"ms), plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
          f"(tensor cores: 3 bf16 passes of {ops} operations at "
          f"{rate:.3g}/s; {elem} elementwise operations, {nbytes} bytes), "
          f"{100 * e['bound_ms'] / e['ms']:.1f} % of it; max|err| "
          f"{err:.3g}; d_dist and d_x bitwise the full kernel's; two "
          f"launches bitwise equal")
    return e


def culled_tests(pos, ctr, runs, rc):
    """The (real center, lane) distance tests the z-pair kernel makes after
    its cuts: for every real row of ``ctr [B, c, 3]`` and run (first,
    lanes) of the lane positions ``pos [B, n, 3]``, the run's lanes up to
    its last occupied one where the box of its occupied lanes lies inside
    the cutoff (the box gap rounded as the kernel rounds it)."""
    real = ctr[:, :, 0] < cuda_window.EMPTY_ROW
    big = torch.tensor(3.0e38, device=pos.device)
    total = 0
    for first, n_lanes in runs:
        run = pos[:, first:first + n_lanes]
        occ = run[:, :, 0] < cuda_window.EMPTY_ROW
        idx = torch.arange(1, n_lanes + 1, device=pos.device)
        cut = torch.where(occ, idx, 0).amax(1)
        lo = torch.where(occ[..., None], run, big).amin(1)
        hi = torch.where(occ[..., None], run, -big).amax(1)
        gap = torch.clamp(torch.maximum(lo[:, None] - ctr, ctr - hi[:, None]),
                          min=0.0)
        d2 = gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1] \
            + gap[..., 2] * gap[..., 2]
        live = (d2 < float(rc) ** 2) & real & (cut[:, None] > 0)
        total += int((live * cut[:, None]).sum())
    return total


def chunk_tests(jx, ctr, bounds):
    """The (real center, lane) distance tests the cluster kernel makes: per
    i-cluster, every real row against every lane of each 32-lane chunk of a
    species block that holds an occupied lane."""
    real = (ctr[:, :, 0] < cuda_window.EMPTY_ROW).sum(1)
    total = 0
    for lo, hi in bounds:
        for b in range(lo, hi, 32):
            occ = (jx[:, b:min(b + 32, hi)] < cuda_window.EMPTY_ROW).any(1)
            total += int((occ * real).sum()) * (min(b + 32, hi) - b)
    return total


def radial_bounds(tested, test_ops, inside, fwd_ops, bwd_ops):
    """sfu_bound of a pair kernel's two directions."""
    return {name: sfu_bound(tested, test_ops, inside, ops, PAIR_SFU[name])
            for name, ops in (('fwd', fwd_ops), ('bwd', bwd_ops))}


def pair_entries(args, label):
    """(fwd, bwd) entries of the z-pair kernel on one recorded call of
    ``pair_radial(ctr, z3, shift, rc, eta, rs, ncells3, cell_caps,
    torchani)``; the backward takes the cotangents of sum(out_a^2) +
    sum(out_b^2). The bound is the larger of the bytes, the FP32 and the
    SFU operations (the FP32-only bound printed beside)."""
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
    first, length, _ = cuda_zpair.pair_runs(geo)
    culled = culled_tests(
        lanes.permute(0, 1, 3, 2).reshape(geo.ncells, 5 * geo.ll, 3), ctr,
        [(d * geo.ll + int(f), int(n)) for d in range(5)
         for f, n in zip(first, length)], rc)
    io = 4 * (ctr.numel() + z3.numel() + shift.numel())
    bounds = radial_bounds(tested, PAIR_TEST_OPS, inside, PAIR_FWD_OPS,
                           PAIR_BWD_OPS)
    fwd = entry('pair_radial_fwd', 'pair_radial',
                max(max_abs(a, b) for a, b in zip(out_k, out_p)),
                lambda: cuda_zpair.pair_radial_fwd_cuda(ctr, z3, shift, spec),
                lambda: cuda_zpair.pair_radial_plain(ctr, z3, shift, *rest),
                io + 4 * sum(o.numel() for o in out_k), *bounds['fwd'][:2])
    bwd = entry('pair_radial_bwd', 'pair_radial',
                max(max_abs(a, b) for a, b in zip(grads_k, grads_p)),
                lambda: cuda_zpair.pair_radial_bwd_cuda(ctr, z3, shift, *g,
                                                        spec),
                lambda: torch.autograd.grad(out_p, ins, g, retain_graph=True),
                2 * io + 4 * sum(t.numel() for t in g), *bounds['bwd'][:2])
    print(f'{label} pair radial cells {geo.ncells} center rows {geo.c} lanes '
          f'5 x {geo.ll} (pairs tested {tested}, after the cuts and box '
          f'tests {culled}, inside {inside}): '
          + times_text(fwd, bwd, bounds) + f'; max|err| '
          f'{fwd["max_abs_err"]:.3g} / {bwd["max_abs_err"]:.3g}; two launches '
          'bitwise equal')
    return fwd, bwd


def cluster_entries(args, label):
    """(fwd, bwd) entries of the cluster-pair kernel on one recorded call of
    ``cluster_radial(jx, jy, jz, centers, rc, eta, rs, cl, lane_caps,
    self_block, torchani)`` (one i-species); the backward takes the
    cotangent of sum(out^2). The bound is the larger of the bytes, the FP32
    and the SFU operations (the FP32-only bound printed beside)."""
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
    culled = chunk_tests(jx, ctr, geo.bounds)
    io = 4 * (3 * jx.numel() + ctr.numel())
    bounds = radial_bounds(tested, CLUSTER_TEST_OPS, inside, CLUSTER_FWD_OPS,
                           CLUSTER_BWD_OPS)
    fwd = entry('cluster_radial_fwd', 'cluster_radial', max_abs(out_k, out_p),
                lambda: cuda_cluster.cluster_radial_fwd_cuda(*planes, spec),
                lambda: cuda_cluster.cluster_radial_plain(*planes, *rest),
                io + 4 * out_k.numel(), *bounds['fwd'][:2])
    bwd = entry('cluster_radial_bwd', 'cluster_radial',
                max(max_abs(a, b) for a, b in zip(grads_k, grads_p)),
                lambda: cuda_cluster.cluster_radial_bwd_cuda(*planes, g,
                                                             spec),
                lambda: torch.autograd.grad(out_p, ins, g, retain_graph=True),
                2 * io + 4 * g.numel(), *bounds['bwd'][:2])
    print(f'{label} cluster radial i-species block {int(self_block)}: '
          f'{jx.shape[0]} clusters x {geo.lanes} lanes (pairs tested '
          f'{tested}, after the empty-chunk cut {culled}, inside '
          f'{inside}): ' + times_text(fwd, bwd, bounds) + '; two launches '
          'bitwise equal')
    return fwd, bwd


def mask_entries(mask_args, pack_args):
    """Entries of the mask kernel and the lane left-pack on one recorded
    'mask' selection; both must equal their plain versions exactly, and
    two launches each other."""
    cx, cy, cz, centers = (t.contiguous() for t in mask_args[:4])
    w2, caps = mask_args[4:6]
    m_k = cuda_select.window_mask_cuda(cx, cy, cz, centers, w2, caps)
    m_p = cuda_select.window_mask_plain(cx, cy, cz, centers, w2, caps)
    if not torch.equal(m_k, m_p):
        raise AssertionError(f'window_mask: kernel and plain differ in '
                             f'{int((m_k != m_p).sum())} of {m_k.numel()}')
    deterministic('window_mask', [m_k], [cuda_select.window_mask_cuda(
        cx, cy, cz, centers, w2, caps)])
    m_atom, widths, a_caps = pack_args
    m_atom = m_atom.contiguous()
    lanes, counts = cuda_select.left_pack_lanes_cuda(m_atom, widths, a_caps)
    p_lanes, p_counts = cuda_select.left_pack_lanes_plain(m_atom, widths,
                                                          a_caps)
    if not (torch.equal(lanes, p_lanes) and torch.equal(counts, p_counts)):
        raise AssertionError('left_pack_lanes: kernel and plain differ')
    deterministic('left_pack_lanes', (lanes, counts),
                  cuda_select.left_pack_lanes_cuda(m_atom, widths, a_caps))
    ncells, c, kk = m_k.shape
    f32 = peak('fp32_flops')
    mask = entry('window_mask', 'window_mask', 0.0,
                 lambda: cuda_select.window_mask_cuda(cx, cy, cz, centers,
                                                      w2, caps),
                 lambda: cuda_select.window_mask_plain(cx, cy, cz, centers,
                                                       w2, caps),
                 4 * (3 * cx.numel() + centers.numel()) + m_k.numel(),
                 MASK_OPS * m_k.numel(), f32)
    pack = entry('left_pack_lanes', 'window_mask', 0.0,
                 lambda: cuda_select.left_pack_lanes_cuda(m_atom, widths,
                                                          a_caps),
                 lambda: cuda_select.left_pack_lanes_plain(m_atom, widths,
                                                           a_caps),
                 m_atom.numel() + 4 * (lanes.numel() + counts.numel()),
                 LANE_PACK_OPS * m_atom.numel(), f32)
    # Empty slot rows sit at FAR and hold ones against the FAR lanes.
    occupied = centers[:, :, 0] < cuda_window.FAR
    print(f'window_mask cells {ncells} rows {c} lanes {kk} (valid '
          f'{int(m_k.sum())}, of them {int(m_k[occupied].sum())} in the '
          f'{int(occupied.sum())} occupied rows of {ncells * c}): '
          f'{mask["ms"]:.4f} ms (eager '
          f'{mask["event_ms"]:.4f}, plain {mask["plain_ms"]:.4f}, bound '
          f'{mask["bound_ms"]:.5f} {mask["bound_by"]}); left_pack_lanes '
          f'rows {m_atom.shape[0]} widths {tuple(widths)} caps '
          f'{tuple(a_caps)}: {pack["ms"]:.4f} ms (eager '
          f'{pack["event_ms"]:.4f}, plain {pack["plain_ms"]:.4f}, bound '
          f'{pack["bound_ms"]:.5f} {pack["bound_by"]}); two launches '
          'bitwise equal')
    return mask, pack


# ---------------------------------------------------------------------------
# The CFConv workload: the JAX package's bench_cfconv_periodic chain.
# ---------------------------------------------------------------------------

class PeriodicStack(NamedTuple):
    """The periodic CFConv workload of the JAX package's
    ``benchmarks/bench_components.py`` ``bench_cfconv_periodic``: a 6-layer
    stack (width 128, 50 Gaussians, 10 A cutoff, ssp) on uniform random
    positions at density 0.1 A^-3, with a cell list of capacity 640 (the
    density estimate plus 30 %, rounded up to 128) and 2048-row chunks."""
    stack: CFConvStack
    params: Tuple[CFConvParams, ...]
    cell_list: CellList
    positions: torch.Tensor
    box: torch.Tensor
    inputs: torch.Tensor
    chunk_size: Optional[int]


def periodic_stack(num_atoms: int, device=None) -> PeriodicStack:
    """Build :class:`PeriodicStack` at ``num_atoms``: positions and inputs
    from ``np.random.RandomState(0)`` in the JAX benchmark's order,
    weights from a ``torch.Generator`` seeded with 0, on ``device`` (the
    card unless the caller says otherwise)."""
    dev = resolve_device(device)
    cfg = CFConvConfig(width=128, num_gaussians=50, cutoff=10.0,
                       gaussian_width=10.0 / 49)
    stack = CFConvStack(cfg, num_layers=6)
    gen = torch.Generator(device=dev if dev.type == 'cuda' else 'cpu')
    params = stack.init(gen.manual_seed(0), device=dev)
    rng = np.random.RandomState(0)
    side = (num_atoms / 0.1) ** (1 / 3)
    box = np.diag([side] * 3).astype(np.float32)
    pos = rng.rand(num_atoms, 3).astype(np.float32) * side
    x = rng.randn(num_atoms, cfg.width).astype(np.float32)
    capacity = int(4 / 3 * np.pi * cfg.cutoff ** 3 * 0.1 * 1.3)
    capacity = -(-capacity // 128) * 128
    return PeriodicStack(
        stack, params, CellList.create(box, cfg.cutoff, capacity=capacity),
        torch.tensor(pos, device=dev), torch.tensor(box, device=dev),
        torch.tensor(x, device=dev), conv_chunk(num_atoms))


def periodic_stack_grads(w: PeriodicStack, weight_grads: bool = True):
    """One iteration of the workload: ``select(build_mirror=True)``, the
    scatter-free distance payload, the stack, and the gradient of the sum
    of its output. Returns ``(value, d_positions, d_inputs, weight
    gradients per layer, selection)``; without ``weight_grads`` the weights
    need no gradient (the MD case) and their gradients are None."""
    with torch.enable_grad():
        pos = w.positions.detach().requires_grad_(True)
        x = w.inputs.detach().requires_grad_(True)
        params = [CFConvParams(*(a.detach().requires_grad_(weight_grads)
                                 for a in p)) for p in w.params]
        sel = w.cell_list.select(pos, w.box, build_mirror=True)
        d, idx, m = w.cell_list.payload_distances_from_selection(pos, w.box,
                                                                 sel)
        value = w.stack.apply_distances(params, d, idx, m, x,
                                        w.chunk_size).sum()
        flat = [a for p in params for a in p] if weight_grads else []
        grads = torch.autograd.grad(value, [pos, x] + flat)
    dw = tuple(CFConvParams(*grads[2 + 4 * i:6 + 4 * i])
               for i in range(len(params))) if weight_grads else None
    return value.detach(), grads[0], grads[1], dw, sel


# ---------------------------------------------------------------------------
# The rows: each kernel's inputs recorded from the path that launches it.
# ---------------------------------------------------------------------------

def window_rows(basis, params):
    """B.1-B.4 and B.9 on water-2.6k: one selection, one step and one
    energy without gradients of the window path (B.9: of the pair path)."""
    model, cell_list, pos, box = build(MOLECULES, basis)
    layout = model.blocked_layout
    print(f'water-2.6k window: atoms {model.num_atoms}, grid '
          f'{layout.cell_grid} cell_caps {layout.cell_caps}, angular grid '
          f'{layout.ang_cell_grid} caps {layout.ang_cell_caps}, ang_caps '
          f'{layout.ang_caps}, tiers {layout.ang_tier_caps} rows '
          f'{layout.ang_tier_rows}')

    def window_pass():
        sel = select_and_step(model, params, pos, box, cell_list)
        with torch.no_grad():
            model.energy_from_selection(params, pos, box, cell_list, sel)

    (packs, radials, angulars, feats), launches = record(
        window_pass, (window_mod, 'left_pack'), (window_mod, 'window_radial'),
        (cuda_aev, 'angular_aev'),
        (ani_mod, 'ensemble_energy_grouped_rows_fused'))
    # The step calls each once (the angular kernel once a tier), then the
    # energy without gradients again.
    ntiers = 1 + len(layout.ang_tier_caps or ())
    if not (len(packs) == 1 and len(radials) == 2
            and len(angulars) == 2 * ntiers and len(feats) == 2):
        raise AssertionError('unexpected kernel calls: '
                             f'{len(packs)} {len(radials)} {len(angulars)} '
                             f'{len(feats)}')
    (args, _), = packs
    kernels = {'left_pack': left_pack_entry(*args)}
    kernels['window_radial_fwd'], kernels['window_radial_bwd'] = \
        radial_entries(*radials[0])
    ang = [angular_entries(a[0].detach().contiguous(), a[1].contiguous(),
                           *a[2:5]) for a, _ in angulars[:ntiers]]
    kernels['angular_aev_fwd'] = merge([f for f, _ in ang])
    kernels['angular_aev_bwd'] = merge([b for _, b in ang])
    args, _ = feats[0]
    kernels.update(nn_entries(args[0], args[1].detach(), args[2]))
    del packs, radials, angulars, feats, args, ang
    counted = {k: launches[k] for k in kernels}

    pair = dataclasses.replace(model, window_radial='pair')
    (calls,), launches = record(
        lambda: select_and_step(pair, params, pos, box, cell_list),
        (cuda_zpair, 'pair_radial'))
    if len(calls) != 1:
        raise AssertionError(f'pair step: {len(calls)} kernel calls')
    for k, e in zip(('pair_radial_fwd', 'pair_radial_bwd'),
                    pair_entries(calls[0][0], 'pair 2.6k')):
        kernels[k], counted[k] = e, launches[k]
    return kernels, counted


def pme_row(basis, params, molecules, label, calls):
    """B.5's (fwd, bwd) entries on the inputs of one force step of config
    5 at ``molecules`` waters, and the launches of that step."""
    c5 = combined_mod.config5(make_water_box(molecules, seed=SEED), basis,
                              device=DEV)
    print(f'{label}: PME grid {c5.model.pme.config.grid_shape}, window plan '
          f'{c5.model.pme_window_plan}')

    def force_step():
        sel = c5.model.select(c5.positions, c5.box, c5.cell_list)
        c5.model.energy_and_forces_from_selection(
            params, c5.positions, c5.charges, c5.box, c5.cell_list, sel)

    (recorded,), launches = record(force_step, (cuda_pme, 'pme_window'))
    if len(recorded) != 1:
        raise AssertionError(f'pme_window called {len(recorded)} times a '
                             'step')
    return pme_entries(recorded[0][0], label, calls=calls) + (launches,)


def config5_rows(basis):
    """B.5 on the inputs of one force step of config 5 at 2,601 atoms (the
    row) and at 26,010 atoms (printed)."""
    params = init_ani_params(torch.Generator(device=DEV).manual_seed(SEED),
                             basis, num_models=8,
                             self_energies=combined_mod.C5_SELF_ENERGIES,
                             device=DEV)
    fwd, bwd, launches = pme_row(basis, params, MOLECULES, 'config5-2.6k', 20)
    pme_row(basis, params, LARGE_MOLECULES, 'config5-26k', 10)
    kernels = {'pme_window_fwd': fwd, 'pme_window_bwd': bwd}
    return kernels, {k: launches[k] for k in kernels}


def cfconv_rows():
    """B.6 and the fused CFConv forward on the layers of one iteration of
    the 26,010-atom chain; B.6's forces-only kernel on one iteration whose
    weights need no gradient."""
    w = periodic_stack(LARGE_MOLECULES * 3, device=DEV)
    cfg = w.stack.config
    cl = w.cell_list
    print(f'cfconv-26k: atoms {w.positions.shape[0]}, box '
          f'{float(w.box[0, 0]):.2f} A, width {cfg.width}, {cfg.num_gaussians}'
          f' Gaussians, cutoff {cfg.cutoff}, {w.stack.num_layers} layers, '
          f'cells {cl.ncells} x {cl.cell_capacity}, capacity {cl.capacity}, '
          f'chunk {w.chunk_size}')
    if cl.ncells != (6, 6, 6) or cl.capacity != 640:
        raise AssertionError('cfconv 26k: expected a 6x6x6 grid, K = 640')
    (bwd_calls, fwd_calls), launches = record(
        lambda: periodic_stack_grads(w), (cuda_cfconv, 'cfconv_bwd'),
        (cuda_cfconv, 'cfconv_fwd'))
    layers = w.stack.num_layers
    if len(bwd_calls) != layers or len(fwd_calls) != layers:
        raise AssertionError(f'cfconv_bwd called {len(bwd_calls)} times, '
                             f'cfconv_fwd {len(fwd_calls)} times')
    kernels = {'cfconv_fwd': cfconv_fwd_entry(fwd_calls, cfg, w.chunk_size)}
    del fwd_calls
    # B.6 on the last layer's backward inputs (the first call).
    first = bwd_calls[0]
    del bwd_calls
    kernels['cfconv_bwd'] = cfconv_bwd_entry(first, cfg, w.chunk_size)
    counted = {k: launches[k] for k in kernels}
    (bwd_calls,), launches = record(
        lambda: periodic_stack_grads(w, weight_grads=False),
        (cuda_cfconv, 'cfconv_bwd'))
    if (len(bwd_calls), launches['cfconv_bwd']) != (layers, 0):
        raise AssertionError(f'forces iteration: cfconv_bwd called '
                             f'{len(bwd_calls)} times, the full kernel '
                             f'launched {launches["cfconv_bwd"]} times')
    first = bwd_calls[0]
    del bwd_calls
    kernels['cfconv_bwd_forces'] = cfconv_bwd_forces_entry(first, cfg,
                                                           w.chunk_size)
    counted['cfconv_bwd_forces'] = launches['cfconv_bwd_forces']
    return kernels, counted


def painn_bwd_entry(call, chunk):
    """PaiNN's fused backward on one recorded call of ``painn_bwd_cuda``:
    against the plain chunked backward (normwise 1e-5 on dd, du, dphi and
    dv, both true f32), two launches bitwise equal, timed. Bound: the FP32
    FLOP of ``painn_bwd_roofline`` (46 F + 4 R + 6 R F a pair inside rc,
    the filter computed again left out), or the bytes (every input read
    once, every output written once)."""
    args = tuple(a.detach() if isinstance(a, torch.Tensor) else a
                 for a in call[0])
    phi_pad, v_pad, d, u, idx, live, wf, bf, gs, gv, rc = args
    kernel = lambda: painn_ops.painn_bwd_cuda(*args)  # noqa: E731
    plain = lambda: painn_ops.painn_bwd_plain(*args, chunk)  # noqa: E731
    got, want = kernel(), plain()
    for name, a, b in zip(('dd', 'du', 'dphi', 'dv'), got, want):
        check_normwise(f'painn-26k bwd {name}', a, b, 1e-5)
    if bool(got[0][~live].any()) or bool(got[1][~live].any()):
        raise AssertionError('painn-26k: nonzero dd or du off the live lanes')
    err = max(max_abs(a, b) for a, b in zip(got, want))
    del got, want
    pairs = int(live.sum())
    n, k = d.shape
    f, r = gs.shape[1], wf.shape[0]
    nbytes = (4 * 2 * (n + 1) * 3 * f + n * k * (4 + 12 + 8 + 1)
              + 4 * (r + 1) * 3 * f + 4 * n * 4 * f
              + 4 * n * k * 4 + 4 * n * 6 * f)
    ops = pairs * (PAIR_BWD_PER_F * f + PAIR_BWD_PER_R * r + 6 * r * f)
    f32 = peak('fp32_flops')
    e = entry('painn_bwd', 'painn_bwd', err, kernel, plain, nbytes, ops, f32,
              calls=5)
    deterministic('painn_bwd', kernel(), kernel())
    print(f"painn_bwd: rows {n} lanes {k}, pairs inside rc {pairs}: kernel "
          f"{e['ms']:.4f} ms (CUDA graph; eager {e['event_ms']:.4f} ms), "
          f"plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
          f"({e['bound_by']}: {ops} FP32 operations at {f32:.3g}/s, "
          f"{nbytes} bytes), {100 * e['bound_ms'] / e['ms']:.1f} % of it; "
          f"max|err| {err:.3g}; two launches bitwise equal")
    return e


def painn_rows():
    """PaiNN's fused backward on the first backward of one force call at
    26,010 atoms (the last block's message, v nonzero)."""
    water = make_water_box(LARGE_MOLECULES, seed=SEED)
    model = PaiNNModel.from_atomic_numbers(water.atomic_numbers,
                                           PaiNNConfig(), elements=(1, 8))
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED),
                        device=DEV)
    cl = model.create_cell_list(water.box, skin=SKIN)
    pos = torch.tensor(water.positions, device=DEV)
    box = torch.tensor(water.box, device=DEV)
    sel = model.select(pos, box, cl)
    print(f'painn-26k: atoms {pos.shape[0]}, width {model.config.width}, '
          f'{model.config.num_radial} radial functions, cutoff '
          f'{model.config.cutoff}, {model.num_interactions} blocks, capacity '
          f'{cl.capacity}')
    (calls,), launches = record(
        lambda: model.energy_and_forces_from_selection(params, pos, box, cl,
                                                       sel),
        (painn_ops, 'painn_bwd_cuda'))
    if len(calls) != model.num_interactions:
        raise AssertionError(f'painn_bwd_cuda called {len(calls)} times')
    chunk = painn_ops.chunk_rows(cl.capacity, model.config.width)
    kernels = {'painn_bwd': painn_bwd_entry(calls[0], chunk)}
    return kernels, {'painn_bwd': launches['painn_bwd']}


def large_rows(basis, params):
    """At water-26k: B.7 on the 'mask' selection, B.8 per i-species on one
    selection and step of the cluster path (the rows), and the left-pack
    and B.9 again at this size (printed)."""
    model, cell_list, pos, box = build(LARGE_MOLECULES, basis)
    layout = model.blocked_layout
    print(f'water-26k window: atoms {model.num_atoms}, grid '
          f'{layout.cell_grid} cell_caps {layout.cell_caps}, bucketing '
          f'{layout.small_caps} / {layout.num_big_cells}, tiers '
          f'{layout.ang_tier_caps}')
    g = model.grouping
    kw = dict(species=model.species_array, layout=layout,
              radial_cutoff=basis.radial_cutoff,
              angular_cutoff=basis.angular_cutoff,
              grouping_order=g.order,
              present_counts=tuple(g.counts[s] for s in layout.present),
              need_shift_planes=True)
    (packs,), _ = record(
        lambda: window_mod.select_window(cell_list, pos, box,
                                         compact_impl='kernel', **kw),
        (window_mod, 'left_pack'))
    (args, _), = packs
    left_pack_entry(*args, label='left_pack 26k')
    del packs, args
    (masks, packs), launches = record(
        lambda: window_mod.select_window(cell_list, pos, box,
                                         compact_impl='mask', **kw),
        (window_mod, 'window_mask'), (window_mod, 'left_pack_lanes'))
    kernels = dict(zip(('window_mask', 'left_pack_lanes'),
                       mask_entries(masks[0][0], packs[0][0])))
    counted = {k: launches[k] for k in kernels}
    del masks, packs

    pair = dataclasses.replace(model, window_radial='pair')
    (calls,), _ = record(
        lambda: select_and_step(pair, params, pos, box, cell_list),
        (cuda_zpair, 'pair_radial'))
    pair_entries(calls[0][0], 'pair 26k')
    del pair, calls

    cluster = build(LARGE_MOLECULES, basis, radial_impl='cluster')[0]
    plan = cluster.blocked_layout.cluster_plan
    if cluster.window_radial != 'cluster' or plan is None:
        raise AssertionError('26k: the cluster planner refused the box')
    print(f'cluster-26k plan: ncl {plan.ncl}, jcaps {plan.jcaps}, cand_caps '
          f'{plan.cand_caps}, kmir {plan.kmir}, col_grid {plan.col_grid}')
    (calls,), launches = record(
        lambda: select_and_step(cluster, params, pos, box, cell_list),
        (clusters_mod, 'cluster_radial'))
    if len(calls) != len(plan.present):
        raise AssertionError(f'cluster_radial called {len(calls)} times')
    ents = [cluster_entries(args, 'cluster-26k') for args, _ in calls]
    for i, name in enumerate(('cluster_radial_fwd', 'cluster_radial_bwd')):
        kernels[name] = merge([e[i] for e in ents])
        counted[name] = launches[name]
    return kernels, counted


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false',
              file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(card[0])
    torch.cuda.set_device(DEV)

    t_start = t0 = time.perf_counter()
    _kernels.library()
    print(f'kernel build/load: {time.perf_counter() - t0:.1f} s '
          f'({_kernels.library_path().name})')

    basis = ANIBasis.ani2x()
    params = init_ani_params(torch.Generator(device=DEV).manual_seed(SEED),
                             basis, num_models=8, device=DEV)
    kernels, launches = {}, {}
    for make in (lambda: window_rows(basis, params),
                 lambda: config5_rows(basis), cfconv_rows, painn_rows,
                 lambda: large_rows(basis, params)):
        got, counted = make()
        kernels.update(got)
        launches.update(counted)
    if set(kernels) != set(_kernels.LAUNCHES):
        raise AssertionError(f'rows {sorted(kernels)} differ from the '
                             f'kernels {sorted(_kernels.LAUNCHES)}')
    for name, k in kernels.items():
        k['launches'] = launches[name]

    print(f'chip_smoke wall time: {time.perf_counter() - t_start:.1f} s '
          '(the kernels\' build included)')
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
    rows = [{key: kernels[name][key] for key in keys}
            for name in _kernels.LAUNCHES]
    for k in rows:
        print(f"{k['name']}: kernel {k['ms']:.5f} ms (CUDA graph), plain "
              f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.5f} ms "
              f"({k['bound_by']}), library {k['library_ms']}, launches "
              f"{k['launches']}, max|err| {k['max_abs_err']:.3g}")
    print(json.dumps({'kernels': rows}))
    print(card[0])
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
