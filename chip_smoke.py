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
   forward and backward per row tier, the fused ensemble's stage kernels:
   layer1, hidden and dx, one launch of each for every species) against
   its plain version at the shapes the path gives it, recorded from one
   selection and one step, plus the window radial kernel with forced
   cell-occupancy bucketing; each kernel timed on the device (20 calls
   captured in a CUDA graph, replayed between CUDA events) beside its plain
   version (CUDA events around 20 eager calls), its bound and, for the
   ensemble's two GEMM stages, cuBLAS bf16 products at their shapes (the
   yardstick; the port never calls them); the angular and window radial
   kernels' bounds the larger of their bytes, FP32 and SFU operations (the
   FP32-only bound printed beside) and two launches of each direction
   bitwise equal; the ensemble's fwd and fwdgrad also whole, graph and
   eager, against the per-species oracle, and two launches bitwise equal;
5. the window main path: 2 selection blocks x 8 force steps as in 3, the
   final frame's energy without gradients, the launch counts (every step
   launches the window radial forward and backward, the angular kernel
   once per tier and each fwdgrad stage of the ensemble exactly once,
   every selection the left-pack, the final energy each fwd stage once),
   and one step against the same step through the plain versions;
6. one selection and 4 steps of the window path at 26,010 atoms, where the
   planner turns on bucketing and four angular tiers: the ensemble's
   stage kernels and the window radial kernel's two bucketed calls checked
   and timed as in 4 at their shapes, finite output, no overflow, ms/step;
7. BASELINE config 5, ANI + PME Langevin MD (``models.combined.ANIWithPME``
   with ``md.integrators``), on the JAX example's settings
   (``examples/run_configs.py`` ``config5``: window ANI-2x, bf16 fused
   ensemble, skin 0.25, margin 1.2, refresh 5, self energies
   ``linspace(-40, -1, 7)``; PME grid the next power of two of the box
   edge (at least 16), order 5, alpha 0.6, coulomb 1389.35457, exclusions
   ``full((n, 1), -1)``, cutoff 5.0, bucketed window plan; charges x 0.2,
   masses O 16 and H 1; BAOAB with dt 2e-4, friction 5, kT 0.596):
   (a) at 2,601 atoms the PME window kernel's forward and backward against
   their plain version on the inputs of one force step, timed (the bound
   as the window radial kernel's), two launches of each bitwise equal,
   plus one call with a forced bucketed plan and the intramolecular
   exclusions;
   (b) the config-5 MD at 2,601 atoms: one warm-up block, then 8 blocks of
   5 steps between CUDA events (ms/step, selection and PME included), the
   count maxima against their capacities, ``check_overflow``, the launch
   counts, and one step against the same step through the plain versions;
   (c) config 5 at 26,010 atoms (bucketed PME plan, four angular tiers):
   one warm-up block, then 2 blocks of 5 steps: finite, no overflow,
   ms/step; then the PME window kernel checked and timed as in (a) on the
   inputs of one force step;
8. SchNet/CFConv, the JAX package's ``bench_cfconv_periodic`` chain at
   full width (``models.schnet.periodic_stack``: 26,010 atoms at density
   0.1, width 128, 50 Gaussians, 10 A cutoff, 6 layers, a 6x6x6 cell grid,
   640 neighbor lanes, 2048-row chunks): (a) the fused CFConv forward
   kernel against its plain version (normwise 1e-6) on the inputs of
   layers 1 and 6, timed on layer 1's, its bound the filter products'
   FFMAs at the f32 rate, two launches bitwise equal; the CFConv backward
   kernel against its plain version on the inputs of one layer's backward,
   timed, its bound that of its three bf16 tensor-core passes (the old f32
   bound printed beside), two launches bitwise equal, plus one small call
   with the tanh activation; (b) 1 warm-up and 2 timed
   iterations (select with mirror, distance payload, 6 layers, gradients
   of the sum with respect to positions, inputs and weights; ms/iteration,
   no overflow, 6 launches of each kernel an iteration), then one
   iteration against the same iteration through the plain forward and
   backward, which launches neither kernel; (c) the pair
   path, which has no kernel: config 2 (``SchNetModel``, 21 atoms, 3
   interactions) and the O(N^2) harness (the stack over
   ``build_cfconv_neighbors`` at 1,000 atoms);
9. the window path's opt-in switches (the z-pair and cluster-pair radial
   kernels, the 'mask' compaction): (a) each of their kernels against its
   plain version at the shapes its path gives it, timed: the z-pair
   forward and backward at 2,601 and 26,010 atoms, the cluster-pair
   forward and backward per i-species at 26,010, the mask and lane
   left-pack on the 26,010-atom angular grid, and the left-pack of a
   26,010-atom 'kernel' selection (bitwise, two launches equal); (b)
   ``window_radial='pair'`` at 2,601 atoms, 2 selection blocks x 8 steps
   as in 5 (launch counts read just after), and on a frozen 26,010-atom
   selection, each step against its plain step and against the 'window'
   step; (c)
   ``with_blocked_layout(radial_impl='cluster')`` at 26,010 atoms (the
   planner's time printed): one selection and 4 frozen steps with the
   counts set to 0 just before, no overflow, one step against its plain
   step and the 'window' step; (d) ``select_window(compact_impl='mask')``
   at 26,010 atoms, twice with the counts set to 0 just before, equal to
   the 'kernel' selection field by field and timed beside it;
10. the dense and payload ANI paths (BASELINE configs 1 and 3), which
   launch no kernel (8 random models from the seed, self energies
   ``linspace(-40, -1, 7)``), each call held against the same call on the
   CPU (f32: energy relative 1e-6, max|dF| <= 1e-4 max|F|; bf16 ensemble:
   1e-4 and 5e-3): (a) ``energy_and_forces`` on methanol and the seven
   ligands of ``tests/data/ligands.npz``, f32 and bf16, and
   ``energy_and_forces_batch`` on 4 perturbed ``2iuz`` conformers, ms per
   call from CUDA events; (b) config 3 at 2,601 atoms (cell-list capacity
   96, ``angular_capacity=32``): ``energy_and_forces_fused``,
   ``check_overflow``, then 2 selection blocks x 8 nudged steps through
   ``md.run_md_sticky`` with ``max_angular_neighbors`` as its overflow
   count, ms/step; (c) the payload path at 26,010 atoms with
   ``aev_chunk_size=512``: one selection, 4 frozen steps, finite, no
   overflow, ms/step and peak memory; (d) every launch count stays 0;
11. the parallel layer over NCCL at world size 1 (one process, one card;
   no multi-rank run): (a) ``parallel.window_shard.window_sharded_energy``
   on water-2.6k (the window layout of 4, the selection of
   ``model.select``), forces by autograd, against the unsharded window
   call with the f32 'xla' ensemble on the same selection (energy
   relative 1e-6, max|dF| <= 1e-4 max|F|), one call's launches exactly
   B.2 forward and backward once and B.3 forward and backward once per
   tier, ms per call of both; (b) the DP x EP train step
   (``parallel.sharding``; ANI-2x, 8 models, the 4 perturbed ``2iuz``
   conformers of phase 10, force weight 0.1, SGD, 3 steps): finite
   falling losses, after one step the parameters within 1e-4 normwise
   (the update within 1e-3) of the same step on the CPU, ms per step; (c)
   ``atom_sharded_energy`` (1hvk), ``tp_ensemble_energy`` and the
   one-stage ``pipeline_ensemble_energy`` against their unsharded
   counterparts (``pipeline_ani_ensemble_energy`` needs as many ranks as
   network layers and runs in the CPU tests only); (d) the train state
   through ``md.checkpoint.save_checkpoint_distributed`` /
   ``load_checkpoint_distributed`` bit for bit; (e) the native host
   library (built by g++) loading a mol2 and a PDB this script writes,
   equal to the Python loaders, and the capacity planner's counts on
   water-2.6k equal to its numpy path;
12. prints the wall time, the kernels' JSON line, the card line again,
   then ``{"ok": true, "device": ...}`` as the last line.

Any failure raises (non-zero exit). Run from the repository root:

    python3 chip_smoke.py
"""
import dataclasses
import functools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    print('chip_smoke: torch.cuda.is_available() is false', file=sys.stderr)
    sys.exit(1)

from nnpops_tpu_torch import ANIBasis, _kernels, run_configs  # noqa: E402
from nnpops_tpu_torch import native  # noqa: E402
from nnpops_tpu_torch.dryrun import params_tree  # noqa: E402
from nnpops_tpu_torch.md import (MDState, initialize,  # noqa: E402
                                 langevin_baoab, load_checkpoint_distributed,
                                 run_md_sticky, run_md_sticky_counts,
                                 save_checkpoint_distributed)
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
from nnpops_tpu_torch.neighbors.cell_list import CellList  # noqa: E402
from nnpops_tpu_torch.ops import (cuda_aev, cuda_cfconv,  # noqa: E402
                                  cuda_cluster, cuda_nn, cuda_pme,
                                  cuda_select, cuda_window, cuda_zpair)
from nnpops_tpu_torch.ops.aev import max_angular_neighbors  # noqa: E402
from nnpops_tpu_torch.ops.batched_nn import ensemble_energy  # noqa: E402
from nnpops_tpu_torch.ops.cfconv import build_cfconv_neighbors  # noqa: E402
from nnpops_tpu_torch.ops.pme import PME  # noqa: E402
from nnpops_tpu_torch.ops.aev_blocked import (  # noqa: E402
    compute_aev_blocked, triple_tables)
from nnpops_tpu_torch.parallel import sharding as sharding_mod  # noqa: E402
from nnpops_tpu_torch.parallel.launch import process_group  # noqa: E402
from nnpops_tpu_torch.parallel.window_shard import (  # noqa: E402
    window_sharded_energy)
from nnpops_tpu_torch.params import ani_params_to, from_jax_params  # noqa: E402
from nnpops_tpu_torch.profile_step import _kernel_events, recording  # noqa: E402
from nnpops_tpu_torch.utils import io as utils_io  # noqa: E402
from nnpops_tpu_torch.utils import make_water_box  # noqa: E402
from nnpops_tpu_torch.utils.profiling import StepTimer, trace  # noqa: E402

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
# SFU (MUFU) operations/s: 16 a clock per SM, 132 SMs, at the 1.98 GHz that
# the f32 peak implies.
SFU_OPS_PER_S = 16 * 132 * 1.98e9
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
    'cfconv_fwd': 'none: the JAX package left the forward to XLA '
                  '(nnpops_tpu/ops/cfconv.py _fwd_rows)',
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
    'cfconv_fwd': 'nnpops_tpu_torch/csrc/cfconv_fwd.cu',
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


def sfu_bound(tested, test_ops, inside, ops, sfu):
    """(operations, rate, bound_by label, FP32-only bound ms) of the larger
    of a kernel's FP32 work (``test_ops`` per pair tested, ``ops`` per pair
    inside the cutoff or triple) and its SFU work (``sfu`` per pair inside
    or triple)."""
    f32 = (tested * test_ops + inside * ops, F32_OPS_PER_S, 'FP32')
    mufu = (inside * sfu, SFU_OPS_PER_S, 'SFU')
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


FUSED_GRAD = ('fused_nn_fwdgrad_layer1', 'fused_nn_fwdgrad_hidden',
              'fused_nn_fwdgrad_dx')
FUSED_FWD = ('fused_nn_fwd_layer1', 'fused_nn_fwd_hidden')


def fused_launches(steps, fwd_calls):
    """The ensemble's launches on a path: one launch set for every species
    a force step, and one forward set a call without gradients."""
    need = {k: steps for k in FUSED_GRAD}
    need.update({k: fwd_calls for k in FUSED_FWD})
    return need


def require_exact(label, launches, need):
    for name, n in need.items():
        if launches[name] != n:
            raise AssertionError(f'{label}: {name} launched {launches[name]}'
                                 f' times, expected {n}')


def nn_entries(ens, feat, counts, label, calls=20):
    """Entries of the fused ensemble's stage kernels on species-grouped AEV
    rows (one launch set for every species): each stage kernel against its
    plain version on the same inputs, the whole fwd and fwdgrad against
    the per-species oracle, two launches bitwise equal, and the times of
    the stages and of the whole function."""
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
            check_normwise(f'{label} {name}', a[r0:r1, :ksp].float(),
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
    check_normwise(f'{label} hidden e', e_h, e_p, 1e-3)
    err_h = max(max_abs(e_h, e_p), cols(g1, g1_p, 'hidden G1', 1e-2))
    e_hf = torch.empty(n, 1, device=DEV)
    cuda_nn.hidden_cuda(h1, None, pe, counts, None, epart, cnt, e_hf)
    check_normwise(f'{label} hidden fwd e', e_hf, e_p, 1e-3)
    g1.copy_(g1_p)
    dx = torch.empty(n, pe.in_actual, device=DEV)
    cuda_nn.dx_cuda(g1, pe, counts, dx)
    check_normwise(f'{label} dx', dx, dx_p, 1e-4)

    # The whole function against the per-species oracle, and repeatable.
    e_k, dx_k = cuda_nn.ensemble_cuda(x, pe, counts, True)
    e_kf, _ = cuda_nn.ensemble_cuda(x, pe, counts, False)
    e_o, dx_o = cuda_nn.ensemble_oracle(ens, x, counts, True)
    check_normwise(f'{label} fwdgrad e', e_k, e_o, 1e-3)
    check_normwise(f'{label} fwdgrad dx', dx_k, dx_o, 1e-2)
    check_normwise(f'{label} fwd e', e_kf, e_o, 1e-3)
    deterministic(f'{label} fused nn fwdgrad', (e_k, dx_k),
                  cuda_nn.ensemble_cuda(x, pe, counts, True))
    deterministic(f'{label} fused nn fwd', (e_kf,),
                  cuda_nn.ensemble_cuda(x, pe, counts, False)[:1])

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
    s1 = [(x16[r0:r1], pe.nets[s].w1) for s, r0, r1, _ in rows]
    s3 = [(g1[r0:r1, :ksp], pe.nets[s].w1) for s, r0, r1, ksp in rows]
    ents = {
        'fused_nn_fwd_layer1': entry(
            'fused_nn_fwd_layer1', 'fused_nn', err_l1f,
            lambda: cuda_nn.layer1_cuda(x16, pe, counts, h1f, None, cnt),
            lambda: cuda_nn.layer1_plain(x16, pe, counts, False),
            io + w1_bytes + 2 * k_rows, 2 * l1_macs, BF16_OPS_PER_S, calls),
        'fused_nn_fwd_hidden': entry(
            'fused_nn_fwd_hidden', 'fused_nn', max_abs(e_hf, e_p),
            lambda: cuda_nn.hidden_cuda(h1, None, pe, counts, None, epart,
                                        cnt, e_hf),
            lambda: cuda_nn.hidden_plain(h1_p, None, pe, counts, False),
            2 * k_rows + hid_w_bytes + 4 * n, 2 * hid_macs, BF16_OPS_PER_S,
            calls),
        'fused_nn_fwdgrad_layer1': entry(
            'fused_nn_fwdgrad_layer1', 'fused_nn', err_l1,
            lambda: cuda_nn.layer1_cuda(x16, pe, counts, h1, d1, cnt),
            lambda: cuda_nn.layer1_plain(x16, pe, counts, True),
            io + w1_bytes + 6 * k_rows, 2 * l1_macs, BF16_OPS_PER_S, calls),
        'fused_nn_fwdgrad_hidden': entry(
            'fused_nn_fwdgrad_hidden', 'fused_nn', err_h,
            lambda: cuda_nn.hidden_cuda(h1, d1, pe, counts, g1, epart, cnt,
                                        e_h),
            lambda: cuda_nn.hidden_plain(h1_p, d1_p, pe, counts, True),
            8 * k_rows + hid_w_bytes + 4 * n, 4 * hid_macs, BF16_OPS_PER_S,
            calls),
        'fused_nn_fwdgrad_dx': entry(
            'fused_nn_fwdgrad_dx', 'fused_nn', max_abs(dx, dx_p),
            lambda: cuda_nn.dx_cuda(g1, pe, counts, dx),
            lambda: cuda_nn.dx_plain(g1_p, pe, counts),
            2 * k_rows + w1_bytes + 4 * n * pe.in_actual, 2 * dx_macs,
            BF16_OPS_PER_S, calls),
    }
    # Yardstick: cuBLAS bf16 products at the stage-1 and stage-3 shapes
    # (timed here only; the port never calls them).
    lib1 = graph_ms(lambda: [torch.matmul(a, w.t()) for a, w in s1], calls)
    lib3 = graph_ms(lambda: [torch.matmul(a, w) for a, w in s3], calls)
    for name in ('fused_nn_fwd_layer1', 'fused_nn_fwdgrad_layer1'):
        ents[name]['library_ms'] = lib1
    ents['fused_nn_fwdgrad_dx']['library_ms'] = lib3
    # The whole function: its own bound (every layer's products, x read
    # and dx written once) against the sum of its stages.
    macs = sum((r1 - r0) * m * sum(w.shape[1] * w.shape[2]
                                   for w in ens.networks[s].weights)
               for s, r0, r1, _ in rows)
    w_bytes = sum(2 * m * sum(w.shape[1] * w.shape[2]
                              for w in ens.networks[s].weights)
                  + 4 * sum(b.numel() for b in ens.networks[s].biases)
                  for s, _, _, _ in rows)
    for grad in (False, True):
        fn = lambda: cuda_nn.ensemble_cuda(x, pe, counts, grad)  # noqa: E731
        t_ops = 2 * macs * (2 if grad else 1) / BF16_OPS_PER_S
        t_bytes = (x.numel() * 4 * (2 if grad else 1) + w_bytes
                   + 4 * n) / HBM_BYTES_PER_S
        stages = FUSED_GRAD if grad else FUSED_FWD
        print(f"{label} fused nn {'fwdgrad' if grad else 'fwd'} (rows "
              f"{counts}): {graph_ms(fn, calls):.5f} ms in a CUDA graph, "
              f"{cuda_ms(fn, calls):.5f} ms eager, stages "
              + ', '.join(f"{k[9:]} {ents[k]['ms']:.5f}" for k in stages)
              + f' ms; bound of the function {1e3 * max(t_ops, t_bytes):.5f}'
              f' ms; staged intermediates {ws.nbytes / 1e6:.1f} MB')
    print(f'{label} fused nn yardstick (cuBLAS bf16): layer-1 products '
          f'{lib1:.5f} ms, dx products {lib3:.5f} ms; max|de| '
          f'{max_abs(e_k, e_o):.3g} (max|e| {float(e_o.abs().max()):.3g}) '
          f'max|ddx| {max_abs(dx_k, dx_o):.3g} (max|dx| '
          f'{float(dx_o.abs().max()):.3g})')
    return ents


def left_pack_entry(keys, widths, caps, label='left_pack'):
    """The left-pack's entry on one recorded call: the kernel must equal
    its plain version exactly, and two launches each other."""
    packed, counts = cuda_select.left_pack_cuda(keys, widths, caps)
    p_packed, p_counts = cuda_select.left_pack_plain(keys, widths, caps)
    again = cuda_select.left_pack_cuda(keys, widths, caps)
    if not (torch.equal(packed, p_packed) and torch.equal(counts, p_counts)):
        raise AssertionError(f'{label}: kernel and plain version differ')
    if not (torch.equal(packed, again[0]) and torch.equal(counts, again[1])):
        raise AssertionError(f'{label}: two launches differ')
    e = entry('left_pack', 'left_pack', 0.0,
              lambda: cuda_select.left_pack_cuda(keys, widths, caps),
              lambda: cuda_select.left_pack_plain(keys, widths, caps),
              4 * (keys.numel() + packed.numel() + counts.numel()),
              3 * keys.numel(), F32_OPS_PER_S)
    print(f'{label} keys {tuple(keys.shape)} widths {tuple(widths)} caps '
          f'{tuple(caps)} (valid {int((keys >= 0).sum())}): {e["ms"]:.5f} ms '
          f'(eager {e["event_ms"]:.5f}, plain {e["plain_ms"]:.4f}), bound '
          f'{e["bound_ms"]:.5f} ms ({e["bound_by"]}); two launches bitwise '
          'equal')
    return e


def radial_entries(args, kwargs, label='window', calls=20):
    """(fwd, bwd) entries of the window radial kernel on one recorded call
    of ``window_radial(candx, candy, candz, centers, rc, eta, rs, cell_caps,
    torchani, center_caps=...)``; the bound the larger of the bytes, the FP32
    and the SFU operations (the FP32-only bound printed beside), and two
    launches of the backward bitwise equal."""
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
                io + 4 * out_k.numel(), *bounds['fwd'][:2], calls=calls)
    bwd = entry('window_radial_bwd', 'window_radial',
                max(max_abs(a, b) for a, b in zip(grads_k, grads_p)),
                lambda: cuda_window.window_radial_bwd_cuda(cx, cy, cz, ctr, g,
                                                           spec),
                lambda: torch.autograd.grad(out_p, ins, g, retain_graph=True),
                2 * io + 4 * g.numel(), *bounds['bwd'][:2], calls=calls)
    print(f'{label} window radial cells {cx.shape[0]} center rows '
          f'{ctr.shape[1]} lanes {geo.kk} (pairs tested {tested}, inside '
          f'{inside}): ' + times_text(fwd, bwd, bounds)
          + '; two launches bitwise equal')
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
    feat = torch.cat(compute_aev_blocked(payload, basis, layout,
                                         angular_impl='plain'),
                     1).detach()
    nn_entries(params.ensemble, feat, model.grouping.counts, 'pallas')
    launches, p, sel = drive('pallas', model, params, pos, box, cell_list)
    steps = BLOCKS * REFRESH
    require_launches('pallas', launches, {
        'angular_aev_fwd': steps, 'angular_aev_bwd': steps})
    require_exact('pallas', launches, fused_launches(steps, 1))
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
    kernels.update(nn_entries(args[0], args[1].detach(), args[2], 'window'))
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
    feats, radials = [], []
    with recording(ani_mod, 'ensemble_energy_grouped_rows_fused', feats), \
            recording(window_mod, 'window_radial', radials):
        model.energy_and_forces_from_selection(params, pos, box, cell_list,
                                               sel)
    torch.cuda.synchronize()
    (args, _), = feats
    nn_entries(args[0], args[1].detach(), args[2], 'window 26k', calls=10)
    del feats, args
    # The window radial kernel's two bucketed calls (big cells at full
    # rows, the rest at small_caps rows), checked and timed.
    if len(radials) != 2:
        raise AssertionError(f'26k: {len(radials)} window radial calls, '
                             'expected 2 (bucketing)')
    for args, kwargs in radials:
        radial_entries(args, kwargs, label='window 26k', calls=10)
    del radials
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

def pme_entries(args, label, calls=20):
    """(fwd, bwd) entries of the PME window kernel on one recorded call of
    ``pme_window(candx, candy, candz, candq, centers, excl, ncells3,
    cutoff, alpha, coulomb)``; the backward takes the main path's cotangent
    (ones: the energy is the sum of the rows). The bound the larger of the
    bytes, the FP32 and the SFU operations (the FP32-only bound printed
    beside); two launches of each direction bitwise equal."""
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
        'angular_aev_bwd': ntiers * steps, **fused_launches(steps, 0)})
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
    # The PME window kernel at 26k's shapes, checked and timed.
    calls = []
    big_sel = big.select(big.pos)
    with recording(cuda_pme, 'pme_window', calls):
        big.forces(big_sel, big.pos)
    if len(calls) != 1:
        raise AssertionError(f'pme_window called {len(calls)} times a step')
    pme_entries(calls[0][0], 'config 5 at 26k', calls=10)
    return fwd, bwd


# ---------------------------------------------------------------------------
# SchNet / CFConv: the periodic 6-layer stack and the pair path.
# ---------------------------------------------------------------------------

def cfconv_pair_ops(width, gaussians):
    """Operations per valid pair of the CFConv backward, counted from
    ``csrc/cfconv_bwd.cu`` (an FMA counts two): ``(products, elementwise)``,
    the four filter products and the two weight-gradient products, 3 W^2 +
    3 G W FMAs (the kernel runs each three times, in bf16 passes), and the
    Gaussians (11 G), the activation, its derivative and the d_y1 / d_x /
    d_fc terms (18 W) and the cutoff (6)."""
    return (2 * (3 * width * width + 3 * gaussians * width),
            11 * gaussians + 18 * width + 6)


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
    kernel = lambda: cuda_cfconv.cfconv_fwd_cuda(  # noqa: E731
        params, dist, mask, idx, x, cfg)
    e = entry('cfconv_fwd', 'cfconv_fwd', err, kernel,
              lambda: cuda_cfconv.conv_fwd_plain(params, dist, mask, idx, x,
                                                 cfg, chunk),
              nbytes, ops, F32_OPS_PER_S, calls=2)
    deterministic('cfconv_fwd', [kernel()], [kernel()])
    print(f"cfconv_fwd: rows {n} lanes {k}, valid pairs {pairs}: kernel "
          f"{e['ms']:.4f} ms (CUDA graph; eager {e['event_ms']:.4f} ms), "
          f"plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
          f"({e['bound_by']}: {ops} FFMA operations at "
          f"{F32_OPS_PER_S:.3g}/s, {nbytes} bytes), "
          f"{100 * e['bound_ms'] / e['ms']:.1f} % of it "
          f"({ops / e['ms'] / 1e9:.1f} TFLOP/s); library none; max|err| "
          f"{err:.3g}")
    return e


def cfconv_phase():
    """Phase 8: the SchNet/CFConv path. (a) the CFConv backward kernel (B.6)
    against its plain version on one layer's inputs of the 26,010-atom
    stack, timed, plus one small call with the tanh activation; (b) the
    stack (``models.schnet.periodic_stack``: select with mirror, distance
    payload, 6 layers, gradients of the sum with respect to positions,
    inputs and weights), 1 warm-up and 2 timed iterations, then one
    iteration against the same iteration through the plain forward and
    backward; (c) the pair path, which has no kernel: config 2 and the
    O(N^2) harness. Returns the two kernels' entries (the forward's first)
    with their launches from (b). The forward kernel is checked and timed
    in (a) on the inputs the warm-up recorded."""
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

    # (b, warm-up) One iteration, recording the kernels' calls.
    calls, fwd_calls = [], []
    with recording(cuda_cfconv, 'cfconv_bwd', calls), \
            recording(cuda_cfconv, 'cfconv_fwd', fwd_calls):
        schnet_mod.periodic_stack_grads(w)
    if len(calls) != w.stack.num_layers or \
            len(fwd_calls) != w.stack.num_layers:
        raise AssertionError(f'cfconv_bwd called {len(calls)} times, '
                             f'cfconv_fwd {len(fwd_calls)} times')
    fe = cfconv_fwd_entry(fwd_calls, cfg, w.chunk_size)
    del fwd_calls

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
    prod, elem = (pairs * o for o in cfconv_pair_ops(wd, ng))
    # The bound: the three bf16 passes of the products on the tensor cores,
    # or the elementwise work at the f32 rate if that takes longer (it
    # does not at these widths), or the bytes.
    tc_bound = 3 * prod / BF16_OPS_PER_S >= elem / F32_OPS_PER_S
    ops, rate = (3 * prod, BF16_OPS_PER_S) if tc_bound else (elem,
                                                             F32_OPS_PER_S)
    # Two calls a measurement: one takes tens of milliseconds.
    kernel = lambda: cuda_cfconv.cfconv_bwd_cuda(  # noqa: E731
        params, dist, mask, idx, x, g, cfg)
    e = entry('cfconv_bwd', 'cfconv_bwd', err, kernel,
              lambda: cuda_cfconv.cfconv_bwd_plain(params, dist, mask, idx, x,
                                                   g, cfg, w.chunk_size),
              nbytes, ops, rate, calls=2)
    first, again = kernel(), kernel()
    deterministic('cfconv_bwd', [*first[0], *first[1:]],
                  [*again[0], *again[1:]])
    del args, params, dist, mask, idx, x, g, first, again
    f32_bound = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                          (prod + elem) / F32_OPS_PER_S)
    print(f"cfconv_bwd: rows {n} lanes {k}, valid pairs {pairs}: kernel "
          f"{e['ms']:.4f} ms (CUDA graph; eager {e['event_ms']:.4f} ms), "
          f"plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
          f"({'tensor cores: 3 bf16 passes of' if tc_bound else 'f32'} "
          f"{ops} operations at {rate:.3g}/s; {elem} elementwise "
          f"operations, {nbytes} bytes), {100 * e['bound_ms'] / e['ms']:.1f} "
          f"% of it; the f32 bound of all {prod + elem} operations "
          f"{f32_bound:.4f} ms; max|err| {err:.3g}")

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
    need = CFCONV_ITERS * w.stack.num_layers
    if launches['cfconv_bwd'] != need or launches['cfconv_fwd'] != need:
        raise AssertionError(f'cfconv 26k: {launches["cfconv_fwd"]} forward '
                             f'and {launches["cfconv_bwd"]} backward '
                             f'launches, expected {need} each')
    e['launches'] = launches['cfconv_bwd']
    fe['launches'] = launches['cfconv_fwd']
    before = dict(_kernels.LAUNCHES)
    p_value, p_pos, p_x, p_dw, _ = schnet_mod.periodic_stack_grads(w, True)
    if dict(_kernels.LAUNCHES) != before:
        raise AssertionError('the plain iteration launched a kernel')
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
    return {'cfconv_fwd': fe, 'cfconv_bwd': e}


# ---------------------------------------------------------------------------
# Phase 9: the window path's opt-in switches (z-pair and cluster-pair
# radial kernels, the 'mask' compaction).
# ---------------------------------------------------------------------------

def deterministic(label, first, again):
    """Two launches on the same inputs give bitwise equal outputs."""
    for a, b in zip(first, again):
        if not torch.equal(a, b):
            raise AssertionError(f'{label}: two launches differ')


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
        'angular_aev_bwd': steps})
    require_exact('pair', launches, fused_launches(steps, 1))
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
    packs = []
    with recording(window_mod, 'left_pack', packs):
        window_mod.select_window(cell_list, pos, box, compact_impl='kernel',
                                 **kw)
    (args, _), = packs
    left_pack_entry(*args, label='left_pack 26k')
    del packs, args
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


# ---------------------------------------------------------------------------
# The dense and payload ANI paths (BASELINE configs 1 and 3): no kernel.
# ---------------------------------------------------------------------------

LIGANDS = Path(__file__).resolve().parent / 'tests' / 'data' / 'ligands.npz'
DENSE_CALLS = 10
PAYLOAD_CAPACITY = 96
PAYLOAD_ANGULAR = 32
PAYLOAD_CHUNK = 512     # the JAX package's probe chunk at 26k atoms


def cpu_gates(label, e, f, e_cpu, f_cpu, bf16):
    """The card's energy and forces against the same call on the CPU: f32
    relative energy 1e-6 and max|dF| <= 1e-4 max|F|; bf16 1e-4 and 5e-3."""
    rtol_e, rtol_f = (1e-4, 5e-3) if bf16 else (1e-6, 1e-4)
    e, f = e.cpu(), f.cpu()
    if not (torch.isfinite(e) and torch.isfinite(f).all()):
        raise AssertionError(f'{label}: non-finite energy or forces')
    if tuple(f.shape) != tuple(f_cpu.shape):
        raise AssertionError(f'{label}: forces shape {tuple(f.shape)}')
    check_close(f'{label} energy', e, e_cpu, rtol=rtol_e, atol=0.0)
    check_normwise(f'{label} forces', f, f_cpu, rtol=rtol_f)
    return (abs(float(e) - float(e_cpu)) / abs(float(e_cpu)),
            max_abs(f, f_cpu) / float(f_cpu.abs().max()))


def event_ms(fn, calls):
    """Mean ms of ``calls`` eager calls of ``fn`` between CUDA events, after
    one warm-up call; returns (ms, last result)."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls, out


def nudge_integrator(force_fn):
    """The force-nudge step ``pos += 1e-6 f`` as an ``md`` integrator."""
    def step(state):
        x = state.positions + 1e-6 * state.forces
        energy, forces = force_fn(x)
        return state._replace(positions=x, forces=forces, energy=energy,
                              step=state.step + 1)
    return step


def dense_payload_phase(basis, card):
    """Phase 10: the dense path (config 1) and the payload path (config 3,
    and at 26,010 atoms), held against the CPU; no kernel may launch."""
    params = init_ani_params(torch.Generator(device=DEV).manual_seed(SEED),
                             basis, num_models=8,
                             self_energies=np.linspace(-40, -1, 7),
                             device=DEV)
    cpu = torch.device('cpu')
    params_cpu = ani_params_to(params, cpu)
    _kernels.reset_launch_counts()

    # (a) Config 1: methanol and the seven ligands, one call each.
    ligands = np.load(LIGANDS)
    mols = [('methanol', np.asarray(run_configs.METHANOL_Z),
             np.asarray(run_configs.METHANOL_POSITIONS, np.float32))]
    mols += [(k[:-len('_positions')], ligands[k[:-len('_positions')]
                                              + '_atomic_numbers'],
              ligands[k].astype(np.float32))
             for k in sorted(ligands.files)
             if k.endswith('_positions') and not k.startswith('water')]
    if len(mols) != 8:
        raise AssertionError(f'expected methanol and 7 ligands, got {mols}')
    for nn_dtype in (None, 'bfloat16'):
        for name, z, xyz in mols:
            model = ANIModel.from_atomic_numbers(z, basis, nn_dtype=nn_dtype)
            pos = torch.tensor(xyz, device=DEV)
            ms, (e, f) = event_ms(
                lambda: model.energy_and_forces(params, pos), DENSE_CALLS)
            e_cpu, f_cpu = model.energy_and_forces(params_cpu, pos.cpu())
            err_e, err_f = cpu_gates(f'config 1 {name} {nn_dtype}', e, f,
                                     e_cpu, f_cpu, nn_dtype is not None)
            print(f'config 1 {name} ({len(z)} atoms, nn {nn_dtype or "f32"}):'
                  f' energy_and_forces {ms:.3f} ms/call (CUDA events, '
                  f'{DENSE_CALLS} calls; {card}); vs CPU: E rel {err_e:.2g},'
                  f' max|dF|/max|F| {err_f:.2g}')
        name, z, xyz = next(m for m in mols if m[0] == '2iuz')
        confs = torch.tensor(xyz + 0.02 * np.random.RandomState(SEED).randn(
            4, *xyz.shape).astype(np.float32), device=DEV)
        model = ANIModel.from_atomic_numbers(z, basis, nn_dtype=nn_dtype)
        ms, (e, f) = event_ms(
            lambda: model.energy_and_forces_batch(params, confs), 3)
        e_cpu, f_cpu = model.energy_and_forces_batch(params_cpu, confs.cpu())
        errs = [cpu_gates(f'config 1 batch {i} {nn_dtype}', e[i], f[i],
                          e_cpu[i], f_cpu[i], nn_dtype is not None)
                for i in range(4)]
        print(f'config 1 batch of 4 {name} conformers (nn {nn_dtype or "f32"}'
              f'): {ms:.3f} ms/call ({card}); vs CPU max: E rel '
              f'{max(e for e, _ in errs):.2g}, max|dF|/max|F| '
              f'{max(f for _, f in errs):.2g}')

    # (b) Config 3: 2,601 waters' atoms, the payload path.
    water = make_water_box(MOLECULES, seed=SEED)
    model = ANIModel.from_atomic_numbers(water.atomic_numbers, basis,
                                         angular_capacity=PAYLOAD_ANGULAR)
    cells = CellList.create(water.box, basis.radial_cutoff,
                            capacity=PAYLOAD_CAPACITY)
    pos = torch.tensor(water.positions, device=DEV)
    box = torch.tensor(water.box, device=DEV)
    ms, (e, f) = event_ms(
        lambda: model.energy_and_forces_fused(params, pos, box, cells), 5)
    e_cpu, f_cpu = model.energy_and_forces_fused(params_cpu, pos.cpu(),
                                                 box.cpu(), cells)
    err_e, err_f = cpu_gates('config 3', e, f, e_cpu, f_cpu, False)
    model.check_overflow(pos, box, cells)
    print(f'config 3 ({model.num_atoms} atoms, cells {cells.ncells} x '
          f'{cells.cell_capacity}, K {cells.capacity}, K_ang '
          f'{model.angular_capacity}): energy_and_forces_fused {ms:.3f} '
          f'ms/call ({card}); vs CPU: E rel {err_e:.2g}, max|dF|/max|F| '
          f'{err_f:.2g}; check_overflow passed')

    def sticky(model, cells, pos, box, blocks, steps):
        ra = basis.angular_cutoff
        e0, f0 = model.energy_and_forces_fused(params, pos, box, cells)
        state = MDState(pos, torch.zeros_like(pos), f0, e0,
                        torch.Generator(device=DEV),
                        torch.zeros((), dtype=torch.int32, device=DEV))
        return run_md_sticky(
            lambda p: model.select(p, box, cells),
            lambda sel, p: model.energy_and_forces_from_selection(
                params, p, box, cells, sel),
            nudge_integrator, state, blocks * steps, steps,
            lambda sel, p: max_angular_neighbors(
                cells.payload_from_selection(p, box, sel), ra))

    ms, (final, energies, stats) = event_ms(
        lambda: sticky(model, cells, pos, box, BLOCKS, REFRESH), 1)
    steps = BLOCKS * REFRESH
    stats.check(cells.capacity, cells.cell_capacity, PAYLOAD_ANGULAR)
    if not (torch.isfinite(energies).all()
            and torch.isfinite(final.forces).all()):
        raise AssertionError('config 3 sticky MD: non-finite output')
    print(f'config 3 sticky MD: {BLOCKS} selections x {REFRESH} nudged steps '
          f'(run_md_sticky, max_angular_neighbors as overflow_fn): '
          f'{ms / steps:.3f} ms/step (CUDA events, selections and each '
          f"block's first force call included; {card}); max counts "
          f'{int(stats.max_neighbors)}/{int(stats.max_cell_occupancy)}/'
          f'{int(stats.max_extra)}')

    # (c) The payload path at 26,010 atoms, chunked.
    water = make_water_box(LARGE_MOLECULES, seed=SEED)
    model = ANIModel.from_atomic_numbers(water.atomic_numbers, basis,
                                         angular_capacity=PAYLOAD_ANGULAR,
                                         aev_chunk_size=PAYLOAD_CHUNK)
    cells = CellList.create(water.box, basis.radial_cutoff,
                            capacity=PAYLOAD_CAPACITY)
    pos = torch.tensor(water.positions, device=DEV)
    box = torch.tensor(water.box, device=DEV)
    sel = model.select(pos, box, cells)
    p = pos
    model.energy_and_forces_from_selection(params, p, box, cells, sel)
    torch.cuda.reset_peak_memory_stats()

    def frozen():
        nonlocal p
        e, f = model.energy_and_forces_from_selection(params, p, box, cells,
                                                      sel)
        p = p + 1e-6 * f
        return e, f

    ms, (e, f) = event_ms(frozen, LARGE_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (torch.isfinite(e) and torch.isfinite(f).all()):
        raise AssertionError('payload 26k: non-finite output')
    model.check_overflow(p, box, cells, sel)
    print(f'payload 26k ({model.num_atoms} atoms, chunk {PAYLOAD_CHUNK}): '
          f'{ms:.3f} ms/step over {LARGE_STEPS} frozen steps (CUDA events; '
          f'{card}); peak memory {peak:.2f} GiB; no overflow')

    # (d) No kernel launched in (a)-(c).
    launched = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f'the dense and payload paths launched '
                             f'kernels: {launched}')
    print('dense and payload paths: no kernel launched')



# ---------------------------------------------------------------------------
# The parallel layer at world size 1 (NCCL), the distributed checkpoint and
# the host utilities.
# ---------------------------------------------------------------------------

TRAIN_LR = 3e-4
TRAIN_FORCE_WEIGHT = 0.1
TRAIN_STEPS = 3
SHARDED_CALLS = 10
PP_WIDTH, PP_ROWS, PP_MICROBATCHES = 256, 1024, 4
ELEMENT_SYMBOLS = {1: 'H', 6: 'C', 7: 'N', 8: 'O', 9: 'F', 16: 'S', 17: 'Cl'}


def with_forces(fn, pos):
    """(energy, forces) of ``fn(pos)`` by autograd."""
    p = pos.detach().requires_grad_(True)
    e = fn(p)
    (g,) = torch.autograd.grad(e, p)
    return e.detach(), -g


def leaf_norm(tensors):
    return float(torch.sqrt(sum((t.detach().double() ** 2).sum()
                                for t in tensors)))


def traced(fn, calls=3):
    """(device kernel ms, kernels) per call of ``fn`` under the port's
    ``utils.profiling.trace`` (torch.profiler)."""
    with tempfile.TemporaryDirectory() as tmp, trace(tmp) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = _kernel_events(prof)
    return sum(us for _, us in kernels) / 1e3 / calls, len(kernels) / calls


def window_sharded_check(basis, params, mesh, card):
    """(a) The window-sharded force call at water-2.6k against the
    unsharded window model (nn_impl 'xla', f32) on the same selection, and
    its B.2 / B.3 launches, forward and backward."""
    _, fused, cell_list, pos, box = build(MOLECULES, 'window', basis)
    model = dataclasses.replace(fused, nn_impl='xla', nn_dtype=None)
    sel = model.select(pos, box, cell_list)
    fn = window_sharded_energy(model, mesh, axis='dp')

    def sharded():
        return with_forces(lambda p: fn(params, p, box, sel), pos)

    def unsharded():
        return model.energy_and_forces_from_selection(params, pos, box,
                                                      cell_list, sel)

    sharded()
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    e_sh, f_sh = sharded()
    torch.cuda.synchronize()
    launches = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    ntiers = 1 + len(model.blocked_layout.ang_tier_caps or ())
    need = {'window_radial_fwd': 1, 'window_radial_bwd': 1,
            'angular_aev_fwd': ntiers, 'angular_aev_bwd': ntiers}
    if launches != need:
        raise AssertionError(f'window sharded call launched {launches}, '
                             f'expected {need}')
    e_un, f_un = unsharded()
    check_close('window sharded energy', e_sh, e_un, rtol=1e-6, atol=0.0)
    check_normwise('window sharded forces', f_sh, f_un, rtol=1e-4)
    t_sh = StepTimer(sharded, warmup=1).measure(iters=SHARDED_CALLS)
    t_un = StepTimer(unsharded, warmup=1).measure(iters=SHARDED_CALLS)
    (dev_sh, k_sh), (dev_un, k_un) = traced(sharded), traced(unsharded)
    print(f'window_sharded_energy, world size 1 (NCCL), water-2.6k '
          f'({model.num_atoms} atoms, {ntiers} tiers, f32 ensemble): mean '
          f'{t_sh["mean_us"] / 1e3:.3f} / median '
          f'{t_sh["median_us"] / 1e3:.3f} ms/call, device {dev_sh:.3f} ms '
          f'in {k_sh:.0f} kernels; unsharded xla window call mean '
          f'{t_un["mean_us"] / 1e3:.3f} / median '
          f'{t_un["median_us"] / 1e3:.3f} ms/call, device {dev_un:.3f} ms '
          f'in {k_un:.0f} kernels (StepTimer, CUDA events, {SHARDED_CALLS} '
          f'calls, energy and forces; device time under utils.profiling.'
          f'trace; {card}); E rel '
          f'{abs(float(e_sh - e_un)) / abs(float(e_un)):.2g}, max|dF|/max|F|'
          f' {max_abs(f_sh, f_un) / float(f_un.abs().max()):.2g}; launches '
          f'in one call {launches}')


def train_check(basis, mesh, card):
    """(b) The DP x EP train step at world size 1 against the same step
    on the CPU; returns (model, the state after the steps, the initial
    parameters on the CPU, the optimizer factory)."""
    ligands = np.load(LIGANDS)
    z = ligands['2iuz_atomic_numbers']
    xyz = ligands['2iuz_positions'].astype(np.float32)
    confs = torch.tensor(xyz + 0.02 * np.random.RandomState(SEED).randn(
        4, *xyz.shape).astype(np.float32))
    model = ANIModel.from_atomic_numbers(z, basis)
    cpu = torch.device('cpu')
    params0 = init_ani_params(torch.Generator().manual_seed(SEED), basis,
                              num_models=8, device=cpu)
    with torch.no_grad():
        e0 = torch.stack([model.energy(params0, c) for c in confs])
    e_t, f_t = e0 - 1.0, torch.zeros_like(confs)
    opt = functools.partial(torch.optim.SGD, lr=TRAIN_LR)

    # The CPU reference: the plain step, once.
    ref = from_jax_params(params_tree(params0), cpu)      # a copy
    ref_leaves = sharding_mod.param_leaves(ref)
    for p in ref_leaves:
        p.requires_grad_(True)
    ref_state = sharding_mod.TrainState(ref, opt(ref_leaves))
    ref_state, ref_loss = sharding_mod.make_train_step(
        model, TRAIN_FORCE_WEIGHT)(ref_state, confs, e_t, f_t)

    state = sharding_mod.init_train_state(model, opt, params0, mesh)
    step = sharding_mod.jit_train_step(model, mesh, TRAIN_FORCE_WEIGHT)
    batch = sharding_mod.shard_batch(mesh, confs, e_t, f_t)
    state, loss = step(state, *batch)
    losses = [float(loss)]
    got = [p.detach().cpu() for p in sharding_mod.param_leaves(state.params)]
    want = [p.detach() for p in ref_leaves]
    start = sharding_mod.param_leaves(params0)
    err = leaf_norm([g - w for g, w in zip(got, want)]) / leaf_norm(want)
    upd_err = (leaf_norm([g - w for g, w in zip(got, want)])
               / leaf_norm([w - p for w, p in zip(want, start)]))
    check_close('train step loss', torch.tensor(losses[0]), ref_loss,
                rtol=1e-5, atol=0.0)
    if not (err <= 1e-4 and upd_err <= 1e-3):
        raise AssertionError(f'train step: parameters {err} (gate 1e-4) and '
                             f'update {upd_err} (gate 1e-3) off the CPU step')
    torch.cuda.synchronize()
    start_ev = torch.cuda.Event(enable_timing=True)
    end_ev = torch.cuda.Event(enable_timing=True)
    start_ev.record()
    for _ in range(TRAIN_STEPS - 1):
        state, loss = step(state, *batch)
        losses.append(float(loss))
    end_ev.record()
    torch.cuda.synchronize()
    ms = start_ev.elapsed_time(end_ev) / (TRAIN_STEPS - 1)
    if not (np.isfinite(losses).all()
            and all(b < a for a, b in zip(losses, losses[1:]))):
        raise AssertionError(f'train step: losses {losses} do not fall')
    print(f'train step, world size 1 (NCCL), ANI-2x 8 models, 4 perturbed '
          f'2iuz conformers ({len(z)} atoms), force_weight '
          f'{TRAIN_FORCE_WEIGHT}, SGD lr {TRAIN_LR}: losses {losses}; '
          f'{ms:.3f} ms/step over steps 2-{TRAIN_STEPS} (CUDA events, '
          f'second-order force term included; {card}); after one step vs '
          f'the CPU step: parameters {err:.2g} normwise, update '
          f'{upd_err:.2g}')
    return model, state, params0, opt


def other_sharded_check(basis, params, mesh, card):
    """(c) atom_sharded_energy, tp_ensemble_energy and
    pipeline_ensemble_energy at world size 1, each against its unsharded
    counterpart."""
    ligands = np.load(LIGANDS)
    z = ligands['1hvk_atomic_numbers']
    pos = torch.tensor(ligands['1hvk_positions'].astype(np.float32),
                       device=DEV)
    model = ANIModel.from_atomic_numbers(z, basis)
    atom_fn = sharding_mod.atom_sharded_energy(model, mesh, axis='dp')
    ms_sh, (e_sh, f_sh) = event_ms(
        lambda: with_forces(lambda p: atom_fn(params, p), pos), DENSE_CALLS)
    ms_un, (e_un, f_un) = event_ms(
        lambda: model.energy_and_forces(params, pos), DENSE_CALLS)
    check_close('atom_sharded energy', e_sh, e_un, rtol=1e-6, atol=0.0)
    check_normwise('atom_sharded forces', f_sh, f_un, rtol=1e-4)
    print(f'atom_sharded_energy, world size 1, 1hvk ({len(z)} atoms): '
          f'{ms_sh:.3f} ms/call vs energy_and_forces {ms_un:.3f} ms/call '
          f'({card}); E rel {abs(float(e_sh - e_un)) / abs(float(e_un)):.2g}')

    with torch.no_grad():
        aev = model.aev(pos)
        grouping, _ = model._device_grouping(DEV)
        tp_fn = sharding_mod.tp_ensemble_energy(model, mesh, axis='mp')
        ms_tp, e_tp = event_ms(lambda: tp_fn(params, aev), DENSE_CALLS)
        ms_ref, e_ref = event_ms(lambda: ensemble_energy(
            params.ensemble, aev, grouping), DENSE_CALLS)
        check_close('tp ensemble energy', e_tp, e_ref, rtol=1e-5, atol=0.0)
        print(f'tp_ensemble_energy, world size 1 (AEV {aev.shape[1]} / 1): '
              f'{ms_tp:.3f} ms/call vs ensemble_energy {ms_ref:.3f} ms/call '
              f'({card}); E rel '
              f'{abs(float(e_tp - e_ref)) / abs(float(e_ref)):.2g}')

        g = torch.Generator(device=DEV).manual_seed(SEED)
        stage_w = torch.randn(1, PP_WIDTH, PP_WIDTH, generator=g,
                              device=DEV) / PP_WIDTH ** 0.5
        stage_b = 0.1 * torch.randn(1, PP_WIDTH, generator=g, device=DEV)
        x = torch.randn(PP_ROWS, PP_WIDTH, generator=g, device=DEV)
        pp_fn = sharding_mod.pipeline_ensemble_energy(
            (PP_WIDTH,), mesh, axis='mp', num_microbatches=PP_MICROBATCHES)
        ms_pp, y = event_ms(lambda: pp_fn(stage_w, stage_b, x), DENSE_CALLS)
        ms_plain, y_ref = event_ms(
            lambda: torch.relu(x @ stage_w[0] + stage_b[0]), DENSE_CALLS)
        check_normwise('pipeline output', y, y_ref, rtol=1e-5)
        print(f'pipeline_ensemble_energy, 1 stage, {PP_MICROBATCHES} '
              f'microbatches of [{PP_ROWS // PP_MICROBATCHES}, {PP_WIDTH}]: '
              f'{ms_pp:.3f} ms/call vs one layer {ms_plain:.3f} ms/call '
              f'({card}); max|dy| {max_abs(y, y_ref):.2g}')
    print('pipeline_ani_ensemble_energy: not run on the card (its stages '
          'must equal the network depth, 4 for ANI-2x, and the card host '
          'has one H100); its CPU tests run it over 3 gloo ranks')


def checkpoint_check(model, state, params0, opt, mesh):
    """(d) The train state through the distributed checkpoint and back,
    bit for bit."""
    with tempfile.TemporaryDirectory() as tmp:
        path = f'{tmp}/train_state'
        save_checkpoint_distributed(path, state, mesh)
        fresh = sharding_mod.init_train_state(model, opt, params0, mesh)
        load_checkpoint_distributed(path, fresh, mesh)
    want = sharding_mod.param_leaves(state.params)
    got = sharding_mod.param_leaves(fresh.params)
    if not all(torch.equal(a, b) for a, b in zip(want, got)):
        raise AssertionError('distributed checkpoint: parameters differ')
    if (fresh.opt_state.state_dict()['param_groups']
            != state.opt_state.state_dict()['param_groups']):
        raise AssertionError('distributed checkpoint: param_groups differ')
    print(f'distributed checkpoint (torch.distributed.checkpoint, DTensor '
          f'shards): {len(want)} parameter tensors restored bit for bit')


def write_mol2(path, z, xyz):
    lines = ['@<TRIPOS>MOLECULE', 'ligand', f' {len(z)} 0 1', 'SMALL',
             '@<TRIPOS>ATOM']
    for i, (zi, (x, y, w)) in enumerate(zip(z, xyz)):
        sym = ELEMENT_SYMBOLS[int(zi)]
        lines.append(f'{i + 1:7d} {sym}{i + 1:<5d} {x:10.4f} {y:10.4f} '
                     f'{w:10.4f} {sym} 1 LIG 0.0000')
    Path(path).write_text('\n'.join(lines) + '\n')


def write_pdb(path, z, xyz, box):
    edge = np.linalg.norm(box, axis=1)
    lines = [f'CRYST1{edge[0]:9.3f}{edge[1]:9.3f}{edge[2]:9.3f}'
             f'{90.0:7.2f}{90.0:7.2f}{90.0:7.2f} P 1           1']
    for i, (zi, (x, y, w)) in enumerate(zip(z, xyz)):
        sym = ELEMENT_SYMBOLS[int(zi)]
        lines.append(f'HETATM{i + 1:5d} {sym:<4s} HOH A{i // 3 + 1:4d}    '
                     f'{x:8.3f}{y:8.3f}{w:8.3f}  1.00  0.00          '
                     f'{sym:>2s}')
    Path(path).write_text('\n'.join(lines + ['END']) + '\n')


def host_utilities_check(basis):
    """(e) The native loader on a mol2 and a PDB this script writes, and
    the capacity planner on water-2.6k, against the Python loaders and the
    numpy planner."""
    if native.get_lib() is None:
        raise AssertionError('the native host library did not build (g++)')
    ligands = np.load(LIGANDS)
    water = make_water_box(MOLECULES, seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        mol2, pdb = f'{tmp}/2iuz.mol2', f'{tmp}/water.pdb'
        write_mol2(mol2, ligands['2iuz_atomic_numbers'],
                   ligands['2iuz_positions'])
        write_pdb(pdb, water.atomic_numbers, water.positions, water.box)
        for path, py in ((mol2, utils_io.load_mol2(mol2)),
                         (pdb, utils_io.load_pdb(pdb))):
            nat = native.load_molecule(path)
            if not (np.array_equal(nat.atomic_numbers, py.atomic_numbers)
                    and np.allclose(nat.positions, py.positions, atol=1e-5,
                                    rtol=0)
                    and (py.box is None) == (nat.box is None)
                    and (py.box is None
                         or np.allclose(nat.box, py.box, atol=1e-4, rtol=0))):
                raise AssertionError(f'native loader differs on {path}')
    if not np.array_equal(nat.atomic_numbers, water.atomic_numbers):
        raise AssertionError('the PDB round trip changed the elements')
    args = (water.positions, water.box, basis.radial_cutoff,
            basis.angular_cutoff, basis.radial_cutoff)
    got = native._counts_native(native.get_lib(), *args)
    want = native._counts_numpy(*args)
    if got != want:
        raise AssertionError(f'plan_capacities: native {got} != numpy {want}')
    print(f'host utilities: native load_molecule equals load_mol2 on 2iuz '
          f'({len(ligands["2iuz_atomic_numbers"])} atoms) and load_pdb on '
          f'water-2.6k ({len(water.positions)} atoms, CRYST1 box); '
          f'plan_capacities counts on water-2.6k native {got} = numpy {want}'
          f', capacities {native.plan_capacities(*args[:4])}')


def parallel_phase(basis, card):
    """Phase 11: the parallel layer over NCCL at world size 1, the
    distributed checkpoint, the host utilities."""
    params = init_ani_params(torch.Generator(device=DEV).manual_seed(SEED),
                             basis, num_models=8,
                             self_energies=np.linspace(-40, -1, 7),
                             device=DEV)
    with process_group('nccl'):
        mesh = sharding_mod.make_mesh(1, model_parallel=1,
                                      device_type='cuda')
        window_sharded_check(basis, params, mesh, card)
        model, state, params0, opt = train_check(basis, mesh, card)
        other_sharded_check(basis, params, mesh, card)
        checkpoint_check(model, state, params0, opt, mesh)
    host_utilities_check(basis)


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
        'angular_aev_bwd': ntiers * steps})
    require_exact('window', launches, fused_launches(steps, 1))
    step_vs_plain('window', model, params, p, box, cell_list, sel)
    for k in kernels.values():
        k['launches'] = launches[k['name']]

    window_large_phase(basis, params)
    kernels['pme_window_fwd'], kernels['pme_window_bwd'] = config5_phase(basis)
    kernels.update(cfconv_phase())
    kernels.update(opt_in_phase(basis, params))
    dense_payload_phase(basis, smi[0])
    parallel_phase(basis, smi[0])

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
