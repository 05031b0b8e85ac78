"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX: the machine with the GPU has none. Inputs come from numpy
seeds through the port's own selection and payload. Every test needs a
CUDA device and skips without one. On the card, from the repository root
(``--noconftest``: ``tests/conftest.py`` configures JAX):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nnpops_tpu_torch import ANI2X_LAYER_DIMS, ANIBasis, _kernels
from nnpops_tpu_torch.config import CFConvConfig, MACEConfig, PaiNNConfig
from nnpops_tpu_torch.models import ani as ani_module
from nnpops_tpu_torch.models.ani import (ANIModel, init_ani_params,
                                         plain_energy_and_forces)
from nnpops_tpu_torch.models.combined import ANIWithPME
from nnpops_tpu_torch.models.mace import MACEModel
from nnpops_tpu_torch.models.painn import PaiNNModel
from nnpops_tpu_torch.models.schnet import CFConvStack, SchNetModel
from nnpops_tpu_torch.models.combined import \
    plain_energy_and_forces as combined_plain
from nnpops_tpu_torch.neighbors.blocked import (BlockedLayout,
                                                payload_from_blocked,
                                                plan_blocked_layout,
                                                select_blocked)
from nnpops_tpu_torch.neighbors.cell_list import CellList, lane_geometry
from nnpops_tpu_torch.neighbors.window import radial_window_inputs
from nnpops_tpu_torch.neighbors import clusters as clusters_mod
from nnpops_tpu_torch.neighbors import window as window_mod
from nnpops_tpu_torch.neighbors.window import _radial_slots, select_window
from nnpops_tpu_torch.ops import (batched_nn, cuda_aev, cuda_cfconv,
                                  cuda_cluster, cuda_nn, cuda_pme,
                                  cuda_select, cuda_window, cuda_zpair)
from nnpops_tpu_torch.ops import painn as painn_ops
from nnpops_tpu_torch.ops.cfconv import CFConvParams, init_cfconv
from nnpops_tpu_torch.ops.cuda_cfconv import _pad_row
from nnpops_tpu_torch.ops.pme import PME
from nnpops_tpu_torch.utils import make_water_box
from nnpops_tpu_torch.utils.profiling import recording

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU (the CUDA kernels have no CPU mode)')
    return torch.device('cuda', torch.cuda.current_device())


def small_basis(torchani, zeta=14.1):
    return ANIBasis.from_grids(
        num_species=3, Rcr=4.2, Rca=3.1,
        EtaR=[16.0], ShfR=[0.9, 1.7, 2.5, 3.3],
        EtaA=[8.0], Zeta=[zeta], ShfA=[0.9, 1.6, 2.3], ShfZ=[0.2, 1.2, 2.2],
        torchani=torchani)


def angular_inputs(basis, rad_mode, dev, n=200, seed=4, box_width=14.0):
    rng = np.random.RandomState(seed)
    positions = rng.rand(n, 3).astype(np.float32) * box_width
    species = rng.randint(0, 3, n).astype(np.int32)
    box = np.eye(3, dtype=np.float32) * box_width
    layout = plan_blocked_layout(positions, box, species, basis.radial_cutoff,
                                 basis.angular_cutoff, basis.num_species)
    cl = CellList.create(box, basis.radial_cutoff, capacity=layout.rad_total)
    pos, tbox = torch.tensor(positions, device=dev), torch.tensor(box, device=dev)
    sel = select_blocked(cl, pos, tbox, species, layout, basis.radial_cutoff,
                         basis.angular_cutoff)
    pay = payload_from_blocked(cl, pos, tbox, sel, rad_only=rad_mode,
                               layout=layout)
    deltas = pay.rad_deltas if rad_mode else pay.ang_deltas
    return (deltas.contiguous(), pay.ang_mask.contiguous(), layout,
            layout.rad_total if rad_mode else None)


@pytest.mark.parametrize('torchani, rad_mode',
                         [(True, False), (False, False), (True, True),
                          (False, True)],
                         ids=['torchani', 'publication', 'torchani-rad',
                              'publication-rad'])
def test_angular_kernel_matches_plain(dev, torchani, rad_mode):
    basis = small_basis(torchani)
    deltas, mask, layout, rad_width = angular_inputs(basis, rad_mode, dev)
    d_k = deltas.clone().requires_grad_(True)
    d_p = deltas.clone().requires_grad_(True)
    before = _kernels.LAUNCHES['angular_aev_fwd']
    a_k = cuda_aev.angular_aev(d_k, mask, basis, layout, rad_width)
    assert _kernels.LAUNCHES['angular_aev_fwd'] == before + 1
    a_p = cuda_aev.place_angular(
        cuda_aev.angular_aev_plain(d_p, mask, basis, layout, rad_width),
        basis, layout)
    torch.testing.assert_close(a_k, a_p, rtol=3e-5, atol=3e-6)
    (g_k,) = torch.autograd.grad(a_k.square().sum(), d_k)
    (g_p,) = torch.autograd.grad(a_p.square().sum(), d_p)
    torch.testing.assert_close(g_k, g_p, rtol=2e-4, atol=2e-5)


def edge_rows(caps, ra, rad_caps=None, seed=0, n_random=8):
    """Delta planes ``[3, N, W]`` and mask ``[N, Kat]`` for rows at the
    angular kernel's edges: 0, 1 and 2 valid lanes (one block and two),
    every lane valid, masked lanes inside the cutoff, pairs at the cosine
    clip (k = +-2 j exactly, collinear), then random rows. With
    ``rad_caps`` the planes are radial: each species' angular lanes lead
    its radial block, the radial-only lanes hold other finite neighbors."""
    rng = np.random.RandomState(seed)
    kat = sum(caps)
    offs = np.cumsum((0,) + tuple(caps))[:-1]

    def vec(n, lo=0.9, hi=0.97 * ra):
        u = rng.randn(n, 3)
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        return u * rng.uniform(lo, hi, (n, 1))

    def far(n):
        return vec(n, 1.05 * ra, 2.0 * ra)

    full = np.ones(kat, bool)
    rows = [(far(kat), full)]                              # 0 valid lanes
    d = far(kat)
    d[offs[-1]] = vec(1)[0]
    rows.append((d, full))                                 # 1
    d = far(kat)
    d[offs[0]:offs[0] + 2] = vec(2)
    rows.append((d, full))                                 # 2, one block
    d = far(kat)
    d[offs[0]], d[offs[-1]] = vec(1)[0], vec(1)[0]
    rows.append((d, full))                                 # 2, two blocks
    rows.append((vec(kat), full))                          # every lane
    rows.append((vec(kat), rng.rand(kat) < 0.5))           # masked inside
    d = vec(kat)
    q = kat // 4
    d[:q] = vec(q, 0.9, 0.48 * ra)
    d[q:2 * q] = d[:q] * np.where(np.arange(q) % 2, 2.0, -2.0)[:, None]
    rows.append((d, full))                                 # at the clip
    for _ in range(n_random):
        rows.append((np.where(rng.rand(kat, 1) < 0.45, vec(kat), far(kat)),
                     rng.rand(kat) < 0.9))
    d = np.stack([r for r, _ in rows]).astype(np.float32)  # [N, Kat, 3]
    mask = np.stack([m for _, m in rows])
    if rad_caps is not None:
        planes = rng.uniform(-6.0, 6.0, (len(rows), sum(rad_caps), 3))
        roffs = np.cumsum((0,) + tuple(rad_caps))[:-1]
        for o, ro, c in zip(offs, roffs, caps):
            planes[:, ro:ro + c] = d[:, o:o + c]
        d = planes.astype(np.float32)
    return (torch.tensor(np.ascontiguousarray(d.transpose(2, 0, 1))),
            torch.tensor(mask))


def edge_case(grid, torchani):
    """(basis, layout): ANI-2x's angular terms on a water tier-0 layout (32
    H + 16 O lanes, radial blocks 40 + 20), or the (3, 3) small basis on
    three species blocks, with its zeta 14.1 or an integer zeta (the
    kernel's run-time integer power, no fractional part)."""
    if grid == 'ani2x':
        basis = dataclasses.replace(ANIBasis.ani2x(), torchani=torchani)
        return basis, BlockedLayout(num_species=7, present=(0, 3),
                                    rad_caps=(40, 20), ang_caps=(32, 16))
    basis = small_basis(torchani, 8.0 if grid == 'small-zeta8' else 14.1)
    return basis, BlockedLayout(
        num_species=3, present=(0, 1, 2), rad_caps=(12, 9, 14),
        ang_caps=(10, 5, 11))


@pytest.mark.parametrize('grid', ['ani2x', 'small', 'small-zeta8'])
@pytest.mark.parametrize('torchani, rad_mode',
                         [(True, False), (False, False), (True, True),
                          (False, True)],
                         ids=['torchani', 'publication', 'torchani-rad',
                              'publication-rad'])
def test_angular_kernel_edge_rows(dev, grid, torchani, rad_mode):
    """The angular kernel against its plain version on rows at its edges,
    forward and gradient at the kernel's gates, and two launches of each
    direction bitwise equal."""
    basis, layout = edge_case(grid, torchani)
    deltas, mask = edge_rows(layout.ang_caps, basis.angular_cutoff,
                             layout.rad_caps if rad_mode else None, seed=5)
    deltas, mask = deltas.to(dev), mask.to(dev)
    width = layout.rad_total if rad_mode else None
    d_k = deltas.clone().requires_grad_(True)
    d_p = deltas.clone().requires_grad_(True)
    a_k = cuda_aev.angular_aev(d_k, mask, basis, layout, width)
    a_p = cuda_aev.place_angular(
        cuda_aev.angular_aev_plain(d_p, mask, basis, layout, width),
        basis, layout)
    torch.testing.assert_close(a_k, a_p, rtol=3e-5, atol=3e-6)
    # Rows with fewer than two valid lanes in a block give exact zeros.
    assert torch.count_nonzero(a_k[:2]) == 0
    (g_k,) = torch.autograd.grad(a_k.square().sum(), d_k)
    (g_p,) = torch.autograd.grad(a_p.square().sum(), d_p)
    torch.testing.assert_close(g_k, g_p, rtol=2e-4, atol=2e-5)
    spec = cuda_aev._spec(basis, layout, width, deltas.device)
    raw = cuda_aev.angular_fwd_cuda(deltas, mask, spec)
    assert torch.equal(raw, cuda_aev.angular_fwd_cuda(deltas, mask, spec))
    cot = torch.rand(raw.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(1))
    first = cuda_aev.angular_bwd_cuda(deltas, mask, cot, spec)
    assert torch.equal(first, cuda_aev.angular_bwd_cuda(deltas, mask, cot,
                                                        spec))


def test_angular_wrapper_rejects_bad_input(dev):
    basis = small_basis(True)
    deltas, mask, layout, _ = angular_inputs(basis, False, dev)
    with pytest.raises(ValueError):
        cuda_aev.angular_aev(deltas.double(), mask, basis, layout)
    with pytest.raises(ValueError):
        cuda_aev.angular_aev(deltas, mask.float(), basis, layout)


def random_net(dims, num_models, in_dim, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    ens = batched_nn.init_ensemble(gen, in_dim, [dims], num_models,
                                   device='cpu')
    net = ens.networks[0]
    biases = tuple(0.1 * torch.randn(b.shape, generator=gen) for b in net.biases)
    return batched_nn.SpeciesNet(tuple(w.to(dev) for w in net.weights),
                                 tuple(b.to(dev) for b in biases))


@pytest.mark.parametrize('dims, num_models, in_dim',
                         [((32, 24, 16), 2, 64), (ANI2X_LAYER_DIMS[0], 8, 1008)],
                         ids=['narrow', 'ani2x-H'])
def test_fused_nn_kernel_matches_plain(dev, dims, num_models, in_dim):
    net = random_net(dims, num_models, in_dim, dev, seed=9)
    gen = torch.Generator().manual_seed(10)
    x = (0.3 * torch.randn(203, in_dim, generator=gen)).to(dev)
    pe = cuda_nn.pack_ensemble(batched_nn.EnsembleParams((net,)))
    e_k = cuda_nn.ensemble_cuda(x, pe, (len(x),), False)[0]
    e_kg, dx_k = cuda_nn.ensemble_cuda(x, pe, (len(x),), True)
    e_p, dx_p = cuda_nn.fused_species_net_plain(x, net, with_grad=True)
    # Normwise gates: a bf16 operand can round the other way when the f32
    # accumulation order differs, which moves a near-zero energy by more
    # than 1e-3 of itself but not of the block's scale.
    for e in (e_k, e_kg):
        assert float((e - e_p).abs().max()) <= 1e-3 * float(e_p.abs().max())
    assert float((dx_k - dx_p).abs().max()) <= 1e-2 * float(dx_p.abs().max())


FUSED_GRAD_STAGES = ('fused_nn_fwdgrad_layer1', 'fused_nn_fwdgrad_hidden',
                     'fused_nn_fwdgrad_dx')
FUSED_FWD_STAGES = ('fused_nn_fwd_layer1', 'fused_nn_fwd_hidden')


def random_ensemble(dims_list, num_models, in_dim, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    ens = batched_nn.init_ensemble(gen, in_dim, dims_list, num_models,
                                   device='cpu')
    return batched_nn.EnsembleParams(tuple(
        batched_nn.SpeciesNet(
            tuple(w.to(dev) for w in net.weights),
            tuple((0.1 * torch.randn(b.shape, generator=gen)).to(dev)
                  for b in net.biases))
        for net in ens.networks))


def normwise(got, want, rtol):
    err = float((got.float() - want.float()).abs().max())
    assert err <= rtol * float(want.float().abs().max()), (err, rtol)


# Three narrow species of different widths (one with 1 row, one with none),
# the same with odd model counts (each species' vectors then end on an odd
# float before the pack pads them), and the ANI-2x H and O nets at full
# width with ragged row counts.
STAGE_CASES = {
    'narrow': ([(32, 24, 16), (48, 16, 32), (16, 32, 16)], 2, 64, (203, 1, 0)),
    'narrow-3-models': ([(32, 24, 16), (48, 16, 32), (16, 32, 16)], 3, 64,
                        (70, 33, 5)),
    'narrow-1-model': ([(32, 24, 16), (48, 16, 32)], 1, 64, (130, 7)),
    'ani2x-HO': ([ANI2X_LAYER_DIMS[0], ANI2X_LAYER_DIMS[3]], 8, 1008,
                 (203, 1)),
}


@pytest.mark.parametrize('case', sorted(STAGE_CASES))
def test_fused_nn_stage_kernels_match_plain(dev, case):
    """Each stage kernel against its plain version on the same inputs."""
    dims_list, models, in_dim, counts = STAGE_CASES[case]
    params = random_ensemble(dims_list, models, in_dim, dev, seed=11)
    pe = cuda_nn.pack_ensemble(params)
    n = sum(counts)
    x = (0.3 * torch.randn(n, in_dim, generator=torch.Generator()
                           .manual_seed(12))).to(dev)
    x16 = cuda_nn.to_bf16_input(x, pe)
    ws = cuda_nn.workspace(pe, counts, True)
    buf = torch.empty(ws.nbytes, dtype=torch.uint8, device=dev)
    h1, d1, g1, epart, cnt = cuda_nn.workspace_views(buf, ws, pe, n)
    h1_p, d1_p = cuda_nn.layer1_plain(x16, pe, counts, True)
    e_p, g1_p = cuda_nn.hidden_plain(h1_p, d1_p, pe, counts, True)
    dx_p = cuda_nn.dx_plain(g1_p, pe, counts)
    before = dict(_kernels.LAUNCHES)
    cuda_nn.layer1_cuda(x16, pe, counts, h1, d1, cnt)
    h1_k = h1.clone()
    for s, r0, r1, ksp in cuda_nn.species_rows(pe, counts):
        normwise(h1[r0:r1, :ksp], h1_p[r0:r1, :ksp], 1e-2)
        normwise(d1[r0:r1, :ksp], d1_p[r0:r1, :ksp], 1e-2)
    # The hidden and dx kernels on the plain version's own inputs.
    h1.copy_(h1_p)
    d1.copy_(d1_p)
    e = torch.empty(n, 1, device=dev)
    cuda_nn.hidden_cuda(h1, d1, pe, counts, g1, epart, cnt, e)
    normwise(e, e_p, 1e-3)
    for s, r0, r1, ksp in cuda_nn.species_rows(pe, counts):
        normwise(g1[r0:r1, :ksp], g1_p[r0:r1, :ksp], 1e-2)
    g1.copy_(g1_p)
    dx = torch.empty(n, in_dim, device=dev)
    cuda_nn.dx_cuda(g1, pe, counts, dx)
    normwise(dx, dx_p, 1e-4)
    for k in FUSED_GRAD_STAGES:
        assert _kernels.LAUNCHES[k] == before[k] + 1
    # The forward-only stages give the energies of the gradient stages.
    cnt.zero_()
    h1f = torch.empty_like(h1)
    cuda_nn.layer1_cuda(x16, pe, counts, h1f, None, cnt)
    for s, r0, r1, ksp in cuda_nn.species_rows(pe, counts):
        assert torch.equal(h1f[r0:r1, :ksp], h1_k[r0:r1, :ksp])
    e_f = torch.empty(n, 1, device=dev)
    cuda_nn.hidden_cuda(h1, None, pe, counts, None, epart, cnt, e_f)
    normwise(e_f, e, 1e-6)
    for k in FUSED_FWD_STAGES:
        assert _kernels.LAUNCHES[k] == before[k] + 1


@pytest.mark.parametrize('case', sorted(STAGE_CASES))
def test_fused_nn_one_launch_set_matches_oracle(dev, case):
    """The grouped total and its gradient through one launch set for every
    species, against the per-species oracle; two launches are bitwise
    equal."""
    dims_list, models, in_dim, counts = STAGE_CASES[case]
    params = random_ensemble(dims_list, models, in_dim, dev, seed=13)
    x = (0.3 * torch.randn(sum(counts), in_dim, generator=torch.Generator()
                           .manual_seed(14))).to(dev)
    _kernels.reset_launch_counts()
    xk = x.clone().requires_grad_(True)
    total = cuda_nn.ensemble_energy_grouped_rows_fused(params, xk, counts)
    (g_k,) = torch.autograd.grad(total, xk)
    assert all(_kernels.LAUNCHES[k] == 1 for k in FUSED_GRAD_STAGES)
    assert not any(_kernels.LAUNCHES[k] for k in FUSED_FWD_STAGES)
    with torch.no_grad():
        total_f = cuda_nn.ensemble_energy_grouped_rows_fused(params, x, counts)
    assert all(_kernels.LAUNCHES[k] == 1 for k in FUSED_FWD_STAGES)
    xp = x.clone().requires_grad_(True)
    want = cuda_nn.ensemble_energy_grouped_rows_fused_plain(params, xp, counts)
    (g_p,) = torch.autograd.grad(want, xp)
    # Per-atom energies are gated normwise; the total against the sum of
    # their magnitudes.
    pe = cuda_nn.pack_ensemble(params)
    e_k, dx_k = cuda_nn.ensemble_cuda(x, pe, counts, True)
    e_o, dx_o = cuda_nn.ensemble_oracle(params, x, counts, True)
    normwise(e_k, e_o, 1e-3)
    normwise(dx_k, dx_o, 1e-2)
    assert (abs(float(total.detach()) - float(want.detach()))
            <= 1e-3 * float(e_o.abs().sum()))
    assert abs(float(total_f) - float(total)) <= 1e-6 * float(e_o.abs().sum())
    normwise(g_k, g_p, 1e-2)
    normwise(dx_k, g_p, 1e-2)
    # Deterministic: no float atomics.
    e_k2, dx_k2 = cuda_nn.ensemble_cuda(x, pe, counts, True)
    e_f1, _ = cuda_nn.ensemble_cuda(x, pe, counts, False)
    e_f2, _ = cuda_nn.ensemble_cuda(x, pe, counts, False)
    assert torch.equal(e_k, e_k2) and torch.equal(dx_k, dx_k2)
    assert torch.equal(e_f1, e_f2)
    normwise(e_f1, e_k, 1e-6)


def test_fused_nn_rejects_bad_input(dev):
    params = random_ensemble([(32, 24, 16)], 2, 64, dev, seed=15)
    pe = cuda_nn.pack_ensemble(params)
    x = torch.zeros(5, 64, device=dev)
    with pytest.raises(ValueError):
        cuda_nn.ensemble_cuda(x.double(), pe, (5,), True)
    with pytest.raises(ValueError):
        cuda_nn.ensemble_cuda(x, pe, (4,), True)
    with pytest.raises(ValueError):
        cuda_nn.ensemble_cuda(x, pe, (5, 0), True)


def test_force_step_kernels_match_plain(dev):
    """The whole slice on water(150): kernels against plain versions."""
    water = make_water_box(150, seed=0)
    basis = ANIBasis.ani2x()
    model = ANIModel.from_atomic_numbers(
        water.atomic_numbers, basis, nn_dtype='bfloat16',
        nn_impl='fused').with_blocked_layout(water.positions, water.box,
                                             impl='pallas', skin=0.25)
    params = init_ani_params(torch.Generator(device=dev).manual_seed(0), basis,
                             device=dev)
    cl = model.create_cell_list(water.box, skin=0.25)
    pos = torch.tensor(water.positions, device=dev)
    box = torch.tensor(water.box, device=dev)
    sel = model.select(pos, box, cl)
    _kernels.reset_launch_counts()
    e_k, f_k = model.energy_and_forces_from_selection(params, pos, box, cl, sel)
    assert _kernels.LAUNCHES['angular_aev_fwd'] == 1
    assert _kernels.LAUNCHES['angular_aev_bwd'] == 1
    # One launch set for H and O: each stage once.
    assert all(_kernels.LAUNCHES[k] == 1 for k in FUSED_GRAD_STAGES)
    e_p, f_p = plain_energy_and_forces(model, params, pos, box, cl, sel)
    assert all(_kernels.LAUNCHES[k] == 1 for k in FUSED_GRAD_STAGES)
    np.testing.assert_allclose(float(e_k), float(e_p), rtol=1e-3)
    assert float((f_k - f_p).abs().max()) <= 5e-3 * float(f_p.abs().max())


def window_setup(dev, molecules=150, bucketed=False):
    """A window-path model on water(``molecules``) with a small random
    ensemble, its cell list, positions, box and selection. ``bucketed``
    forces cell-occupancy bucketing with small caps 5 under the planned
    cell caps."""
    water = make_water_box(molecules, seed=0)
    basis = ANIBasis.ani2x()
    model = ANIModel.from_atomic_numbers(
        water.atomic_numbers, basis, nn_dtype='bfloat16',
        nn_impl='fused').with_blocked_layout(water.positions, water.box,
                                             margin=1.15, impl='window',
                                             skin=0.25)
    assert model.aev_impl == 'window'
    cl = model.create_cell_list(water.box, skin=0.25)
    if bucketed:
        caps = model.blocked_layout.cell_caps
        model = dataclasses.replace(model, blocked_layout=dataclasses.replace(
            model.blocked_layout, small_caps=tuple(max(c - 5, 1) for c in caps),
            num_big_cells=cl.num_cells - 4))
    pos = torch.tensor(water.positions, device=dev)
    box = torch.tensor(water.box, device=dev)
    return model, cl, pos, box, model.select(pos, box, cl)


def window_radial_inputs(model, cl, pos, sel):
    """The radial kernel's inputs as ``window_features`` builds them."""
    win, centers = radial_window_inputs(cl, pos, sel, model.blocked_layout)
    return ([w.contiguous() for w in win], centers,
            tuple(model.blocked_layout.cell_caps))


def test_left_pack_kernel_matches_plain(dev):
    rng = np.random.RandomState(7)
    widths, caps = (486, 297), (32, 16)
    keys = np.where(rng.rand(2601, sum(widths)) < rng.uniform(0, 0.1, (2601, 1)),
                    rng.randint(0, 10 ** 6, (2601, sum(widths))), -1)
    keys = torch.tensor(keys.astype(np.int32), device=dev)
    before = _kernels.LAUNCHES['left_pack']
    packed, counts = cuda_select.left_pack(keys, widths, caps)
    assert _kernels.LAUNCHES['left_pack'] == before + 1
    p_packed, p_counts = cuda_select.left_pack_plain(keys, widths, caps)
    assert torch.equal(packed, p_packed)
    assert torch.equal(counts, p_counts)
    assert bool((counts > torch.tensor(caps, device=dev)).any())


# (widths, caps, rows) of the left-pack's edge cases: the 2.6k and 26k
# boxes' angular grids at their row counts, one row, one lane, caps equal
# to the width and of 1, widths that are no multiple of 4 or 32, a block
# of 1,500 lanes (wider than one window of the kernel's lines), three and
# eight (MAX_BLOCKS) blocks, and an empty block.
LEFT_PACK_EDGE_CASES = {
    'water2.6k': ((486, 297), (32, 16), 2601),
    'water26k': ((324, 297), (32, 16), 26010),
    'one-row': ((486, 297), (32, 16), 1),
    'one-lane': ((1,), (1,), 40),
    'cap-is-width': ((33, 7), (33, 1), 300),
    'wide-block': ((1500, 37), (40, 37), 300),
    'three-blocks': ((255, 257, 1033), (32, 1, 257), 300),
    'eight-blocks': ((5, 1, 33, 100, 2, 64, 31, 3),
                     (5, 1, 1, 9, 2, 64, 3, 3), 300),
    'empty-block': ((0, 65), (3, 2), 100),
}


def left_pack_edge_keys(widths, caps, rows, seed):
    """``[rows, W]`` int32 keys: six patterns in which every species block
    holds cap + 1, 0, cap - 1, cap, all and half of its lanes valid (each
    at most the width) at random places, each on up to 32 consecutive rows
    (with an odd W their starts take every offset mod 128 bytes), then
    random rows of densities up to 0.36 up to ``rows``."""
    rng = np.random.RandomState(seed)
    offs = np.cumsum((0,) + tuple(widths))
    rep = max(1, min(32, rows // 6))
    pattern_rows = []
    for pattern in range(6):
        row = np.full(offs[-1], -1, np.int64)
        for s, (w, cap) in enumerate(zip(widths, caps)):
            n = min((cap + 1, 0, max(cap - 1, 0), cap, w, w // 2)[pattern], w)
            row[offs[s] + rng.choice(w, n, replace=False)] = rng.randint(
                0, 10 ** 6, n)
        pattern_rows += [row] * rep
    dens = rng.uniform(0.0, 0.6, (max(rows - len(pattern_rows), 0), 1)) ** 2
    rand = np.where(rng.rand(len(dens), offs[-1]) < dens,
                    rng.randint(0, 10 ** 6, (len(dens), offs[-1])), -1)
    return np.concatenate([np.stack(pattern_rows), rand])[:rows].astype(
        np.int32)


@pytest.mark.parametrize('case', sorted(LEFT_PACK_EDGE_CASES))
def test_left_pack_kernel_edge_cases(dev, case):
    """The left-pack kernel against its plain version, bitwise, at its
    edges: rows with no, cap - 1, cap, cap + 1 and every key valid, at
    every base address mod 128 bytes of the keys (a view into a larger
    buffer) and, with an odd W, every row start mod 128 bytes. Two
    launches are bitwise equal and each wrapper call counts one launch."""
    widths, caps, rows = LEFT_PACK_EDGE_CASES[case]
    keys = left_pack_edge_keys(widths, caps, rows, seed=sum(widths) + rows)
    n, width = keys.shape
    flat = torch.tensor(keys, device=dev).reshape(-1)
    flat = torch.cat([flat, flat[:32]])
    counts_seen = set()
    for shift in range(0, 32, 1 if n * width < 10 ** 6 else 5):
        view = flat[shift:shift + n * width].view(n, width)
        before = _kernels.LAUNCHES['left_pack']
        got = cuda_select.left_pack(view, widths, caps)
        assert _kernels.LAUNCHES['left_pack'] == before + 1
        want = cuda_select.left_pack_plain(view, widths, caps)
        again = cuda_select.left_pack(view, widths, caps)
        for a, b, c in zip(got, want, again):
            assert torch.equal(a, b) and torch.equal(a, c)
        counts_seen.update(got[1].flatten().tolist())
    if n >= 6:
        for w_s, cap in zip(widths, caps):
            assert {0, min(max(cap - 1, 0), w_s), min(cap, w_s),
                    min(cap + 1, w_s), w_s} <= counts_seen


@pytest.mark.parametrize('packed', [False, True],
                         ids=['full-rows', 'center-caps'])
def test_window_radial_kernel_matches_plain(dev, packed):
    model, cl, pos, _, sel = window_setup(dev)
    (cx, cy, cz), centers, caps = window_radial_inputs(model, cl, pos, sel)
    center_caps = None
    if packed:
        center_caps = tuple(max(c - 4, 1) for c in caps)
        offs = np.cumsum((0,) + caps)[:-1]
        centers = torch.cat([centers[:, int(o):int(o) + s]
                             for o, s in zip(offs, center_caps)], 1)
    basis = model.basis
    args = (basis.radial_cutoff, basis.radial_eta, basis.radial_rs, caps,
            basis.torchani)
    ins_k = [t.detach().clone().requires_grad_(True)
             for t in (cx, cy, cz, centers)]
    ins_p = [t.detach().clone().requires_grad_(True)
             for t in (cx, cy, cz, centers)]
    before = dict(_kernels.LAUNCHES)
    out_k = cuda_window.window_radial(*ins_k, *args, center_caps=center_caps)
    out_p = cuda_window.window_radial_plain(*ins_p, *args,
                                            center_caps=center_caps)
    assert (float((out_k - out_p).detach().abs().max())
            <= 1e-5 * float(out_p.detach().abs().max()))
    g_k = torch.autograd.grad(out_k.square().sum(), ins_k)
    g_p = torch.autograd.grad(out_p.square().sum(), ins_p)
    for a, b in zip(g_k, g_p):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    assert _kernels.LAUNCHES['window_radial_fwd'] == before['window_radial_fwd'] + 1
    assert _kernels.LAUNCHES['window_radial_bwd'] == before['window_radial_bwd'] + 1


@pytest.mark.parametrize('bucketed', [False, True],
                         ids=['window', 'bucketed'])
def test_window_step_kernels_match_plain(dev, bucketed):
    """The window path on water(150): one selection and one step through
    the kernels against the step through the plain versions."""
    _kernels.reset_launch_counts()
    model, cl, pos, box, sel = window_setup(dev, bucketed=bucketed)
    assert _kernels.LAUNCHES['left_pack'] == 1
    model.check_overflow(pos, box, cl, sel)
    params = init_ani_params(torch.Generator(device=dev).manual_seed(0),
                             model.basis, device=dev)
    e_k, f_k = model.energy_and_forces_from_selection(params, pos, box, cl, sel)
    tiers = 1 + len(model.blocked_layout.ang_tier_caps or ())
    radial_calls = 2 if bucketed else 1
    assert _kernels.LAUNCHES['window_radial_fwd'] == radial_calls
    assert _kernels.LAUNCHES['window_radial_bwd'] == radial_calls
    assert _kernels.LAUNCHES['angular_aev_fwd'] == tiers
    assert _kernels.LAUNCHES['angular_aev_bwd'] == tiers
    # One launch set for H and O: each stage once.
    assert all(_kernels.LAUNCHES[k] == 1 for k in FUSED_GRAD_STAGES)
    before = dict(_kernels.LAUNCHES)
    e_p, f_p = plain_energy_and_forces(model, params, pos, box, cl, sel)
    assert dict(_kernels.LAUNCHES) == before
    np.testing.assert_allclose(float(e_k), float(e_p), rtol=1e-3)
    assert float((f_k - f_p).abs().max()) <= 5e-3 * float(f_p.abs().max())


def exact_offsets(rc2, step=2.0 ** -20):
    """Two in-plane offsets (dx, dy) on a grid of ``step`` whose squared
    length, rounded as PyTorch rounds ``dx*dx + dy*dy`` in f32, is exactly
    ``f32(rc2)`` (the first) and the float just below it (the second)."""
    big = np.float32(rc2)
    found = []
    for want in (big, np.nextafter(big, np.float32(0))):
        for k in range(1, 4000):
            dy = np.float32(k * 977 * step)
            dy2 = dy * dy
            x0 = int(round(np.sqrt(float(big) - float(dy2)) / step))
            hits = [np.float32(j * step) for j in range(x0 - 4, x0 + 5)
                    if np.float32(j * step) * np.float32(j * step) + dy2
                    == want]
            if hits:
                found.append((hits[0], dy))
                break
    assert len(found) == 2
    return found


def synthetic_windows(caps, w, ncells, rc2, seed, charges=False,
                      modes=('empty-centers', 'full', 'edge')):
    """Window planes ``[ncells, kk]`` and centers ``[ncells, c, 3 or 4]``
    in the kernels' layout (species-major, stencil-entry-major inside a
    species block): run (s, e) holds ``caps[s]`` slots at random places of
    stencil cube e of width ``w``; each slot is occupied with probability
    0.65 (anywhere in its run, not only as a prefix), empty slots at FAR
    (charge 0); center row ``off_s + k`` is slot k of run (s, 13), FAR when
    that slot is empty. The first cells follow ``modes``: no real center
    (every slot of entry 13 empty), every slot occupied, and 'edge': two
    lanes at exactly rc^2 and just inside of row 0's center, then the rest
    of that cell random. The other cells are random. With ``w`` = rc whole
    runs lie beyond the cutoff of a row and others straddle it."""
    rng = np.random.RandomState(seed)
    caps = tuple(caps)
    c = sum(caps)
    offs = np.cumsum((0,) + caps)[:-1]
    kk = 27 * c
    ent = np.arange(27)
    cube = np.stack([ent // 9 - 1, (ent // 3) % 3 - 1, ent % 3 - 1], 1)
    pos = np.full((ncells, kk, 3), cuda_window.FAR, np.float64)
    q = np.zeros((ncells, kk))
    for cell in range(ncells):
        mode = modes[cell] if cell < len(modes) else 'random'
        for s, cs in enumerate(caps):
            for e in range(27):
                lo = 27 * offs[s] + e * cs
                occ = rng.rand(cs) < 0.65
                if mode == 'full':
                    occ[:] = True
                if mode == 'empty-centers' and e == 13:
                    occ[:] = False
                n = int(occ.sum())
                pos[cell, lo:lo + cs][occ] = (cube[e] + rng.rand(n, 3)) * w
                q[cell, lo:lo + cs][occ] = rng.uniform(-0.8, 0.8, n)
        if mode == 'edge':
            self0 = 13 * caps[0]
            pos[cell, self0] = (1.0, 1.0, 1.0)
            q[cell, self0] = 0.7
            for k, (dx, dy) in enumerate(exact_offsets(rc2)):
                pos[cell, 14 * caps[0] + k] = (1.0 + dx, 1.0 + dy, 1.0)
                q[cell, 14 * caps[0] + k] = 0.5
    pos = pos.astype(np.float32)
    self_lanes = np.concatenate([27 * o + 13 * cs + np.arange(cs)
                                 for o, cs in zip(offs, caps)])
    centers = pos[:, self_lanes]
    planes = [pos[:, :, a] for a in range(3)]
    if charges:
        planes.append(q.astype(np.float32))
        centers = np.concatenate([centers, q[:, self_lanes, None]], 2)
    return ([torch.tensor(np.ascontiguousarray(x)) for x in planes],
            torch.tensor(np.ascontiguousarray(centers, np.float32)))


def normwise_close(got, want, rtol):
    return (float((got - want).detach().abs().max())
            <= rtol * float(want.detach().abs().max()))


RADIAL_EDGE_CASES = {
    # (basis, cell_caps, packed center_caps)
    'ani2x': (ANIBasis.ani2x(), (7, 4), (4, 2)),
    'small': (small_basis(True), (5, 3, 4), (3, 2, 2)),
}


@pytest.mark.parametrize('ncells', [6, 140])
@pytest.mark.parametrize('packed', [False, True],
                         ids=['full-rows', 'center-caps'])
@pytest.mark.parametrize('torchani', [True, False],
                         ids=['torchani', 'publication'])
@pytest.mark.parametrize('case', sorted(RADIAL_EDGE_CASES))
def test_window_radial_kernel_edge_cells(dev, case, torchani, packed,
                                         ncells):
    """The window radial kernel against its plain version on synthetic
    windows at its edges (a cell with no real center, a full cell, lanes at
    exactly rc^2 and just inside, whole runs beyond the cutoff and runs
    that straddle it, randomly placed empty slots; full and packed center
    rows; fewer cells than SMs and more), forward and gradient at the
    gates, and two launches of each direction bitwise equal."""
    basis, caps, small = RADIAL_EDGE_CASES[case]
    basis = dataclasses.replace(basis, torchani=torchani)
    rc = basis.radial_cutoff
    (cx, cy, cz), centers = synthetic_windows(caps, rc, ncells, rc * rc,
                                              seed=ncells)
    center_caps = None
    if packed:
        center_caps = small
        offs = np.cumsum((0,) + caps)[:-1]
        centers = torch.cat([centers[:, int(o):int(o) + n]
                             for o, n in zip(offs, small)], 1)
    args = (rc, basis.radial_eta, basis.radial_rs, caps, basis.torchani)
    planes = [t.to(dev) for t in (cx, cy, cz, centers)]
    real = planes[3][:, :, 0] < cuda_window.EMPTY_ROW
    assert real.any() and not real[0].any()
    ins_k = [t.clone().requires_grad_(True) for t in planes]
    ins_p = [t.clone().requires_grad_(True) for t in planes]
    out_k = cuda_window.window_radial(*ins_k, *args, center_caps=center_caps)
    out_p = cuda_window.window_radial_plain(*ins_p, *args,
                                            center_caps=center_caps)
    assert normwise_close(out_k, out_p, 1e-5)
    assert torch.count_nonzero(out_k[~real]) == 0
    g = torch.rand(out_p.shape, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(2))
    g_k = torch.autograd.grad(out_k, ins_k, g)
    g_p = torch.autograd.grad(out_p, ins_p, g)
    for a, b in zip(g_k, g_p):
        assert bool(torch.isfinite(a).all())
        assert normwise_close(a, b, 1e-4)
    spec = cuda_window._spec(
        caps, center_caps, float(rc), tuple(basis.radial_eta),
        tuple(basis.radial_rs), bool(torchani))
    first = cuda_window.window_radial_fwd_cuda(*planes, spec)
    assert torch.equal(first, cuda_window.window_radial_fwd_cuda(*planes,
                                                                 spec))
    first = cuda_window.window_radial_bwd_cuda(*planes, g, spec)
    again = cuda_window.window_radial_bwd_cuda(*planes, g, spec)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def pme_edge_excl(planes, centers, ncells3, num_excl, cutoff, seed):
    """Exclusion slot ids ``[ncells, c, num_excl]``: for every real row a
    lane inside the cutoff (its slot id), and with two columns a random
    slot id of the window in the second; -1 elsewhere."""
    rng = np.random.RandomState(seed)
    ncells, c = centers.shape[:2]
    slot = cuda_pme._lane_slots(ncells3, c, 'cpu').numpy()
    d2 = sum((planes[a].numpy()[:, None, :] - centers.numpy()[:, :, a:a + 1])
             ** 2 for a in range(3))
    excl = np.full((ncells, c, num_excl), -1, np.int32)
    for cell in range(ncells):
        for row in range(c):
            if centers[cell, row, 0] >= cuda_pme.EMPTY_ROW:
                continue
            inside = np.flatnonzero((d2[cell, row] < cutoff ** 2)
                                    & (slot[cell] != cell * c + row))
            if len(inside):
                excl[cell, row, 0] = slot[cell, rng.choice(inside)]
            if num_excl == 2:
                excl[cell, row, 1] = slot[cell, rng.randint(27 * c)]
    return torch.tensor(excl)


@pytest.mark.parametrize('grid', [(3, 3, 3), (6, 5, 5)])
@pytest.mark.parametrize('num_excl', [1, 2])
def test_pme_window_kernel_edge_cells(dev, num_excl, grid):
    """The PME window kernel against its plain version on synthetic windows
    at its edges (a cell with no real center, a full cell, lanes at
    exactly rc^2 and just inside, whole runs beyond the cutoff and runs
    that straddle it, randomly placed empty slots; one exclusion column
    naming a lane inside the cutoff, and a second of random slots; fewer
    cells than SMs and more), energy and gradients at the gates, and two
    launches of each direction bitwise equal."""
    cutoff, alpha, coulomb = 5.0, 0.6, 1389.35457
    ncells = int(np.prod(grid))
    planes, centers = synthetic_windows((6,), cutoff, ncells, cutoff ** 2,
                                        seed=num_excl, charges=True)
    excl = pme_edge_excl(planes, centers, grid, num_excl, cutoff, seed=3)
    planes = [t.to(dev) for t in (*planes, centers)]
    excl = excl.to(dev)
    real = planes[4][:, :, 0] < cuda_pme.EMPTY_ROW
    assert real.any() and not real[0].any()
    args = (grid, cutoff, alpha, coulomb)
    ins_k = [t.clone().requires_grad_(True) for t in planes]
    ins_p = [t.clone().requires_grad_(True) for t in planes]
    out_k = cuda_pme.pme_window(*ins_k, excl, *args)
    out_p = cuda_pme.pme_window_plain(*ins_p, excl, *args)
    np.testing.assert_allclose(float(out_k.detach().sum()),
                               float(out_p.detach().sum()), rtol=1e-5)
    assert normwise_close(out_k, out_p, 1e-5)
    assert torch.count_nonzero(out_k[~real]) == 0
    g = torch.randn(out_p.shape, generator=torch.Generator(device=dev)
                    .manual_seed(0), device=dev)
    g_k = torch.autograd.grad(out_k, ins_k, g)
    g_p = torch.autograd.grad(out_p, ins_p, g)
    for a, b in zip(g_k, g_p):
        assert bool(torch.isfinite(a).all())
        assert normwise_close(a, b, 1e-4)
    spec = cuda_pme._PmeSpec(grid, centers.shape[1], num_excl, cutoff, alpha,
                             coulomb)
    first = cuda_pme.pme_window_fwd_cuda(*planes, excl, spec)
    assert torch.equal(first, cuda_pme.pme_window_fwd_cuda(*planes, excl,
                                                           spec))
    first = cuda_pme.pme_window_bwd_cuda(*planes, excl, g, spec)
    again = cuda_pme.pme_window_bwd_cuda(*planes, excl, g, spec)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def spread(a, b):
    """max |a - b| over max |b|: the run-to-run spread of two launches."""
    return float((a - b).abs().max()) / float(b.abs().max())


# B.2, B.3 and B.5 sum in a fixed order: their spreads are 0. The forces of
# two identical window steps still differ in their last bits (ROADMAP
# section C): on an NVIDIA H100 80GB HBM3 their spread measured 1.2e-7 with
# those three kernels at 0, which leaves autograd's adjoints of the step's
# gathers (index_select backward runs index_add_, which adds with atomics
# on a CUDA tensor). The bound holds the forces only.
ATOMIC_SPREAD_BOUND = 1e-5


def test_atomic_backwards_spread_is_bounded(dev):
    """B.2's and B.3's backward and B.5's forward and backward launched
    twice on the same inputs (the window path's shapes on water(150), and
    PME on water(150) with the intramolecular exclusions), and the forces
    of two identical window steps: B.2, B.3 and B.5 are bitwise
    repeatable, the spread of the forces is bounded, and B.4's part of the
    step is bitwise repeatable."""
    model, cl, pos, box, sel = window_setup(dev)
    (cx, cy, cz), centers, caps = window_radial_inputs(model, cl, pos, sel)
    basis = model.basis
    args = (basis.radial_cutoff, basis.radial_eta, basis.radial_rs, caps,
            basis.torchani)

    def radial_grads():
        ins = [t.detach().clone().requires_grad_(True)
               for t in (cx, cy, cz, centers)]
        out = cuda_window.window_radial(*ins, *args)
        return torch.autograd.grad(out.square().sum(), ins)

    angulars = []
    params = init_ani_params(torch.Generator(device=dev).manual_seed(0),
                             basis, device=dev)
    with recording(cuda_aev, 'angular_aev', angulars):
        model.energy_and_forces_from_selection(params, pos, box, cl, sel)

    def angular_grads():
        out = []
        for a, _ in angulars:
            d = a[0].detach().clone().requires_grad_(True)
            res = cuda_aev.angular_aev(d, a[1], *a[2:5])
            out += torch.autograd.grad(res.square().sum(), d)
        return out

    _, pme, plan, (ppos, q, pbox) = pme_setup(dev, 2)
    *planes, excl = cuda_pme.pme_window_inputs(ppos, q, pbox, pme.exclusions,
                                               *plan)
    planes = [t.detach().contiguous() for t in planes]
    pspec = cuda_pme._PmeSpec(plan[0], plan[1], excl.shape[2], 5.0, 0.6,
                              1389.35457)
    pg = torch.randn(planes[4].shape[:2], device=dev,
                     generator=torch.Generator(device=dev).manual_seed(4))

    spreads = {}
    for name, fn in (
            ('B.2 bwd', radial_grads), ('B.3 bwd', angular_grads),
            ('B.5 fwd', lambda: [cuda_pme.pme_window_fwd_cuda(
                *planes, excl, pspec)]),
            ('B.5 bwd', lambda: cuda_pme.pme_window_bwd_cuda(
                *planes, excl, pg, pspec))):
        first, again = fn(), fn()
        spreads[name] = max(spread(a, b) for a, b in zip(again, first))
    _, f1 = model.energy_and_forces_from_selection(params, pos, box, cl, sel)
    _, f2 = model.energy_and_forces_from_selection(params, pos, box, cl, sel)
    spreads['window step forces'] = spread(f2, f1)
    print(f'two-launch spreads (max|diff| / max|value|): {spreads}')
    for name in ('B.2 bwd', 'B.3 bwd', 'B.5 fwd', 'B.5 bwd'):
        assert spreads[name] == 0, spreads
    assert spreads['window step forces'] <= ATOMIC_SPREAD_BOUND, spreads


def pme_setup(dev, num_excl, molecules=150):
    """PME on water(``molecules``) with ``num_excl`` exclusions per atom: 0,
    1 (all -1, as config 5 passes) or 2 (the intramolecular partners)."""
    water = make_water_box(molecules, seed=0)
    n = len(water.positions)
    excl = np.full((n, num_excl), -1, np.int32)
    if num_excl == 2:
        for m in range(n // 3):
            o, h1, h2 = 3 * m, 3 * m + 1, 3 * m + 2
            excl[o], excl[h1], excl[h2] = [h1, h2], [o, h2], [o, h1]
    pme = PME(16, 16, 16, 5, 0.6, 1389.35457, excl, device=dev)
    plan = pme.plan_direct_window(water.box, 5.0, water.positions)
    tensors = (torch.tensor(water.positions, device=dev),
               0.2 * torch.tensor(water.charges, device=dev),
               torch.tensor(water.box, device=dev))
    return water, pme, plan, tensors


@pytest.mark.parametrize('num_excl', [0, 1, 2])
def test_pme_window_kernel_matches_plain(dev, num_excl):
    _, pme, plan, (pos, q, box) = pme_setup(dev, num_excl)
    ncells3, cap = plan
    *planes, excl = cuda_pme.pme_window_inputs(pos, q, box, pme.exclusions,
                                               ncells3, cap)
    assert excl.shape[2] == max(num_excl, 1)
    args = (ncells3, 5.0, 0.6, 1389.35457)
    ins_k = [t.detach().clone().requires_grad_(True) for t in planes]
    ins_p = [t.detach().clone().requires_grad_(True) for t in planes]
    before = dict(_kernels.LAUNCHES)
    out_k = cuda_pme.pme_window(*ins_k, excl, *args)
    out_p = cuda_pme.pme_window_plain(*ins_p, excl, *args)
    np.testing.assert_allclose(float(out_k.detach().sum()),
                               float(out_p.detach().sum()),
                               rtol=1e-5)
    assert (float((out_k - out_p).detach().abs().max())
            <= 1e-5 * float(out_p.detach().abs().max()))
    g = torch.randn(out_p.shape, generator=torch.Generator(device=dev)
                    .manual_seed(0), device=dev)
    g_k = torch.autograd.grad(out_k, ins_k, g)
    g_p = torch.autograd.grad(out_p, ins_p, g)
    for a, b in zip(g_k, g_p):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    assert _kernels.LAUNCHES['pme_window_fwd'] == before['pme_window_fwd'] + 1
    assert _kernels.LAUNCHES['pme_window_bwd'] == before['pme_window_bwd'] + 1


def test_pme_direct_bucketed_plan_matches_plain(dev):
    """A forced bucketed 4-tuple plan with real exclusions: the direct
    energy and its position and charge gradients through the kernel against
    the plain version, and against the unbucketed plan."""
    water, pme, plan, (pos, q, box) = pme_setup(dev, 2, molecules=867)
    bplan = (plan[0], plan[1], max(8, plan[1] - 8), plan[0][0] ** 3 // 2)
    assert int(pme.direct_window_overflow(pos, box, bplan)) <= plan[1]

    def run(p_plan, plain):
        p = pos.clone().requires_grad_(True)
        qq = q.clone().requires_grad_(True)
        e = pme.compute_direct_window(p, qq, 5.0, box, p_plan, plain=plain)
        return (e.detach(), *torch.autograd.grad(e, (p, qq)))

    got, want, flat = run(bplan, False), run(bplan, True), run(plan, False)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    for a, b in zip(got, flat):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_combined_step_kernels_match_plain(dev):
    """ANI + PME on water(150): one step through every kernel against the
    same step through the plain versions."""
    water, pme, _, (pos, q, box) = pme_setup(dev, 1)
    ani = ANIModel.from_atomic_numbers(
        water.atomic_numbers, ANIBasis.ani2x(), nn_dtype='bfloat16',
        nn_impl='fused').with_blocked_layout(water.positions, water.box,
                                             impl='window', skin=0.25)
    ff = ANIWithPME.create(ani, pme, 5.0, positions=water.positions,
                           box=water.box)
    cl = ani.create_cell_list(water.box, skin=0.25)
    params = init_ani_params(torch.Generator(device=dev).manual_seed(0),
                             ani.basis, device=dev)
    sel = ff.select(pos, box, cl)
    ff.check_overflow(pos, q, box, cl, sel)
    _kernels.reset_launch_counts()
    e_k, f_k = ff.energy_and_forces_from_selection(params, pos, q, box, cl,
                                                   sel)
    assert _kernels.LAUNCHES['pme_window_fwd'] == 1
    assert _kernels.LAUNCHES['pme_window_bwd'] == 1
    assert _kernels.LAUNCHES['window_radial_bwd'] >= 1
    before = dict(_kernels.LAUNCHES)
    e_p, f_p = combined_plain(ff, params, pos, q, box, cl, sel)
    assert dict(_kernels.LAUNCHES) == before
    np.testing.assert_allclose(float(e_k), float(e_p), rtol=1e-3)
    assert float((f_k - f_p).abs().max()) <= 5e-3 * float(f_p.abs().max())


def cfconv_config(activation='ssp', width=128, num_gaussians=50):
    return CFConvConfig(width=width, num_gaussians=num_gaussians,
                        cutoff=10.0, gaussian_width=10.0 / (num_gaussians - 1),
                        activation=activation)


def cfconv_inputs(dev, cfg, k, n=37, seed=0, row_counts=()):
    """Random backward inputs: about 60 % of the lanes valid, row 5 all
    masked, random biases; row r of ``row_counts`` gets exactly
    ``row_counts[r]`` valid lanes at random places."""
    rng = np.random.RandomState(seed)
    mask = rng.rand(n, k) < 0.6
    mask[5] = False
    for r, count in enumerate(row_counts):
        mask[r] = False
        mask[r, rng.choice(k, count, replace=False)] = True
    dist = np.where(mask, rng.uniform(0.5, 9.9, (n, k)), 0.0)
    idx = np.where(mask, rng.randint(0, n, (n, k)), n)
    w = cfg.width
    params = init_cfconv(torch.Generator().manual_seed(seed), cfg,
                         device='cpu')
    params = params._replace(b1=torch.tensor(0.1 * rng.randn(w)).float(),
                             b2=torch.tensor(0.1 * rng.randn(w)).float())
    tensors = (torch.tensor(dist, dtype=torch.float32),
               torch.tensor(mask), torch.tensor(idx, dtype=torch.int32),
               torch.tensor(rng.randn(n, w), dtype=torch.float32),
               torch.tensor(rng.randn(n, w), dtype=torch.float32))
    return (tuple(a.to(dev) for a in params),
            tuple(a.to(dev) for a in tensors))


def assert_cfconv_bwd_close(got, want):
    """Normwise: d_dist and d_x to 1e-4, the weight gradients (sums over
    every pair), where computed, to 1e-3 of the reference's scale."""
    (gw, gd, gx), (ww, wd, wx) = got, want
    assert (gw is None) == (ww is None)
    for a, b, tol in [(gd, wd, 1e-4), (gx, wx, 1e-4)] + [
            (a, b, 1e-3) for a, b in zip(gw or (), ww or ())]:
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def check_cfconv_bwd(params, dist, mask, idx, x, g, cfg, weight_grads):
    """One launch of B.6, or of its forces-only kernel without
    ``weight_grads`` (and none of the other), against the plain version;
    masked lanes exactly 0; two launches bitwise equal; the forces-only
    kernel's d_dist and d_x bitwise the full kernel's (the same products
    and f32 epilogues, in the same order). Returns (kernel, plain)."""
    names = ('cfconv_bwd', 'cfconv_bwd_forces')
    before = [_kernels.LAUNCHES[k] for k in names]
    got = cuda_cfconv.cfconv_bwd(params, dist, mask, idx, x, g, cfg,
                                 weight_grads=weight_grads)
    assert [_kernels.LAUNCHES[k] - b for k, b in zip(names, before)] == [
        int(weight_grads), int(not weight_grads)]
    want = cuda_cfconv.cfconv_bwd_plain(params, dist, mask, idx, x, g, cfg,
                                        weight_grads=weight_grads)
    assert_cfconv_bwd_close(got, want)
    assert not bool(got[1][~mask].any())          # masked lanes exactly 0
    again = cuda_cfconv.cfconv_bwd(params, dist, mask, idx, x, g, cfg,
                                   weight_grads=weight_grads)
    for a, b in zip((*(got[0] or ()), *got[1:]),
                    (*(again[0] or ()), *again[1:])):
        assert torch.equal(a, b)                  # deterministic
    if not weight_grads:
        _, d_dist, d_x = cuda_cfconv.cfconv_bwd(params, dist, mask, idx, x,
                                                g, cfg)
        assert torch.equal(got[1], d_dist) and torch.equal(got[2], d_x)
    return got, want


WEIGHT_GRADS = pytest.mark.parametrize('weight_grads', [True, False],
                                       ids=['full', 'forces'])


@WEIGHT_GRADS
@pytest.mark.parametrize('k', [100, 640])
@pytest.mark.parametrize('activation', ['ssp', 'tanh'])
def test_cfconv_bwd_kernel_matches_plain(dev, k, activation, weight_grads):
    cfg = cfconv_config(activation)
    params, (dist, mask, idx, x, g) = cfconv_inputs(dev, cfg, k)
    got, _ = check_cfconv_bwd(params, dist, mask, idx, x, g, cfg,
                              weight_grads)
    assert not bool(got[1][5].any()) and not bool(got[2][5].any())


@WEIGHT_GRADS
@pytest.mark.parametrize('width', [32, 64])
def test_cfconv_bwd_kernel_other_widths(dev, width, weight_grads):
    cfg = cfconv_config('ssp', width=width, num_gaussians=8)
    params, (dist, mask, idx, x, g) = cfconv_inputs(dev, cfg, 64, n=50)
    check_cfconv_bwd(params, dist, mask, idx, x, g, cfg, weight_grads)
    with pytest.raises(ValueError, match='width'):
        cuda_cfconv.cfconv_bwd(params, dist, mask, idx, x, g,
                               cfconv_config(width=48),
                               weight_grads=weight_grads)


@WEIGHT_GRADS
def test_cfconv_bwd_kernel_tile_edges(dev, weight_grads):
    """Rows with 0, 1, 63, 64, 65 and 129 valid lanes (the 64-pair tiles'
    edges and the empty row), 300 rows (not a multiple of the SM count,
    so blocks take 2 or 3 rows) and exactly 64 Gaussians (no padded
    Gaussian column): against the plain version, masked lanes exactly 0,
    two launches bitwise equal."""
    cfg = cfconv_config('ssp', num_gaussians=64)
    params, (dist, mask, idx, x, g) = cfconv_inputs(
        dev, cfg, 160, n=300, seed=2, row_counts=(0, 1, 63, 64, 65, 129))
    assert 300 % torch.cuda.get_device_properties(dev).multi_processor_count
    got, want = check_cfconv_bwd(params, dist, mask, idx, x, g, cfg,
                                 weight_grads)
    assert not bool(got[2][0].any())
    for r in range(1, 6):              # every row's d_x, row by row
        assert_normwise(got[2][r], want[2][r], 1e-4)


@pytest.mark.parametrize('width,num_gaussians', [(32, 7), (64, 64),
                                                  (128, 50)])
@pytest.mark.parametrize('activation', ['ssp', 'tanh'])
def test_cfconv_fwd_kernel_matches_plain(dev, activation, width,
                                         num_gaussians):
    """The fused forward against ``conv_fwd_plain`` in float32 at K = 640,
    300 rows: normwise 1e-6 over all rows and row by row on rows with 0,
    1, 63, 64, 65 and 129 valid lanes (the 64-pair tiles' edges; the other
    rows cross six tiles), masked lanes carrying nonzero distances and
    real neighbors; the empty row exactly 0; one launch; two launches
    bitwise equal."""
    cfg = cfconv_config(activation, width=width, num_gaussians=num_gaussians)
    params, (dist, mask, idx, x, _) = cfconv_inputs(
        dev, cfg, 640, n=300, seed=3, row_counts=(0, 1, 63, 64, 65, 129))
    rng = np.random.RandomState(4)
    dist = torch.where(mask, dist, torch.tensor(
        rng.uniform(0.5, 9.9, mask.shape), dtype=torch.float32).to(dev))
    idx = torch.where(mask, idx, torch.tensor(
        rng.randint(0, 300, mask.shape), dtype=torch.int32).to(dev))
    before = _kernels.LAUNCHES['cfconv_fwd']
    got = cuda_cfconv.cfconv_fwd(params, dist, mask, idx, x, cfg)
    assert _kernels.LAUNCHES['cfconv_fwd'] == before + 1
    want = cuda_cfconv.conv_fwd_plain(params, dist, mask, idx, x, cfg)
    assert_normwise(got, want, 1e-6)
    assert not bool(got[0].any())
    for r in range(1, 6):
        assert_normwise(got[r], want[r], 1e-6)
    assert torch.equal(cuda_cfconv.cfconv_fwd(params, dist, mask, idx, x,
                                              cfg), got)
    with pytest.raises(ValueError, match='width'):
        cuda_cfconv.cfconv_fwd(params, dist, mask, idx, x,
                               cfconv_config(width=48))
    with pytest.raises(ValueError, match='float32'):
        cuda_cfconv.cfconv_fwd(params, dist, mask, idx, x, cfg,
                               dtype=torch.bfloat16)


def test_cfconv_stack_kernel_matches_plain(dev):
    """A chunked 2-layer stack over the scatter-free distance payload on
    water(300) at width 128 and a 6 A cutoff: value, position, input and
    weight gradients through the kernels (one forward and one backward
    launch a layer) against the plain forward and backward."""
    water = make_water_box(300, seed=4)
    cfg = CFConvConfig(width=128, num_gaussians=50, cutoff=6.0,
                       gaussian_width=6.0 / 49)
    stack = CFConvStack(cfg, num_layers=2)
    params = stack.init(torch.Generator().manual_seed(3), device=dev)
    cl = CellList.create(water.box, cfg.cutoff, capacity=128)
    box = torch.tensor(water.box, device=dev)
    x = torch.randn(len(water.positions), 128,
                    generator=torch.Generator().manual_seed(1)).to(dev)

    def run(plain):
        p = torch.tensor(water.positions, device=dev).requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        prm = [tuple(a.clone().requires_grad_(True) for a in q)
               for q in params]
        sel = cl.select(p, box, build_mirror=True)
        assert int(sel.max_neighbors) <= cl.capacity
        d, idx, m = cl.payload_distances_from_selection(p, box, sel)
        v = stack.apply_distances(prm, d, idx, m, xx, chunk_size=256,
                                  plain=plain).sum()
        return (v.detach(), *torch.autograd.grad(
            v, [p, xx] + [a for q in prm for a in q]))

    _kernels.reset_launch_counts()
    got = run(False)
    assert _kernels.LAUNCHES['cfconv_bwd'] == 2
    assert _kernels.LAUNCHES['cfconv_fwd'] == 2
    want = run(True)
    assert _kernels.LAUNCHES['cfconv_bwd'] == 2
    assert _kernels.LAUNCHES['cfconv_fwd'] == 2
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    for a, b in zip(got[1:], want[1:]):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


def test_schnet_force_call_takes_forces_kernel(dev):
    """SchNet's MD force call (``select``, then
    ``energy_and_forces_from_selection``) on water(300) at width 128, 50
    Gaussians and a 6 A cutoff: its weights need no gradient, so each
    layer's backward is one forces-only launch and no full one; the forces
    within 1e-5 normwise of the same call with the CFConv weights
    requiring grad, which takes the full kernel."""
    water = make_water_box(300, seed=4)
    cfg = CFConvConfig(width=128, num_gaussians=50, cutoff=6.0,
                       gaussian_width=6.0 / 49)
    model = SchNetModel.from_atomic_numbers(water.atomic_numbers, cfg,
                                            elements=(1, 8),
                                            num_interactions=2)
    params = model.init(torch.Generator().manual_seed(5), device=dev)
    box = torch.tensor(water.box, device=dev)
    pos = torch.tensor(water.positions, device=dev)
    cl = model.create_cell_list(water.box)
    sel = model.select(pos, box, cl)
    trained = params._replace(interactions=tuple(
        b._replace(conv=CFConvParams(*(a.detach().clone().requires_grad_(True)
                                       for a in b.conv)))
        for b in params.interactions))
    launches = []
    for prm in (params, trained):
        _kernels.reset_launch_counts()
        e, f = model.energy_and_forces_from_selection(prm, pos, box, cl, sel)
        launches.append((_kernels.LAUNCHES['cfconv_bwd_forces'],
                         _kernels.LAUNCHES['cfconv_bwd']))
        if prm is params:
            e_forces, f_forces = e, f
    assert launches == [(2, 0), (0, 2)]
    np.testing.assert_allclose(float(e_forces), float(e), rtol=1e-6)
    assert float(f.abs().max()) > 0
    assert_normwise(f_forces, f, 1e-5)


def painn_system(dev, waters, seed=0):
    """PaiNN at its published widths (128, 20 radial functions, 5 A, 3
    blocks) on water(``waters``): (model, params, cell list, positions,
    box) on ``dev``."""
    water = make_water_box(waters, seed=seed)
    model = PaiNNModel.from_atomic_numbers(water.atomic_numbers,
                                           PaiNNConfig(), elements=(1, 8))
    params = model.init(torch.Generator().manual_seed(5), device=dev)
    cl = model.create_cell_list(water.box, skin=0.25)
    return (model, params, cl, torch.tensor(water.positions, device=dev),
            torch.tensor(water.box, device=dev))


def test_painn_force_call_matches_cpu_and_repeats(dev):
    """PaiNN's MD force call on water(300): the card's energy within 1e-6
    and forces within 1e-5 normwise of the same call on the CPU, and two
    calls on the card bitwise equal (the message's and the deltas
    payload's adjoints are scatter-free: no atomics)."""
    cpu = torch.device('cpu')
    out = {}
    for d in (dev, cpu):
        model, params, cl, pos, box = painn_system(d, 300)
        sel = model.select(pos, box, cl)
        out[d.type] = [model.energy_and_forces_from_selection(
            params, pos, box, cl, sel) for _ in range(2 if d == dev else 1)]
    (e1, f1), (e2, f2) = out['cuda']
    (e_cpu, f_cpu), = out['cpu']
    assert float(e1) == float(e2) and torch.equal(f1, f2)
    np.testing.assert_allclose(float(e1), float(e_cpu), rtol=1e-6)
    assert float(f_cpu.abs().max()) > 0
    assert_normwise(f1.cpu(), f_cpu, 1e-5)


def test_painn_force_call_26k(dev):
    """PaiNN's MD force call at 26,010 atoms: finite, every count within
    its capacity, the backward kernel launched once a message; the energy
    within 1e-6 and the forces within 1e-5 normwise of the same call on the
    CPU (the plain chunked backward); prints the force call's time and the
    peak memory."""
    model, params, cl, pos, box = painn_system(dev, 8670)
    sel = model.select(pos, box, cl)
    counts = model.overflow_counts(pos, box, cl, sel)
    for k, cap in model.capacities(cl).items():
        assert 0 < int(counts[k]) <= cap, k
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    e, f = model.energy_and_forces_from_selection(params, pos, box, cl, sel)
    end.record()
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES['painn_bwd'] == 3
    assert bool(torch.isfinite(e)) and bool(torch.isfinite(f).all())
    assert float(f.abs().max()) > 0
    print(f'PaiNN 26k force call {start.elapsed_time(end):.1f} ms, peak '
          f'{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, K '
          f'{cl.capacity}, counts {dict((k, int(v)) for k, v in counts.items())}')
    model, params, cl, pos, box = painn_system(torch.device('cpu'), 8670)
    e_cpu, f_cpu = model.energy_and_forces_from_selection(
        params, pos, box, cl, model.select(pos, box, cl))
    err = float((f.cpu() - f_cpu).abs().max() / f_cpu.abs().max())
    print(f'PaiNN 26k against the CPU: energy {float(e)} / {float(e_cpu)}, '
          f'forces normwise {err:.3g}')
    np.testing.assert_allclose(float(e), float(e_cpu), rtol=1e-6)
    assert_normwise(f.cpu(), f_cpu, 1e-5)


def test_painn_force_call_takes_bwd_kernel(dev):
    """A 3-block PaiNN force call on the card launches the fused backward
    once a message and never runs the plain chunked backward."""
    model, params, cl, pos, box = painn_system(dev, 300)
    sel = model.select(pos, box, cl)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    calls = []
    with recording(painn_ops, '_rows_backward', calls):
        _, f = model.energy_and_forces_from_selection(params, pos, box, cl,
                                                      sel)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES['painn_bwd'] == 3 and not calls
    assert bool(torch.isfinite(f).all()) and float(f.abs().max()) > 0


def painn_lanes(dev, waters=300):
    """PaiNN's lanes on water(``waters``) at its published widths: (config,
    d, u, idx (int64), mask, live) and the first block's filter (w, b)."""
    model, params, cl, pos, box = painn_system(dev, waters)
    sel = model.select(pos, box, cl)
    deltas, idx, mask = cl.payload_deltas_from_selection(pos, box, sel)
    d, u = lane_geometry(deltas, mask)
    live = mask & (d < model.config.cutoff)
    filt = params.blocks[0].message.filter
    return model.config, d, u, idx.long(), mask, live, filt.w, filt.b


def painn_bwd_inputs(n, f, dev, seed, v_zero=False):
    """Random (phi_pad, v_pad) [n + 1, 3f], each ending in a zero row (v
    zero throughout with ``v_zero``, as in the first block), and cotangents
    gs [n, f], gv [n, 3, f]."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    phi, v = rand(n, 3 * f), rand(n, 3 * f)
    if v_zero:
        v.zero_()
    return _pad_row(phi), _pad_row(v), rand(n, f), rand(n, 3, f)


def check_painn_bwd(args, rtol=1e-5):
    """The kernel (one launch) against the plain ``_rows_backward`` over all
    rows in float64 on the card: dd, du, dphi and dv within ``rtol`` of
    their largest; two launches bitwise equal. Returns the kernel's."""
    phi_pad, v_pad, d, u, idx, live, wf, bf, gs, gv, rc = args
    n, f = gs.shape
    _kernels.reset_launch_counts()
    got = painn_ops.painn_bwd_cuda(*args)
    assert _kernels.LAUNCHES['painn_bwd'] == 1
    want = painn_ops._rows_backward(
        slice(0, n), phi_pad.double(), v_pad.double(), _pad_row(gs.double()),
        _pad_row(gv.reshape(n, 3 * f).double()), d.double(), u.double(), idx,
        live, wf.double(), bf.double(), rc)
    for name, a, b in zip(('dd', 'du', 'dphi', 'dv'), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert float(b.abs().max()) > 0, name
        err = float((a.double() - b).abs().max() / b.abs().max())
        assert err <= rtol, (name, err)
    again = painn_ops.painn_bwd_cuda(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return got


@pytest.mark.parametrize('v_zero', [True, False])
def test_painn_bwd_kernel_matches_plain(dev, v_zero):
    """The fused backward on water(300) at F 128, K 128, R 20 against the
    plain chunked backward's arithmetic, with v = 0 (block 1) and v random:
    within 1e-5 normwise, two launches bitwise equal."""
    config, d, u, idx, mask, live, wf, bf = painn_lanes(dev)
    n, f = d.shape[0], config.width
    assert (f, d.shape[1], wf.shape[0]) == (128, 128, 20)
    phi_pad, v_pad, gs, gv = painn_bwd_inputs(n, f, dev, 3, v_zero)
    check_painn_bwd((phi_pad, v_pad, d, u, idx, live, wf, bf, gs, gv,
                     float(config.cutoff)))


def test_painn_bwd_kernel_edge_lanes(dev):
    """Exact zeros in dd and du on padded lanes, on skin lanes (rc <= d <
    rc + skin) and on a live lane whose neighbor is the padding row, and
    zero dphi and dv on rows with no live lane; the rest as the plain."""
    config, d, u, idx, mask, live, wf, bf = painn_lanes(dev)
    n, f = d.shape[0], config.width
    rc = float(config.cutoff)
    skin = mask & ~live
    assert bool((~mask).any()) and bool(skin.any())
    live = live.clone()
    live[[0, 7, n - 1]] = False              # rows with no live lane
    idx = idx.clone()
    lane = int(torch.nonzero(live[5])[0])
    idx[5, lane] = n                         # a live lane on the padding row
    phi_pad, v_pad, gs, gv = painn_bwd_inputs(n, f, dev, 5)
    dd, du, dphi, dv = check_painn_bwd((phi_pad, v_pad, d, u, idx, live, wf,
                                        bf, gs, gv, rc))
    zero = ~live
    zero[5, lane] = True
    assert bool((dd[zero] == 0).all()) and bool((du[zero] == 0).all())
    for row in (0, 7, n - 1):
        assert bool((dphi[row] == 0).all()) and bool((dv[row] == 0).all())


@pytest.mark.parametrize('k', [100, 37])
def test_painn_bwd_kernel_second_width(dev, k):
    """At F 64 (two warps a block) and a K that is no multiple of the
    kernel's 32-lane tiles: water(300)'s first ``k`` lanes, random phi, v,
    filter and cotangents, against the plain."""
    config, d, u, idx, mask, live, _, _ = painn_lanes(dev)
    n, f, r = d.shape[0], 64, config.num_radial
    gen = torch.Generator(device=dev).manual_seed(6)
    wf = torch.randn(r, 3 * f, generator=gen, device=dev) / 4
    bf = torch.randn(3 * f, generator=gen, device=dev) / 10
    lanes = [t[:, :k].contiguous() for t in (d, u, idx, live)]
    assert int(lanes[3].sum(1).max()) > 32
    phi_pad, v_pad, gs, gv = painn_bwd_inputs(n, f, dev, 8)
    check_painn_bwd((phi_pad, v_pad, *lanes, wf, bf, gs, gv,
                     float(config.cutoff)))


def mace_system(dev, waters, seed=0):
    """MACE at MACE-OFF23 medium's widths (``MACEConfig``'s defaults: 128
    channels, l <= 3, hidden 0e + 1o, correlation 3, 8 Bessel functions,
    5 A, 2 layers; the frame's mean neighbor count 55.3975) on
    water(``waters``): (model, params, cell list, positions, box) on
    ``dev``."""
    water = make_water_box(waters, seed=seed)
    model = MACEModel.from_atomic_numbers(
        water.atomic_numbers, MACEConfig(avg_num_neighbors=55.3975),
        elements=(1, 8))
    params = model.init(torch.Generator().manual_seed(5), device=dev)
    cl = model.create_cell_list(water.box, skin=0.25)
    return (model, params, cl, torch.tensor(water.positions, device=dev),
            torch.tensor(water.box, device=dev))


class _Scatters(TorchDispatchMode):
    """Records the accumulating scatters dispatched (autograd's too):
    ``index_add``, ``scatter*`` and ``index_put`` with ``accumulate``."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if 'index_add' in name or 'scatter' in name or (
                name.startswith('index_put') and (kwargs.get('accumulate') or (
                    len(args) > 3 and args[3]))):
            self.found.append(name)
        return func(*args, **kwargs)


def test_mace_force_call_matches_cpu_and_repeats(dev):
    """MACE's MD force call on water(300): the card's energy within 1e-6
    and forces within 1e-5 normwise of the same call on the CPU, and two
    calls on the card bitwise equal (the message's, the contraction's and
    the deltas payload's adjoints are scatter-free: no atomics)."""
    cpu = torch.device('cpu')
    out = {}
    for d in (dev, cpu):
        model, params, cl, pos, box = mace_system(d, 300)
        sel = model.select(pos, box, cl)
        out[d.type] = [model.energy_and_forces_from_selection(
            params, pos, box, cl, sel) for _ in range(2 if d == dev else 1)]
    (e1, f1), (e2, f2) = out['cuda']
    (e_cpu, f_cpu), = out['cpu']
    assert float(e1) == float(e2) and torch.equal(f1, f2)
    np.testing.assert_allclose(float(e1), float(e_cpu), rtol=1e-6)
    assert float(f_cpu.abs().max()) > 0
    assert_normwise(f1.cpu(), f_cpu, 1e-5)


def test_mace_force_call_26k(dev):
    """MACE's MD force call at 26,010 atoms: every count within its
    capacity, finite, no accumulating scatter dispatched (forward and
    backward); the energy within 1e-5 and the forces within 1e-5 normwise
    of the same call on the CPU; prints the force call's time and the peak
    memory."""
    model, params, cl, pos, box = mace_system(dev, 8670)
    sel = model.select(pos, box, cl)
    counts = model.overflow_counts(pos, box, cl, sel)
    for k, cap in model.capacities(cl).items():
        assert 0 < int(counts[k]) <= cap, k
    model.energy_and_forces_from_selection(params, pos, box, cl, sel)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    e, f = model.energy_and_forces_from_selection(params, pos, box, cl, sel)
    end.record()
    torch.cuda.synchronize()
    print(f'MACE 26k force call {start.elapsed_time(end):.1f} ms, peak '
          f'{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, lanes '
          f'{model.lanes(sel, cl.capacity)} of {cl.capacity}, counts '
          f'{dict((k, int(v)) for k, v in counts.items())}')
    with _Scatters() as mode:
        model.energy_and_forces_from_selection(params, pos, box, cl, sel)
    assert mode.found == []
    assert bool(torch.isfinite(e)) and bool(torch.isfinite(f).all())
    assert float(f.abs().max()) > 0
    model, params, cl, pos, box = mace_system(torch.device('cpu'), 8670)
    e_cpu, f_cpu = model.energy_and_forces_from_selection(
        params, pos, box, cl, model.select(pos, box, cl))
    err = float((f.cpu() - f_cpu).abs().max() / f_cpu.abs().max())
    print(f'MACE 26k against the CPU: energy {float(e)} / {float(e_cpu)}, '
          f'forces normwise {err:.3g}')
    np.testing.assert_allclose(float(e), float(e_cpu), rtol=1e-5)
    assert_normwise(f.cpu(), f_cpu, 1e-5)


# ---------------------------------------------------------------------------
# The window path's opt-in switches: the z-pair and cluster-pair radial
# kernels and the 'mask' compaction.
# ---------------------------------------------------------------------------

def assert_normwise(got, want, rtol):
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= rtol * float(want.abs().max())


def test_mask_kernels_match_plain(dev):
    """The mask kernel and the lane left-pack on water(150)'s 'mask'
    selection equal their plain versions exactly, and the selection equals
    the default 'kernel' selection."""
    model, cl, pos, box, k_sel = window_setup(dev)
    g = model.grouping
    layout = model.blocked_layout
    kw = dict(species=model.species_array, layout=layout,
              radial_cutoff=model.basis.radial_cutoff,
              angular_cutoff=model.basis.angular_cutoff,
              grouping_order=g.order,
              present_counts=tuple(g.counts[s] for s in layout.present))
    masks, packs = [], []
    before = dict(_kernels.LAUNCHES)
    with recording(window_mod, 'window_mask', masks), \
            recording(window_mod, 'left_pack_lanes', packs):
        m_sel = select_window(cl, pos, box, compact_impl='mask', **kw)
    assert _kernels.LAUNCHES['window_mask'] == before['window_mask'] + 1
    assert (_kernels.LAUNCHES['left_pack_lanes']
            == before['left_pack_lanes'] + 1)
    assert _kernels.LAUNCHES['left_pack'] == before['left_pack']
    cx, cy, cz, centers, w2, caps = masks[0][0]
    m_k = cuda_select.window_mask(cx, cy, cz, centers, w2, caps)
    assert torch.equal(m_k, cuda_select.window_mask_plain(cx, cy, cz, centers,
                                                          w2, caps))
    m_atom, widths, a_caps = packs[0][0]
    got = cuda_select.left_pack_lanes(m_atom, widths, a_caps)
    want = cuda_select.left_pack_lanes_plain(m_atom, widths, a_caps)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for f in ('nbr_rad', 'rad_mask', 'max_rad', 'max_ang', 'ang_in_rad'):
        assert torch.equal(getattr(m_sel.ang, f), getattr(k_sel.ang, f)), f


def test_left_pack_lanes_kernel_matches_plain(dev):
    """Random masks, rows far over the caps among them: packed lanes and
    counts equal the plain version's exactly."""
    rng = np.random.RandomState(7)
    widths, caps = (486, 297, 40), (32, 16, 40)
    mask = rng.rand(2601, sum(widths)) < rng.uniform(0, 0.12, (2601, 1))
    mask = torch.tensor(mask, device=dev)
    got = cuda_select.left_pack_lanes(mask, widths, caps)
    want = cuda_select.left_pack_lanes_plain(mask, widths, caps)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool((got[1] > torch.tensor(caps, device=dev)).any())


# (cell caps, cells) of the mask kernel's edge cases: one, two and three
# species with odd cells of bytes (27 c^2), fewer cells than SMs and the
# 26k angular grid's 17^3; (12, 11) are the 26k box's caps.
MASK_EDGE_CASES = [((5,), 1), ((5,), 7), ((7, 4), 1), ((7, 4), 7),
                   ((5, 3, 3), 1), ((5, 3, 3), 7), ((5, 3, 3), 4913),
                   ((12, 11), 7), ((12, 11), 4913)]
# (widths, caps) of the lane left-pack's: widths 1 to 486, caps 0 and
# equal to the width among them; (324, 297) / (32, 16) are the 26k box's.
LANE_PACK_EDGE_CASES = [((1, 31, 33), (1, 5, 33)),
                        ((324, 297), (32, 16)),
                        ((486, 297, 33, 1), (32, 16, 0, 1))]


def lane_pack_edge_mask(widths, caps, seed):
    """``[N, W]`` bool rows: four patterns in which every species block
    holds 0, cap, cap + 1 (at most the width) and all of its lanes valid
    at random places, each on 16 consecutive rows (with an odd W their
    starts take every byte offset mod 16), then 200 random rows of
    densities up to 0.6."""
    rng = np.random.RandomState(seed)
    offs = np.cumsum((0,) + tuple(widths))
    rows = []
    for pattern in range(4):
        row = np.zeros(offs[-1], bool)
        for s, (w, cap) in enumerate(zip(widths, caps)):
            n = min((0, cap, cap + 1, w)[pattern], w)
            row[offs[s] + rng.choice(w, n, replace=False)] = True
        rows += [row] * 16
    dens = rng.uniform(0.0, 0.6, (200, 1)) ** 2
    return np.concatenate([np.stack(rows), rng.rand(200, offs[-1]) < dens])


@pytest.mark.parametrize('caps, ncells', MASK_EDGE_CASES)
def test_mask_kernels_edge_cases(dev, caps, ncells):
    """Both 'mask' kernels against their plain versions, bitwise, at their
    edges. The mask kernel on synthetic windows: lanes at exactly d2 = w2
    and one ulp inside, rows whose center is FAR (they hold ones against
    the FAR lanes, as the plain version's do), odd byte counts a cell so
    that cells start at every offset mod 16. The lane left-pack on rows
    with 0, cap, cap + 1 and every lane valid, at every row start mod 16
    and every base address mod 16 of the mask. Two launches of each are
    bitwise equal and each wrapper call counts one launch."""
    w = 3.75                                   # ANI-2x's angular window
    (cx, cy, cz), centers = synthetic_windows(
        caps, w, ncells, w * w, seed=ncells,
        modes=('edge', 'empty-centers', 'full'))
    ins = [t.to(dev) for t in (cx, cy, cz, centers)]
    before = _kernels.LAUNCHES['window_mask']
    got = cuda_select.window_mask(*ins, w * w, caps)
    assert _kernels.LAUNCHES['window_mask'] == before + 1
    want = cuda_select.window_mask_plain(*ins, w * w, caps)
    assert torch.equal(got, want)
    assert torch.equal(got, cuda_select.window_mask(*ins, w * w, caps))
    far = ins[3][:, :, 0] >= cuda_window.FAR
    assert bool(far.any()) and bool(got[far].any())
    edge = got[0, 0, 14 * caps[0]:14 * caps[0] + 2].tolist()
    assert edge == [False, True]               # d2 = w2, one ulp inside

    for widths, a_caps in LANE_PACK_EDGE_CASES:
        rows = lane_pack_edge_mask(widths, a_caps, seed=sum(widths))
        n, width = rows.shape
        big = torch.tensor(rows, device=dev).reshape(-1)
        big = torch.cat([big, big[:16]])
        counts_seen = set()
        for base in range(16):
            mask = big[base:base + n * width].view(n, width)
            before = _kernels.LAUNCHES['left_pack_lanes']
            got = cuda_select.left_pack_lanes(mask, widths, a_caps)
            assert _kernels.LAUNCHES['left_pack_lanes'] == before + 1
            want = cuda_select.left_pack_lanes_plain(mask, widths, a_caps)
            again = cuda_select.left_pack_lanes(mask, widths, a_caps)
            for a, b, c in zip(got, want, again):
                assert torch.equal(a, b) and torch.equal(a, c)
            counts_seen.update(got[1][:64:16].flatten().tolist())
        for w_s, cap in zip(widths, a_caps):
            assert {0, min(cap + 1, w_s), w_s} <= counts_seen
    wide = cuda_select.MAX_LANE_PACK_WIDTH + 1
    with pytest.raises(ValueError, match='at most'):
        cuda_select.left_pack_lanes(
            torch.zeros(1, wide, dtype=torch.bool, device=dev), (wide,), (1,))


def pair_setup(dev, molecules=150):
    model, cl, pos, box, _ = window_setup(dev, molecules)
    pair = dataclasses.replace(model, window_radial='pair')
    sel = pair.select(pos, box, cl)
    grid = tuple(int(x) for x in cl.ncells)
    caps = tuple(model.blocked_layout.cell_caps)
    return pair, cl, pos, box, sel, grid, caps


def test_pair_radial_kernel_matches_plain(dev):
    pair, cl, pos, box, sel, grid, caps = pair_setup(dev)
    basis = pair.basis
    ins = cuda_zpair.pair_inputs(_radial_slots(pos, sel), box, grid, caps)
    args = (basis.radial_cutoff, basis.radial_eta, basis.radial_rs, grid,
            caps, basis.torchani)
    ins_k = [t.detach().clone().requires_grad_(True) for t in ins]
    ins_p = [t.detach().clone().requires_grad_(True) for t in ins]
    before = dict(_kernels.LAUNCHES)
    out_k = cuda_zpair.pair_radial(*ins_k, *args)
    out_p = cuda_zpair.pair_radial_plain(*ins_p, *args)
    for a, b in zip(out_k, out_p):
        assert_normwise(a.detach(), b.detach(), 1e-5)
    gen = torch.Generator(device=dev).manual_seed(0)
    g = [torch.randn(o.shape, generator=gen, device=dev) for o in out_p]
    g_k = torch.autograd.grad(out_k, ins_k, g)
    g_p = torch.autograd.grad(out_p, ins_p, g)
    for a, b in zip(g_k, g_p):
        assert_normwise(a, b, 1e-4)
    assert _kernels.LAUNCHES['pair_radial_fwd'] == before['pair_radial_fwd'] + 1
    assert _kernels.LAUNCHES['pair_radial_bwd'] == before['pair_radial_bwd'] + 1
    # Deterministic: no atomics, every sum in a fixed order.
    spec = cuda_zpair._spec(grid, caps, float(basis.radial_cutoff),
                            tuple(basis.radial_eta), tuple(basis.radial_rs),
                            bool(basis.torchani))
    raw = [t.detach().contiguous() for t in ins]
    for a, b in zip(cuda_zpair.pair_radial_fwd_cuda(*raw, spec), out_k):
        assert torch.equal(a, b.detach())
    again = cuda_zpair.pair_radial_bwd_cuda(*raw, *g, spec)
    for a, b in zip(again, cuda_zpair.pair_radial_bwd_cuda(*raw, *g, spec)):
        assert torch.equal(a, b)


def synthetic_pair_slots(caps, grid, w, seed,
                         modes=('edge', 'empty-centers', 'full',
                                'no-species')):
    """Slot positions ``[ncells * c, 3]`` and the box of a grid of cubic
    cells of width ``w``, in the kernels' layout (species-sub-blocked slots
    per cell): each slot is occupied with probability 0.65 (anywhere in its
    species block, not only as a prefix) at a random place of its cell,
    empty slots at FAR. The first cells follow ``modes``: 'edge' (slot 0 at
    (1, 1, 1), two slots of the same cell and two of the (1, 0, 0) column's
    cell at exactly rc^2 and just inside of it), no atom at all, every slot
    occupied, no atom of the last species. With ``w`` = rc the half-offset
    columns hold runs beyond the cutoff of a row and runs that straddle
    it."""
    rng = np.random.RandomState(seed)
    nx, ny, nz = grid
    caps = tuple(caps)
    c = sum(caps)
    ncells = nx * ny * nz
    cell = np.arange(ncells)
    corner = np.stack([cell // (ny * nz), (cell // nz) % ny, cell % nz],
                      1) * w
    pos = np.full((ncells, c, 3), cuda_window.FAR, np.float64)
    for k in range(ncells):
        mode = modes[k] if k < len(modes) else 'random'
        occ = rng.rand(c) < 0.65
        if mode in ('full', 'edge'):
            occ[:] = True
        if mode == 'empty-centers':
            occ[:] = False
        if mode == 'no-species':
            occ[c - caps[-1]:] = False
        pos[k, occ] = corner[k] + rng.rand(int(occ.sum()), 3) * w
    rc2 = w * w
    pos[0, 0] = (1.0, 1.0, 1.0)
    for j, (dx, dy) in enumerate(exact_offsets(rc2)):
        pos[0, 1 + j] = (1.0 + dx, 1.0 + dy, 1.0)
        pos[ny * nz, j] = (1.0 + dx, 1.0 + dy, 1.0)
    box = np.diag([nx * w, ny * w, nz * w])
    return (torch.tensor(pos.reshape(-1, 3), dtype=torch.float32),
            torch.tensor(box, dtype=torch.float32))


PAIR_EDGE_CASES = {
    # (basis, cell_caps); 'wide' cuts a 33-slot block into runs of 32 and
    # 1 lanes and has 1-lane runs of the second species.
    'ani2x': (ANIBasis.ani2x(), (7, 4)),
    'small': (small_basis(True), (5, 3, 4)),
    'wide': (ANIBasis.ani2x(), (33, 1)),
}


@pytest.mark.parametrize('grid', [(3, 3, 3), (6, 5, 5)],
                         ids=['27-cells', '150-cells'])
@pytest.mark.parametrize('torchani', [True, False],
                         ids=['torchani', 'publication'])
@pytest.mark.parametrize('case', sorted(PAIR_EDGE_CASES))
def test_pair_radial_kernel_edge_cells(dev, case, torchani, grid):
    """The z-pair kernel against its plain version on synthetic grids at its
    edges (a cell with no real center, a full cell, lanes at exactly rc^2
    and just inside in the own column and a half-offset column, runs beyond
    and straddling the cutoff, empty slots anywhere in a run, a species
    with no atom in a cell, runs of 32 and 1 lanes, the smallest grid and
    one of more cells than SMs): forward and gradients at the gates, empty
    rows 0, and two launches of each direction bitwise equal."""
    basis, caps = PAIR_EDGE_CASES[case]
    basis = dataclasses.replace(basis, torchani=torchani)
    rc = basis.radial_cutoff
    slots, box = synthetic_pair_slots(caps, grid, rc, seed=sum(grid))
    ins = [t.to(dev) for t in cuda_zpair.pair_inputs(slots, box, grid, caps)]
    real = ins[0][:, :, 0] < cuda_window.EMPTY_ROW
    assert real.any() and not real[1].any() and real[2].all()
    args = (rc, basis.radial_eta, basis.radial_rs, grid, caps, torchani)
    ins_k = [t.clone().requires_grad_(True) for t in ins]
    ins_p = [t.clone().requires_grad_(True) for t in ins]
    out_k = cuda_zpair.pair_radial(*ins_k, *args)
    out_p = cuda_zpair.pair_radial_plain(*ins_p, *args)
    for a, b in zip(out_k, out_p):
        assert normwise_close(a, b, 1e-5)
    assert torch.count_nonzero(out_k[0][~real]) == 0
    gen = torch.Generator(device=dev).manual_seed(2)
    g = [torch.rand(o.shape, device=dev, generator=gen) for o in out_p]
    g_k = torch.autograd.grad(out_k, ins_k, g)
    g_p = torch.autograd.grad(out_p, ins_p, g)
    for a, b in zip(g_k, g_p):
        assert bool(torch.isfinite(a).all())
        assert normwise_close(a, b, 1e-4)
    spec = cuda_zpair._spec(grid, caps, float(rc), tuple(basis.radial_eta),
                            tuple(basis.radial_rs), bool(torchani))
    first = cuda_zpair.pair_radial_fwd_cuda(*ins, spec)
    again = cuda_zpair.pair_radial_fwd_cuda(*ins, spec)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    first = cuda_zpair.pair_radial_bwd_cuda(*ins, *g, spec)
    again = cuda_zpair.pair_radial_bwd_cuda(*ins, *g, spec)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def synthetic_clusters(cl, lane_caps, self_block, ncl, rc, seed,
                       modes=('edge', 'empty-centers', 'full',
                              'empty-block')):
    """Lane planes ``[ncl, lanes]`` and centers ``[ncl, cl, 3]`` in the
    kernel's layout: i-cluster i's atoms lie in a cube of width rc, and it
    is the first entry of block ``self_block``; each species block holds
    ``lane_caps[s]`` entries of cl lanes, of which a random number lead
    with j-clusters (cubes of width rc placed up to 2 rc away, so some lie
    beyond the cutoff of a row and some straddle it) and the rest are
    empty, as the selection compacts them. Lanes and centers are FAR with
    probability 0.15, anywhere in an entry. The first clusters follow
    ``modes``: 'edge' (row 0 at (1, 1, 1), two lanes of a j-cluster at
    exactly rc^2 and just inside of it), no real center, nothing FAR, and
    a block (the last) with no atom."""
    rng = np.random.RandomState(seed)
    lanes = cl * sum(lane_caps)
    offs = np.cumsum((0,) + tuple(lane_caps)) * cl
    planes = np.full((ncl, lanes, 3), cuda_window.FAR, np.float64)
    centers = np.full((ncl, cl, 3), cuda_window.FAR, np.float64)
    for i in range(ncl):
        mode = modes[i] if i < len(modes) else 'random'
        holes = mode not in ('full', 'edge')

        def far(n):
            return (rng.rand(n) < 0.15) & holes

        home = rng.uniform(-rc, rc, 3)
        ctr = home + rng.rand(cl, 3) * rc
        ctr[far(cl)] = cuda_window.FAR
        if mode == 'empty-centers':
            ctr[:] = cuda_window.FAR
        centers[i] = ctr
        for s, caps in enumerate(lane_caps):
            used = caps if mode == 'full' else rng.randint(1, caps + 1)
            if mode == 'empty-block' and s == len(lane_caps) - 1:
                used = 0
            for e in range(used):
                lo = offs[s] + e * cl
                if s == self_block and e == 0:
                    planes[i, lo:lo + cl] = ctr
                    continue
                atoms = home + rng.uniform(-2 * rc, 2 * rc, 3) + \
                    rng.rand(cl, 3) * rc
                atoms[far(cl)] = cuda_window.FAR
                planes[i, lo:lo + cl] = atoms
    own = offs[self_block]
    other = offs[1] if self_block == 0 else 0
    centers[0, 0] = planes[0, own] = (1.0, 1.0, 1.0)
    for k, (dx, dy) in enumerate(exact_offsets(rc * rc)):
        planes[0, other + k] = (1.0 + dx, 1.0 + dy, 1.0)
    planes, centers = planes.astype(np.float32), centers.astype(np.float32)
    return ([torch.tensor(np.ascontiguousarray(planes[..., k]))
             for k in range(3)], torch.tensor(centers))


CLUSTER_EDGE_CASES = {
    # (basis, cl, lane_caps in entries, self_block): a block of more
    # entries than a live-run table holds; the i-cluster in the second
    # block; 1-lane clusters of three species.
    'big-block': (ANIBasis.ani2x(), 8, (40, 3), 0),
    'self-second': (ANIBasis.ani2x(), 8, (5, 9), 1),
    'one-lane': (small_basis(True), 1, (70, 5, 4), 2),
}


@pytest.mark.parametrize('torchani', [True, False],
                         ids=['torchani', 'publication'])
@pytest.mark.parametrize('case', sorted(CLUSTER_EDGE_CASES))
def test_cluster_radial_kernel_edge_cases(dev, case, torchani):
    """The cluster-pair kernel against its plain version on synthetic
    clusters at its edges (a cluster with no real center, a full cluster,
    lanes at exactly rc^2 and just inside, j-entries beyond and straddling
    the cutoff, empty lanes anywhere in an entry, a species block with no
    atom, blocks of more than 32 entries, 1-lane clusters): forward and
    gradients at the gates, empty rows 0, and two launches of each
    direction bitwise equal."""
    basis, cl, lane_caps, self_block = CLUSTER_EDGE_CASES[case]
    basis = dataclasses.replace(basis, torchani=torchani)
    rc = basis.radial_cutoff
    (jx, jy, jz), centers = synthetic_clusters(cl, lane_caps, self_block, 24,
                                               rc, seed=len(case))
    planes = [t.to(dev) for t in (jx, jy, jz, centers)]
    real = planes[3][:, :, 0] < cuda_window.EMPTY_ROW
    assert real.any() and not real[1].any()
    args = (rc, basis.radial_eta, basis.radial_rs, cl, lane_caps, self_block,
            torchani)
    ins_k = [t.clone().requires_grad_(True) for t in planes]
    ins_p = [t.clone().requires_grad_(True) for t in planes]
    out_k = cuda_cluster.cluster_radial(*ins_k, *args)
    out_p = cuda_cluster.cluster_radial_plain(*ins_p, *args)
    assert normwise_close(out_k, out_p, 1e-5)
    assert torch.count_nonzero(out_k[~real]) == 0
    g = torch.rand(out_p.shape, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(3))
    g_k = torch.autograd.grad(out_k, ins_k, g)
    g_p = torch.autograd.grad(out_p, ins_p, g)
    for a, b in zip(g_k, g_p):
        assert bool(torch.isfinite(a).all())
        assert normwise_close(a, b, 1e-4)
    spec = cuda_cluster._spec(cl, lane_caps, self_block, float(rc),
                              tuple(basis.radial_eta),
                              tuple(basis.radial_rs), bool(torchani))
    first = cuda_cluster.cluster_radial_fwd_cuda(*planes, spec)
    assert torch.equal(first,
                       cuda_cluster.cluster_radial_fwd_cuda(*planes, spec))
    first = cuda_cluster.cluster_radial_bwd_cuda(*planes, g, spec)
    again = cuda_cluster.cluster_radial_bwd_cuda(*planes, g, spec)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def cluster_setup(dev, molecules=1000):
    water = make_water_box(molecules, seed=0)
    model = ANIModel.from_atomic_numbers(
        water.atomic_numbers, ANIBasis.ani2x(), nn_dtype='bfloat16',
        nn_impl='fused').with_blocked_layout(
            water.positions, water.box, margin=1.15, impl='window',
            skin=0.25, radial_impl='cluster')
    assert model.window_radial == 'cluster'
    assert model.blocked_layout.cluster_plan is not None
    cl = model.create_cell_list(water.box, skin=0.25)
    pos = torch.tensor(water.positions, device=dev)
    box = torch.tensor(water.box, device=dev)
    return model, cl, pos, box, model.select(pos, box, cl)


def test_cluster_radial_kernel_matches_plain(dev):
    """Per i-species on water(1000)'s cluster selection: forward,
    backward, and two launches bitwise equal."""
    model, cl, pos, box, sel = cluster_setup(dev)
    params = init_ani_params(torch.Generator(device=dev).manual_seed(0),
                             model.basis, num_models=2,
                             layer_dims=[(32, 24, 16)] * 7, device=dev)
    calls = []
    with recording(clusters_mod, 'cluster_radial', calls):
        model.energy_and_forces_from_selection(params, pos, box, cl, sel)
    assert len(calls) == 2
    for args, _ in calls:
        planes = [t.detach().contiguous() for t in args[:4]]
        rest = args[4:]
        ins_k = [t.clone().requires_grad_(True) for t in planes]
        ins_p = [t.clone().requires_grad_(True) for t in planes]
        out_k = cuda_cluster.cluster_radial(*ins_k, *rest)
        out_p = cuda_cluster.cluster_radial_plain(*ins_p, *rest)
        assert_normwise(out_k.detach(), out_p.detach(), 1e-5)
        g = torch.randn(out_p.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
        g_k = torch.autograd.grad(out_k, ins_k, g)
        g_p = torch.autograd.grad(out_p, ins_p, g)
        for a, b in zip(g_k, g_p):
            assert_normwise(a, b, 1e-4)
        spec = cuda_cluster._spec(
            int(rest[3]), tuple(rest[4]), int(rest[5]), float(rest[0]),
            tuple(rest[1]), tuple(rest[2]), bool(rest[6]))
        assert torch.equal(cuda_cluster.cluster_radial_fwd_cuda(*planes, spec),
                           out_k.detach())
        first = cuda_cluster.cluster_radial_bwd_cuda(*planes, g, spec)
        for a, b in zip(first, cuda_cluster.cluster_radial_bwd_cuda(
                *planes, g, spec)):
            assert torch.equal(a, b)


@pytest.mark.parametrize('radial', ['pair', 'cluster'])
def test_opt_in_radial_step_matches_plain(dev, radial):
    """One step of the pair (water(150)) or cluster (water(1000)) path
    through the kernels against the plain step and the window step."""
    if radial == 'pair':
        model, cl, pos, box, sel = pair_setup(dev)[:5]
    else:
        model, cl, pos, box, sel = cluster_setup(dev)
    model.check_overflow(pos, box, cl, sel)
    params = init_ani_params(torch.Generator(device=dev).manual_seed(0),
                             model.basis, device=dev)
    _kernels.reset_launch_counts()
    e_k, f_k = model.energy_and_forces_from_selection(params, pos, box, cl,
                                                      sel)
    species = 2 if radial == 'cluster' else 1
    assert _kernels.LAUNCHES[f'{radial}_radial_fwd'] == species
    assert _kernels.LAUNCHES[f'{radial}_radial_bwd'] == species
    assert _kernels.LAUNCHES['window_radial_fwd'] == 0
    before = dict(_kernels.LAUNCHES)
    e_p, f_p = plain_energy_and_forces(model, params, pos, box, cl, sel)
    assert dict(_kernels.LAUNCHES) == before
    np.testing.assert_allclose(float(e_k), float(e_p), rtol=1e-3)
    assert float((f_k - f_p).abs().max()) <= 5e-3 * float(f_p.abs().max())
    window = dataclasses.replace(model, window_radial='window')
    e_w, f_w = window.energy_and_forces_from_selection(
        params, pos, box, cl, window.select(pos, box, cl))
    np.testing.assert_allclose(float(e_k), float(e_w), rtol=1e-3)
    assert float((f_k - f_w).abs().max()) <= 5e-3 * float(f_w.abs().max())


# ---------------------------------------------------------------------------
# The dense and payload ANI paths (no kernel): the card against the CPU.

LIGANDS = np.load(__file__.rsplit('/', 1)[0] + '/data/ligands.npz')
METHANOL_Z = (6, 1, 1, 1, 8, 1)
METHANOL = np.array([[-0.046, 0.663, 0.0], [-1.097, 0.904, 0.174],
                     [0.574, 1.217, 0.705], [0.137, 0.947, -1.026],
                     [0.117, -0.716, 0.152], [1.061, -0.898, 0.033]],
                    np.float32)


def card_and_cpu_params(dev):
    from nnpops_tpu_torch.params import ani_params_to
    params = init_ani_params(torch.Generator(device=dev).manual_seed(0),
                             ANIBasis.ani2x(),
                             self_energies=np.linspace(-40, -1, 7),
                             device=dev)
    return params, ani_params_to(params, 'cpu')


def assert_cpu_gates(e, f, e_cpu, f_cpu, bf16):
    """f32: energy relative 1e-6, max|dF| <= 1e-4 max|F|; bf16 ensemble:
    1e-4 and 5e-3."""
    rtol_e, rtol_f = (1e-4, 5e-3) if bf16 else (1e-6, 1e-4)
    assert torch.isfinite(f).all() and f.shape == f_cpu.shape
    np.testing.assert_allclose(float(e), float(e_cpu), rtol=rtol_e)
    assert (float((f.cpu() - f_cpu).abs().max())
            <= rtol_f * float(f_cpu.abs().max()))


@pytest.mark.parametrize('nn_dtype', [None, 'bfloat16'])
def test_dense_path_matches_cpu(dev, nn_dtype):
    """Config 1's entry points on methanol and two ligands, and the batch
    API on 3 conformers, against the CPU; no kernel launches."""
    params, params_cpu = card_and_cpu_params(dev)
    _kernels.reset_launch_counts()
    mols = [(METHANOL_Z, METHANOL)] + [
        (LIGANDS[f'{n}_atomic_numbers'], LIGANDS[f'{n}_positions'])
        for n in ('2iuz', '1hvk')]
    for z, xyz in mols:
        model = ANIModel.from_atomic_numbers(z, ANIBasis.ani2x(),
                                             nn_dtype=nn_dtype)
        pos = torch.tensor(xyz, dtype=torch.float32)
        e, f = model.energy_and_forces(params, pos.to(dev))
        assert_cpu_gates(e, f, *model.energy_and_forces(params_cpu, pos),
                         nn_dtype is not None)
    confs = torch.tensor(xyz + 0.02 * np.random.RandomState(1).randn(
        3, *xyz.shape), dtype=torch.float32)
    e, f = model.energy_and_forces_batch(params, confs.to(dev))
    e_cpu, f_cpu = model.energy_and_forces_batch(params_cpu, confs)
    for i in range(3):
        assert_cpu_gates(e[i], f[i], e_cpu[i], f_cpu[i], nn_dtype is not None)
    assert not any(_kernels.LAUNCHES.values()), _kernels.LAUNCHES


def payload_setup(dev, molecules=300, **kw):
    water = make_water_box(molecules, seed=0)
    model = ANIModel.from_atomic_numbers(water.atomic_numbers,
                                         ANIBasis.ani2x(),
                                         angular_capacity=32, **kw)
    cl = CellList.create(water.box, model.basis.radial_cutoff, capacity=96)
    return (model, cl, torch.tensor(water.positions, device=dev),
            torch.tensor(water.box, device=dev))


@pytest.mark.parametrize('chunk', [None, 128])
def test_payload_path_matches_cpu(dev, chunk):
    """Config 3's fused entry point and a frozen SlotSelection step on
    water(300), against the CPU; the overflow counts equal the CPU's; no
    kernel launches."""
    params, params_cpu = card_and_cpu_params(dev)
    model, cl, pos, box = payload_setup(dev, aev_chunk_size=chunk)
    _kernels.reset_launch_counts()
    e, f = model.energy_and_forces_fused(params, pos, box, cl)
    assert_cpu_gates(e, f, *model.energy_and_forces_fused(
        params_cpu, pos.cpu(), box.cpu(), cl), False)
    sel = model.select(pos, box, cl)
    e, f = model.energy_and_forces_from_selection(params, pos, box, cl, sel)
    sel_cpu = model.select(pos.cpu(), box.cpu(), cl)
    assert_cpu_gates(e, f, *model.energy_and_forces_from_selection(
        params_cpu, pos.cpu(), box.cpu(), cl, sel_cpu), False)
    counts = model.overflow_counts(pos, box, cl, sel)
    counts_cpu = model.overflow_counts(pos.cpu(), box.cpu(), cl, sel_cpu)
    assert {k: int(v) for k, v in counts.items()} == {
        k: int(v) for k, v in counts_cpu.items()}
    model.check_overflow(pos, box, cl, sel)
    assert not any(_kernels.LAUNCHES.values()), _kernels.LAUNCHES


def test_payload_backwards_spread_is_bounded(dev):
    """The forces of two identical payload steps differ only through
    autograd's ``index_add`` adjoints of the gathers (atomics on the card):
    their spread stays within ATOMIC_SPREAD_BOUND of the largest force."""
    params, _ = card_and_cpu_params(dev)
    model, cl, pos, box = payload_setup(dev)
    sel = model.select(pos, box, cl)
    _, f1 = model.energy_and_forces_from_selection(params, pos, box, cl, sel)
    _, f2 = model.energy_and_forces_from_selection(params, pos, box, cl, sel)
    print(f'payload step forces spread: {spread(f2, f1)}')
    assert spread(f2, f1) <= ATOMIC_SPREAD_BOUND


def test_window_sharded_world_size_one(dev):
    """``parallel.window_shard.window_sharded_energy`` over NCCL at world
    size 1 on water(300) against the unsharded window call (f32 'xla'
    ensemble) on the same selection: energy relative 1e-6, max|dF| <=
    1e-4 max|F|; one call launches B.2 forward and backward once and B.3
    forward and backward once per tier."""
    from nnpops_tpu_torch.parallel.launch import process_group
    from nnpops_tpu_torch.parallel.sharding import make_mesh
    from nnpops_tpu_torch.parallel.window_shard import window_sharded_energy
    params, _ = card_and_cpu_params(dev)
    water = make_water_box(300, seed=0)
    model = ANIModel.from_atomic_numbers(
        water.atomic_numbers, ANIBasis.ani2x()).with_blocked_layout(
            water.positions, water.box, margin=1.15, impl='window',
            skin=0.25)
    assert model.aev_impl == 'window'
    ntiers = 1 + len(model.blocked_layout.ang_tier_caps or ())
    cl = model.create_cell_list(water.box, skin=0.25)
    pos = torch.tensor(water.positions, device=dev)
    box = torch.tensor(water.box, device=dev)
    sel = model.select(pos, box, cl)
    with process_group('nccl'):
        fn = window_sharded_energy(model, make_mesh(1, 1, 'cuda'))
        _kernels.reset_launch_counts()
        p = pos.detach().requires_grad_(True)
        e = fn(params, p, box, sel)
        (g,) = torch.autograd.grad(e, p)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    assert launches == {'window_radial_fwd': 1, 'window_radial_bwd': 1,
                        'angular_aev_fwd': ntiers,
                        'angular_aev_bwd': ntiers}, launches
    e_u, f_u = model.energy_and_forces_from_selection(params, pos, box, cl,
                                                      sel)
    np.testing.assert_allclose(float(e), float(e_u), rtol=1e-6)
    assert float((-g - f_u).abs().max()) <= 1e-4 * float(f_u.abs().max())


# ---------------------------------------------------------------------------
# The parallel layer's train step, sharded energies and distributed
# checkpoint over NCCL at world size 1 (one process, one card).
# ---------------------------------------------------------------------------

TRAIN_LR = 3e-4
TRAIN_FORCE_WEIGHT = 0.1


def leaf_norm(tensors):
    return float(torch.sqrt(sum((t.detach().double() ** 2).sum()
                                for t in tensors)))


def train_setup():
    """ANI-2x (8 models, on the CPU) on 4 perturbed ``2iuz`` conformers,
    energy targets 1 below the initial energies and zero forces, and an
    SGD factory."""
    z = LIGANDS['2iuz_atomic_numbers']
    xyz = LIGANDS['2iuz_positions'].astype(np.float32)
    confs = torch.tensor(xyz + 0.02 * np.random.RandomState(0).randn(
        4, *xyz.shape).astype(np.float32))
    model = ANIModel.from_atomic_numbers(z, ANIBasis.ani2x())
    params0 = init_ani_params(torch.Generator().manual_seed(0),
                              model.basis, num_models=8, device='cpu')
    with torch.no_grad():
        e0 = torch.stack([model.energy(params0, c) for c in confs])
    opt = functools.partial(torch.optim.SGD, lr=TRAIN_LR)
    return model, params0, confs, e0 - 1.0, torch.zeros_like(confs), opt


def test_train_step_world_size_one(dev):
    """The DP x EP train step (``parallel.sharding``) over NCCL at world
    size 1: after one step the loss equals the plain step's on the CPU
    (relative 1e-5), the parameters lie within 1e-4 normwise of its and
    the update within 1e-3; over 3 steps the losses are finite and
    fall."""
    from nnpops_tpu_torch.dryrun import params_tree
    from nnpops_tpu_torch.parallel import sharding
    from nnpops_tpu_torch.parallel.launch import process_group
    from nnpops_tpu_torch.params import from_jax_params
    model, params0, confs, e_t, f_t, opt = train_setup()
    start = [p.clone() for p in sharding.param_leaves(params0)]
    ref = from_jax_params(params_tree(params0), 'cpu')      # a copy
    ref_leaves = sharding.param_leaves(ref)
    for p in ref_leaves:
        p.requires_grad_(True)
    _, ref_loss = sharding.make_train_step(model, TRAIN_FORCE_WEIGHT)(
        sharding.TrainState(ref, opt(ref_leaves)), confs, e_t, f_t)
    with process_group('nccl'):
        mesh = sharding.make_mesh(1, model_parallel=1, device_type='cuda')
        state = sharding.init_train_state(model, opt, params0, mesh)
        step = sharding.jit_train_step(model, mesh, TRAIN_FORCE_WEIGHT)
        batch = sharding.shard_batch(mesh, confs, e_t, f_t)
        state, loss = step(state, *batch)
        got = [p.detach().to('cpu', copy=True)
               for p in sharding.param_leaves(state.params)]
        losses = [float(loss)]
        for _ in range(2):
            state, loss = step(state, *batch)
            losses.append(float(loss))
    np.testing.assert_allclose(losses[0], float(ref_loss), rtol=1e-5)
    want = [p.detach() for p in ref_leaves]
    diff = leaf_norm([g - w for g, w in zip(got, want)])
    assert diff <= 1e-4 * leaf_norm(want)
    assert diff <= 1e-3 * leaf_norm([w - p for w, p in zip(want, start)])
    assert np.isfinite(losses).all(), losses
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


def test_distributed_checkpoint_world_size_one(dev, tmp_path):
    """The train state after one step through
    ``md.checkpoint.save_checkpoint_distributed`` and
    ``load_checkpoint_distributed`` (DTensor shards over NCCL, world size
    1) into a fresh state: every parameter bit for bit, the optimizer's
    param_groups equal."""
    from nnpops_tpu_torch.md import (load_checkpoint_distributed,
                                     save_checkpoint_distributed)
    from nnpops_tpu_torch.parallel import sharding
    from nnpops_tpu_torch.parallel.launch import process_group
    model, params0, confs, e_t, f_t, opt = train_setup()
    start = [p.clone() for p in sharding.param_leaves(params0)]
    with process_group('nccl'):
        mesh = sharding.make_mesh(1, model_parallel=1, device_type='cuda')
        state = sharding.init_train_state(model, opt, params0, mesh)
        step = sharding.jit_train_step(model, mesh, TRAIN_FORCE_WEIGHT)
        state, _ = step(state, *sharding.shard_batch(mesh, confs, e_t, f_t))
        save_checkpoint_distributed(str(tmp_path / 'train_state'), state,
                                    mesh)
        fresh = sharding.init_train_state(model, opt, params0, mesh)
        load_checkpoint_distributed(str(tmp_path / 'train_state'), fresh,
                                    mesh)
    want = sharding.param_leaves(state.params)
    got = sharding.param_leaves(fresh.params)
    assert len(got) == len(want)
    assert not all(torch.equal(a.cpu(), b) for a, b in zip(want, start))
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    assert (fresh.opt_state.state_dict()['param_groups']
            == state.opt_state.state_dict()['param_groups'])


@pytest.mark.parametrize('kind', ['atom', 'tp', 'pp'])
def test_sharded_energy_world_size_one(dev, kind):
    """At world size 1 over NCCL, each sharded energy against its
    unsharded counterpart on the card: ``atom_sharded_energy`` on 1hvk
    (energy relative 1e-6, forces by autograd within 1e-4 of max|F|),
    ``tp_ensemble_energy`` on its AEV (relative 1e-5), and the one-stage
    ``pipeline_ensemble_energy`` (4 microbatches of [256, 256]) against
    the layer (normwise 1e-5). ``pipeline_ani_ensemble_energy`` needs as
    many ranks as network layers: the CPU tests run it over gloo."""
    from nnpops_tpu_torch.parallel import sharding
    from nnpops_tpu_torch.parallel.launch import process_group
    params, _ = card_and_cpu_params(dev)
    model = ANIModel.from_atomic_numbers(LIGANDS['1hvk_atomic_numbers'],
                                         ANIBasis.ani2x())
    pos = torch.tensor(LIGANDS['1hvk_positions'].astype(np.float32),
                       device=dev)
    with process_group('nccl'):
        mesh = sharding.make_mesh(1, model_parallel=1, device_type='cuda')
        if kind == 'atom':
            fn = sharding.atom_sharded_energy(model, mesh, axis='dp')
            p = pos.detach().requires_grad_(True)
            e = fn(params, p)
            (g,) = torch.autograd.grad(e, p)
            e_u, f_u = model.energy_and_forces(params, pos)
            np.testing.assert_allclose(float(e.detach()), float(e_u),
                                       rtol=1e-6)
            assert_normwise(-g, f_u, 1e-4)
        elif kind == 'tp':
            with torch.no_grad():
                aev = model.aev(pos)
                grouping, _ = model._device_grouping(dev)
                e = sharding.tp_ensemble_energy(model, mesh, axis='mp')(
                    params, aev)
                e_u = batched_nn.ensemble_energy(params.ensemble, aev,
                                                 grouping)
            np.testing.assert_allclose(float(e), float(e_u), rtol=1e-5)
        else:
            gen = torch.Generator(device=dev).manual_seed(0)
            w = torch.randn(1, 256, 256, generator=gen, device=dev) / 16.0
            b = 0.1 * torch.randn(1, 256, generator=gen, device=dev)
            x = torch.randn(1024, 256, generator=gen, device=dev)
            with torch.no_grad():
                y = sharding.pipeline_ensemble_energy(
                    (256,), mesh, axis='mp', num_microbatches=4)(w, b, x)
            assert_normwise(y, torch.relu(x @ w[0] + b[0]), 1e-5)


# ---------------------------------------------------------------------------
# The paths at 26,010 atoms (water(8670)), where the planner turns on
# cell-occupancy bucketing, four angular tiers and a bucketed PME plan.
# ---------------------------------------------------------------------------

LARGE_WATERS = 8670


def frozen_steps(model, params, pos, box, cl, sel, steps=4):
    """``steps`` force steps nudged by ``1e-6 f`` on a frozen selection:
    every energy and force finite, no overflow at the last frame."""
    p = pos
    for _ in range(steps):
        e, f = model.energy_and_forces_from_selection(params, p, box, cl,
                                                      sel)
        assert bool(torch.isfinite(e)) and bool(torch.isfinite(f).all())
        assert tuple(f.shape) == (model.num_atoms, 3)
        p = p + 1e-6 * f
    model.check_overflow(p, box, cl, sel)


def assert_step_matches(e, f, e_ref, f_ref):
    """A step's gate: energy relative 1e-3, max|dF| <= 5e-3 max|F|."""
    np.testing.assert_allclose(float(e), float(e_ref), rtol=1e-3)
    assert float((f - f_ref).abs().max()) <= 5e-3 * float(f_ref.abs().max())


def assert_kernel_call_matches(kernel, plain, planes, rest, **kw):
    """A recorded kernel call's differentiable planes through ``kernel``
    and ``plain``: outputs normwise 1e-5, the gradients of the sum of the
    squared outputs 1e-4."""
    ins_k = [t.detach().clone().requires_grad_(True) for t in planes]
    ins_p = [t.detach().clone().requires_grad_(True) for t in planes]
    out_k, out_p = kernel(*ins_k, *rest, **kw), plain(*ins_p, *rest, **kw)
    if isinstance(out_k, torch.Tensor):
        out_k, out_p = (out_k,), (out_p,)
    for a, b in zip(out_k, out_p):
        assert_normwise(a.detach(), b.detach(), 1e-5)
    g_k = torch.autograd.grad(sum(o.square().sum() for o in out_k), ins_k)
    g_p = torch.autograd.grad(sum(o.square().sum() for o in out_p), ins_p)
    for a, b in zip(g_k, g_p):
        assert_normwise(a, b, 1e-4)


def large_window_case(dev, radial):
    """The window path (``radial`` 'window'), its pair variant or the
    cluster path on water(8670): bucketing and four tiers planned, a
    selection without overflow; each recorded radial kernel call (two
    bucketed window calls, one pair call, one cluster call an i-species)
    against its plain version; for the window path the ensemble on the
    step's AEV rows against the per-species oracle; the step against the
    plain step and, for 'pair' and 'cluster', the window step; then
    frozen nudged steps."""
    model, cl, pos, box, window_sel = window_setup(dev, LARGE_WATERS)
    layout = model.blocked_layout
    assert layout.small_caps is not None
    assert len(layout.ang_tier_caps or ()) == 3
    params = init_ani_params(torch.Generator(device=dev).manual_seed(0),
                             model.basis, device=dev)
    window = model
    if radial == 'pair':
        model = dataclasses.replace(window, window_radial='pair')
        target = (cuda_zpair, 'pair_radial')
    elif radial == 'cluster':
        water = make_water_box(LARGE_WATERS, seed=0)
        model = ANIModel.from_atomic_numbers(
            water.atomic_numbers, model.basis, nn_dtype='bfloat16',
            nn_impl='fused').with_blocked_layout(
                water.positions, water.box, margin=1.15, impl='window',
                skin=0.25, radial_impl='cluster')
        assert model.window_radial == 'cluster'
        plan = model.blocked_layout.cluster_plan
        assert plan is not None
        assert dataclasses.replace(model.blocked_layout,
                                   cluster_plan=None) == layout
        target = (clusters_mod, 'cluster_radial')
    else:
        target = (window_mod, 'window_radial')
    sel = window_sel if radial == 'window' else model.select(pos, box, cl)
    model.check_overflow(pos, box, cl, sel)
    calls, feats = [], []
    with recording(*target, calls), recording(
            ani_module, 'ensemble_energy_grouped_rows_fused', feats):
        e_k, f_k = model.energy_and_forces_from_selection(params, pos, box,
                                                          cl, sel)
    assert len(calls) == {'window': 2, 'pair': 1, 'cluster': 2}[radial]
    for args, kw in calls:
        if radial == 'window':
            assert_kernel_call_matches(
                cuda_window.window_radial, cuda_window.window_radial_plain,
                args[:4], args[4:], **kw)
        elif radial == 'pair':
            assert_kernel_call_matches(
                cuda_zpair.pair_radial, cuda_zpair.pair_radial_plain,
                args[:3], args[3:])
        else:
            assert_kernel_call_matches(
                cuda_cluster.cluster_radial,
                cuda_cluster.cluster_radial_plain, args[:4], args[4:])
    if radial == 'window':
        (args, _), = feats
        ens, x, counts = args[0], args[1].detach().contiguous(), args[2]
        pe = cuda_nn.pack_ensemble(ens)
        e_n, dx_n = cuda_nn.ensemble_cuda(x, pe, counts, True)
        e_o, dx_o = cuda_nn.ensemble_oracle(ens, x, counts, True)
        normwise(e_n, e_o, 1e-3)
        normwise(dx_n, dx_o, 1e-2)
    assert_step_matches(e_k, f_k, *plain_energy_and_forces(
        model, params, pos, box, cl, sel))
    if radial != 'window':
        assert_step_matches(e_k, f_k, *window.energy_and_forces_from_selection(
            params, pos, box, cl, window_sel))
    frozen_steps(model, params, pos, box, cl, sel)


def large_config5_case(dev):
    """Config 5 (``models.combined.config5``) on water(8670): a bucketed
    PME plan and four tiers; the PME window kernel on one force step's
    recorded call against its plain version (energy relative 1e-5, the
    gradients of the energy normwise 1e-4); then two selection blocks of
    Langevin MD (``run_md_sticky_counts``): count maxima within their
    capacities, no overflow, a finite state."""
    from nnpops_tpu_torch.md import (initialize, langevin_baoab,
                                     run_md_sticky_counts)
    from nnpops_tpu_torch.models import combined
    c5 = combined.config5(make_water_box(LARGE_WATERS, seed=0),
                          ANIBasis.ani2x(), device=dev)
    ff, cl, box, q = c5.model, c5.cell_list, c5.box, c5.charges
    plan = ff.pme_window_plan
    assert plan is not None and plan[2] is not None
    assert len(ff.ani.blocked_layout.ang_tier_caps or ()) == 3
    params = init_ani_params(torch.Generator(device=dev).manual_seed(0),
                             ff.ani.basis, num_models=8,
                             self_energies=combined.C5_SELF_ENERGIES,
                             device=dev)

    def select(p):
        return ff.select(p, box, cl)

    def forces(sel, p):
        return ff.energy_and_forces_from_selection(params, p, q, box, cl, sel)

    calls = []
    with recording(cuda_pme, 'pme_window', calls):
        forces(select(c5.positions), c5.positions)
    (args, _), = calls
    planes, excl, rest = args[:5], args[5], args[6:10]
    ins_k = [t.detach().clone().requires_grad_(True) for t in planes]
    ins_p = [t.detach().clone().requires_grad_(True) for t in planes]
    e_k = cuda_pme.pme_window(*ins_k, excl, *rest).sum()
    e_p = cuda_pme.pme_window_plain(*ins_p, excl, *rest).sum()
    np.testing.assert_allclose(float(e_k.detach()), float(e_p.detach()),
                               rtol=1e-5)
    for a, b in zip(torch.autograd.grad(e_k, ins_k),
                    torch.autograd.grad(e_p, ins_p)):
        assert_normwise(a, b, 1e-4)
    state = initialize(lambda p: forces(select(p), p), c5.positions,
                       c5.masses, combined.C5_KT,
                       torch.Generator(device=dev).manual_seed(1))
    final, energies, stats = run_md_sticky_counts(
        select, forces,
        lambda f: langevin_baoab(f, c5.masses, combined.C5_DT,
                                 combined.C5_FRICTION, combined.C5_KT),
        state, 2 * combined.C5_REFRESH, combined.C5_REFRESH,
        lambda sel, p: ff.overflow_counts(p, q, box, cl, sel))
    ff.check_counts(stats, cl)
    ff.check_overflow(final.positions, q, box, cl)
    for t in (energies, final.positions, final.velocities):
        assert bool(torch.isfinite(t).all())


def large_mask_case(dev):
    """``select_window(compact_impl='mask')`` on water(8670): one launch
    each of the mask kernel and the lane left-pack and none of the
    left-pack; each recorded call equal to its plain version; the
    selection equal to the 'kernel' selection field by field."""
    model, cl, pos, box, _ = window_setup(dev, LARGE_WATERS)
    g = model.grouping
    layout = model.blocked_layout
    kw = dict(species=model.species_array, layout=layout,
              radial_cutoff=model.basis.radial_cutoff,
              angular_cutoff=model.basis.angular_cutoff,
              grouping_order=g.order,
              present_counts=tuple(g.counts[s] for s in layout.present),
              need_shift_planes=True)
    k_sel = select_window(cl, pos, box, compact_impl='kernel', **kw)
    masks, packs = [], []
    _kernels.reset_launch_counts()
    with recording(window_mod, 'window_mask', masks), \
            recording(window_mod, 'left_pack_lanes', packs):
        m_sel = select_window(cl, pos, box, compact_impl='mask', **kw)
    assert _kernels.LAUNCHES['window_mask'] == 1
    assert _kernels.LAUNCHES['left_pack_lanes'] == 1
    assert _kernels.LAUNCHES['left_pack'] == 0
    (args, _), = masks
    assert torch.equal(cuda_select.window_mask(*args),
                       cuda_select.window_mask_plain(*args))
    (args, _), = packs
    for a, b in zip(cuda_select.left_pack_lanes(*args),
                    cuda_select.left_pack_lanes_plain(*args)):
        assert torch.equal(a, b)
    fields = [('ang.' + f, getattr(k_sel.ang, f), getattr(m_sel.ang, f))
              for f in ('order', 'slot_of_sorted', 'nbr_rad', 'rad_mask',
                        'max_rad', 'max_ang', 'ang_in_rad')]
    assert k_sel.tier is not None
    for t in range(len(k_sel.tier.idx)):
        fields += [(f'tier.{f}[{t}]', getattr(k_sel.tier, f)[t],
                    getattr(m_sel.tier, f)[t]) for f in ('idx', 'mask')]
    fields += [('tier.' + f, getattr(k_sel.tier, f), getattr(m_sel.tier, f))
               for f in ('row_atom', 'tier_counts', 'concat_pos')]
    for name, a, b in fields:
        assert torch.equal(a, b), name


def large_payload_case(dev):
    """The payload path (config 3's capacities, ``aev_chunk_size=512``) on
    water(8670): no kernel launches; frozen nudged steps finite without
    overflow; then two blocks of two nudged steps through
    ``md.run_md_sticky`` with ``max_angular_neighbors`` as its overflow
    count, within the capacities."""
    from nnpops_tpu_torch.md import MDState, run_md_sticky
    from nnpops_tpu_torch.ops.aev import max_angular_neighbors
    params, _ = card_and_cpu_params(dev)
    model, cl, pos, box = payload_setup(dev, LARGE_WATERS,
                                        aev_chunk_size=512)
    _kernels.reset_launch_counts()
    frozen_steps(model, params, pos, box, cl, model.select(pos, box, cl))

    def nudge(force_fn):
        def step(state):
            x = state.positions + 1e-6 * state.forces
            energy, forces = force_fn(x)
            return state._replace(positions=x, forces=forces, energy=energy,
                                  step=state.step + 1)
        return step

    e0, f0 = model.energy_and_forces_fused(params, pos, box, cl)
    state = MDState(pos, torch.zeros_like(pos), f0, e0,
                    torch.Generator(device=dev),
                    torch.zeros((), dtype=torch.int32, device=dev))
    final, energies, stats = run_md_sticky(
        lambda p: model.select(p, box, cl),
        lambda sel, p: model.energy_and_forces_from_selection(
            params, p, box, cl, sel),
        nudge, state, 4, 2,
        lambda sel, p: max_angular_neighbors(
            cl.payload_from_selection(p, box, sel),
            model.basis.angular_cutoff))
    stats.check(cl.capacity, cl.cell_capacity, model.angular_capacity)
    assert bool(torch.isfinite(energies).all())
    assert bool(torch.isfinite(final.forces).all())
    assert not any(_kernels.LAUNCHES.values()), _kernels.LAUNCHES


@pytest.mark.parametrize('path', ['window', 'pair', 'cluster', 'config5',
                                  'mask', 'payload'])
def test_large_path_matches_plain(dev, path):
    """Each path at 26,010 atoms: the window path and its pair and cluster
    radials, config 5, the 'mask' selection and the payload path (see the
    case functions for what each holds)."""
    if path in ('window', 'pair', 'cluster'):
        large_window_case(dev, path)
    elif path == 'config5':
        large_config5_case(dev)
    elif path == 'mask':
        large_mask_case(dev)
    else:
        large_payload_case(dev)
