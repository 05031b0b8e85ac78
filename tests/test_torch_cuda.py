"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX: the machine with the GPU has none. Inputs come from numpy
seeds through the port's own selection and payload. Every test needs a
CUDA device and skips without one. On the card, from the repository root
(``--noconftest``: ``tests/conftest.py`` configures JAX):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import dataclasses

import numpy as np
import pytest
import torch

from nnpops_tpu_torch import ANI2X_LAYER_DIMS, ANIBasis, _kernels
from nnpops_tpu_torch.config import CFConvConfig
from nnpops_tpu_torch.models.ani import (ANIModel, init_ani_params,
                                         plain_energy_and_forces)
from nnpops_tpu_torch.models.combined import ANIWithPME
from nnpops_tpu_torch.models.schnet import CFConvStack
from nnpops_tpu_torch.models.combined import \
    plain_energy_and_forces as combined_plain
from nnpops_tpu_torch.neighbors.blocked import (payload_from_blocked,
                                                plan_blocked_layout,
                                                select_blocked)
from nnpops_tpu_torch.neighbors.cell_list import CellList
from nnpops_tpu_torch.neighbors.window import radial_window_inputs
from nnpops_tpu_torch.neighbors import clusters as clusters_mod
from nnpops_tpu_torch.neighbors import window as window_mod
from nnpops_tpu_torch.neighbors.window import _radial_slots, select_window
from nnpops_tpu_torch.ops import (batched_nn, cuda_aev, cuda_cfconv,
                                  cuda_cluster, cuda_nn, cuda_pme,
                                  cuda_select, cuda_window, cuda_zpair)
from nnpops_tpu_torch.ops.cfconv import init_cfconv
from nnpops_tpu_torch.ops.pme import PME
from nnpops_tpu_torch.profile_step import recording
from nnpops_tpu_torch.utils import make_water_box

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU (the CUDA kernels have no CPU mode)')
    return torch.device('cuda', torch.cuda.current_device())


def small_basis(torchani):
    return ANIBasis.from_grids(
        num_species=3, Rcr=4.2, Rca=3.1,
        EtaR=[16.0], ShfR=[0.9, 1.7, 2.5, 3.3],
        EtaA=[8.0], Zeta=[14.1], ShfA=[0.9, 1.6, 2.3], ShfZ=[0.2, 1.2, 2.2],
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
    e_k = cuda_nn.fused_species_net_fwd(x, net)
    e_kg, dx_k = cuda_nn.fused_species_net_fwdgrad(x, net)
    e_p, dx_p = cuda_nn.fused_species_net_plain(x, net, with_grad=True)
    # Normwise gates: a bf16 operand can round the other way when the f32
    # accumulation order differs, which moves a near-zero energy by more
    # than 1e-3 of itself but not of the block's scale.
    for e in (e_k, e_kg):
        assert float((e - e_p).abs().max()) <= 1e-3 * float(e_p.abs().max())
    assert float((dx_k - dx_p).abs().max()) <= 1e-2 * float(dx_p.abs().max())


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
    assert _kernels.LAUNCHES['fused_nn_fwdgrad'] == 2          # H and O
    e_p, f_p = plain_energy_and_forces(model, params, pos, box, cl, sel)
    assert _kernels.LAUNCHES['fused_nn_fwdgrad'] == 2
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
    assert _kernels.LAUNCHES['fused_nn_fwdgrad'] == 2           # H and O
    before = dict(_kernels.LAUNCHES)
    e_p, f_p = plain_energy_and_forces(model, params, pos, box, cl, sel)
    assert dict(_kernels.LAUNCHES) == before
    np.testing.assert_allclose(float(e_k), float(e_p), rtol=1e-3)
    assert float((f_k - f_p).abs().max()) <= 5e-3 * float(f_p.abs().max())


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


def cfconv_inputs(dev, cfg, k, n=37, seed=0):
    """Random backward inputs: about 60 % of the lanes valid, row 5 all
    masked, random biases."""
    rng = np.random.RandomState(seed)
    mask = rng.rand(n, k) < 0.6
    mask[5] = False
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
    every pair) to 1e-3 of the reference's scale."""
    (gw, gd, gx), (ww, wd, wx) = got, want
    for a, b, tol in [(gd, wd, 1e-4), (gx, wx, 1e-4)] + [
            (a, b, 1e-3) for a, b in zip(gw, ww)]:
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.parametrize('k', [100, 640])
@pytest.mark.parametrize('activation', ['ssp', 'tanh'])
def test_cfconv_bwd_kernel_matches_plain(dev, k, activation):
    cfg = cfconv_config(activation)
    params, (dist, mask, idx, x, g) = cfconv_inputs(dev, cfg, k)
    before = _kernels.LAUNCHES['cfconv_bwd']
    got = cuda_cfconv.cfconv_bwd(params, dist, mask, idx, x, g, cfg)
    assert _kernels.LAUNCHES['cfconv_bwd'] == before + 1
    want = cuda_cfconv.cfconv_bwd_plain(params, dist, mask, idx, x, g, cfg)
    assert_cfconv_bwd_close(got, want)
    assert not bool(got[1][5].any()) and not bool(got[2][5].any())
    assert not bool(got[1][~mask].any())          # masked lanes exactly 0
    again = cuda_cfconv.cfconv_bwd(params, dist, mask, idx, x, g, cfg)
    for a, b in zip((*got[0], *got[1:]), (*again[0], *again[1:])):
        assert torch.equal(a, b)                  # deterministic


@pytest.mark.parametrize('width', [32, 64])
def test_cfconv_bwd_kernel_other_widths(dev, width):
    cfg = cfconv_config('ssp', width=width, num_gaussians=8)
    params, (dist, mask, idx, x, g) = cfconv_inputs(dev, cfg, 64, n=50)
    got = cuda_cfconv.cfconv_bwd(params, dist, mask, idx, x, g, cfg)
    want = cuda_cfconv.cfconv_bwd_plain(params, dist, mask, idx, x, g, cfg)
    assert_cfconv_bwd_close(got, want)
    with pytest.raises(ValueError, match='width'):
        cuda_cfconv.cfconv_bwd(params, dist, mask, idx, x, g,
                               cfconv_config(width=48))


def test_cfconv_stack_kernel_matches_plain(dev):
    """A chunked 2-layer stack over the scatter-free distance payload on
    water(300) at width 128 and a 6 A cutoff: value, position, input and
    weight gradients through the kernel against the plain backward."""
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
    want = run(True)
    assert _kernels.LAUNCHES['cfconv_bwd'] == 2
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    for a, b in zip(got[1:], want[1:]):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


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
