"""MACE on the cell list's MD path (``MACEModel.from_atomic_numbers``:
``select``, ``energy_and_forces_from_selection``, ``overflow_counts``) on
the CPU at 8 channels (every other width MACE-OFF23 medium's: l <= 3
harmonics, hidden 0e + 1o, correlation 3, 8 Bessel functions, the radial
MLP 64-64-64, a 5 A cutoff, skin 0.25) on 300 waters (900 atoms: the
5.25 A cell list is three cells wide): against the benchmark's plain
reference (``mdbench/reference/mace_cell_list.py``) on its seeded
parameters; the message's hand-written adjoint and the symmetric
contraction's against autograd, in float64; the refusal of weight
gradients; invariance and equivariance under rotations, translations and
permutations; a lane of the Verlet skin contributing exactly nothing; no
``index_add`` or accumulating ``index_put`` on the force path; two MD
blocks. And the tables (``ops.so3``): C and every U orthonormal and
equivariant under real Wigner D matrices fitted from Y, U symmetric in its
slots, U's sizes against the character formula, and equal to the plain
reference's own tables."""
import itertools
import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mdbench import harness, inputs
from mdbench.models import mace_cell_list as kind
from mdbench.reference import mace_cell_list as reference
from nnpops_tpu_torch.config import MACEConfig
from nnpops_tpu_torch.md import integrators
from nnpops_tpu_torch.models.mace import MACEModel, radial_basis
from nnpops_tpu_torch.neighbors.cell_list import CellList, lane_geometry
from nnpops_tpu_torch.ops import mace as mace_ops
from nnpops_tpu_torch.ops import so3

SMALL = dict(channels=8, aev_length=8, layer_dims=[[8]])
SEED = 2 ** 33 + 5
F = 8


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cell():
    cfg = harness.load_json('configs', 'mace')
    cfg.update(SMALL)
    traffic = harness.load_json('traffic', 'water26010-check1')
    traffic['molecules'] = 300
    return cfg, traffic


@pytest.fixture(scope='module')
def cell():
    """(cfg, setup, model, cell list, params, positions) at one seed."""
    cfg, traffic = small_cell()
    setup = harness.make_setup(cfg, traffic, SEED, 'cpu')
    model, cells = kind.mace_model(cfg, setup)
    params = kind.port_params(cfg, setup)
    r = inputs.restart(SEED, 0, setup.frame, setup.masses, 0.596, 0.02)
    return cfg, setup, model, cells, params, r.positions


def test_cell_list_sizes(cell):
    cfg, setup, model, cells, _, _ = cell
    assert model.num_interactions == 2 and model.num_species == 10
    assert model.config == MACEConfig(channels=8, avg_num_neighbors=55.3975)
    assert cells.cutoff == pytest.approx(5.25)
    assert cells.ncells == (3, 3, 3) and cells.capacity == 128
    assert model.species[:3] == (3, 0, 0)          # O, H, H
    assert [len(model.paths(t)) for t in range(2)] == [4, 10]
    for bad in (dict(channels=0), dict(l_max=2), dict(correlation=2),
                dict(hidden_l=2), dict(avg_num_neighbors=0.0)):
        with pytest.raises(ValueError):
            MACEConfig(**bad)


def test_equals_plain_reference(cell):
    """Energy rtol 1e-6, forces within 1e-5 of their largest (both float32
    on the CPU); the force call's lanes are the selection's largest count
    rounded up to 8, not the cell list's 128."""
    cfg, setup, model, cells, params, pos = cell
    sel = model.select(pos, setup.box, cells)
    e, f = model.energy_and_forces_from_selection(params, pos, setup.box,
                                                  cells, sel)
    k = model.lanes(sel, cells.capacity)
    assert k % 8 == 0 and int(sel.max_neighbors) <= k < 128
    ref = reference.make(cfg, setup)
    er, fr, none = ref.energy_forces_and_ani(pos)
    assert none is None and er.dtype == torch.float64
    assert float(torch.max(torch.abs(fr))) > 1e-3
    np.testing.assert_allclose(float(e), float(er), rtol=1e-6)
    np.testing.assert_allclose(f.numpy(), fr.numpy(), rtol=0,
                               atol=1e-5 * float(torch.max(torch.abs(fr))))


def lanes(cell):
    """The lanes of the cell's selection in float64: (Y, e, indices) of
    the first 80."""
    cfg, setup, model, cells, params, pos = cell
    sel = model.select(pos, setup.box, cells)
    deltas, idx, mask = cells.payload_deltas_from_selection(
        pos.double(), setup.box.double(), sel)
    d, u = lane_geometry(deltas[:, :80], mask[:, :80])
    live = mask[:, :80] & (d < model.config.cutoff)
    assert bool((mask[:, :80] & ~live).any())          # skin lanes
    return (so3.spherical_harmonics(u), radial_basis(d, live, model.config),
            idx[:, :80])


@pytest.mark.parametrize('layer, rows_per_chunk', [(0, None), (0, 97),
                                                   (1, None), (1, 97)])
def test_message_adjoint_matches_autograd(cell, layer, rows_per_chunk):
    """The hand-written backward (scatter-free: the row's atom's h
    cotangent through the mirrored lanes) against autograd through the
    same forward unchunked, float64: the messages and the h, Y and e
    cotangents within 1e-10 of their largest, in one chunk or in chunks of
    97 rows."""
    y, e, idx = lanes(cell)
    model = cell[2]
    paths = model.paths(layer)
    pl = mace_ops.plan(paths)
    n = y.shape[0]
    gen = torch.Generator().manual_seed(3 + layer)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    h = rand(n, F, pl.width_in)
    widths = (8, 64, 64, 64, len(paths) * F)
    weights = [rand(a, b) / math.sqrt(a) for a, b in zip(widths, widths[1:])]
    gs = [rand(n, len(g), F, 2 * l3 + 1) for l3, g in enumerate(pl.by_l3)]
    out = {}
    for plain in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in (h, y, e)]
        if plain:
            ms = mace_ops.message_plain(*leaves, idx, weights, paths)
        else:
            ms = mace_ops.mace_message(*leaves, idx, weights, paths,
                                       rows_per_chunk=rows_per_chunk)
        loss = sum((m * g).sum() for m, g in zip(ms, gs))
        out[plain] = tuple(m.detach() for m in ms) + torch.autograd.grad(
            loss, leaves)
    names = [f'm{l3}' for l3 in range(4)] + ['h', 'y', 'e']
    for name, a, b in zip(names, out[False], out[True]):
        scale = float(torch.max(torch.abs(b)))
        assert scale > 0, name
        assert float(torch.max(torch.abs(a - b))) <= 1e-10 * scale, name


def test_contraction_adjoint_matches_autograd(cell):
    """The contraction (species-grouped, nested, its backward the same
    nesting with T_nu scaled by nu) against autograd through the explicit
    per-atom sum over U, float64: values and A cotangents within 1e-10 of
    their largest, for layer 1's outputs (0e + 1o) and layer 2's (0e)."""
    model = cell[2]
    n = len(model.species)
    gen = torch.Generator().manual_seed(6)
    a = torch.randn(n, F, 16, generator=gen, dtype=torch.float64)
    groups, inverse, _ = model._groups('cpu')
    z = torch.tensor(model.species)
    for outputs in ((0, 1), (0,)):
        weights = tuple(tuple(
            torch.randn(10, so3.symmetric_basis(nu, big_l).shape[-1], F,
                        generator=gen, dtype=torch.float64)
            for nu in (1, 2, 3)) for big_l in outputs)
        leaf = a.clone().requires_grad_(True)
        b = mace_ops.symmetric_contraction(leaf, outputs, weights, groups,
                                           inverse)
        g = torch.randn(b.shape, generator=gen, dtype=torch.float64)
        (da,) = torch.autograd.grad((b * g).sum(), leaf)
        leaf2 = a.clone().requires_grad_(True)
        want = []
        for big_l, w_l in zip(outputs, weights):
            u = [torch.as_tensor(so3.symmetric_basis(nu, big_l))
                 for nu in (1, 2, 3)]
            want.append(
                torch.einsum('aMe,nec,nca->ncM', u[0], w_l[0][z], leaf2)
                + torch.einsum('abMe,nec,nca,ncb->ncM', u[1], w_l[1][z],
                               leaf2, leaf2)
                + torch.einsum('abdMe,nec,nca,ncb,ncd->ncM', u[2],
                               w_l[2][z], leaf2, leaf2, leaf2))
        want = torch.cat(want, -1)
        (da2,) = torch.autograd.grad((want * g).sum(), leaf2)
        for got, ref in ((b.detach(), want.detach()), (da, da2)):
            scale = float(torch.max(torch.abs(ref)))
            assert scale > 0
            assert float(torch.max(torch.abs(got - ref))) <= 1e-10 * scale


def test_ops_refuse_weight_gradients(cell):
    y, e, idx = lanes(cell)
    model = cell[2]
    n = y.shape[0]
    paths = model.paths(0)
    widths = (8, 64, 64, 64, len(paths) * F)
    weights = [torch.zeros(a, b, dtype=torch.float64)
               for a, b in zip(widths, widths[1:])]
    weights[1].requires_grad_(True)
    with pytest.raises(RuntimeError, match='no weight gradients'):
        mace_ops.mace_message(torch.zeros(n, F, 1, dtype=torch.float64), y,
                              e, idx, weights, paths)
    groups, inverse, _ = model._groups('cpu')
    w = tuple(torch.zeros(10, so3.symmetric_basis(nu, 0).shape[-1], F,
                          requires_grad=(nu == 3)) for nu in (1, 2, 3))
    with pytest.raises(RuntimeError, match='no weight gradients'):
        mace_ops.symmetric_contraction(torch.zeros(n, F, 16), (0,), (w,),
                                       groups, inverse)


def cluster_system():
    """MACE on a water cluster in a large box: (model, params, box,
    positions about the box's centre)."""
    water = inputs.water_frame(300, 0)
    pos = torch.tensor(water.positions, dtype=torch.float32)
    centre = pos.mean(0)
    near = torch.linalg.norm(pos.view(-1, 3, 3)[:, 0] - centre, dim=1) < 7.0
    pos = pos.view(-1, 3, 3)[near].reshape(-1, 3) - centre + 20.0
    numbers = np.tile([8, 1, 1], pos.shape[0] // 3)
    model = MACEModel.from_atomic_numbers(
        numbers, MACEConfig(channels=F, avg_num_neighbors=10.0), [1, 8])
    params = model.init(torch.Generator().manual_seed(2), device='cpu')
    return model, params, torch.eye(3) * 40.0, pos


def energy_and_forces(model, params, box, pos):
    """The force call on a cell list sized for the cluster's density, not
    the box's (``create_cell_list`` would give cells of 8 atoms)."""
    cells = CellList.create(box, 5.25, capacity=128, cell_capacity=64)
    sel = model.select(pos, box, cells)
    for k, v in model.overflow_counts(pos, box, cells, sel).items():
        assert 0 < int(v) <= model.capacities(cells)[k], k
    return model.energy_and_forces_from_selection(params, pos, box, cells,
                                                  sel)


@pytest.mark.parametrize('move', ['rotation', 'translation', 'permutation'])
def test_invariance(move):
    """A cluster of waters centred in a 40 A box: the energy is unchanged
    (rtol 1e-5) by an arbitrary rotation about the centre, a translation
    and a permutation of the atoms, and the forces rotate and permute with
    them (within 1e-4 of their largest)."""
    model, params, box, pos = cluster_system()
    e, f = energy_and_forces(model, params, box, pos)
    assert float(torch.max(torch.abs(f))) > 1e-3
    if move == 'rotation':
        rot = torch.as_tensor(so3.rotation(5), dtype=torch.float32)
        moved = (pos - 20.0) @ rot.T + 20.0
        f_moved = f @ rot.T
    elif move == 'translation':
        moved, f_moved = pos + torch.tensor([3.1, -2.7, 1.4]), f
    else:
        perm = torch.randperm(pos.shape[0],
                              generator=torch.Generator().manual_seed(1))
        model = MACEModel.from_atomic_numbers(
            np.asarray([8, 1, 1] * (pos.shape[0] // 3))[perm.numpy()],
            model.config, [1, 8])
        moved, f_moved = pos[perm], f[perm]
    e2, f2 = energy_and_forces(model, params, box, moved)
    np.testing.assert_allclose(float(e2), float(e), rtol=1e-5)
    np.testing.assert_allclose(f2.numpy(), f_moved.numpy(), rtol=0,
                               atol=1e-4 * float(torch.max(torch.abs(f))))


def test_skin_lane_contributes_nothing():
    """Two atoms selected 4.9 A apart, then one moved to 5.1 A: the lane
    stays in the frozen selection (inside 5.25 A) past the 5 A cutoff, and
    gives exactly the energy of the two atoms far apart and exactly zero
    forces; at 4.9 A the forces are not zero."""
    model = MACEModel.from_atomic_numbers(
        [8, 1], MACEConfig(channels=F, avg_num_neighbors=1.0), [1, 8])
    params = model.init(torch.Generator().manual_seed(2), device='cpu')
    box = torch.eye(3) * 20.0
    cells = model.create_cell_list(box, skin=0.25)

    def at(dx):
        return torch.tensor([[2.0, 3.0, 4.0], [2.0 + dx, 3.0, 4.0]])

    sel = model.select(at(4.9), box, cells)
    assert bool(sel.mask.any(1).all())
    e_near, f_near = model.energy_and_forces_from_selection(
        params, at(4.9), box, cells, sel)
    e_skin, f_skin = model.energy_and_forces_from_selection(
        params, at(5.1), box, cells, sel)
    far = at(9.0)
    e_far, f_far = model.energy_and_forces_from_selection(
        params, far, box, cells, model.select(far, box, cells))
    assert float(torch.max(torch.abs(f_near))) > 0
    assert float(e_skin) == float(e_far)
    assert bool(torch.all(f_skin == 0)) and bool(torch.all(f_far == 0))


class _Ops(TorchDispatchMode):
    """Records the name of every ATen op dispatched, autograd's too."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.calls.append((str(func.overloadpacket.__name__), func, args,
                           kwargs))
        return func(*args, **kwargs)


def scatter_calls(fn) -> list:
    """The names of the accumulating scatters that ``fn`` dispatches."""
    with _Ops() as ops:
        fn()
    bad = []
    for name, func, args, kwargs in ops.calls:
        accumulate = (name.startswith('index_put')
                      and (kwargs.get('accumulate') or (
                          len(args) > 3 and args[3])))
        if 'index_add' in name or 'scatter' in name or accumulate:
            bad.append(name)
    return bad


def test_force_path_is_scatter_free(cell):
    """The whole force call, its backward included, dispatches no
    ``index_add``, no scatter and no accumulating ``index_put`` (each an
    atomic add on the card); a plain gather's adjoint does."""
    cfg, setup, model, cells, params, pos = cell
    sel = model.select(pos, setup.box, cells)
    assert scatter_calls(lambda: model.energy_and_forces_from_selection(
        params, pos, setup.box, cells, sel)) == []
    x = torch.ones(4, 3, requires_grad=True)
    assert 'index_add' in scatter_calls(lambda: torch.autograd.grad(
        x.index_select(0, torch.tensor([0, 0, 2])).sum(), x))


def test_sticky_md_drives_the_model(cell):
    """``run_md_sticky_counts`` for two 1-step blocks: finite energies and
    positions, every count within its capacity."""
    cfg, setup, model, cells, params, pos = cell
    i = cfg['integrator']
    r = inputs.restart(3, 0, setup.frame, setup.masses, i['kT'], 0.02)
    zeros = torch.zeros_like(pos)
    state = integrators.MDState(r.positions, r.velocities, zeros,
                                zeros.new_zeros(()), r.generator,
                                torch.zeros((), dtype=torch.int32))
    box = setup.box
    state, energies, stats = integrators.run_md_sticky_counts(
        lambda p: model.select(p, box, cells),
        lambda sel, p: model.energy_and_forces_from_selection(
            params, p, box, cells, sel),
        lambda fn: integrators.langevin_baoab(fn, setup.masses, i['dt'],
                                              i['friction'], i['kT']),
        state, 2, 1, lambda sel, p: model.overflow_counts(p, box, cells, sel))
    assert energies.shape == (2,) and bool(torch.isfinite(energies).all())
    assert bool(torch.isfinite(state.positions).all())
    caps = model.capacities(cells)
    assert set(stats) == set(caps)
    for k, v in stats.items():
        assert 0 < int(v) <= caps[k], k


# ---- The tables.


def fitted_d(l: int, rot: np.ndarray) -> np.ndarray:
    """The real D_l of ``rot`` fitted by least squares from the lanes'
    harmonics (``so3.spherical_harmonics``, float64)."""
    pts = torch.as_tensor(so3._sample_points(40, 3))
    a = so3.spherical_harmonics(pts)[:, so3.block(l)].numpy()
    b = so3.spherical_harmonics(pts @ torch.as_tensor(rot).T)[
        :, so3.block(l)].numpy()
    dt, *_ = np.linalg.lstsq(a, b, rcond=None)
    return dt.T


def big_d(rot: np.ndarray) -> np.ndarray:
    """D of 0e + 1o + 2e + 3o, block-diagonal [16, 16]."""
    d = np.zeros((16, 16))
    for l in range(4):
        d[so3.block(l), so3.block(l)] = fitted_d(l, rot)
    return d


def test_clebsch_gordan_orthonormal_and_equivariant():
    """Every C^{l1 l2 l3} with l1, l2, l3 <= 3 the triangle rule allows:
    an isometry of V_l3 into V_l1 (x) V_l2 (sum_{m1 m2} C C = identity),
    and C(D x, D y) = D C(x, y) for two random rotations, to 1e-10."""
    rots = [so3.rotation(s) for s in (101, 102)]
    for l1, l2, l3 in itertools.product(range(4), repeat=3):
        if not abs(l1 - l2) <= l3 <= l1 + l2:
            assert not so3.clebsch_gordan(l1, l2, l3).any()
            continue
        c = so3.clebsch_gordan(l1, l2, l3)
        np.testing.assert_allclose(np.einsum('abc,abd->cd', c, c),
                                   np.eye(2 * l3 + 1), atol=1e-10)
        for rot in rots:
            d1, d2, d3 = (fitted_d(l, rot) for l in (l1, l2, l3))
            np.testing.assert_allclose(
                np.einsum('abc,ai,bj->ijc', c, d1, d2),
                np.einsum('ijk,ck->ijc', c, d3), atol=1e-10)


def _character_count(nu: int, big_l: int) -> float:
    """dim Hom_O(3)(Sym^nu(0e + 1o + 2e + 3o), V_L of parity (-1)^L) by
    the character formula, numerically."""
    th = np.linspace(1e-7, np.pi, 200001)

    def chi(l, t):
        return np.sin((2 * l + 1) * t / 2) / np.sin(t / 2)

    def chi_v(t, s):
        return sum(s ** l * chi(l, t) for l in range(4))

    total = 0.0
    for s in (1, -1):
        if nu == 1:
            sym = chi_v(th, s)
        elif nu == 2:
            sym = (chi_v(th, s) ** 2 + chi_v(2 * th, 1)) / 2
        else:
            sym = (chi_v(th, s) ** 3 + 3 * chi_v(th, s) * chi_v(2 * th, 1)
                   + 2 * chi_v(3 * th, s)) / 6
        total += np.trapezoid((1 - np.cos(th)) / np.pi * sym
                              * chi(big_l, th) * s ** big_l, th) / 2
    return total


@pytest.mark.parametrize('nu, big_l, size', [(1, 0, 1), (2, 0, 4), (3, 0, 8),
                                             (1, 1, 1), (2, 1, 3),
                                             (3, 1, 12)])
def test_symmetric_basis(nu, big_l, size):
    """U^{nu,L}: its size pinned, and equal to the character formula's
    count; orthonormal; symmetric under every slot permutation;
    equivariant, U(D x, .., D x) = D_L U(x, .., x), for two random
    rotations, to 1e-10; equal to the plain reference's table to 1e-12."""
    u = so3.symmetric_basis(nu, big_l)
    assert u.shape == (16,) * nu + (2 * big_l + 1, size)
    assert round(_character_count(nu, big_l)) == size
    flat = u.reshape(-1, size)
    np.testing.assert_allclose(flat.T @ flat, np.eye(size), atol=1e-10)
    for p in itertools.permutations(range(nu)):
        np.testing.assert_allclose(np.transpose(u, p + (nu, nu + 1)), u,
                                   atol=1e-10)
    letters = 'abc'[:nu]
    for seed in (201, 202):
        rot = so3.rotation(seed)
        d, dl = big_d(rot), fitted_d(big_l, rot)
        lhs = u
        for slot in range(nu):
            lhs = np.moveaxis(np.tensordot(lhs, d, axes=([slot], [0])), -1,
                              slot)
        rhs = np.einsum(f'{letters}Kn,MK->{letters}Mn', u, dl)
        np.testing.assert_allclose(lhs, rhs, atol=1e-10)
    np.testing.assert_allclose(u, reference.basis(nu, big_l), rtol=0,
                               atol=1e-12)


def test_tables_equal_the_references():
    """The port's C (null space of fitted D's) equals the reference's
    (Racah's formula in the real basis) to 1e-12 for every l1, l2 <= 3,
    l3 <= 4; the lanes' harmonics equal the reference's to 1e-12."""
    for l1, l2, l3 in itertools.product(range(4), range(4), range(5)):
        np.testing.assert_allclose(so3.clebsch_gordan(l1, l2, l3),
                                   reference.clebsch_gordan(l1, l2, l3),
                                   rtol=0, atol=1e-12)
    u = torch.randn(50, 3, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    u = u / torch.linalg.norm(u, dim=1, keepdim=True)
    np.testing.assert_allclose(so3.spherical_harmonics(u).numpy(),
                               reference.harmonics(u).numpy(), rtol=0,
                               atol=1e-12)
    assert mace_ops.SILU_NORM == pytest.approx(reference.silu_norm(),
                                               rel=1e-14)
