"""PaiNN on the cell list's MD path (``PaiNNModel.from_atomic_numbers``:
``select``, ``energy_and_forces_from_selection``, ``overflow_counts``) on
the CPU, at width 16, 8 radial functions, 2 blocks and a 5 A cutoff (skin
0.25) on 300 waters (900 atoms: the 5.25 A cell list is three cells
wide): against the benchmark's plain reference
(``mdbench/reference/painn_cell_list.py``) on its seeded parameters; the
message's hand-written adjoint against plain autograd through the same
forward, in float64, and on CPU tensors taken by the plain chunks, never
the card's kernel (whose wrapper refuses what it is not built for); the
deltas payload's mirror-routed adjoint against
``payload_from_selection``'s ``index_add``; invariance under a translation
and the cubic box's symmetries; a lane of the Verlet skin contributing
exactly nothing; the parameters following the seed; two MD blocks."""
import numpy as np
import pytest
import torch

from mdbench import harness, inputs, painn_params
from mdbench.models import painn_cell_list as kind
from nnpops_tpu_torch import _kernels
from nnpops_tpu_torch.config import PaiNNConfig
from nnpops_tpu_torch.md import integrators
from nnpops_tpu_torch.models.painn import PaiNNModel
from nnpops_tpu_torch.neighbors.cell_list import lane_geometry
from nnpops_tpu_torch.ops import painn as painn_ops
from nnpops_tpu_torch.utils.profiling import recording

SMALL = dict(width=16, radial=8, interactions=2, cutoff=5.0, aev_length=16,
             layer_dims=[[8]])
SKIN = 0.25
SEED = 2 ** 33 + 5


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cell():
    cfg = harness.load_json('configs', 'painn')
    cfg.update(SMALL)
    traffic = harness.load_json('traffic', 'water26010-check1')
    traffic['molecules'] = 300
    return cfg, traffic


@pytest.fixture(scope='module')
def cell():
    """(cfg, setup, model, cell list, params, positions) at one seed."""
    cfg, traffic = small_cell()
    setup = harness.make_setup(cfg, traffic, SEED, 'cpu')
    model, cells = kind.painn_model(cfg, setup)
    params = kind.port_params(cfg, setup)
    r = inputs.restart(SEED, 0, setup.frame, setup.masses, 0.596, 0.02)
    return cfg, setup, model, cells, params, r.positions


def test_cell_list_sizes(cell):
    cfg, setup, model, cells, _, _ = cell
    assert model.num_interactions == 2 and model.num_species == 2
    assert model.config == PaiNNConfig(width=16, num_radial=8, cutoff=5.0)
    assert cells.cutoff == pytest.approx(5.25)
    assert cells.ncells == (3, 3, 3) and cells.capacity == 128
    assert model.species[:3] == (1, 0, 0)          # O, H, H
    with pytest.raises(ValueError):
        PaiNNConfig(width=0)


def test_equals_plain_reference(cell):
    """Energy rtol 1e-6, forces within 1e-5 of their largest (both float32
    on the CPU)."""
    cfg, setup, model, cells, params, pos = cell
    sel = model.select(pos, setup.box, cells)
    e, f = model.energy_and_forces_from_selection(params, pos, setup.box,
                                                  cells, sel)
    ref = harness.load_module(harness.HERE / 'reference'
                              / 'painn_cell_list.py').make(cfg, setup)
    er, fr, none = ref.energy_forces_and_ani(pos)
    assert none is None and er.dtype == torch.float64
    assert float(torch.max(torch.abs(fr))) > 0.1
    np.testing.assert_allclose(float(e), float(er), rtol=1e-6)
    np.testing.assert_allclose(f.numpy(), fr.numpy(), rtol=0,
                               atol=1e-5 * float(torch.max(torch.abs(fr))))


def lanes(cell):
    """The lanes of the cell's selection: (d, u, indices, mask), d and u in
    float64 (exactly symmetric: they come from float32 deltas)."""
    cfg, setup, model, cells, params, pos = cell
    sel = model.select(pos, setup.box, cells)
    deltas, idx, mask = cells.payload_deltas_from_selection(pos, setup.box,
                                                            sel)
    d, u = lane_geometry(deltas, mask)
    return d.double(), u.double(), idx, mask


@pytest.mark.parametrize('rows_per_chunk', [None, 97])
def test_message_adjoint_matches_autograd(cell, rows_per_chunk):
    """The hand-written backward (scatter-free: the row's atom's phi and v
    cotangents through the mirrored lanes) against autograd through the
    same forward, float64: the d, u, phi and v cotangents within 1e-10 of
    their largest; the values too, in one chunk or in chunks of 97 rows."""
    d, u, idx, mask = lanes(cell)
    n, k = d.shape
    config = cell[2].config
    f, r = config.width, config.num_radial
    gen = torch.Generator().manual_seed(3)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    phi, v = rand(n, 3 * f), rand(n, 3, f)
    wf, bf = rand(r, 3 * f) / 3, rand(3 * f) / 10
    gs, gv = rand(n, f), rand(n, 3, f)
    assert bool((mask & (d >= config.cutoff)).any())    # skin lanes
    out = {}
    for plain in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in (phi, v, d, u)]
        ms, mv = painn_ops.painn_message(*leaves, idx, mask, wf, bf, config,
                                         rows_per_chunk=rows_per_chunk,
                                         plain=plain)
        grads = torch.autograd.grad((ms * gs).sum() + (mv * gv).sum(),
                                    leaves)
        out[plain] = (ms.detach(), mv.detach()) + grads
    for name, a, b in zip(('m_s', 'm_v', 'phi', 'v', 'd', 'u'), out[False],
                          out[True]):
        scale = float(torch.max(torch.abs(b)))
        assert scale > 0, name
        assert float(torch.max(torch.abs(a - b))) <= 1e-10 * scale, name


def test_message_refuses_weight_gradients(cell):
    d, u, idx, mask = lanes(cell)
    config = cell[2].config
    n, f = d.shape[0], config.width
    wf = torch.zeros(config.num_radial, 3 * f, dtype=torch.float64,
                     requires_grad=True)
    with pytest.raises(RuntimeError, match='no weight gradients'):
        painn_ops.painn_message(torch.zeros(n, 3 * f, dtype=torch.float64),
                                torch.zeros(n, 3, f, dtype=torch.float64), d,
                                u, idx, mask, wf, torch.zeros(3 * f), config)


def test_message_backward_on_cpu_takes_plain_chunks(cell):
    """On CPU tensors the backward runs the plain ``_rows_backward`` once a
    chunk (10 chunks of at most 97 of the 900 rows) and launches no
    kernel."""
    d, u, idx, mask = lanes(cell)
    config = cell[2].config
    n, f = d.shape[0], config.width
    gen = torch.Generator().manual_seed(4)
    leaves = [torch.randn(*shape, generator=gen, dtype=torch.float64,
                          requires_grad=True)
              for shape in ((n, 3 * f), (n, 3, f))]
    wf = torch.randn(config.num_radial, 3 * f, generator=gen,
                     dtype=torch.float64)
    ms, mv = painn_ops.painn_message(*leaves, d, u, idx, mask, wf,
                                     torch.zeros(3 * f, dtype=torch.float64),
                                     config, rows_per_chunk=97)
    _kernels.reset_launch_counts()
    calls = []
    with recording(painn_ops, '_rows_backward', calls):
        grads = torch.autograd.grad(ms.sum() + mv.sum(), leaves)
    assert len(calls) == 10 and _kernels.LAUNCHES['painn_bwd'] == 0
    assert all(bool(g.abs().max() > 0) for g in grads)


@pytest.mark.parametrize('width, dtype', [(16, torch.float32),
                                          (32, torch.float64)])
def test_bwd_kernel_refuses_inputs(width, dtype):
    """The kernel's wrapper raises before any launch on a width the kernel
    is not built for and on inputs that are not float32."""
    n, k, r = 5, 4, 20

    def zeros(*shape, dtype=dtype):
        return torch.zeros(*shape, dtype=dtype)

    with pytest.raises(ValueError, match='width|expected'):
        painn_ops.painn_bwd_cuda(
            zeros(n + 1, 3 * width), zeros(n + 1, 3 * width), zeros(n, k),
            zeros(n, k, 3), zeros(n, k, dtype=torch.int64),
            zeros(n, k, dtype=torch.bool), zeros(r, 3 * width),
            zeros(3 * width), zeros(n, width), zeros(n, 3, width), 5.0)
    assert _kernels.LAUNCHES['painn_bwd'] == 0


def test_deltas_payload_adjoint(cell):
    """``payload_deltas_from_selection`` (mirror-routed adjoint) against
    ``payload_from_selection`` (autograd's ``index_add``), float64: the
    same deltas, indices and mask, and the same position gradient for a
    random cotangent."""
    cfg, setup, model, cells, params, pos = cell
    sel = model.select(pos, setup.box, cells)
    box = setup.box.double()
    g = torch.randn((pos.shape[0], cells.capacity, 3),
                    generator=torch.Generator().manual_seed(4),
                    dtype=torch.float64)
    p1 = pos.double().requires_grad_(True)
    deltas, idx, mask = cells.payload_deltas_from_selection(p1, box, sel)
    p2 = pos.double().requires_grad_(True)
    payload = cells.payload_from_selection(p2, box, sel)
    assert torch.equal(deltas, payload.deltas)
    assert torch.equal(idx, payload.indices)
    assert torch.equal(mask, payload.mask)
    (a,) = torch.autograd.grad((deltas * g).sum(), p1)
    (b,) = torch.autograd.grad((payload.deltas * g).sum(), p2)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                               atol=1e-12 * float(torch.max(torch.abs(b))))
    with pytest.raises(ValueError, match='build_mirror'):
        cells.payload_deltas_from_selection(pos, setup.box,
                                            sel._replace(mirror=None))


def energy_and_forces(cell, pos):
    _, setup, model, cells, params, _ = cell
    sel = model.select(pos, setup.box, cells)
    return model.energy_and_forces_from_selection(params, pos, setup.box,
                                                  cells, sel)


@pytest.mark.parametrize('move', ['translation', 'permutation',
                                  'rotation'])
def test_invariance(cell, move):
    """The energy is unchanged (rtol 1e-5) by a translation, a cyclic
    permutation of the axes and a 90 degree rotation about z of the cubic
    box, and the forces move with the atoms (within 1e-4 of their
    largest)."""
    pos = cell[5]
    edge = float(cell[1].box[0, 0])
    e, f = energy_and_forces(cell, pos)
    if move == 'translation':
        moved = torch.remainder(pos + torch.tensor([3.1, -7.7, 12.4]), edge)
        f_moved = f
    elif move == 'permutation':
        moved, f_moved = pos[:, [1, 2, 0]], f[:, [1, 2, 0]]
    else:
        moved = torch.stack([edge - pos[:, 1], pos[:, 0], pos[:, 2]], 1)
        f_moved = torch.stack([-f[:, 1], f[:, 0], f[:, 2]], 1)
    e2, f2 = energy_and_forces(cell, moved)
    np.testing.assert_allclose(float(e2), float(e), rtol=1e-5)
    np.testing.assert_allclose(f2.numpy(), f_moved.numpy(), rtol=0,
                               atol=1e-4 * float(torch.max(torch.abs(f))))


def test_skin_lane_contributes_nothing():
    """Two atoms selected 4.9 A apart, then one moved to 5.1 A: the lane
    stays in the frozen selection (inside 5.25 A) past the 5 A cutoff, and
    gives exactly the energy of the two atoms far apart and exactly zero
    forces; at 4.9 A the forces are not zero."""
    model = PaiNNModel.from_atomic_numbers(
        [8, 1], PaiNNConfig(width=16, num_radial=8, cutoff=5.0), [1, 8],
        num_interactions=2)
    params = model.init(torch.Generator().manual_seed(2), device='cpu')
    box = torch.eye(3) * 20.0
    cells = model.create_cell_list(box, skin=SKIN)

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


def test_params_follow_the_seed():
    cfg, _ = small_cell()

    def draw(seed):
        w = inputs.make_weights(seed, cfg['layer_dims'], cfg['aev_length'],
                                cfg['num_models'], cfg['bias_scale'], 'cpu')
        return painn_params.make(cfg, w, 'cpu')

    a, b, c = draw(2 ** 33 + 1), draw(2 ** 33 + 1), draw(2 ** 33 + 2)
    assert a.blocks[1].filter_w.shape == (8, 48)
    assert a.blocks[0].uv.shape == (16, 32) and a.readout1_w.shape == (16, 8)
    for x, y, z in zip(a.blocks[0] + (a.embedding,),
                       b.blocks[0] + (b.embedding,),
                       c.blocks[0] + (c.embedding,)):
        assert torch.equal(x, y)
        assert torch.any(x) and not torch.equal(x, z)
    assert not torch.equal(a.readout1_w, c.readout1_w)


def test_sticky_md_drives_the_model(cell):
    """``run_md_sticky_counts`` for two 4-step blocks: finite energies and
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
        state, 8, 4, lambda sel, p: model.overflow_counts(p, box, cells, sel))
    assert energies.shape == (2,) and bool(torch.isfinite(energies).all())
    assert bool(torch.isfinite(state.positions).all())
    caps = model.capacities(cells)
    assert set(stats) == set(caps)
    for k, v in stats.items():
        assert 0 < int(v) <= caps[k], k
