"""The window radial AEV's plain version (``ops.cuda_window``) against the
JAX package's Pallas kernel (interpret mode on the CPU) on water(150)'s
real 27-cell windows: the forward and the gradient of ``sum(out^2)``, with
full center rows and with packed center rows (``center_caps``, the
bucketed small-cell class)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.ops.pallas_window import window_radial_aev
from nnpops_tpu_torch.config import ANIBasis
from nnpops_tpu_torch.models.ani import ANIModel
from nnpops_tpu_torch.neighbors.window import (_grid_device_tables,
                                               _window_tables,
                                               radial_window_inputs)
from nnpops_tpu_torch.ops.cuda_window import (EMPTY_ROW, WindowGeometry,
                                              window_radial,
                                              window_radial_plain,
                                              window_runs)
from nnpops_tpu_torch.utils import make_water_box

SKIN = 0.25


@pytest.fixture(scope='module')
def windows():
    """(candx, candy, candz, centers, basis, cell_caps) as numpy, built by
    the port's window selection the way ``window_features`` builds them."""
    water = make_water_box(150, seed=0)
    basis = ANIBasis.ani2x()
    model = ANIModel.from_atomic_numbers(water.atomic_numbers, basis
                                         ).with_blocked_layout(
        water.positions, water.box, margin=1.15, impl='window', skin=SKIN)
    cl = model.create_cell_list(water.box, skin=SKIN)
    pos, box = torch.tensor(water.positions), torch.tensor(water.box)
    wsel = model.select(pos, box, cl)
    caps = tuple(model.blocked_layout.cell_caps)
    win, centers = radial_window_inputs(cl, pos, wsel, model.blocked_layout)
    return (win[0].numpy(), win[1].numpy(), win[2].numpy(), centers.numpy(),
            basis, caps)


def pack_centers(centers, cell_caps, center_caps):
    offs = np.cumsum((0,) + cell_caps)[:-1]
    return np.concatenate([centers[:, o:o + s]
                           for o, s in zip(offs, center_caps)], 1)


def run_both(windows, packed):
    cx, cy, cz, centers, basis, caps = windows
    center_caps = tuple(max(c - 4, 1) for c in caps) if packed else None
    if packed:
        centers = pack_centers(centers, caps, center_caps)
    args = (basis.radial_cutoff, basis.radial_eta, basis.radial_rs, caps,
            basis.torchani)

    def j_fn(x, y, z, ctr):
        return window_radial_aev(x, y, z, ctr, *args, interpret=True,
                                 center_caps=center_caps)

    j_in = [jnp.asarray(a) for a in (cx, cy, cz, centers)]
    j_out = jax.jit(j_fn)(*j_in)
    j_grads = jax.jit(jax.grad(lambda *a: jnp.sum(j_fn(*a) ** 2),
                               argnums=(0, 1, 2, 3)))(*j_in)
    t_in = [torch.tensor(a).requires_grad_(True) for a in (cx, cy, cz, centers)]
    t_out = window_radial_plain(*t_in, *args, center_caps=center_caps)
    t_grads = torch.autograd.grad(t_out.square().sum(), t_in)
    return centers, t_out, j_out, t_grads, j_grads


@pytest.mark.parametrize('packed', [False, True],
                         ids=['full-rows', 'center-caps'])
def test_window_radial_plain_matches_jax(windows, packed):
    centers, t_out, j_out, t_grads, j_grads = run_both(windows, packed)
    real = centers[:, :, 0] < EMPTY_ROW
    assert real.any() and (~real).any()
    t_out, j_out = t_out.detach().numpy(), np.asarray(j_out)
    assert t_out.shape == j_out.shape
    # Empty slots' rows are never read; the port writes them as 0 (see
    # ops.cuda_window), the Pallas kernel pairs FAR with FAR.
    assert not t_out[~real].any()
    scale = np.abs(j_out[real]).max()
    np.testing.assert_allclose(t_out[real], j_out[real], rtol=1e-5,
                               atol=1e-6 * scale)
    for name, tg, jg in zip(('dcandx', 'dcandy', 'dcandz', 'dcenters'),
                            t_grads, j_grads):
        tg, jg = tg.numpy(), np.asarray(jg)
        assert np.isfinite(tg).all(), name
        np.testing.assert_allclose(tg, jg, rtol=1e-4,
                                   atol=1e-5 * np.abs(jg).max(), err_msg=name)


def test_window_radial_cpu_dispatch_is_plain(windows):
    cx, cy, cz, centers, basis, caps = windows
    args = (basis.radial_cutoff, basis.radial_eta, basis.radial_rs, caps,
            basis.torchani)
    t_in = [torch.tensor(a) for a in (cx, cy, cz, centers)]
    assert torch.equal(window_radial(*t_in, *args),
                       window_radial_plain(*t_in, *args))


def test_window_radial_rejects_bad_center_caps(windows):
    cx, cy, cz, centers, basis, caps = windows
    t_in = [torch.tensor(a) for a in (cx, cy, cz, centers)]
    with pytest.raises(ValueError, match='center_caps'):
        window_radial_plain(*t_in, basis.radial_cutoff, basis.radial_eta,
                            basis.radial_rs, caps, basis.torchani,
                            center_caps=tuple(c + 1 for c in caps))


def test_window_radial_needs_eta_per_radial_function(windows):
    cx, cy, cz, centers, basis, caps = windows
    t_in = [torch.tensor(a) for a in (cx, cy, cz, centers)]
    with pytest.raises(ValueError, match='radial_eta'):
        window_radial_plain(*t_in, basis.radial_cutoff, basis.radial_eta[:1],
                            basis.radial_rs, caps, basis.torchani)


@pytest.mark.parametrize('packed', [False, True],
                         ids=['full-rows', 'center-caps'])
def test_window_runs_match_lane_slots(packed):
    """The kernel's run table (``cuda_window.window_runs``) against the
    window's lane table (``_grid_device_tables``, the slot of every window
    lane) and ``WindowGeometry``: runs tile the window in order, run 27 s +
    e holds present species s's slots of stencil entry e's cell in rank
    order inside species s's lane block, and every center row's self lane
    is its own rank in run (s, 13). On water(150)'s selection the occupied
    lanes lead every run (the slots fill by rank), so the kernel, which
    cuts each run at its last occupied lane, tests no empty lane."""
    water = make_water_box(150, seed=0)
    model = ANIModel.from_atomic_numbers(water.atomic_numbers,
                                         ANIBasis.ani2x()
                                         ).with_blocked_layout(
        water.positions, water.box, margin=1.15, impl='window', skin=SKIN)
    cl = model.create_cell_list(water.box, skin=SKIN)
    caps = tuple(model.blocked_layout.cell_caps)
    center_caps = tuple(max(c - 4, 1) for c in caps) if packed else None
    geo = WindowGeometry(caps, center_caps)
    first, length = window_runs(geo)
    assert len(first) == 27 * geo.npres
    assert first[0] == 0 and (first[1:] == first[:-1] + length[:-1]).all()
    assert first[-1] + length[-1] == geo.kk
    grid = tuple(int(x) for x in cl.ncells)
    _, cand_slot = _grid_device_tables(grid, caps, torch.device('cpu'))
    cand_slot = cand_slot.numpy()
    stencil = _window_tables(grid)[1]
    offs = np.cumsum((0,) + caps)[:-1]
    for s, ((lo, hi), cs) in enumerate(zip(geo.bounds, caps)):
        for e in range(27):
            r = 27 * s + e
            assert length[r] == cs and lo <= first[r] < first[r] + cs <= hi
            np.testing.assert_array_equal(
                cand_slot[:, first[r]:first[r] + cs],
                stencil[:, e:e + 1] * geo.c + offs[s] + np.arange(cs))
    for s, (o, n) in enumerate(zip(geo.ctr_offs, geo.center_caps)):
        rows = np.arange(o, o + n)
        np.testing.assert_array_equal(geo.self_lane[rows],
                                      first[27 * s + 13] + rows - o)
    pos, box = torch.tensor(water.positions), torch.tensor(water.box)
    win, _ = radial_window_inputs(cl, pos, model.select(pos, box, cl),
                                  model.blocked_layout)
    occ = win[0].numpy() < EMPTY_ROW
    assert (~occ).any()
    for f, n in zip(first, length):
        run = occ[:, f:f + n]
        assert not (run[:, 1:] & ~run[:, :-1]).any()
