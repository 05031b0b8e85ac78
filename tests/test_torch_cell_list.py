"""The port's cell list (``nnpops_tpu_torch.neighbors.cell_list``) against
the JAX package's on the same numpy inputs: the selection and its mirror
pairing (every integer field equal), the degenerate one-cell grid, the
payloads, the scatter-free distance payload and its position gradient, and
the half pair list."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.neighbors import window as jwindow
from nnpops_tpu.neighbors.cell_list import CellList as JCellList
from nnpops_tpu.neighbors.cell_list import \
    payload_to_half_pairs as j_half_pairs
from nnpops_tpu_torch.neighbors import window as twindow
from nnpops_tpu_torch.neighbors.cell_list import CellList, payload_to_half_pairs
from nnpops_tpu_torch.utils import make_triclinic_water_box, make_water_box

CUTOFF = 4.0
CAPACITY = 64


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on a few cores, where each torch op's thread pool would
    contend with the others' and with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def boxes():
    rect = make_water_box(300, seed=4)
    tri = make_triclinic_water_box(300, seed=0)
    # Wrapped: the same box with atoms moved by whole box vectors.
    shift = np.random.RandomState(5).randint(-2, 3, (len(rect.positions), 3))
    wrapped = (rect.positions + shift @ rect.box).astype(np.float32)
    return {'rectangular': (rect.positions, rect.box),
            'triclinic': (tri.positions, tri.box),
            'wrapped': (wrapped, rect.box)}


BOXES = boxes()


def selections(name, build_mirror=True, cutoff=CUTOFF, capacity=CAPACITY):
    pos, box = BOXES[name]
    jcl = JCellList.create(box, cutoff, capacity=capacity)
    tcl = CellList.create(box, cutoff, capacity=capacity)
    assert tcl.ncells == jcl.ncells and tcl.cell_capacity == jcl.cell_capacity
    jsel = jax.jit(jcl.select, static_argnums=(2,))(
        jnp.asarray(pos), jnp.asarray(box), build_mirror)
    tsel = tcl.select(torch.tensor(pos), torch.tensor(box),
                      build_mirror=build_mirror)
    return jcl, tcl, jsel, tsel


def assert_fields_equal(tsel, jsel):
    for f in jsel._fields:
        a, b = getattr(jsel, f), getattr(tsel, f)
        if a is None:
            assert b is None, f
            continue
        a = np.asarray(a)
        assert str(b.dtype).split('.')[-1] == str(a.dtype), f
        np.testing.assert_array_equal(b.numpy(), a, f)


@pytest.mark.parametrize('name', list(BOXES))
def test_select_with_mirror_equals_jax(name):
    jcl, _, jsel, tsel = selections(name)
    assert jcl.use_cells
    assert_fields_equal(tsel, jsel)
    k = CAPACITY
    assert int(tsel.max_neighbors) <= k       # below capacity: pairs intact
    # The mirror is an involution on the valid entries.
    mir = tsel.mirror.reshape(-1).long()
    valid = tsel.mask.reshape(-1)
    assert bool((mir[valid] < mir.numel()).all())
    assert torch.equal(mir[mir[valid]], torch.nonzero(valid)[:, 0])


def test_degenerate_grid_counts_each_neighbor_27_times():
    """200 atoms at density 0.1 and a 5 A cutoff make a box under 3 cells
    wide: one cell, whose 27 stencil entries all name it. ``select`` has no
    one-cell guard in either package, so every candidate is counted 27
    times; the port reproduces JAX's count, which the overflow check
    reports."""
    n = 200
    side = (n / 0.1) ** (1 / 3)
    pos = np.random.RandomState(0).rand(n, 3).astype(np.float32) * side
    box = np.diag([side] * 3).astype(np.float32)
    jcl = JCellList.create(box, 5.0, capacity=2048)
    tcl = CellList.create(box, 5.0, capacity=2048)
    assert tcl.ncells == (1, 1, 1) and not tcl.use_cells
    jsel = jcl.select(jnp.asarray(pos), jnp.asarray(box))
    tsel = tcl.select(torch.tensor(pos), torch.tensor(box))
    assert_fields_equal(tsel, jsel)
    d = pos[:, None] - pos[None]
    d -= np.round(d / side) * side
    d2 = (d * d).sum(-1)
    true_max = int(((d2 < 25.0) & ~np.eye(n, dtype=bool)).sum(1).max())
    assert int(tsel.max_neighbors) == 27 * true_max
    # build_payload takes the dense path on such a grid: true counts.
    payload = tcl.build_payload(torch.tensor(pos), torch.tensor(box))
    assert int(payload.max_neighbors) == true_max


def test_mirror_fallback_equals_jax():
    """Without grid information ``_mirror_packed`` pairs by sorted slot-pair
    keys: equal to JAX's on a two-tier packing."""
    _, _, jsel, tsel = selections('rectangular', build_mirror=False)
    cc = int(tsel.slot_to_atom.shape[0]) - 1
    half = tsel.nbr_slot_k.shape[0] // 2
    segs_t = [(tsel.slot_of_sorted[:half], tsel.nbr_slot_k[:half],
               tsel.mask[:half]),
              (tsel.slot_of_sorted[half:], tsel.nbr_slot_k[half:, :40],
               tsel.mask[half:, :40])]
    segs_j = [tuple(jnp.asarray(t.numpy()) for t in s) for s in segs_t]
    got = twindow._mirror_packed(segs_t, cc)
    want = jwindow._mirror_packed(segs_j, cc)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize('name', ['rectangular', 'triclinic'])
def test_payload_equals_jax(name):
    pos, box = BOXES[name]
    jcl, tcl, _, _ = selections(name, build_mirror=False)
    feats = np.random.RandomState(1).rand(len(pos), 2).astype(np.float32)
    jp = jcl.build_payload(jnp.asarray(pos), jnp.asarray(box),
                           jnp.asarray(feats))
    tp = tcl.build_payload(torch.tensor(pos), torch.tensor(box),
                           torch.tensor(feats))
    for f in ('indices', 'mask', 'max_neighbors', 'max_cell_occupancy'):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), f)
    for f in ('deltas', 'distances', 'features'):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)),
                                   rtol=1e-6, atol=1e-5, err_msg=f)
    jh, th = j_half_pairs(jp, 3.5), payload_to_half_pairs(tp, 3.5)
    for f in ('atom1', 'atom2', 'mask', 'num_pairs'):
        np.testing.assert_array_equal(getattr(th, f).numpy(),
                                      np.asarray(getattr(jh, f)), f)
    for f in ('deltas', 'distances'):
        np.testing.assert_allclose(getattr(th, f).numpy(),
                                   np.asarray(getattr(jh, f)),
                                   rtol=1e-6, atol=1e-5, err_msg=f)


def test_dense_payload_equals_jax():
    """A box under 3 cells wide: ``build_payload`` takes the dense path."""
    water = make_water_box(48, seed=2)
    jcl = JCellList.create(water.box, CUTOFF, capacity=CAPACITY)
    tcl = CellList.create(water.box, CUTOFF, capacity=CAPACITY)
    assert not tcl.use_cells
    jp = jcl.build_payload(jnp.asarray(water.positions),
                           jnp.asarray(water.box))
    tp = tcl.build_payload(torch.tensor(water.positions),
                           torch.tensor(water.box))
    for f in ('indices', 'mask', 'max_neighbors', 'max_cell_occupancy'):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), f)
    np.testing.assert_allclose(tp.distances.numpy(), np.asarray(jp.distances),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize('name', ['rectangular', 'triclinic'])
def test_distance_payload_and_gradient_equal_jax(name):
    """Values, indices and mask equal JAX's; the position gradient of a
    random linear function of the distances (the mirror-routed adjoint)
    agrees with JAX's at 1e-5 of its scale and with plain autograd through
    the generic payload."""
    pos, box = BOXES[name]
    jcl, tcl, jsel, tsel = selections(name)
    w = np.random.RandomState(2).randn(len(pos), CAPACITY).astype(np.float32)

    def jloss(p):
        d, _, _ = jcl.payload_distances_from_selection(p, jnp.asarray(box),
                                                       jsel)
        return jnp.sum(d * jnp.asarray(w))

    jd, ji, jm = jcl.payload_distances_from_selection(
        jnp.asarray(pos), jnp.asarray(box), jsel)
    jg = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(pos)))
    tpos = torch.tensor(pos, requires_grad=True)
    td, ti, tm = tcl.payload_distances_from_selection(tpos, torch.tensor(box),
                                                      tsel)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd),
                               rtol=1e-6, atol=1e-5)
    (tg,) = torch.autograd.grad(torch.sum(td * torch.tensor(w)), tpos)
    scale = np.abs(jg).max()
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=1e-5 * scale)
    # Against plain autograd through the payload (index_add adjoint).
    tpos2 = torch.tensor(pos, requires_grad=True)
    payload = tcl.payload_from_selection(tpos2, torch.tensor(box), tsel)
    (ref,) = torch.autograd.grad(torch.sum(payload.distances
                                           * torch.tensor(w)), tpos2)
    np.testing.assert_allclose(tg.numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * scale)


def test_distance_payload_needs_mirror():
    _, tcl, _, tsel = selections('rectangular', build_mirror=False)
    pos, box = BOXES['rectangular']
    with pytest.raises(ValueError, match='build_mirror'):
        tcl.payload_distances_from_selection(torch.tensor(pos),
                                             torch.tensor(box), tsel)


def test_perm_gather_adjoint_is_the_inverse_gather():
    perm = torch.randperm(7, generator=torch.Generator().manual_seed(0))
    inv = torch.empty_like(perm).index_copy_(0, perm, torch.arange(7))
    x = torch.randn(7, 2, dtype=torch.float64, requires_grad=True)
    y = twindow._perm_gather(x, perm, inv)
    assert torch.equal(y, x[perm])
    torch.autograd.gradcheck(lambda a: twindow._perm_gather(a, perm, inv),
                             (x,))
