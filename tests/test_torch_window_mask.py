"""The 'mask' and 'sort' compactions of the window selection
(``select_window(compact_impl=...)``) against the JAX package's on
water(150), and the two 'mask' kernels' plain versions (``ops.cuda_select``
``window_mask``, ``left_pack_lanes``) against the JAX Pallas kernels
(``make_window_mask``, ``make_left_pack_lanes``, interpret mode).

Every comparison here is exact: the masks, the packed lanes and counts,
and the selections' integer fields, lane order included (the JAX suite
compares the compactions' neighbour sets, ``test_window_aev.py:257-336``;
the port holds each compaction to JAX's own lists)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.config import ANIBasis as JBasis
from nnpops_tpu.models.ani import ANIModel as JModel
from nnpops_tpu.neighbors.window import select_window as j_select_window
from nnpops_tpu.ops.pallas_select import (make_left_pack_lanes,
                                          make_window_mask)
from nnpops_tpu_torch.config import ANIBasis
from nnpops_tpu_torch.models.ani import ANIModel
from nnpops_tpu_torch.neighbors import window as window_mod
from nnpops_tpu_torch.neighbors.window import select_window
from nnpops_tpu_torch.ops.cuda_select import (left_pack_lanes,
                                              left_pack_lanes_plain,
                                              window_mask, window_mask_plain)
from nnpops_tpu_torch.profile_step import recording
from nnpops_tpu_torch.utils import make_water_box

SKIN = 0.25
MARGIN = 1.15
IMPLS = ('kernel', 'mask', 'sort')


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on a few cores, where each torch op's thread pool would
    contend with the others' and with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def system():
    water = make_water_box(150, seed=0)
    model = ANIModel.from_atomic_numbers(
        water.atomic_numbers, ANIBasis.ani2x()).with_blocked_layout(
            water.positions, water.box, margin=MARGIN, impl='window',
            skin=SKIN)
    cl = model.create_cell_list(water.box, skin=SKIN)
    pos, box = torch.tensor(water.positions), torch.tensor(water.box)
    g = model.grouping
    layout = model.blocked_layout
    kw = dict(species=model.species_array, layout=layout,
              radial_cutoff=model.basis.radial_cutoff,
              angular_cutoff=model.basis.angular_cutoff,
              grouping_order=np.asarray(g.order),
              present_counts=tuple(g.counts[s] for s in layout.present))
    return water, model, cl, pos, box, kw


@pytest.fixture(scope='module')
def port_selections(system):
    """The port's three selections, and the mask kernels' recorded calls of
    the 'mask' one."""
    _, _, cl, pos, box, kw = system
    sels = {impl: select_window(cl, pos, box, compact_impl=impl, **kw)
            for impl in ('kernel', 'sort')}
    masks, packs = [], []
    with recording(window_mod, 'window_mask', masks), \
            recording(window_mod, 'left_pack_lanes', packs):
        sels['mask'] = select_window(cl, pos, box, compact_impl='mask', **kw)
    assert len(masks) == len(packs) == 1
    return sels, masks[0][0], packs[0][0]


@pytest.fixture(scope='module')
def jax_selections(system):
    water, _, _, _, _, kw = system
    jm = JModel.from_atomic_numbers(
        water.atomic_numbers, JBasis.ani2x()).with_blocked_layout(
            water.positions, water.box, margin=MARGIN, impl='window',
            skin=SKIN)
    jcl = jm.create_cell_list(water.box, skin=SKIN)
    jpos, jbox = jnp.asarray(water.positions), jnp.asarray(water.box)
    out = {}
    for impl in ('mask', 'sort'):
        fn = functools.partial(j_select_window, jcl, compact_impl=impl,
                               need_shift_planes=True, **kw)
        out[impl] = jax.jit(fn)(jpos, jbox)
    return out


def equal(name, got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, name)


def assert_selections_equal(got, want):
    for f in ('order', 'slot_of_sorted', 'inv_order', 'slot_to_atom',
              'nbr_rad', 'rad_mask', 'max_rad', 'max_ang', 'ang_in_rad'):
        equal('ang.' + f, getattr(got.ang, f), getattr(want.ang, f))
    assert (got.tier is None) == (want.tier is None)
    if got.tier is not None:
        for f in ('row_order', 'row_atom', 'tier_counts', 'concat_pos'):
            equal('tier.' + f, getattr(got.tier, f), getattr(want.tier, f))
        for t in range(len(want.tier.idx)):
            for f in ('idx', 'mask', 'slot_rows'):
                equal(f'tier.{f}[{t}]', getattr(got.tier, f)[t],
                      getattr(want.tier, f)[t])


@pytest.mark.parametrize('impl', ['mask', 'sort'])
def test_selection_matches_jax(port_selections, jax_selections, impl):
    sels, _, _ = port_selections
    assert sels[impl].tier is not None
    assert_selections_equal(sels[impl], jax_selections[impl])


def test_mask_selection_equals_kernel_selection(port_selections):
    """'mask' gives the default compaction's lists: the same sets, the same
    entry-major lane order, the same counts."""
    sels, _, _ = port_selections
    assert_selections_equal(sels['mask'], sels['kernel'])


def test_sort_selection_has_kernel_sets(system, port_selections):
    """'sort' keeps the same neighbour set per (row, species block), with
    slot-ascending lanes."""
    layout = system[1].blocked_layout
    sels, _, _ = port_selections
    k, s = sels['kernel'].ang, sels['sort'].ang
    equal('max_ang', s.max_ang, k.max_ang)
    offs = np.cumsum((0,) + tuple(layout.ang_caps))
    for b in range(len(layout.ang_caps)):
        blk = slice(offs[b], offs[b + 1])
        equal(f'block {b}', torch.sort(s.nbr_rad[:, blk], 1).values,
              torch.sort(k.nbr_rad[:, blk], 1).values)
        assert torch.all(s.nbr_rad[:, blk][:, 1:] >= s.nbr_rad[:, blk][:, :-1])


def test_window_mask_plain_matches_jax(port_selections):
    _, (cx, cy, cz, centers, w2, caps), _ = port_selections
    got = window_mask_plain(cx, cy, cz, centers, w2, caps)
    want = make_window_mask(float(w2), tuple(caps), interpret=True)(
        *(jnp.asarray(t.numpy()) for t in (cx, cy, cz, centers)))
    assert got.dtype == torch.bool
    equal('mask', got, np.asarray(want) != 0)
    assert 0 < int(got.sum()) < got.numel()
    assert torch.equal(window_mask(cx, cy, cz, centers, w2, caps), got)


def jax_left_pack_lanes(mask, widths, caps):
    """The JAX call as ``_compact_window_mask`` makes it: each block padded
    with zeros to a multiple of 128 lanes; f32 lanes and counts."""
    parts, off = [], 0
    for w in widths:
        parts.append(np.pad(mask[:, off:off + w], ((0, 0), (0, -w % 128))))
        off += w
    lanes, counts = make_left_pack_lanes(tuple(widths), tuple(caps),
                                         interpret=True)(
        jnp.asarray(np.concatenate(parts, 1).astype(np.float32)))
    return (np.asarray(lanes).astype(np.int32),
            np.asarray(counts).astype(np.int32))


def random_mask(rows, widths, density, seed):
    rng = np.random.RandomState(seed)
    p = np.clip(rng.normal(density, density / 2, (rows, 1)), 0.0, 1.0)
    return rng.rand(rows, sum(widths)) < p


@pytest.mark.parametrize('widths, caps, density', [
    ((351, 216), (40, 24), 0.08),          # water(150)'s angular grid
    ((100, 37, 64), (9, 5, 64), 0.2),      # three blocks, one cap = width
], ids=['water150', 'three-blocks'])
def test_left_pack_lanes_plain_matches_jax(widths, caps, density):
    mask = random_mask(203, widths, density, seed=sum(widths))
    lanes, counts = left_pack_lanes_plain(torch.tensor(mask), widths, caps)
    j_lanes, j_counts = jax_left_pack_lanes(mask, widths, caps)
    assert lanes.dtype == counts.dtype == torch.int32
    equal('lanes', lanes, j_lanes)
    equal('counts', counts, j_counts)
    over = counts.numpy() > np.asarray(caps)
    assert over.any() and (~over).any()        # both regimes are exercised


def test_left_pack_lanes_plain_matches_jax_on_selection(port_selections):
    """On the mask rows the 'mask' selection packs."""
    _, _, (m_atom, widths, caps) = port_selections
    lanes, counts = left_pack_lanes(m_atom, widths, caps)
    j_lanes, j_counts = jax_left_pack_lanes(m_atom.numpy(), widths, caps)
    equal('lanes', lanes, j_lanes)
    equal('counts', counts, j_counts)


def test_mask_wrappers_reject_bad_input(port_selections):
    _, (cx, cy, cz, centers, w2, caps), _ = port_selections
    with pytest.raises(ValueError, match='centers'):
        window_mask(cx, cy, cz, centers[:, 1:], w2, caps)
    with pytest.raises(ValueError, match='float32'):
        window_mask(cx.double(), cy, cz, centers, w2, caps)
    mask = torch.zeros(4, 10, dtype=torch.bool)
    with pytest.raises(ValueError, match='bool'):
        left_pack_lanes(mask.int(), (6, 4), (2, 2))
    with pytest.raises(ValueError, match=r'\[N, 11\]'):
        left_pack_lanes(mask, (6, 5), (2, 2))
    with pytest.raises(ValueError, match='compact_impl'):
        select_window(None, None, None, None, None, 0.0, 0.0,
                      compact_impl='bitonic')
