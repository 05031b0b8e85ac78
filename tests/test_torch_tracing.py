"""The port's spans and upload counter (``utils.profiling.span``,
``COUNTERS``) and its call recorder (``recording``) on the window path, water(150) on the CPU: with no profiler
a span is one shared no-op and never makes a ``record_function``; under
``torch.profiler`` a refresh block's trace holds the span tree, each
sub-span inside its parent; and a selection's uploads and table builds
are counted, a cold one's (every cache empty) and a warm one's (none).
SchNet's, PaiNN's and MACE's cell-list MD paths, water(300): their span
trees, their CFConv, PaiNN and MACE lanes, MACE's contractions and no
upload in a warm block."""
import dataclasses
import json

import pytest
import torch

from nnpops_tpu_torch.config import (ANIBasis, CFConvConfig, MACEConfig,
                                     PaiNNConfig)
from nnpops_tpu_torch.md import MDState, langevin_baoab, run_md_sticky_counts
from nnpops_tpu_torch.models.ani import ANIModel, init_ani_params
from nnpops_tpu_torch.models.mace import MACEModel
from nnpops_tpu_torch.models.painn import PaiNNModel
from nnpops_tpu_torch.models.schnet import SchNetModel
from nnpops_tpu_torch.neighbors import window
from nnpops_tpu_torch.ops.aev_blocked import device_constant
from nnpops_tpu_torch.utils import make_water_box, profiling

SKIN = 0.25
SELECT = ('select.species', 'select.grid_sort', 'select.big_cells',
          'select.candidates', 'select.left_pack', 'select.tiers')
FORCE = ('force.aev', 'force.ensemble', 'force.backward')


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def system():
    water = make_water_box(150, seed=0)
    basis = ANIBasis.ani2x()
    model = ANIModel.from_atomic_numbers(
        water.atomic_numbers, basis, nn_impl='fused').with_blocked_layout(
            water.positions, water.box, margin=1.15, impl='window', skin=SKIN)
    assert model.aev_impl == 'window'
    cl = model.create_cell_list(water.box, skin=SKIN)
    params = init_ani_params(torch.Generator().manual_seed(0), basis,
                             num_models=2, device='cpu')
    pos, box = torch.tensor(water.positions), torch.tensor(water.box)
    return model, cl, params, pos, box


def test_span_off_is_one_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    assert profiling.span('select') is profiling.span('force.aev')
    with profiling.span('select'), profiling.span('select.tiers'):
        pass


def test_recording_keeps_calls_and_restores():
    """``recording`` appends each call's (args, kwargs), the wrapped
    function still runs and returns, and the original is back after the
    block, also when the block raises."""
    real = window.left_pack
    calls = []
    with profiling.recording(window, 'left_pack', calls) as got:
        assert got is calls and window.left_pack is not real
        keys = torch.tensor([[3, -1, 5, 7]], dtype=torch.int32)
        out = window.left_pack(keys, (4,), caps=(2,))
        window.left_pack(keys, (4,), (1,))
    assert window.left_pack is real
    for a, b in zip(out, real(keys, (4,), (2,))):
        assert torch.equal(a, b)
    assert [(len(args), sorted(kw)) for args, kw in calls] == [
        (2, ['caps']), (3, [])]
    assert calls[0][0][0] is keys and calls[1][0][2] == (1,)
    with pytest.raises(ZeroDivisionError):
        with profiling.recording(window, 'left_pack', calls):
            1 / 0
    assert window.left_pack is real and len(calls) == 2


def test_no_record_function_without_profiler(system, monkeypatch):
    model, cl, params, pos, box = system

    def refuse(*args, **kwargs):
        raise AssertionError('record_function made with no profiler')

    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    sel = model.select(pos, box, cl)
    model.energy_and_forces_from_selection(params, pos, box, cl, sel)
    model.overflow_counts(pos, box, cl, sel)


def _ranges(path):
    with open(path) as f:
        events = json.load(f)['traceEvents']
    out = {}
    for e in events:
        if (e.get('ph') == 'X' and e.get('cat') == 'user_annotation'
                and e['name'].startswith('nnpops.')):
            out.setdefault(e['name'][len('nnpops.'):], []).append(
                (e['ts'], e['ts'] + e['dur']))
    return out


def _inside(r, outer):
    return any(s <= r[0] and r[1] <= e for s, e in outer)


def test_span_tree_under_profiler(system, tmp_path):
    """One refresh block (a selection, the force call at its start, one
    BAOAB step's force call) and the counts, profiled."""
    model, cl, params, pos, box = system
    masses = torch.ones(pos.shape[0])
    zeros = torch.zeros_like(pos)
    state = MDState(pos, zeros, zeros, zeros.new_zeros(()),
                    torch.Generator().manual_seed(1),
                    torch.zeros((), dtype=torch.int32))
    with profiling.trace(str(tmp_path)):
        run_md_sticky_counts(
            lambda p: model.select(p, box, cl),
            lambda sel, p: model.energy_and_forces_from_selection(
                params, p, box, cl, sel),
            lambda f: langevin_baoab(f, masses, 1e-4, 1.0, 0.0), state, 1, 1,
            lambda sel, p: model.overflow_counts(p, box, cl, sel))
    ranges = _ranges(tmp_path / 'trace.json')
    # The layout plans one angular grid apart from the radial one.
    counts = {name: len(r) for name, r in ranges.items()}
    assert counts == {'md.block': 1, 'select': 1, 'select.species': 1,
                      'select.grid_sort': 2, 'select.big_cells': 1,
                      'select.candidates': 1, 'select.left_pack': 1,
                      'select.tiers': 1, 'force': 2, 'force.aev': 2,
                      'force.ensemble': 2, 'force.backward': 2, 'counts': 1}
    block = ranges['md.block']
    for name in ('select', 'force'):
        assert all(_inside(r, block) for r in ranges[name]), name
    assert not any(_inside(r, block) for r in ranges['counts'])
    for name in SELECT:
        assert all(_inside(r, ranges['select']) for r in ranges[name]), name
    for name in FORCE:
        assert all(_inside(r, ranges['force']) for r in ranges[name]), name
    # The force phases run in order within each call.
    for k in range(2):
        aev, ens, bwd = (ranges[name][k] for name in FORCE)
        assert aev[1] <= ens[0] and ens[1] <= bwd[0]


def test_selection_uploads_counted(system, monkeypatch):
    """A cold selection (a fresh copy of the model, every cache empty)
    builds the model's device tables once (two uploads: the grouping order
    and the species ids) and uploads each ``device_constant`` it misses,
    the two grids' device tables (two tensors each) and ``concat_pos``. A
    warm one uploads and builds nothing: its ``device_constant`` calls all
    hit the cache, and none asks for a table longer than ``num_species +
    1``."""
    model, cl, params, pos, box = system
    model = dataclasses.replace(model)
    device_constant.cache_clear()
    window._grid_device_tables.cache_clear()
    window._tier_device_tables.cache_clear()
    profiling.reset_counters()
    model.select(pos, box, cl)
    cold = dict(profiling.COUNTERS)
    misses = device_constant.cache_info().misses
    assert misses == 9
    assert cold == {'uploads': misses + 2 + 4 + 1, 'upload_bytes': 517380,
                    'selection_table_builds': 1, 'cfconv_lanes': 0,
                    'painn_lanes': 0, 'mace_lanes': 0,
                    'mace_contractions': 0}

    lengths = []

    def recorded(values, dtype, device):
        lengths.append(len(values))
        return device_constant(values, dtype, device)

    monkeypatch.setattr(window, 'device_constant', recorded)
    profiling.reset_counters()
    model.select(pos, box, cl)
    assert profiling.COUNTERS == {'uploads': 0, 'upload_bytes': 0,
                                  'selection_table_builds': 0,
                                  'cfconv_lanes': 0, 'painn_lanes': 0,
                                  'mace_lanes': 0, 'mace_contractions': 0}
    assert lengths and max(lengths) <= model.basis.num_species + 1
    info = device_constant.cache_info()
    assert (info.misses, info.hits) == (misses, misses)


SCHNET_FORCE = ('force.distances', 'force.interaction', 'force.readout',
                'force.backward')


@pytest.fixture(scope='module')
def schnet_system():
    water = make_water_box(300, seed=0)
    config = CFConvConfig(width=16, num_gaussians=8, cutoff=6.0,
                          gaussian_width=6.0 / 7)
    model = SchNetModel.from_atomic_numbers(water.atomic_numbers, config,
                                            [1, 8], num_interactions=6)
    cl = model.create_cell_list(water.box, skin=SKIN)
    params = model.init(torch.Generator().manual_seed(0), device='cpu')
    return (model, cl, params, torch.tensor(water.positions),
            torch.tensor(water.box))


def _cell_list_block(system):
    model, cl, params, pos, box = system
    zeros = torch.zeros_like(pos)
    state = MDState(pos, zeros, zeros, zeros.new_zeros(()),
                    torch.Generator().manual_seed(1),
                    torch.zeros((), dtype=torch.int32))
    run_md_sticky_counts(
        lambda p: model.select(p, box, cl),
        lambda sel, p: model.energy_and_forces_from_selection(
            params, p, box, cl, sel),
        lambda f: langevin_baoab(f, torch.ones(pos.shape[0]), 1e-4, 1.0,
                                 0.0), state, 1, 1,
        lambda sel, p: model.overflow_counts(p, box, cl, sel))


def test_schnet_span_tree_and_lanes(schnet_system, tmp_path):
    """A warm SchNet refresh block (a selection, two force calls, the
    counts) uploads nothing and counts N x K lanes for each of the six
    convolutions of each force call; profiled, its spans nest as the
    window path's do, the force phases in order."""
    model, cl, _, pos, _ = schnet_system
    _cell_list_block(schnet_system)
    profiling.reset_counters()
    _cell_list_block(schnet_system)
    assert profiling.COUNTERS == {
        'uploads': 0, 'upload_bytes': 0, 'selection_table_builds': 0,
        'cfconv_lanes': 2 * 6 * pos.shape[0] * cl.capacity,
        'painn_lanes': 0, 'mace_lanes': 0, 'mace_contractions': 0}
    with profiling.trace(str(tmp_path)):
        _cell_list_block(schnet_system)
    ranges = _ranges(tmp_path / 'trace.json')
    assert {name: len(r) for name, r in ranges.items()} == {
        'md.block': 1, 'select': 1, 'force': 2, 'force.distances': 2,
        'force.interaction': 2, 'force.readout': 2, 'force.backward': 2,
        'counts': 1}
    block = ranges['md.block']
    for name in ('select', 'force'):
        assert all(_inside(r, block) for r in ranges[name]), name
    assert not any(_inside(r, block) for r in ranges['counts'])
    for name in SCHNET_FORCE:
        assert all(_inside(r, ranges['force']) for r in ranges[name]), name
    for k in range(2):
        phases = [ranges[name][k] for name in SCHNET_FORCE]
        assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))


PAINN_FORCE = ('force.distances', 'force.message', 'force.update',
               'force.readout', 'force.backward')


@pytest.fixture(scope='module')
def painn_system():
    water = make_water_box(300, seed=0)
    model = PaiNNModel.from_atomic_numbers(
        water.atomic_numbers, PaiNNConfig(width=16, num_radial=8,
                                          cutoff=5.0), [1, 8],
        num_interactions=2)
    cl = model.create_cell_list(water.box, skin=SKIN)
    params = model.init(torch.Generator().manual_seed(0), device='cpu')
    return (model, cl, params, torch.tensor(water.positions),
            torch.tensor(water.box))


def test_painn_span_tree_and_lanes(painn_system, tmp_path):
    """A warm PaiNN refresh block (a selection, two force calls, the
    counts) uploads nothing and counts N x K lanes for each of the two
    messages of each force call; profiled, the force call's phases nest in
    it in order, a message and an update a block."""
    model, cl, _, pos, _ = painn_system
    _cell_list_block(painn_system)
    profiling.reset_counters()
    _cell_list_block(painn_system)
    assert profiling.COUNTERS == {
        'uploads': 0, 'upload_bytes': 0, 'selection_table_builds': 0,
        'cfconv_lanes': 0, 'painn_lanes': 2 * 2 * pos.shape[0] * cl.capacity,
        'mace_lanes': 0, 'mace_contractions': 0}
    with profiling.trace(str(tmp_path)):
        _cell_list_block(painn_system)
    ranges = _ranges(tmp_path / 'trace.json')
    assert {name: len(r) for name, r in ranges.items()} == {
        'md.block': 1, 'select': 1, 'force': 2, 'force.distances': 2,
        'force.message': 4, 'force.update': 4, 'force.readout': 2,
        'force.backward': 2, 'counts': 1}
    for name in ('select', 'force'):
        assert all(_inside(r, ranges['md.block']) for r in ranges[name])
    for name in PAINN_FORCE:
        assert all(_inside(r, ranges['force']) for r in ranges[name]), name
    for k in range(2):
        phases = ([ranges['force.distances'][k]]
                  + [ranges[name][2 * k + b] for b in range(2)
                     for name in ('force.message', 'force.update')]
                  + [ranges[name][k] for name in ('force.readout',
                                                  'force.backward')])
        assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))


MACE_FORCE = ('force.distances', 'force.interaction', 'force.product',
              'force.readout', 'force.backward')


@pytest.fixture(scope='module')
def mace_system():
    water = make_water_box(300, seed=0)
    model = MACEModel.from_atomic_numbers(
        water.atomic_numbers, MACEConfig(channels=8, avg_num_neighbors=10.0),
        [1, 8])
    cl = model.create_cell_list(water.box, skin=SKIN)
    params = model.init(torch.Generator().manual_seed(0), device='cpu')
    return (model, cl, params, torch.tensor(water.positions),
            torch.tensor(water.box))


def test_mace_span_tree_and_counters(mace_system, tmp_path):
    """A warm MACE refresh block (a selection, two force calls, the counts)
    uploads nothing, counts N x K lanes for each of the two messages of
    each force call (K the selection's lanes, its largest count rounded up
    to 8) and N x F atom-channel pairs for each of the two contractions;
    profiled, the force call's phases nest in it in order, an interaction
    and a product a layer."""
    model, cl, _, pos, box = mace_system
    _cell_list_block(mace_system)
    profiling.reset_counters()
    _cell_list_block(mace_system)
    k = model.lanes(model.select(pos, box, cl), cl.capacity)
    assert k < cl.capacity
    assert profiling.COUNTERS == {
        'uploads': 0, 'upload_bytes': 0, 'selection_table_builds': 0,
        'cfconv_lanes': 0, 'painn_lanes': 0,
        'mace_lanes': 2 * 2 * pos.shape[0] * k,
        'mace_contractions': 2 * 2 * pos.shape[0] * 8}
    with profiling.trace(str(tmp_path)):
        _cell_list_block(mace_system)
    ranges = _ranges(tmp_path / 'trace.json')
    assert {name: len(r) for name, r in ranges.items()} == {
        'md.block': 1, 'select': 1, 'force': 2, 'force.distances': 2,
        'force.interaction': 4, 'force.product': 4, 'force.readout': 2,
        'force.backward': 2, 'counts': 1}
    for name in ('select', 'force'):
        assert all(_inside(r, ranges['md.block']) for r in ranges[name])
    for name in MACE_FORCE:
        assert all(_inside(r, ranges['force']) for r in ranges[name]), name
    for k in range(2):
        phases = ([ranges['force.distances'][k]]
                  + [ranges[name][2 * k + b] for b in range(2)
                     for name in ('force.interaction', 'force.product')]
                  + [ranges[name][k] for name in ('force.readout',
                                                  'force.backward')])
        assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))
