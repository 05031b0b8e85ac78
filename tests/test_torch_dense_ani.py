"""The port's dense ANI-2x path (BASELINE config 1: ``ANIModel.energy``,
``energy_and_forces`` and the conformer batch) and the ensemble's
original-order and padded layouts against the JAX package, with
parameters carried across by ``from_jax_params``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.config import ANIBasis as JBasis
from nnpops_tpu.models.ani import ANIModel as JModel
from nnpops_tpu.models.ani import init_ani_params as j_init
from nnpops_tpu.neighbors.cell_list import CellList as JCellList
from nnpops_tpu.ops import batched_nn as jnn
from nnpops_tpu.utils.water import make_water_box
from nnpops_tpu_torch import run_configs
from nnpops_tpu_torch.config import ANIBasis
from nnpops_tpu_torch.models.ani import ANIModel
from nnpops_tpu_torch.neighbors.cell_list import CellList
from nnpops_tpu_torch.ops import batched_nn as tnn
from nnpops_tpu_torch.params import from_jax_params

METHANOL = np.asarray(run_configs.METHANOL_POSITIONS, np.float32)
LIGANDS = np.load(__file__.rsplit('/', 1)[0] + '/data/ligands.npz')


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs several pytest workers on a few
    cores, where every small op's thread pool would contend with the
    others' and with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def params():
    """ANI-2x at full width, 8 models, the JAX example's self energies."""
    jp = j_init(jax.random.PRNGKey(0), JBasis.ani2x(),
                self_energies=np.linspace(-40, -1, 7))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device='cpu')


def molecule(name):
    if name == 'methanol':
        return np.asarray(run_configs.METHANOL_Z), METHANOL
    return (LIGANDS[f'{name}_atomic_numbers'],
            LIGANDS[f'{name}_positions'].astype(np.float32))


def check(name, je, jf, te, tf, bf16):
    je, jf, te, tf = float(je), np.asarray(jf), float(te), tf.numpy()
    assert tf.shape == jf.shape and np.isfinite(tf).all()
    if bf16:
        np.testing.assert_allclose(te, je, rtol=1e-4, err_msg=name)
        assert np.abs(tf - jf).max() <= 5e-3 * np.abs(jf).max(), name
    else:
        np.testing.assert_allclose(te, je, rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(tf, jf, rtol=1e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize('nn_dtype', [None, 'bfloat16'])
@pytest.mark.parametrize('name', ['methanol', '3lka', '2iuz'])
def test_energy_and_forces_match_jax(params, name, nn_dtype):
    jp, tp = params
    z, pos = molecule(name)
    jm = JModel.from_atomic_numbers(z, JBasis.ani2x(), nn_dtype=nn_dtype)
    tm = ANIModel.from_atomic_numbers(z, ANIBasis.ani2x(), nn_dtype=nn_dtype)
    assert tm.aev_impl == 'payload'
    je, jf = jax.jit(jm.energy_and_forces)(jp, jnp.asarray(pos))
    te, tf = tm.energy_and_forces(tp, torch.tensor(pos))
    check(name, je, jf, te, tf, nn_dtype is not None)
    with torch.no_grad():
        np.testing.assert_allclose(float(tm.energy(tp, torch.tensor(pos))),
                                   float(te), rtol=1e-6)


def test_batch_api_matches_jax(params):
    jp, tp = params
    z, pos = molecule('2iuz')
    confs = (pos + 0.02 * np.random.RandomState(4).randn(3, *pos.shape)
             ).astype(np.float32)
    jm = JModel.from_atomic_numbers(z, JBasis.ani2x())
    tm = ANIModel.from_atomic_numbers(z, ANIBasis.ani2x())
    je, jf = jax.jit(jm.energy_and_forces_batch)(jp, jnp.asarray(confs))
    te, tf = tm.energy_and_forces_batch(tp, torch.tensor(confs))
    assert te.shape == (3,) and tf.shape == confs.shape
    for i in range(3):
        check(f'conformer {i}', je[i], jf[i], te[i], tf[i], False)
    with torch.no_grad():
        e_only = tm.energy_batch(tp, torch.tensor(confs))
    np.testing.assert_allclose(e_only.numpy(), te.numpy(), rtol=1e-6)


def small_ensemble(seed=3):
    dims = [(16, 12, 8), (16, 12, 8), (10, 8, 6)]
    ens = jnn.init_ensemble(jax.random.PRNGKey(seed), 24, dims, 3)
    # Non-zero biases so the padded layout's bias padding is exercised.
    ens = jax.tree.map(lambda a: a + 0.01, ens)
    port = tnn.EnsembleParams(tuple(
        tnn.SpeciesNet(tuple(torch.tensor(np.asarray(w)) for w in net.weights),
                       tuple(torch.tensor(np.asarray(b)) for b in net.biases))
        for net in ens.networks))
    return ens, port


@pytest.mark.parametrize('bf16', [False, True])
def test_atomic_energies_grouped_matches_jax(bf16):
    ens, port = small_ensemble()
    species = np.array([2, 0, 0, 2, 1, 0, 2, 2, 1], np.int32)
    x = np.random.RandomState(5).randn(len(species), 24).astype(np.float32)
    grouping = jnn.build_grouping(species, 3)
    assert tnn.build_grouping(species, 3).counts == grouping.counts
    jdt = jnp.bfloat16 if bf16 else None
    tdt = torch.bfloat16 if bf16 else None
    want = jax.jit(lambda xx: jnn.atomic_energies_grouped(
        ens, xx, grouping, jdt))(jnp.asarray(x))
    got = tnn.atomic_energies_grouped(port, torch.tensor(x),
                                      tnn.build_grouping(species, 3), tdt)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    total = tnn.ensemble_energy(port, torch.tensor(x),
                                tnn.build_grouping(species, 3), tdt)
    np.testing.assert_allclose(
        float(total), float(jnp.sum(want)), **tol)


def test_padded_layout_matches_jax():
    """pad_ensemble, apply_padded_ensemble and batched_linear against JAX,
    and the padded layout against the grouped one."""
    ens, port = small_ensemble()
    species = np.array([1, 2, 0, 2, 2], np.int32)
    aev = np.random.RandomState(6).randn(2, len(species), 24).astype(np.float32)
    jpad = jnn.pad_ensemble(ens, species)
    tpad = tnn.pad_ensemble(port, species)
    for (jw, jb), (tw, tb) in zip(jpad, tpad):
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    want = jnn.apply_padded_ensemble(jpad, jnp.asarray(aev))
    got = tnn.apply_padded_ensemble(tpad, torch.tensor(aev))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    grouped = tnn.ensemble_energy(port, torch.tensor(aev[1]),
                                  tnn.build_grouping(species, 3))
    np.testing.assert_allclose(float(got[1]), float(grouped), rtol=1e-5)
    x = np.random.RandomState(7).randn(2, 5, 3, 4, 1).astype(np.float32)
    w = np.random.RandomState(8).randn(1, 5, 3, 6, 4).astype(np.float32)
    b = np.random.RandomState(9).randn(1, 5, 3, 6, 1).astype(np.float32)
    np.testing.assert_allclose(
        tnn.batched_linear(*map(torch.tensor, (x, w, b))).numpy(),
        np.asarray(jnn.batched_linear(*map(jnp.asarray, (x, w, b)))),
        rtol=1e-6, atol=1e-6)


def test_periodic_system_matches_jax(params):
    """Twelve atoms in an 11 A box (``tests/test_ani_model.py``): the port
    against JAX, and a periodic image moved by a box vector changes
    nothing."""
    jp, tp = params
    z = [8, 1, 1] * 4
    base = np.random.RandomState(1).rand(12, 3).astype(np.float32) * 11
    box = np.eye(3, dtype=np.float32) * 11.0
    jm = JModel.from_atomic_numbers(z, JBasis.ani2x())
    tm = ANIModel.from_atomic_numbers(z, ANIBasis.ani2x())
    je, jf = jax.jit(jm.energy_and_forces)(jp, jnp.asarray(base),
                                           jnp.asarray(box))
    te, tf = tm.energy_and_forces(tp, torch.tensor(base), torch.tensor(box))
    check('periodic', je, jf, te, tf, False)
    shifted = base.copy()
    shifted[3] += np.array([11.0, 0, 0], np.float32)
    te2, _ = tm.energy_and_forces(tp, torch.tensor(shifted), torch.tensor(box))
    np.testing.assert_allclose(float(te2), float(te), rtol=1e-5)


def test_energy_over_cell_list_neighbors_matches_jax(params):
    """``energy(neighbors=...)`` from ``CellList.build`` on water(150) with
    an angular capacity, against JAX on its own cell list."""
    jp, tp = params
    water = make_water_box(150, seed=0)
    basis = ANIBasis.ani2x()
    jcl = JCellList.create(water.box, basis.radial_cutoff, capacity=96)
    tcl = CellList.create(water.box, basis.radial_cutoff, capacity=96)
    jbox, tbox = jnp.asarray(water.box), torch.tensor(water.box)
    jpos, tpos = jnp.asarray(water.positions), torch.tensor(water.positions)
    jm = JModel.from_atomic_numbers(water.atomic_numbers, JBasis.ani2x(),
                                    angular_capacity=32)
    tm = ANIModel.from_atomic_numbers(water.atomic_numbers, basis,
                                      angular_capacity=32)
    jn, tn = jcl.build(jpos, jbox), tcl.build(tpos, tbox)
    assert int(tn.max_neighbors) <= tcl.capacity
    je, jf = jax.jit(jm.energy_and_forces)(jp, jpos, jbox, jn.indices)
    te, tf = tm.energy_and_forces(tp, tpos, tbox, tn.indices)
    check('water(150)', je, jf, te, tf, False)


def test_run_configs_config1_prints_finite(capsys):
    run_configs.main(['1', '--device', 'cpu'])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith('[1] methanol: E = ')
    e = float(line.split('E = ')[1].split(',')[0])
    f = float(line.split('max|F| = ')[1])
    assert np.isfinite(e) and np.isfinite(f) and f > 0
