"""The port's host utilities against the JAX package's: the molecule
loaders (``utils.io``), the native loader and capacity planner
(``native``), the TorchANI npz import and export (``utils.torchani_io``)
and the profiling helpers (``utils.profiling``). All numpy-seeded; the
mirror of tests/test_models_io.py and tests/test_native.py, with parity."""
import json
import textwrap

import jax
import numpy as np
import pytest
import torch

from nnpops_tpu import native as jnative
from nnpops_tpu.config import ANIBasis as JBasis
from nnpops_tpu.models.ani import ANIModel as JModel
from nnpops_tpu.models.ani import init_ani_params as j_init
from nnpops_tpu.utils import io as jio
from nnpops_tpu.utils import profiling as jprof
from nnpops_tpu.utils import torchani_io as jtio
from nnpops_tpu.utils.water import make_water_box as j_water

from nnpops_tpu_torch import native
from nnpops_tpu_torch.config import ANIBasis
from nnpops_tpu_torch.models.ani import ANIModel, ANIParams
from nnpops_tpu_torch.run_configs import METHANOL_POSITIONS, METHANOL_Z
from nnpops_tpu_torch.utils import io, profiling, torchani_io
from nnpops_tpu_torch.utils import (TIP3P_CHARGES, WaterBox,  # noqa: F401
                                    make_triclinic_water_box, make_water_box)

MOL2 = textwrap.dedent('''\
    @<TRIPOS>MOLECULE
    test
     7 2 1
    SMALL
    @<TRIPOS>ATOM
      1 O1   0.000  0.100  0.200 O.3   1 RES  -0.8
      2 H1   0.957  0.000  0.000 H     1 RES   0.4
      3 CL1  2.000  1.000  0.000 Cl    1 RES   0.4
      4 CAA  -1.250  0.333  4.125 c3    1 RES   0.0
      5 BR2  3.500 -2.000  1.000 br    1 RES   0.0
      6 N3   0.250  0.750 -1.500 N.ar  1 RES   0.0
      7 S1   1.125  2.250  3.375 S.3   1 RES   0.0
    @<TRIPOS>BOND
      1 1 2 1
    ''')
PDB_CUBIC = (
    'CRYST1   15.000   15.000   15.000  90.00  90.00  90.00 P 1           1\n'
    'HETATM    1  O   HOH A   1       0.100   0.200   0.300  1.00  0.00           O\n'
    'HETATM    2  H1  HOH A   1       1.000   0.200   0.300  1.00  0.00           H\n'
    'END\n')
PDB_TRICLINIC = (
    'CRYST1   20.000   21.000   22.000  80.00  95.00 100.00 P 1           1\n'
    'ATOM      1  CA  ALA A   1      11.104   6.134  -6.504  1.00  0.00\n'
    'ATOM      2  CL  LIG A   2       1.500   2.500   3.500  1.00  0.00\n'
    'HETATM    3  N   LIG A   2      -3.250   4.000  12.750  1.00  0.00           N\n'
    'END\n')


def write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def assert_molecule_equal(got, want):
    np.testing.assert_array_equal(got.atomic_numbers, want.atomic_numbers)
    assert got.atomic_numbers.dtype == np.int32
    np.testing.assert_allclose(got.positions, want.positions, atol=1e-5)
    assert got.positions.dtype == np.float32
    if want.box is None:
        assert got.box is None
    else:
        np.testing.assert_allclose(got.box, want.box, atol=1e-4)


# ---------------------------------------------------------------------------
# Loaders.

def test_load_mol2_matches_jax(tmp_path):
    path = write(tmp_path, 'mol.mol2', MOL2)
    mol = io.load_mol2(path)
    np.testing.assert_array_equal(mol.atomic_numbers, [8, 1, 17, 6, 35, 7, 16])
    np.testing.assert_allclose(mol.positions[0], [0.0, 0.1, 0.2], atol=1e-6)
    assert_molecule_equal(mol, jio.load_mol2(path))


@pytest.mark.parametrize('text', [PDB_CUBIC, PDB_TRICLINIC],
                         ids=['cubic', 'triclinic'])
def test_load_pdb_matches_jax(tmp_path, text):
    path = write(tmp_path, 'box.pdb', text)
    mol = io.load_pdb(path)
    assert_molecule_equal(mol, jio.load_pdb(path))
    # The reduced lower-triangular box.
    assert np.allclose(np.triu(mol.box, 1), 0.0)
    if text is PDB_CUBIC:
        np.testing.assert_allclose(mol.box, np.eye(3) * 15.0, atol=1e-4)
    else:
        np.testing.assert_array_equal(mol.atomic_numbers, [6, 17, 7])


def test_loaders_reject_empty(tmp_path):
    with pytest.raises(ValueError, match='no atoms'):
        io.load_mol2(write(tmp_path, 'e.mol2', '@<TRIPOS>ATOM\n'))
    with pytest.raises(ValueError, match='no atoms'):
        io.load_pdb(write(tmp_path, 'e.pdb', 'END\n'))


def test_water_builders_import_from_the_utils_package():
    w = make_water_box(10, seed=1)
    np.testing.assert_array_equal(w.positions, j_water(10, seed=1).positions)
    assert make_triclinic_water_box(10, seed=1).box[1, 0] > 0
    assert TIP3P_CHARGES == (-0.834, 0.417, 0.417)


# ---------------------------------------------------------------------------
# The native library.

def test_native_builds_into_the_build_dir():
    lib = native.get_lib()
    assert lib is not None, 'native library failed to build'
    assert native.LIB.parent.name == '_build'
    assert native.LIB.exists()
    assert not list(native.SRC.parent.glob('*.so'))


@pytest.mark.parametrize('name,text', [('mol.mol2', MOL2),
                                       ('cubic.pdb', PDB_CUBIC),
                                       ('tri.pdb', PDB_TRICLINIC)])
def test_load_molecule_matches_python_loaders(tmp_path, name, text):
    path = write(tmp_path, name, text)
    py = io.load_mol2(path) if name.endswith('.mol2') else io.load_pdb(path)
    assert_molecule_equal(native.load_molecule(path), py)
    assert_molecule_equal(native.load_molecule(path),
                          jnative.load_molecule(path))


def test_load_molecule_without_library(tmp_path, monkeypatch):
    path = write(tmp_path, 'mol.mol2', MOL2)
    monkeypatch.setattr(native, 'get_lib', lambda: None)
    assert_molecule_equal(native.load_molecule(path), io.load_mol2(path))


@pytest.mark.parametrize('periodic', [True, False], ids=['periodic', 'open'])
@pytest.mark.parametrize('path', ['native', 'numpy'])
def test_plan_capacities_matches_jax(monkeypatch, periodic, path):
    water = make_water_box(200, seed=3)
    box = water.box if periodic else None
    if path == 'numpy':
        monkeypatch.setattr(native, 'get_lib', lambda: None)
        monkeypatch.setattr(jnative, 'get_lib', lambda: None)
    args = (water.positions, box, 5.1, 3.5)
    got = native.plan_capacities(*args)
    assert got == jnative.plan_capacities(*args)
    assert (native.plan_capacities(*args, margin=1.0, cell_size=4.0)
            == jnative.plan_capacities(*args, margin=1.0, cell_size=4.0))


@pytest.mark.parametrize('periodic', [True, False], ids=['periodic', 'open'])
def test_plan_capacities_native_equals_numpy(periodic):
    """The two paths agree wherever the cells are at least the cutoff wide
    (the native planner's 27-cell stencil covers the cutoff only then)."""
    water = make_water_box(200, seed=3)
    box = water.box if periodic else None
    for cutoff, ang, cs in ((5.1, 3.5, 5.1), (3.0, 0.0, 3.5)):
        assert (native._counts_native(native.get_lib(), water.positions, box,
                                      cutoff, ang, cs)
                == native._counts_numpy(water.positions, box, cutoff, ang,
                                        cs))


# ---------------------------------------------------------------------------
# TorchANI npz.

def jax_methanol():
    jb = JBasis.ani2x()
    model = JModel.from_atomic_numbers(METHANOL_Z, jb)
    params = j_init(jax.random.PRNGKey(4), jb, num_models=3,
                    self_energies=np.linspace(-40, -1, 7))
    pos = np.asarray(METHANOL_POSITIONS, np.float32)
    return model, params, pos


def nested(ensemble):
    """weights[s][m][l] and biases[s][m][l] of a stacked ensemble."""
    def per_model(x):
        return [np.asarray(x)[m] for m in range(np.asarray(x).shape[0])]
    weights = [[list(ws) for ws in zip(*(per_model(w) for w in net.weights))]
               for net in ensemble.networks]
    biases = [[list(bs) for bs in zip(*(per_model(b) for b in net.biases))]
              for net in ensemble.networks]
    return weights, biases


def test_npz_from_jax_gives_jax_energy(tmp_path):
    """An npz written by the JAX package, loaded by the port: methanol's
    energy equals JAX's at rtol 1e-6."""
    model, params, pos = jax_methanol()
    path = str(tmp_path / 'ens.npz')
    jtio.save_ensemble_npz(path, *nested(params.ensemble),
                           self_energies=params.self_energies)
    ens, sae = torchani_io.load_ensemble_npz(path, device='cpu')
    assert ens.networks[0].weights[0].device.type == 'cpu'
    assert ens.num_models == 3 and len(ens.networks) == 7
    tmodel = ANIModel.from_atomic_numbers(METHANOL_Z, ANIBasis.ani2x())
    e = tmodel.energy(ANIParams(ens, sae), torch.tensor(pos))
    np.testing.assert_allclose(float(e), float(model.energy(params, pos)),
                               rtol=1e-6)


def test_npz_round_trip_both_ways(tmp_path):
    rng = np.random.RandomState(0)
    weights = [[[rng.randn(4, 6).astype(np.float32),
                 rng.randn(1, 4).astype(np.float32)] for _ in range(3)]
               for _ in range(2)]
    biases = [[[rng.randn(4).astype(np.float32),
                rng.randn(1).astype(np.float32)] for _ in range(3)]
              for _ in range(2)]
    port_path, jax_path = str(tmp_path / 'p.npz'), str(tmp_path / 'j.npz')
    torchani_io.save_ensemble_npz(port_path, weights, biases,
                                  self_energies=[-1.0, -2.0])
    jtio.save_ensemble_npz(jax_path, weights, biases,
                           self_energies=[-1.0, -2.0])
    with np.load(port_path) as a, np.load(jax_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    ens, sae = torchani_io.load_ensemble_npz(port_path, device='cpu')
    jens, jsae = jtio.load_ensemble_npz(port_path)
    np.testing.assert_array_equal(sae.numpy(), np.asarray(jsae))
    for net, jnet in zip(ens.networks, jens.networks):
        for w, jw in zip(net.weights + net.biases, jnet.weights + jnet.biases):
            np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ens.networks[1].weights[0][2].numpy(),
                                  weights[1][2][0])
    torchani_io.save_ensemble_npz(port_path, weights, biases)
    assert torchani_io.load_ensemble_npz(port_path, device='cpu')[1] is None


def test_import_torch_state_dict_matches_jax(tmp_path):
    """A state dict of per-(model, species) torch.nn.Sequential networks."""
    torch.manual_seed(0)
    dims = (6, 5, 4, 3, 1)

    def net():
        layers = []
        for i in range(4):
            layers += [torch.nn.Linear(dims[i], dims[i + 1]),
                       torch.nn.CELU(0.1)]
        return torch.nn.Sequential(*layers[:-1])

    nets = torch.nn.ModuleList([torch.nn.ModuleList([net() for _ in range(2)])
                                for _ in range(3)])      # 3 models, 2 species
    sd = nets.state_dict()
    w, b = torchani_io.import_torch_state_dict(sd, num_species=2,
                                               num_models=3)
    jw, jb = jtio.import_torch_state_dict(sd, num_species=2, num_models=3)
    for got, want in ((w, jw), (b, jb)):
        for s in range(2):
            for m in range(3):
                for layer in range(4):
                    np.testing.assert_array_equal(got[s][m][layer],
                                                  want[s][m][layer])
    np.testing.assert_array_equal(w[1][2][3],
                                  nets[2][1][6].weight.detach().numpy())
    path = str(tmp_path / 'sd.npz')
    torchani_io.save_ensemble_npz(path, w, b)
    ens, _ = torchani_io.load_ensemble_npz(path, device='cpu')
    x = torch.randn(5, 6)
    from nnpops_tpu_torch.ops.batched_nn import apply_species_net
    with torch.no_grad():
        want = torch.stack([nets[m][0](x)[:, 0] for m in range(3)], 1)
    torch.testing.assert_close(apply_species_net(ens.networks[0], x), want,
                               rtol=1e-5, atol=1e-6)


def test_export_torchani_npz_needs_torchani(tmp_path):
    import importlib.util
    assert importlib.util.find_spec('torchani') is None
    with pytest.raises(ImportError):
        jtio.export_torchani_npz(str(tmp_path / 'x.npz'))
    with pytest.raises(ImportError):
        torchani_io.export_torchani_npz(str(tmp_path / 'x.npz'))


# ---------------------------------------------------------------------------
# Profiling.

def test_energy_drift_monitor_matches_jax():
    rng = np.random.RandomState(2)
    t = np.arange(50) * 0.002
    energies = -1000.0 + 3.5 * t + 0.01 * rng.randn(50)
    mon = profiling.EnergyDriftMonitor(tolerance_per_ps=1.0)
    jmon = jprof.EnergyDriftMonitor(tolerance_per_ps=1.0)
    assert mon.drift_per_ps == jmon.drift_per_ps == 0.0
    for ti, ei in zip(t, energies):
        mon.record(ti, ei)
        jmon.record(ti, ei)
    assert mon.drift_per_ps == jmon.drift_per_ps
    np.testing.assert_allclose(mon.drift_per_ps, 3.5, rtol=0.05)
    with pytest.raises(RuntimeError, match='exceeds tolerance') as err:
        mon.check()
    with pytest.raises(RuntimeError, match='exceeds tolerance') as jerr:
        jmon.check()
    assert str(err.value) == str(jerr.value)
    profiling.EnergyDriftMonitor().check()          # no tolerance: no raise
    with pytest.raises(RuntimeError, match='non-finite') as err:
        mon.record(1.0, float('nan'))
    with pytest.raises(RuntimeError, match='non-finite') as jerr:
        jmon.record(1.0, float('nan'))
    assert str(err.value) == str(jerr.value)


def test_step_timer_keys():
    x = torch.randn(64, 64)
    res = profiling.StepTimer(lambda a: a @ a, warmup=1).measure(x, iters=5)
    assert set(res) == {'mean_us', 'median_us', 'p10_us', 'p90_us', 'iters'}
    assert res['iters'] == 5
    assert 0 < res['p10_us'] <= res['median_us'] <= res['p90_us']


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(32, 32)
    with profiling.trace(str(tmp_path / 'trace')) as prof:
        (x @ x).sum()
    path = tmp_path / 'trace' / 'trace.json'
    assert path.exists()
    assert 'traceEvents' in json.loads(path.read_text())
    assert any('matmul' in e.key or 'mm' in e.key
               for e in prof.key_averages())
