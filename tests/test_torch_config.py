"""The port's own copies of the JAX package's numpy-only modules (the ANI
basis and constants, the water builders) against the originals, and the
port's device defaults."""
import dataclasses

import numpy as np
import pytest
import torch

import nnpops_tpu.config as jconfig
from nnpops_tpu.utils import water as jwater
from nnpops_tpu_torch import config as tconfig
from nnpops_tpu_torch import utils as tutils
from nnpops_tpu_torch.models.ani import init_ani_params
from nnpops_tpu_torch.ops.batched_nn import init_ensemble
from nnpops_tpu_torch.params import from_jax_params, from_npz


def assert_basis_equal(tb, jb):
    assert [f.name for f in dataclasses.fields(tb)] == [
        f.name for f in dataclasses.fields(jb)]
    for f in dataclasses.fields(jb):
        assert getattr(tb, f.name) == getattr(jb, f.name), f.name
    for prop in ('num_radial', 'num_angular', 'num_species_pairs',
                 'radial_length', 'angular_length', 'aev_length'):
        assert getattr(tb, prop) == getattr(jb, prop), prop


@pytest.mark.parametrize('torchani', [True, False])
def test_ani2x_basis_equals_jax(torchani):
    assert_basis_equal(tconfig.ANIBasis.ani2x(torchani),
                       jconfig.ANIBasis.ani2x(torchani))


def test_from_grids_equals_jax():
    grids = dict(num_species=3, Rcr=4.2, Rca=3.1, EtaR=[16.0, 8.0],
                 ShfR=[0.9, 1.7, 2.5], EtaA=[8.0], Zeta=[14.1, 32.0],
                 ShfA=[0.9, 1.6], ShfZ=[0.2, 1.2, 2.2], torchani=False)
    assert_basis_equal(tconfig.ANIBasis.from_grids(**grids),
                       jconfig.ANIBasis.from_grids(**grids))


def test_ani2x_constants_equal_jax():
    assert tconfig.ANI2X_ELEMENTS == jconfig.ANI2X_ELEMENTS
    assert tconfig.ANI2X_LAYER_DIMS == jconfig.ANI2X_LAYER_DIMS


def test_pme_config_equals_jax():
    assert [f.name for f in dataclasses.fields(tconfig.PMEConfig)] == [
        f.name for f in dataclasses.fields(jconfig.PMEConfig)]
    args = (14, 15, 16, 5, 4.985823141035867, 138.935)
    assert dataclasses.astuple(tconfig.PMEConfig(*args)) == \
        dataclasses.astuple(jconfig.PMEConfig(*args))
    assert tconfig.PMEConfig(*args).grid_shape == (14, 15, 16)
    for bad in ((0, 15, 16, 5, 1.0, 1.0), (14, 15, 16, 0, 1.0, 1.0),
                (14, 15, 16, 5, 0.0, 1.0), (14, 15, 16, 5, 1.0, -1.0)):
        with pytest.raises(ValueError) as t_err:
            tconfig.PMEConfig(*bad)
        with pytest.raises(ValueError) as j_err:
            jconfig.PMEConfig(*bad)
        assert str(t_err.value) == str(j_err.value)


def assert_box_equal(t, j):
    for name in ('positions', 'atomic_numbers', 'charges', 'box'):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, name)


@pytest.mark.parametrize('molecules', [150, 867])
def test_water_box_equals_jax(molecules):
    assert_box_equal(tutils.make_water_box(molecules, seed=0),
                     jwater.make_water_box(molecules, seed=0))


def test_triclinic_water_box_equals_jax():
    assert_box_equal(tutils.make_triclinic_water_box(300, seed=0),
                     jwater.make_triclinic_water_box(300, seed=0))
    assert_box_equal(
        tutils.make_triclinic_water_box(100, seed=2, shear=(0.2, 0.05, 0.1)),
        jwater.make_triclinic_water_box(100, seed=2, shear=(0.2, 0.05, 0.1)))


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without ``device`` the entry points put tensors on the CUDA card, and
    raise where there is none; ``device='cpu'`` asks for the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    basis = tconfig.ANIBasis.ani2x()
    gen = torch.Generator().manual_seed(0)
    dims = [(8, 8, 8)] * 7
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_ani_params(gen, basis, layer_dims=dims, num_models=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_ensemble(gen, 16, [(8, 4)], 1)
    params = init_ani_params(gen, basis, layer_dims=dims, num_models=1,
                             device='cpu')
    assert params.self_energies.device.type == 'cpu'
    tree = ((tuple((tuple(w.numpy() for w in net.weights),
                    tuple(b.numpy() for b in net.biases))
                   for net in params.ensemble.networks),),
            params.self_energies.numpy())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_params(tree)
    assert from_jax_params(tree, device='cpu').self_energies.device.type == 'cpu'
    path = tmp_path / 'missing.npz'
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_npz(str(path))
