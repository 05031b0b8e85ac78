"""The port's window pipeline sharded over 2 gloo ranks
(``parallel.window_shard.window_sharded_energy``) against the JAX
package's on a 2-device mesh, on the same water box (150 waters, the
smallest box with a 3^3 cell grid, so the 27 cells split 14 + 13 and the
tail block carries one FAR cell) and a small two-species basis with
angular tiers: energy and forces, and the same selection through the
port's unsharded window path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nnpops_tpu.config import ANIBasis as JBasis
from nnpops_tpu.models.ani import ANIModel as JModel
from nnpops_tpu.models.ani import init_ani_params as j_init
from nnpops_tpu.parallel.sharding import make_mesh
from nnpops_tpu.parallel.window_shard import window_sharded_energy
from nnpops_tpu.utils.water import make_water_box

from nnpops_tpu_torch.config import ANIBasis
from nnpops_tpu_torch.dryrun import run_suite
from nnpops_tpu_torch.parallel.launch import run_spmd

GRIDS = dict(EtaR=[16.0], ShfR=[1.0, 2.5, 4.0], EtaA=[8.0], Zeta=[8.0],
             ShfA=[1.0, 2.0], ShfZ=[0.5, 1.5])
SKIN = 0.25


def tree(params):
    nets = tuple((tuple(np.asarray(w) for w in net.weights),
                  tuple(np.asarray(b) for b in net.biases))
                 for net in params.ensemble.networks)
    return ((nets,), np.asarray(params.self_energies))


@pytest.fixture(scope='module')
def results():
    water = make_water_box(150, seed=0)
    jb = JBasis.from_grids(2, 5.1, 3.5, **GRIDS)
    model = JModel.from_atomic_numbers(water.atomic_numbers, jb,
                                       elements=(1, 8))
    model = model.with_blocked_layout(water.positions, water.box,
                                      impl='window', skin=SKIN)
    assert model.aev_impl == 'window'
    assert model.blocked_layout.ang_tier_rows is not None
    params = j_init(jax.random.PRNGKey(2), jb, layer_dims=((16, 8),) * 2,
                    num_models=2, self_energies=np.asarray([-0.5, -75.0]))
    box, pos = jnp.asarray(water.box), jnp.asarray(water.positions)
    sel = model.select(pos, box, model.create_cell_list(water.box,
                                                        skin=SKIN))
    fn = window_sharded_energy(model, make_mesh(2, model_parallel=1),
                               axis='dp')
    e, g = jax.jit(jax.value_and_grad(
        lambda p: fn(params, p, box, sel)))(pos)
    cfg = {'window': [dict(basis=ANIBasis.from_grids(2, 5.1, 3.5, **GRIDS),
                           z=water.atomic_numbers, elements=(1, 8),
                           n_devices=2, skin=SKIN, positions=water.positions,
                           box=water.box, params=tree(params))]}
    ranks = run_spmd(run_suite, 2, 'gloo', cfg, timeout_s=240.0)
    return (float(e), -np.asarray(g), len(model.blocked_layout.ang_tier_caps)
            + 1), ranks


def test_window_sharded_matches_jax(results):
    (e_ref, f_ref, tiers), ranks = results
    scale = np.abs(f_ref).max()
    for r in ranks:
        assert r['jax_imported'] == []
        (w,) = r['window']
        assert w['tiers'] == tiers
        np.testing.assert_allclose(w['energy'], e_ref, rtol=1e-5)
        assert np.abs(w['forces'] - f_ref).max() <= 1e-4 * scale


def test_window_sharded_matches_unsharded(results):
    """Two ranks against one: the same selection through the port's
    unsharded window path (the self energies enter on rank 0 only)."""
    _, ranks = results
    for r in ranks:
        (w,) = r['window']
        e_u, f_u = w['unsharded']
        np.testing.assert_allclose(w['energy'], e_u, rtol=2e-6)
        assert np.abs(w['forces'] - f_u).max() <= 2e-5 * np.abs(f_u).max()
