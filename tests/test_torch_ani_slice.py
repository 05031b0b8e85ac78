"""The port's ANI-2x MD force step against the JAX model on water(150):
the f32 blocked path, the bf16 fused 'pallas' configuration, sticky reuse
of one selection, the overflow contract and parameter loading."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.config import ANIBasis
from nnpops_tpu.models.ani import ANIModel as JModel
from nnpops_tpu.models.ani import init_ani_params as j_init
from nnpops_tpu.utils.torchani_io import save_ensemble_npz
from nnpops_tpu.utils.water import make_water_box
from nnpops_tpu_torch.models.ani import ANIModel as TModel
from nnpops_tpu_torch.models.ani import init_ani_params as t_init
from nnpops_tpu_torch.models.ani import plain_energy_and_forces
from nnpops_tpu_torch.params import from_jax_params, from_npz

SKIN = 0.25
CONFIGS = {
    # name: (impl, nn_impl, nn_dtype)
    'f32-blocked': ('blocked', 'xla', None),
    'bf16-fused': ('pallas', 'fused', 'bfloat16'),
}


@pytest.fixture(scope='module')
def system():
    water = make_water_box(150, seed=0)
    basis = ANIBasis.ani2x()
    jp = j_init(jax.random.PRNGKey(0), basis, layer_dims=[(32, 24, 16)] * 7,
                num_models=2)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device='cpu')
    return water, basis, jp, tp


def build(system, name):
    water, basis, jp, tp = system
    impl, nn_impl, nn_dtype = CONFIGS[name]
    jm = JModel.from_atomic_numbers(water.atomic_numbers, basis, nn_impl=nn_impl,
                                    nn_dtype=nn_dtype).with_blocked_layout(
        water.positions, water.box, impl=impl, skin=SKIN)
    tm = TModel.from_atomic_numbers(water.atomic_numbers, basis, nn_impl=nn_impl,
                                    nn_dtype=nn_dtype).with_blocked_layout(
        water.positions, water.box, impl=impl, skin=SKIN)
    assert tm.blocked_layout.rad_caps == jm.blocked_layout.rad_caps
    assert tm.blocked_layout.ang_caps == jm.blocked_layout.ang_caps
    jcl = jm.create_cell_list(water.box, skin=SKIN)
    tcl = tm.create_cell_list(water.box, skin=SKIN)
    assert dataclasses.asdict(jcl) == dataclasses.asdict(tcl)
    assert tcl.use_cells
    jstep = jax.jit(jm.energy_and_forces_from_selection, static_argnums=(3,))
    return jm, tm, jcl, tcl, jstep


def check_step(name, je, jf, te, tf):
    je, jf = float(je), np.asarray(jf)
    te, tf = float(te), tf.numpy()
    if name == 'f32-blocked':
        np.testing.assert_allclose(te, je, rtol=1e-6)
        np.testing.assert_allclose(tf, jf, rtol=1e-3, atol=1e-5)
    else:
        np.testing.assert_allclose(te, je, rtol=1e-4)
        assert np.abs(tf - jf).max() <= 5e-3 * np.abs(jf).max()


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_step_matches_jax(system, name):
    water, basis, jp, tp = system
    jm, tm, jcl, tcl, jstep = build(system, name)
    jpos, jbox = jnp.asarray(water.positions), jnp.asarray(water.box)
    tpos, tbox = torch.tensor(water.positions), torch.tensor(water.box)
    jsel = jm.select(jpos, jbox, jcl)
    tsel = tm.select(tpos, tbox, tcl)
    je, jf = jstep(jp, jpos, jbox, jcl, jsel)
    te, tf = tm.energy_and_forces_from_selection(tp, tpos, tbox, tcl, tsel)
    assert tf.shape == (len(water.positions), 3)
    check_step(name, je, jf, te, tf)
    # Energy-only evaluation agrees with the force step's energy.
    with torch.no_grad():
        e_only = tm.energy_from_selection(tp, tpos, tbox, tcl, tsel)
    np.testing.assert_allclose(float(e_only), float(te), rtol=1e-6)
    jc = jm.overflow_counts(jpos, jbox, jcl, jsel)
    tc = tm.overflow_counts(tpos, tbox, tcl, tsel)
    for k in jc:
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]), k)
    tm.check_overflow(tpos, tbox, tcl, tsel)


def test_sticky_selection_reuse_matches_jax(system):
    """One frozen selection, three nudged steps (Verlet-skin reuse)."""
    water, basis, jp, tp = system
    name = 'f32-blocked'
    jm, tm, jcl, tcl, jstep = build(system, name)
    jbox, tbox = jnp.asarray(water.box), torch.tensor(water.box)
    pos = water.positions
    jsel = jm.select(jnp.asarray(pos), jbox, jcl)
    tsel = tm.select(torch.tensor(pos), tbox, tcl)
    rng = np.random.RandomState(11)
    for _ in range(3):
        pos = (pos + rng.uniform(-0.03, 0.03, pos.shape)).astype(np.float32)
        je, jf = jstep(jp, jnp.asarray(pos), jbox, jcl, jsel)
        te, tf = tm.energy_and_forces_from_selection(tp, torch.tensor(pos),
                                                     tbox, tcl, tsel)
        check_step(name, je, jf, te, tf)


def test_plain_reference_is_the_cpu_step(system):
    """On a CPU tensor every kernel wrapper runs its plain version, so the
    plain reference step is the model's step: the same energy and the same
    forces up to the summation order of multithreaded CPU scatter-adds."""
    water, basis, jp, tp = system
    _, tm, _, tcl, _ = build(system, 'bf16-fused')
    tpos, tbox = torch.tensor(water.positions), torch.tensor(water.box)
    sel = tm.select(tpos, tbox, tcl)
    e, f = tm.energy_and_forces_from_selection(tp, tpos, tbox, tcl, sel)
    e_p, f_p = plain_energy_and_forces(tm, tp, tpos, tbox, tcl, sel)
    assert torch.equal(e, e_p)
    torch.testing.assert_close(f, f_p, rtol=1e-5, atol=1e-6)


def test_check_overflow_raises_on_shrunk_capacity(system):
    water, basis, jp, tp = system
    _, tm, _, tcl, _ = build(system, 'f32-blocked')
    tpos, tbox = torch.tensor(water.positions), torch.tensor(water.box)
    sel = tm.select(tpos, tbox, tcl)
    small = dataclasses.replace(tm, blocked_layout=dataclasses.replace(
        tm.blocked_layout,
        ang_caps=tuple(int(c) - 1 for c in sel.max_ang)))
    with pytest.raises(RuntimeError, match='max_angular'):
        small.check_overflow(tpos, tbox, tcl)


def test_window_paths_raise_not_implemented(system):
    """The window path and its 'cluster' and 'pair' radial kernels are
    ported (``test_torch_window_slice.py``, ``test_torch_zpair.py``,
    ``test_torch_clusters.py``) and follow the JAX package's switches: the
    radial switch is ignored outside window mode and sets
    ``window_radial`` inside it. The payload path is not ported."""
    water, basis, _, _ = system
    base = TModel.from_atomic_numbers(water.atomic_numbers, basis)
    assert base.with_blocked_layout(water.positions, water.box,
                                    impl='window').aev_impl == 'window'
    ignored = base.with_blocked_layout(water.positions, water.box,
                                       impl='pallas', radial_impl='cluster')
    assert (ignored.aev_impl, ignored.window_radial) == ('pallas', 'window')
    paired = base.with_blocked_layout(water.positions, water.box,
                                      impl='window', radial_impl='pair')
    jpaired = JModel.from_atomic_numbers(
        water.atomic_numbers, basis).with_blocked_layout(
            water.positions, water.box, impl='window', radial_impl='pair')
    assert paired.window_radial == jpaired.window_radial == 'pair'
    for radial in ('cluster', 'pair'):
        assert dataclasses.replace(base, window_radial=radial
                                   ).window_radial == radial
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        base.select(torch.tensor(water.positions), torch.tensor(water.box), None)


def test_from_npz_round_trip(system, tmp_path):
    _, basis, jp, tp = system
    path = tmp_path / 'ens.npz'
    nets = jp.ensemble.networks
    models = range(jp.ensemble.num_models)
    weights = [[[np.asarray(w[m]) for w in net.weights] for m in models]
               for net in nets]
    biases = [[[np.asarray(b[m]) for b in net.biases] for m in models]
              for net in nets]
    sae = np.arange(basis.num_species, dtype=np.float32) - 3.0
    save_ensemble_npz(str(path), weights, biases, sae)
    loaded = from_npz(str(path), device='cpu')
    np.testing.assert_array_equal(loaded.self_energies.numpy(), sae)
    for a, b in zip(loaded.ensemble.networks, tp.ensemble.networks):
        for x, y in zip(a.weights + a.biases, b.weights + b.biases):
            assert torch.equal(x, y)


def test_init_ani_params_generator():
    basis = ANIBasis.ani2x()
    p1 = t_init(torch.Generator().manual_seed(3), basis, num_models=2,
                device='cpu')
    p2 = t_init(torch.Generator().manual_seed(3), basis, num_models=2,
                device='cpu')
    assert len(p1.ensemble.networks) == basis.num_species
    assert p1.ensemble.num_models == 2
    assert torch.equal(p1.ensemble.networks[6].weights[0],
                       p2.ensemble.networks[6].weights[0])
    assert p1.self_energies.shape == (basis.num_species,)
