"""The port's SchNet models (``nnpops_tpu_torch.models.schnet``) against the
JAX package's on the same numpy inputs, weights carried across with
``params.schnet_params_from_jax`` / ``cfconv_params_from_jax``: config 2
(the aspirin-sized SchNet of ``examples/run_configs.py``: 21 atoms, width
128, 50 Gaussians, 10 A, 3 interactions) energy and forces, a periodic
SchNet, and the CFConv stack over the pair list and a payload."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import PeriodicStack, periodic_stack, periodic_stack_grads
from nnpops_tpu.config import CFConvConfig as JConfig
from nnpops_tpu.models.schnet import CFConvStack as JStack
from nnpops_tpu.models.schnet import SchNetModel as JSchNet
from nnpops_tpu.neighbors.cell_list import CellList as JCellList
from nnpops_tpu.ops.cfconv import build_cfconv_neighbors as j_build
from nnpops_tpu_torch.config import CFConvConfig
from nnpops_tpu_torch.models.schnet import CFConvStack, SchNetModel
from nnpops_tpu_torch.neighbors.cell_list import CellList
from nnpops_tpu_torch.ops.cfconv import build_cfconv_neighbors
from nnpops_tpu_torch.params import (cfconv_params_from_jax,
                                     schnet_params_from_jax)
from nnpops_tpu_torch.utils import make_water_box

CONFIG2 = dict(width=128, num_gaussians=50, cutoff=10.0,
               gaussian_width=10.0 / 49)


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One torch thread for this module: the suite runs several pytest
    workers on a few cores, where each torch op's thread pool would
    contend with the others' and with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def schnet_pair(cfg, num_species, num_interactions, seed):
    jm = JSchNet(JConfig(**cfg), num_species=num_species,
                 num_interactions=num_interactions)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = SchNetModel(CFConvConfig(**cfg), num_species=num_species,
                     num_interactions=num_interactions)
    tp = schnet_params_from_jax(jax.tree.map(np.asarray, jp), device='cpu')
    return jm, jp, tm, tp


def test_config2_energy_and_forces_equal_jax():
    """Config 2: energy rtol 1e-5, forces within 1e-4 of their scale."""
    rng = np.random.RandomState(0)
    pos = rng.rand(21, 3).astype(np.float32) * 6
    species = rng.randint(0, 3, 21).astype(np.int32)
    jm, jp, tm, tp = schnet_pair(CONFIG2, 3, 3, seed=1)
    je, jf = jax.jit(jm.energy_and_forces)(jp, jnp.asarray(pos),
                                           jnp.asarray(species))
    te, tf = tm.energy_and_forces(tp, torch.tensor(pos),
                                  torch.tensor(species))
    jf = np.asarray(jf)
    assert tf.shape == (21, 3) and bool(torch.isfinite(tf).all())
    np.testing.assert_allclose(float(te), float(je), rtol=1e-5)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0,
                               atol=1e-4 * np.abs(jf).max())


def test_periodic_schnet_equals_jax():
    """A narrow SchNet on water(48) in its periodic box (box rows through
    the pair list's minimum image): energy rtol 1e-5, forces 1e-4 of scale."""
    water = make_water_box(48, seed=1)
    cfg = dict(width=16, num_gaussians=8, cutoff=4.0, gaussian_width=0.5)
    jm, jp, tm, tp = schnet_pair(cfg, 2, 2, seed=3)
    species = (water.atomic_numbers == 1).astype(np.int32)
    je, jf = jax.jit(jm.energy_and_forces)(jp, jnp.asarray(water.positions),
                                           jnp.asarray(species),
                                           jnp.asarray(water.box))
    te, tf = tm.energy_and_forces(tp, torch.tensor(water.positions),
                                  torch.tensor(species),
                                  torch.tensor(water.box))
    jf = np.asarray(jf)
    np.testing.assert_allclose(float(te), float(je), rtol=1e-5)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0,
                               atol=1e-4 * np.abs(jf).max())


@pytest.mark.parametrize('path', ['pairs', 'payload'])
def test_stack_equals_jax(path):
    """Three CFConv layers over one shared neighbor list (the pair list, as
    the O(N^2) harness builds it, or a cell-list payload): outputs and input
    gradients against JAX, rtol/atol 2e-4."""
    water = make_water_box(100, seed=6)
    cfg = dict(width=8, num_gaussians=5, cutoff=4.0, gaussian_width=0.5)
    jstack = JStack(JConfig(**cfg), num_layers=3)
    jp = jstack.init(jax.random.PRNGKey(5))
    tstack = CFConvStack(CFConvConfig(**cfg), num_layers=3)
    tp = tuple(cfconv_params_from_jax(jax.tree.map(np.asarray, p),
                                      device='cpu') for p in jp)
    rng = np.random.RandomState(2)
    n = len(water.positions)
    x = rng.randn(n, 8).astype(np.float32)
    w = rng.randn(n, 8).astype(np.float32)
    jpos, jbox = jnp.asarray(water.positions), jnp.asarray(water.box)
    tpos, tbox = torch.tensor(water.positions), torch.tensor(water.box)
    if path == 'pairs':
        jnb, tnb = j_build(jpos, 4.0, jbox), build_cfconv_neighbors(tpos, 4.0,
                                                                    tbox)
        jrun = lambda inp: jstack(jp, jnb, inp)             # noqa: E731
        trun = lambda inp: tstack(tp, tnb, inp)             # noqa: E731
    else:
        jpl = JCellList.create(water.box, 4.0, capacity=64).build_payload(
            jpos, jbox)
        tpl = CellList.create(water.box, 4.0, capacity=64).build_payload(
            tpos, tbox)
        jrun = lambda inp: jstack.apply_payload(jp, jpl, inp)  # noqa: E731
        trun = lambda inp: tstack.apply_payload(tp, tpl, inp)  # noqa: E731
    jv, jg = jax.jit(jax.value_and_grad(lambda inp: jnp.sum(jrun(inp) * w)))(
        jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tv = torch.sum(trun(tx) * torch.tensor(w))
    (tg,) = torch.autograd.grad(tv, tx)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=2e-4)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=2e-4,
                               atol=2e-4)


def test_init_shapes_and_device():
    cfg = CFConvConfig(**CONFIG2)
    gen = torch.Generator().manual_seed(0)
    params = SchNetModel(cfg, num_species=3).init(gen, device='cpu')
    assert params.embedding.shape == (3, 128)
    assert len(params.interactions) == 3
    assert params.interactions[0].conv.w1.shape == (50, 128)
    assert params.readout2.w.shape == (64, 1)
    stack = CFConvStack(cfg, num_layers=6).init(gen, device='cpu')
    assert len(stack) == 6 and stack[0].w2.shape == (128, 128)


def test_periodic_stack_matches_jax_benchmark():
    """``chip_smoke.periodic_stack`` builds the JAX package's
    ``bench_cfconv_periodic`` workload: at 26,010 atoms the same positions
    and inputs (numpy seed 0), cell grid and capacities (6x6x6, 176 slots a
    cell, 640 lanes) and 2048-row chunks; ``periodic_stack_grads`` on a
    narrow two-layer stack equals the JAX chain (value rtol 1e-5, position,
    input and weight gradients rtol/atol 3e-4)."""
    n = 26010
    w = periodic_stack(n, device='cpu')
    rng = np.random.RandomState(0)
    side = (n / 0.1) ** (1 / 3)
    pos = rng.rand(n, 3).astype(np.float32) * side
    x = rng.randn(n, 128).astype(np.float32)
    np.testing.assert_array_equal(w.positions.numpy(), pos)
    np.testing.assert_array_equal(w.inputs.numpy(), x)
    jcl = JCellList.create(np.diag([side] * 3).astype(np.float32), 10.0,
                           capacity=640)
    assert (w.cell_list.ncells, w.cell_list.cell_capacity,
            w.cell_list.capacity) == (jcl.ncells, jcl.cell_capacity, 640)
    assert w.cell_list.ncells == (6, 6, 6) and w.chunk_size == 2048
    assert w.stack.num_layers == 6 and w.stack.config == CFConvConfig(
        **CONFIG2)

    water = make_water_box(300, seed=4)
    cfg = dict(width=8, num_gaussians=5, cutoff=4.0, gaussian_width=0.5)
    jstack = JStack(JConfig(**cfg), num_layers=2)
    jp = jstack.init(jax.random.PRNGKey(7))
    tp = tuple(cfconv_params_from_jax(jax.tree.map(np.asarray, p),
                                      device='cpu') for p in jp)
    x = np.random.RandomState(3).randn(len(water.positions), 8).astype(
        np.float32)
    small = PeriodicStack(CFConvStack(CFConvConfig(**cfg), 2), tp,
                          CellList.create(water.box, 4.0, capacity=64),
                          torch.tensor(water.positions),
                          torch.tensor(water.box), torch.tensor(x), 128)
    jcl = JCellList.create(water.box, 4.0, capacity=64)
    jbox = jnp.asarray(water.box)

    def jloss(p, prm, inp):
        sel = jcl.select(p, jbox, build_mirror=True)
        d, idx, m = jcl.payload_distances_from_selection(p, jbox, sel)
        return jnp.sum(jstack.apply_distances(prm, d, idx, m, inp,
                                              chunk_size=128))

    jv, (jg_pos, jg_prm, jg_x) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2)))(jnp.asarray(water.positions), jp,
                                   jnp.asarray(x))
    value, d_pos, d_x, dw, sel = periodic_stack_grads(small)
    assert int(sel.max_neighbors) <= 64
    np.testing.assert_allclose(float(value), float(jv), rtol=1e-5)
    got = [d_pos] + [a for p in dw for a in p] + [d_x]
    want = [jg_pos] + jax.tree_util.tree_leaves(jg_prm) + [jg_x]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-4,
                                   atol=3e-4)
