"""The port's parallel layer (``nnpops_tpu_torch.parallel``) against the
JAX package's, on gloo ranks on the CPU.

The ranks are spawned by ``parallel.launch.run_spmd`` and run
``nnpops_tpu_torch.dryrun.run_suite``, which imports no JAX; each spawn
runs several checks, and its results are compared here with the JAX
functions on the virtual 8-device mesh, on the same numpy inputs: the DP x
EP train step (dp=2 x mp=2, with and without force matching) against
JAX's unsharded step with ``optax.sgd``, the loss and the updated
parameters; the atom-sharded energy and forces on 4 ranks; TP 4-way with a
replicated and a model-sharded tail; PP with 4 stages and the pipelined
ANI ensemble with 3; the mesh shapes; the distributed checkpoint on 2
ranks; and ``dryrun_multichip(4)``.
"""
import functools
import operator
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnpops_tpu.config import ANIBasis as JBasis
from nnpops_tpu.models.ani import ANIModel as JModel
from nnpops_tpu.models.ani import init_ani_params as j_init
from nnpops_tpu.ops.batched_nn import ensemble_energy as j_ensemble_energy
from nnpops_tpu.parallel import sharding as jsh

from nnpops_tpu_torch.config import ANIBasis
from nnpops_tpu_torch.dryrun import dryrun_multichip, run_suite
from nnpops_tpu_torch.parallel.launch import run_spmd

GRIDS = dict(EtaR=[16.0], ShfR=[1.0, 2.0, 3.0], EtaA=[8.0], Zeta=[8.0],
             ShfA=[1.0, 2.0], ShfZ=[0.5, 1.5])
GRIDS32 = dict(EtaR=[16.0], ShfR=[1.0, 2.0, 3.0, 4.0], EtaA=[8.0],
               Zeta=[8.0], ShfA=[1.0, 2.0], ShfZ=[0.5, 1.0, 1.5, 2.0])
Z = [8, 1, 1, 8, 1, 1, 7, 1]          # 8 atoms: divisible by every axis
Z32 = [8, 1, 1, 8, 1, 1, 8, 1]
MESH_SHAPES = [(4, 2), (4, 4), (4, 3), (4, 1), (3, 2), (2, 2), (1, 2)]
LR = 1e-2
FORCE_WEIGHTS = (0.0, 0.1)
STEPS = 2


def tree(params):
    """JAX ``ANIParams`` -> plain nested tuples of numpy arrays (what the
    ranks read; no JAX class crosses to them)."""
    nets = tuple((tuple(np.asarray(w) for w in net.weights),
                  tuple(np.asarray(b) for b in net.biases))
                 for net in params.ensemble.networks)
    return ((nets,), np.asarray(params.self_energies))


def leaves(t):
    ((nets,), sae) = t
    return [x for w, b in nets for x in (*w, *b)] + [sae]


def systems():
    """Every input, from numpy seeds and JAX PRNG keys, as in
    tests/test_sharding.py."""
    rng = np.random.RandomState(0)
    jb = JBasis.from_grids(3, 4.6, 3.1, **GRIDS)
    jb32 = JBasis.from_grids(2, 4.6, 3.1, **GRIDS32)
    s = dict(jb=jb, jb32=jb32,
             tb=ANIBasis.from_grids(3, 4.6, 3.1, **GRIDS),
             tb32=ANIBasis.from_grids(2, 4.6, 3.1, **GRIDS32))
    s['model'] = JModel.from_atomic_numbers(Z, jb, elements=(1, 8, 7))
    s['model32'] = JModel.from_atomic_numbers(Z32, jb32, elements=(1, 8))
    s['params'] = j_init(jax.random.PRNGKey(0), jb,
                         layer_dims=((16, 8),) * 3, num_models=4)
    s['batch'] = (rng.rand(8, 8, 3) * 4).astype(np.float32)
    s['e_t'] = rng.randn(8).astype(np.float32)
    s['f_t'] = (3.0 * rng.randn(8, 8, 3)).astype(np.float32)
    s['pos'] = (np.random.RandomState(1).rand(8, 3) * 4).astype(np.float32)
    # TP: 6 models over 4 ranks (replicated tail), 8 (model-sharded tail).
    s['tp_params'] = [j_init(jax.random.PRNGKey(k), jb32,
                             layer_dims=((16, 8), (16, 8)), num_models=m)
                      for k, m in ((0, 6), (2, 8))]
    s['tp_aev'] = [np.random.RandomState(k).randn(8, jb32.aev_length)
                   .astype(np.float32) for k in (2, 6)]
    prng = np.random.RandomState(3)
    s['pp'] = dict(stage_w=(prng.randn(4, 16, 16) * 0.3).astype(np.float32),
                   stage_b=(prng.randn(4, 16) * 0.1).astype(np.float32),
                   x=prng.randn(32, 16).astype(np.float32))
    s['pp_ani_params'] = j_init(jax.random.PRNGKey(1), jb,
                                layer_dims=((16, 8), (12, 8), (16, 4)),
                                num_models=4)
    s['pp_ani_aev'] = (np.random.RandomState(5)
                       .randn(len(Z), jb.aev_length).astype(np.float32))
    return s


@pytest.fixture(scope='module')
def sys_():
    assert len(jax.devices()) == 8, 'tests need the virtual 8-device mesh'
    return systems()


@pytest.fixture(scope='module')
def ranks(sys_):
    """One spawn of 4 gloo ranks running every 4-rank check."""
    s = sys_
    small = dict(basis=s['tb'], z=Z, elements=(1, 8, 7))
    cfg = {
        'mesh_shapes': MESH_SHAPES,
        'train': dict(small, params=tree(s['params']),
                      positions=s['batch'], e_target=s['e_t'],
                      f_target=s['f_t'], model_parallel=2,
                      optimizer=functools.partial(torch.optim.SGD, lr=LR),
                      force_weights=FORCE_WEIGHTS, steps=STEPS),
        'atom': [dict(small, params=tree(s['params']), positions=s['pos'],
                      n_devices=4)],
        'tp': [dict(basis=s['tb32'], z=Z32, elements=(1, 8), n_devices=4,
                    params=tree(p), aev=a)
               for p, a in zip(s['tp_params'], s['tp_aev'])],
        'pp': [dict(s['pp'], stages=4, num_microbatches=4)],
        'pp_ani': [dict(small, params=tree(s['pp_ani_params']),
                        aev=s['pp_ani_aev'], stages=3)],
    }
    return run_spmd(run_suite, 4, 'gloo', cfg, timeout_s=240.0)


def test_ranks_import_no_jax(ranks):
    for r in ranks:
        assert r['jax_imported'] == []


def test_mesh_shapes(ranks):
    for (n, mp), got in zip(MESH_SHAPES, ranks[0]['mesh_shapes']):
        assert got == dict(jsh.make_mesh(n, model_parallel=mp).shape), (n, mp)
    assert ranks[0]['mesh_shapes'][0] == {'dp': 2, 'mp': 2}
    assert ranks[0]['mesh_shapes'][1] == {'dp': 1, 'mp': 4}


@pytest.fixture(scope='module')
def jax_train(sys_):
    """JAX's unsharded step with optax.sgd, STEPS times: (losses, params)
    per force weight."""
    s = sys_
    out = {}
    for fw in FORCE_WEIGHTS:
        opt = optax.sgd(LR)
        step = jax.jit(jsh.make_train_step(s['model'], opt, fw))
        state = jsh.TrainState(s['params'], opt.init(s['params']))
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, jnp.asarray(s['batch']),
                               jnp.asarray(s['e_t']), jnp.asarray(s['f_t']))
            losses.append(float(loss))
        out[fw] = (losses, tree(state.params))
    return out


@pytest.mark.parametrize('fw', FORCE_WEIGHTS)
def test_train_step_dp_ep_matches_jax(ranks, jax_train, sys_, fw):
    """dp=2 x mp=2: the loss of each step and the parameters after the
    steps equal JAX's unsharded step; the update itself agrees to 1e-4 of
    its size (an ensemble gradient off by the factor mp or dp fails
    both)."""
    want_losses, want = jax_train[fw]
    for r in ranks:     # every rank reports the same replicated loss
        np.testing.assert_allclose(r['train'][fw]['losses'], want_losses,
                                   rtol=1e-5)
    assert want_losses[1] < want_losses[0]
    got = ranks[0]['train'][fw]['params']
    p0 = leaves(tree(sys_['params']))
    for g, w, p in zip(leaves(got), leaves(want), p0):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
        update = np.abs(w - p).max()
        assert np.abs((g - p) - (w - p)).max() <= 1e-4 * update + 1e-9
    # The check has teeth: the ensemble moved by far more than the
    # tolerance, and the force term moved it measurably.
    ens = slice(0, -1)
    assert max(np.abs(w - p).max() for w, p in
               zip(leaves(want)[ens], p0[ens])) > 1e-3
    if fw:
        base = leaves(jax_train[0.0][1])
        assert max(np.abs(w - b).max() for w, b in
                   zip(leaves(want)[ens], base[ens])) > 1e-4


def test_atom_sharded_energy_matches_jax(ranks, sys_):
    s = sys_
    mesh = jsh.make_mesh(4, model_parallel=1)
    fn = jsh.atom_sharded_energy(s['model'], mesh, axis='dp')
    pos = jnp.asarray(s['pos'])
    with jax.sharding.set_mesh(mesh):
        e_ref = float(jax.jit(fn)(s['params'], pos))
        f_ref = -np.asarray(jax.jit(jax.grad(fn, argnums=1))(s['params'],
                                                            pos))
    for r in ranks:
        (got,) = r['atom']
        e, f = got
        np.testing.assert_allclose(e, e_ref, rtol=1e-5)
        scale = np.abs(f_ref).max()
        assert np.abs(f - f_ref).max() <= 1e-4 * scale


@pytest.mark.parametrize('case', [0, 1], ids=['replicated_tail',
                                              'model_sharded_tail'])
def test_tensor_parallel_matches_jax(ranks, sys_, case):
    s = sys_
    params, aev = s['tp_params'][case], jnp.asarray(s['tp_aev'][case])
    mesh = jsh.make_mesh(4, model_parallel=4)
    fn = jsh.tp_ensemble_energy(s['model32'], mesh, axis='mp')
    with jax.sharding.set_mesh(mesh):
        e_tp = float(jax.jit(fn)(params, aev))
    e_ref = float(j_ensemble_energy(params.ensemble, aev,
                                    s['model32'].grouping))
    for r in ranks:
        np.testing.assert_allclose(r['tp'][case], e_tp, rtol=1e-5)
        np.testing.assert_allclose(r['tp'][case], e_ref, rtol=1e-5)


def test_pipeline_parallel_mlp_matches_jax(ranks, sys_):
    pp = sys_['pp']
    mesh = jsh.make_mesh(4, model_parallel=4)
    fn = jsh.pipeline_ensemble_energy((16,), mesh, axis='mp',
                                      num_microbatches=4)
    with jax.sharding.set_mesh(mesh):
        want = np.asarray(jax.jit(fn)(*(jnp.asarray(pp[k]) for k in
                                         ('stage_w', 'stage_b', 'x'))))
    for r in ranks:
        np.testing.assert_allclose(r['pp'][0], want, rtol=1e-5, atol=1e-6)


def test_pipeline_ani_ensemble_matches_jax(ranks, sys_):
    """3 stages on ranks 0-2 (rank 3 is outside that mesh)."""
    s = sys_
    mesh = jsh.make_mesh(3, model_parallel=3)
    fn = jsh.pipeline_ani_ensemble_energy(s['model'], mesh, axis='mp')
    aev = jnp.asarray(s['pp_ani_aev'])
    with jax.sharding.set_mesh(mesh):
        e_pp = float(jax.jit(fn)(s['pp_ani_params'], aev))
    for r in ranks[:3]:
        np.testing.assert_allclose(r['pp_ani'][0], e_pp, rtol=1e-5)
    assert ranks[3]['pp_ani'] == [None]


@pytest.mark.parametrize('optimizer', ['sgd_momentum', 'adam'])
def test_distributed_checkpoint_round_trip(sys_, tmp_path, optimizer):
    """2 ranks, mp=2: a step, a save, a fresh state loaded from it; every
    parameter shard and optimizer tensor restored bit for bit."""
    s = sys_
    factory = (functools.partial(torch.optim.SGD, lr=LR, momentum=0.9)
               if optimizer == 'sgd_momentum'
               else functools.partial(torch.optim.Adam, lr=1e-3))
    cfg = {'checkpoint': dict(basis=s['tb'], z=Z, elements=(1, 8, 7),
                              params=tree(s['params']),
                              positions=s['batch'][:2],
                              e_target=s['e_t'][:2], f_target=s['f_t'][:2],
                              model_parallel=2, optimizer=factory,
                              path=str(tmp_path / 'ckpt'))}
    for r in run_spmd(run_suite, 2, 'gloo', cfg, timeout_s=180.0):
        ck = r['checkpoint']
        assert ck['changed'] and ck['params_equal'] and ck['optim_equal']
        assert ck['optim_tensors'] > 0


def test_dryrun_multichip(capsys):
    res = dryrun_multichip(4)
    out = capsys.readouterr().out
    assert 'dryrun_multichip(4) OK' in out
    for name in ('dp/ep train step', 'sp inference', 'tp ensemble',
                 'pp microbatch', 'pp ani ensemble',
                 'sharded window pipeline', 'distributed checkpoint'):
        assert name in out
    assert res['jax_imported'] == []


def test_run_spmd_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match='ZeroDivisionError'):
        run_spmd(operator.truediv, 2, 'gloo', 1.0, 0.0, timeout_s=60.0)


def test_run_spmd_times_out_a_hung_rank():
    """A rank that never returns fails the call at its timeout; the ranks
    are terminated."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match='did not finish'):
        run_spmd(time.sleep, 2, 'gloo', 600.0, timeout_s=10.0)
    assert time.monotonic() - t0 < 60.0
