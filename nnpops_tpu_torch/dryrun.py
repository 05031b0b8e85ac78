"""Multi-rank dry run of the parallel layer (the twin of the JAX package's
``dryrun_multichip``), and the rank function that drives each sharded
path on given inputs.

:func:`run_suite` runs on every rank of a process group and evaluates
the sections of its config that are present (each a dict of numpy inputs,
parameter trees as plain nested tuples): 'mesh_shapes', 'train' (the DP x
EP step, with and without force matching), 'atom' (SP), 'tp', 'pp',
'pp_ani', 'window' (the window pipeline sharded over cell and row blocks)
and 'checkpoint' (the distributed round trip). It returns numpy results,
so the CPU tests hold them to the JAX package's, and
:func:`dryrun_multichip` to finite values. It lives in the package, not in
a test, because spawned ranks import their function by module and must
not import JAX.

    python3 -m nnpops_tpu_torch.dryrun 4     # four gloo ranks on the CPU
"""
from __future__ import annotations

import functools
import sys
import tempfile

import numpy as np
import torch

from .config import ANIBasis
from .models.ani import ANIModel, init_ani_params
from .params import from_jax_params
from .parallel.collectives import all_gather_rows
from .parallel.launch import run_spmd
from .parallel.sharding import (atom_sharded_energy, init_train_state,
                                jit_train_step, make_mesh, mesh_shape,
                                param_leaves, pipeline_ani_ensemble_energy,
                                pipeline_ensemble_energy, shard_batch,
                                tp_ensemble_energy, mesh_axis)
from .parallel.window_shard import window_sharded_energy
from .utils.water import make_water_box


def params_tree(params):
    """``ANIParams`` -> the plain nested tuple of numpy arrays that
    ``params.from_jax_params`` reads back."""
    nets = tuple((tuple(w.detach().cpu().numpy() for w in net.weights),
                  tuple(b.detach().cpu().numpy() for b in net.biases))
                 for net in params.ensemble.networks)
    return ((nets,), params.self_energies.detach().cpu().numpy())


def _model(c) -> ANIModel:
    return ANIModel.from_atomic_numbers(c['z'], c['basis'],
                                        elements=c['elements'])


def _in_mesh(mesh) -> bool:
    return mesh.get_coordinate() is not None


def _gathered_tree(params, mesh):
    """The whole ensemble from the ranks' ``mp`` shards, as numpy."""
    group = mesh_axis(mesh, 'mp')[0]
    leaves = param_leaves(params)
    with torch.no_grad():
        full = [all_gather_rows(p.detach(), group).cpu().numpy()
                for p in leaves[:-1]]
    out, k = [], 0
    for net in params.ensemble.networks:
        nl = len(net.weights)
        out.append((tuple(full[k:k + nl]), tuple(full[k + nl:k + 2 * nl])))
        k += 2 * nl
    return ((tuple(out),), leaves[-1].detach().cpu().numpy())


def _train(c, device_type):
    model = _model(c)
    mesh = make_mesh(c.get('n_devices'), c['model_parallel'], device_type)
    results = {}
    for fw in c['force_weights']:
        state = init_train_state(model, c['optimizer'],
                                 from_jax_params(c['params'], 'cpu'), mesh)
        step = jit_train_step(model, mesh, force_weight=fw)
        batch = shard_batch(mesh, *(torch.as_tensor(c[k]) for k in
                                    ('positions', 'e_target', 'f_target')))
        losses = []
        for _ in range(c['steps']):
            state, loss = step(state, *batch)
            losses.append(float(loss))
        results[fw] = {'losses': losses,
                       'params': _gathered_tree(state.params, mesh)}
    return results


def _forces(fn, params, positions, device):
    pos = torch.as_tensor(positions, device=device).requires_grad_(True)
    e = fn(params, pos)
    (g,) = torch.autograd.grad(e, pos)
    return float(e.detach()), (-g).cpu().numpy()


def _atom(c, device_type, device):
    model = _model(c)
    mesh = make_mesh(c['n_devices'], 1, device_type)
    if not _in_mesh(mesh):
        return None
    fn = atom_sharded_energy(model, mesh, axis='dp')
    return _forces(fn, from_jax_params(c['params'], device), c['positions'],
                   device)


def _tp(c, device_type, device):
    model = _model(c)
    mesh = make_mesh(c['n_devices'], c['n_devices'], device_type)
    if not _in_mesh(mesh):
        return None
    fn = tp_ensemble_energy(model, mesh, axis='mp')
    return float(fn(from_jax_params(c['params'], device),
                    torch.as_tensor(c['aev'], device=device)))


def _pp(c, device_type, device):
    mesh = make_mesh(c['stages'], c['stages'], device_type)
    if not _in_mesh(mesh):
        return None
    fn = pipeline_ensemble_energy((c['x'].shape[1],), mesh, axis='mp',
                                  num_microbatches=c['num_microbatches'])
    return fn(*(torch.as_tensor(c[k], device=device)
                for k in ('stage_w', 'stage_b', 'x'))).cpu().numpy()


def _pp_ani(c, device_type, device):
    model = _model(c)
    mesh = make_mesh(c['stages'], c['stages'], device_type)
    if not _in_mesh(mesh):
        return None
    fn = pipeline_ani_ensemble_energy(model, mesh, axis='mp')
    return float(fn(from_jax_params(c['params'], device),
                    torch.as_tensor(c['aev'], device=device)))


def _window(c, device_type, device):
    model = _model(c).with_blocked_layout(c['positions'], c['box'],
                                          impl='window', skin=c['skin'])
    mesh = make_mesh(c['n_devices'], 1, device_type)
    if not _in_mesh(mesh):
        return None
    layout = model.blocked_layout
    if model.aev_impl != 'window' or layout.ang_tier_rows is None:
        return {'tiers': None}
    box = torch.as_tensor(c['box'], device=device)
    pos = torch.as_tensor(c['positions'], device=device)
    cell_list = model.create_cell_list(c['box'], skin=c['skin'])
    sel = model.select(pos, box, cell_list)
    fn = window_sharded_energy(model, mesh, axis='dp')
    params = from_jax_params(c['params'], device)
    e, f = _forces(lambda p, x: fn(p, x, box, sel), params, c['positions'],
                   device)
    # The same selection through the unsharded window path.
    e_u, f_u = model.energy_and_forces_from_selection(params, pos, box,
                                                      cell_list, sel)
    return {'energy': e, 'forces': f, 'tiers': len(layout.ang_tier_caps) + 1,
            'unsharded': (float(e_u), f_u.cpu().numpy())}


def _checkpoint(c, device_type):
    """One step, a save, a fresh state loaded from it: every parameter and
    optimizer tensor restored bit for bit."""
    from .md.checkpoint import (load_checkpoint_distributed,
                                save_checkpoint_distributed)
    model = _model(c)
    mesh = make_mesh(c.get('n_devices'), c['model_parallel'], device_type)
    batch = shard_batch(mesh, *(torch.as_tensor(c[k]) for k in
                                ('positions', 'e_target', 'f_target')))
    state = init_train_state(model, c['optimizer'],
                             from_jax_params(c['params'], 'cpu'), mesh)
    state, _ = jit_train_step(model, mesh)(state, *batch)
    save_checkpoint_distributed(c['path'], state, mesh)
    fresh = init_train_state(model, c['optimizer'],
                             from_jax_params(c['params'], 'cpu'), mesh)
    before = [p.detach().clone() for p in param_leaves(fresh.params)]
    load_checkpoint_distributed(c['path'], fresh, mesh)
    want = [p.detach() for p in param_leaves(state.params)]
    got = [p.detach() for p in param_leaves(fresh.params)]
    opt_want = state.opt_state.state_dict()['state']
    opt_got = fresh.opt_state.state_dict()['state']
    tensors = [(a, opt_got[i][k]) for i in opt_want
               for k, a in opt_want[i].items() if isinstance(a, torch.Tensor)]
    return {'params_equal': all(torch.equal(a, b) for a, b in zip(want, got)),
            'changed': not all(torch.equal(a, b)
                               for a, b in zip(want, before)),
            'optim_tensors': len(tensors),
            'optim_equal': all(torch.equal(a, b) for a, b in tensors)}


def run_suite(cfg: dict) -> dict:
    """The rank function: each present section of ``cfg`` on this rank
    (device 'cpu' over gloo, or 'cuda'); results as numpy and floats
    (None for a section whose sub-mesh leaves this rank out). Every rank
    must get the same ``cfg``."""
    device_type = cfg.get('device', 'cpu')
    device = (torch.device('cuda', torch.cuda.current_device())
              if device_type == 'cuda' else torch.device('cpu'))
    out = {}
    if 'mesh_shapes' in cfg:
        out['mesh_shapes'] = [mesh_shape(make_mesh(n, mp, device_type))
                              for n, mp in cfg['mesh_shapes']]
    if 'train' in cfg:
        out['train'] = _train(cfg['train'], device_type)
    for name, fn in (('atom', _atom), ('tp', _tp), ('pp', _pp),
                     ('pp_ani', _pp_ani), ('window', _window)):
        if name in cfg:
            out[name] = [fn(c, device_type, device) for c in cfg[name]]
    if 'checkpoint' in cfg:
        out['checkpoint'] = _checkpoint(cfg['checkpoint'], device_type)
    out['jax_imported'] = sorted(
        m for m in sys.modules if m == 'jax' or m.startswith('jax.')
        or m == 'nnpops_tpu' or m.startswith('nnpops_tpu.'))
    return out


# ---------------------------------------------------------------------------
# The dry run.
# ---------------------------------------------------------------------------

def _small_params(basis, layer_dims, num_models, seed):
    return params_tree(init_ani_params(torch.Generator().manual_seed(seed),
                                       basis, layer_dims=layer_dims,
                                       num_models=num_models, device='cpu'))


def dryrun_config(n_devices: int, tmpdir: str) -> tuple:
    """The dry run's sections for ``n_devices`` ranks (tiny shapes, from
    numpy seeds), under the JAX dry run's divisibility conditions; returns
    (cfg, the names of the paths it runs)."""
    rng = np.random.RandomState(0)
    basis = ANIBasis.from_grids(3, 4.6, 3.1, EtaR=[16.0],
                                ShfR=[1.0, 2.5, 4.0], EtaA=[8.0], Zeta=[8.0],
                                ShfA=[1.0, 2.0], ShfZ=[0.5, 1.5])
    num_atoms = max(8, n_devices)            # divisible by every layout
    z = ([8, 1, 1, 7] * ((num_atoms + 3) // 4))[:num_atoms]
    small = dict(basis=basis, z=z, elements=(1, 8, 7),
                 params=_small_params(basis, ((16, 8),) * 3, 4, 0))
    batch = dict(positions=rng.rand(n_devices, num_atoms, 3)
                 .astype(np.float32) * 4,
                 e_target=np.zeros(n_devices, np.float32))
    batch['f_target'] = np.zeros_like(batch['positions'])
    mp = 2 if n_devices % 2 == 0 else 1
    cfg = {'train': dict(small, **batch, model_parallel=mp,
                         optimizer=functools.partial(torch.optim.Adam,
                                                     lr=1e-3),
                         force_weights=(0.1,), steps=1)}
    ran = ['dp/ep train step']
    if num_atoms % n_devices == 0:
        cfg['atom'] = [dict(small, n_devices=n_devices,
                            positions=rng.rand(num_atoms, 3)
                            .astype(np.float32) * 4)]
        ran.append('sp inference')
    basis32 = ANIBasis.from_grids(2, 4.6, 3.1, EtaR=[16.0],
                                  ShfR=[1.0, 2.0, 3.0, 4.0], EtaA=[8.0],
                                  Zeta=[8.0], ShfA=[1.0, 2.0],
                                  ShfZ=[0.5, 1.0, 1.5, 2.0])
    if basis32.aev_length % n_devices == 0:
        cfg['tp'] = [dict(basis=basis32, z=([8, 1, 1] * 6)[:num_atoms],
                          elements=(1, 8), n_devices=n_devices,
                          params=_small_params(basis32, ((16, 8),) * 2, 4, 1),
                          aev=rng.randn(num_atoms, basis32.aev_length)
                          .astype(np.float32))]
        ran.append('tp ensemble')
    stages = 4 if n_devices % 4 == 0 else (2 if n_devices % 2 == 0 else 1)
    if stages > 1:
        width = 16
        cfg['pp'] = [dict(stages=stages, num_microbatches=4,
                          stage_w=rng.randn(stages, width, width)
                          .astype(np.float32) * 0.3,
                          stage_b=np.zeros((stages, width), np.float32),
                          x=rng.randn(16, width).astype(np.float32))]
        ran.append('pp microbatch')
    if n_devices >= 3:
        cfg['pp_ani'] = [dict(small, stages=3,
                              aev=rng.randn(num_atoms, basis.aev_length)
                              .astype(np.float32))]
        ran.append('pp ani ensemble')
    # The window pipeline: the smallest box that admits a 3^3 cell grid.
    water = make_water_box(150, seed=0)
    wbasis = ANIBasis.from_grids(2, 5.1, 3.5, EtaR=[16.0],
                                 ShfR=[1.0, 2.5, 4.0], EtaA=[8.0],
                                 Zeta=[8.0], ShfA=[1.0, 2.0], ShfZ=[0.5, 1.5])
    cfg['window'] = [dict(basis=wbasis, z=water.atomic_numbers,
                          elements=(1, 8), n_devices=n_devices, skin=0.25,
                          positions=water.positions, box=water.box,
                          params=_small_params(wbasis, ((16, 8),) * 2, 2, 2))]
    cfg['checkpoint'] = dict(cfg['train'], path=f'{tmpdir}/checkpoint')
    return cfg, ran


def dryrun_multichip(n_devices: int) -> dict:
    """Run every sharded path on ``n_devices`` gloo ranks on the CPU with
    tiny shapes (the DP x EP force-matching step with Adam, SP, TP, PP, the
    pipelined ANI ensemble, the sharded window pipeline, the distributed
    checkpoint), check that each gave finite values, and print what ran.
    Returns rank 0's results."""
    with tempfile.TemporaryDirectory() as tmp:
        cfg, ran = dryrun_config(n_devices, tmp)
        res = run_spmd(run_suite, n_devices, 'gloo', cfg)[0]
    if res['jax_imported']:
        raise AssertionError(f'a rank imported {res["jax_imported"]}')
    (train,) = res['train'].values()
    loss = train['losses'][0]
    checks = [np.isfinite(loss)]
    checks += [np.isfinite(e) and np.isfinite(f).all()
               for e, f in res.get('atom', [])]
    checks += [np.isfinite(e) for e in res.get('tp', [])]
    checks += [np.isfinite(y).all() for y in res.get('pp', [])]
    checks += [np.isfinite(e) for e in res.get('pp_ani', [])]
    (window,) = res['window']
    if window['tiers'] is not None:
        checks.append(np.isfinite(window['energy'])
                      and np.isfinite(window['forces']).all())
        ran.append('sharded window pipeline')
    ck = res['checkpoint']
    checks.append(ck['params_equal'] and ck['optim_equal'] and ck['changed'])
    ran.append('distributed checkpoint')
    if not all(checks):
        raise AssertionError(f'dryrun_multichip({n_devices}): non-finite or '
                             f'unequal results: {res}')
    print(f'dryrun_multichip({n_devices}) OK: train loss {loss:.6f} '
          f'(exercised: {", ".join(ran)})')
    return res


if __name__ == '__main__':
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
