"""Checkpoint / resume of nested NamedTuples, tuples, lists and dicts of
tensors, MD state and parameters alike (port of the npz path of
``nnpops_tpu.md.checkpoint``).

Leaves are saved in flattening order to one ``.npz``; a
``torch.Generator`` leaf (the MD state's) is saved as its state, so a
resumed Langevin run draws the same numbers. Loading takes a template of
the same structure: shapes must match, and each leaf comes back in the
template's dtype and on its device (restore is exact, bit for bit).

``save_checkpoint_distributed`` / ``load_checkpoint_distributed`` are the
counterparts of the JAX package's Orbax path: PyTorch's sharded
checkpoint (``torch.distributed.checkpoint``) of an EP-sharded
``parallel.sharding.TrainState``, called on every rank. Each ensemble
leaf is saved as a DTensor over the mesh (replicated over 'dp', its model
axis sharded over 'mp'), so the file holds the whole ensemble in its
global layout and each rank writes and reads only its shard; the self
energies and the optimizer's scalars are saved once.
"""
from __future__ import annotations

import os
from typing import Any, List

import numpy as np
import torch


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _unflatten(template: Any, leaves) -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, tuple) and hasattr(template, '_fields'):
        return type(template)(*(_unflatten(t, leaves) for t in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(t, leaves) for t in template)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree: Any) -> None:
    """Save every leaf of ``tree`` to ``path`` (.npz), atomically: a crash
    never leaves a torn checkpoint."""
    arrays = {f'leaf_{i:05d}': _to_numpy(leaf)
              for i, leaf in enumerate(_leaves(tree))}
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _restore(got: np.ndarray, want):
    if isinstance(want, torch.Generator):
        gen = torch.Generator(device=want.device)
        gen.set_state(torch.from_numpy(got.copy()))
        return gen
    shape = tuple(np.shape(want))
    if got.shape != shape:
        raise ValueError(f'leaf shape mismatch: {got.shape} vs {shape}')
    if isinstance(want, torch.Tensor):
        return torch.from_numpy(got.copy()).to(dtype=want.dtype,
                                                device=want.device)
    return got.astype(np.asarray(want).dtype)


def load_checkpoint(path: str, template: Any) -> Any:
    """Load a checkpoint saved by :func:`save_checkpoint` into the structure
    of ``template`` (leaf count and shapes must match; raises ValueError)."""
    with np.load(path) as data:
        saved = [data[f'leaf_{i:05d}'] for i in range(len(data.files))]
    t_leaves = _leaves(template)
    if len(saved) != len(t_leaves):
        raise ValueError(f'checkpoint has {len(saved)} leaves, template has '
                         f'{len(t_leaves)}')
    restored = [_restore(g, w) for g, w in zip(saved, t_leaves)]
    return _unflatten(template, iter(restored))


def _dtensor(local, mesh, sharded: bool):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not sharded:
        return local
    placements = [Shard(0) if name == 'mp' else Replicate()
                  for name in mesh.mesh_dim_names]
    return DTensor.from_local(local, mesh, placements, run_check=False)


def _train_state_dict(state, mesh, optim_state) -> dict:
    """The flat DCP state dict of ``state``'s parameters and of
    ``optim_state`` (an optimizer state dict's ``'state'``)."""
    from ..parallel.sharding import ensemble_param_spec, param_leaves
    leaves = param_leaves(state.params)
    sharded = [spec == 'mp'
               for spec in param_leaves(ensemble_param_spec(state.params))]
    sd = {f'params.{i}': _dtensor(p.detach(), mesh, sh)
          for i, (p, sh) in enumerate(zip(leaves, sharded))}
    for i, entry in optim_state.items():
        for key, value in entry.items():
            if isinstance(value, torch.Tensor):
                like = (sharded[i]
                        and tuple(value.shape) == tuple(leaves[i].shape))
                value = _dtensor(value, mesh, like)
            sd[f'optim.{i}.{key}'] = value
    return sd


def save_checkpoint_distributed(path: str, state, mesh) -> None:
    """Save an EP-sharded ``TrainState`` (parameters and optimizer state)
    with ``torch.distributed.checkpoint`` into the directory ``path``.
    Call on every rank with the mesh of ``init_train_state``."""
    import torch.distributed.checkpoint as dcp
    opt = state.opt_state.state_dict()
    sd = _train_state_dict(state, mesh, opt['state'])
    sd['optim.param_groups'] = opt['param_groups']
    dcp.save(sd, checkpoint_id=os.path.abspath(path))


def load_checkpoint_distributed(path: str, state, mesh):
    """Restore a checkpoint of :func:`save_checkpoint_distributed` into
    ``state`` (a ``TrainState`` of the same model and mesh layout, e.g.
    fresh from ``init_train_state``): the parameters are overwritten in
    place, the optimizer state loaded (bit for bit). Returns ``state``.
    Call on every rank."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata
    from ..parallel.sharding import ensemble_param_spec, param_leaves
    path = os.path.abspath(path)
    metadata = dcp.FileSystemReader(path).read_metadata()
    leaves = param_leaves(state.params)
    sharded = [spec == 'mp'
               for spec in param_leaves(ensemble_param_spec(state.params))]
    mp = int(mesh.mesh.shape[mesh.mesh_dim_names.index('mp')])
    # The optimizer entries the checkpoint holds, each allocated in the
    # layout of its parameter (a tensor of the parameter's global shape
    # is sharded as the parameter is).
    optim_state = {}
    for key, meta in metadata.state_dict_metadata.items():
        parts = key.split('.')
        if parts[0] != 'optim' or parts[1] == 'param_groups':
            continue
        i, name = int(parts[1]), '.'.join(parts[2:])
        if isinstance(meta, TensorStorageMetadata):
            p = leaves[i]
            full = tuple(meta.size)
            if sharded[i] and full == (p.shape[0] * mp,) + tuple(
                    p.shape[1:]):
                full = tuple(p.shape)     # this rank's shard
            value = torch.empty(full, dtype=meta.properties.dtype,
                                device=p.device)
        else:
            value = None
        optim_state.setdefault(i, {})[name] = value
    sd = _train_state_dict(state, mesh, optim_state)
    sd = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
          for k, v in sd.items()}
    sd['optim.param_groups'] = state.opt_state.state_dict()['param_groups']
    dcp.load(sd, checkpoint_id=path)

    def local(v):
        return v.to_local() if hasattr(v, 'to_local') else v

    with torch.no_grad():
        for i, p in enumerate(leaves):
            p.copy_(local(sd[f'params.{i}']))
    restored = {i: {name: local(sd[f'optim.{i}.{name}']) for name in entry}
                for i, entry in optim_state.items()}
    state.opt_state.load_state_dict({'state': restored,
                                     'param_groups': sd['optim.param_groups']})
    return state
