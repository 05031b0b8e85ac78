"""SPMD over a ``torch.distributed`` process group (port of
``nnpops_tpu.parallel.sharding``): one process per device, every function
called on every rank, a ``DeviceMesh`` with dims ``('dp', 'mp')`` in place
of the JAX mesh.

How the parallelism axes map onto the NNP workload:

* **DP**: a batch of conformations, split over ``dp``
  (:func:`shard_batch`); the parameter gradients are averaged over ``dp``.
* **EP**: the ANI ensemble's models are the experts: each rank of ``mp``
  keeps its slice of the model axis (:func:`shard_params`), and the
  ensemble mean is a sum over ``mp`` of the ranks' partial means.
* **SP**: :func:`atom_sharded_energy` splits the center atoms over an axis
  against replicated positions; forces come through autograd.
* **TP**: :func:`tp_ensemble_energy` splits layer 0 over the 1008-long
  AEV axis (one all-reduce), layers 1+ over the model axis.
* **PP**: :func:`pipeline_ensemble_energy` and
  :func:`pipeline_ani_ensemble_energy` run layer i on rank i of ``mp``,
  microbatches handed on by a ring shift.

Where JAX's GSPMD inserts the collectives and their transposes, this
module calls them itself (``parallel.collectives``). The train step forms
each conformation's energy and forces from this rank's models, sums both
over ``mp``, and then every ``mp`` rank evaluates the same loss: the
gradient of a local parameter is then exact with a pass-through backward
of the sums, also through the second-order force term (an all-reduce
whose backward all-reduces again would scale it by ``mp``).

Eager PyTorch has nothing to compile: :func:`jit_train_step` returns the
step of :func:`make_train_step`. Optimizers are ``torch.optim`` classes in
place of optax; they hold their state, so :func:`init_train_state` takes a
factory (``functools.partial(torch.optim.SGD, lr=1e-4)``) and applies it
to this rank's parameter tensors, and the state travels in
:class:`TrainState`.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models.ani import ANIModel, ANIParams
from ..ops.aev import aev_forward
from ..ops.batched_nn import (EnsembleParams, SpeciesNet, apply_species_net,
                              celu, ensemble_energy)
from .collectives import psum, replicated, ring_shift

Tensor = torch.Tensor


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 2,
              device_type: str = 'cuda') -> DeviceMesh:
    """A ``('dp', 'mp')`` mesh over the first ``n_devices`` ranks of the
    initialised default group (all of them by default); ``mp`` is the
    largest value up to ``model_parallel`` that divides the rank count.
    ``device_type``: 'cuda' on the card (NCCL), 'cpu' over gloo. Call it
    on every rank; a rank past ``n_devices`` is in no coordinate of the
    mesh (``get_coordinate()`` is None) and skips its functions."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f'n_devices={n} must lie in [1, {world}] (the '
                         'world size)')
    mp = max(1, min(model_parallel, n))
    while n % mp:
        mp -= 1
    return DeviceMesh(device_type, torch.arange(n).reshape(n // mp, mp),
                      mesh_dim_names=('dp', 'mp'))


def mesh_shape(mesh: DeviceMesh) -> dict:
    """``{'dp': ..., 'mp': ...}``, as ``jax.sharding.Mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_axis(mesh: DeviceMesh, axis: str):
    """(group, this rank's index along ``axis``, the axis size)."""
    size = int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])
    return mesh.get_group(axis), mesh.get_local_rank(axis), size


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(mesh.device_type)


# ---------------------------------------------------------------------------
# DP x EP training.
# ---------------------------------------------------------------------------

def ensemble_param_spec(params: ANIParams) -> ANIParams:
    """The sharding of every leaf: 'mp' (the leading model axis split over
    'mp') for the ensemble's weights and biases, None (replicated) for the
    self energies."""
    ens = EnsembleParams(tuple(
        SpeciesNet(tuple('mp' for _ in net.weights),
                   tuple('mp' for _ in net.biases))
        for net in params.ensemble.networks))
    return ANIParams(ens, None)


def param_leaves(params: ANIParams) -> List[Tensor]:
    """Every tensor of ``params`` in a fixed order: per species its
    weights then biases, the self energies last."""
    out = []
    for net in params.ensemble.networks:
        out.extend(net.weights)
        out.extend(net.biases)
    out.append(params.self_energies)
    return out


def shard_params(params: ANIParams, mesh: DeviceMesh) -> ANIParams:
    """This rank's parameters in the EP layout, on the mesh's device: its
    ``mp`` slice of every ensemble leaf's model axis, the self energies
    whole."""
    _, idx, mp = mesh_axis(mesh, 'mp')
    m = params.ensemble.num_models
    if m % mp:
        raise ValueError(f'{m} models do not split over mp={mp}')
    m_loc = m // mp
    dev = mesh_device(mesh)

    def take(x):
        return x[idx * m_loc:(idx + 1) * m_loc].detach().to(dev).clone()

    nets = tuple(SpeciesNet(tuple(take(w) for w in net.weights),
                            tuple(take(b) for b in net.biases))
                 for net in params.ensemble.networks)
    return ANIParams(EnsembleParams(nets),
                     params.self_energies.detach().to(dev).clone())


class TrainState(NamedTuple):
    """This rank's parameter shard (leaves that require grad) and the
    ``torch.optim`` optimizer over them (its state is optax's
    ``opt_state``)."""
    params: ANIParams
    opt_state: torch.optim.Optimizer


def init_train_state(model: ANIModel, optimizer: Callable,
                     params: ANIParams, mesh: DeviceMesh) -> TrainState:
    """Shard ``params`` onto the mesh and build the optimizer over this
    rank's shard: ``optimizer(list_of_tensors)``, e.g.
    ``functools.partial(torch.optim.SGD, lr=1e-4)``."""
    sharded = shard_params(params, mesh)
    leaves = param_leaves(sharded)
    for p in leaves:
        p.requires_grad_(True)
    return TrainState(sharded, optimizer(leaves))


def shard_batch(mesh: DeviceMesh, *arrays: Tensor) -> Tuple[Tensor, ...]:
    """This rank's ``dp`` block of each array's leading dim, on the mesh's
    device."""
    _, idx, dp = mesh_axis(mesh, 'dp')
    dev = mesh_device(mesh)
    out = []
    for a in arrays:
        a = torch.as_tensor(a)
        if a.shape[0] % dp:
            raise ValueError(f'batch {a.shape[0]} does not split over '
                             f'dp={dp}')
        b = a.shape[0] // dp
        out.append(a[idx * b:(idx + 1) * b].to(dev))
    return tuple(out)


def _partial_energy(model: ANIModel, params: ANIParams, pos: Tensor,
                    mp: int, with_sae: bool) -> Tensor:
    """This rank's share of one conformation's energy: the ensemble mean
    over its models, over ``mp`` (the ``mp`` ranks' shares sum to the
    ensemble mean); plus the self energies where ``with_sae``."""
    grouping, _ = model._device_grouping(pos.device)
    e = ensemble_energy(params.ensemble, model.aev(pos), grouping,
                        model.nn_compute_dtype) / mp
    if with_sae:
        _, species = model._device_arrays(pos.device)
        e = e + torch.sum(params.self_energies[species])
    return e


def make_train_step(model: ANIModel, force_weight: float = 0.0,
                    mesh: Optional[DeviceMesh] = None) -> Callable:
    """The training step: the batch mean of ``(e - e_t)^2``, plus
    ``force_weight * mean((f - f_t)^2)`` when ``force_weight > 0`` (force
    matching, second-order autograd through the forces).

    ``mesh`` None is the plain single-process step (the JAX
    ``make_train_step``). With a mesh, ``state`` holds this rank's EP
    shard (:func:`init_train_state`) and the batch arrays its DP block
    (:func:`shard_batch`); the energies and forces are summed over
    ``mp``, the gradients averaged over ``dp``, the self energies' summed
    over ``mp`` too (they enter on ``mp`` rank 0 only).

    Returns ``step(state, positions [B, N, 3], e_target [B], f_target [B,
    N, 3]) -> (state, loss)``, the loss the global batch mean (replicated),
    after the optimizer's update of ``state.params`` in place."""
    mp, with_sae = 1, True
    if mesh is not None:
        mp_group, mp_idx, mp = mesh_axis(mesh, 'mp')
        dp_group, _, dp = mesh_axis(mesh, 'dp')
        with_sae = mp_idx == 0

    def step(state: TrainState, positions, e_target, f_target):
        params, opt = state
        opt.zero_grad(set_to_none=True)
        total = positions.new_zeros(())
        with torch.enable_grad():
            for pos, et, ft in zip(positions, e_target, f_target):
                pos = pos.detach().requires_grad_(force_weight > 0.0)
                e = _partial_energy(model, params, pos, mp, with_sae)
                if force_weight > 0.0:
                    (g,) = torch.autograd.grad(e, pos, create_graph=True)
                    f = -g if mesh is None else psum(-g, mp_group)
                if mesh is not None:
                    e = psum(e, mp_group)
                total = total + (e - et) ** 2
                if force_weight > 0.0:
                    total = total + force_weight * torch.mean((f - ft) ** 2)
            loss = total / positions.shape[0]
            loss.backward()
        if mesh is not None:
            leaves = param_leaves(params)
            sae = leaves[-1]
            if sae.grad is None:
                sae.grad = torch.zeros_like(sae)
            dist.all_reduce(sae.grad, group=mp_group)
            for p in leaves:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                dist.all_reduce(p.grad, group=dp_group)
                p.grad /= dp
            loss = loss.detach().clone()
            dist.all_reduce(loss, group=dp_group)
            loss = loss / dp
        opt.step()
        return TrainState(params, opt), loss.detach()

    return step


def jit_train_step(model: ANIModel, mesh: DeviceMesh,
                   force_weight: float = 0.0) -> Callable:
    """The sharded train step (eager PyTorch compiles nothing; the name
    mirrors the JAX package's)."""
    return make_train_step(model, force_weight, mesh)


# ---------------------------------------------------------------------------
# Inference: TP, PP, SP.
# ---------------------------------------------------------------------------

def replicated_params(params: ANIParams, group) -> ANIParams:
    nets = tuple(SpeciesNet(tuple(replicated(w, group) for w in net.weights),
                            tuple(replicated(b, group) for b in net.biases))
                 for net in params.ensemble.networks)
    return ANIParams(EnsembleParams(nets),
                     replicated(params.self_energies, group))


def tp_ensemble_energy(model: ANIModel, mesh: DeviceMesh,
                       axis: str = 'mp') -> Callable:
    """Tensor-parallel ensemble evaluation, every layer sharded.

    Layer 0 (the one large contraction, 1008 wide in ANI-2x) splits over
    the AEV axis: each rank multiplies its slice of W0 by its columns of
    the features and one all-reduce rebuilds the activations. Layers 1+
    split over the model axis when ``axis`` size divides the model count
    (else they run replicated, and each rank's share is scaled to match);
    a final scalar all-reduce sums the ranks' partial energies.

    Returns ``fn(params, aev [N, aev_length]) -> energy`` (no self
    energies), on replicated inputs."""
    group, idx, k = mesh_axis(mesh, axis)
    aev_len = model.basis.aev_length
    if aev_len % k:
        raise ValueError(f'axis size {k} must divide aev length {aev_len}')
    grouping = model.grouping

    def fn(params: ANIParams, aev: Tensor) -> Tensor:
        params = replicated_params(params, group)
        aev = replicated(aev, group)
        order, _ = model._device_arrays(aev.device)
        cols = aev_len // k
        gathered = aev.index_select(0, order)[:, idx * cols:(idx + 1) * cols]
        total = aev.new_zeros(())
        start = 0
        for s, count in enumerate(grouping.counts):
            if count == 0:
                continue
            net = params.ensemble.networks[s]
            block = gathered[start:start + count]
            m, out0, _ = net.weights[0].shape
            sharded_tail = m % k == 0
            m_loc = m // k if sharded_tail else m
            m_start = idx * m_loc if sharded_tail else 0
            # The final sum adds every rank's share: a replicated tail
            # contributes k equal copies.
            divisor = m if sharded_tail else m * k
            w0 = net.weights[0][:, :, idx * cols:(idx + 1) * cols]
            w0_mat = w0.permute(2, 0, 1).reshape(cols, m * out0)
            h = psum(block @ w0_mat, group)                # TP all-reduce
            h = celu(h.reshape(count, m, out0) + net.biases[0])
            h = h.transpose(0, 1)[m_start:m_start + m_loc]  # [m_loc, n, out]
            num_layers = len(net.weights)
            for layer in range(1, num_layers):
                w = net.weights[layer][m_start:m_start + m_loc]
                b = net.biases[layer][m_start:m_start + m_loc]
                h = h @ w.transpose(1, 2) + b[:, None, :]
                if layer < num_layers - 1:
                    h = celu(h)
            total = total + torch.sum(h[:, :, 0]) / divisor
            start += count
        return psum(total, group)

    return fn


def pipeline_ani_ensemble_energy(model: ANIModel, mesh: DeviceMesh,
                                 axis: str = 'mp') -> Callable:
    """Pipeline-parallel evaluation of the ANI ensemble: layer i of the
    per-species CELU networks runs on rank i of ``axis`` (stages equal the
    network depth), species-homogeneous microbatches of atoms (each padded
    to the largest species count) handed on by a ring shift each tick
    (bubble ``stages - 1``). Activations ride a buffer padded to the widest
    layer; the weights stay replicated (PP places the compute).

    Returns ``fn(params, aev) -> total NN energy`` (no self energies), equal
    to ``ops.batched_nn.ensemble_energy``."""
    group, idx, stages = mesh_axis(mesh, axis)
    grouping = model.grouping
    present = [s for s, c in enumerate(grouping.counts) if c > 0]
    counts = [grouping.counts[s] for s in present]
    mb = max(counts)
    num_mb = len(present)

    def fn(params: ANIParams, aev: Tensor) -> Tensor:
        params = replicated_params(params, group)
        aev = replicated(aev, group)
        nets = params.ensemble.networks
        num_layers = len(nets[present[0]].weights)
        if num_layers != stages:
            raise ValueError(f'pipeline needs axis size == network depth '
                             f'({stages} != {num_layers})')
        m = nets[present[0]].weights[0].shape[0]
        h_max = max(max(w.shape[1] for w in nets[s].weights)
                    for s in present)
        order, _ = model._device_arrays(aev.device)
        gathered = aev.index_select(0, order)
        blocks, masks = [], []
        start = 0
        for c in counts:
            blocks.append(torch.nn.functional.pad(
                gathered[start:start + c], (0, 0, 0, mb - c)))
            masks.append((torch.arange(mb, device=aev.device) < c)
                         .to(aev.dtype))
            start += c

        buf = aev.new_zeros(m, mb, h_max)
        acc = aev.new_zeros(())
        for t in range(num_mb + stages - 1):
            mb_id = t - idx          # the microbatch this stage works on
            if 0 <= mb_id < num_mb:
                net = nets[present[mb_id]]
                w, b = net.weights[idx], net.biases[idx]
                o, i = w.shape[1], w.shape[2]
                if idx == 0:
                    h = blocks[mb_id] @ w.permute(2, 0, 1).reshape(i, m * o)
                    h = h.reshape(mb, m, o).transpose(0, 1)
                else:
                    h = buf[:, :, :i] @ w.transpose(1, 2)
                h = h + b[:, None, :]
                if idx < num_layers - 1:
                    h = celu(h)
                out = torch.nn.functional.pad(h, (0, h_max - o))
                if idx == stages - 1:
                    acc = acc + torch.sum(torch.mean(out[:, :, 0], 0)
                                          * masks[mb_id])
            else:
                out = aev.new_zeros(m, mb, h_max)
            buf = ring_shift(out, group)
        return psum(acc, group)

    return fn


def pipeline_ensemble_energy(layer_dims: Tuple[int, ...], mesh: DeviceMesh,
                             axis: str = 'mp',
                             num_microbatches: int = 4) -> Callable:
    """Pipeline-parallel MLP evaluation: layer i on rank i of ``axis``,
    microbatches of atoms streamed through the stages by a ring shift
    (the classic 1F pipeline, bubble ``stages - 1``), on a homogeneous
    stack of one width (``layer_dims`` names it, as in the JAX package).

    Returns ``fn(stage_weights [S, W, W], stage_biases [S, W], x [N, W]) ->
    outputs [N, W]`` (ReLU after every stage), S the axis size and N a
    multiple of ``num_microbatches``; rank i reads stage i's slice."""
    group, idx, stages = mesh_axis(mesh, axis)

    def fn(stage_w: Tensor, stage_b: Tensor, x: Tensor) -> Tensor:
        if stage_w.shape[0] != stages:
            raise ValueError(f'{stage_w.shape[0]} stages on an axis of '
                             f'{stages}')
        n = x.shape[0]
        if n % num_microbatches:
            raise ValueError(f'num atoms {n} must be divisible by '
                             f'num_microbatches {num_microbatches}')
        x = replicated(x, group)
        w, b = stage_w[idx], stage_b[idx]
        mb = n // num_microbatches
        x_mb = x.reshape(num_microbatches, mb, -1)
        buf = x.new_zeros(mb, x.shape[1])
        done = []
        for t in range(num_microbatches + stages - 1):
            # Stage 0 injects microbatch t; the others take the handoff.
            current = (x_mb[min(t, num_microbatches - 1)] if idx == 0
                       else buf)
            y = torch.relu(current @ w + b)
            buf = ring_shift(y, group)
            if t >= stages - 1 and idx == stages - 1:
                done.append(y)
        # Only the last stage holds the outputs; the sum hands them out.
        out = torch.cat(done) if done else x.new_zeros(n, w.shape[1])
        return psum(out, group)

    return fn


def atom_sharded_energy(model: ANIModel, mesh: DeviceMesh,
                        axis: str = 'dp') -> Callable:
    """Atom-axis (SP) sharded energy.

    Each rank computes the AEV and atomic energies of its contiguous block
    of center atoms against the replicated positions (the ``centers``
    argument of ``ops.aev.aev_forward``), then one all-reduce sums the
    ranks' energies. A block's species mix depends on the data, so the
    atomic energies come from a masked evaluation of every species'
    network.

    Returns ``fn(params, positions) -> energy``, differentiable (forces by
    autograd on every rank); the atom count must divide over the axis."""
    group, idx, k = mesh_axis(mesh, axis)
    n = model.num_atoms
    if n % k:
        raise ValueError(f'num_atoms {n} must divide mesh axis size {k}')
    block = n // k
    start = idx * block

    def fn(params: ANIParams, positions: Tensor) -> Tensor:
        params = replicated_params(params, group)
        positions = replicated(positions, group)
        _, species = model._device_arrays(positions.device)
        centers = torch.arange(start, start + block, device=positions.device)
        feat = aev_forward(positions, species, model.basis, centers=centers,
                           angular_capacity=model.angular_capacity)
        sp = species[start:start + block]
        total = positions.new_zeros(())
        for s, net in enumerate(params.ensemble.networks):
            e_s = torch.mean(apply_species_net(net, feat), -1)     # [block]
            total = total + torch.sum(torch.where(sp == s, e_s, 0.0))
        total = total + torch.sum(params.self_energies[sp])
        return psum(total, group)

    return fn
