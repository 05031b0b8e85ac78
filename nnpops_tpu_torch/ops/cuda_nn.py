"""The fused species-ensemble kernel (``csrc/fused_nn.cu``), its wrapper,
its autograd Function and its plain PyTorch version.

Port of ``nnpops_tpu/ops/pallas_nn.py`` (``make_fused_species_net``,
``species_energies_fused``, ``ensemble_energy_grouped_rows_fused``). Per
species: every model's MLP with bf16 matmul operands and f32 accumulation,
f32 biases and CELU(0.1) in f32 (activations are rounded to bf16 only as
matmul operands), the out=1 last layer as an f32 product with the
bf16-valued last weights, and the model mean. This is not
``batched_nn.apply_species_net``'s bf16 path, which rounds activations
before the CELU; the plain version here follows the kernel.

Scope as in the reference BatchedNN: inference and input gradients. Under
autograd the forward launches the fused energy+gradient kernel and saves
``dx1 = de/dx`` at unit cotangent; the backward is ``g * dx1``. Weights and
biases get no gradient.

Dispatch: a CPU tensor runs :func:`fused_species_net_plain`; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.utils.weak

from .. import _kernels
from .batched_nn import CELU_ALPHA, EnsembleParams, SpeciesNet

_BF16 = torch.bfloat16


def _bf16_values(t: torch.Tensor) -> torch.Tensor:
    """f32 tensor holding ``t`` rounded to bf16: a matmul of such operands in
    f32 is a bf16 matmul with f32 accumulation (the products are exact)."""
    return t.to(_BF16).float()


def fused_species_net_plain(x: torch.Tensor, net: SpeciesNet,
                            with_grad: bool = False,
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel: ``x [n, in] -> (e [n, 1],
    dx [n, in] or None)``, model-mean energies and, with ``with_grad``, their
    input gradient at unit cotangent, in the kernel's working types."""
    n_layers = len(net.weights)
    num_models = net.weights[0].shape[0]
    x16 = _bf16_values(x.float())
    acc = 0.0
    bias_sum = 0.0
    dx = None
    for mi in range(num_models):
        h = x16
        derivs = []
        for l in range(n_layers - 1):
            w = _bf16_values(net.weights[l][mi])                 # [out, in]
            z = _bf16_values(h) @ w.T + net.biases[l][mi].float()
            e_z = torch.exp(z / CELU_ALPHA)
            h = torch.where(z > 0, z, CELU_ALPHA * (e_z - 1.0))
            derivs.append(torch.where(z > 0, 1.0, e_z))
        w_last = _bf16_values(net.weights[n_layers - 1][mi])   # [1, d]
        acc = acc + h * w_last
        bias_sum = bias_sum + net.biases[n_layers - 1][mi].float()
        if with_grad:
            d = w_last.expand_as(h)
            for l in range(n_layers - 2, -1, -1):
                d = d * derivs[l]
                d = _bf16_values(d) @ _bf16_values(net.weights[l][mi])
            dx = d if dx is None else dx + d
    e = (torch.sum(acc, 1, keepdim=True) + bias_sum) * (1.0 / num_models)
    if with_grad:
        dx = dx * (1.0 / num_models)
    return e, dx


def _pad16(d: int) -> int:
    return -(-d // 16) * 16


class PackedNet(NamedTuple):
    """One species' ensemble in the kernel's buffers (see fused_nn.cu)."""
    wbuf: torch.Tensor        # bf16, flat
    fbuf: torch.Tensor        # f32, flat
    dims: Tuple[int, ...]     # padded widths, last = 1
    in_actual: int
    num_models: int


# Packed buffers per net, keyed weakly by the net's first weight tensor, so
# an entry lives only as long as the net's weights do.
_PACKED = torch.utils.weak.WeakIdKeyDictionary()


def pack_species_net(net: SpeciesNet) -> PackedNet:
    """bf16 weights (and their transposes, for the backward matmuls) and f32
    biases, every width zero-padded to a multiple of 16. Padded units have
    z = 0, so they contribute exact zeros forward and backward.

    Packed once per net and reused while every tensor of the net is the
    same object at the same version: an in-place update of a weight or
    bias (``copy_``, ``load_state_dict``) packs it anew."""
    tensors = net.weights + net.biases
    stamp = tuple((id(t), t._version) for t in tensors)
    hit = _PACKED.get(net.weights[0])
    if hit is not None and hit[0] == stamp:
        return hit[1]
    packed = _pack(net)
    _PACKED[net.weights[0]] = (stamp, packed)
    return packed


@torch.no_grad()
def _pack(net: SpeciesNet) -> PackedNet:
    ws, bs = net.weights, net.biases
    n_layers = len(ws)
    m = ws[0].shape[0]
    dims = [ws[0].shape[2]] + [w.shape[1] for w in ws]
    if dims[-1] != 1:
        raise ValueError('the last layer must have one output')
    pd = [_pad16(d) for d in dims[:-1]] + [1]
    dev = ws[0].device
    wparts, fparts = [], []
    for l in range(n_layers - 1):
        w = torch.zeros(m, pd[l + 1], pd[l], dtype=_BF16, device=dev)
        w[:, :dims[l + 1], :dims[l]] = ws[l].to(_BF16)
        wparts += [w.reshape(-1), w.transpose(1, 2).reshape(-1)]
        b = torch.zeros(m, pd[l + 1], dtype=torch.float32, device=dev)
        b[:, :dims[l + 1]] = bs[l].float()
        fparts.append(b.reshape(-1))
    w_last = torch.zeros(m, pd[n_layers - 1], dtype=torch.float32, device=dev)
    w_last[:, :dims[n_layers - 1]] = _bf16_values(ws[n_layers - 1][:, 0, :])
    fparts += [w_last.reshape(-1), bs[n_layers - 1][:, 0].float()]
    return PackedNet(torch.cat(wparts).contiguous(),
                     torch.cat(fparts).contiguous(), tuple(pd),
                     int(dims[0]), int(m))


def launch_packed(x: torch.Tensor, packed: PackedNet, with_grad: bool,
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the fwd (or, ``with_grad``, the fwdgrad) kernel on packed
    weights: ``(e [n, 1], dx [n, in] or None)``."""
    name = 'fused_nn_fwdgrad' if with_grad else 'fused_nn_fwd'
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != packed.in_actual:
        raise ValueError(f'x must be float32 [n, {packed.in_actual}], got '
                         f'{x.dtype} {tuple(x.shape)}')
    _kernels.require_cuda(x, packed.wbuf, packed.fbuf)
    n = x.shape[0]
    e = torch.empty(n, 1, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x) if with_grad else None
    if n:
        dims = (ctypes.c_int * len(packed.dims))(*packed.dims)
        _kernels.launch(
            name, x.data_ptr(), packed.wbuf.data_ptr(), packed.fbuf.data_ptr(),
            e.data_ptr(), dx.data_ptr() if with_grad else None, n,
            packed.in_actual, len(packed.dims) - 1, dims, packed.num_models,
            _kernels.stream_handle(x.device))
    return e, dx


def fused_species_net_fwd(x: torch.Tensor, net: SpeciesNet) -> torch.Tensor:
    """Per-atom model-mean energies ``[n, 1]`` (forward kernel)."""
    if x.device.type == 'cpu':
        return fused_species_net_plain(x, net)[0]
    if x.device.type != 'cuda':
        raise ValueError(f'no fused-NN kernel for device {x.device}')
    return launch_packed(x.contiguous(), pack_species_net(net), False)[0]


def fused_species_net_fwdgrad(x: torch.Tensor, net: SpeciesNet,
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Energies ``[n, 1]`` and ``de/dx`` at unit cotangent (fwdgrad kernel)."""
    if x.device.type == 'cpu':
        return fused_species_net_plain(x, net, with_grad=True)
    if x.device.type != 'cuda':
        raise ValueError(f'no fused-NN kernel for device {x.device}')
    return launch_packed(x.contiguous(), pack_species_net(net), True)


class FusedSpeciesNetFunction(torch.autograd.Function):
    """Energy and gradient in one pass, ``fwdgrad(x, net) -> (e, dx1)``;
    the backward is ``g * dx1``."""

    @staticmethod
    def forward(ctx, x, net, fwdgrad):
        e, dx1 = fwdgrad(x, net)
        ctx.save_for_backward(dx1)
        return e

    @staticmethod
    def backward(ctx, g):
        (dx1,) = ctx.saved_tensors
        return g * dx1, None, None


def _plain_fwdgrad(x: torch.Tensor, net: SpeciesNet):
    return fused_species_net_plain(x, net, with_grad=True)


def species_energies_fused(net: SpeciesNet, x: torch.Tensor) -> torch.Tensor:
    """``[n, aev] -> [n, 1]`` per-atom model-mean energies for one species,
    differentiable in ``x`` only. Under autograd this is one fwdgrad launch."""
    if torch.is_grad_enabled() and x.requires_grad:
        return FusedSpeciesNetFunction.apply(x, net, fused_species_net_fwdgrad)
    return fused_species_net_fwd(x, net)


def species_energies_fused_plain(net: SpeciesNet,
                                 x: torch.Tensor) -> torch.Tensor:
    """:func:`species_energies_fused` through the plain version on any
    device, with the same gradient: the reference the kernel is held
    against on the card."""
    if torch.is_grad_enabled() and x.requires_grad:
        return FusedSpeciesNetFunction.apply(x, net, _plain_fwdgrad)
    return fused_species_net_plain(x, net)[0]


def _grouped_total(species_energies, params: EnsembleParams,
                   aev: torch.Tensor, counts: Sequence[int]) -> torch.Tensor:
    total = aev.new_zeros(())
    start = 0
    for s, count in enumerate(counts):
        if count == 0:
            continue
        e = species_energies(params.networks[s], aev[start:start + count])
        total = total + torch.sum(e)
        start += count
    return total


def ensemble_energy_grouped_rows_fused(params: EnsembleParams,
                                       aev: torch.Tensor,
                                       counts: Sequence[int]) -> torch.Tensor:
    """Total NN energy from species-grouped AEV rows (``counts[s]``
    contiguous rows per species, ascending species) through the fused net."""
    return _grouped_total(species_energies_fused, params, aev, counts)


def ensemble_energy_grouped_rows_fused_plain(params: EnsembleParams,
                                             aev: torch.Tensor,
                                             counts: Sequence[int],
                                             ) -> torch.Tensor:
    """:func:`ensemble_energy_grouped_rows_fused` through the plain version
    on any device (the reference; see :func:`species_energies_fused_plain`)."""
    return _grouped_total(species_energies_fused_plain, params, aev, counts)
