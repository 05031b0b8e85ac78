"""The CFConv kernels (``csrc/cfconv_fwd.cu``, the fused forward, and
``csrc/cfconv_bwd.cu``, B.6, the backward), their wrappers and plain
PyTorch versions, and the payload conv's autograd Function (port of
``nnpops_tpu/ops/cfconv.py`` ``_make_payload_conv`` and of
``nnpops_tpu/ops/pallas_cfconv.py``).

The conv runs over an explicit neighbor triple: ``dist [N, K]`` (exact
zeros on masked lanes), ``mask [N, K]`` bool and ``idx [N, K]`` int32
(``N`` on masked lanes), inputs ``x [N, W]``, filter weights ``w1 [G, W]``,
``b1 [W]``, ``w2 [W, W]``, ``b2 [W]`` (the JAX ``[in, out]`` layout):

* forward: ``out[i] = sum_l y2[i, l] * x[idx[i, l]]`` with the filter
  ``y2 = (act(gauss(d) w1 + b1) w2 + b2) * fc(d)``. Its plain version
  (:func:`conv_fwd_plain`) is chunked over atom rows as the JAX
  ``_fwd_rows`` and gives the two filter products to ``torch.matmul`` in
  true f32, as JAX left them to XLA; the kernel computes the same in one
  float32 pass over each row's valid lanes, its products as FFMA;
* backward, recomputing the filter: the four weight gradients, the
  distance cotangent and the input-gradient rows by self-adjointness
  (``d_x[i] = sum_l y2[i, l] * g[idx[i, l]]``, exact when the directed
  list holds both directions of every pair). With ``weight_grads=False``
  (what ``PayloadConv`` asks for when no filter weight needs a gradient,
  as in MD, where only the positions do) the weight gradients are not
  computed and come back as ``None``; on the card that is the
  forces-only kernel (``cfconv_bwd_forces``), with no weight-gradient
  products and no partial-sum reduction.

Dispatch, both directions: a CPU tensor runs the plain version (the
backward's is the JAX ``_bwd_rows`` chunk algebra); a CUDA tensor launches
the kernel, once over all N rows whatever ``chunk_size``, or raises.
Validity is the mask (the JAX default XLA backward), not the Pallas
kernel's ``dist > 0``: the two differ only for coincident atoms. The JAX
package's ``bwd_impl`` selector and the Pallas constraints behind its
silent fallback (K a multiple of 128, rows of 16) are TPU matters: the
kernels take any K and row count.

``compute_dtype=torch.bfloat16`` rounds the filter products' operands to
bf16 with f32 accumulation (the JAX option) in the plain forward and the
plain backward; the forward kernel takes only ``None`` (true f32). The
backward kernel runs its six products on the tensor cores in three bf16
passes (``hi.hi + hi.lo + lo.hi`` of ``hi = bf16(a)``, ``lo = bf16(a -
hi)``, f32 accumulation), about 2^-16 relative per product where the
Pallas kernel computes in f32; ``dtype=SPLIT3`` makes the plain version
emulate that arithmetic (for tests). The forces-only kernel runs the
remaining four products the same way.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .. import _kernels
from ..config import CFConvConfig
from .aev_blocked import device_constant

Tensor = torch.Tensor

_LN2 = float(np.log(2.0))
MAX_GAUSSIANS = 64            # the kernels' limits (csrc/cfconv_*.cu)
WIDTHS = (32, 64, 128)


# ``dtype`` of the plain versions that emulates the kernel's products.
SPLIT3 = 'bf16x3'


def _split(a: Tensor):
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def _mm(a: Tensor, b: Tensor, dtype) -> Tensor:
    """``a @ b`` with f32 accumulation; ``dtype`` rounds the operands, and
    :data:`SPLIT3` takes the kernel's three bf16 passes."""
    if dtype is None:
        return a @ b
    if dtype == SPLIT3:
        (ah, al), (bh, bl) = _split(a), _split(b)
        return ah @ bh + ah @ bl + al @ bh
    return a.to(dtype).float() @ b.to(dtype).float()


def filter_fwd(params, d: Tensor, m: Tensor, config: CFConvConfig, dtype):
    """The filter pipeline on ``[B, K]`` rows: (u, gauss, h, act, y1, fc,
    y2)."""
    w1, b1, w2, b2 = params
    centers = device_constant(tuple(float(c) for c in
                                    config.gaussian_positions),
                              torch.float32, d.device)
    u = (d[..., None] - centers) / config.gaussian_width
    gauss = torch.exp(-0.5 * u * u)                           # [B, K, G]
    h = _mm(gauss, w1, dtype) + b1
    if config.activation == 'ssp':
        act = torch.nn.functional.softplus(h) - _LN2
    else:
        act = torch.tanh(h)
    y1 = _mm(act, w2, dtype) + b2                             # [B, K, W]
    pi_rc = math.pi / config.cutoff
    fc = torch.where(m, 0.5 * torch.cos(pi_rc * d) + 0.5, 0.0)
    return u, gauss, h, act, y1, fc, y1 * fc[..., None]


def _gather_rows(table: Tensor, i: Tensor) -> Tensor:
    """``table[i]`` for ``i [B, K]`` -> ``[B, K, W]`` (an ``index_select``)."""
    return table.index_select(0, i.reshape(-1)).reshape(*i.shape, -1)


def _pad_row(x: Tensor) -> Tensor:
    return torch.cat([x, x.new_zeros(1, *x.shape[1:])])


def _row_chunks(n: int, chunk_size: Optional[int]):
    """Row slices of at most ``chunk_size`` rows (one slice without)."""
    b = max(1, n if chunk_size is None or n <= chunk_size else int(chunk_size))
    return [slice(s, min(s + b, n)) for s in range(0, max(n, 1), b)]


def conv_fwd_plain(params, dist: Tensor, mask: Tensor, idx: Tensor,
                   x: Tensor, config: CFConvConfig,
                   chunk_size: Optional[int] = None, dtype=None) -> Tensor:
    """The conv's value, chunked over atom rows."""
    x_pad = _pad_row(x)
    out = []
    for s in _row_chunks(x.shape[0], chunk_size):
        y2 = filter_fwd(params, dist[s], mask[s], config, dtype)[-1]
        # The neighbor gather stays f32 (compute_dtype routes only the
        # filter products, as in the JAX package).
        out.append(torch.sum(y2 * _gather_rows(x_pad, idx[s]), 1))
    return torch.cat(out)


def _bwd_rows(params, d, m, i, x_pad, g_pad, gc, config, dtype,
              weight_grads=True):
    """One chunk of the backward (the JAX ``_bwd_rows``): (dW partials, or
    None without ``weight_grads``, d_dist rows, d_x rows)."""
    w1, b1, w2, b2 = params
    u, gauss, h, act, y1, fc, y2 = filter_fwd(params, d, m, config, dtype)
    bk = d.shape[0] * d.shape[1]
    w = y1.shape[-1]
    xg = _gather_rows(x_pad, i)                                 # [B, K, W]
    gg = _gather_rows(g_pad, i)
    d_x_rows = torch.sum(y2 * gg, 1)                            # [B, W]
    d_y2 = gc[:, None, :] * xg
    d_y1 = d_y2 * fc[..., None]
    d_fc = torch.sum(d_y2 * y1, -1)                             # [B, K]
    d2 = d_y1.reshape(bk, w)
    d_act = _mm(d2, w2.t(), dtype).reshape(h.shape)
    if config.activation == 'ssp':
        d_h = d_act * torch.sigmoid(h)
    else:
        d_h = d_act * (1.0 - act * act)
    dh2 = d_h.reshape(bk, w)
    d_gauss = _mm(dh2, w1.t(), dtype).reshape(gauss.shape)
    gw = config.gaussian_width
    pi_rc = math.pi / config.cutoff
    d_d = torch.sum(d_gauss * gauss * (-u / gw), -1)
    d_d = d_d + d_fc * torch.where(m, -0.5 * pi_rc * torch.sin(pi_rc * d),
                                   0.0)
    dw = None
    if weight_grads:
        dw = (_mm(gauss.reshape(bk, -1).t(), dh2, dtype), torch.sum(dh2, 0),
              _mm(act.reshape(bk, w).t(), d2, dtype), torch.sum(d2, 0))
    return dw, torch.where(m, d_d, 0.0), d_x_rows


def cfconv_bwd_plain(params, dist: Tensor, mask: Tensor, idx: Tensor,
                     x: Tensor, g: Tensor, config: CFConvConfig,
                     chunk_size: Optional[int] = None, dtype=None,
                     weight_grads: bool = True):
    """Plain version of the kernels: ``((dW1, db1, dW2, db2), d_dist,
    d_x)``, chunked over atom rows, weight gradients summed in chunk order;
    ``(None, d_dist, d_x)`` without ``weight_grads``."""
    x_pad, g_pad = _pad_row(x), _pad_row(g)
    dw, d_dist, d_x = None, [], []
    for s in _row_chunks(x.shape[0], chunk_size):
        pw, dd, dx = _bwd_rows(params, dist[s], mask[s], idx[s], x_pad,
                               g_pad, g[s], config, dtype, weight_grads)
        if weight_grads:
            dw = pw if dw is None else tuple(a + b for a, b in zip(dw, pw))
        d_dist.append(dd)
        d_x.append(dx)
    return dw, torch.cat(d_dist), torch.cat(d_x)


def check_kernel_config(config: CFConvConfig) -> None:
    """Raise unless the kernels take this width and Gaussian count."""
    if config.width not in WIDTHS or not 1 <= config.num_gaussians <= MAX_GAUSSIANS:
        raise ValueError(f'the CFConv kernels take width in {WIDTHS} and '
                         f'1..{MAX_GAUSSIANS} Gaussians, got width '
                         f'{config.width}, {config.num_gaussians} Gaussians')


def _check_inputs(params, dist, mask, idx, x, config, *rows) -> None:
    """Raise unless the kernels take these inputs (``rows``: more [N, W]
    f32 tensors beside ``x``), on the current CUDA device."""
    check_kernel_config(config)
    n, k = dist.shape
    wd, ng = config.width, config.num_gaussians
    shapes = ((dist, (n, k), torch.float32), (mask, (n, k), torch.bool),
              (idx, (n, k), torch.int32),
              *((t, (n, wd), torch.float32) for t in (x, *rows)),
              *zip(params, ((ng, wd), (wd,), (wd, wd), (wd,)),
                   (torch.float32,) * 4))
    for t, shape, dtype in shapes:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f'expected {dtype} {shape}, got {t.dtype} '
                             f'{tuple(t.shape)}')
    _kernels.require_cuda(*(t for t, _, _ in shapes))


def _aligned(t: Tensor) -> Tensor:
    """``t``, copied if it does not start on 16 bytes (the kernels gather
    its rows in 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _num_blocks(device, n: int) -> int:
    """One block per SM (fixed for a device, so the backward's
    weight-gradient sum order is too)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(n, sms))


def cfconv_fwd_cuda(params, dist: Tensor, mask: Tensor, idx: Tensor,
                    x: Tensor, config: CFConvConfig) -> Tensor:
    """Launch the fused forward kernel over all rows: ``out [N, W]``."""
    _check_inputs(params, dist, mask, idx, x, config)
    w1, b1, w2, b2 = params
    n, k = dist.shape
    x = _aligned(x)
    dev = dist.device
    centers = device_constant(tuple(float(c) for c in
                                    config.gaussian_positions),
                              torch.float32, dev)
    out = torch.empty_like(x)
    _kernels.launch(
        'cfconv_fwd', dist.data_ptr(), mask.data_ptr(), idx.data_ptr(),
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), centers.data_ptr(), out.data_ptr(), n, k,
        config.width, config.num_gaussians, _num_blocks(dev, n),
        int(config.activation == 'tanh'), 1.0 / config.gaussian_width,
        math.pi / config.cutoff, _kernels.stream_handle(dev))
    return out


def cfconv_fwd(params, dist: Tensor, mask: Tensor, idx: Tensor, x: Tensor,
               config: CFConvConfig, chunk_size: Optional[int] = None,
               dtype=None) -> Tensor:
    """The conv's value: the fused kernel on a CUDA tensor (one launch over
    all rows, true f32), :func:`conv_fwd_plain` on a CPU tensor."""
    if dist.device.type == 'cpu':
        return conv_fwd_plain(params, dist, mask, idx, x, config, chunk_size,
                              dtype)
    if dist.device.type != 'cuda':
        raise ValueError(f'no CFConv forward kernel for device {dist.device}')
    if dtype is not None:
        raise ValueError(f'the CFConv forward kernel computes in float32; '
                         f'got compute dtype {dtype}')
    return cfconv_fwd_cuda(tuple(p.contiguous() for p in params),
                           dist.contiguous(), mask.contiguous(),
                           idx.to(torch.int32).contiguous(), x.contiguous(),
                           config)


def cfconv_bwd_cuda(params, dist: Tensor, mask: Tensor, idx: Tensor,
                    x: Tensor, g: Tensor, config: CFConvConfig,
                    weight_grads: bool = True):
    """Launch the kernel (and its partial-sum reduction) over all rows:
    ``((dW1, db1, dW2, db2), d_dist, d_x)``; without ``weight_grads`` the
    forces-only kernel, one launch: ``(None, d_dist, d_x)``."""
    _check_inputs(params, dist, mask, idx, x, config, g)
    w1, b1, w2, b2 = params
    n, k = dist.shape
    wd, ng = config.width, config.num_gaussians
    x, g = _aligned(x), _aligned(g)
    dev = dist.device
    centers = device_constant(tuple(float(c) for c in
                                    config.gaussian_positions),
                              torch.float32, dev)
    nblocks = _num_blocks(dev, n)
    d_dist = torch.empty_like(dist)
    d_x = torch.empty_like(x)
    common = (n, k, wd, ng, nblocks, int(config.activation == 'tanh'),
              1.0 / config.gaussian_width, math.pi / config.cutoff,
              _kernels.stream_handle(dev))
    if not weight_grads:
        _kernels.launch(
            'cfconv_bwd_forces', dist.data_ptr(), mask.data_ptr(),
            idx.data_ptr(), x.data_ptr(), g.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), centers.data_ptr(),
            d_dist.data_ptr(), d_x.data_ptr(), *common)
        return None, d_dist, d_x
    size = ng * wd + wd + wd * wd + wd
    part = torch.empty(nblocks, size, dtype=torch.float32, device=dev)
    dw = torch.empty(size, dtype=torch.float32, device=dev)
    _kernels.launch(
        'cfconv_bwd', dist.data_ptr(), mask.data_ptr(), idx.data_ptr(),
        x.data_ptr(), g.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), centers.data_ptr(), d_dist.data_ptr(),
        d_x.data_ptr(), part.data_ptr(), dw.data_ptr(), *common)
    o1, o2 = ng * wd, ng * wd + wd
    o3 = o2 + wd * wd
    return ((dw[:o1].reshape(ng, wd), dw[o1:o2], dw[o2:o3].reshape(wd, wd),
             dw[o3:]), d_dist, d_x)


def cfconv_bwd(params, dist: Tensor, mask: Tensor, idx: Tensor, x: Tensor,
               g: Tensor, config: CFConvConfig,
               chunk_size: Optional[int] = None, dtype=None,
               weight_grads: bool = True):
    """The conv's backward: the kernel on a CUDA tensor (one launch over
    all rows, three bf16 passes a product; the forces-only kernel without
    ``weight_grads``), :func:`cfconv_bwd_plain` on a CPU tensor."""
    if dist.device.type == 'cpu':
        return cfconv_bwd_plain(params, dist, mask, idx, x, g, config,
                                chunk_size, dtype, weight_grads)
    if dist.device.type != 'cuda':
        raise ValueError(f'no CFConv backward kernel for device {dist.device}')
    return cfconv_bwd_cuda(tuple(p.contiguous() for p in params),
                           dist.contiguous(), mask.contiguous(),
                           idx.to(torch.int32).contiguous(), x.contiguous(),
                           g.contiguous(), config, weight_grads)


class PayloadConv(torch.autograd.Function):
    """The payload conv: forward through :func:`cfconv_fwd`, recompute-based
    backward through :func:`cfconv_bwd` (only the inputs are saved); with
    ``plain``, both directions' plain versions. Returns cotangents for
    w1/b1/w2/b2 (``None`` when none of them needs a gradient: the
    backward then computes none), the distances and the inputs. First
    order."""

    @staticmethod
    def forward(ctx, w1, b1, w2, b2, dist, mask, idx, x, config, chunk_size,
                dtype, plain):
        params = (w1, b1, w2, b2)
        ctx.save_for_backward(w1, b1, w2, b2, dist, mask, idx, x)
        ctx.spec = (config, chunk_size, dtype)
        ctx.plain = plain
        fwd = conv_fwd_plain if plain else cfconv_fwd
        return fwd(params, dist, mask, idx, x, config, chunk_size, dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        w1, b1, w2, b2, dist, mask, idx, x = ctx.saved_tensors
        bwd = cfconv_bwd_plain if ctx.plain else cfconv_bwd
        weight_grads = any(ctx.needs_input_grad[:4])
        dw, d_dist, d_x = bwd((w1, b1, w2, b2), dist, mask, idx, x,
                              g.contiguous(), *ctx.spec,
                              weight_grads=weight_grads)
        if dw is None:
            dw = (None,) * 4
        return (*dw, d_dist, None, None, d_x, None, None, None, None)


def payload_conv(params, dist: Tensor, mask: Tensor, idx: Tensor, x: Tensor,
                 config: CFConvConfig, chunk_size: Optional[int] = None,
                 dtype=None, plain: bool = False) -> Tensor:
    """The payload conv through the kernels (see the module doc); ``params``
    is ``(w1, b1, w2, b2)``. ``plain`` runs both directions' plain versions
    on any device (the reference a run through the kernels is held against
    on the card)."""
    w1, b1, w2, b2 = params
    return PayloadConv.apply(w1, b1, w2, b2, dist, mask, idx, x, config,
                             chunk_size, dtype, plain)
