"""The window radial AEV kernel (``csrc/window_radial.cu``), forward and
backward, its wrapper, its autograd Function and its plain PyTorch version.

Port of ``nnpops_tpu/ops/pallas_window.py`` ``make_window_radial_kernel``
(``window_radial_aev``). Per cell, the cell's center slots are paired with
its dense 27-cell candidate window:

* ``candx/candy/candz`` ``[ncells, kk]``: candidate coordinate planes in
  species-major window order (present species s owns the lanes
  ``[27*sum(cell_caps[:s]), 27*sum(cell_caps[:s+1]))``, stencil-entry-major
  inside its block), periodic image shifts applied, empty slots at FAR;
* ``centers`` ``[ncells, c_ctr, 3]``: the cell's own slots
  (``c_ctr = sum(center_caps)``, ``center_caps = cell_caps`` unless cells
  are bucketed);
* output ``[ncells, c_ctr, P*R]``, column ``p*R + q`` = radial function q
  against present species p, scaled by 0.25 in torchani mode.

A pair is valid when ``d2 < rc^2`` and the lane is not the center's own
(the static self lane ``row + shift_s``, taken from the full ``cell_caps``
geometry also for packed centers). ``fc`` is the degree-8 polynomial in
``t = min(d2/rc^2, 1)``; the Gaussians use ``r`` clamped to ``rc`` (the
Pallas kernel's ladder of exps agrees with direct exps to 3e-9, and the
ladder is a TPU means of saving exps).

One contract the port adds: a center at or beyond ``EMPTY_ROW`` (FAR/2)
is an empty slot, and its output row is 0 with no pair evaluated. The
Pallas kernel pairs empty centers with empty candidates (FAR against FAR,
d2 = 0) and writes rows that no caller reads; their cotangents are 0 in
both, and every such pair has a zero delta, so no cotangent of a real slot
changes.

The kernel walks the window in runs (:func:`window_runs`): run ``27*s +
e`` is present species s's lanes of stencil entry e, ``cell_caps[s]``
contiguous lanes. It cuts each run at its last occupied lane (x <
``EMPTY_ROW``; the selection fills a cell's slots by rank, so the occupied
lanes lead the run) and skips, per center row, every run whose box of
occupied positions lies beyond the cutoff.

Dispatch: a CPU tensor runs :func:`window_radial_plain` (gradients by
autograd); a CUDA tensor launches the forward kernel, and the backward
kernel under autograd, or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _kernels
from .cuda_aev import fc_poly_t

# Empty-slot position sentinel: d2 > cutoff^2 against any real position,
# squares still finite in f32.
FAR = 1.0e6
# Centers at or beyond this coordinate are empty slots (see module doc).
EMPTY_ROW = 0.5 * FAR
# Stencil entry of the cell itself in the (-1, 0, 1)^3 meshgrid order.
SELF_STENCIL_INDEX = 13
MAX_SPECIES = 8     # csrc/window_radial.cu limits
MAX_RADIAL = 32
STENCIL_ENTRIES = 27


class WindowGeometry:
    """Static lane geometry of one (cell_caps, center_caps) configuration."""

    def __init__(self, cell_caps: Tuple[int, ...],
                 center_caps: Optional[Tuple[int, ...]]):
        self.cell_caps = tuple(int(x) for x in cell_caps)
        self.center_caps = (self.cell_caps if center_caps is None
                            else tuple(int(x) for x in center_caps))
        npres = len(self.cell_caps)
        if len(self.center_caps) != npres or any(
                a > b for a, b in zip(self.center_caps, self.cell_caps)):
            raise ValueError('center_caps must align with and not exceed '
                             'cell_caps')
        self.npres = npres
        self.c = sum(self.cell_caps)
        self.kk = 27 * self.c
        self.c_ctr = sum(self.center_caps)
        offs = np.cumsum((0,) + self.cell_caps)[:-1]
        self.ctr_offs = tuple(int(x) for x in
                              np.cumsum((0,) + self.center_caps)[:-1])
        self.bounds = tuple((int(27 * o), int(27 * (o + cs)))
                            for o, cs in zip(offs, self.cell_caps))
        self.self_shift = tuple(
            int(27 * offs[s] + SELF_STENCIL_INDEX * self.cell_caps[s]
                - self.ctr_offs[s]) for s in range(npres))
        row_sp = np.zeros(self.c_ctr, np.int64)
        for s in range(1, npres):
            row_sp[self.ctr_offs[s]:] = s
        self.self_lane = (np.arange(self.c_ctr)
                          + np.asarray(self.self_shift)[row_sp]).astype(np.int64)


def window_runs(geo: WindowGeometry) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's run table: (first lane, lanes) of run ``27*s + e``,
    present species s's lanes of stencil entry e (``cell_caps[s]`` lanes
    from ``bounds[s][0] + e*cell_caps[s]``). The runs tile ``[0, kk)`` in
    order, so each species block is the contiguous runs of its species."""
    first, length = [], []
    for (lo, _), cs in zip(geo.bounds, geo.cell_caps):
        for e in range(STENCIL_ENTRIES):
            first.append(lo + e * cs)
            length.append(cs)
    return np.asarray(first, np.int64), np.asarray(length, np.int64)


@functools.lru_cache(maxsize=32)
def _geometry(cell_caps, center_caps) -> WindowGeometry:
    return WindowGeometry(cell_caps, center_caps)


def _radial_params(radial_eta, radial_rs):
    rs = tuple(float(x) for x in radial_rs)
    etas = tuple(float(x) for x in radial_eta)
    if len(etas) != len(rs):
        raise ValueError('radial_eta and radial_rs must have one entry per '
                         'radial function')
    return etas, rs


def window_radial_plain(candx: torch.Tensor, candy: torch.Tensor,
                        candz: torch.Tensor, centers: torch.Tensor,
                        radial_cutoff: float, radial_eta: Sequence[float],
                        radial_rs: Sequence[float],
                        cell_caps: Tuple[int, ...], torchani: bool,
                        center_caps: Optional[Tuple[int, ...]] = None,
                        ) -> torch.Tensor:
    """Plain version of the kernel, differentiable by autograd."""
    geo = _geometry(tuple(cell_caps), None if center_caps is None
                    else tuple(center_caps))
    etas, rs = _radial_params(radial_eta, radial_rs)
    rc = float(radial_cutoff)
    scale = 0.25 if torchani else 1.0
    dev = candx.device
    dx = candx[:, None, :] - centers[:, :, 0:1]              # [G, c, kk]
    dy = candy[:, None, :] - centers[:, :, 1:2]
    dz = candz[:, None, :] - centers[:, :, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    lane = torch.arange(geo.kk, device=dev)
    self_lane = torch.as_tensor(geo.self_lane, device=dev)
    valid = ((d2 < rc * rc) & (lane[None, :] != self_lane[:, None])[None]
             & (centers[:, :, 0:1] < EMPTY_ROW))
    r = torch.sqrt(torch.clamp(d2, min=1e-12))
    t = torch.clamp(d2 * (1.0 / (rc * rc)), max=1.0)
    fc = torch.where(valid, fc_poly_t(t), 0.0)
    rm = torch.clamp(r, max=rc)
    cols = [None] * (geo.npres * len(rs))
    for s, (b0, b1) in enumerate(geo.bounds):
        fcs, rms = fc[:, :, b0:b1], rm[:, :, b0:b1]
        for q, (eta, r0) in enumerate(zip(etas, rs)):
            cols[s * len(rs) + q] = scale * torch.sum(
                fcs * torch.exp(-eta * (rms - r0) ** 2), 2)
    return torch.stack(cols, 2)


class _WindowSpec:
    """Host constants of one kernel configuration, as ctypes arrays. The
    lane geometry is :class:`WindowGeometry`'s, so the kernel and the plain
    version exclude the same self lanes; the kernel only checks it."""

    def __init__(self, geo: WindowGeometry, radial_cutoff, radial_eta,
                 radial_rs, torchani):
        etas, rs = _radial_params(radial_eta, radial_rs)
        if geo.npres > MAX_SPECIES or len(rs) > MAX_RADIAL:
            raise NotImplementedError(
                f'window radial kernel takes <= {MAX_SPECIES} species and '
                f'<= {MAX_RADIAL} radial functions')
        self.geo = geo
        self.out_w = geo.npres * len(rs)
        ints = ctypes.c_int * (MAX_SPECIES + 1)
        floats = ctypes.c_float * MAX_RADIAL
        run_first, run_len = window_runs(geo)
        self.run_first = (ctypes.c_int * len(run_first))(*run_first.tolist())
        self.run_len = (ctypes.c_int * len(run_len))(*run_len.tolist())
        self.ctr_off = ints(*geo.ctr_offs, geo.c_ctr)
        self.self_shift = ints(*geo.self_shift)
        self.eta = floats(*etas)
        self.rs = floats(*rs)
        self.n_r = len(rs)
        self.rc = float(radial_cutoff)
        self.scale = 0.25 if torchani else 1.0

    def scalars(self, ncells: int, stream: int):
        return (ncells, self.geo.npres, self.geo.kk, self.run_first,
                self.run_len, self.ctr_off, self.self_shift, self.n_r,
                self.eta, self.rs, self.rc, self.scale, stream)


@functools.lru_cache(maxsize=32)
def _spec(cell_caps, center_caps, radial_cutoff, radial_eta, radial_rs,
          torchani) -> _WindowSpec:
    return _WindowSpec(_geometry(cell_caps, center_caps), radial_cutoff,
                       radial_eta, radial_rs, torchani)


def _check_inputs(spec: _WindowSpec, candx, candy, candz, centers) -> int:
    ncells = candx.shape[0]
    geo = spec.geo
    for name, t in (('candx', candx), ('candy', candy), ('candz', candz)):
        if t.dtype != torch.float32 or tuple(t.shape) != (ncells, geo.kk):
            raise ValueError(f'{name} must be float32 [ncells, {geo.kk}], got '
                             f'{t.dtype} {tuple(t.shape)}')
    if (centers.dtype != torch.float32
            or tuple(centers.shape) != (ncells, geo.c_ctr, 3)):
        raise ValueError(f'centers must be float32 [ncells, {geo.c_ctr}, 3], '
                         f'got {centers.dtype} {tuple(centers.shape)}')
    _kernels.require_cuda(candx, candy, candz, centers)
    return ncells


def window_radial_fwd_cuda(candx, candy, candz, centers,
                           spec: _WindowSpec) -> torch.Tensor:
    """Launch the forward kernel: ``[ncells, c_ctr, P*R]``."""
    ncells = _check_inputs(spec, candx, candy, candz, centers)
    out = torch.empty(ncells, spec.geo.c_ctr, spec.out_w, dtype=torch.float32,
                      device=candx.device)
    if ncells:
        _kernels.launch('window_radial_fwd', candx.data_ptr(),
                        candy.data_ptr(), candz.data_ptr(), centers.data_ptr(),
                        out.data_ptr(),
                        *spec.scalars(ncells, _kernels.stream_handle(candx.device)))
    return out


def window_radial_bwd_cuda(candx, candy, candz, centers, g,
                           spec: _WindowSpec):
    """Launch the backward kernel: cotangents of the three candidate planes
    ``[ncells, kk]`` and of the centers ``[ncells, c_ctr, 3]``."""
    ncells = _check_inputs(spec, candx, candy, candz, centers)
    if g.dtype != torch.float32 or tuple(g.shape) != (ncells, spec.geo.c_ctr,
                                                      spec.out_w):
        raise ValueError(f'cotangent must be float32 [ncells, '
                         f'{spec.geo.c_ctr}, {spec.out_w}]')
    _kernels.require_cuda(g)
    # The kernel writes every lane of the three planes once.
    dcand = torch.empty(3, ncells, spec.geo.kk, dtype=torch.float32,
                        device=candx.device)
    dctr = torch.empty_like(centers)
    if ncells:
        _kernels.launch('window_radial_bwd', candx.data_ptr(),
                        candy.data_ptr(), candz.data_ptr(), centers.data_ptr(),
                        g.data_ptr(), dcand.data_ptr(), dctr.data_ptr(),
                        *spec.scalars(ncells, _kernels.stream_handle(candx.device)))
    return dcand[0], dcand[1], dcand[2], dctr


class WindowRadialFunction(torch.autograd.Function):
    """Kernel forward; recompute-based kernel backward (only the inputs are
    saved, as in the Pallas VJP)."""

    @staticmethod
    def forward(ctx, candx, candy, candz, centers, spec):
        ctx.save_for_backward(candx, candy, candz, centers)
        ctx.spec = spec
        return window_radial_fwd_cuda(candx, candy, candz, centers, spec)

    @staticmethod
    def backward(ctx, g):
        candx, candy, candz, centers = ctx.saved_tensors
        dcx, dcy, dcz, dctr = window_radial_bwd_cuda(
            candx, candy, candz, centers, g.contiguous(), ctx.spec)
        return dcx, dcy, dcz, dctr, None


def window_radial(candx: torch.Tensor, candy: torch.Tensor,
                  candz: torch.Tensor, centers: torch.Tensor,
                  radial_cutoff: float, radial_eta: Sequence[float],
                  radial_rs: Sequence[float], cell_caps: Tuple[int, ...],
                  torchani: bool,
                  center_caps: Optional[Tuple[int, ...]] = None,
                  ) -> torch.Tensor:
    """``[ncells, c_ctr, P*R]`` radial AEV in (packed) slot space (the
    counterpart of ``window_radial_aev``): the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if candx.device.type == 'cpu':
        return window_radial_plain(candx, candy, candz, centers,
                                   radial_cutoff, radial_eta, radial_rs,
                                   cell_caps, torchani, center_caps)
    if candx.device.type != 'cuda':
        raise ValueError(f'no window radial kernel for device {candx.device}')
    spec = _spec(tuple(int(x) for x in cell_caps),
                 None if center_caps is None else tuple(int(x) for x in center_caps),
                 float(radial_cutoff), tuple(float(x) for x in radial_eta),
                 tuple(float(x) for x in radial_rs), bool(torchani))
    return WindowRadialFunction.apply(candx.contiguous(), candy.contiguous(),
                                      candz.contiguous(), centers.contiguous(),
                                      spec)
