"""The cluster-pair radial AEV kernel (``csrc/cluster_radial.cu``), forward
and backward, its wrapper, its autograd Function and its plain PyTorch
version.

Port of ``nnpops_tpu/ops/pallas_cluster.py`` ``make_cluster_radial_kernel``
(``cluster_radial_aev``), for the i-clusters of one species:

* ``jx/jy/jz`` ``[ncl, lanes]``: each i-cluster's gathered j-cluster atoms
  (image shifts applied, empty slots at FAR), j-species-major: species
  block s owns the lanes ``[cl * sum(lane_caps[:s]), cl *
  sum(lane_caps[:s+1]))``, j-cluster-major inside it;
* ``centers`` ``[ncl, cl, 3]``: the i-clusters' own atoms;
* output ``[ncl, cl, P*R]``, column ``p*R + q`` = radial function q against
  present species p, scaled by 0.25 in torchani mode.

The i-cluster itself is the first j-cluster of its own species' block
(``self_block``), so the self pair of row r is the static lane
``cl * sum(lane_caps[:self_block]) + r``. A pair is valid when ``d2 < rc^2``
and is not that lane; ``fc`` is the cosine cutoff (the window radial kernel
uses a polynomial, so the two paths agree to the cutoff's difference, not
bit for bit).

One contract the port adds, as ``ops.cuda_window`` does: a center at or
beyond ``EMPTY_ROW`` (a padding slot of a cluster) evaluates no pair and
its row is 0. The Pallas kernel pairs such centers with the padding lanes
of their own cluster and writes rows no caller reads; every other row and
every cotangent agree.

Dispatch: a CPU tensor runs :func:`cluster_radial_plain` (gradients by
autograd); a CUDA tensor launches the forward kernel, and the backward
kernel under autograd, or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import _kernels
from .cuda_window import EMPTY_ROW, _radial_params

MAX_CLUSTER = 8     # csrc/cluster_radial.cu limits
MAX_SPECIES = 8
MAX_RADIAL = 32


class ClusterGeometry:
    """Static lane geometry of one (cl, lane_caps, self_block)."""

    def __init__(self, cl: int, lane_caps: Tuple[int, ...], self_block: int):
        self.cl = int(cl)
        self.lane_caps = tuple(int(x) for x in lane_caps)
        self.npres = len(self.lane_caps)
        offs = np.cumsum((0,) + tuple(c * self.cl for c in self.lane_caps))
        self.lanes = int(offs[-1])
        self.bounds = tuple((int(offs[j]), int(offs[j + 1]))
                            for j in range(self.npres))
        if not 0 <= int(self_block) < self.npres:
            raise ValueError('self_block must index lane_caps')
        self.self_off = int(offs[int(self_block)])


@functools.lru_cache(maxsize=32)
def _geometry(cl, lane_caps, self_block) -> ClusterGeometry:
    return ClusterGeometry(cl, lane_caps, self_block)


def cluster_radial_plain(jx: torch.Tensor, jy: torch.Tensor, jz: torch.Tensor,
                         centers: torch.Tensor, radial_cutoff: float,
                         radial_eta: Sequence[float],
                         radial_rs: Sequence[float], cl: int,
                         lane_caps: Tuple[int, ...], self_block: int,
                         torchani: bool) -> torch.Tensor:
    """Plain version of the kernel, differentiable by autograd."""
    geo = _geometry(int(cl), tuple(int(x) for x in lane_caps), int(self_block))
    etas, rs = _radial_params(radial_eta, radial_rs)
    rc = float(radial_cutoff)
    scale = 0.25 if torchani else 1.0
    dx = jx[:, None, :] - centers[:, :, 0:1]                  # [ncl, cl, lanes]
    dy = jy[:, None, :] - centers[:, :, 1:2]
    dz = jz[:, None, :] - centers[:, :, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    lane = torch.arange(geo.lanes, device=jx.device)
    row = torch.arange(geo.cl, device=jx.device)
    valid = ((d2 < rc * rc) & (lane[None, :] != row[:, None] + geo.self_off)
             & (centers[:, :, 0:1] < EMPTY_ROW))
    r = torch.sqrt(torch.clamp(d2, min=1e-12))
    fc = torch.where(valid, 0.5 * torch.cos((math.pi / rc) * r) + 0.5, 0.0)
    rm = torch.clamp(r, max=rc)
    cols = [None] * (geo.npres * len(rs))
    for s, (b0, b1) in enumerate(geo.bounds):
        fcs, rms = fc[:, :, b0:b1], rm[:, :, b0:b1]
        for q, (eta, r0) in enumerate(zip(etas, rs)):
            cols[s * len(rs) + q] = scale * torch.sum(
                fcs * torch.exp(-eta * (rms - r0) ** 2), 2)
    return torch.stack(cols, 2)


class _ClusterSpec:
    """Host constants of one kernel configuration, as ctypes arrays (the
    geometry is :class:`ClusterGeometry`'s, which the plain version uses;
    the kernel checks it)."""

    def __init__(self, geo: ClusterGeometry, radial_cutoff, radial_eta,
                 radial_rs, torchani):
        etas, rs = _radial_params(radial_eta, radial_rs)
        if (geo.cl > MAX_CLUSTER or geo.npres > MAX_SPECIES
                or len(rs) > MAX_RADIAL):
            raise NotImplementedError(
                f'cluster radial kernel takes clusters of <= {MAX_CLUSTER} '
                f'atoms, <= {MAX_SPECIES} species and <= {MAX_RADIAL} radial '
                'functions')
        self.geo = geo
        self.n_r = len(rs)
        self.out_w = geo.npres * self.n_r
        ints = ctypes.c_int * MAX_SPECIES
        floats = ctypes.c_float * MAX_RADIAL
        self.lane_lo = ints(*(lo for lo, _ in geo.bounds))
        self.lane_hi = ints(*(hi for _, hi in geo.bounds))
        self.eta = floats(*etas)
        self.rs = floats(*rs)
        self.rc = float(radial_cutoff)
        self.scale = 0.25 if torchani else 1.0

    def scalars(self, ncl: int, stream: int):
        geo = self.geo
        return (ncl, geo.cl, geo.lanes, geo.npres, self.lane_lo, self.lane_hi,
                geo.self_off, self.n_r, self.eta, self.rs, self.rc,
                self.scale, stream)


@functools.lru_cache(maxsize=32)
def _spec(cl, lane_caps, self_block, radial_cutoff, radial_eta, radial_rs,
          torchani) -> _ClusterSpec:
    return _ClusterSpec(_geometry(cl, lane_caps, self_block), radial_cutoff,
                        radial_eta, radial_rs, torchani)


def _check_inputs(spec: _ClusterSpec, jx, jy, jz, centers) -> int:
    ncl = jx.shape[0]
    geo = spec.geo
    for name, t in (('jx', jx), ('jy', jy), ('jz', jz)):
        if t.dtype != torch.float32 or tuple(t.shape) != (ncl, geo.lanes):
            raise ValueError(f'{name} must be float32 [ncl, {geo.lanes}], got '
                             f'{t.dtype} {tuple(t.shape)}')
    if (centers.dtype != torch.float32
            or tuple(centers.shape) != (ncl, geo.cl, 3)):
        raise ValueError(f'centers must be float32 [ncl, {geo.cl}, 3], got '
                         f'{centers.dtype} {tuple(centers.shape)}')
    _kernels.require_cuda(jx, jy, jz, centers)
    return ncl


def cluster_radial_fwd_cuda(jx, jy, jz, centers,
                            spec: _ClusterSpec) -> torch.Tensor:
    """Launch the forward kernel: ``[ncl, cl, P*R]``."""
    ncl = _check_inputs(spec, jx, jy, jz, centers)
    out = torch.empty(ncl, spec.geo.cl, spec.out_w, dtype=torch.float32,
                      device=jx.device)
    if ncl:
        _kernels.launch('cluster_radial_fwd', jx.data_ptr(), jy.data_ptr(),
                        jz.data_ptr(), centers.data_ptr(), out.data_ptr(),
                        *spec.scalars(ncl, _kernels.stream_handle(jx.device)))
    return out


def cluster_radial_bwd_cuda(jx, jy, jz, centers, g, spec: _ClusterSpec):
    """Launch the backward kernel: cotangents of the three lane planes
    ``[ncl, lanes]`` and of the centers ``[ncl, cl, 3]``."""
    ncl = _check_inputs(spec, jx, jy, jz, centers)
    if g.dtype != torch.float32 or tuple(g.shape) != (ncl, spec.geo.cl,
                                                      spec.out_w):
        raise ValueError(f'cotangent must be float32 [ncl, {spec.geo.cl}, '
                         f'{spec.out_w}]')
    _kernels.require_cuda(g)
    dj = torch.empty(3, ncl, spec.geo.lanes, dtype=torch.float32,
                     device=jx.device)
    dctr = torch.empty_like(centers)
    if ncl:
        _kernels.launch('cluster_radial_bwd', jx.data_ptr(), jy.data_ptr(),
                        jz.data_ptr(), centers.data_ptr(), g.data_ptr(),
                        dj.data_ptr(), dctr.data_ptr(),
                        *spec.scalars(ncl, _kernels.stream_handle(jx.device)))
    return dj[0], dj[1], dj[2], dctr


class ClusterRadialFunction(torch.autograd.Function):
    """Kernel forward; recompute-based kernel backward (only the inputs are
    saved, as in the Pallas VJP)."""

    @staticmethod
    def forward(ctx, jx, jy, jz, centers, spec):
        ctx.save_for_backward(jx, jy, jz, centers)
        ctx.spec = spec
        return cluster_radial_fwd_cuda(jx, jy, jz, centers, spec)

    @staticmethod
    def backward(ctx, g):
        jx, jy, jz, centers = ctx.saved_tensors
        djx, djy, djz, dctr = cluster_radial_bwd_cuda(
            jx, jy, jz, centers, g.contiguous(), ctx.spec)
        return djx, djy, djz, dctr, None


def cluster_radial(jx: torch.Tensor, jy: torch.Tensor, jz: torch.Tensor,
                   centers: torch.Tensor, radial_cutoff: float,
                   radial_eta: Sequence[float], radial_rs: Sequence[float],
                   cl: int, lane_caps: Tuple[int, ...], self_block: int,
                   torchani: bool) -> torch.Tensor:
    """``[ncl, cl, P*R]`` radial AEV of one i-species' clusters (the
    counterpart of ``cluster_radial_aev``): the kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if jx.device.type == 'cpu':
        return cluster_radial_plain(jx, jy, jz, centers, radial_cutoff,
                                    radial_eta, radial_rs, cl, lane_caps,
                                    self_block, torchani)
    if jx.device.type != 'cuda':
        raise ValueError(f'no cluster radial kernel for device {jx.device}')
    spec = _spec(int(cl), tuple(int(x) for x in lane_caps), int(self_block),
                 float(radial_cutoff), tuple(float(x) for x in radial_eta),
                 tuple(float(x) for x in radial_rs), bool(torchani))
    return ClusterRadialFunction.apply(jx.contiguous(), jy.contiguous(),
                                       jz.contiguous(), centers.contiguous(),
                                       spec)
