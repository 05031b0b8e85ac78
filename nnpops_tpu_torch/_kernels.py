"""Build, load and count the package's CUDA kernels.

The kernels live in ``csrc/*.cu`` as plain ``extern "C"`` entry points. On
the first CUDA call, :func:`library` compiles them with ``nvcc`` for
``sm_90a`` (one ``nvcc -c`` per source, all started together, then one
link) into one shared library under ``_build/`` (named by a hash of the
sources and flags, so an edited source rebuilds) and loads it with
``ctypes``. Importing this module builds nothing and needs no ``nvcc``.

Every entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code. :data:`LAUNCHES` counts kernel
launches by name: a wrapper adds one exactly where it launches its kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).parent / 'csrc'
BUILD_DIR = Path(__file__).parent / '_build'
SOURCES = ('angular_aev.cu', 'cfconv_bwd.cu', 'cluster_radial.cu',
           'fused_nn.cu', 'left_pack.cu', 'pair_radial.cu', 'pme_window.cu',
           'window_mask.cu', 'window_radial.cu')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC')

LAUNCHES = {'angular_aev_fwd': 0, 'angular_aev_bwd': 0, 'cfconv_bwd': 0,
            'cluster_radial_fwd': 0, 'cluster_radial_bwd': 0,
            'fused_nn_fwd': 0, 'fused_nn_fwdgrad': 0,
            'left_pack': 0, 'left_pack_lanes': 0,
            'pair_radial_fwd': 0, 'pair_radial_bwd': 0,
            'pme_window_fwd': 0, 'pme_window_bwd': 0,
            'window_mask': 0, 'window_radial_fwd': 0, 'window_radial_bwd': 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_SIGNATURES = {
    # planes, mask, lane_pos, jj, kk, seg_bounds, out, n_rows, width, kat,
    # n_seg, n_rs, n_ts, rs, cos_ts, sin_ts (host arrays), ra, eta, zeta,
    # torchani, stream
    'angular_aev_fwd': (_P,) * 7 + (_I,) * 6 + (_P,) * 3
                       + (_D, _D, _D, _I, _P),
    # planes, mask, lane_pos, col_lane, jj, kk, seg_bounds, g, out, then as
    # the forward from n_rows on
    'angular_aev_bwd': (_P,) * 9 + (_I,) * 6 + (_P,) * 3
                       + (_D, _D, _D, _I, _P),
    # dist, mask, idx, x, g, w1, b1, w2, b2, centers, d_dist, d_x, part, dw,
    # n, k, width, g, nblocks, tanh, inv_gw, pi_rc, stream
    'cfconv_bwd': (_P,) * 14 + (_I,) * 6 + (_D, _D, _P),
    # jx, jy, jz, centers, out, ncl, cl, lanes, npres, lane_lo, lane_hi
    # (host arrays), self_off, n_r, eta, rs (host), rc, scale, stream
    'cluster_radial_fwd': (_P,) * 5 + (_I,) * 4 + (_P,) * 2 + (_I,) * 2
                          + (_P,) * 2 + (_D, _D, _P),
    # jx, jy, jz, centers, g, dj [3, ncl, lanes], dctr, then as the forward
    # from ncl on
    'cluster_radial_bwd': (_P,) * 7 + (_I,) * 4 + (_P,) * 2 + (_I,) * 2
                          + (_P,) * 2 + (_D, _D, _P),
    # x, wbuf, fbuf, e_out, dx_out, n, in_actual, n_layers, dims, models,
    # stream
    'fused_nn_fwd': (_P,) * 5 + (_I,) * 3 + (_P, _I, _P),
    'fused_nn_fwdgrad': (_P,) * 5 + (_I,) * 3 + (_P, _I, _P),
    # keys, packed, counts, n_rows, width, k_total, npres, widths, caps
    # (host arrays), stream
    'left_pack': (_P,) * 3 + (_I,) * 4 + (_P,) * 3,
    # mask (uint8), lanes, counts, then as left_pack from n_rows on
    'left_pack_lanes': (_P,) * 3 + (_I,) * 4 + (_P,) * 3,
    # ctr, z3, shift, out_a, out_b, nx, ny, nz, npres, row_off (host),
    # n_chunks, chunk_lo, chunk_hi, chunk_sp (host), n_r, eta, rs (host),
    # rc, scale, stream
    'pair_radial_fwd': (_P,) * 5 + (_I,) * 4 + (_P, _I) + (_P,) * 3
                       + (_I,) + (_P,) * 2 + (_D, _D, _P),
    # ctr, z3, shift, ga, gb, dctr, dz5 [5, ncells, 3, L], dsh, then as the
    # forward from nx on
    'pair_radial_bwd': (_P,) * 8 + (_I,) * 4 + (_P, _I) + (_P,) * 3
                       + (_I,) + (_P,) * 2 + (_D, _D, _P),
    # candx, candy, candz, candq, centers, excl, out, ncells, nx, ny, nz, c,
    # ne, cutoff, alpha, coulomb, stream
    'pme_window_fwd': (_P,) * 7 + (_I,) * 6 + (_D,) * 3 + (_P,),
    # candx, candy, candz, candq, centers, excl, g, dcand [4, ncells, kk],
    # dctr, then as the forward from ncells on
    'pme_window_bwd': (_P,) * 9 + (_I,) * 6 + (_D,) * 3 + (_P,),
    # candx, candy, candz, centers, mask (uint8), ncells, npres, cell_caps
    # (host), w2, stream
    'window_mask': (_P,) * 5 + (_I,) * 2 + (_P, _D, _P),
    # candx, candy, candz, centers, out, ncells, npres, kk, lane_lo,
    # lane_hi, ctr_off, self_shift (host), n_r, eta, rs (host), rc, scale,
    # stream
    'window_radial_fwd': (_P,) * 5 + (_I,) * 3 + (_P,) * 4
                         + (_I, _P, _P, _D, _D, _P),
    # candx, candy, candz, centers, g, dcand [3, ncells, kk] (zeroed),
    # dctr, then as the forward from ncells on
    'window_radial_bwd': (_P,) * 7 + (_I,) * 3 + (_P,) * 4
                         + (_I, _P, _P, _D, _D, _P),
}

_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    default = Path('/usr/local/cuda/bin/nvcc')
    if default.exists():
        return str(default)
    raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                       'toolkit (nvcc on PATH or under /usr/local/cuda)')


def library_path() -> Path:
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f'libnnpops_kernels_{digest.hexdigest()[:16]}.so'


def _run(procs) -> None:
    """Wait for every (cmd, Popen); raise naming each failed command."""
    errors = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f'{" ".join(cmd)}\n{out}{err}')
    if errors:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(errors))


def build() -> Path:
    """Compile ``csrc/`` into ``_build/`` unless the hashed library exists:
    every source compiles in its own ``nvcc`` process, all at once, then
    one ``nvcc -shared`` links the objects."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        nvcc = _nvcc()
        objs, procs = [], []
        for name in SOURCES:
            obj = str(Path(tmpdir) / (Path(name).stem + '.o'))
            cmd = [nvcc, *NVCC_FLAGS, '-c', '-o', obj, str(CSRC / name)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
            objs.append(obj)
        _run(procs)
        lib = str(Path(tmpdir) / 'lib.so')
        cmd = [nvcc, *NVCC_FLAGS, '-shared', '-o', lib, *objs]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
        os.replace(lib, target)   # atomic: a concurrent loader sees all or nothing
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        lib.nnpops_error_string.argtypes = [ctypes.c_int]
        lib.nnpops_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call the C entry ``name``, count the launch, raise on a CUDA error."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.nnpops_error_string(err).decode()
        raise RuntimeError(f'{name}: CUDA error {err} ({msg})')
    LAUNCHES[name] += 1


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(*tensors) -> None:
    """Raise unless every tensor is a contiguous tensor on the current CUDA
    device (the kernels take raw pointers on the current stream)."""
    import torch
    dev = torch.cuda.current_device()
    for t in tensors:
        if t.device.type != 'cuda' or t.device.index != dev:
            raise ValueError(f'expected a tensor on cuda:{dev}, got {t.device}')
        if not t.is_contiguous():
            raise ValueError('expected a contiguous tensor')
