"""ctypes binding of the native host runtime (port of
``nnpops_tpu.native``): the molecule loader and the capacity planner.

:func:`get_lib` builds ``loader.cpp`` with ``g++ -O3 -shared -fPIC
-std=c++17`` at first use (one translation unit, about a second) into
``nnpops_tpu_torch/_build/libnnpops_host.so``, the directory the CUDA
kernels build into, and rebuilds it when the source is newer. The build
writes a temporary file and renames it, so processes that build at once
never load a torn library. Every entry point has a Python path
(``utils.io`` for the loaders, numpy for the planner), so the package works
without a compiler; the native path is for bulk loading and O(N) planning
at production scale. Host code only: nothing here touches a device.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..utils.io import Molecule, load_mol2, load_pdb

SRC = Path(__file__).parent / 'loader.cpp'
BUILD_DIR = Path(__file__).parent.parent / '_build'
LIB = BUILD_DIR / 'libnnpops_host.so'
_lock = threading.Lock()
_lib = None


def _build() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ['g++', '-O3', '-shared', '-fPIC', '-std=c++17', str(SRC),
               '-o', tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            if (not LIB.exists()
                    or LIB.stat().st_mtime < SRC.stat().st_mtime):
                _build()
            lib = ctypes.CDLL(str(LIB))
        except (OSError, subprocess.CalledProcessError):
            return None
        lib.nnpops_load.restype = ctypes.c_void_p
        lib.nnpops_load.argtypes = [ctypes.c_char_p]
        lib.nnpops_num_atoms.restype = ctypes.c_int32
        lib.nnpops_num_atoms.argtypes = [ctypes.c_void_p]
        lib.nnpops_has_box.restype = ctypes.c_int32
        lib.nnpops_has_box.argtypes = [ctypes.c_void_p]
        lib.nnpops_copy.restype = None
        lib.nnpops_copy.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')]
        lib.nnpops_free.restype = None
        lib.nnpops_free.argtypes = [ctypes.c_void_p]
        lib.nnpops_plan_capacities.restype = None
        lib.nnpops_plan_capacities.argtypes = [
            np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS'),
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
            ctypes.c_float,
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')]
        _lib = lib
        return _lib


def load_molecule(path: str) -> Molecule:
    """Load a mol2 or PDB file natively; the Python parsers without the
    library."""
    lib = get_lib()
    if lib is None:
        return load_mol2(path) if path.endswith('.mol2') else load_pdb(path)
    handle = lib.nnpops_load(path.encode())
    if not handle:
        raise ValueError(f'failed to parse {path}')
    try:
        n = lib.nnpops_num_atoms(handle)
        positions = np.empty((n, 3), np.float32)
        numbers = np.empty((n,), np.int32)
        box = np.zeros((3, 3), np.float32)
        lib.nnpops_copy(handle, positions, numbers, box)
        has_box = bool(lib.nnpops_has_box(handle))
    finally:
        lib.nnpops_free(handle)
    return Molecule(positions, numbers, box if has_box else None)


def _counts_native(lib, positions: np.ndarray, box: Optional[np.ndarray],
                   cutoff: float, angular_cutoff: float,
                   cell_size: float) -> Tuple[int, int, int]:
    out = np.zeros(3, np.int32)
    box_arr = None if box is None else np.ascontiguousarray(box, np.float32)
    box_arg = (None if box_arr is None
               else box_arr.ctypes.data_as(ctypes.c_void_p))
    lib.nnpops_plan_capacities(positions, len(positions), box_arg,
                               float(cutoff), float(angular_cutoff),
                               float(cell_size), out)
    return tuple(int(x) for x in out)


def _counts_numpy(positions: np.ndarray, box: Optional[np.ndarray],
                  cutoff: float, angular_cutoff: float,
                  cell_size: float) -> Tuple[int, int, int]:
    """The planner's counts by brute force (the JAX package's numpy path):
    max neighbors within ``cutoff`` and ``angular_cutoff``, max cell
    occupancy at ``cell_size``."""
    delta = positions[None] - positions[:, None]
    if box is not None:
        b = np.asarray(box, np.float64)
        delta = delta - np.round(delta[..., 2:3] / b[2, 2]) * b[2]
        delta = delta - np.round(delta[..., 1:2] / b[1, 1]) * b[1]
        delta = delta - np.round(delta[..., 0:1] / b[0, 0]) * b[0]
    d2 = (delta ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    k1 = int((d2 < cutoff * cutoff).sum(1).max())
    k2 = (int((d2 < angular_cutoff * angular_cutoff).sum(1).max())
          if angular_cutoff else 0)
    # The real max cell occupancy by binning (as the native planner bins).
    if box is not None:
        ext = np.diag(np.asarray(box, np.float64)).copy()
        origin = np.zeros(3)
    else:
        lo = positions.min(0).astype(np.float64)
        ext = positions.max(0) - lo + 1e-3
        origin = lo
    nc = np.maximum((ext / cell_size).astype(int), 1)
    f = (positions - origin) / ext
    f -= np.floor(f)
    cells3 = np.minimum((f * nc).astype(int), nc - 1)
    ids = (cells3[:, 0] * nc[1] + cells3[:, 1]) * nc[2] + cells3[:, 2]
    occ = int(np.bincount(ids).max())
    return k1, k2, occ


def plan_capacities(positions: np.ndarray, box: Optional[np.ndarray],
                    cutoff: float, angular_cutoff: float = 0.0,
                    cell_size: Optional[float] = None,
                    margin: float = 1.25) -> Tuple[int, int, int]:
    """Exact max neighbor counts (radial, angular) and cell occupancy of a
    configuration, scaled by a safety margin (``ceil(count * margin) +
    1``): sizes the cell-list and AEV capacities so that overflow cannot
    happen at run time. Native, or numpy without the library."""
    positions = np.ascontiguousarray(positions, np.float32)
    cs = float(cell_size if cell_size is not None else max(cutoff, 1e-3))
    lib = get_lib()
    if lib is not None:
        counts = _counts_native(lib, positions, box, cutoff, angular_cutoff,
                                cs)
    else:
        counts = _counts_numpy(positions, box, cutoff, angular_cutoff, cs)
    return tuple(int(np.ceil(v * margin)) + 1 for v in counts)
