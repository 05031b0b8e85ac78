"""Molecule file loaders, mol2 and PDB (the port's copy of
``nnpops_tpu.utils.io``).

Small, dependency-free parsers of what NNP workloads need: coordinates,
elements and box vectors. A PDB's CRYST1 record becomes the reduced
lower-triangular box the neighbor code requires. The native C++ loader
(``nnpops_tpu_torch.native``) has the same interface and falls back to
these parsers without a compiler. numpy only, no device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

# Minimal symbol -> atomic number table covering organic/bio systems.
_ELEMENTS = {
    'H': 1, 'He': 2, 'Li': 3, 'Be': 4, 'B': 5, 'C': 6, 'N': 7, 'O': 8,
    'F': 9, 'Ne': 10, 'Na': 11, 'Mg': 12, 'Al': 13, 'Si': 14, 'P': 15,
    'S': 16, 'Cl': 17, 'Ar': 18, 'K': 19, 'Ca': 20, 'Fe': 26, 'Zn': 30,
    'Br': 35, 'I': 53,
}


class Molecule(NamedTuple):
    positions: np.ndarray        # [N, 3] float32, Angstrom
    atomic_numbers: np.ndarray   # [N] int32
    box: Optional[np.ndarray]    # [3, 3] float32 or None


def _element_from_symbol(sym: str) -> int:
    sym = sym.strip()
    for cand in (sym[:2].capitalize(), sym[:1].upper()):
        if cand in _ELEMENTS:
            return _ELEMENTS[cand]
    raise ValueError(f'unknown element symbol: {sym!r}')


def _element_from_mol2(name: str, atype: str) -> int:
    """Element from a mol2 ATOM record.

    SYBYL types ("C.3", "N.ar", "Cl") carry the element before the dot;
    force-field typed files (GAFF "c3", "nd", or custom types like "zf") do
    not, so fall back to the atom name with a two-letter halogen check
    (ligand convention: "CL1" is chlorine, "CAA" is a carbon).
    """
    head = atype.split('.')[0]
    if head[:1].isupper():
        try:
            return _element_from_symbol(head)
        except ValueError:
            pass
    lower = atype.lower()
    if lower[:2] in ('cl', 'br') and head[:1].islower():
        return _ELEMENTS[lower[:2].capitalize()]
    letters = ''.join(ch for ch in name if ch.isalpha()).upper()
    if letters[:2] in ('CL', 'BR'):
        return _ELEMENTS[letters[:2].capitalize()]
    return _element_from_symbol(letters[:1])


def load_mol2(path: str) -> Molecule:
    """Parse a TRIPOS mol2 file (ATOM section: id, name, x, y, z, type...)."""
    positions, numbers = [], []
    in_atoms = False
    with open(path) as f:
        for line in f:
            stripped = line.strip()
            if stripped.startswith('@<TRIPOS>'):
                in_atoms = stripped == '@<TRIPOS>ATOM'
                continue
            if not in_atoms or not stripped:
                continue
            parts = stripped.split()
            if len(parts) < 6:
                continue
            positions.append([float(parts[2]), float(parts[3]), float(parts[4])])
            numbers.append(_element_from_mol2(parts[1], parts[5]))
    if not positions:
        raise ValueError(f'no atoms found in {path}')
    return Molecule(np.asarray(positions, np.float32),
                    np.asarray(numbers, np.int32), None)


def _reduced_box_from_cryst1(a, b, c, alpha, beta, gamma) -> np.ndarray:
    """CRYST1 cell parameters -> reduced lower-triangular box vectors
    (the convention required by the neighbor ops, getNeighborPairs.py:24-35)."""
    alpha, beta, gamma = np.deg2rad([alpha, beta, gamma])
    av = np.array([a, 0.0, 0.0])
    bv = np.array([b * np.cos(gamma), b * np.sin(gamma), 0.0])
    cx = c * np.cos(beta)
    cy = c * (np.cos(alpha) - np.cos(beta) * np.cos(gamma)) / np.sin(gamma)
    cz = np.sqrt(max(c * c - cx * cx - cy * cy, 0.0))
    cv = np.array([cx, cy, cz])
    # Reduce: subtract integer multiples so the reduced-form inequalities hold.
    cv -= bv * round(cv[1] / bv[1])
    cv -= av * round(cv[0] / av[0])
    bv -= av * round(bv[0] / av[0])
    return np.stack([av, bv, cv]).astype(np.float32)


def load_pdb(path: str) -> Molecule:
    """Parse a PDB file: ATOM/HETATM coordinates + element column, CRYST1 box."""
    positions, numbers = [], []
    box = None
    with open(path) as f:
        for line in f:
            record = line[:6].strip()
            if record == 'CRYST1':
                a, b, c = float(line[6:15]), float(line[15:24]), float(line[24:33])
                al, be, ga = float(line[33:40]), float(line[40:47]), float(line[47:54])
                box = _reduced_box_from_cryst1(a, b, c, al, be, ga)
            elif record in ('ATOM', 'HETATM'):
                positions.append([float(line[30:38]), float(line[38:46]),
                                  float(line[46:54])])
                sym = line[76:78].strip() if len(line) > 76 else ''
                if sym:
                    numbers.append(_element_from_symbol(sym))
                else:
                    # Fall back to the atom-name column: names never mean
                    # metals ("CA" is a C-alpha carbon, not calcium) — only
                    # the halogen two-letter forms are honored, mirroring
                    # the mol2 name logic and the native parser.
                    letters = ''.join(ch for ch in line[12:16] if ch.isalpha()).upper()
                    if letters[:2] in ('CL', 'BR'):
                        numbers.append(_ELEMENTS[letters[:2].capitalize()])
                    else:
                        numbers.append(_element_from_symbol(letters[:1]))
    if not positions:
        raise ValueError(f'no atoms found in {path}')
    return Molecule(np.asarray(positions, np.float32),
                    np.asarray(numbers, np.int32), box)
