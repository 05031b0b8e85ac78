"""The PyTorch port imports no JAX (the machine with the GPU has none) and
nothing of the JAX package ``nnpops_tpu``, not even its numpy-only modules:
it keeps its own copies."""
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / 'nnpops_tpu_torch'
MODULES = ['nnpops_tpu_torch'] + sorted(
    'nnpops_tpu_torch.' + '.'.join(
        p.relative_to(PKG).parent.parts if p.name == '__init__.py'
        else p.relative_to(PKG).with_suffix('').parts)
    for p in PKG.rglob('*.py') if p.parent != PKG or p.name != '__init__.py')
# The port's sources and the chip smoke script, which drives the port only.
SOURCES = sorted(PKG.rglob('*.py')) + [ROOT / 'chip_smoke.py']


def test_import_leaves_jax_unloaded():
    code = ('import sys\n'
            + ''.join(f'import {m}\n' for m in MODULES)
            + "assert 'jax' not in sys.modules, sorted(m for m in sys.modules"
              " if m.startswith('jax'))\n"
            + "bad = sorted(m for m in sys.modules if m == 'nnpops_tpu'"
              " or m.startswith('nnpops_tpu.'))\n"
            + 'assert not bad, bad\n'
            + "print('ok')\n")
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'


def _imports(words, top):
    """Whether a source line (split into words) imports package ``top`` or
    one of its modules."""
    def named(mod):
        return mod == top or mod.startswith(top + '.')
    if words[:1] == ['from'] and len(words) > 1:
        return named(words[1])
    if words[:1] == ['import'] and len(words) > 1:
        return any(named(m.strip(',')) for m in words[1:]
                   if m not in ('as',))
    return False


@pytest.mark.parametrize('path', SOURCES,
                         ids=lambda p: str(p.relative_to(
                             PKG if PKG in p.parents else ROOT)))
def test_no_jax_import_in_source(path):
    for line in path.read_text().splitlines():
        words = line.split()
        assert not _imports(words, 'jax'), (path, line)
        assert not _imports(words, 'nnpops_tpu'), (path, line)


def test_import_builds_nothing():
    """Importing the kernel module needs no nvcc and loads no library."""
    from nnpops_tpu_torch import _kernels
    assert _kernels._lib is None
    assert set(_kernels.LAUNCHES) == {'angular_aev_fwd', 'angular_aev_bwd',
                                      'cfconv_bwd', 'cfconv_bwd_forces',
                                      'cfconv_fwd',
                                      'cluster_radial_fwd',
                                      'cluster_radial_bwd',
                                      'fused_nn_fwd_layer1',
                                      'fused_nn_fwd_hidden',
                                      'fused_nn_fwdgrad_layer1',
                                      'fused_nn_fwdgrad_hidden',
                                      'fused_nn_fwdgrad_dx',
                                      'left_pack', 'left_pack_lanes',
                                      'painn_bwd',
                                      'pair_radial_fwd', 'pair_radial_bwd',
                                      'pme_window_fwd', 'pme_window_bwd',
                                      'window_mask', 'window_radial_fwd',
                                      'window_radial_bwd'}


def test_host_and_parallel_modules_covered():
    """The host utilities, the native binding and the parallel layer are
    among the modules imported above; importing them builds nothing."""
    for name in ('utils', 'utils.water', 'utils.io', 'utils.profiling',
                 'utils.torchani_io', 'native', 'parallel',
                 'parallel.collectives', 'parallel.launch',
                 'parallel.sharding', 'parallel.window_shard', 'dryrun'):
        assert f'nnpops_tpu_torch.{name}' in MODULES, name
    code = ('import nnpops_tpu_torch.native as n, nnpops_tpu_torch.dryrun\n'
            'from nnpops_tpu_torch import _kernels\n'
            'assert n._lib is None and _kernels._lib is None\n'
            "print('ok')\n")
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'
