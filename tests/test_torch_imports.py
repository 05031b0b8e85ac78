"""The PyTorch port imports no JAX (the machine with the GPU has none)."""
import pathlib
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1] / 'nnpops_tpu_torch'
MODULES = ['nnpops_tpu_torch'] + sorted(
    'nnpops_tpu_torch.' + '.'.join(p.relative_to(PKG).with_suffix('').parts)
    for p in PKG.rglob('*.py') if p.name != '__init__.py')


def test_import_leaves_jax_unloaded():
    code = ('import sys\n'
            + ''.join(f'import {m}\n' for m in MODULES)
            + "assert 'jax' not in sys.modules, sorted(m for m in sys.modules"
              " if m.startswith('jax'))\n"
            + "print('ok')\n")
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, cwd=PKG.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'


@pytest.mark.parametrize('path', sorted(PKG.rglob('*.py')),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_import_in_source(path):
    for line in path.read_text().splitlines():
        words = line.split()
        assert not (words[:2] == ['import', 'jax']
                    or (words[:1] == ['from'] and len(words) > 1
                        and words[1].split('.')[0] == 'jax')
                    or (words[:1] == ['import'] and len(words) > 1
                        and words[1].startswith('jax.'))), (path, line)


def test_import_builds_nothing():
    """Importing the kernel module needs no nvcc and loads no library."""
    from nnpops_tpu_torch import _kernels
    assert _kernels._lib is None
    assert set(_kernels.LAUNCHES) == {'angular_aev_fwd', 'angular_aev_bwd',
                                      'fused_nn_fwd', 'fused_nn_fwdgrad'}
