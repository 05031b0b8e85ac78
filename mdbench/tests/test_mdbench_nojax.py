"""A tiny rehearsal run of the harness imports no module whose top-level
name is jax, jaxlib, flax or nnpops_tpu (names compared whole, so the
port, nnpops_tpu_torch, passes)."""
import json
import subprocess
import sys

from helpers import MOLECULES

from mdbench import harness

SCRIPT = f'''
import json, sys, time
sys.path.insert(0, {str(harness.HERE.parent)!r})
from mdbench import harness
sys.path.insert(0, {str(harness.HERE / 'tests')!r})
from helpers import small_cell, run_small
cfg, tr = small_cell('ani2x_pme')
cfg.update(layer_dims=[[32, 24, 16]] * 7, num_models=2)
out = run_small(cfg, tr, 2 ** 33 + 3, seconds=0.2)
import run
print(json.dumps([run.forbidden_modules(),
                  sorted({{m.split('.')[0] for m in sys.modules}})]))
'''


def test_rehearsal_imports_no_jax():
    proc = subprocess.run([sys.executable, '-c', SCRIPT], capture_output=True,
                          text=True, timeout=600,
                          cwd=str(harness.HERE))
    assert proc.returncode == 0, proc.stderr[-3000:]
    found, top = json.loads(proc.stdout.strip().splitlines()[-1])
    assert found == []
    top = set(top)
    assert 'nnpops_tpu_torch' in top
    assert not top & {'jax', 'jaxlib', 'flax', 'nnpops_tpu'}
    assert MOLECULES == 150
