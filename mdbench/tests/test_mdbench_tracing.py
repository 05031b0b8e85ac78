"""The trace reader on a small hand-made Chrome trace: busy time as the
union of device intervals, launch calls counted once, each span's device
time by correlation id, idle gaps named by the host op open in them."""
import json

import pytest

from mdbench import tracing


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
         'pid': 1, 'tid': tid}
    if corr is not None:
        e['args'] = {'correlation': corr}
    return e


def test_read(tmp_path):
    events = [
        _ev('user_annotation', tracing.STRETCH, 0, 100),
        _ev('user_annotation', 'mdbench.force', 10, 30),
        _ev('cpu_op', 'aten::mul', 12, 5),
        _ev('cuda_runtime', 'cudaLaunchKernel', 13, 2, corr=1),
        _ev('cuda_driver', 'cuLaunchKernel', 13.5, 1, corr=1),
        _ev('cuda_runtime', 'cudaLaunchKernel', 20, 2, corr=2),
        _ev('cuda_runtime', 'cudaStreamSynchronize', 25, 10),
        _ev('user_annotation', 'mdbench.select', 50, 20),
        _ev('cuda_runtime', 'cudaMemsetAsync', 55, 1, corr=3),
        _ev('cpu_op', 'aten::nonzero', 60, 8),
        # Device activity: two overlapping kernels (streams 7 and 8) and a
        # memset; one kernel launched outside the stretch is clipped.
        _ev('kernel', 'void anon_k<1>(float*)', 15, 10, tid=7, corr=1),
        _ev('kernel', 'void anon_k<2>(float*)', 20, 10, tid=8, corr=2),
        _ev('gpu_memset', 'Memset (Device)', 56, 4, tid=7, corr=3),
    ]
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': events}))
    tr = tracing.read(path)
    assert tr['window_s'] == pytest.approx(100e-6)
    assert tr['busy_s'] == pytest.approx(19e-6)          # [15, 30] + [56, 60]
    assert tr['launches'] == 3                            # driver call nested
    assert tr['device_activities'] == 3
    force_s, force_n = tr['span_device']['force']
    assert force_s == pytest.approx(15e-6) and force_n == 1
    assert tr['span_device']['select'][0] == pytest.approx(4e-6)
    ops = dict(tr['breakdown']['device_ops'])
    assert ops['anon_k<1>'] == pytest.approx(10e-6)
    gaps = dict(tr['breakdown']['idle_gaps'])
    # Gaps: [0, 15] (mid 7.5: loop), [30, 56] (mid 43: loop), [60, 100]
    # (mid 80: loop); 'select/aten::nonzero' is open over none of them.
    assert sum(gaps.values()) == pytest.approx(81e-6)
    assert set(gaps) == {'loop'}


def test_short_name():
    assert tracing.short_name(
        'void (anonymous namespace)::hidden_kernel<true>((anonymous '
        'namespace)::Table, float const*)') == 'anon::hidden_kernel<true>'
    assert tracing.short_name('Memcpy DtoD (Device -> Device)') == \
        'Memcpy DtoD'
