"""The reader of the port's own spans (``program_spans``) on a small
hand-made Chrome trace: self time under nested spans, device time joined
by correlation id for a launch on another thread, idle time inside a
span, the per-layer numbers made from them; and ``tracing.read`` on the
same trace, whose numbers the port's spans leave as they were while its
idle gaps take their names."""
import json

import pytest

from mdbench import program_spans, tracing


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
         'pid': 1, 'tid': tid}
    if corr is not None:
        e['args'] = {'correlation': corr}
    return e


HARNESS = [
    _ev('user_annotation', tracing.STRETCH, 0, 200),
    _ev('user_annotation', 'mdbench.select', 10, 40),
    _ev('user_annotation', 'mdbench.force', 60, 80),
    _ev('cuda_runtime', 'cudaLaunchKernel', 1, 1, corr=10),
    _ev('cuda_runtime', 'cudaLaunchKernel', 15, 1, corr=1),
    _ev('cuda_runtime', 'cudaMemcpyAsync', 32, 1, corr=2),
    _ev('cuda_runtime', 'cudaLaunchKernel', 63, 1, corr=3),
    _ev('cuda_runtime', 'cudaLaunchKernel', 83, 1, corr=4),
    # The backward's launch, on the autograd thread.
    _ev('cpu_op', 'aten::mul', 104, 4, tid=2),
    _ev('cuda_runtime', 'cudaLaunchKernel', 105, 1, tid=2, corr=5),
    _ev('cuda_runtime', 'cudaLaunchKernel', 160, 1, corr=6),
    _ev('kernel', 'void k0(float*)', 2, 11, tid=7, corr=10),
    _ev('kernel', 'void k1(float*)', 16, 2, tid=7, corr=1),
    _ev('gpu_memcpy', 'Memcpy HtoD (Pageable -> Device)', 33, 2, tid=7,
        corr=2),
    _ev('kernel', 'void aev(float*)', 64, 15, tid=7, corr=3),
    _ev('kernel', 'void ens(float*)', 85, 14, tid=7, corr=4),
    _ev('kernel', 'void bwd(float*)', 106, 24, tid=7, corr=5),
    _ev('kernel', 'void k6(float*)', 161, 9, tid=7, corr=6),
]
PROGRAM = [
    _ev('user_annotation', 'nnpops.md.block', 5, 145),
    _ev('user_annotation', 'nnpops.select', 12, 36),
    _ev('user_annotation', 'nnpops.select.species', 14, 6),
    _ev('user_annotation', 'nnpops.select.tiers', 30, 10),
    _ev('user_annotation', 'nnpops.force', 61, 78),
    _ev('user_annotation', 'nnpops.force.aev', 62, 18),
    _ev('user_annotation', 'nnpops.force.ensemble', 82, 18),
    _ev('user_annotation', 'nnpops.force.backward', 102, 36),
    # Outside the stretch: not read.
    _ev('user_annotation', 'nnpops.select', 300, 10),
]


def _write(tmp_path, events, name='trace.json'):
    path = tmp_path / name
    path.write_text(json.dumps({'traceEvents': events}))
    return path


@pytest.fixture
def spans(tmp_path):
    return program_spans.read(_write(tmp_path, HARNESS + PROGRAM))


@pytest.mark.parametrize('name, count, wall, self_, device, idle', [
    ('md.block', 1, 145, 31, 57, 80),
    ('select', 1, 36, 20, 4, 31),
    ('select.species', 1, 6, 6, 2, 4),
    ('select.tiers', 1, 10, 10, 2, 8),
    ('force', 1, 78, 6, 53, 25),
    ('force.aev', 1, 18, 18, 15, 3),
    ('force.ensemble', 1, 18, 18, 14, 4),
    ('force.backward', 1, 36, 36, 24, 12),
])
def test_read(spans, name, count, wall, self_, device, idle):
    got = spans[name]
    assert got['count'] == count
    assert got['wall_s'] == pytest.approx(wall * 1e-6)
    assert got['self_s'] == pytest.approx(self_ * 1e-6)
    assert got['device_s'] == pytest.approx(device * 1e-6)
    assert got['idle_s'] == pytest.approx(idle * 1e-6)


def test_read_without_spans_or_stretch(tmp_path):
    assert program_spans.read(_write(tmp_path, HARNESS)) == {}
    # No stretch: every range counts, the one at 300 too.
    whole = program_spans.read(_write(tmp_path, HARNESS[1:] + PROGRAM))
    assert whole['select']['count'] == 2


def test_metrics(spans):
    got = program_spans.metrics(spans, {'uploads': 1, 'upload_bytes': 800},
                                8)
    assert got == pytest.approx({
        'select_idle_ms': 31e-3, 'aev_ms': 15e-3, 'ensemble_ms': 14e-3,
        'force_backward_ms': 24e-3, 'upload_bytes_per_step': 100.0})
    # A program without the spans or the counters: nothing to report.
    assert program_spans.metrics({}, None, 8) == {}
    assert 'force_backward_ms' not in program_spans.metrics(
        {k: v for k, v in spans.items() if k != 'force.backward'}, None, 8)


def test_table(spans):
    lines = program_spans.table(spans).splitlines()
    assert len(lines) == 1 + len(spans)
    assert lines[1].split()[0] == 'nnpops.md.block'


def test_tracing_read_with_program_spans(tmp_path):
    """``tracing.read`` gives the same numbers with the port's spans in the
    trace; only the idle gaps' names change, to the innermost port span."""
    plain = tracing.read(_write(tmp_path, HARNESS, 'plain.json'))
    traced = tracing.read(_write(tmp_path, HARNESS + PROGRAM))
    assert set(traced) == set(plain)
    for key in ('window_s', 'busy_s', 'launches', 'device_activities',
                'span_device'):
        assert traced[key] == plain[key], key
    assert set(traced['span_device']) == {'select', 'force'}
    assert traced['breakdown']['device_ops'] == \
        plain['breakdown']['device_ops']
    gaps = dict(traced['breakdown']['idle_gaps'])
    assert sum(gaps.values()) == pytest.approx(
        sum(dict(plain['breakdown']['idle_gaps']).values()))
    # The gap [13, 16] lies in the species span inside the harness's
    # select span; [18, 33] in the port's select span alone.
    assert gaps['select/nnpops.select.species'] == pytest.approx(3e-6)
    assert gaps['select/nnpops.select'] == pytest.approx(15e-6)
    assert 'select' in dict(plain['breakdown']['idle_gaps'])
