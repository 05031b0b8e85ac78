"""``painn_bwd_roofline`` on a synthetic trace (CPU): the least time of the
PaiNN message backward by hand, and no reading where the cell counts no
PaiNN pairs, the trace has no force span, or no ``painn_bwd`` op ran."""
from types import SimpleNamespace

import pytest

from mdbench import work
from mdbench.metrics import painn_bwd_roofline

COUNTS = {'painn_pairs': 1_440_888, 'interactions': 3, 'width': 128,
          'radial': 20, 'atoms': 26010, 'species': 2}
TRACE = {'span_device': {'force': (14.0, 45)},
         'breakdown': {'device_ops': [
             ['at::native::elementwise_kernel', 4.0],
             ['anon::painn_bwd_kernel_20_', 0.27]]}}


def read(counts, trace):
    return painn_bwd_roofline.read(SimpleNamespace(counts=counts,
                                                   trace=trace))


def test_painn_bwd_roofline_on_a_synthetic_trace():
    """Three blocks of 1,440,888 pairs at F 128, R 20: (46 F + 4 R + 6 R
    F) = 21,328 FLOP a pair, 92.19 GFLOP, 1.376 ms at 67 TFLOP/s; the
    kernel's 0.27 s over 45 force spans is 6 ms a call: 22.93 %."""
    least = 3 * 1_440_888 * 21_328 / 67e12
    assert work.PEAKS['fp32_flops'] == 67e12
    assert painn_bwd_roofline.least_seconds(COUNTS) == pytest.approx(least)
    assert least == pytest.approx(1.376e-3, rel=1e-3)
    assert read(COUNTS, TRACE) == pytest.approx(100 * least / (0.27 / 45))
    assert read(COUNTS, TRACE) == pytest.approx(22.93, rel=1e-3)


@pytest.mark.parametrize('case', ['plain_backward', 'no_force_span',
                                  'no_painn_pairs'])
def test_painn_bwd_roofline_reads_nothing(case):
    counts, trace = COUNTS, TRACE
    if case == 'plain_backward':
        trace = dict(TRACE, breakdown={'device_ops': [['gather', 1.0]]})
    elif case == 'no_force_span':
        trace = dict(TRACE, span_device={})
    else:
        counts = {'cfconv_pairs': 5}
    assert read(counts, trace) is None
