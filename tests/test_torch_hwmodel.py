"""The port's AM latency model against the reference's, exactly.

``repro_torch.core.hwmodel`` is a copy of ``repro/core/hwmodel.py``'s
host arithmetic (Table 2's component latencies, the Fig. 6(a) dataflow).
Its constants and every function are held equal to the reference's, as
floats compared with ``==``, over a grid of ``HwConfig``: replay sizes
1 to 10^6, m 1 to 64, CSP ratios 0 to 1 and batches 1 to 512.
"""
import itertools

import pytest

from repro.core import hwmodel as jhw
from repro_torch.core import hwmodel as thw

SIZES = (1, 63, 64, 65, 5_000, 10_000, 20_000, 99_999, 1_000_000)
MS = (1, 7, 20, 64)
RATIOS = (0.0, 0.01, 0.15, 0.5, 1.0)
BATCHES = (1, 64, 512)


def test_table2_constants_equal_reference():
    names = [n for n in dir(jhw) if n.isupper()]
    assert names and all(getattr(thw, n) == getattr(jhw, n) for n in names)


@pytest.mark.parametrize("er_size", SIZES)
def test_latencies_equal_reference_over_grid(er_size):
    for m, ratio, batch in itertools.product(MS, RATIOS, BATCHES):
        jc = jhw.HwConfig(er_size=er_size, m=m, csp_ratio=ratio, batch=batch)
        tc = thw.HwConfig(er_size=er_size, m=m, csp_ratio=ratio, batch=batch)
        assert (tc.n_arrays, tc.csp_size) == (jc.n_arrays, jc.csp_size)
        for fn in ("latency_fr_ns", "latency_k_ns", "latency_update_ns"):
            assert getattr(thw, fn)(tc) == getattr(jhw, fn)(jc), (fn, jc)
        for us, variant in itertools.product((0.5, 150.0, 3_300.0),
                                             ("fr", "k")):
            assert thw.speedup_vs_gpu(tc, us, variant) == \
                jhw.speedup_vs_gpu(jc, us, variant)


def test_defaults_equal_reference():
    assert thw.HwConfig(1000) == thw.HwConfig(1000, 20, 0.15, 64)
    jc, tc = jhw.HwConfig(1000), thw.HwConfig(1000)
    assert (tc.m, tc.csp_ratio, tc.batch) == (jc.m, jc.csp_ratio, jc.batch)
