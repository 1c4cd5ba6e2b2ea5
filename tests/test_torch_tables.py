"""Port vs JAX package: the host-side filter kernels and resize tables
(pure numpy f64 in both) must be exactly equal."""

import numpy as np
import pytest

from libsrcnn_tpu.ops import filters as jfilters
from libsrcnn_tpu.ops import weights_table as jtable
from libsrcnn_tpu_torch.config import FilterType
from libsrcnn_tpu_torch.ops import filters, weights_table

FILTERS = list(FilterType)


@pytest.mark.parametrize("ft", FILTERS, ids=lambda f: f.name)
@pytest.mark.parametrize("dst,src", [(97, 40), (31, 77)], ids=["up", "down"])
def test_contribution_table_equal(ft, dst, src):
    left, weights = weights_table.contribution_table(ft, dst, src)
    jleft, jweights = jtable.contribution_table(int(ft), dst, src)
    np.testing.assert_array_equal(left, jleft)
    np.testing.assert_array_equal(weights, jweights)
    assert weights.dtype == np.float64 and left.dtype == np.int32


@pytest.mark.parametrize("ft", FILTERS, ids=lambda f: f.name)
def test_filter_kernels_equal(ft):
    x = np.random.default_rng(1).uniform(-4, 4, 513)
    x[:5] = [0.0, 0.5, -1.0, 2.0, 3.0]  # support edges and the sinc pole
    fn, width = filters.FILTERS[ft]
    jfn, jwidth = jfilters.FILTERS[int(ft)]
    assert width == jwidth
    np.testing.assert_array_equal(fn(x), jfn(x))
