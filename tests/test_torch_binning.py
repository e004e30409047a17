"""Port parity: binning (`mmlspark_tpu_torch.ops.binning`) against the JAX
package's `ops/binning.py`. Bins must be bit-equal (np.array_equal),
NaN, +-inf, constant and low-cardinality columns and identity-binned
categorical columns included."""
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops import binning as ref
from mmlspark_tpu_torch.ops import binning as port

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)


def _data(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    x[:, 1] = rng.integers(0, 5, size=n)            # low cardinality
    x[:, 2] = 3.0                                   # constant
    x[:, 3] = rng.integers(0, 40, size=n)           # categorical ids
    x[rng.random(n) < 0.05, 0] = np.nan
    x[rng.random(n) < 0.02, 4] = np.inf
    x[rng.random(n) < 0.02, 4] = -np.inf
    x[rng.random(n) < 0.03, 5] = np.nan
    return x


@pytest.mark.parametrize("max_bin,cat", [(63, ()), (255, ()), (15, (3,))])
def test_fit_bins_matches_reference(max_bin, cat):
    x = _data()
    a = ref.fit_bins(x, max_bin=max_bin, sample_cnt=1000, seed=3,
                     categorical_features=cat)
    b = port.fit_bins(x, max_bin=max_bin, sample_cnt=1000, seed=3,
                      categorical_features=cat)
    assert np.array_equal(a.upper_bounds, b.upper_bounds, equal_nan=True)
    assert np.array_equal(a.n_bins, b.n_bins)
    assert a.max_bin == b.max_bin
    assert (a.categorical is None) == (b.categorical is None)
    if a.categorical is not None:
        assert np.array_equal(a.categorical, b.categorical)


@pytest.mark.parametrize("max_bin,cat", [(63, ()), (255, ()), (15, (3,))])
def test_apply_bins_device_bit_equal(max_bin, cat):
    """The port's device searchsorted (run on the CPU here) equals the
    reference's host and device assignment, on rows the mapper never saw
    (fresh NaN/inf positions)."""
    mapper = ref.fit_bins(_data(), max_bin=max_bin,
                          categorical_features=cat)
    x = _data(n=2000, seed=1)
    host = ref.apply_bins(mapper, x)
    dev_ref = np.asarray(ref.apply_bins_device(mapper, x))
    got = port.apply_bins_device(mapper, x, device="cpu")
    assert got.dtype == port.torch.uint8 and got.is_contiguous()
    assert np.array_equal(got.numpy(), host)
    assert np.array_equal(got.numpy(), dev_ref)
    assert np.array_equal(port.apply_bins(mapper, x), host)
