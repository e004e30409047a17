"""Port parity: the histogram op (`mmlspark_tpu_torch.ops.histogram`).

- the plain version `_torch_hist` against the reference's f32 scatter
  `_xla_hist`, at the shapes of tests/test_histogram.py, with count_w and
  inactive rows: f32 summation tolerance (rtol 1e-5, atol 1e-4 — sums of
  a few thousand O(1) values in another order); counts exact;
- against the TPU kernels themselves, `pallas_hist(..., interpret=True)`
  for the routes the main path takes, at their bf16 tolerance.
The CUDA kernels are held against the plain version on the card in
tests/test_torch_histogram_cuda.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mmlspark_tpu.ops.histogram import _xla_hist
from mmlspark_tpu.ops.histogram_pallas import pallas_hist
from mmlspark_tpu_torch.ops import histogram as port


def _data(n, f, m, b, seed=None, count_w=False):
    rng = np.random.default_rng(n if seed is None else seed)
    bins = rng.integers(0, b, size=(n, f)).astype(np.uint8)
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.uniform(0.1, 1, size=n).astype(np.float32)
    node = rng.integers(-1, m, size=n).astype(np.int32)
    cw = (rng.integers(0, 2, size=n).astype(np.float32) if count_w
          else None)
    return bins, grad, hess, node, node >= 0, cw


def _ref(args, m, b, count_w):
    bins, grad, hess, node, active, _ = args
    return _xla_hist(jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
                     jnp.asarray(node), jnp.asarray(active), m, b,
                     count_w=None if count_w is None else jnp.asarray(count_w))


def _port(args, m, b, count_w, device="cpu"):
    bins, grad, hess, node, active, _ = args
    t = lambda a: torch.as_tensor(a).to(device)
    return port.node_feature_histograms(
        t(bins), t(grad), t(hess), t(node), t(active), m, b,
        count_w=None if count_w is None else t(count_w))


@pytest.mark.parametrize("n,f,m,b", [(5000, 7, 4, 256), (3000, 16, 1, 64),
                                     (2048, 8, 32, 256), (100, 3, 2, 64),
                                     (4000, 5, 8, 256), (3000, 6, 16, 255),
                                     (2500, 4, 2, 128), (2000, 3, 4, 255),
                                     (3000, 5, 2, 64), (2500, 6, 4, 64),
                                     (2000, 4, 2, 100), (1500, 3, 4, 96)])
@pytest.mark.parametrize("with_cw", [False, True])
def test_plain_matches_xla_hist(n, f, m, b, with_cw):
    args = _data(n, f, m, b, count_w=with_cw)
    cw = args[5]
    want = _ref(args, m, b, cw)
    got = _port(args, m, b, cw)
    for name, w, g in zip(["grad", "hess"], want[:2], got[:2]):
        assert g.shape == (m, f, b) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_inactive_rows_and_count_indicator():
    """Inactive rows add nothing; the count histogram is the count_w
    indicator, not hess."""
    n, f, m, b = 1000, 4, 2, 64
    args = list(_data(n, f, m, b, count_w=True))
    args[4] = np.zeros(n, bool)                      # nothing active
    for h in _port(args, m, b, args[5]):
        assert float(h.abs().max()) == 0.0
    args = _data(n, f, m, b, count_w=True)
    active, cw = args[4], args[5]
    hc = _port(args, m, b, cw)[2]
    assert float(hc.sum()) == float((cw * active).sum() * f)


@pytest.mark.parametrize("route", [("direct", 64), ("joint", 16),
                                   ("joint", 32)])
def test_plain_matches_pallas_routes(route):
    """Against the TPU kernels in interpret mode, with bagging count
    weights: the tolerance of tests/test_histogram.py (bf16 operands)."""
    n, f, m, b = 3000, 5, 4, 64
    args = _data(n, f, m, b, count_w=True)
    bins, grad, hess, node, active, cw = args
    want = pallas_hist(jnp.asarray(bins), jnp.asarray(grad),
                       jnp.asarray(hess), jnp.asarray(node),
                       jnp.asarray(active), m, b, count_w=jnp.asarray(cw),
                       route=route, interpret=True)
    got = _port(args, m, b, cw)
    for name, w, g in zip(["grad", "hess", "count"], want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=6e-3,
                                   atol=5e-2, err_msg=f"{route} {name}")


def test_unknown_device_raises():
    args = _data(100, 2, 1, 16)
    with pytest.raises(ValueError, match="no histogram path"):
        _port(args, 1, 16, None, device="meta")
