"""Port parity: the planes histogram route (`mmlspark_tpu_torch.ops.
histogram`: `plan_lo_bins`, `planes_route`, `build_hist_plan`,
`_torch_hist_planes`) and a fit under `MMLSPARK_TPU_HIST=planes`, against
the JAX package's `histogram_pallas` on the CPU.

- The plan: the port's (F, n, LO) layout holds the reference's
  (F_pad, LO, n_pad) contents on the real rows and features, exactly.
- The router: the port's planes decision equals the reference's
  `kernel_route(m, B, has_planes=True)[0] == "planes"` (with its
  `MMLSPARK_TPU_HIST_JOINT64` default).
- `_torch_hist_planes` against the TPU kernel itself,
  `pallas_hist(..., lo_planes=, plane_lo=, interpret=True)`: both round
  grad/hess to bf16 and multiply by exact {0, 1} planes, so they differ
  only in f32 summation order: rtol 1e-5, atol 1e-4 (sums of a few
  thousand O(1) values); counts exact.
- A planes fit against the reference's planes fit (planes kernel in
  interpret mode) at depth 4, where every level (m = 1, 1, 2, 4) takes
  the planes route on both sides: the same trees, leaves and scores at
  the fit parity tolerance of tests/test_torch_boosting.py.
The CUDA kernel is held against `_torch_hist_planes` on the card in
tests/test_torch_histogram_planes_cuda.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mmlspark_tpu.ops import histogram_pallas as hp
from mmlspark_tpu_torch.ops import histogram as port

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_TOL = dict(rtol=1e-5, atol=1e-4)


def _data(n, f, m, b, seed=None, count_w=False):
    rng = np.random.default_rng(n if seed is None else seed)
    bins = rng.integers(0, b, size=(n, f)).astype(np.uint8)
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.uniform(0.1, 1, size=n).astype(np.float32)
    node = rng.integers(-1, m, size=n).astype(np.int32)
    cw = (rng.integers(0, 2, size=n).astype(np.float32) if count_w
          else None)
    return bins, grad, hess, node, node >= 0, cw


@pytest.mark.parametrize("n,f,b", [(3000, 5, 64), (900, 3, 96),
                                   (1500, 3, 128), (700, 33, 256)])
def test_plan_matches_reference(n, f, b):
    bins = _data(n, f, 1, b)[0]
    lo = port.plan_lo_bins(b)
    want = np.asarray(hp.build_hist_plan(jnp.asarray(bins), b))
    got = port.build_hist_plan(torch.as_tensor(bins), b)
    assert got.dtype == torch.int8 and tuple(got.shape) == (f, n, lo)
    # reference (F_pad, LO, n_pad) -> the real (F, n, LO) block
    np.testing.assert_array_equal(got.numpy(),
                                  want[:f, :, :n].transpose(0, 2, 1))


def test_router_matches_kernel_route(monkeypatch):
    monkeypatch.delenv("MMLSPARK_TPU_HIST_JOINT64", raising=False)
    for b in (32, 63, 64, 96, 100, 128, 255, 256):
        assert port.plan_lo_bins(b) == hp.plan_lo_bins(b), b
        for m in range(1, 65):
            kind, lo = hp.kernel_route(m, b, has_planes=True)
            assert bool(port.planes_route(m, b, True)) == (kind == "planes")
            if kind == "planes":
                assert port.planes_route(m, b, True) == lo
            assert port.planes_route(m, b, False) == 0
    assert port.PLANES_M_MAX == hp.PLANES_M_MAX


@pytest.mark.parametrize("n,f,m,b", [(3000, 5, 1, 64), (2500, 4, 2, 64),
                                     (2000, 6, 4, 64), (1500, 3, 4, 128),
                                     (900, 3, 2, 96)])
@pytest.mark.parametrize("with_cw", [False, True])
def test_plain_planes_matches_pallas_planes(n, f, m, b, with_cw):
    bins, grad, hess, node, active, cw = _data(n, f, m, b, count_w=with_cw)
    lo = hp.plan_lo_bins(b)
    j = jnp.asarray
    want = hp.pallas_hist(j(bins), j(grad), j(hess), j(node), j(active), m,
                          b, count_w=None if cw is None else j(cw),
                          lo_planes=hp.build_hist_plan(j(bins), b),
                          plane_lo=lo, interpret=True)
    t = torch.as_tensor
    tb = t(bins)
    got = port.node_feature_histograms(
        tb, t(grad), t(hess), t(node), t(active), m, b,
        count_w=None if cw is None else t(cw),
        lo_planes=port.build_hist_plan(tb, b), plane_lo=lo)
    for name, w, g in zip(["grad", "hess"], want[:2], got[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **_TOL,
                                   err_msg=name)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_planes_rounds_stats_to_bf16():
    """The planes histogram is the scatter histogram of bf16-rounded
    stats (exactly, in one-row bins), not of the f32 stats."""
    bins, grad, hess, node, active, _ = _data(64, 2, 1, 64, seed=3)
    bins[:, 0] = np.arange(64)              # one row per bin
    grad = grad + np.float32(1e-3)          # not representable in bf16
    t = torch.as_tensor
    tb = t(bins)
    got = port.node_feature_histograms(
        tb, t(grad), t(hess), t(node), t(active), 1, 64,
        lo_planes=port.build_hist_plan(tb, 64), plane_lo=16)
    rounded = t(grad).to(torch.bfloat16).to(torch.float32)
    want = port._torch_hist(tb, rounded, t(hess), t(node), t(active), 1, 64)
    assert torch.equal(got[0][0, 0], want[0][0, 0])
    assert not torch.equal(got[0][0, 0], port._torch_hist(
        tb, t(grad), t(hess), t(node), t(active), 1, 64)[0][0, 0])


def test_inactive_rows_drop_out():
    bins, grad, hess, node, _, cw = _data(1000, 4, 2, 64, count_w=True)
    t = torch.as_tensor
    tb = t(bins)
    plan = port.build_hist_plan(tb, 64)
    for nd, act in ((np.full(1000, -1, np.int32), np.ones(1000, bool)),
                    (np.zeros(1000, np.int32), np.zeros(1000, bool)),
                    (np.full(1000, 2, np.int32), np.ones(1000, bool))):
        out = port.node_feature_histograms(
            tb, t(grad), t(hess), t(nd), t(act), 2, 64, count_w=t(cw),
            lo_planes=plan, plane_lo=16)
        for arr in out:
            assert float(arr.abs().max()) == 0.0


def test_mismatched_plan_raises():
    """A plan of other bins (other row count), of another digit width, or
    for a bin count no digit divides is refused, as the reference's."""
    bins, grad, hess, node, active, _ = _data(2000, 4, 2, 64)
    t = torch.as_tensor
    args = (t(bins), t(grad), t(hess), t(node), t(active), 2, 64)
    other = port.build_hist_plan(t(_data(6000, 4, 2, 64)[0]), 64)
    with pytest.raises(ValueError, match="plan"):
        port.node_feature_histograms(*args, lo_planes=other, plane_lo=16)
    wide = port.build_hist_plan(t(bins), 256)          # LO = 64
    with pytest.raises(ValueError, match="LO=16"):
        port.node_feature_histograms(*args, lo_planes=wide, plane_lo=64)
    with pytest.raises(ValueError, match="LO \\| B"):
        port.build_hist_plan(t(bins), 255)
    # levels past PLANES_M_MAX ignore the plan and take the scatter route
    got = port.node_feature_histograms(
        t(bins), t(grad), t(hess), t(node), t(active), 8, 64,
        lo_planes=other, plane_lo=16)
    want = port._torch_hist(t(bins), t(grad), t(hess), t(node), t(active),
                            8, 64)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_fit_booster_planes_matches_reference_planes_fit(monkeypatch):
    """MMLSPARK_TPU_HIST=planes through both fit paths: the port builds
    its plan once and sends every level to `_torch_hist_planes`; the
    reference runs its planes kernel in interpret mode (as
    tests/test_histogram.py::test_fit_booster_planes_end_to_end)."""
    from test_torch_boosting import _assert_same_model, _data as fit_data

    from mmlspark_tpu.models.gbdt.boosting import BoostParams as RefParams
    from mmlspark_tpu.models.gbdt.boosting import fit_booster as ref_fit
    from mmlspark_tpu_torch.models.gbdt import BoostParams, fit_booster
    from mmlspark_tpu_torch.models.gbdt import trainer
    from mmlspark_tpu_torch.ops.binning import apply_bins, fit_bins

    x, y = fit_data("binary", n=1500, f=6, seed=12)
    kw = dict(objective="binary", num_iterations=3, max_depth=4,
              num_leaves=15, max_bin=63, min_data_in_leaf=20)
    monkeypatch.setenv("MMLSPARK_TPU_HIST", "planes")
    monkeypatch.setenv("MMLSPARK_TPU_HIST_INTERPRET", "1")
    ref_b, ref_base, _ = ref_fit(x, y, RefParams(**kw))

    calls = []
    real = trainer.node_feature_histograms

    def spy(*a, **k):
        calls.append((a[5], k.get("plane_lo"),
                      tuple(k["lo_planes"].shape)))
        return real(*a, **k)
    monkeypatch.setattr(trainer, "node_feature_histograms", spy)
    got_b, got_base, _ = fit_booster(x, y, BoostParams(**kw), device="cpu")
    assert got_base == ref_base
    assert calls == [(m, 16, (6, 1500, 16))
                     for _ in range(3) for m in (1, 1, 2, 4)]
    _assert_same_model(got_b, ref_b,
                       apply_bins(fit_bins(x, max_bin=63, seed=0), x))
    np.testing.assert_allclose(
        got_b.raw_score(x, got_base, backend="host"),
        ref_b.raw_score(x, ref_base), rtol=1e-4, atol=1e-4)
