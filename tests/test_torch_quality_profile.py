"""The fit-time quality profile of the port (`telemetry.quality`, ROADMAP
Queue 3 (p)) against the JAX package's `telemetry/quality.py`: the same
columns give the same `DatasetProfile` state, the same drift scores and
the same chunked folds; a default-Params GBDT fit in each package
attaches a profile, equal column for column."""
import numpy as np
import pytest
import torch

from mmlspark_tpu.core import Table as RefTable
from mmlspark_tpu.data.pipeline import profile_columns as ref_profile_columns
from mmlspark_tpu.models.gbdt import GBDTRegressor as RefRegressor
from mmlspark_tpu.reliability.metrics import Histogram as RefHistogram
from mmlspark_tpu.telemetry import quality as ref_q
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.data import profile_columns
from mmlspark_tpu_torch.models.gbdt import GBDTClassifier, GBDTRegressor
from mmlspark_tpu_torch.reliability.metrics import Histogram
from mmlspark_tpu_torch.telemetry import quality as q

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)


def _columns(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=n), "b": rng.exponential(size=n) * 3 - 1,
            "c": rng.integers(0, 40, n), "d": np.full(n, 2.5),
            "e": np.where(rng.random(n) < 0.1, np.nan, rng.normal(size=n))}


def test_profile_state_equals_the_reference():
    cols = _columns()
    got = q.DatasetProfile.fit(cols, categorical=("c",))
    want = ref_q.DatasetProfile.fit(cols, categorical=("c",))
    assert got.state() == want.state()
    assert got.count == want.count
    # a state round-trips, and either package reads the other's
    assert q.DatasetProfile.from_state(want.state()).state() == want.state()
    assert ref_q.DatasetProfile.from_state(got.state()).state() == \
        got.state()


def test_chunked_fold_and_merge_equal_the_reference():
    cols = _columns(seed=1)
    got = q.DatasetProfile.fit(cols, categorical=("c",), observe=False)
    want = ref_q.DatasetProfile.fit(cols, categorical=("c",), observe=False)
    profile_columns(got, cols, chunk_rows=700, max_rows=4000)
    ref_profile_columns(want, cols, chunk_rows=700, max_rows=4000)
    assert got.state() == want.state()
    other = _columns(seed=2)
    live = got.spawn_live()
    ref_live = want.spawn_live()
    for name, v in other.items():
        live.observe(name, v)
        ref_live.observe(name, v)
    got.merge(live)
    want.merge(ref_live)
    assert got.state() == want.state()


def test_drift_scores_equal_the_reference():
    ref_cols, live_cols = _columns(seed=3), _columns(seed=4)
    live_cols["a"] = live_cols["a"] + 0.5
    prof = q.DatasetProfile.fit(ref_cols, categorical=("c",))
    ref_prof = ref_q.DatasetProfile.fit(ref_cols, categorical=("c",))
    live, ref_live = prof.spawn_live(), ref_prof.spawn_live()
    for name, v in live_cols.items():
        live.observe(name, v)
        ref_live.observe(name, v)
    got = q.drift_scores(prof, live)
    want = ref_q.drift_scores(ref_prof, ref_live)
    assert got == want
    assert got["a"]["psi"] > got["b"]["psi"]
    counts = ([3, 5, 0, 2], [1, 7, 2, 0])
    assert q.psi(*counts) == ref_q.psi(*counts)
    assert q.js_divergence(*counts) == ref_q.js_divergence(*counts)


def test_grid_histogram_state_equals_the_reference():
    edges = (-1.0, 0.0, 0.5, 3.0)
    got, want = Histogram("h", bounds=edges), RefHistogram("h", bounds=edges)
    assert got.state() == want.state()
    for v in (-4.0, -0.5, 0.25, 0.25, 2.0, 7.5):
        got.observe_ms(v)
        want.observe_ms(v)
    assert got.state() == want.state()
    assert got.percentile(50) == want.percentile(50)
    got.merge_state(want.state())
    want.merge_state(want.state())
    assert got.state() == want.state()
    with pytest.raises(ValueError):
        got.merge_state(Histogram("o", bounds=(1.0, 2.0)).state())


def test_serving_half_names_its_item():
    """The serving half is ported; its one left-out name, the watch rules
    over `telemetry/watch.py`, names its ROADMAP item."""
    from mmlspark_tpu_torch.telemetry.quality import StreamingEvaluator
    assert q.QualityMonitor().evaluator.__class__ is StreamingEvaluator
    with pytest.raises(NotImplementedError, match="item 27"):
        q.quality_watch_rules()


def test_default_fit_attaches_the_reference_s_profile():
    """Default Params in both packages: quality_profile is True, and the
    profiles of the features and the label are equal; the prediction
    columns hold the same row count (the two models' predictions agree at
    parity tolerance, not bit for bit)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1500, 4)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] + 0.2 * rng.normal(size=1500)).astype(
        np.float32)
    assert GBDTRegressor().quality_profile is True
    assert GBDTClassifier().quality_profile is True
    got = GBDTRegressor(num_iterations=3, device="cpu").fit(
        Table({"features": x, "label": y})).quality_profile
    want = RefRegressor(num_iterations=3, num_tasks=1).fit(
        RefTable({"features": x, "label": y})).quality_profile
    assert sorted(got["columns"]) == sorted(want["columns"]) == \
        ["f0", "f1", "f2", "f3", "label", "prediction"]
    for name in ("f0", "f1", "f2", "f3", "label"):
        assert got["columns"][name] == want["columns"][name], name
    pred, ref_pred = got["columns"]["prediction"], \
        want["columns"]["prediction"]
    assert pred["hist"]["count"] == ref_pred["hist"]["count"] == 1500
    np.testing.assert_allclose(pred["edges"], ref_pred["edges"], rtol=1e-4,
                               atol=1e-5)
    off = GBDTRegressor(num_iterations=1, device="cpu",
                        quality_profile=False).fit(
        Table({"features": x, "label": y}))
    assert getattr(off, "quality_profile", None) is None


def test_profile_columns_needs_one_row_count():
    prof = q.DatasetProfile.fit({"a": np.arange(10.0)}, observe=False)
    assert profile_columns(prof, {}) is prof
    profile_columns(prof, {"a": np.arange(10.0)}, chunk_rows=3)
    assert prof.columns["a"].count == 10
