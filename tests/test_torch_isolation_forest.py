"""Port parity: the isolation forest (`models/isolation_forest.py`) and
its fleet workload (`workloads/iforest.py`).

The same seeded numpy rows go through both packages, JAX on the CPU and
the port with `device="cpu"`:
- the plain fit and the scorer's supervised fit grow heaps bit-identical
  to the reference's (numpy's `default_rng` draw for draw);
- scores within rtol 1e-6 (the reference sums path values in float32,
  the port in float64, so they sit a few float32 ulps apart), labels
  equal;
- a kill-resume fit and the `oocore` sample stage bit-identical to the
  uninterrupted fit;
- the descent in tiles equals the descent in one piece bit for bit;
- served through `serve_pipeline` with `plan.recompiles` at 0, replies
  equal to `transform`, and the uncached `fast_path=False` path equal too.
"""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import Table as RefTable
from mmlspark_tpu.data.oocore import OocoreOptions as RefOocore
from mmlspark_tpu.models.isolation_forest import IsolationForest as RefIF
from mmlspark_tpu.workloads import IsolationForestScorer as RefScorer
from mmlspark_tpu_torch.core import PipelineStage, Table
from mmlspark_tpu_torch.data.oocore import OocoreOptions
from mmlspark_tpu_torch.io.serving import serve_pipeline
from mmlspark_tpu_torch.models import isolation_forest as iso
from mmlspark_tpu_torch.reliability.faults import (FaultInjector,
                                                   InjectedFault)
from mmlspark_tpu_torch.reliability.metrics import reliability_metrics
from mmlspark_tpu_torch.reliability.policy import RetryPolicy
from mmlspark_tpu_torch.telemetry import lineage, quality
from mmlspark_tpu_torch.telemetry import names as tnames
from mmlspark_tpu_torch.workloads import (IsolationForestScorer,
                                          IsolationForestScorerModel)

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_HEAPS = ("_split_feat", "_split_thresh", "_is_leaf", "_path_value")
_SCORE_RTOL = 1e-6
_KW = dict(num_estimators=24, max_samples=64, contamination=0.05, seed=3)


@pytest.fixture(autouse=True)
def fleet_state():
    reliability_metrics.reset()
    quality.reset_monitor()
    lineage.reset_version_registry()
    yield
    lineage.reset_version_registry()
    quality.reset_monitor()
    reliability_metrics.reset()


def _data(seed=0, n=400, f=6):
    rng = np.random.default_rng(seed)
    return np.vstack([rng.normal(size=(n - n // 20, f)),
                      rng.normal(4.0, 1.0, size=(n // 20, f))])


def _same_heaps(a, b):
    for name in _HEAPS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("bootstrap, max_features", [(False, 1.0),
                                                      (True, 0.5)])
def test_plain_fit_is_the_reference_s(bootstrap, max_features):
    x = _data()
    kw = dict(_KW, bootstrap=bootstrap, max_features=max_features)
    ref = RefIF(**kw).fit(RefTable({"features": x}))
    port = iso.IsolationForest(device="cpu", **kw).fit(Table({"features": x}))
    _same_heaps(ref, port)
    assert port._c_norm == ref._c_norm and port._depth == ref._depth
    assert port._threshold == pytest.approx(ref._threshold, rel=_SCORE_RTOL)
    want = RefTable({"features": x})
    got = port.transform(Table({"features": x}))
    ref_out = ref.transform(want)
    np.testing.assert_allclose(got["outlierScore"], ref_out["outlierScore"],
                               rtol=_SCORE_RTOL)
    np.testing.assert_array_equal(got["predictedLabel"],
                                  ref_out["predictedLabel"])


def test_scorer_fit_and_scores_are_the_reference_s():
    x = _data()
    ref = RefScorer(**_KW).fit(RefTable({"features": x}))
    port = IsolationForestScorer(device="cpu", **_KW).fit(
        Table({"features": x}))
    _same_heaps(ref, port)
    assert port._n_features == ref._n_features
    np.testing.assert_allclose(port.scoring_plan()(x),
                               ref.scoring_plan()(x), rtol=_SCORE_RTOL)
    assert port._threshold == pytest.approx(ref._threshold, rel=_SCORE_RTOL)
    assert port.lineage["estimator"] == "IsolationForestScorer"
    assert port.quality_profile
    assert reliability_metrics.get(tnames.WORKLOADS_IFOREST_TREES) == 24


def test_reference_model_carried_across_scores_the_same():
    x = _data(2)
    ref = RefScorer(**_KW).fit(RefTable({"features": x}))
    port = iso.iforest_from_reference(ref, cls=IsolationForestScorerModel,
                                      device="cpu")
    assert port._n_features == x.shape[1]
    np.testing.assert_allclose(port.transform(Table({"features": x}))[
        "outlierScore"], ref.transform(RefTable({"features": x}))[
        "outlierScore"], rtol=_SCORE_RTOL)


def test_descent_in_tiles_equals_one_piece():
    x = _data(4)
    m = iso.IsolationForest(device="cpu", **_KW).fit(Table({"features": x}))
    heaps = m._heaps(torch.device("cpu"))
    xt = torch.as_tensor(x, dtype=torch.float32)
    whole = iso._score_forest(xt, *heaps, m._c_norm, m._depth)
    tiled = iso._score_forest(xt, *heaps, m._c_norm, m._depth, tile=37)
    assert torch.equal(whole, tiled)
    # the outliers (last 5%) score highest
    assert whole[-20:].mean() > whole[:-20].mean() + 0.1


def test_restart_mid_fit_is_bit_identical(tmp_path):
    x = _data()
    clean = IsolationForestScorer(device="cpu", **_KW).fit(
        Table({"features": x}))
    inj = FaultInjector(seed=1337, rules=[
        {"site": "train.step5", "kind": "crash", "at": [0]}])
    m = IsolationForestScorer(
        device="cpu", checkpoint_dir=str(tmp_path / "ck"),
        checkpoint_every=2, faults=inj, **_KW).fit(Table({"features": x}))
    _same_heaps(clean, m)
    assert clean._threshold == m._threshold
    assert reliability_metrics.get("train.step_restarts") >= 1


def test_kill_resume_is_bit_identical(tmp_path):
    """Exhaust the restarts (the in-process analogue of a kill), then a
    fresh fit on the same checkpoint directory resumes from the tree
    cursor and lands bit-identical to the uninterrupted fit, and to the
    reference's."""
    x = _data()
    clean = IsolationForestScorer(device="cpu", **_KW).fit(
        Table({"features": x}))
    kw = dict(_KW, device="cpu", checkpoint_dir=str(tmp_path / "ck"),
              checkpoint_every=2)
    inj = FaultInjector(seed=7, rules=[
        {"site": "train.step9", "kind": "crash", "at": [0, 1]}])
    with pytest.raises(InjectedFault):
        IsolationForestScorer(faults=inj,
                              retry_policy=RetryPolicy(max_attempts=1),
                              **kw).fit(Table({"features": x}))
    resumed = IsolationForestScorer(**kw).fit(Table({"features": x}))
    _same_heaps(clean, resumed)
    assert clean._threshold == resumed._threshold
    assert reliability_metrics.get("train.resumes") >= 1
    assert lineage.model_version(clean).content_digest == \
        lineage.model_version(resumed).content_digest
    _same_heaps(RefScorer(**_KW).fit(RefTable({"features": x})), resumed)


def test_oocore_sample_stage_is_bit_identical():
    x = _data()
    clean = IsolationForestScorer(device="cpu", **_KW).fit(
        Table({"features": x}))
    m = IsolationForestScorer(device="cpu", oocore=OocoreOptions(
        chunk_rows=64), **_KW).fit(Table({"features": x}))
    _same_heaps(clean, m)
    assert reliability_metrics.gauge(
        tnames.DATA_OOCORE_RESIDENT_BYTES) <= 64 * 6 * 4
    ref = RefScorer(oocore=RefOocore(chunk_rows=64), **_KW).fit(
        RefTable({"features": x}))
    _same_heaps(ref, m)


def test_kernels_and_save_load(tmp_path):
    x = _data(1)
    m = IsolationForestScorer(device="cpu", **_KW).fit(Table({"features": x}))
    out = m.transform(Table({"features": x}))
    score_k = m._serving_kernel(m.score_col)
    label_k = m._serving_kernel(m.predicted_label_col)
    assert score_k.expected_features == x.shape[1]
    np.testing.assert_array_equal(score_k(x), out[m.score_col])
    np.testing.assert_array_equal(label_k(x).astype(np.int64),
                                  out[m.predicted_label_col])
    assert m._serving_kernel("nonexistent") is None
    with pytest.raises(ValueError):
        m.scoring_plan()(np.zeros((2, x.shape[1] + 1), np.float32))
    m.save(str(tmp_path / "m"))
    back = PipelineStage.load(str(tmp_path / "m"))
    _same_heaps(m, back)
    np.testing.assert_array_equal(
        back.transform(Table({"features": x}))[m.score_col],
        out[m.score_col])


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=15) as resp:
        return resp, json.loads(resp.read())


@pytest.mark.parametrize("fast_path", [True, False])
def test_serves_equal_to_transform(fast_path):
    """The compiled plan answers every repeat of a bucket with 0
    recompiles, and a reply equals the offline transform bit for bit,
    on the fast path and on the uncached Table path."""
    x = _data(7)
    m = IsolationForestScorer(device="cpu", **_KW).fit(Table({"features": x}))
    want = m.transform(Table({"features": x[:4]}))["outlierScore"]
    server, q = serve_pipeline(m, ["features"], output_col="outlierScore",
                               fast_path=fast_path)
    try:
        for i in range(8):
            resp, reply = _post(server.address,
                                {"features": [float(v) for v in x[i % 4]]})
            assert reply["outlierScore"] == want[i % 4]
        if fast_path:
            assert resp.headers["X-Model-Version"]
            stats = q.transform_fn.stats()
            assert stats["misses"] == 1 and stats["hits"] >= 7
            assert reliability_metrics.get(tnames.PLAN_RECOMPILES) == 0
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(server.address, {"features": [0.0] * (x.shape[1] + 1)})
            assert ei.value.code == 400
    finally:
        q.stop()
        server.stop()


def test_contract_names_its_item():
    import mmlspark_tpu_torch.workloads.iforest as wi
    with pytest.raises(NotImplementedError, match="item 24"):
        wi.iforest_score_contract   # noqa: B018
