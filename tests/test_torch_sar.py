"""Port parity: SAR (`recommendation/sar.py`) and its serving workload
(`workloads/sar_serving.py`).

The same seeded events go through both packages, JAX on the CPU and the
port with `device="cpu"`:
- affinity and similarity within rtol 1e-6 for all three similarity
  functions, with time decay (the reference sums affinities in float32,
  the port in float64 in event order, rounded once), and the
  co-occurrence counts C = BᵀB exactly equal;
- top-k with the reference's tie rule (`lax.top_k`: the lower index
  first among equal values): index lists equal wherever the k-th value
  has no tie, index sets equal up to the tied level where it does;
- the plan on a 4-position CPU mesh equal to 1 position;
- `remove_seen` and unknown users (items -1, ratings NaN);
- `recommend?user=` served through the id-keyed plan branch with 0
  recompiles, and `fast_path=False` replies equal to the fast path's.
"""
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.core import Table as RefTable
from mmlspark_tpu.recommendation import SAR as RefSAR
from mmlspark_tpu.workloads import SARServing as RefSARServing
from mmlspark_tpu_torch.core import PipelineStage, Table
from mmlspark_tpu_torch.io.serving import serve_pipeline
from mmlspark_tpu_torch.ops.topk import top_k
from mmlspark_tpu_torch.parallel import data_mesh
from mmlspark_tpu_torch.recommendation import SAR
from mmlspark_tpu_torch.recommendation.sar import (_segment_sums,
                                                   sar_from_reference)
from mmlspark_tpu_torch.reliability.faults import (FaultInjector,
                                                   InjectedFault)
from mmlspark_tpu_torch.reliability.metrics import reliability_metrics
from mmlspark_tpu_torch.telemetry import lineage, quality
from mmlspark_tpu_torch.telemetry import names as tnames
from mmlspark_tpu_torch.workloads import SARServing, SARServingModel

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_RTOL = 1e-6
_N_USERS, _N_ITEMS = 40, 30


@pytest.fixture(autouse=True)
def fleet_state():
    reliability_metrics.reset()
    quality.reset_monitor()
    lineage.reset_version_registry()
    yield
    lineage.reset_version_registry()
    quality.reset_monitor()
    reliability_metrics.reset()


def _events(seed=0, n_ev=600, n_users=_N_USERS, n_items=_N_ITEMS):
    rng = np.random.default_rng(seed)
    return {"user": rng.integers(0, n_users, n_ev),
            "item": rng.integers(0, n_items, n_ev),
            "rating": rng.integers(1, 6, n_ev).astype(np.float64),
            "timestamp": rng.integers(0, 10**7, n_ev).astype(np.float64)}


def _cooc(ev):
    b = np.zeros((ev["user"].max() + 1, ev["item"].max() + 1))
    b[ev["user"], ev["item"]] = 1.0
    return b.T @ b


def _assert_topk_agrees(idx, vals, want_scores, k):
    """`idx`/`vals` (n, k) against float64 scores: each row's values are
    the k largest within rtol, index lists equal where the k-th value is
    untied, sets equal up to the tied level where it is."""
    for r in range(want_scores.shape[0]):
        s = want_scores[r]
        order = np.argsort(-s, kind="stable")
        top = s[order[:k]]
        np.testing.assert_allclose(vals[r], top, rtol=1e-5, atol=1e-6)
        tol = 1e-5 * max(abs(top[-1]), 1e-6)
        near = np.abs(s - top[-1]) <= tol
        if near.sum() == 1 and not np.any(
                np.abs(np.diff(top)) <= 1e-5 * np.abs(top[1:])):
            np.testing.assert_array_equal(idx[r], order[:k])
        else:
            above = set(np.flatnonzero(s > top[-1] + tol).tolist())
            got = set(idx[r].tolist())
            assert above <= got, r
            assert got - above <= set(np.flatnonzero(near).tolist()), r


@pytest.mark.parametrize("sim", ["jaccard", "lift", "cooccurrence"])
@pytest.mark.parametrize("ref_cls, port_cls", [(RefSAR, SAR),
                                               (RefSARServing, SARServing)])
def test_fit_tables_are_the_reference_s(sim, ref_cls, port_cls):
    ev = _events()
    kw = dict(similarity_function=sim, support_threshold=2,
              time_decay_coeff=30)
    ref = ref_cls(**kw).fit(RefTable(ev))
    port = port_cls(device="cpu", **kw).fit(Table(ev))
    np.testing.assert_allclose(port._affinity, ref._affinity, rtol=_RTOL)
    np.testing.assert_allclose(port._similarity, ref._similarity,
                               rtol=_RTOL)
    assert port._affinity.dtype == port._similarity.dtype == np.float32


def test_cooccurrence_counts_are_exact():
    ev = _events(1)
    port = SAR(similarity_function="cooccurrence", support_threshold=0,
               device="cpu").fit(Table(ev))
    ref = RefSAR(similarity_function="cooccurrence",
                 support_threshold=0).fit(RefTable(ev))
    want = _cooc(ev)
    np.testing.assert_array_equal(port._similarity, want)
    np.testing.assert_array_equal(port._similarity, ref._similarity)


def test_time_decay_halves_per_half_life():
    t = {"user": np.array([0, 0]), "item": np.array([0, 1]),
         "timestamp": np.array([0.0, 30 * 86400.0])}
    m = SAR(time_decay_coeff=30, rating_col=None, support_threshold=0,
            device="cpu").fit(Table(t))
    np.testing.assert_allclose(m._affinity[0], [0.5, 1.0], rtol=1e-7)


def test_segment_sums_take_events_in_order():
    keys = torch.tensor([5, 2, 5, 5, 2, 9])
    w = torch.tensor([1e16, 1.0, 1.0, -1e16, 2.0, 3.0], dtype=torch.float64)
    uk, sums = _segment_sums(keys, w)
    assert uk.tolist() == [2, 5, 9]
    # (1e16 + 1) - 1e16 in input order is 0 in float64, not 1
    assert sums.tolist() == [3.0, 0.0, 3.0]


def test_two_fits_are_bit_identical():
    ev = _events(3)
    a = SARServing(support_threshold=2, device="cpu").fit(Table(ev))
    b = SARServing(support_threshold=2, device="cpu").fit(Table(ev))
    assert np.array_equal(a._affinity, b._affinity)
    assert np.array_equal(a._similarity, b._similarity)


def test_top_k_tie_order_is_lax_top_k_s():
    rng = np.random.default_rng(5)
    for _ in range(50):
        n, m = rng.integers(1, 6), rng.integers(2, 40)
        k = int(rng.integers(1, m + 1))
        s = rng.integers(0, 3, size=(n, m)).astype(np.float32)
        s[rng.random(s.shape) < 0.2] = -np.inf
        vals, idx = top_k(torch.as_tensor(s), k)
        jv, ji = jax.lax.top_k(s, k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("sim", ["jaccard", "cooccurrence"])
def test_recommendations_are_the_reference_s(sim):
    ev = _events()
    ref = RefSARServing(similarity_function=sim, support_threshold=2,
                        num_recommendations=5).fit(RefTable(ev))
    port = sar_from_reference(ref, cls=SARServingModel, device="cpu",
                              num_recommendations=5)
    scores = (np.asarray(ref._affinity, np.float64)
              @ np.asarray(ref._similarity, np.float64))
    out = port.recommend_plan()(np.arange(_N_USERS))
    ref_out = ref.recommend_plan()(np.arange(_N_USERS))
    _assert_topk_agrees(out[:, 0].astype(int), out[:, 1], scores, 5)
    _assert_topk_agrees(ref_out[:, 0].astype(int), ref_out[:, 1], scores, 5)
    rec = port.recommend_for_user_subset(np.arange(_N_USERS), 5)
    np.testing.assert_array_equal(rec["recommendations"], out[:, 0])
    np.testing.assert_array_equal(rec["ratings"], out[:, 1])
    # pair scoring equals affinity @ similarity
    t = Table({"user": ev["user"][:50], "item": ev["item"][:50]})
    np.testing.assert_allclose(
        port.transform(t)["prediction"],
        scores[ev["user"][:50], ev["item"][:50]], rtol=1e-6, atol=1e-7)


def test_four_positions_equal_one():
    m = SARServing(support_threshold=2, num_recommendations=6,
                   device="cpu").fit(Table(_events(2)))
    ids = np.arange(_N_USERS + 3) - 1          # one unknown on each side
    one = m.recommend_plan(mesh=data_mesh(devices=["cpu"]))(ids)
    four = m.recommend_plan(mesh=data_mesh(devices=["cpu"] * 4))(ids)
    np.testing.assert_array_equal(one, four)
    # 30 items over 4 positions pads the catalog: no padded item served
    assert one[1:-2, 0].max() < _N_ITEMS


def test_remove_seen_and_unknown_users():
    ev = _events()
    m = SARServing(support_threshold=2, num_recommendations=4,
                   remove_seen=True, device="cpu").fit(Table(ev))
    out = m.recommend_plan()(np.arange(m.n_users))
    for u in range(m.n_users):
        seen = set(ev["item"][ev["user"] == u].tolist())
        assert not (seen & set(out[u, 0].astype(int).tolist())), u
    assert np.isfinite(out[:, 1]).all()        # _NEG stays finite
    reliability_metrics.reset()
    bad = m.recommend_plan()(np.array([-3, m.n_users + 5]))
    np.testing.assert_array_equal(bad[:, 0, :], -1.0)
    assert np.isnan(bad[:, 1, :]).all()
    assert reliability_metrics.get(tnames.WORKLOADS_SAR_UNKNOWN_USERS) == 2
    # the plain model's pair scoring answers NaN outside the fitted range
    t = Table({"user": np.array([0, -1, 0]), "item": np.array([0, 1, 99])})
    pred = m.transform(t)["prediction"]
    assert np.isfinite(pred[0]) and np.isnan(pred[1:]).all()


def test_refit_chaos_leaves_incumbent():
    inj = FaultInjector(seed=11, rules=[
        {"site": "workloads.sar.refit", "kind": "error", "at": [0]}])
    with pytest.raises(InjectedFault):
        SARServing(support_threshold=2, faults=inj,
                   device="cpu").fit(Table(_events(5)))
    m = SARServing(support_threshold=2, faults=inj,
                   device="cpu").fit(Table(_events(5)))
    assert m.lineage["estimator"] == "SARServing" and m.quality_profile
    assert reliability_metrics.gauge(
        tnames.WORKLOADS_SAR_CATALOG_ITEMS) == m.n_items


def test_save_load_keeps_the_plan(tmp_path):
    m = SARServing(support_threshold=2, num_recommendations=3,
                   device="cpu").fit(Table(_events(4)))
    m.save(str(tmp_path / "sar"))
    back = PipelineStage.load(str(tmp_path / "sar"))
    ids = np.arange(_N_USERS)
    np.testing.assert_array_equal(back.recommend_plan()(ids),
                                  m.recommend_plan()(ids))


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=15) as resp:
        return resp, json.loads(resp.read())


def test_serves_through_the_id_keyed_plan():
    m = SARServing(support_threshold=2, num_recommendations=4,
                   device="cpu").fit(Table(_events(6)))
    server, q = serve_pipeline(m, ["user"], output_col="recommendations")
    try:
        want = m.recommend_plan()(np.array([3]))
        for _ in range(6):
            resp, reply = _post(server.address, {"user": 3})
        items, ratings = reply["recommendations"]
        assert items == want[0, 0].tolist()
        assert ratings == want[0, 1].tolist()
        assert resp.headers["X-Model-Version"]
        stats = q.transform_fn.stats()
        assert stats["misses"] == 1 and stats["hits"] >= 5
        assert reliability_metrics.get(tnames.PLAN_RECOMPILES) == 0
        assert reliability_metrics.get(
            tnames.WORKLOADS_SAR_RECOMMEND_ROWS) >= 6
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server.address, {"user": "alice"})
        assert ei.value.code == 400
        # an unknown user answers items -1
        _, reply = _post(server.address, {"user": 10_000})
        assert reply["recommendations"][0] == [-1.0] * 4
    finally:
        q.stop()
        server.stop()


def _reply_or_status(url, payload):
    try:
        return _post(url, payload)[1]
    except urllib.error.HTTPError as e:
        return e.code


def test_uncached_path_replies_equal_fast_path():
    """Known users, users outside the fitted range (items -1, ratings
    NaN) and ids the plan refuses (400) answer alike on both paths."""
    m = SARServing(support_threshold=2, num_recommendations=5,
                   device="cpu").fit(Table(_events(8)))
    users = list(range(0, _N_USERS, 3)) + [-1, _N_USERS, 99_999]
    replies = {}
    for fast in (True, False):
        server, q = serve_pipeline(m, ["user"], output_col="recommendations",
                                   fast_path=fast)
        try:
            replies[fast] = [_reply_or_status(server.address, {"user": u})
                             for u in users]
            replies[fast] += [_reply_or_status(server.address, bad)
                              for bad in ({"user": "alice"}, {"user": 1.5},
                                          {"user": [1, 2]}, {"id": 3})]
        finally:
            q.stop()
            server.stop()
    # NaN != NaN: compare the JSON text of the replies
    assert json.dumps(replies[True]) == json.dumps(replies[False])
    for r in replies[False][-7:-4]:
        assert r["recommendations"][0] == [-1.0] * 5
        assert all(np.isnan(r["recommendations"][1]))
    assert replies[False][-4:] == [400] * 4


def test_uncached_path_answers_batch_mates_of_a_bad_row():
    """One refused id in a batch answers 400 alone; its batch-mates are
    scored."""
    m = SARServing(support_threshold=2, num_recommendations=3,
                   device="cpu").fit(Table(_events(8)))
    server, q = serve_pipeline(m, ["user"], output_col="recommendations",
                               fast_path=False)
    try:
        replies = q.transform_fn([json.dumps({"user": 2}).encode(),
                                  json.dumps({"user": "bob"}).encode(),
                                  b"{not json",
                                  json.dumps({"user": 7}).encode()])
    finally:
        q.stop()
        server.stop()
    want = m.recommend_plan()(np.array([2, 7]))
    assert replies[0]["recommendations"] == want[0].tolist()
    assert replies[3]["recommendations"] == want[1].tolist()
    assert replies[1].status == 400 and replies[2].status == 400


def test_plain_recommend_answers_unknown_users():
    """`recommend_for_user_subset` answers ids outside the fitted range
    with items -1 and ratings NaN (it never indexes the affinity with
    them); `_scores` refuses them."""
    m = SAR(support_threshold=2, device="cpu").fit(Table(_events(4)))
    ids = np.array([3, -1, _N_USERS, 5, 10**9])
    rec = m.recommend_for_user_subset(ids, 4, remove_seen=True)
    want = m.recommend_for_user_subset(np.array([3, 5]), 4, remove_seen=True)
    got_i = np.asarray(rec["recommendations"])
    got_r = np.asarray(rec["ratings"])
    np.testing.assert_array_equal(got_i[[0, 3]], want["recommendations"])
    np.testing.assert_array_equal(got_r[[0, 3]], want["ratings"])
    assert (got_i[[1, 2, 4]] == -1).all()
    assert np.isnan(got_r[[1, 2, 4]]).all()
    with pytest.raises(ValueError, match="outside"):
        m._scores(np.array([_N_USERS]))


def test_segment_sums_one_pass_over_repeats():
    """Keys repeated thousands of times (implicit-feedback logs) sum in
    one reduction, equal to float64 numpy within rounding."""
    rng = np.random.default_rng(11)
    n = 200_000
    keys = (rng.zipf(1.3, n) % 50).astype(np.int64)
    w = rng.uniform(0, 1, n) * np.power(2.0, -rng.uniform(0, 36, n))
    uk, sums = _segment_sums(torch.as_tensor(keys), torch.as_tensor(w))
    want = np.zeros(50)
    np.add.at(want, keys, w)
    assert uk.tolist() == np.flatnonzero(np.bincount(keys, minlength=50)
                                         ).tolist()
    np.testing.assert_allclose(sums.numpy(), want[uk.numpy()], rtol=1e-12)
    assert np.bincount(keys).max() > 1000


def test_contract_names_its_item():
    import mmlspark_tpu_torch.workloads.sar_serving as ws
    with pytest.raises(NotImplementedError, match="item 24"):
        ws.sar_score_sharded_contract   # noqa: B018
