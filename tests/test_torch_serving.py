"""Port parity: model serving (`mmlspark_tpu_torch.io`).

The same model, fitted once by the reference and carried across
(`models.gbdt.convert.booster_from_reference`; the encoder's weights
through `transformer.params_from_numpy`), is served by both packages'
`serve_pipeline` over localhost HTTP, on both transports, JAX on the CPU
and the port with `device="cpu"`:
- GBDT, 64 seeded rows: equal `prediction` labels, probabilities within
  1e-6, raw scores within 1e-6, the tolerance the reference's own
  `scoring_plan` keeps against `raw_score` (ROADMAP Queue 3 (d));
- `TransformerSentenceEncoder` at d_model 32, 2 layers: embeddings within
  1e-5 (batch-of-one serving pads each document to its own width);
- the JSON error bodies of bad rows equal the reference's text.

The rest pins the port's own contracts, each named after the reference
test it mirrors (`tests/test_serving_latency.py`, `tests/test_io_http.py`):
the plan cache (one miss per distinct bucket, single-flight builds, LRU
eviction), per-row 400s, continuous mode and linger, epoch replay, 503
shedding and graceful drain. No rate or latency floor is asserted.
`device.exact_f32`'s scope is held across two interleaved threads.
"""
import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import Table as RefTable
from mmlspark_tpu.io import plan as ref_plan
from mmlspark_tpu.io import serving as ref_serving
from mmlspark_tpu.models.dnn import transformer as ref_tr
from mmlspark_tpu.models.gbdt.estimators import GBDTClassifier as RefGBDT
from mmlspark_tpu.stages import batching as ref_batching
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.device import exact_f32
from mmlspark_tpu_torch.io import plan, serving
from mmlspark_tpu_torch.models.dnn import transformer as port_tr
from mmlspark_tpu_torch.models.dnn.model import DNNModel
from mmlspark_tpu_torch.models.gbdt.convert import booster_from_reference
from mmlspark_tpu_torch.models.gbdt.estimators import (
    GBDTClassificationModel, GBDTClassifier)
from mmlspark_tpu_torch.reliability.faults import FaultInjector
from mmlspark_tpu_torch.reliability.metrics import reliability_metrics
from mmlspark_tpu_torch.stages import batching
from mmlspark_tpu_torch.telemetry import lineage, quality

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

TRANSPORTS = ("selector", "threading")
# the reference's scoring_plan-vs-raw_score tolerance (Queue 3 (d))
_RAW_TOL = 1e-6
_PROBA_TOL = 1e-6
_EMB_TOL = 1e-5
_N_ROWS = 64
_ENC = dict(input_col="text", output_col="emb", d_model=32, n_heads=4,
            n_layers=2, d_ff=64, max_len=64)


@pytest.fixture(autouse=True)
def serving_state():
    """Fresh port metrics, quality monitor and version registry."""
    reliability_metrics.reset()
    quality.reset_monitor()
    lineage.reset_version_registry()
    yield
    lineage.reset_version_registry()
    quality.reset_monitor()
    reliability_metrics.reset()


def _start(pkg_serving, pkg_plan, model, cols, output_col="prediction",
           transport="selector", **kw):
    """serve_pipeline on the selector transport; the same composition by
    hand on the threading one (serve_pipeline takes no transport)."""
    if transport == "selector":
        return pkg_serving.serve_pipeline(model, cols, output_col=output_col,
                                          **kw)
    server = pkg_serving.ServingServer(
        transport="threading",
        num_partitions=kw.pop("num_partitions", 1)).start()
    try:
        transform = pkg_plan.compile_serving_transform(model, cols,
                                                       output_col)
        q = pkg_serving.ServingQuery(server, transform, **kw).start()
    except BaseException:
        server.stop(drain=False)
        raise
    return server, q


@pytest.fixture
def running():
    """Starts servers and queries; stops every one of them afterwards."""
    started = []

    def start(*args, **kw):
        server, q = _start(*args, **kw)
        started.append((server, q))
        return server, q

    def add(server, q):
        started.append((server, q))
        return server, q

    start.add = add
    yield start
    for server, q in reversed(started):
        if q is not None:
            q.stop()
        try:
            server.stop(drain=False)
        except (OSError, AttributeError, ValueError):
            pass   # already stopped by the test


def _post(url, obj, timeout=10):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _post_all(address, bodies, timeout=10):
    """Each body POSTed in turn on one keep-alive connection (reopened
    when the transport closes it): [(status, payload)]."""
    host, port = address[len("http://"):].rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    out = []
    try:
        for b in bodies:
            conn.request("POST", "/", body=b)
            resp = conn.getresponse()
            out.append((resp.status, resp.read()))
    finally:
        conn.close()
    return out


# ------------------------------------------------------------- the models
@pytest.fixture(scope="module")
def gbdt_pair():
    """A reference GBDTClassifier fit on seeded rows, and the port's model
    of the same booster (and the same fit-time quality profile)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1000, 8)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float32)
    ref = RefGBDT(num_iterations=5, max_depth=3).fit(
        RefTable({"features": x, "label": y}))
    port = GBDTClassificationModel(
        booster=booster_from_reference(ref.booster.to_dict()),
        init_score=float(ref._init_score), n_classes=2, device="cpu")
    port.quality_profile = getattr(ref, "quality_profile", None)
    rows = np.random.default_rng(1).normal(size=(_N_ROWS, 8)).astype(
        np.float32)
    return ref, port, rows


def _fit_port_gbdt(n=2000, f=8, seed=0, **kw):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float32)
    kw.setdefault("num_iterations", 5)
    kw.setdefault("max_depth", 3)
    return GBDTClassifier(device="cpu", **kw).fit(
        Table({"features": x, "label": y}))


@pytest.fixture(scope="module")
def port_gbdt():
    return _fit_port_gbdt()


def _linear_dnn(width=4, out=1):
    """A DNNModel without a serving kernel: the generic Table plan."""
    rng = np.random.default_rng(3)
    params = {"w": rng.normal(size=(width, out)).astype(np.float32),
              "b": rng.normal(size=(out,)).astype(np.float32)}
    return DNNModel(apply_fn=lambda p, xb: xb @ p["w"] + p["b"],
                    params=params, input_col="features",
                    output_col="scores", batch_size=8, device="cpu")


# ------------------------------------------------------- exact_f32 threads
def test_exact_f32_is_safe_across_threads():
    """Thread A enters, thread B enters, A leaves: B still reads TF32 off,
    and after both leave the flag is back to what A found."""
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    cudnn.allow_tf32 = True
    seen = []
    a_in, b_in, a_out = threading.Event(), threading.Event(), \
        threading.Event()

    def a():
        with exact_f32():
            seen.append(("a inside", cudnn.allow_tf32))
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def b():
        a_in.wait(10)
        with exact_f32():
            seen.append(("b inside", cudnn.allow_tf32))
            b_in.set()
            a_out.wait(10)
            seen.append(("b after a left", cudnn.allow_tf32))

    threads = [threading.Thread(target=f, daemon=True) for f in (a, b)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=10)
        assert [s for s, _ in seen] == ["a inside", "b inside",
                                        "b after a left"], seen
        assert all(v is False for _, v in seen), seen
        assert cudnn.allow_tf32 is True
        with exact_f32():
            with exact_f32():   # nested on one thread
                assert cudnn.allow_tf32 is False
            assert cudnn.allow_tf32 is False
        assert cudnn.allow_tf32 is True
    finally:
        cudnn.allow_tf32 = before


# ------------------------------------------------- parity with the reference
@pytest.mark.parametrize("output_col",
                         ["prediction", "probabilities", "raw_prediction"])
@pytest.mark.parametrize("transport", TRANSPORTS)
def test_gbdt_served_equals_reference(gbdt_pair, running, transport,
                                      output_col):
    ref, port, rows = gbdt_pair
    bodies = [json.dumps({"features": r.tolist()}).encode() for r in rows]
    got_server, _ = running(serving, plan, port, ["features"], output_col,
                            transport)
    want_server, _ = running(ref_serving, ref_plan, ref, ["features"],
                             output_col, transport)
    got = _post_all(got_server.address, bodies)
    want = _post_all(want_server.address, bodies)
    assert [s for s, _ in got] == [200] * _N_ROWS, got[:2]
    assert [s for s, _ in want] == [200] * _N_ROWS, want[:2]
    g = np.asarray([json.loads(p)[output_col] for _, p in got], np.float64)
    w = np.asarray([json.loads(p)[output_col] for _, p in want], np.float64)
    assert g.shape == w.shape
    if output_col == "prediction":
        np.testing.assert_array_equal(g, w)
        assert 0 < g.sum() < _N_ROWS   # both classes are answered
    elif output_col == "probabilities":
        np.testing.assert_allclose(g, w, rtol=0, atol=_PROBA_TOL)
    else:
        np.testing.assert_allclose(g, w, rtol=_RAW_TOL, atol=_RAW_TOL)
    # the port's reply equals its own offline transform
    offline = port.transform(Table({"features": rows}))[output_col]
    np.testing.assert_allclose(g, np.asarray(offline, np.float64).reshape(
        g.shape), rtol=_RAW_TOL, atol=_RAW_TOL)


@pytest.fixture(scope="module")
def encoder_pair():
    tree = ref_tr.init_transformer(1 << 14, _ENC["d_model"], _ENC["n_heads"],
                                   _ENC["n_layers"], _ENC["d_ff"],
                                   _ENC["max_len"], 7)
    numpy_tree = _as_numpy(tree)
    ref = ref_tr.TransformerSentenceEncoder(**_ENC).set_params_tree(tree)
    port = port_tr.TransformerSentenceEncoder(**_ENC, device="cpu")
    port.set_params_tree(numpy_tree)
    rng = np.random.default_rng(2)
    words = ["w%d" % i for i in range(300)]
    docs = [" ".join(rng.choice(words, size=int(rng.integers(3, 17))))
            for _ in range(12)]
    return ref, port, docs


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: v if k == "meta" else _as_numpy(v)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_numpy(v) for v in tree]
    return np.asarray(tree)


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_encoder_served_equals_reference(encoder_pair, running, transport):
    ref, port, docs = encoder_pair
    bodies = [json.dumps({"text": d}).encode() for d in docs]
    got_server, _ = running(serving, plan, port, ["text"], "emb", transport)
    want_server, _ = running(ref_serving, ref_plan, ref, ["text"], "emb",
                             transport)
    got = _post_all(got_server.address, bodies)
    want = _post_all(want_server.address, bodies)
    assert [s for s, _ in got] == [200] * len(docs)
    assert [s for s, _ in want] == [200] * len(docs)
    g = np.asarray([json.loads(p)["emb"] for _, p in got])
    w = np.asarray([json.loads(p)["emb"] for _, p in want])
    assert g.shape == (len(docs), _ENC["d_model"])
    np.testing.assert_allclose(g, w, rtol=0, atol=_EMB_TOL)


def test_error_bodies_match_reference(gbdt_pair):
    """A bad row answers 400 alone with the reference's error text."""
    ref, port, rows = gbdt_pair
    good = json.dumps({"features": rows[0].tolist()}).encode()
    bodies = [good, b"{not json", b"[1, 2]", json.dumps({"x": 1}).encode(),
              json.dumps({"features": [1.0, 2.0]}).encode(),
              json.dumps({"features": "hello"}).encode(), good]
    got = plan.compile_serving_transform(port, ["features"])(bodies)
    want = ref_plan.compile_serving_transform(ref, ["features"])(bodies)
    assert [r.status for r in got] == [200, 400, 400, 400, 400, 400, 200]
    assert [r.status for r in got] == [r.status for r in want]
    for g, w in zip(got, want):
        assert g.data == w.data
        assert g.content_type == w.content_type


def test_shape_bucket_and_padding_equal_reference():
    rng = np.random.default_rng(4)
    for n in [0, 1, 2, 3, 5, 64, 65, 100, 4096, 5000,
              *rng.integers(1, 10_000, size=20).tolist()]:
        for cap in (64, 4096, 1 << 20):
            assert batching.shape_bucket(int(n), cap) == \
                ref_batching.shape_bucket(int(n), cap)
    for n, bucket in ((1, 1), (3, 4), (5, 8), (8, 8), (9, 8)):
        a = rng.normal(size=(n, 3)).astype(np.float32)
        np.testing.assert_array_equal(batching.pad_rows_to_bucket(a, bucket),
                                      ref_batching.pad_rows_to_bucket(
                                          a, bucket))
    text = np.array(["a", "bb", "ccc"])
    np.testing.assert_array_equal(batching.pad_rows_to_bucket(text, 4),
                                  ref_batching.pad_rows_to_bucket(text, 4))


def test_minibatch_transformers_equal_reference():
    rng = np.random.default_rng(5)
    cols = {"x": rng.normal(size=(11, 2)).astype(np.float32),
            "t": np.sort(rng.uniform(0, 3, size=11))}
    cases = [("FixedMiniBatchTransformer", dict(batch_size=4)),
             ("FixedMiniBatchTransformer", dict(batch_size=4,
                                               pad_last_batch=True)),
             ("DynamicMiniBatchTransformer", dict(max_batch_size=5)),
             ("TimeIntervalMiniBatchTransformer",
              dict(interval_ms=1000, timestamp_col="t"))]
    for name, kw in cases:
        got = getattr(batching, name)(**kw).transform(Table(dict(cols)))
        want = getattr(ref_batching, name)(**kw).transform(
            RefTable(dict(cols)))
        assert len(got) == len(want), name
        for c in cols:
            for g, w in zip(got[c], want[c]):
                np.testing.assert_array_equal(g, w)
        flat = batching.FlattenBatch().transform(got)
        ref_flat = ref_batching.FlattenBatch().transform(want)
        for c in cols:
            np.testing.assert_array_equal(flat[c], ref_flat[c])


# ------------------------------------------------------------- plan cache
def test_plan_cache_zero_recompiles_same_bucket(port_gbdt):
    transform = plan.compile_serving_transform(port_gbdt, ["features"])
    body = json.dumps({"features": [0.1] * 8}).encode()
    for _ in range(10):
        replies = transform([body] * 3)       # bucket 4 every time
        assert all(isinstance(r, serving.Reply) and r.status == 200
                   for r in replies)
    stats = transform.stats()
    assert stats["hits"] == 9 and stats["misses"] == 1, stats
    assert stats["buckets"] == 1 and stats["evictions"] == 0, stats
    transform([body] * 7)                     # bucket 8
    transform([body] * 5)                     # bucket 8 again -> hit
    stats = transform.stats()
    assert stats["misses"] == 2 and stats["buckets"] == 2, stats


def test_plan_cache_misses_equal_distinct_buckets():
    """Misses equal the number of distinct buckets for a Table plan too,
    and every build is recorded once as a plan.compile."""
    from mmlspark_tpu_torch.telemetry import perf
    model = _linear_dnn()
    transform = plan.compile_serving_transform(model, ["features"],
                                               output_col="scores")
    rng = np.random.default_rng(6)
    sizes = [1, 2, 3, 4, 5, 8, 9, 3, 1, 16, 7]
    before = perf.compile_stats()["compiles"]
    for n in sizes:
        rows = rng.normal(size=(n, 4)).tolist()
        replies = transform([json.dumps({"features": r}).encode()
                             for r in rows])
        assert [r.status for r in replies] == [200] * n
    buckets = {batching.shape_bucket(n) for n in sizes}
    stats = transform.stats()
    assert stats["misses"] == len(buckets), stats
    assert stats["hits"] == len(sizes) - len(buckets), stats
    assert perf.compile_stats()["compiles"] - before == len(buckets)
    assert reliability_metrics.get("serving.plan.misses") == len(buckets)


def test_plan_cache_counters_in_metrics(port_gbdt):
    transform = plan.compile_serving_transform(port_gbdt, ["features"])
    body = json.dumps({"features": [0.2] * 8}).encode()
    for _ in range(4):
        transform([body])
    snap = reliability_metrics.snapshot()
    assert snap.get("serving.plan.misses") == 1, snap
    assert snap.get("serving.plan.hits") == 3, snap


def test_plan_cache_miss_stampede_single_flight(port_gbdt):
    transform = plan.compile_serving_transform(port_gbdt, ["features"])
    builds = []
    in_build = threading.Event()
    release = threading.Event()
    real_build = transform._build_plan

    def slow_build(bucket, handle=None):
        builds.append(bucket)
        in_build.set()
        assert release.wait(10), "test orchestration stalled"
        return real_build(bucket, handle)

    transform._build_plan = slow_build
    plans = []
    threads = [threading.Thread(
        target=lambda: plans.append(transform._plan_for(3)), daemon=True)
        for _ in range(2)]
    threads[0].start()
    assert in_build.wait(10)
    threads[1].start()
    time.sleep(0.05)
    release.set()
    for th in threads:
        th.join(timeout=10)
    assert len(plans) == 2
    assert plans[0] is plans[1]
    assert builds == [4]
    stats = transform.stats()
    assert stats["misses"] == 1 and stats["hits"] == 1, stats


def test_plan_build_failure_not_cached(port_gbdt):
    transform = plan.compile_serving_transform(port_gbdt, ["features"])
    real_build = transform._build_plan
    calls = []

    def failing_once(bucket, handle=None):
        calls.append(bucket)
        if len(calls) == 1:
            raise RuntimeError("transient build failure")
        return real_build(bucket, handle)

    transform._build_plan = failing_once
    with pytest.raises(RuntimeError, match="transient"):
        transform._plan_for(3)
    built = transform._plan_for(3)
    assert built is transform._plan_for(3)
    assert len(calls) == 2
    assert not transform._building


def test_plan_cache_lru_eviction(port_gbdt):
    """A bounded cache evicts the least recently used bucket; an evicted
    key rebuilds on its next use and counts as a recompile."""
    from mmlspark_tpu_torch.telemetry import perf
    transform = plan.compile_serving_transform(port_gbdt, ["features"],
                                               max_plans=2)
    body = json.dumps({"features": [0.3] * 8}).encode()
    for n in (1, 2, 4):      # buckets 1, 2, 4: the first is evicted
        transform([body] * n)
    before = perf.compile_stats()["recompiles"]
    transform([body])        # bucket 1 again: rebuilt
    stats = transform.stats()
    assert stats["evictions"] == 2 and stats["buckets"] == 2, stats
    assert stats["misses"] == 4, stats
    assert reliability_metrics.get("serving.plan.evictions") == 2
    assert perf.compile_stats()["recompiles"] - before == 1


def test_fingerprint_distinguishes_models():
    a = _fit_port_gbdt(num_iterations=5)
    b = _fit_port_gbdt(num_iterations=6)
    assert plan.pipeline_fingerprint(a) != plan.pipeline_fingerprint(b)
    assert plan.pipeline_fingerprint(a) == plan.pipeline_fingerprint(a)
    c = _fit_port_gbdt(num_iterations=5, seed=1)
    assert plan.pipeline_fingerprint(a, content=True) != \
        plan.pipeline_fingerprint(c, content=True)


def test_fingerprint_hashes_tensor_state(encoder_pair):
    """A stage whose state is tensors (the encoder's weights) digests by
    shape, or by content with content=True."""
    _, port, _ = encoder_pair
    other = port_tr.TransformerSentenceEncoder(**_ENC, device="cpu")
    assert plan.pipeline_fingerprint(port) == plan.pipeline_fingerprint(
        other)
    assert plan.pipeline_fingerprint(port, content=True) != \
        plan.pipeline_fingerprint(other, content=True)


def test_serving_kernel_matches_transform():
    model = _fit_port_gbdt(num_iterations=10, max_depth=4)
    x = np.random.default_rng(1).normal(size=(33, 8)).astype(np.float32)
    out = model.transform(Table({"features": x}))
    kern = model._serving_kernel("prediction")
    assert kern is not None and kern.expected_features == 8
    np.testing.assert_array_equal(kern(x), np.asarray(out["prediction"]))
    np.testing.assert_allclose(model._serving_kernel("probabilities")(x),
                               np.asarray(out["probabilities"]),
                               rtol=1e-6, atol=1e-6)
    assert model._serving_kernel("no_such_col") is None


def test_regressor_and_ranker_kernels_match_transform():
    from mmlspark_tpu_torch.models.gbdt.estimators import (GBDTRanker,
                                                           GBDTRegressor)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(600, 5)).astype(np.float32)
    y = (x[:, 0] * 2 + rng.normal(size=600) * 0.1).astype(np.float32)
    for est, extra in ((GBDTRegressor(objective="poisson"), {}),
                       (GBDTRegressor(), {}),
                       (GBDTRanker(), {"group": np.repeat(np.arange(60),
                                                          10)})):
        if extra:
            label = np.clip(np.round(y), 0, 4)
        elif est.get_or_default("objective") == "poisson":
            label = np.exp(y / 4)
        else:
            label = y
        est.set(num_iterations=4, max_depth=3, device="cpu")
        model = est.fit(Table({"features": x, "label": label, **extra}))
        kern = model._serving_kernel("prediction")
        np.testing.assert_allclose(
            kern(x), np.asarray(model.transform(
                Table({"features": x}))["prediction"]),
            rtol=1e-5, atol=1e-5)
        assert model._serving_kernel("probabilities") is None


def test_generic_plan_pads_and_slices():
    """A model without a serving kernel pads to the bucket and slices:
    5 rows (bucket 8) answer what an unpadded transform gives."""
    model = _linear_dnn()
    transform = plan.compile_serving_transform(model, ["features"],
                                               output_col="scores")
    x = np.random.default_rng(8).normal(size=(5, 4)).astype(np.float32)
    replies = transform([json.dumps({"features": r.tolist()}).encode()
                         for r in x])
    got = np.asarray([json.loads(r.data)["scores"] for r in replies])
    want = model.transform(Table({"features": x}))["scores"]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert transform.stats()["misses"] == 1


def test_single_stage_pipeline_serves_through_its_stage(port_gbdt):
    from mmlspark_tpu_torch.core import PipelineModel
    transform = plan.compile_serving_transform(
        PipelineModel(stages=[port_gbdt]), ["features"])
    assert transform._handle.kernel is not None
    assert transform.model is port_gbdt


class _PairModel:
    """A model whose serving kernel takes hashed (idx, val) pair columns:
    a weighted sum of the values at their indices."""
    weights = np.linspace(-1.0, 1.0, 64).astype(np.float32)

    def _serving_kernel(self, output_col):
        w = self.weights

        def kern(idx, val):
            return (w[idx] * val).sum(axis=1).astype(np.float64)
        kern.sparse_pairs = True
        return kern


class _IdModel:
    """A model whose serving kernel resolves integer row ids."""
    table = np.arange(100, dtype=np.float64) ** 2

    def _serving_kernel(self, output_col):
        def kern(ids):
            return self.table[ids]
        kern.row_ids = True
        return kern


def test_sparse_pair_and_id_plans_equal_reference():
    """The sparse-pair plan (rows and pairs per row bucketed, padded with
    zero pairs) and the id-keyed plan answer as the reference's, bad rows
    included."""
    rng = np.random.default_rng(14)
    pairs = []
    for _ in range(9):
        k = int(rng.integers(1, 12))
        pairs.append({"f_idx": rng.integers(0, 64, size=k).tolist(),
                      "f_val": rng.normal(size=k).round(3).tolist()})
    pairs.append({"f_idx": [1, 2], "f_val": [1.0]})          # ragged: 400
    ids = [{"user": int(i)} for i in rng.integers(0, 100, size=6)]
    ids.append({"user": 1.5})                                # not an id
    for model, cols, rows in ((_PairModel(), ["f_idx", "f_val"], pairs),
                              (_IdModel(), ["user"], ids)):
        bodies = [json.dumps(r).encode() for r in rows]
        got = plan.compile_serving_transform(model, cols)(bodies)
        want = ref_plan.compile_serving_transform(model, cols)(bodies)
        assert [r.status for r in got] == [r.status for r in want]
        assert [r.status for r in got].count(400) == 1
        for g, w in zip(got, want):
            assert g.data == w.data


# --------------------------------------------------- per-row 400 isolation
def test_bad_value_row_isolated_without_replay(port_gbdt):
    transform = plan.compile_serving_transform(port_gbdt, ["features"])
    good = json.dumps({"features": [0.5] * 8}).encode()
    replies = transform([good,
                         json.dumps({"features": "hello"}).encode(),
                         json.dumps({"features": [1.0, 2.0]}).encode(),
                         good])
    assert replies[0].status == 200 and replies[3].status == 200
    assert replies[1].status == 400
    assert replies[2].status == 400


def test_mutually_ragged_rows_isolated_without_replay():
    class WidthAgnostic:
        def transform(self, t):
            x = np.asarray(t["features"])
            return Table({"prediction": x.sum(axis=1)})

    transform = plan.compile_serving_transform(WidthAgnostic(),
                                               ["features"])
    replies = transform([json.dumps({"features": [1.0, 2.0]}).encode(),
                         json.dumps({"features": [1.0, 2.0, 3.0]}).encode()])
    assert [r.status for r in replies] == [200, 200]
    assert json.loads(replies[0].data)["prediction"] == 3.0
    assert json.loads(replies[1].data)["prediction"] == 6.0


def test_nonfinite_prediction_encodes_like_legacy():
    model = DNNModel(apply_fn=lambda p, xb: xb.sum(dim=1), params={},
                     input_col="features", output_col="prediction",
                     batch_size=4, device="cpu")
    transform = plan.compile_serving_transform(model, ["features"])
    replies = transform([
        json.dumps({"features": [float("nan"), 0.0]}).encode(),
        json.dumps({"features": [1.0, 1.0]}).encode()])
    out = json.loads(replies[0].data)
    assert out["prediction"] != out["prediction"]
    assert json.loads(replies[1].data)["prediction"] == 2.0


def test_server_fault_is_not_blamed_on_client(port_gbdt):
    transform = plan.compile_serving_transform(port_gbdt, ["features"],
                                               output_col="no_such_col")
    good = json.dumps({"features": [0.5] * 8}).encode()
    with pytest.raises(KeyError):
        transform([good])


def test_malformed_json_row_gets_400_alone(port_gbdt):
    transform = plan.compile_serving_transform(port_gbdt, ["features"])
    good = json.dumps({"features": [0.5] * 8}).encode()
    replies = transform([good, b"{not json", good,
                         json.dumps({"wrong": 1}).encode()])
    assert replies[0].status == 200 and replies[2].status == 200
    assert replies[1].status == 400
    assert replies[3].status == 400
    assert "features" in replies[3].data["error"]


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_malformed_json_400_over_http_batchmates_unaffected(
        port_gbdt, running, transport):
    server, _ = running(serving, plan, port_gbdt, ["features"],
                        transport=transport, max_batch=8)
    results = {}

    def send(key, payload: bytes):
        req = urllib.request.Request(server.address, data=payload,
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                results[key] = ("ok", r.status, json.loads(r.read()))
        except urllib.error.HTTPError as e:
            results[key] = ("err", e.code, json.loads(e.read()))

    threads = [threading.Thread(target=send, args=(k, p), daemon=True)
               for k, p in [
                   ("a", json.dumps({"features": [1.0] * 8}).encode()),
                   ("bad", b"][ definitely not json"),
                   ("b", json.dumps({"features": [-1.0] * 8}).encode())]]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert results["a"][:2] == ("ok", 200)
    assert results["b"][:2] == ("ok", 200)
    assert results["bad"][:2] == ("err", 400)
    assert "bad request" in results["bad"][2]["error"]


# ------------------------------------------------- micro-batching modes
def test_continuous_mode_batches_of_one(running):
    server = serving.ServingServer(num_partitions=1).start()
    sizes = []

    def transform(bodies):
        sizes.append(len(bodies))
        return [{"ok": 1}] * len(bodies)

    q = serving.ServingQuery(server, transform, mode="continuous",
                             poll_timeout=0.005).start()
    running.add(server, q)
    for i in range(5):
        assert _post(server.address, {"x": i}) == {"ok": 1}
    assert sizes and all(s == 1 for s in sizes), sizes


def test_linger_coalesces_concurrent_requests(running):
    server = serving.ServingServer(num_partitions=1).start()
    sizes = []

    def transform(bodies):
        sizes.append(len(bodies))
        return [{"ok": 1}] * len(bodies)

    q = serving.ServingQuery(server, transform, mode="microbatch",
                             max_batch=4, batch_linger_ms=2000.0,
                             poll_timeout=0.005).start()
    running.add(server, q)
    results = []
    threads = [threading.Thread(
        target=lambda i=i: results.append(_post(server.address, {"x": i})),
        daemon=True) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert len(results) == 4
    assert sum(sizes) == 4
    assert len(sizes) <= 2, sizes


def test_linger_zero_drains_only_whats_queued(running):
    server = serving.ServingServer(num_partitions=1).start()
    sizes = []

    def transform(bodies):
        sizes.append(len(bodies))
        return [{"ok": 1}] * len(bodies)

    q = serving.ServingQuery(server, transform, mode="microbatch",
                             max_batch=8, poll_timeout=0.05)
    running.add(server, q)
    results = []
    threads = [threading.Thread(
        target=lambda i=i: results.append(_post(server.address, {"x": i})),
        daemon=True) for i in range(3)]
    for th in threads:
        th.start()
    time.sleep(0.3)   # all three enqueue before the workers exist
    q.start()
    for th in threads:
        th.join(timeout=10)
    assert len(results) == 3
    assert sizes[0] == 3, sizes


def test_continuous_rejects_linger(running):
    server = serving.ServingServer(num_partitions=1).start()
    running.add(server, None)
    q = serving.ServingQuery(server, lambda b: b, mode="continuous",
                             batch_linger_ms=50.0)
    assert q.batch_linger_ms == 0.0
    with pytest.raises(ValueError):
        serving.ServingQuery(server, lambda b: b, batch_linger_ms=-1.0)


def test_admission_names_its_item():
    """`admission=` is ported (`control.actuators.BurnAwareAdmission`):
    both entry points mount the controller; the shedding itself is held
    in tests/test_torch_control.py."""
    from mmlspark_tpu_torch.control import BurnAwareAdmission
    adm = BurnAwareAdmission(verdict_fn=lambda: None)
    server = serving.ServingServer(admission=adm)
    assert server.admission is adm
    assert serving.ServingServer().admission is None


def test_serving_request_metrics_present_and_monotonic(port_gbdt, running):
    server, q = running(serving, plan, port_gbdt, ["features"])
    n = 12
    for i in range(n):
        _post(server.address, {"features": [0.1 * i] * 8})
    q.stop()
    server.stop()
    snap = reliability_metrics.snapshot()
    for stage in ("queue", "transform", "reply", "e2e"):
        assert snap.get(f"serving.request.{stage}.count", 0) > 0, stage
        p50 = snap[f"serving.request.{stage}.p50"]
        p95 = snap[f"serving.request.{stage}.p95"]
        p99 = snap[f"serving.request.{stage}.p99"]
        assert 0.0 <= p50 <= p95 <= p99, (stage, p50, p95, p99)
    assert snap["serving.request.e2e.count"] == n
    assert snap["serving.request.total"] == n
    assert "serving.queue_depth" in snap
    assert "serving.batch.occupancy" in snap
    assert reliability_metrics.percentile("serving.request.e2e", 50.0) \
        == snap["serving.request.e2e.p50"]


# ------------------------------------------------- replay, shedding, drain
def test_epoch_replay_preserved_on_fast_path(port_gbdt, running):
    server, q = running(serving, plan, port_gbdt, ["features"])
    q.inject_fault(0)
    want = float(port_gbdt.transform(Table(
        {"features": np.ones((1, 8), np.float32)}))["prediction"][0])
    assert _post(server.address, {"features": [1.0] * 8}) == \
        {"prediction": want}
    assert q._recoveries >= 1


def test_serving_fault_tolerance(running):
    server = serving.ServingServer(num_partitions=1, reply_timeout=10).start()
    q = serving.ServingQuery(server, lambda bodies: [
        {"ok": json.loads(b)["v"]} for b in bodies])
    running.add(server, q)
    q.inject_fault(0)
    q.start()
    assert _post(server.address, {"v": 99}) == {"ok": 99}
    assert q._recoveries >= 1


def test_serving_replay_on_worker_death(running):
    inj = FaultInjector(seed=77, rules=[
        {"site": "serving.worker", "kind": "crash", "at": [0]}])
    server = serving.ServingServer(num_partitions=1, reply_timeout=10,
                                   faults=inj).start()
    commits = []
    real_commit = server.commit
    server.commit = lambda epoch, pid: (commits.append((epoch, pid)),
                                        real_commit(epoch, pid))
    calls = []

    def transform(bodies):
        calls.append(len(bodies))
        return [{"ok": json.loads(b)["v"]} for b in bodies]

    q = serving.ServingQuery(server, transform, poll_timeout=0.005,
                             watchdog_interval=0.01).start()
    running.add(server, q)
    assert _post(server.address, {"v": 7}) == {"ok": 7}
    time.sleep(0.05)
    assert q._restarts >= 1
    assert inj.schedule() == [("serving.worker", 0, "crash")]
    assert reliability_metrics.get("serving.worker_restarts") >= 1
    assert reliability_metrics.get("serving.replayed_epochs") >= 1
    assert calls == [1]
    epochs = [e for e, _ in commits]
    assert len(epochs) == len(set(epochs))
    assert server.reply_to("no-such-request", {"x": 1}) is False


def test_poison_row_isolated_from_batch(running):
    server = serving.ServingServer(num_partitions=1, reply_timeout=10).start()

    def transform(bodies):
        rows = [json.loads(b) for b in bodies]
        if any(r.get("poison") for r in rows) and len(rows) > 1:
            raise ValueError("batch blew up")
        if rows and rows[0].get("poison"):
            raise ValueError("poison row")
        return [{"ok": r["v"]} for r in rows]

    q = serving.ServingQuery(server, transform, max_batch=8,
                             poll_timeout=1.0)
    running.add(server, q)
    results = {}

    def send(key, payload):
        try:
            results[key] = ("ok", _post(server.address, payload))
        except urllib.error.HTTPError as e:
            results[key] = ("err", e.code, json.loads(e.read()))

    threads = [threading.Thread(target=send, args=(k, p), daemon=True)
               for k, p in [("a", {"v": 1}), ("bad", {"poison": True}),
                            ("b", {"v": 2})]]
    for th in threads:
        th.start()
    time.sleep(0.3)
    q.start()
    for th in threads:
        th.join(timeout=10)
    assert results["a"] == ("ok", {"ok": 1})
    assert results["b"] == ("ok", {"ok": 2})
    kind, code, body = results["bad"]
    assert kind == "err" and code == 502
    assert "poison" in body["error"]


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_serving_load_shedding_503(running, transport):
    server = serving.ServingServer(num_partitions=1, max_queue=1,
                                   reply_timeout=2,
                                   transport=transport).start()
    running.add(server, None)
    results = []

    def client(i):
        try:
            results.append(("ok", _post(server.address, {"v": i},
                                        timeout=6)))
        except urllib.error.HTTPError as e:
            results.append(("http", e.code))
        except OSError as e:
            results.append(("err", type(e).__name__))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(5)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    shed = [r for r in results if r == ("http", 503)]
    assert shed, results
    assert reliability_metrics.get("serving.shed_requests") >= len(shed)


def test_serving_graceful_drain(running):
    server = serving.ServingServer(num_partitions=1, reply_timeout=10).start()

    def slow_transform(bodies):
        time.sleep(0.15)   # hold the request in flight across stop()
        return [{"ok": json.loads(b)["v"]} for b in bodies]

    q = serving.ServingQuery(server, slow_transform,
                             poll_timeout=0.005).start()
    running.add(server, q)
    addr = server.address
    inflight = {}

    def client():
        try:
            inflight["out"] = _post(addr, {"v": 5})
        except (OSError, ValueError) as e:
            inflight["err"] = e

    th = threading.Thread(target=client, daemon=True)
    th.start()
    time.sleep(0.05)
    server.stop()
    th.join(timeout=10)
    q.stop()
    assert inflight.get("out") == {"ok": 5}, inflight
    with pytest.raises(OSError):
        _post(addr, {"v": 6}, timeout=2)


def test_serving_epoch_commit_gc(running):
    server = serving.ServingServer(num_partitions=1).start()
    q = serving.ServingQuery(server, lambda bodies: [{} for _ in bodies])
    running.add(server, q)
    q.start()
    _post(server.address, {"a": 1})
    deadline = time.monotonic() + 5
    while server._history and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not server._history


def test_drain_on_signal_drains_then_stops(running):
    import signal
    server = serving.ServingServer(num_partitions=1).start()
    q = serving.ServingQuery(server, lambda b: [{"ok": 1}] * len(b)).start()
    running.add(server, q)
    assert _post(server.address, {"x": 1}) == {"ok": 1}
    previous = signal.getsignal(signal.SIGTERM)
    try:
        handler = serving.drain_on_signal(servers=[server], queries=[q],
                                          signals=(signal.SIGTERM,),
                                          exit_code=None)
        handler()
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert reliability_metrics.get("serving.signal_drains") == 1
    with pytest.raises(OSError):
        _post(server.address, {"x": 2}, timeout=2)


# ------------------------------------------------- stages on two partitions
def test_dnn_model_served_on_two_partitions(running):
    """A DNNModel scored by two partition workers at once: every reply
    equals the offline transform of its row."""
    model = _linear_dnn(width=4, out=3)
    server, _ = running(serving, plan, model, ["features"], "scores",
                        num_partitions=2, max_batch=4)
    x = np.random.default_rng(9).normal(size=(24, 4)).astype(np.float32)
    want = model.transform(Table({"features": x}))["scores"]
    got = {}

    def client(lo):
        bodies = [json.dumps({"features": r.tolist()}).encode()
                  for r in x[lo:lo + 6]]
        for i, (status, payload) in enumerate(_post_all(server.address,
                                                        bodies)):
            got[lo + i] = (status, json.loads(payload)["scores"])

    threads = [threading.Thread(target=client, args=(lo,), daemon=True)
               for lo in range(0, 24, 6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert sorted(got) == list(range(24))
    assert all(s == 200 for s, _ in got.values())
    np.testing.assert_allclose(np.asarray([got[i][1] for i in range(24)]),
                               want, rtol=1e-6, atol=1e-6)
