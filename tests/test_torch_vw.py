"""Port parity: Vowpal Wabbit (`models/vw`: featurizer, learner,
estimators, the sparse-pair serving kernel).

The same seeded arrays go through both packages, JAX on the CPU and the
port with `device="cpu"`. The JAX side runs on the tests' 8-device CPU
mesh, so every parity fit passes `num_tasks` explicitly, as the
reference's own tests do. Tolerances:
- the featurizer's and the interactions' `_idx`/`_val` columns are
  bit-equal to the reference's;
- `fit_vw` weights and bias within `_RTOL` of the reference's largest
  weight (sgd, adaptive, l1; both losses), `_BFGS_RTOL` for BFGS (its
  line search and two-loop dot products add in another order), and the
  same for `num_tasks=2` against the reference's `shard_map` form; the
  reported losses within rtol 1e-5 (1e-4 for BFGS);
- a bandit's `parallel_fit` bit-equal to its sequential fits;
- `vw_from_reference` probabilities within 1e-6 and labels equal (the
  reference gathers and sums in XLA's order, the port in torch's);
- a saved model loaded in a fresh process scores bit-equal.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import Table as RefTable
from mmlspark_tpu.models.vw import VowpalWabbitClassifier as RefClassifier
from mmlspark_tpu.models.vw import \
    VowpalWabbitContextualBandit as RefBandit
from mmlspark_tpu.models.vw import VowpalWabbitFeaturizer as RefFeaturizer
from mmlspark_tpu.models.vw import \
    VowpalWabbitInteractions as RefInteractions
from mmlspark_tpu.models.vw import VowpalWabbitRegressor as RefRegressor
from mmlspark_tpu.models.vw import learner as ref_learner
from mmlspark_tpu_torch.core import Pipeline, Table
from mmlspark_tpu_torch.models.vw import (VowpalWabbitClassificationModel,
                                          VowpalWabbitClassifier,
                                          VowpalWabbitContextualBandit,
                                          VowpalWabbitFeaturizer,
                                          VowpalWabbitInteractions,
                                          VowpalWabbitRegressor,
                                          vw_from_reference)
from mmlspark_tpu_torch.models.vw import learner
from mmlspark_tpu_torch.telemetry import lineage, quality

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RTOL = 2e-5
_BFGS_RTOL = 1e-4
_PROBA_TOL = 1e-6


@pytest.fixture(autouse=True)
def vw_state():
    quality.reset_monitor()
    lineage.reset_version_registry()
    lineage.configure_run_ledger(None)
    yield
    lineage.configure_run_ledger(None)
    lineage.reset_version_registry()
    quality.reset_monitor()


def _strings(rng, n, vocab, prefix):
    return np.array([f"{prefix}{v}" for v in rng.integers(0, vocab, n)],
                    dtype=object)


def _mixed_columns(seed=0, n=64):
    rng = np.random.default_rng(seed)
    return {
        "num": rng.normal(size=n).astype(np.float32),
        "count": rng.integers(0, 50, n).astype(np.float64),
        "cat": _strings(rng, n, 7, "c"),
        "site": np.array([f"s{v}" for v in rng.integers(0, 5, n)]),
        "vec": rng.normal(size=(n, 3)).astype(np.float32),
        "text": np.array([" ".join(f"w{w}" for w in rng.integers(
            0, 20, rng.integers(0, 5))) for _ in range(n)], dtype=object),
    }


@pytest.mark.parametrize("num_bits, hash_seed", [(18, 0), (12, 7)])
def test_featurizer_bit_equal(num_bits, hash_seed):
    cols = _mixed_columns()
    kw = dict(input_cols=list(cols), output_col="f", num_bits=num_bits,
              hash_seed=hash_seed, string_split_cols=["text"])
    got = VowpalWabbitFeaturizer(**kw).transform(Table(cols))
    want = RefFeaturizer(**kw).transform(RefTable(cols))
    for c in ("f_idx", "f_val"):
        assert got[c].dtype == want[c].dtype
        np.testing.assert_array_equal(got[c], want[c])


def test_interactions_bit_equal():
    cols = _mixed_columns(seed=1)
    ft = dict(output_col="a", num_bits=14)
    t = VowpalWabbitFeaturizer(input_cols=["num", "cat"], **ft).transform(
        Table(cols))
    t = VowpalWabbitFeaturizer(input_cols=["vec"], output_col="b",
                               num_bits=14).transform(t)
    r = RefFeaturizer(input_cols=["num", "cat"], **ft).transform(
        RefTable(cols))
    r = RefFeaturizer(input_cols=["vec"], output_col="b",
                      num_bits=14).transform(r)
    kw = dict(input_cols=["a", "b"], output_col="ab", num_bits=14)
    got = VowpalWabbitInteractions(**kw).transform(t)
    want = RefInteractions(**kw).transform(r)
    for c in ("ab_idx", "ab_val"):
        np.testing.assert_array_equal(got[c], want[c])
    with pytest.raises(ValueError):
        VowpalWabbitInteractions(input_cols=["a"], output_col="x") \
            .transform(t)


def _pairs(seed=0, n=700, k=12, bits=10, loss="squared"):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << 14, size=(n, k)).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    beta = rng.normal(size=1 << bits).astype(np.float32)
    margin = (beta[idx & ((1 << bits) - 1)] * val).sum(1)
    y = (margin if loss == "squared" else margin > 0).astype(np.float32)
    return idx, val, y


def _close(got, want, rtol):
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= rtol * scale


_MODES = [("sgd", {}), ("adaptive", {}), ("sgd", {"l1": 1e-3}),
          ("adaptive", {"num_passes": 3, "l2": 1e-3}),
          ("sgd", {"power_t": 0.3, "initial_t": 2.0}),
          ("bfgs", {"bfgs_iters": 8})]


@pytest.mark.parametrize("loss", ["squared", "logistic"])
@pytest.mark.parametrize("mode, extra", _MODES)
def test_fit_vw_matches_reference(loss, mode, extra):
    bits = 10
    idx, val, y = _pairs(bits=bits, loss=loss)
    w_row = np.random.default_rng(5).uniform(0.5, 2.0, len(y)) \
        .astype(np.float32)
    kw = dict(num_bits=bits, loss_function=loss, mode=mode, batch_size=64,
              **extra)
    rw, rb, rs = ref_learner.fit_vw(idx, val, y, ref_learner.VWParams(**kw),
                                    weights=w_row, num_tasks=1)
    pw, pb, ps = learner.fit_vw(idx, val, y, learner.VWParams(**kw),
                                weights=w_row, num_tasks=1, device="cpu")
    rtol = _BFGS_RTOL if mode == "bfgs" else _RTOL
    assert pw.dtype == np.float32 and pw.shape == rw.shape
    _close(pw, rw, rtol)
    assert abs(pb - rb) <= rtol * max(abs(rb), float(np.abs(rw).max()))
    assert ps["passes"] == rs["passes"]
    np.testing.assert_allclose(ps["loss_history"], rs["loss_history"],
                               rtol=10 * rtol)
    assert ps["num_features_nonzero"] == rs["num_features_nonzero"]


@pytest.mark.parametrize("loss", ["squared", "logistic"])
def test_fit_vw_two_tasks_matches_shard_map(loss):
    bits = 10
    idx, val, y = _pairs(seed=3, n=517, bits=bits, loss=loss)
    kw = dict(num_bits=bits, loss_function=loss, batch_size=64,
              num_passes=2)
    rw, rb, _ = ref_learner.fit_vw(idx, val, y, ref_learner.VWParams(**kw),
                                   num_tasks=2)
    pw, pb, _ = learner.fit_vw(idx, val, y, learner.VWParams(**kw),
                               num_tasks=2, device="cpu")
    _close(pw, rw, _RTOL)
    assert abs(pb - rb) <= _RTOL * float(np.abs(rw).max())
    # two positions are not one: the averaging is real
    one, _, _ = learner.fit_vw(idx, val, y, learner.VWParams(**kw),
                               num_tasks=1, device="cpu")
    assert not np.allclose(one, pw)


def test_warm_start_matches_reference():
    bits = 10
    idx, val, y = _pairs(seed=4, bits=bits)
    init = (np.random.default_rng(6).normal(size=1 << bits)
            .astype(np.float32) * 0.1, 0.25)
    kw = dict(num_bits=bits, mode="sgd", batch_size=32)
    rw, rb, _ = ref_learner.fit_vw(idx, val, y, ref_learner.VWParams(**kw),
                                   initial_model=init, num_tasks=1)
    pw, pb, _ = learner.fit_vw(idx, val, y, learner.VWParams(**kw),
                               initial_model=init, num_tasks=1,
                               device="cpu")
    _close(pw, rw, _RTOL)
    assert abs(pb - rb) <= _RTOL


def test_segment_sum_is_ordered_and_exact():
    """The segmented sum groups by index in input order: the CPU sums
    equal a float32 loop over the pairs, and empty slots are 0."""
    rng = np.random.default_rng(9)
    flat_idx = rng.integers(0, 50, 4000).astype(np.int32)
    flat_g = rng.normal(size=4000).astype(np.float32)
    got = learner._segment_sum(torch.as_tensor(flat_idx),
                               torch.as_tensor(flat_g), 64).numpy()
    want = np.zeros(64, np.float32)
    for i, g in zip(flat_idx, flat_g):
        want[i] = np.float32(want[i] + g)
    np.testing.assert_array_equal(got, want)


def _table(seed=0, n=512, k=8, bits=12):
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, 1 << bits, size=k).astype(np.int32)
    idx = np.tile(slots, (n, 1))
    val = rng.normal(size=(n, k)).astype(np.float32)
    beta = rng.normal(size=k).astype(np.float32)
    y = (val @ beta > 0).astype(np.float32)
    return {"features_idx": idx, "features_val": val, "label": y}


_EST = dict(features_col="features", label_col="label", num_bits=12,
            num_passes=4, num_tasks=1)


def test_classifier_matches_reference_and_stamps():
    d = _table()
    ref = RefClassifier(**_EST).fit(RefTable(d))
    m = VowpalWabbitClassifier(device="cpu", **_EST).fit(Table(d))
    _close(m._weights, np.asarray(ref._weights), _RTOL)
    got, want = m.transform(Table(d)), ref.transform(RefTable(d))
    np.testing.assert_allclose(got["probabilities"], want["probabilities"],
                               atol=_PROBA_TOL)
    assert m.quality_profile is not None
    assert m.lineage["estimator"] == "VowpalWabbitClassifier"
    assert m.lineage["params"]["num_passes"] == 4
    stats = m.get_performance_statistics()
    assert set(stats.columns) == set(
        ref.get_performance_statistics().columns)


def test_regressor_dense_features_match_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(300, 6)).astype(np.float32)
    y = (x @ rng.normal(size=6) + 0.5).astype(np.float32)
    kw = dict(features_col="features", label_col="label", num_bits=12,
              mode="sgd", l1=1e-4, num_tasks=1, batch_size=16)
    ref = RefRegressor(**kw).fit(RefTable({"features": x, "label": y}))
    m = VowpalWabbitRegressor(device="cpu", **kw).fit(
        Table({"features": x, "label": y}))
    _close(m._weights, np.asarray(ref._weights), _RTOL)
    np.testing.assert_allclose(
        m.transform(Table({"features": x}))["prediction"],
        ref.transform(RefTable({"features": x}))["prediction"],
        rtol=1e-5, atol=1e-6)


def _bandit_table(seed=0, n=400):
    d = _table(seed, n=n)
    rng = np.random.default_rng(seed + 1)
    d.update(chosen_action=rng.integers(1, 4, n),
             cost=rng.normal(size=n).astype(np.float32),
             probability=rng.uniform(0.2, 1.0, n).astype(np.float32))
    return d


_SWEEP = [{"learning_rate": 0.1}, {"learning_rate": 0.5}, {"l2": 1e-3},
          {"num_passes": 2}]


def test_bandit_parallel_fit_equals_sequential_and_reference():
    d = _bandit_table()
    kw = dict(features_col="features", num_bits=12, num_actions=3,
              num_tasks=1)
    est = VowpalWabbitContextualBandit(device="cpu", **kw)
    swept = est.parallel_fit(Table(d), _SWEEP)
    for pm, m in zip(_SWEEP, swept):
        seq = est.copy(pm).fit(Table(d))
        np.testing.assert_array_equal(m._weights, seq._weights)
        assert m._bias == seq._bias
        assert m._stats["ips_estimate"] == seq._stats["ips_estimate"]
    ref = RefBandit(**kw).fit(RefTable(d))
    _close(swept[1]._weights, np.asarray(ref._weights), _RTOL)
    got = vw_from_reference(ref, device="cpu").transform(Table(d))
    want = ref.transform(RefTable(d))
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    np.testing.assert_allclose(got["action_scores"], want["action_scores"],
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        est.parallel_fit(Table(d), [{"num_bits": 10}])


def test_from_reference_scores_equal():
    d = _table(seed=3)
    ref = RefClassifier(**_EST).fit(RefTable(d))
    m = vw_from_reference(ref, device="cpu")
    assert isinstance(m, VowpalWabbitClassificationModel)
    assert m.num_bits == 12 and m.features_col == "features"
    np.testing.assert_array_equal(m._weights, np.asarray(ref._weights))
    assert m._stats == ref._stats
    got, want = m.transform(Table(d)), ref.transform(RefTable(d))
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    np.testing.assert_allclose(got["probabilities"], want["probabilities"],
                               atol=_PROBA_TOL)


def test_serving_kernel_equals_transform():
    d = _table(seed=4)
    m = VowpalWabbitClassifier(device="cpu", **_EST).fit(Table(d))
    kernel = m._serving_kernel("prediction")
    assert kernel.sparse_pairs
    out = kernel(d["features_idx"], d["features_val"])
    assert out.dtype == np.float64
    np.testing.assert_array_equal(out, m.transform(Table(d))["prediction"])
    reg = VowpalWabbitRegressor(device="cpu", **_EST).fit(Table(d))
    np.testing.assert_allclose(
        reg._serving_kernel("prediction")(d["features_idx"],
                                          d["features_val"]),
        reg.transform(Table(d))["prediction"], rtol=1e-6)


def test_pipeline_saves_and_loads_in_a_fresh_process(tmp_path):
    cols = _mixed_columns(seed=5, n=200)
    cols["label"] = (cols["num"] > 0).astype(np.float32)
    pipe = Pipeline([
        VowpalWabbitFeaturizer(input_cols=["num", "count", "cat", "site",
                                           "vec"], output_col="features",
                               num_bits=12),
        VowpalWabbitClassifier(device="cpu", **_EST)])
    model = pipe.fit(Table(cols))
    model.save(str(tmp_path / "pm"))
    feat = {k: v for k, v in cols.items() if k != "label"}
    np.save(tmp_path / "cols.npy", feat, allow_pickle=True)
    code = (
        "import numpy as np\n"
        "from mmlspark_tpu_torch.core import PipelineModel, Table\n"
        f"m = PipelineModel.load({str(tmp_path / 'pm')!r})\n"
        f"cols = np.load({str(tmp_path / 'cols.npy')!r}, "
        "allow_pickle=True).item()\n"
        "out = m.transform(Table(cols))\n"
        f"np.save({str(tmp_path / 'p.npy')!r}, out['probabilities'])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=_REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    np.testing.assert_array_equal(np.load(tmp_path / "p.npy"),
                                  model.transform(Table(feat))[
                                      "probabilities"])


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    idx, val, y = _pairs(n=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        learner.fit_vw(idx, val, y, learner.VWParams(num_bits=10))


def test_mesh_over_processes_names_its_item():
    class _Spanning:
        process_count = 2

    with pytest.raises(NotImplementedError, match="item 19"):
        learner.vw_positions(mesh=_Spanning())
