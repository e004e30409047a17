"""Port parity: the linear learners (`models/linear.py`) and the sparse
helpers they read (`ops/sparse.py`, `ops/hashing.hash_strings`,
`ops/levels.py`).

The same seeded arrays go through both packages, JAX on the CPU and the
port with `device="cpu"`. Tolerances:
- Adam fits (dense and sparse; binary, multiclass, regression; with and
  without L2): weights and bias within `_RTOL` of the reference's largest
  weight. Both run the same 300 full-batch steps in f32; the products and
  the sparse scatter add in another order, and Adam's first steps move a
  weight whose gradient is near zero by about the learning rate whatever
  its size (ROADMAP Queue 3 (ag)), so the largest differences sit on
  noise columns. Multiclass fits within `_MULTICLASS_RTOL`: the softmax
  leaves one direction free, and f32 rounding alone moves that fit by
  6.3e-6 of max |w| (its float64 run, unweighted, in
  `test_adam_sign_steps_amplify_rounding`); the weighted parity fit
  differs from the reference's by 9.75e-6;
- the normal solver within `_NORMAL_RTOL` (float64 on both sides);
- scoring on the CPU is the reference's numpy: equal bit for bit for the
  same weights; `to_dense`, `hash_strings`, `lookup_levels` and
  `rows_to_pair` equal bit for bit.
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import Table as RefTable
from mmlspark_tpu.models.linear import LinearRegression as RefLinReg
from mmlspark_tpu.models.linear import LogisticRegression as RefLogReg
from mmlspark_tpu.ops import hashing as ref_hashing
from mmlspark_tpu.ops import levels as ref_levels
from mmlspark_tpu.ops import sparse as ref_sparse
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.core.serialize import load_stage, save_stage
from mmlspark_tpu_torch.models.linear import (LinearRegression,
                                              LinearRegressionModel,
                                              LogisticRegression,
                                              LogisticRegressionModel,
                                              linear_from_reference)
from mmlspark_tpu_torch.ops import hashing, levels, sparse

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RTOL = 1e-5
_MULTICLASS_RTOL = 5e-5
_NORMAL_RTOL = 1e-9
_N, _F, _WIDTH, _K = 2000, 16, 1 << 10, 8


def _dense(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(_N, _F)).astype(np.float32)
    truth = rng.normal(size=_F)
    z = x @ truth
    return {"x": x, "binary": (rng.random(_N) < 1 / (1 + np.exp(-z))
                               ).astype(np.float64),
            "multiclass": np.argmax(x[:, :3] + rng.normal(size=(_N, 3)), 1
                                    ).astype(np.float64),
            "regression": z + rng.normal(size=_N),
            "weight": rng.uniform(0.5, 2.0, _N)}


def _sparse_pairs(seed=1):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, _WIDTH, size=(_N, _K)).astype(np.int32)
    val = rng.normal(size=(_N, _K)).astype(np.float32)
    z = (val * rng.normal(size=_WIDTH)[idx]).sum(1)
    return {"idx": idx, "val": val,
            "binary": (rng.random(_N) < 1 / (1 + np.exp(-z))
                       ).astype(np.float64),
            "multiclass": np.digitize(z, [-1.0, 1.0]).astype(np.float64),
            "regression": z}


def _tables(cols, meta_width=None):
    out = []
    for cls in (RefTable, Table):
        t = cls(dict(cols))
        if meta_width:
            t = t.with_column_meta("features_idx", logical_width=meta_width)
        out.append(t)
    return out


def _close(ref_model, port_model, rtol=_RTOL):
    rw = np.asarray(ref_model._w)
    scale = np.abs(rw).max()
    assert scale > 0
    np.testing.assert_allclose(port_model._w, rw, rtol=0, atol=rtol * scale)
    np.testing.assert_allclose(np.asarray(port_model._b),
                               np.asarray(ref_model._b), rtol=0,
                               atol=rtol * scale)


_CASES = [("binary", RefLogReg, LogisticRegression, {}),
          ("multiclass", RefLogReg, LogisticRegression, {}),
          ("binary", RefLogReg, LogisticRegression, {"reg_param": 0.01}),
          ("regression", RefLinReg, LinearRegression, {"solver": "sgd"})]


@pytest.mark.parametrize("label, ref_cls, cls, kw", _CASES)
def test_dense_adam_fit_matches_reference(label, ref_cls, cls, kw):
    d = _dense()
    cols = {"features": d["x"], "label": d[label], "w": d["weight"]}
    rt, pt = _tables(cols)
    ref = ref_cls(weight_col="w", **kw).fit(rt)
    got = cls(weight_col="w", device="cpu", **kw).fit(pt)
    _close(ref, got, _MULTICLASS_RTOL if label == "multiclass" else _RTOL)
    assert type(got).__name__ == type(ref).__name__
    assert got.sparse_trained is False


@pytest.mark.parametrize("label, ref_cls, cls, kw", _CASES)
def test_sparse_adam_fit_matches_reference(label, ref_cls, cls, kw):
    d = _sparse_pairs()
    cols = {"features_idx": d["idx"], "features_val": d["val"],
            "label": d[label]}
    rt, pt = _tables(cols, meta_width=_WIDTH)
    ref = ref_cls(**kw).fit(rt)
    got = cls(device="cpu", **kw).fit(pt)
    assert got._w.shape[0] == _WIDTH
    _close(ref, got, _MULTICLASS_RTOL if label == "multiclass" else _RTOL)
    assert got.sparse_trained is True
    # scored on the CPU: the reference's numpy on the port's weights
    carried = linear_from_reference(ref, device="cpu")
    want = ref.transform(rt)
    out = carried.transform(pt)
    for c in ("prediction",) + (("probabilities",)
                                if label != "regression" else ()):
        np.testing.assert_array_equal(out[c], np.asarray(want[c]))


def test_normal_solver_matches_reference():
    d = _dense()
    cols = {"features": d["x"], "label": d["regression"], "w": d["weight"]}
    rt, pt = _tables(cols)
    for reg in (0.0, 0.5):
        ref = RefLinReg(weight_col="w", reg_param=reg).fit(rt)
        got = LinearRegression(weight_col="w", reg_param=reg,
                               device="cpu").fit(pt)
        np.testing.assert_allclose(got._w, ref._w, rtol=_NORMAL_RTOL)
        np.testing.assert_allclose(got._b, ref._b, rtol=_NORMAL_RTOL)
        assert got._w.dtype == np.float32 and got.sparse_trained is False


def _one_hot_design(seed=7, n=2000):
    """Two numeric columns and two categoricals one-hot encoded, as
    `Featurize` gives them: each categorical's columns sum to the bias."""
    rng = np.random.default_rng(seed)
    cols = [rng.normal(size=(n, 2))]
    for card in (5, 3):
        hot = np.zeros((n, card))
        hot[np.arange(n), rng.integers(0, card, n)] = 1.0
        cols.append(hot)
    x = np.concatenate(cols, 1).astype(np.float32)
    return x, x @ rng.normal(size=x.shape[1]) + rng.normal(size=n)


def test_normal_solver_refuses_an_exactly_singular_system():
    """A column of zeros with no L2 gives the Gram an exact zero pivot:
    numpy's solve raises `LinAlgError`, and so does the port."""
    x, y = _one_hot_design()
    x[:, 1] = 0.0
    rt, pt = _tables({"features": x, "label": y})
    with pytest.raises(np.linalg.LinAlgError):
        RefLinReg().fit(rt)
    with pytest.raises(np.linalg.LinAlgError):
        LinearRegression(device="cpu").fit(pt)


def test_normal_solver_on_one_hot_columns_predicts_as_the_reference():
    """One-hot columns beside the bias with no L2 (TrainRegressor's
    default on a categorical table) make the Gram singular up to
    rounding, and rounding decides whether numpy's LU meets an exact zero
    pivot (ROADMAP Queue 3 (ai)): over eight seeded designs the reference
    refuses some; the port solves each, with weights that part from the
    reference's along the null space and predictions that agree."""
    solved = 0
    for seed in range(8):
        x, y = _one_hot_design(seed)
        rt, pt = _tables({"features": x, "label": y})
        got = LinearRegression(device="cpu").fit(pt)
        try:
            ref = RefLinReg().fit(rt)
        except np.linalg.LinAlgError:
            continue
        solved += 1
        want = np.asarray(ref.transform(rt)["prediction"], np.float64)
        pred = np.asarray(got.transform(pt)["prediction"], np.float64)
        assert np.abs(pred - want).max() <= 1e-5 * np.abs(want).max()
    assert solved >= 4


def test_sparse_width_falls_back_with_the_reference_s_warning():
    d = _sparse_pairs()
    cols = {"features_idx": d["idx"][:, :4], "features_val": d["val"][:, :4],
            "label": d["binary"]}
    rt, pt = _tables(cols)
    with pytest.warns(UserWarning, match="logical_width"):
        ref = RefLogReg(max_iter=5).fit(rt)
    with pytest.warns(UserWarning, match="logical_width"):
        got = LogisticRegression(max_iter=5, device="cpu").fit(pt)
    assert got._w.shape == np.asarray(ref._w).shape
    with pytest.warns(UserWarning, match="normal"):
        lin = LinearRegression(max_iter=5, device="cpu").fit(
            pt.with_column_meta("features_idx", logical_width=_WIDTH))
    assert lin.sparse_trained and lin._w.shape == (_WIDTH,)


def test_dense_model_refuses_sparse_pairs():
    d = _dense()
    _, pt = _tables({"features": d["x"], "label": d["binary"]})
    m = LogisticRegression(max_iter=3, device="cpu").fit(pt)
    sp = Table({"features_idx": np.zeros((4, 2), np.int32),
                "features_val": np.ones((4, 2), np.float32)})
    with pytest.raises(TypeError, match="dense"):
        m.transform(sp)


def test_from_reference_scores_equal_and_round_trip(tmp_path):
    d = _dense()
    cols = {"features": d["x"], "label": d["multiclass"]}
    rt, pt = _tables(cols)
    ref = RefLogReg(max_iter=20).fit(rt)
    got = linear_from_reference(ref, device="cpu")
    assert isinstance(got, LogisticRegressionModel) and got.n_classes == 3
    want = ref.transform(rt)
    out = got.transform(pt)
    np.testing.assert_array_equal(out["probabilities"],
                                  np.asarray(want["probabilities"]))
    save_stage(got, str(tmp_path / "m"))
    back = load_stage(str(tmp_path / "m"))
    np.testing.assert_array_equal(back.transform(pt)["probabilities"],
                                  out["probabilities"])
    ref_reg = RefLinReg().fit(RefTable({"features": d["x"],
                                        "label": d["regression"]}))
    reg = linear_from_reference(ref_reg, device="cpu")
    assert isinstance(reg, LinearRegressionModel)
    save_stage(reg, str(tmp_path / "r"))
    np.testing.assert_array_equal(
        load_stage(str(tmp_path / "r")).transform(pt)["prediction"],
        np.asarray(ref_reg.transform(rt)["prediction"]))


_LOAD = """
import sys
import numpy as np
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.core.serialize import load_stage
m = load_stage(sys.argv[1])
x = np.load(sys.argv[2])
np.save(sys.argv[3], m.transform(Table({"features": x}))["probabilities"])
"""


def test_saved_fit_scores_equal_in_a_fresh_process(tmp_path):
    d = _dense()
    _, pt = _tables({"features": d["x"], "label": d["binary"]})
    m = LogisticRegression(max_iter=30, device="cpu").fit(pt)
    save_stage(m, str(tmp_path / "m"))
    np.save(tmp_path / "x.npy", d["x"])
    subprocess.run([sys.executable, "-c", _LOAD, str(tmp_path / "m"),
                    str(tmp_path / "x.npy"), str(tmp_path / "p.npy")],
                   cwd=_REPO, check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": _REPO})
    np.testing.assert_array_equal(np.load(tmp_path / "p.npy"),
                                  m.transform(pt)["probabilities"])


def test_entry_points_default_to_the_card():
    d = _dense()
    _, pt = _tables({"features": d["x"], "label": d["binary"]})
    if torch.cuda.is_available():
        pytest.skip("a card is visible: None resolves to it")
    for est in (LogisticRegression(max_iter=2), LinearRegression()):
        with pytest.raises(RuntimeError, match="CUDA"):
            est.fit(pt)
    with pytest.raises(RuntimeError, match="CUDA"):
        sparse.to_dense(np.zeros((2, 2), np.int32),
                        np.ones((2, 2), np.float32), 4)


def test_to_dense_sums_collisions_as_the_reference():
    rng = np.random.default_rng(3)
    idx = rng.integers(-3, 40, size=(64, 12)).astype(np.int32)
    val = rng.normal(size=(64, 12)).astype(np.float32)
    want = ref_sparse.to_dense(idx, val, 32)
    got = sparse.to_dense(idx, val, 32, device="cpu")
    assert got.dtype == np.float32 and got.shape == (64, 32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sparse.to_dense(idx, val, 32,
                                                  device="cpu"), got)
    ri, rv = ref_sparse.rows_to_pair([[1, 2], [], [5]], [[1., 2.], [], [3.]])
    pi, pv = sparse.rows_to_pair([[1, 2], [], [5]], [[1., 2.], [], [3.]])
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pv, rv)
    assert sparse.DENSE_AUTO_LIMIT == ref_sparse.DENSE_AUTO_LIMIT


@pytest.mark.parametrize("n", [10, 2000])
def test_hash_strings_and_levels_match_reference(n):
    rng = np.random.default_rng(n)
    vals = np.array([f"tok{v}" for v in rng.integers(0, 5000, n)],
                    dtype=object)
    for bits in (10, 18):
        want = ref_hashing.hash_strings(vals, num_bits=bits)
        got = hashing.hash_strings(vals, num_bits=bits)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    lv = np.unique(vals[: n // 2])
    for a, b in zip(levels.lookup_levels(lv, vals),
                    ref_levels.lookup_levels(lv, vals)):
        np.testing.assert_array_equal(a, b)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        i, f = levels.lookup_levels(np.array([], dtype=object), vals[:3])
    assert not f.any() and (i == 0).all()


def test_sparse_gradient_sums_long_slots_in_chunks():
    """A slot holding more than `_CHUNK` pairs (hashed text's commonest
    tokens) is summed in chunks, then per slot: the sums match float64
    within f32 rounding, and the empty slots are exactly 0."""
    from mmlspark_tpu_torch.models import linear
    rng = np.random.default_rng(9)
    n, k, width = 3000, 6, 64
    idx = np.where(rng.random((n, k)) < 0.5, 3,
                   rng.integers(0, width // 2, (n, k))).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    g = torch.as_tensor(rng.normal(size=(n, 2)).astype(np.float32))
    design = linear._Sparse(torch.as_tensor(idx), torch.as_tensor(val),
                            width)
    assert int(design.chunk_lengths.max()) <= linear._CHUNK
    assert int(design.slot_chunks[3]) > 1
    got = linear._weight_grad(design, g).numpy()
    want = np.zeros((width, 2))
    np.add.at(want, idx.reshape(-1),
              (val[..., None].astype(np.float64)
               * g.numpy()[:, None, :].astype(np.float64)).reshape(-1, 2))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert (got[width // 2:] == 0).all() and (got[width // 2:] == want[
        width // 2:]).all()


def _f32_against_f64(design_args, y, kind, width, steps):
    """max |w_f32 - w_f64| / max |w_f64| of the port's Adam fit run in
    f32 and in float64 on the same inputs."""
    from mmlspark_tpu_torch.models import linear
    got = []
    for dtype in (torch.float32, torch.float64):
        idx, val = design_args
        x = (linear._Sparse(torch.as_tensor(idx),
                            torch.as_tensor(val, dtype=dtype), width)
             if idx is not None else torch.as_tensor(val, dtype=dtype))
        classes = int(y.max()) + 1 if kind == "multiclass" else 1
        w, _ = linear.fit_linear(x, torch.as_tensor(y, dtype=dtype),
                                 torch.ones(len(y), dtype=dtype), steps,
                                 classes, kind, 0.0, 0.1, n_features=width)
        got.append(w.double())
    return float((got[0] - got[1]).abs().max() / got[1].abs().max())


def test_adam_sign_steps_amplify_rounding():
    """ROADMAP Queue 3 (ag), measured on the CPU: where gradients are
    near zero, Adam steps by their rounding's sign, so a fit's f32 and
    float64 runs part. A noiseless sparse regression (4,000 x 12 pairs
    over 600 slots of 2^14) agrees to 1.2e-7 of max |w| after 200 steps
    and parts by 3.5e-4 by 300, once it has converged; hashed Zipf tokens
    with binary labels (slots whose contributions nearly cancel) part by
    7.5e-4; a dense multiclass fit (the direction its softmax leaves
    free) by 6.3e-6; a dense regression with noisy labels stays at
    5.6e-8."""
    rng = np.random.default_rng(1)
    n, k, width = 4000, 12, 1 << 14
    idx = (rng.integers(0, 600, size=(n, k)) * 5).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    z = (val * rng.normal(size=width)[idx]).sum(1) * 0.3
    assert _f32_against_f64((idx, val), z, "regression", width, 200) < 1e-6
    assert _f32_against_f64((idx, val), z, "regression", width, 300) > 1e-4
    rng = np.random.default_rng(2)
    n, k, vocab = 2000, 20, 5000
    ranks = np.floor(np.exp(rng.random(n * k) * np.log(vocab + 1.0))) - 1
    tok = np.clip(ranks, 0, vocab - 1).astype(np.int32).reshape(n, k)
    margin = rng.normal(size=vocab)[tok].sum(1) / np.sqrt(k)
    y = (rng.random(n) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    assert _f32_against_f64((tok, np.ones((n, k), np.float32)), y,
                            "binary", vocab, 300) > 1e-4
    d = _dense()
    assert _f32_against_f64((None, d["x"]), d["regression"], "regression",
                            _F, 300) < 1e-6
    assert _f32_against_f64((None, d["x"]), d["multiclass"], "multiclass",
                            _F, 300) > 5e-6
