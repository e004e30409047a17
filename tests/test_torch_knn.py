"""Port parity: KNN and ConditionalKNN (`mmlspark_tpu_torch.nn`).

The same seeded index and queries go through both packages, JAX on the
CPU and the port with `device="cpu"`: distances (inner products) within
rtol 1e-5, neighbour indices equal except at ties (a swap between two
neighbours whose float64 inner products are within rtol 1e-5), payloads
and labels of the same neighbours, the conditioner respected, underfull
conditioners padded with -inf, query tiles joined in order, save/load.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu.core import Table as RefTable
from mmlspark_tpu.nn import KNN as RefKNN
from mmlspark_tpu.nn import ConditionalKNN as RefCKNN
from mmlspark_tpu_torch.core import PipelineStage, Table
from mmlspark_tpu_torch.nn import KNN, ConditionalKNN, ConditionalKNNModel
from mmlspark_tpu_torch.nn import knn as knn_mod

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_DIST_RTOL = 1e-5


def _index(seed=3, n=200, d=16):
    rng = np.random.default_rng(seed)
    return {"features": rng.normal(size=(n, d)).astype(np.float32),
            "values": np.arange(n).astype(np.int64),
            "labels": rng.integers(0, 4, size=n)}


def _queries(seed=4, q=37, d=16):
    rng = np.random.default_rng(seed)
    conds = np.empty(q, dtype=object)
    for i in range(q):
        conds[i] = list(rng.choice(4, size=rng.integers(1, 4),
                                   replace=False))
    return {"features": rng.normal(size=(q, d)).astype(np.float32),
            "conditioner": conds}


def _assert_same_neighbours(got_idx, want_idx, exact):
    """Equal index lists, except where two neighbours' float64 products
    are within rtol 1e-5 (a tie)."""
    for r in range(got_idx.shape[0]):
        for a, b in zip(got_idx[r], want_idx[r]):
            if a != b:
                va, vb = exact[r, a], exact[r, b]
                assert abs(va - vb) <= _DIST_RTOL * max(abs(va), abs(vb)), r


def test_knn_is_the_reference_s():
    idx, q = _index(), _queries()
    ref = RefKNN(k=7).fit(RefTable(idx)).transform(RefTable(q))
    port = KNN(k=7, device="cpu").fit(Table(idx)).transform(Table(q))
    exact = (q["features"].astype(np.float64)
             @ idx["features"].astype(np.float64).T)
    np.testing.assert_allclose(port["output.distance"],
                               ref["output.distance"], rtol=_DIST_RTOL,
                               atol=1e-6)
    _assert_same_neighbours(port["output.value"], ref["output.value"], exact)
    want = np.sort(exact, axis=1)[:, ::-1][:, :7]
    np.testing.assert_allclose(port["output.distance"], want, rtol=1e-5)


def test_conditional_knn_is_the_reference_s():
    idx, q = _index(), _queries()
    ref = RefCKNN(k=5).fit(RefTable(idx)).transform(RefTable(q))
    model = ConditionalKNN(k=5, device="cpu").fit(Table(idx))
    port = model.transform(Table(q))
    np.testing.assert_allclose(port["output.distance"],
                               ref["output.distance"], rtol=_DIST_RTOL,
                               atol=1e-6)
    exact = (q["features"].astype(np.float64)
             @ idx["features"].astype(np.float64).T)
    _assert_same_neighbours(port["output.value"], ref["output.value"], exact)
    np.testing.assert_array_equal(
        port["output.label"], idx["labels"][port["output.value"]])
    for i in range(len(q["features"])):
        assert set(port["output.label"][i].tolist()) <= set(
            q["conditioner"][i])
    allowed, label_ids = model.allowed_mask(q["conditioner"])
    assert allowed.shape == (37, 4) and label_ids.shape == (200,)


def test_underfull_conditioner_pads_with_minus_inf():
    idx = {"features": np.eye(3, dtype=np.float32),
           "values": np.array(["a", "b", "c"]),
           "labels": np.array([0, 0, 1])}
    q = {"features": np.ones((1, 3), dtype=np.float32),
         "conditioner": np.array([[1]], dtype=np.int64)}
    port = ConditionalKNN(k=3, device="cpu").fit(Table(idx)).transform(
        Table(q))
    ref = RefCKNN(k=3).fit(RefTable(idx)).transform(RefTable(q))
    d = port["output.distance"][0]
    assert np.isfinite(d[0]) and not np.isfinite(d[1:]).any()
    assert port["output.label"][0][0] == 1
    np.testing.assert_array_equal(port["output.distance"],
                                  ref["output.distance"])
    # -inf ties resolve to the lower index, as lax.top_k does
    np.testing.assert_array_equal(port["output.value"], ref["output.value"])


def test_integer_products_tie_like_the_reference():
    """Integer-valued vectors tie often: the lower index comes first."""
    rng = np.random.default_rng(9)
    idx = {"features": rng.integers(0, 2, size=(64, 4)).astype(np.float32),
           "values": np.arange(64)}
    q = {"features": rng.integers(0, 2, size=(10, 4)).astype(np.float32)}
    port = KNN(k=6, device="cpu").fit(Table(idx)).transform(Table(q))
    ref = RefKNN(k=6).fit(RefTable(idx)).transform(RefTable(q))
    np.testing.assert_array_equal(port["output.value"], ref["output.value"])
    np.testing.assert_array_equal(port["output.distance"],
                                  ref["output.distance"])


def test_query_tiles_join_in_order(monkeypatch):
    idx, q = _index(), _queries()
    whole = KNN(k=4, device="cpu").fit(Table(idx)).transform(Table(q))
    monkeypatch.setattr(knn_mod, "_QUERY_TILE", 8)
    tiled = KNN(k=4, device="cpu").fit(Table(idx)).transform(Table(q))
    np.testing.assert_array_equal(whole["output.value"],
                                  tiled["output.value"])
    np.testing.assert_array_equal(whole["output.distance"],
                                  tiled["output.distance"])


def test_string_values_and_bad_shape():
    idx = _index()
    t = {"features": idx["features"],
         "values": np.array([f"id_{i}" for i in range(200)])}
    out = KNN(k=2, device="cpu").fit(Table(t)).transform(
        Table({"features": idx["features"][:5]}))
    assert out["output.value"].shape == (5, 2)
    assert all(v.startswith("id_") for v in out["output.value"].ravel())
    with pytest.raises(ValueError, match="must be"):
        KNN(device="cpu").fit(Table({"features": np.arange(4.0),
                                     "values": np.arange(4)}))


def test_reference_model_carried_across_and_saved(tmp_path):
    idx, q = _index(5), _queries(6)
    ref = RefCKNN(k=3).fit(RefTable(idx))
    port = knn_mod.knn_from_reference(ref, device="cpu", k=3)
    assert isinstance(port, ConditionalKNNModel)
    got = port.transform(Table(q))
    want = ref.transform(RefTable(q))
    np.testing.assert_allclose(got["output.distance"],
                               want["output.distance"], rtol=_DIST_RTOL,
                               atol=1e-6)
    port.save(str(tmp_path / "knn"))
    back = PipelineStage.load(str(tmp_path / "knn"))
    again = back.transform(Table(q))
    np.testing.assert_array_equal(again["output.value"], got["output.value"])
