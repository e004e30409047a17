"""Port parity: CyberML (`mmlspark_tpu_torch/cyber/`).

The same seeded inputs go through both packages in one process, JAX on
the CPU and the port with `device="cpu"`:
- the indexers, scalers, `DataFactory` and `ComplementAccessTransformer`
  (host numpy in both): columns and states equal bit for bit;
- `AccessAnomaly`'s dense ratings and weights after the cast to float32,
  and the initial factors: equal bit for bit (the reference's matrices
  are taken from its `_als` call, its initial factors from `_als` with
  no iteration);
- the ALS factors at three sizes, 5 and 25 iterations, within
  `_FACTOR_RTOL` of the largest |factor| (one product per side against
  the reference's per-entity products: f32 rounding in another order,
  measured up to 1.9e-5 at these sizes), and the scores within
  `_SCORE_RTOL` of the largest |score|;
- cross-group accesses outscore in-group ones, unseen ids score 0, and a
  save/load round trip and `access_anomaly_from_reference` score as the
  model they came from.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu import Table as RefTable
from mmlspark_tpu.cyber import access_anomaly as ref_aa
from mmlspark_tpu.cyber import dataset as ref_dataset
from mmlspark_tpu.cyber import features as ref_features
from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.core import PipelineStage
from mmlspark_tpu_torch.cyber import (AccessAnomaly, AccessAnomalyModel,
                                      ComplementAccessTransformer,
                                      DataFactory, IdIndexer,
                                      LinearScalarScaler,
                                      StandardScalarScaler)
from mmlspark_tpu_torch.cyber import access_anomaly as aa

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_CPU = torch.device("cpu")
_FACTOR_RTOL = 1e-4
_SCORE_RTOL = 1e-4


def _log(n_rows, n_users, n_res, seed, tenants=("contoso", "fabrikam"),
         strings=True, likelihood=False):
    """Clustered access: each of two groups of users reaches its own half
    of the resources, per tenant."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 2, n_rows)
    u = g * (n_users // 2) + rng.integers(0, n_users // 2, n_rows)
    r = g * (n_res // 2) + rng.integers(0, n_res // 2, n_rows)
    ten = np.asarray(tenants, dtype=object)[rng.integers(0, len(tenants),
                                                         n_rows)]
    cols = {"tenant": ten,
            "user": (np.asarray([f"user_{i}" for i in u], dtype=object)
                     if strings else u),
            "res": (np.asarray([f"res_{i}" for i in r], dtype=object)
                    if strings else r)}
    if likelihood:
        cols["likelihood"] = rng.integers(1, 50, n_rows).astype(np.float64)
    return cols


def _both(cols):
    return RefTable(dict(cols)), Table(dict(cols))


def _equal(a, b, text_as_str=False):
    a, b = np.asarray(a), np.asarray(b)
    if text_as_str and a.dtype.kind in "OU":
        # a saved object column of strings loads as a numpy str array
        a, b = a.astype(str), b.astype(str)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.kind == "f":
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    else:
        assert (a == b).all()


def _states_equal(ref_model, port_model, text_as_str=False):
    rs, ps = ref_model._get_state(), port_model._get_state()
    assert sorted(rs) == sorted(ps)
    for k in rs:
        _equal(rs[k], ps[k], text_as_str)


# ------------------------------------------------------------ host stages
@pytest.mark.parametrize("col", ["user", "res"])
def test_id_indexer_equal(col):
    ref_t, port_t = _both(_log(3000, 40, 20, 0))
    kw = dict(input_col=col, output_col="ix")
    rm = ref_features.IdIndexer(**kw).fit(ref_t)
    pm = IdIndexer(**kw).fit(port_t)
    _states_equal(rm, pm)
    probe = _log(500, 44, 24, 1, tenants=("contoso", "fabrikam", "new"))
    out_r = rm.transform(RefTable(dict(probe)))["ix"]
    out_p = pm.transform(Table(dict(probe)))["ix"]
    _equal(out_r, out_p)
    assert out_p.min() == 0 and out_p.max() >= 1   # unseen -> 0, 1-based
    assert pm.vocab_size("contoso") == rm.vocab_size("contoso")


@pytest.mark.parametrize("cls, kw", [
    ("StandardScalarScaler", dict(coefficient_factor=2.5)),
    ("LinearScalarScaler", dict(min_required_value=-1.0,
                                max_required_value=3.0))])
def test_scalers_equal(cls, kw):
    rng = np.random.default_rng(3)
    cols = {"tenant": np.asarray(["a"] * 60 + ["b"] * 40 + ["c"] * 5,
                                 dtype=object),
            "x": np.concatenate([rng.normal(10, 2, 60),
                                 rng.normal(-5, 7, 40), np.full(5, 4.0)])}
    ref_t, port_t = _both(cols)
    kw = dict(input_col="x", output_col="z", **kw)
    rm = getattr(ref_features, cls)(**kw).fit(ref_t)
    pm = {"StandardScalarScaler": StandardScalarScaler,
          "LinearScalarScaler": LinearScalarScaler}[cls](**kw).fit(port_t)
    _states_equal(rm, pm)
    probe = dict(cols, tenant=np.asarray(["a", "b", "zz"] * 35,
                                         dtype=object))
    _equal(rm.transform(RefTable(dict(probe)))["z"],
           pm.transform(Table(dict(probe)))["z"])


@pytest.mark.parametrize("seed, single", [(7, True), (3, False)])
def test_data_factory_equal(seed, single):
    rf = ref_dataset.DataFactory(seed=seed, single_component=single)
    pf = DataFactory(seed=seed, single_component=single)
    rt, pt = rf.create_clustered_training_data(ratio=0.3), \
        pf.create_clustered_training_data(ratio=0.3)
    for a, b in ((rt, pt),
                 (rf.create_clustered_intra_test_data(rt),
                  pf.create_clustered_intra_test_data(pt)),
                 (rf.create_clustered_inter_test_data(),
                  pf.create_clustered_inter_test_data())):
        assert a.columns == b.columns and len(a) > 0
        for c in a.columns:
            _equal(a[c], b[c])


def test_complement_access_equal():
    rng = np.random.default_rng(4)
    cols = {"tenant": np.asarray(["a"] * 30 + ["b"] * 12, dtype=object),
            "user_ix": np.concatenate([rng.integers(1, 9, 30),
                                       rng.integers(0, 4, 12)]),
            "res_ix": np.concatenate([rng.integers(1, 7, 30),
                                      rng.integers(0, 5, 12)])}
    ref_t, port_t = _both(cols)
    for seed, factor in ((0, 2), (5, 3)):
        a = ref_aa.ComplementAccessTransformer(
            seed=seed, complementset_factor=factor).transform(ref_t)
        b = ComplementAccessTransformer(
            seed=seed, complementset_factor=factor).transform(port_t)
        assert len(b) > 0
        for c in a.columns:
            _equal(a[c], b[c])


# ------------------------------------------------------------ AccessAnomaly
def _spy_reference(monkeypatch):
    """Record each (ratings, weights) the reference's fit hands `_als`."""
    seen = []
    real = ref_aa._als

    def spy(ratings, weights, rank, iters, reg, seed):
        seen.append((ratings, weights))
        return real(ratings, weights, rank, iters, reg, seed)
    monkeypatch.setattr(ref_aa, "_als", spy)
    return seen


def _port_matrices(cols, est):
    out = {}
    tenants = np.asarray(cols["tenant"])
    counts = (np.asarray(cols[est.likelihood_col], np.float64)
              if est.likelihood_col else np.ones(len(tenants)))
    for ten in np.unique(tenants):
        m = tenants == ten
        ul, u_ix = np.unique(np.asarray(cols["user"])[m], return_inverse=True)
        rl, r_ix = np.unique(np.asarray(cols["res"])[m], return_inverse=True)
        keys, sums = aa.pair_sums(u_ix, r_ix, counts[m], len(rl))
        out[ten] = aa.tenant_matrices(
            keys, sums, len(ul), len(rl), est.low_value, est.high_value,
            est.neg_score, est.complementset_factor, _CPU)
    return out


@pytest.mark.parametrize("likelihood, kw", [
    (False, {}),
    (True, {}),
    (True, dict(low_value=2.0, high_value=9.5, neg_score=0.25,
                complementset_factor=3)),
])
def test_matrices_bit_equal(monkeypatch, likelihood, kw):
    cols = _log(4000, 60, 30, 11, likelihood=likelihood)
    seen = _spy_reference(monkeypatch)
    lik = "likelihood" if likelihood else None
    ref = ref_aa.AccessAnomaly(max_iter=1, likelihood_col=lik, **kw)
    ref.fit(RefTable(dict(cols)))
    port = _port_matrices(cols, AccessAnomaly(likelihood_col=lik,
                                              device="cpu", **kw))
    assert len(seen) == len(port) == 2
    for (r, w), ten in zip(seen, sorted(port)):
        pr, pw = port[ten]
        _equal(np.asarray(r, np.float32), pr.numpy())
        _equal(np.asarray(w, np.float32), pw.numpy())


def test_matrices_constant_counts_and_no_evidence(monkeypatch):
    """Every pair observed equally often (the ratings all `high`), and a
    tenant whose counts are all 0 (no factors in either package)."""
    cols = _log(600, 10, 8, 2, likelihood=True)
    cols["likelihood"] = np.where(cols["tenant"] == "contoso", 0.0, 3.0)
    seen = _spy_reference(monkeypatch)
    ref = ref_aa.AccessAnomaly(max_iter=1, likelihood_col="likelihood")
    rm = ref.fit(RefTable(dict(cols)))
    port = _port_matrices(cols, AccessAnomaly(likelihood_col="likelihood",
                                              device="cpu"))
    assert port["contoso"] is None and len(seen) == 1
    _equal(np.asarray(seen[0][0], np.float32), port["fabrikam"][0].numpy())
    _equal(np.asarray(seen[0][1], np.float32), port["fabrikam"][1].numpy())
    pm = AccessAnomaly(max_iter=1, likelihood_col="likelihood",
                       device="cpu").fit(Table(dict(cols)))
    assert sorted(pm._models) == sorted(rm._models) == ["fabrikam"]
    probe = {k: np.asarray(v)[:50] for k, v in cols.items()}
    _equal(rm.transform(RefTable(dict(probe)))["anomaly_score"][
        probe["tenant"] == "contoso"],
        pm.transform(Table(dict(probe)))["anomaly_score"][
        probe["tenant"] == "contoso"])


@pytest.mark.parametrize("n_u, n_r, rank, seed", [(7, 5, 3, 0),
                                                  (300, 200, 10, 9)])
def test_initial_factors_bit_equal(n_u, n_r, rank, seed):
    ratings = np.ones((n_u, n_r))
    u0, v0 = ref_aa._als(ratings, ratings, rank, 0, 1.0, seed)
    pu, pv = aa.initial_factors(n_u, n_r, rank, seed)
    _equal(np.asarray(u0), pu)
    _equal(np.asarray(v0), pv)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("iters", [5, 25])
@pytest.mark.parametrize("n_rows, n_u, n_r", [(3000, 40, 20),
                                              (8000, 120, 90),
                                              (20000, 300, 200)])
def test_als_factors_and_scores(n_rows, n_u, n_r, iters):
    cols = _log(n_rows, n_u, n_r, 5, tenants=("t",), strings=False)
    u_l, u_ix = np.unique(cols["user"], return_inverse=True)
    r_l, r_ix = np.unique(cols["res"], return_inverse=True)
    keys, sums = aa.pair_sums(u_ix, r_ix, np.ones(n_rows), len(r_l))
    ratings, weights = aa.tenant_matrices(keys, sums, len(u_l), len(r_l),
                                          5.0, 10.0, 1.0, 2, _CPU)
    ru, rv = ref_aa._als(ratings.double().numpy(), weights.double().numpy(),
                         10, iters, 1.0, 0)
    u0, v0 = aa.initial_factors(len(u_l), len(r_l), 10, 0)
    pu, pv = aa.als(ratings, weights, torch.from_numpy(u0),
                    torch.from_numpy(v0), iters, 1.0)
    assert _rel(pu, ru) <= _FACTOR_RTOL, _rel(pu, ru)
    assert _rel(pv, rv) <= _FACTOR_RTOL, _rel(pv, rv)

    kw = dict(max_iter=iters)
    rm = ref_aa.AccessAnomaly(**kw).fit(RefTable(dict(cols)))
    pm = AccessAnomaly(device="cpu", **kw).fit(Table(dict(cols)))
    probe = _log(1000, n_u + 4, n_r + 4, 6, tenants=("t", "other"),
                 strings=False)
    a = rm.transform(RefTable(dict(probe)))["anomaly_score"]
    b = pm.transform(Table(dict(probe)))["anomaly_score"]
    assert b.dtype == np.float64
    assert _rel(b, a) <= _SCORE_RTOL, _rel(b, a)
    _equal(a == 0.0, b == 0.0)    # the same unseen / no-tenant rows


def _access_log():
    """tests/test_cyber.py's fixture: two tenants, users 0-19 on
    resources 0-9 and users 20-39 on resources 10-19."""
    rng = np.random.default_rng(0)
    rows_t, rows_u, rows_r = [], [], []
    for ten in ("contoso", "fabrikam"):
        for _ in range(1500):
            if rng.random() < 0.5:
                u, r = rng.integers(0, 20), rng.integers(0, 10)
            else:
                u, r = rng.integers(20, 40), rng.integers(10, 20)
            rows_t.append(ten)
            rows_u.append(f"user_{u}")
            rows_r.append(f"res_{r}")
    return {"tenant": np.asarray(rows_t, dtype=object),
            "user": np.asarray(rows_u, dtype=object),
            "res": np.asarray(rows_r, dtype=object)}


def _probe(users, res):
    return Table({"tenant": np.asarray(["contoso"] * len(users),
                                       dtype=object),
                  "user": np.asarray(users, dtype=object),
                  "res": np.asarray(res, dtype=object)})


def test_cross_access_scores_higher_unseen_zero():
    model = AccessAnomaly(max_iter=10, rank=8, device="cpu").fit(
        Table(_access_log()))
    users = [f"user_{u}" for u in range(10)] * 2
    s_norm = model.transform(_probe(
        users, [f"res_{r}" for r in range(5)] * 4))["anomaly_score"]
    s_cross = model.transform(_probe(
        users, [f"res_{r}" for r in range(15, 20)] * 4))["anomaly_score"]
    assert s_cross.mean() > s_norm.mean() + 1.0, (s_norm.mean(),
                                                  s_cross.mean())
    got = model.transform(_probe(["stranger", "user_0"],
                                 ["res_0", "nowhere"]))["anomaly_score"]
    assert got[0] == 0.0 and got[1] == 0.0


def test_data_factory_end_to_end():
    f = DataFactory(seed=7)
    train = f.create_clustered_training_data(ratio=0.4)
    intra = f.create_clustered_intra_test_data(train)
    inter = f.create_clustered_inter_test_data()
    model = AccessAnomaly(max_iter=10, rank=8, likelihood_col="likelihood",
                          device="cpu").fit(train)
    s_intra = model.transform(intra)["anomaly_score"]
    s_inter = model.transform(inter)["anomaly_score"]
    assert s_inter.mean() > s_intra.mean(), (s_intra.mean(), s_inter.mean())


def test_save_load_and_from_reference(tmp_path):
    cols = _access_log()
    kw = dict(max_iter=5, rank=6)
    pm = AccessAnomaly(device="cpu", **kw).fit(Table(dict(cols)))
    probe = Table({k: v[::7] for k, v in cols.items()})
    want = pm.transform(probe)["anomaly_score"]
    path = str(tmp_path / "aa")
    pm.save(path)
    loaded = PipelineStage.load(path)
    assert isinstance(loaded, AccessAnomalyModel)
    loaded.set(device="cpu")
    _equal(want, loaded.transform(probe)["anomaly_score"])
    _states_equal(pm, loaded, text_as_str=True)

    rm = ref_aa.AccessAnomaly(**kw).fit(RefTable(dict(cols)))
    carried = aa.access_anomaly_from_reference(rm, device="cpu")
    _states_equal(rm, carried)
    a = rm.transform(RefTable({k: v[::7] for k, v in cols.items()}))[
        "anomaly_score"]
    b = carried.transform(probe)["anomaly_score"]
    assert _rel(b, a) <= 1e-6, _rel(b, a)


def test_default_device_is_the_card(monkeypatch):
    """`device=None` means the card: without one the fit raises, and
    nothing moves to the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AccessAnomaly(max_iter=1).fit(Table(_access_log()))
