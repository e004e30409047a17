"""The fleet workloads on the card: the isolation forest's descent, the
SAR fit and its top-k, and KNN, each against the port's CPU path on the
same inputs.

Every test here carries the `gpu` marker and skips without a card. This
file imports neither jax nor the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_fleet_cuda.py

Tolerances: isolation-forest scores within rtol 1e-6 of the CPU path
(the path sum is exact in float64; only `pow` may differ by an ulp); the
SAR tables of a card fit equal to the CPU fit's (affinity within 1e-6,
co-occurrence counts exact) and two card fits bit-identical, also where
pairs repeat thousands of times; users outside the fitted range answer
items -1 and ratings NaN on the card; SAR and KNN
top-k lists equal to the CPU path's except at ties (a swap between
entries whose float64 scores are within rtol 1e-5), distances within
rtol 1e-5, with cuBLAS's TF32 flag ON outside the port's scope.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.nn import KNN, ConditionalKNN
from mmlspark_tpu_torch.ops.topk import top_k
from mmlspark_tpu_torch.parallel import data_mesh
from mmlspark_tpu_torch.workloads import IsolationForestScorer, SARServing

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_SCORE_RTOL = 1e-6
_TIE_RTOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def tf32_on():
    """A caller that lets cuBLAS run f32 products in TF32: the port's
    products must scope it off themselves."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


def _agree(idx_a, idx_b, exact):
    """Index lists equal except where the swapped entries' float64
    scores are within `_TIE_RTOL`."""
    for r in range(idx_a.shape[0]):
        for a, b in zip(idx_a[r], idx_b[r]):
            if a != b:
                va, vb = exact[r, int(a)], exact[r, int(b)]
                assert abs(va - vb) <= _TIE_RTOL * max(abs(va), abs(vb)), r


@pytest.mark.gpu
def test_iforest_descent_matches_cpu(cuda_device):
    rng = np.random.default_rng(0)
    x = np.vstack([rng.normal(size=(19_000, 8)),
                   rng.normal(4.0, 1.0, size=(1_000, 8))])
    kw = dict(num_estimators=50, max_samples=256, seed=1)
    card = IsolationForestScorer(**kw).fit(Table({"features": x}))
    cpu = IsolationForestScorer(device="cpu", **kw).fit(
        Table({"features": x}))
    for name in ("_split_feat", "_split_thresh", "_is_leaf", "_path_value"):
        np.testing.assert_array_equal(getattr(card, name), getattr(cpu, name))
    got = card.transform(Table({"features": x}))["outlierScore"]
    want = cpu.transform(Table({"features": x}))["outlierScore"]
    np.testing.assert_allclose(got, want, rtol=_SCORE_RTOL)
    np.testing.assert_array_equal(card.scoring_plan()(x[:300]), got[:300])


def _events(seed=0, n=20_000, users=600, items=400):
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, items + 1)
    return {"user": rng.integers(0, users, n),
            "item": rng.choice(items, size=n, p=pop / pop.sum()),
            "rating": rng.integers(1, 6, n).astype(np.float64),
            "timestamp": rng.uniform(0, 3 * 365 * 86400.0, n)}


@pytest.mark.gpu
@pytest.mark.parametrize("sim", ["jaccard", "lift", "cooccurrence"])
def test_sar_fit_matches_cpu_and_repeats(cuda_device, sim):
    ev = _events()
    kw = dict(support_threshold=2, similarity_function=sim)
    a = SARServing(**kw).fit(Table(ev))
    b = SARServing(**kw).fit(Table(ev))
    cpu = SARServing(device="cpu", **kw).fit(Table(ev))
    assert np.array_equal(a._affinity, b._affinity)
    assert np.array_equal(a._similarity, b._similarity)
    np.testing.assert_allclose(a._affinity, cpu._affinity, rtol=1e-6)
    if sim == "cooccurrence":
        np.testing.assert_array_equal(a._similarity, cpu._similarity)
    else:
        np.testing.assert_allclose(a._similarity, cpu._similarity,
                                   rtol=1e-6)


@pytest.mark.gpu
def test_sar_repeated_pairs_fit_repeats(cuda_device):
    """An implicit-feedback log whose pairs repeat thousands of times:
    two card fits bit-identical, the affinity within 1e-6 of the CPU's."""
    rng = np.random.default_rng(4)
    n, users, items = 200_000, 300, 200
    keys = rng.zipf(1.2, n) % (users * items)
    ev = {"user": keys // items, "item": keys % items,
          "timestamp": rng.uniform(0, 3 * 365 * 86400.0, n)}
    assert np.bincount(keys).max() > 1000
    kw = dict(support_threshold=2)
    a = SARServing(**kw).fit(Table(ev))
    b = SARServing(**kw).fit(Table(ev))
    cpu = SARServing(device="cpu", **kw).fit(Table(ev))
    assert np.array_equal(a._affinity, b._affinity)
    assert np.array_equal(a._similarity, b._similarity)
    np.testing.assert_allclose(a._affinity, cpu._affinity, rtol=1e-6)


@pytest.mark.gpu
def test_sar_unknown_users_answer_on_the_card(cuda_device):
    """Ids outside the fitted user range answer items -1 / ratings NaN on
    the plain recommend path and on `serve_pipeline(fast_path=False)`,
    and the card goes on answering (no device-side assert)."""
    import json
    import urllib.request

    from mmlspark_tpu_torch.io.serving import serve_pipeline
    m = SARServing(support_threshold=2,
                   num_recommendations=5).fit(Table(_events(2)))
    ids = np.array([-1, m.n_users, 10**6, 3])
    rec = m.recommend_for_user_subset(ids, 5)
    assert (rec["recommendations"][:3] == -1).all()
    assert np.isnan(rec["ratings"][:3]).all()
    want = m.recommend_plan()(np.array([3]))
    np.testing.assert_array_equal(rec["recommendations"][3], want[0, 0])
    server, q = serve_pipeline(m, ["user"], output_col="recommendations",
                               fast_path=False)
    try:
        got = []
        for u in (10**6, 3):
            req = urllib.request.Request(
                server.address, data=json.dumps({"user": u}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                got.append(json.loads(resp.read())["recommendations"])
    finally:
        q.stop()
        server.stop()
    assert got[0][0] == [-1.0] * 5 and all(np.isnan(got[0][1]))
    assert got[1] == want[0].tolist()


@pytest.mark.gpu
def test_sar_top_k_matches_cpu_on_every_mesh(cuda_device, tf32_on):
    m = SARServing(support_threshold=2,
                   num_recommendations=10).fit(Table(_events(1)))
    ids = np.arange(m.n_users)
    one = m.recommend_plan()(ids)
    four = m.recommend_plan(mesh=data_mesh(
        devices=[cuda_device] * 4, span_processes=False))(ids)
    np.testing.assert_array_equal(one, four)
    want = m.copy({"device": "cpu"}).recommend_plan()(ids)
    exact = (m._affinity.astype(np.float64)
             @ m._similarity.astype(np.float64))
    _agree(one[:, 0], want[:, 0], exact)
    np.testing.assert_allclose(one[:, 1], want[:, 1], rtol=1e-6)


@pytest.mark.gpu
def test_top_k_ties_match_cpu(cuda_device):
    rng = np.random.default_rng(2)
    s = rng.integers(0, 4, size=(64, 3000)).astype(np.float32)
    vc, ic = top_k(torch.as_tensor(s, device=cuda_device), 17)
    vh, ih = top_k(torch.as_tensor(s), 17)
    assert torch.equal(ic.cpu(), ih) and torch.equal(vc.cpu(), vh)


@pytest.mark.gpu
def test_knn_matches_cpu(cuda_device, tf32_on):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(20_000, 128)).astype(np.float32)
    labels = rng.integers(0, 16, size=20_000)
    q = rng.normal(size=(300, 128)).astype(np.float32)
    conds = np.empty(300, dtype=object)
    for i in range(300):
        conds[i] = list(rng.choice(16, size=3, replace=False))
    index = Table({"features": x, "values": np.arange(20_000),
                   "labels": labels})
    queries = Table({"features": q, "conditioner": conds})
    exact = q.astype(np.float64) @ x.astype(np.float64).T
    for est in (KNN(k=10), ConditionalKNN(k=10)):
        card = est.fit(index)
        cpu = card.copy({"device": "cpu"})
        got, want = card.transform(queries), cpu.transform(queries)
        _agree(got["output.value"], want["output.value"], exact)
        np.testing.assert_allclose(got["output.distance"],
                                   want["output.distance"], rtol=_TIE_RTOL)
