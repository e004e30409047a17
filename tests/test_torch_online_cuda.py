"""VW and the online learner on the card: the deterministic segmented
sum, card fits and learners against the port's CPU path, and the
sparse-pair serving kernel's replies against `transform`.

Every test here carries the `gpu` marker and skips without a card. This
file imports neither jax nor the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_online_cuda.py

Tolerances: two card fits, two card learners fed the same chunks, and
two card segmented sums are equal bit for bit; card weights within
`_CARD_RTOL` of the CPU path's largest weight (the card's segmented
reduction adds each group in a tree, the CPU in input order), BFGS within
`_BFGS_RTOL`; served replies equal `transform`'s labels exactly.
"""
import json
import urllib.request

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.models.vw import (VowpalWabbitClassifier,
                                          VowpalWabbitRegressor)
from mmlspark_tpu_torch.models.vw import learner
from mmlspark_tpu_torch.online import OnlineLearner
from mmlspark_tpu_torch.parallel import data_mesh

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_CARD_RTOL = 1e-5
_BFGS_RTOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pairs(seed=0, n=20_000, k=24, bits=14, vocab=3000):
    """Hashed pairs whose slots repeat thousands of times per batch
    (vocab << rows x k), a logistic truth over them."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, vocab, size=(n, k)).astype(np.int32) * 7
    val = rng.normal(size=(n, k)).astype(np.float32)
    truth = rng.normal(size=1 << bits).astype(np.float32)
    margin = (truth[idx & ((1 << bits) - 1)] * val).sum(1) * 0.2
    y = (rng.random(n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    return {"features_idx": idx, "features_val": val, "label": y}


_KW = dict(features_col="features", label_col="label", num_bits=14,
           num_tasks=1)


def _close(got, want, rtol):
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.mark.gpu
def test_segment_sum_repeats_itself_on_the_card(cuda_device):
    rng = np.random.default_rng(1)
    flat_idx = torch.as_tensor(rng.integers(0, 64, 200_000)
                               .astype(np.int32))
    flat_g = torch.as_tensor(rng.normal(size=200_000).astype(np.float32))
    a = learner._segment_sum(flat_idx.to(cuda_device),
                             flat_g.to(cuda_device), 1 << 12)
    b = learner._segment_sum(flat_idx.to(cuda_device),
                             flat_g.to(cuda_device), 1 << 12)
    assert torch.equal(a, b)
    want = np.zeros(1 << 12)
    np.add.at(want, flat_idx.numpy(), flat_g.numpy().astype(np.float64))
    np.testing.assert_allclose(a.cpu().numpy(), want, rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("cls, extra", [
    (VowpalWabbitClassifier, {}),
    (VowpalWabbitClassifier, {"num_passes": 2, "l2": 1e-5}),
    (VowpalWabbitRegressor, {"mode": "sgd", "l1": 1e-6})])
def test_card_fits_repeat_and_match_cpu(cuda_device, cls, extra):
    t = Table(_pairs())
    a = cls(**_KW, **extra).fit(t)
    b = cls(**_KW, **extra).fit(t)
    np.testing.assert_array_equal(a._weights, b._weights)
    assert a._bias == b._bias
    cpu = cls(device="cpu", **_KW, **extra).fit(t)
    _close(a._weights, cpu._weights, _CARD_RTOL)
    assert abs(a._bias - cpu._bias) <= _CARD_RTOL * float(
        np.abs(cpu._weights).max())
    assert a.quality_profile is not None and a.lineage is not None


@pytest.mark.gpu
def test_card_mesh_fit_repeats_and_matches_cpu(cuda_device):
    t = Table(_pairs(seed=2, n=9_001))
    kw = dict(_KW, num_tasks=4, num_passes=2)
    a = VowpalWabbitClassifier(mesh=data_mesh(devices=[cuda_device] * 4),
                               **kw).fit(t)
    b = VowpalWabbitClassifier(mesh=data_mesh(devices=[cuda_device] * 4),
                               **kw).fit(t)
    np.testing.assert_array_equal(a._weights, b._weights)
    cpu = VowpalWabbitClassifier(device="cpu", **kw).fit(t)
    _close(a._weights, cpu._weights, _CARD_RTOL)


@pytest.mark.gpu
def test_card_bfgs_matches_cpu(cuda_device):
    t = Table(_pairs(seed=3, n=4_000))
    kw = dict(_KW, mode="bfgs", bfgs_iters=6)
    a = VowpalWabbitClassifier(**kw).fit(t)
    cpu = VowpalWabbitClassifier(device="cpu", **kw).fit(t)
    _close(a._weights, cpu._weights, _BFGS_RTOL)


@pytest.mark.gpu
def test_card_learners_repeat_and_match_cpu(cuda_device):
    d = _pairs(seed=4, n=4_096, k=16)
    params = learner.VWParams(loss_function="logistic", num_bits=14)
    snaps = []
    for dev in (cuda_device, cuda_device, "cpu"):
        lrn = OnlineLearner(params, rows=256, device=dev)
        for lo in range(0, 4_096, 512):
            lrn.partial_fit(d["features_idx"][lo:lo + 512],
                            d["features_val"][lo:lo + 512],
                            d["label"][lo:lo + 512])
        snaps.append(lrn.snapshot())
    a, b, cpu = snaps
    for key in ("weights", "acc"):
        np.testing.assert_array_equal(a[key], b[key])
    assert a["bias"] == b["bias"]
    _close(a["weights"], cpu["weights"], _CARD_RTOL)
    # a restore on the card rewinds exactly
    lrn = OnlineLearner(params, rows=256, device=cuda_device)
    lrn.restore(a)
    again = lrn.snapshot()
    np.testing.assert_array_equal(again["weights"], a["weights"])


@pytest.mark.gpu
def test_sparse_kernel_replies_equal_transform(cuda_device):
    from mmlspark_tpu_torch.io import serve_pipeline
    d = _pairs(seed=5, n=2_000, k=16)
    model = VowpalWabbitClassifier(**_KW).fit(Table(d))
    rows = Table({c: d[c][:300] for c in ("features_idx", "features_val")})
    want = model.transform(rows)["prediction"]
    kernel = model._serving_kernel("prediction")
    np.testing.assert_array_equal(
        kernel(d["features_idx"][:300], d["features_val"][:300]), want)
    server, q = serve_pipeline(model, ["features_idx", "features_val"],
                               max_batch=64)
    try:
        assert q.transform_fn._handle.kernel.sparse_pairs
        got = []
        for i in range(300):
            # ragged rows: the plan pads pairs to the k bucket
            k = 16 - (i % 5)
            body = json.dumps({
                "features_idx": d["features_idx"][i, :k].tolist(),
                "features_val": d["features_val"][i, :k].tolist()})
            req = urllib.request.Request(
                server.address, data=body.encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                got.append(json.loads(resp.read())["prediction"])
    finally:
        q.stop()
        server.stop()
    ragged = model.transform(Table({
        "features_idx": np.stack([np.pad(d["features_idx"][i, :16 - i % 5],
                                         (0, i % 5)) for i in range(300)]),
        "features_val": np.stack([np.pad(d["features_val"][i, :16 - i % 5],
                                         (0, i % 5)) for i in range(300)])}))
    np.testing.assert_array_equal(np.asarray(got), ragged["prediction"])
