"""CyberML's AccessAnomaly on the card, against the port's CPU path.

Every test here carries the `gpu` marker and skips without a card. This
file imports neither jax nor the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cyber_cuda.py

Tolerances: two card fits are equal bit for bit (f32 products with TF32
off, batched solves, no atomics); the card's factors within
`_FACTOR_RTOL` of the CPU fit's largest |factor| and its scores within
`_SCORE_RTOL` of the largest |score| (cuBLAS and the CPU add the grams'
products in other orders; tests/test_torch_cyber.py holds the CPU path
to the reference within the same limits). The dense matrices are equal
to the CPU's bit for bit.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.cyber import AccessAnomaly
from mmlspark_tpu_torch.cyber import access_anomaly as aa

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_FACTOR_RTOL = 1e-4
_SCORE_RTOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _log(n_rows=60_000, n_users=2_000, n_res=1_500, groups=10, seed=0):
    """Users in groups, each reaching its own group's resources; two
    tenants, the second small."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, groups, n_rows)
    u = g * (n_users // groups) + rng.integers(0, n_users // groups, n_rows)
    r = g * (n_res // groups) + rng.integers(0, n_res // groups, n_rows)
    ten = (rng.random(n_rows) < 0.1).astype(np.int64)
    return {"tenant": ten, "user": u, "res": r,
            "count": rng.integers(1, 20, n_rows).astype(np.float64)}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.gpu
def test_two_card_fits_bit_identical(cuda_device):
    t = Table(_log())
    kw = dict(likelihood_col="count", device=cuda_device)
    a = AccessAnomaly(**kw).fit(t)
    b = AccessAnomaly(**kw).fit(t)
    assert sorted(a._models) == sorted(b._models) == ["0", "1"]
    for k in a._models:
        ul, uv, rl, rv, mean, std = a._models[k]
        ul2, uv2, rl2, rv2, mean2, std2 = b._models[k]
        assert uv.device.type == cuda_device.type
        assert torch.equal(uv, uv2) and torch.equal(rv, rv2)
        assert (mean, std) == (mean2, std2)


@pytest.mark.gpu
def test_matrices_equal_cpu(cuda_device):
    cols = _log()
    m = cols["tenant"] == 0
    ul, u_ix = np.unique(cols["user"][m], return_inverse=True)
    rl, r_ix = np.unique(cols["res"][m], return_inverse=True)
    keys, sums = aa.pair_sums(u_ix, r_ix, cols["count"][m], len(rl))
    got = aa.tenant_matrices(keys, sums, len(ul), len(rl), 5.0, 10.0, 1.0,
                             2, cuda_device)
    want = aa.tenant_matrices(keys, sums, len(ul), len(rl), 5.0, 10.0, 1.0,
                              2, torch.device("cpu"))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_card_against_cpu_and_unseen(cuda_device):
    cols = _log(seed=1)
    t = Table(cols)
    card = AccessAnomaly(likelihood_col="count", device=cuda_device).fit(t)
    cpu = AccessAnomaly(likelihood_col="count", device="cpu").fit(t)
    for k in ("0", "1"):
        _, uv, _, rv, _, _ = card._models[k]
        _, cuv, _, crv, _, _ = cpu._models[k]
        assert _rel(uv.cpu(), cuv) <= _FACTOR_RTOL
        assert _rel(rv.cpu(), crv) <= _FACTOR_RTOL
    rng = np.random.default_rng(2)
    probe = Table({"tenant": rng.integers(0, 3, 5_000),
                   "user": rng.integers(0, 2_100, 5_000),
                   "res": rng.integers(0, 1_600, 5_000)})
    a = card.transform(probe)["anomaly_score"]
    b = cpu.transform(probe)["anomaly_score"]
    assert a.dtype == np.float64
    assert _rel(a, b) <= _SCORE_RTOL
    # users and resources a tenant never saw, and the unknown tenant,
    # score 0
    seen = np.zeros(len(a), bool)
    for ten in (0, 1):
        m = cols["tenant"] == ten
        seen |= ((probe["tenant"] == ten)
                 & np.isin(probe["user"], cols["user"][m])
                 & np.isin(probe["res"], cols["res"][m]))
    unseen = ~seen
    assert unseen.sum() > 100
    assert (a[unseen] == 0.0).all() and (b[unseen] == 0.0).all()
    assert (a[seen] != 0.0).all() and (b[seen] != 0.0).all()
