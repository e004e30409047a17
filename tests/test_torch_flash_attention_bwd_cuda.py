"""The CUDA flash-attention backward kernels (dq, dk/dv) against their
plain version, on the card.

Every test here carries the `gpu` marker and skips without a card. This
file imports neither jax nor the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_flash_attention_bwd_cuda.py

Tolerances are per element, `flash_attention._BWD_TOL` against the
output's magnitude and its term scale r (`_bwd_term_scales`, the root sum
of squares of the terms it sums): f32 2^-21 |plain| + 2^-18 sqrt(n) r (a
few ulps plus ~45 standard deviations of summing n terms in another
order); bf16 2^-7 |plain| + 2^-8 r (one output ulp plus the terms whose p
or ds rounds to the neighbouring bf16 value on one side only). The bf16
limit rejects the kernels run on dO shifted by one query row
(`test_bf16_limit_rejects_do_one_row_off`).
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(sq, sk, h, d, dtype, device, causal, scale, seed=0):
    """q, k, v, dO in `dtype` and the forward's lse and dsum = rowsum(dO*O)
    in f32, from seeded numpy."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.as_tensor(rng.normal(size=(s, h, d)).astype(
        np.float32)).to(device=device, dtype=dtype) for s in (sq, sk, sk, sq))
    out, lse = fa._flash_forward_lse_plain(q, k, v, causal, scale)
    dsum = (do.float() * out.float()).sum(-1).T.contiguous()
    return q, k, v, do, lse, dsum


def _share_of_limit(got, want, lims):
    return max(float(((g.float() - w.float()).abs() / lim).max())
               for g, w, lim in zip(got, want, lims))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,h,d", [(384, 384, 4, 64),   # 6 full tiles
                                       (300, 300, 2, 128),  # ragged edge
                                       (96, 40, 2, 32),     # cross, Sk < tile
                                       (96, 320, 2, 16),    # cross, Sk > Sq
                                       (257, 257, 8, 16)])
def test_kernels_match_plain(cuda_device, sq, sk, h, d, dtype, causal):
    scale = 1.0 / d ** 0.5
    ops = _operands(sq, sk, h, d, dtype, cuda_device, causal, scale)
    dq = fa.flash_bwd_dq(*ops, causal, scale)
    dk, dv = fa.flash_bwd_dkv(*ops, causal, scale)
    want = fa._flash_backward_plain(*ops, causal, scale)
    torch.cuda.synchronize()
    for g, w in zip((dq, dk, dv), want):
        assert g.dtype == dtype and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all())
    lims = fa._bwd_limits(*ops, causal, scale, want)
    assert _share_of_limit((dq, dk, dv), want, lims) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_limit_rejects_do_one_row_off(cuda_device, causal):
    """The bf16 limit sees a load one row off: the kernels' gradients on
    dO shifted by one query row fail it at most outputs of each."""
    ops = _operands(384, 384, 4, 64, torch.bfloat16, cuda_device, causal,
                    0.125)
    q, k, v, do, lse, dsum = ops
    want = fa._flash_backward_plain(*ops, causal, 0.125)
    lims = fa._bwd_limits(*ops, causal, 0.125, want)
    shifted = do.roll(1, 0)
    got = (fa.flash_bwd_dq(q, k, v, shifted, lse, dsum, causal, 0.125),
           *fa.flash_bwd_dkv(q, k, v, shifted, lse, dsum, causal, 0.125))
    for g, w, lim in zip(got, want, lims):
        assert float(((g.float() - w.float()).abs() > lim).float().mean()) \
            > 0.5


@pytest.mark.gpu
def test_deterministic_and_strided(cuda_device):
    """q/k/v read through their strides (slices of one (S, 3, H, D)
    projection, as a fused qkv matmul gives them); no atomics, so two runs
    agree bit for bit."""
    rng = np.random.default_rng(1)
    qkv = torch.as_tensor(rng.normal(size=(200, 3, 4, 64)).astype(
        np.float32)).to(cuda_device)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    do = torch.as_tensor(rng.normal(size=(200, 4, 64)).astype(
        np.float32)).to(cuda_device)
    out, lse = fa._flash_forward_lse_plain(q, k, v, True, 0.125)
    dsum = (do * out).sum(-1).T.contiguous()
    runs = [(fa.flash_bwd_dq(q, k, v, do, lse, dsum, True, 0.125),
             *fa.flash_bwd_dkv(q, k, v, do, lse, dsum, True, 0.125))
            for _ in range(2)]
    want = fa._flash_backward_plain(q, k, v, do, lse, dsum, True, 0.125)
    lims = fa._bwd_limits(q, k, v, do, lse, dsum, True, 0.125, want)
    assert _share_of_limit(runs[0], want, lims) <= 1.0
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_autograd_launches_kernels_and_counts(cuda_device):
    """A gradient through `flash_attention` on CUDA tensors launches the
    two kernels once each, never the plain version; only what autograd
    asks for runs (dv alone: the dk/dv kernel only)."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.as_tensor(rng.normal(size=(128, 2, 64)).astype(
        np.float32)).to(cuda_device).bfloat16().requires_grad_()
        for _ in range(3))
    fa.reset_launches()
    fa.flash_attention(q, k, v, causal=True).float().sum().backward()
    assert fa.launches == {"flash_fwd": 1, "flash_stats_fwd": 0,
                           "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16
    q2, k2 = q.detach(), k.detach()
    fa.reset_launches()
    fa.flash_attention(q2, k2, v, causal=True).float().sum().backward()
    assert fa.launches == {"flash_fwd": 1, "flash_stats_fwd": 0,
                           "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 1}
    with pytest.raises(ValueError, match="dO must have"):
        fa.flash_bwd_dq(q2, k2, v.detach(), q2[:64], *(
            torch.zeros(2, 128, device=cuda_device) for _ in range(2)),
            True, 0.125)
