"""The CUDA flash-attention forward against its plain version, on the card.

Every test here carries the `gpu` marker and skips without a card. This
file imports neither jax nor the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_flash_attention_cuda.py

Tolerances: f32 holds out and lse to 2e-5 (both sides sum exact f32
products, in another order); bf16 holds lse to 2e-5 (f32 scores of the
same bf16 inputs) and out, per element, to 2^-7 |plain| + 2^-6 r with
r = `_bf16_rounding_scale` (sqrt(sum p^2 v^2) / sum p): one bf16 ulp of
the output plus ~10 standard deviations of what rounding p at another
point does (the kernel rounds p to bf16 against each tile's running max,
the plain version against the row's final max). A kernel that reads V
one key off fails that limit (`test_bf16_limit_rejects_v_one_key_off`).
bf16 runs on the tensor cores (`flash_fwd_mma`), and so does f32, each
operand split into three bf16 terms (`flash_fwd_split3`;
`test_bf16_kernels_run_on_the_tensor_cores`); the cases where an
`mma.sync` design breaks are here: Sq not a multiple of 16, Sk of 8 and 72,
near-uniform attention, large scores, strided inputs.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.ops import flash_attention as fa

_F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _bf16_limit(q, k, v, causal, scale, want):
    r = fa._bf16_rounding_scale(q, k, v, causal, scale)
    return 2.0 ** -7 * want.float().abs() + 2.0 ** -6 * r


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(sq, sk, h, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.normal(size=(s, h, d)).astype(np.float32))
               .to(device=device, dtype=dtype) for s in (sq, sk, sk))
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,h,d", [(384, 384, 4, 64),   # 6 full tiles
                                       (300, 300, 2, 128),  # ragged edge
                                       (96, 40, 2, 32),     # cross, Sk < tile
                                       (96, 320, 2, 16),    # cross, Sk > Sq
                                       (257, 257, 8, 16),   # the stage's D
                                       (200, 200, 2, 64),   # Sq % 16 != 0
                                       (96, 8, 2, 64),      # Sk = 8
                                       (100, 72, 2, 128)])  # Sk = 72
def test_kernel_matches_plain(cuda_device, sq, sk, h, d, dtype, causal):
    q, k, v = _qkv(sq, sk, h, d, dtype, cuda_device)
    scale = 1.0 / d ** 0.5
    got, got_lse = fa.flash_fwd(q, k, v, causal, scale)
    want, want_lse = fa._flash_forward_lse_plain(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (sq, h, d)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **_F32_TOL)
    else:
        lim = _bf16_limit(q, k, v, causal, scale, want)
        assert bool(((got.float() - want.float()).abs() <= lim).all())
    torch.testing.assert_close(got_lse, want_lse, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_limit_rejects_v_one_key_off(cuda_device, causal):
    """The bf16 limit is tight enough to see a load one row off: the
    kernel's output on V shifted by one key fails it at most outputs."""
    q, k, v = _qkv(384, 384, 4, 64, torch.bfloat16, cuda_device)
    want = fa._flash_forward_lse_plain(q, k, v, causal, 0.125)[0]
    lim = _bf16_limit(q, k, v, causal, 0.125, want)
    shifted = fa.flash_fwd(q, k, v.roll(1, 0), causal, 0.125)[0]
    assert float(((shifted.float() - want.float()).abs() > lim)
                 .float().mean()) > 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_near_uniform_attention(cuda_device, causal):
    """q = 0: every score is 0 and every p exactly 1, so lse is the log
    of the visible keys' count and out their mean (p = 1 rounds exactly
    against any running max)."""
    _, k, v = _qkv(200, 200, 2, 64, torch.bfloat16, cuda_device)
    q = torch.zeros_like(k)
    got, lse = fa.flash_fwd(q, k, v, causal, 0.125)
    want, want_lse = fa._flash_forward_lse_plain(q, k, v, causal, 0.125)
    lim = _bf16_limit(q, k, v, causal, 0.125, want)
    assert bool(((got.float() - want.float()).abs() <= lim).all())
    n = torch.arange(1, 201, device=cuda_device) if causal else 200
    torch.testing.assert_close(lse, torch.log(n * torch.ones(
        2, 200, device=cuda_device)), rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_large_scores(cuda_device, causal):
    """Scores 10x the usual scale: the running max moves by tens, alpha
    underflows to 0 and most p are 0; out and lse still match."""
    q, k, v = _qkv(300, 300, 2, 64, torch.bfloat16, cuda_device, seed=3)
    scale = 10 / 8
    got, lse = fa.flash_fwd(q, k, v, causal, scale)
    want, want_lse = fa._flash_forward_lse_plain(q, k, v, causal, scale)
    lim = _bf16_limit(q, k, v, causal, scale, want)
    assert bool(((got.float() - want.float()).abs() <= lim).all())
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_bf16_kernels_run_on_the_tensor_cores(cuda_device):
    """Every instantiation (both forms, each D) holds tensor-core
    instructions in its SASS: the bf16 kernel and the f32 one, whose
    operands are split into three bf16 terms."""
    import chip_smoke
    from mmlspark_tpu_torch.ops import _build
    _build.load("flash_attention")
    want = {(f, c, d) for f in ("normalized", "stats") for c in (0, 1)
            for d in fa.HEAD_DIMS}
    counts = chip_smoke._mma_build_checks(
        "flash_attention", None, chip_smoke._fwd_mma_key, want)
    assert set(counts) == want


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_f32_near_uniform_and_large_scores(cuda_device, causal):
    """f32 at q = 0 (every p exactly 1: lse is the log of the visible
    keys' count) and at 10x the usual scale (alpha underflows to 0)."""
    _, k, v = _qkv(200, 200, 2, 64, torch.float32, cuda_device)
    q = torch.zeros_like(k)
    got, lse = fa.flash_fwd(q, k, v, causal, 0.125)
    want, _ = fa._flash_forward_lse_plain(q, k, v, causal, 0.125)
    torch.testing.assert_close(got, want, **_F32_TOL)
    n = torch.arange(1, 201, device=cuda_device) if causal else 200
    torch.testing.assert_close(lse, torch.log(n * torch.ones(
        2, 200, device=cuda_device)), **_F32_TOL)
    q = _qkv(300, 300, 2, 64, torch.float32, cuda_device, seed=3)[0]
    k, v = _qkv(300, 300, 2, 64, torch.float32, cuda_device, seed=4)[1:]
    got, lse = fa.flash_fwd(q, k, v, causal, 1.25)
    want, want_lse = fa._flash_forward_lse_plain(q, k, v, causal, 1.25)
    torch.testing.assert_close(got, want, **_F32_TOL)
    torch.testing.assert_close(lse, want_lse, **_F32_TOL)


@pytest.mark.gpu
def test_strided_inputs(cuda_device):
    """q/k/v read through their strides: slices of one (S, 3, H, D)
    projection, as a fused qkv matmul would give them, f32 and bf16."""
    rng = np.random.default_rng(1)
    qkv = torch.as_tensor(rng.normal(size=(200, 3, 4, 64)).astype(
        np.float32)).to(cuda_device)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    got, lse = fa.flash_fwd(q, k, v, True, 0.125)
    want, want_lse = fa._flash_forward_lse_plain(q, k, v, True, 0.125)
    torch.testing.assert_close(got, want, **_F32_TOL)
    torch.testing.assert_close(lse, want_lse, **_F32_TOL)
    qkv = qkv.bfloat16()
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    got, lse = fa.flash_fwd(q, k, v, True, 0.125)
    want, want_lse = fa._flash_forward_lse_plain(q, k, v, True, 0.125)
    lim = _bf16_limit(q, k, v, True, 0.125, want)
    assert bool(((got.float() - want.float()).abs() <= lim).all())
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_dispatch_launches_kernel_and_counts(cuda_device):
    """A CUDA tensor goes to the kernel, never the plain version, and each
    launch counts; what the kernel does not take raises."""
    q, k, v = _qkv(128, 128, 2, 64, torch.float32, cuda_device)
    fa.reset_launches()
    fa.flash_attention(q, k, v, causal=True)
    assert fa.launches == {"flash_fwd": 1, "flash_stats_fwd": 0,
                           "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0}
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half())
    assert fa.launches == {"flash_fwd": 1, "flash_stats_fwd": 0,
                           "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0}
