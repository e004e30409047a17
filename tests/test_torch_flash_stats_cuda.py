"""The CUDA flash stats forward and the offset-aware backward kernels
against their plain versions, on the card.

Every test here carries the `gpu` marker and skips without a card. This
file imports neither jax nor the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_flash_stats_cuda.py

Pairs of one ring step, 256-row shards at global offsets on the 64-key
grid: diagonal, fully visible, fully masked (every row flagged) and
non-causal. The forward is held by `chip_smoke._stats_check`, the card
check's own: on live rows m and lse = m + log l within (1e-5, 1e-4), and
acc / l within 2e-5 (f32) or, per element, 2^-7 |plain| + 2^-6 r with
r = `_bf16_rounding_scale` at the pair's offsets (bf16: the kernel
rounds p against each tile's running max, the plain version against the
row's final max); flagged rows must be exactly acc = 0, l = 0,
m = -1e30. The backward kernels at the same offsets (lse := m,
dsum := -d_l, dO := d_acc in f32) are held per element within
`flash_attention._BWD_TOL`. A kernel run with k_offset one 64-key tile
off fails the forward check both ways: one tile late by the flagged
rows, one tile early by the acc / l limit. Both dtypes run on the tensor
cores and are also held at offsets off the key grid (rows with no visible
key in a computed tile: acc = 0, l = 0 exactly); bf16 also with q = 0 (l
the count of visible keys) and at 10x the usual scale.
"""
import numpy as np
import pytest
import torch

from chip_smoke import _stats_check
from mmlspark_tpu_torch.ops import flash_attention as fa
from mmlspark_tpu_torch.parallel import data_mesh
from mmlspark_tpu_torch.parallel.ring_attention import ring_attention

_S = 256
_PAIRS = {"diagonal": (256, 256, True), "full": (768, 0, True),
          "masked": (0, 768, True), "noncausal": (0, 768, False)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(h, d, dtype, device, seed=0, s=_S):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.normal(size=(s, h, d)).astype(
        np.float32)).to(device=device, dtype=dtype) for _ in range(3))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pair", list(_PAIRS))
@pytest.mark.parametrize("h,d", [(2, 64), (2, 128), (4, 16)])
def test_stats_kernel_matches_plain(cuda_device, pair, h, d, dtype):
    q, k, v = _qkv(h, d, dtype, cuda_device)
    qo, ko, causal = _PAIRS[pair]
    scale = 1.0 / d ** 0.5
    got = fa.flash_stats_fwd(q, k, v, qo, ko, causal, scale)
    want = fa._flash_stats_plain(q, k, v, qo, ko, causal, scale)
    torch.cuda.synchronize()
    res = _stats_check(got, want, q, k, v, qo, ko, causal, scale)
    assert max(res["m"], res["lse"], res["out"]) <= 1.0, res


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shifted_tile_fails_the_check(cuda_device, dtype):
    """The check sees a fault of one tile: the diagonal pair run with
    k_offset one 64-key tile late fails it on the flagged rows (the first
    64 rows lose every key); one tile early keeps the flags, and acc / l
    falls outside its limit at most live outputs."""
    q, k, v = _qkv(2, 64, dtype, cuda_device)
    qo, ko, _ = _PAIRS["diagonal"]
    want = fa._flash_stats_plain(q, k, v, qo, ko, True, 0.125)
    late = fa.flash_stats_fwd(q, k, v, qo, ko + 64, True, 0.125)
    with pytest.raises(AssertionError):
        _stats_check(late, want, q, k, v, qo, ko, True, 0.125)
    early = fa.flash_stats_fwd(q, k, v, qo, ko - 64, True, 0.125)
    res = _stats_check(early, want, q, k, v, qo, ko, True, 0.125)
    assert res["out"] > 1.0 and res["out_outside"] >= 0.5, res


@pytest.mark.gpu
def test_rows_without_a_visible_key_stay_finite(cuda_device):
    """Offsets off the key grid, f32: rows whose keys all lie after them in
    a computed tile end exactly acc = 0, l = 0, m = -1e30, as the plain
    version's (and the bf16 kernel's), and the others are finite."""
    q, k, v = _qkv(2, 32, torch.float32, cuda_device, s=96)
    acc, m, l = fa.flash_stats_fwd(q, k, v, 0, 40, True, 0.25)
    assert bool(torch.isfinite(acc).all() and torch.isfinite(l).all())
    assert bool((m[:, :40] == -1e30).all() and (m[:, 40:] > -1e29).all())
    assert bool((acc[:40] == 0).all() and (l[:, :40] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("q_off,k_off", [(256, 257), (256, 255), (63, 0),
                                         (0, 1), (0, 33)])
def test_f32_offsets_off_the_tile_grid(cuda_device, q_off, k_off):
    """Offsets off the key grid, f32: the rows with no visible key in a
    computed tile come out exactly acc = 0, l = 0, m = -1e30
    (`_stats_check` demands it), and the other rows meet the limits."""
    q, k, v = _qkv(2, 64, torch.float32, cuda_device)
    got = fa.flash_stats_fwd(q, k, v, q_off, k_off, True, 0.125)
    want = fa._flash_stats_plain(q, k, v, q_off, k_off, True, 0.125)
    res = _stats_check(got, want, q, k, v, q_off, k_off, True, 0.125)
    assert max(res["m"], res["lse"], res["out"]) <= 1.0, res


@pytest.mark.gpu
@pytest.mark.parametrize("q_off,k_off", [(256, 257), (256, 255), (63, 0),
                                         (0, 1)])
def test_bf16_offsets_off_the_tile_grid(cuda_device, q_off, k_off):
    """Offsets one key off the 64-key grid: the bf16 kernel's rows with no
    visible key in a computed tile come out exactly acc = 0, l = 0,
    m = -1e30, as the plain version's (`_stats_check` demands it), and
    the other rows meet the limits."""
    q, k, v = _qkv(2, 64, torch.bfloat16, cuda_device)
    got = fa.flash_stats_fwd(q, k, v, q_off, k_off, True, 0.125)
    want = fa._flash_stats_plain(q, k, v, q_off, k_off, True, 0.125)
    res = _stats_check(got, want, q, k, v, q_off, k_off, True, 0.125)
    assert max(res["m"], res["lse"], res["out"]) <= 1.0, res


@pytest.mark.gpu
@pytest.mark.parametrize("pair", ["diagonal", "full", "noncausal"])
def test_bf16_near_uniform_and_large_scores(cuda_device, pair):
    """q = 0 (every p = 1: l is the count of visible keys, exactly) and
    scores at 10x the usual scale (alpha underflows to 0)."""
    _, k, v = _qkv(2, 64, torch.bfloat16, cuda_device)
    qo, ko, causal = _PAIRS[pair]
    q = torch.zeros_like(k)
    acc, m, l = fa.flash_stats_fwd(q, k, v, qo, ko, causal, 0.125)
    want = fa._flash_stats_plain(q, k, v, qo, ko, causal, 0.125)
    assert torch.equal(l, want[2]) and bool((m == 0).all())
    q = _qkv(2, 64, torch.bfloat16, cuda_device, seed=5)[0]
    got = fa.flash_stats_fwd(q, k, v, qo, ko, causal, 1.25)
    want = fa._flash_stats_plain(q, k, v, qo, ko, causal, 1.25)
    res = _stats_check(got, want, q, k, v, qo, ko, causal, 1.25)
    assert max(res["m"], res["lse"], res["out"]) <= 1.0, res


def _bwd_operands(h, d, dtype, device, pair):
    q, k, v = _qkv(h, d, dtype, device)
    qo, ko, causal = _PAIRS[pair]
    scale = 1.0 / d ** 0.5
    _, m, _ = fa._flash_stats_plain(q, k, v, qo, ko, causal, scale)
    rng = np.random.default_rng(7)
    d_acc = torch.as_tensor(rng.normal(size=(_S, h, d)).astype(np.float32)
                            ).to(device)
    d_l = torch.as_tensor(rng.normal(size=(h, _S)).astype(np.float32)
                          ).to(device)
    return (q, k, v, d_acc, m, (-d_l).contiguous()), (causal, scale, qo, ko)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pair", list(_PAIRS))
def test_backward_kernels_at_offsets_match_plain(cuda_device, pair, dtype):
    ops, (causal, scale, qo, ko) = _bwd_operands(2, 64, dtype, cuda_device,
                                                 pair)
    got = (fa.flash_bwd_dq(*ops, causal, scale, qo, ko),
           *fa.flash_bwd_dkv(*ops, causal, scale, qo, ko))
    want = fa._flash_backward_plain(*ops, causal, scale, qo, ko)
    torch.cuda.synchronize()
    lims = fa._bwd_limits(*ops, causal, scale, want, qo, ko)
    for g, w, lim in zip(got, want, lims):
        assert g.dtype == dtype and bool(torch.isfinite(g.float()).all())
        assert bool(((g.float() - w.float()).abs() <= lim).all())
    if pair == "masked":
        assert not any(bool(g.any()) for g in got)


@pytest.mark.gpu
def test_autograd_and_ring_launch_the_kernels(cuda_device):
    """A gradient through `flash_attention_stats` on CUDA tensors launches
    the stats kernel and both backward kernels once each (bf16 inputs, an
    f32 dO); the flash ring over 4 positions of one card launches the
    stats kernel once per pair and agrees with the normalized kernel."""
    q, k, v = (t.requires_grad_() for t in _qkv(2, 64, torch.bfloat16,
                                                 cuda_device))
    fa.reset_launches()
    acc, m, l = fa.flash_attention_stats(q, k, v, 256, 0, True, 0.125)
    (acc / l.T[:, :, None]).sum().backward()
    assert fa.launches == {"flash_fwd": 0, "flash_stats_fwd": 1,
                           "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    assert q.grad.dtype == torch.bfloat16
    q, k, v = _qkv(4, 64, torch.float32, cuda_device, s=1024)
    fa.reset_launches()
    got = ring_attention(q, k, v, mesh=data_mesh(devices=[cuda_device] * 4),
                         causal=True, block_impl="flash")
    assert fa.launches["flash_stats_fwd"] == 16
    want = fa.flash_fwd(q, k, v, True, 0.125)[0]
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
