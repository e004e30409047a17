#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mmlspark_tpu_torch`) on one card.

    python3 chip_smoke.py            # the check: needs one CUDA card
    python3 chip_smoke.py --profile  # also prints torch.profiler tables
                                     # of one boosting iteration and of
                                     # one flash encode_long
    python3 chip_smoke.py --sweep    # also times the shared-memory
                                     # kernel's launch geometries

Phases (any failure exits non-zero before the last line is printed):
  1. card: name and power limit (nvidia-smi), torch's device name;
  2. build: every CUDA source of the port with nvcc for sm_90a, one nvcc
     per source, all started together, with the build seconds and the
     -Xptxas -v register/shared-memory report;
  3. kernels vs plain: each kernel entry point against its plain PyTorch
     version on the same CUDA tensors, at the main path's shapes.
     Histograms: 8M rows x 32 features x 64 bins, m in {1, 2, 4, 8}, with
     inactive rows, both without count_w, as the trainer calls it, and
     with it, and, for the global-atomics kernel, an m*B too large for
     shared memory. Counts must be exactly equal; grad/hess within the
     tolerance stated at `_HIST_RTOL_OF_ABS_SUM`. Flash forward: out and
     lse at S=16384, H=8, D in {128, 64} (the shapes of bench.py's flash
     mode), a ragged S=16000, a cross shape Sq=96/Sk=40 and D=16, each
     in f32 and bf16, causal and not, within `_FLASH_F32_TOL` and the
     bf16 limit at `_BF16_OUT_ULP`, which is shown to reject a kernel
     that reads V one key off. Times from
     CUDA events after warm-up, beside the plain version, one library
     call as the yardstick (`index_add_`; `scaled_dot_product_attention`)
     and the bound;
  4. GBDT main path, two runs, each with the launch counts set to 0 just
     before it and read just after: the headline fit (binning on the
     card, `fit_booster` binary, depth 5, 31 leaves, 64 bins,
     10 iterations at 8M x 32) with exactly 50 shared-memory launches,
     then a 1-iteration max_depth=11 fit whose deepest level needs the
     global-atomics kernel (10 + 1 launches). Between them: bulk and
     serving-sized scoring through `Booster`, and train logloss/AUC
     against a fit whose histograms come from the plain version on the
     card;
  5. encoder main path at the flagship transformer's width (12 layers,
     d_model 1024, 8 heads of 128, d_ff 4096, vocab 2^15, max_len 16384;
     weights from `init_transformer(seed=0)`): `encode_long` on 16,384
     tokens with attention="flash" in f32 and in bf16, and one causal
     `transformer_apply` (the LM's forward), each with the flash count
     set to 0 just before and exactly 12 launches after, each held
     against the same encode with dense attention on the card within
     `_ENCODE_TOL`; then the stage's batched dense `transform()` on 256
     seeded documents of up to 500 words, with a document's embedding
     checked against the same document encoded alone.
Then one JSON line of kernels, the nvidia-smi line, and, last:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet), used for the bounds only
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12      # tensor cores, dense

N_ROWS, N_FEAT, MAX_BIN, N_ITERS, DEPTH = 8_000_000, 32, 63, 10, 5
# grad/hess: |kernel - plain| <= this x (sum of |stat| in the bin). Both
# sides add in an order that changes from run to run (atomics); a sum of
# k f32 values in any order is off by at most ~k * 6e-8 of the sum of
# magnitudes and typically ~sqrt(k) * 6e-8 (k up to ~1.3e5 rows per bin
# here, so ~2e-5); 1e-4 leaves headroom without hiding a wrong bin.
_HIST_RTOL_OF_ABS_SUM = 1e-4
# the kernel fit and the plain-histogram fit may flip splits near gain
# ties; their train metrics must agree this closely
_METRIC_TOL = 2e-3

# the flagship transformer (bench.py:1965-2009, BENCH_EXTRA_r03.json
# lm_training_long_context) as the encoder stage; nothing is cut
ENCODER = dict(vocab_bits=15, d_model=1024, n_heads=8, n_layers=12,
               d_ff=4096, max_len=16384)
SEQ = 16384
N_DOCS, MAX_WORDS = 256, 500
# flash_fwd vs the plain version. f32 out (rtol, atol): sums of up to
# 16k exact products in another order (~sqrt(16k) * 6e-8 relative).
# lse is f32 from f32 scores of the same inputs in both dtypes.
_FLASH_F32_TOL = (2e-5, 2e-5)
# bf16 out, per element: |kernel - plain| <= 2^-7 |plain| + 2^-6 r, with
# r = sqrt(sum_j p_j^2 v_j^2) / sum_j p_j (`_bf16_rounding_scale`). The
# first term is one bf16 ulp of the output (the two sides may round it
# to neighbouring values); the second is ~10 standard deviations of what
# rounding p at different points does (the kernel rounds p to bf16
# against each tile's running max, the plain version against the row's
# final max; each p is off by at most 2^-9 relative, so the difference
# has a std of ~1.6e-3 r). At S=16384, H=8, D=128 a typical output is
# ~0.013 and the limit ~3e-4. On an H100 (80GB HBM3, 700 W) the kernel
# used 0.620-0.756 of this limit over the phase's bf16 shapes (0.657 and
# 0.664 at S=16384, H=8, D=128, non-causal and causal); its output on V
# shifted by one key failed it at 98.5% of the outputs.
_BF16_OUT_ULP, _BF16_P_NOISE = 2.0 ** -7, 2.0 ** -6
_LSE_TOL = (1e-5, 1e-4)
# flash encode vs dense encode on the card, max |diff| of the (16384,
# 1024) output of the final layer norm (unit scale). f32: 12 layers of
# the same f32 math in two summation orders. bf16: p rounded to bf16 at
# different points (tile max vs row max) in each of 12 layers, the
# tolerance of tests/test_transformer.py's bf16 check.
_ENCODE_TOL = {None: 2e-3, "bfloat16": 5e-2}
# a document's pooled embedding in a padded batch vs alone: the same f32
# math, with cuBLAS sums whose order depends on the batch width
_PAD_TOL = 1e-3


def log(*a):
    print(*a, flush=True)


def timed(fn, warmup=3, reps=20):
    """Mean ms per call from CUDA events over `reps` calls after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def card_phase():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[card] nvidia-smi: {smi}")
    log(f"[card] torch: {name}, {torch.cuda.device_count()} device(s), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return smi, name


def build_phase():
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from mmlspark_tpu_torch.ops import _build

    def build(name):
        t = time.perf_counter()
        return _build.build(name), time.perf_counter() - t
    names = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                   if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        reports = dict(zip(names, pool.map(build, names)))
    log(f"[build] {len(names)} sources in parallel: "
        f"{time.perf_counter() - t0:.2f} s")
    for name, (report, secs) in reports.items():
        if report is None:
            log(f"[build] {name}.cu: already built")
            continue
        log(f"[build] {name}.cu: nvcc {secs:.2f} s; ptxas report:")
        for line in report.splitlines():
            if "entry function" in line:
                log(f"  {line.split(chr(39))[1]}")     # the mangled name
            elif "registers" in line or "spill" in line:
                log(f"    {line.strip()}")


def _hist_inputs(gen, dev, n, f, b, m):
    import torch
    bins = torch.randint(0, b, (n, f), dtype=torch.uint8, device=dev,
                         generator=gen)
    grad = torch.randn(n, device=dev, generator=gen)
    hess = torch.rand(n, device=dev, generator=gen) * 0.9 + 0.1
    node = torch.randint(-1, m, (n,), dtype=torch.int32, device=dev,
                         generator=gen)             # -1 = inactive row
    cw = torch.randint(0, 2, (n,), device=dev, generator=gen).float()
    return bins, grad, hess, node, node >= 0, cw


def _index_add_call(bins, grad, hess, node, active, cw, m, b):
    """The library yardstick: ONE `index_add_` computing all three
    histograms from precomputed keys (key prep is outside the timing)."""
    import torch
    n, f = bins.shape
    seg = m * f * b
    keys = ((node.long()[:, None] * f
             + torch.arange(f, device=bins.device)[None, :]) * b
            + bins.long())
    keys = torch.where(active[:, None], keys, seg).reshape(-1)
    vals = torch.stack([grad, hess, cw], 1)[:, None, :].expand(n, f, 3) \
        .reshape(-1, 3).contiguous()
    out = torch.zeros(seg + 1, 3, device=bins.device)
    return lambda: out.zero_().index_add_(0, keys, vals)


def _bound(n, n_active, f, b, m, with_count):
    """(ms, "bytes" or "operations"): the least time for one call. Bytes:
    node for every row; bins, grad, hess (and count_w) for the active rows
    only, which are all the function needs; the three outputs written once.
    Operations: three f32 adds per active (row, feature)."""
    nbytes = 4 * n + n_active * (f + 8 + 4 * with_count) + 3 * m * f * b * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 3 * n_active * f / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def _check_hist(got, want, abs_grad_hist, label):
    """Counts exact; grad/hess within the stated tolerance. Returns the
    max abs error over the three."""
    import torch
    if not torch.equal(got[2], want[2]):
        bad = int((got[2] != want[2]).sum())
        raise AssertionError(f"{label}: {bad} count bins differ")
    err = 0.0
    for name, g, w, scale in (("grad", got[0], want[0], abs_grad_hist),
                              ("hess", got[1], want[1], want[1])):
        diff = (g - w).abs()
        lim = _HIST_RTOL_OF_ABS_SUM * scale.abs() + 1e-6
        if not bool((diff <= lim).all()):
            raise AssertionError(
                f"{label}: {name} off by {float(diff.max())} (limit "
                f"{_HIST_RTOL_OF_ABS_SUM} x sum |{name}| per bin)")
        err = max(err, float(diff.max()))
    return err


def kernel_phase(dev):
    """Each kernel against `_torch_hist` on the same CUDA tensors."""
    import torch
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    from mmlspark_tpu_torch.ops.histogram import _torch_hist
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    cases = [("hist_smem", m, N_FEAT, MAX_BIN + 1) for m in (1, 2, 4, 8)]
    # 3 * 128 * 256 * 4 B = 384 KiB per feature: no block can hold it
    cases.append(("hist_global", 128, N_FEAT, 256))
    for kname, m, f, b in cases:
        inputs = _hist_inputs(gen, dev, N_ROWS, f, b, m)
        bins, grad, hess, node, active, cw = inputs
        kern = getattr(hc, kname)
        if kname == "hist_smem" and hc.smem_bytes_per_feature(m, b) > \
                hc.smem_limit(dev):
            raise AssertionError(f"m={m}, B={b} does not fit shared memory")
        if kname == "hist_global" and hc.smem_bytes_per_feature(m, b) <= \
                hc.smem_limit(dev):
            raise AssertionError("the global-atomics case fits shared memory")
        abs_grad = _torch_hist(bins, grad.abs(), hess, node, active, m, b)[0]
        err = 0.0
        # the trainer passes no count_w (every row counts 1); the
        # reference's callers with weights pass one
        for w in (None, cw):
            got = kern(*inputs[:5], m, b, count_w=w)
            want = _torch_hist(*inputs[:5], m, b, count_w=w)
            torch.cuda.synchronize()
            label = f"{kname} m={m} B={b} count_w " + \
                ("set" if w is not None else "None")
            err = max(err, _check_hist(got, want, abs_grad, label))
            del got, want
        del abs_grad
        ms = timed(lambda: kern(*inputs[:5], m, b))
        plain_ms = timed(lambda: _torch_hist(*inputs[:5], m, b),
                         warmup=1, reps=5)
        lib = _index_add_call(*inputs[:5], torch.ones_like(cw), m, b)
        library_ms = timed(lib, warmup=1, reps=5)
        del lib
        bound_ms, bound_by = _bound(N_ROWS, int(active.sum()), f, b, m,
                                    with_count=False)
        log(f"[kernel] {kname} n={N_ROWS} F={f} B={b} m={m}: match with and "
            f"without count_w (counts exact, max abs err {err:.3g}); "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, one index_add_ "
            f"{library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        results.setdefault(kname, []).append(dict(
            m=m, n=N_ROWS, f=f, b=b, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
            bound_by=bound_by))
        del inputs, bins, grad, hess, node, active, cw
        torch.cuda.empty_cache()
    return results


def sweep_phase(dev):
    """Time `hist_smem_kernel` at the main path's shapes over launch
    geometries: features per block (fg) and row blocks per SM in all.
    Every geometry's output is checked against the plain version."""
    import torch
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    from mmlspark_tpu_torch.ops.histogram import _torch_hist
    gen = torch.Generator(device=dev).manual_seed(1)
    limit, sms = hc.smem_limit(dev), hc._card(dev.index or 0)[1]
    b = MAX_BIN + 1
    for m in (1, 2, 4, 8):
        inputs = _hist_inputs(gen, dev, N_ROWS, N_FEAT, b, m)
        want = _torch_hist(*inputs[:5], m, b)
        abs_grad = _torch_hist(inputs[0], inputs[1].abs(),
                               *inputs[2:5], m, b)[0]
        ops, _ = hc._prepare(*inputs[:5], m, b, None)
        chosen = hc.smem_geometry(N_ROWS, N_FEAT, m, b, dev)
        row = []
        for fg in (1, 2, 4, 8, 16, 32):
            if fg * hc.smem_bytes_per_feature(m, b) > limit:
                continue
            groups = -(-N_FEAT // fg)
            for per_sm in (1, 2, 4, 8, 16, 32):
                rb = max(1, per_sm * sms // groups)
                outs = [torch.zeros(m, N_FEAT, b, device=dev)
                        for _ in range(3)]

                def launch():
                    for o in outs:
                        o.zero_()
                    hc._launch_smem(ops, outs, N_ROWS, N_FEAT, m, b, fg, rb)
                launch()
                torch.cuda.synchronize()
                _check_hist(outs, want, abs_grad, f"sweep m={m} fg={fg}")
                ms = timed(launch, warmup=2, reps=10)
                mark = "*" if (fg, rb) == chosen else ""
                row.append(f"fg{fg}/sm{per_sm}:{ms:.3f}{mark}")
        log(f"[sweep] m={m} (ms; * = the rule's choice) " + " ".join(row))
        del inputs, want, abs_grad, ops
        torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_histograms():
    """Route the trainer's histograms through the plain version for one
    reference fit (the port itself never does: a CUDA tensor always goes
    to the kernel)."""
    from mmlspark_tpu_torch.models.gbdt import trainer
    from mmlspark_tpu_torch.ops.histogram import _torch_hist
    saved = trainer.node_feature_histograms
    trainer.node_feature_histograms = _torch_hist
    try:
        yield
    finally:
        trainer.node_feature_histograms = saved


def _metrics(margin, y):
    """Train logloss and AUC (ties by stable order) on the card."""
    import torch
    p = torch.sigmoid(margin).clamp(1e-15, 1 - 1e-15)
    logloss = float(-(y * p.log() + (1 - y) * (1 - p).log()).mean())
    order = torch.argsort(margin, stable=True)
    ranks = torch.empty_like(margin, dtype=torch.float64)
    ranks[order] = torch.arange(1, margin.shape[0] + 1, device=margin.device,
                                dtype=torch.float64)
    npos = float(y.sum())
    nneg = y.shape[0] - npos
    auc = (float(ranks[y == 1].sum()) - npos * (npos + 1) / 2) / (npos * nneg)
    return logloss, auc


def main_path_phase(dev, profile: bool):
    import dataclasses

    import torch
    from mmlspark_tpu_torch.models.gbdt import BoostParams, fit_booster
    from mmlspark_tpu_torch.ops import binning
    from mmlspark_tpu_torch.ops import histogram_cuda as hc

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N_ROWS, N_FEAT)).astype(np.float32)
    w = rng.normal(size=N_FEAT)
    y = (x @ w + rng.normal(scale=0.5, size=N_ROWS) > 0).astype(np.float32)
    log(f"[main] data {N_ROWS} x {N_FEAT} f32 from numpy seed 0 in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    mapper = binning.fit_bins(x, max_bin=MAX_BIN, seed=0)
    d_bins = binning.apply_bins_device(mapper, x, device=dev)
    d_y = torch.as_tensor(y).to(dev)
    torch.cuda.synchronize()
    log(f"[main] fit_bins + apply_bins_device on the card: "
        f"{time.perf_counter() - t0:.2f} s; bins {tuple(d_bins.shape)} "
        f"{d_bins.dtype} on {d_bins.device}")
    host_check = binning.apply_bins(mapper, x[:100_000])
    if not np.array_equal(d_bins[:100_000].cpu().numpy(), host_check):
        raise AssertionError("device bins differ from host apply_bins")

    params = BoostParams(objective="binary", num_iterations=N_ITERS,
                         num_leaves=31, max_depth=DEPTH, max_bin=MAX_BIN,
                         min_data_in_leaf=20)
    staged = (mapper, d_bins, d_y)
    # warm-up (CUDA context, kernel load, allocator) with 1 iteration
    fit_booster(x, y, dataclasses.replace(params, num_iterations=1),
                prebinned=staged, device=dev)
    torch.cuda.synchronize()

    # headline path: counts set to 0 just before, read just after
    hc.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    booster, base, _ = fit_booster(x, y, params, prebinned=staged,
                                   device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(hc.launches)
    peak = torch.cuda.max_memory_allocated()
    want = dict(hist_smem=N_ITERS * DEPTH, hist_global=0)
    if launches != want:
        raise AssertionError(f"histogram launches {launches}, expected "
                             f"{want}")
    log(f"[main] fit_booster binary depth {DEPTH} leaves 31 B={MAX_BIN + 1} "
        f"{N_ITERS} iters: {fit_s:.3f} s = "
        f"{N_ROWS * N_ITERS / fit_s:.4g} rows*iters/s; histogram launches "
        f"{launches}; peak memory {peak / 2**30:.2f} GiB "
        f"(max_memory_allocated); {booster.n_trees} trees")

    # bulk scoring on the card, then serving-sized host batches
    t0 = time.perf_counter()
    margin = booster.raw_score_device(x, device=dev)[:, 0] + base
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    if margin.shape != (N_ROWS,) or not bool(torch.isfinite(margin).all()):
        raise AssertionError("bulk margins are not finite (n,) values")
    bulk = booster.raw_score(x[:200_000], base, backend="device",
                            device=dev)
    plan = booster.scoring_plan(base)
    for rows in (1, 16, 256):
        batch = x[1000:1000 + rows]
        t1 = time.perf_counter()
        served = plan(batch)
        t_plan = time.perf_counter() - t1
        auto = booster.raw_score(batch, base)          # host route (< 4096)
        if not (np.allclose(served, bulk[1000:1000 + rows], rtol=1e-5,
                            atol=1e-5)
                and np.array_equal(auto, booster.raw_score(
                    batch, base, backend="host"))):
            raise AssertionError(f"serving batch of {rows} disagrees with "
                                 f"bulk device scoring")
        log(f"[main] serving batch {rows} rows: scoring_plan "
            f"{t_plan * 1e3:.3f} ms, agrees with device scoring")
    logloss, auc = _metrics(margin, d_y)
    log(f"[main] bulk raw_score on the card: {N_ROWS} rows in "
        f"{score_s:.3f} s ({N_ROWS / score_s:.4g} rows/s); train logloss "
        f"{logloss:.6f}, AUC {auc:.6f}")

    hc.reset_launches()
    with plain_histograms():
        t0 = time.perf_counter()
        ref, ref_base, _ = fit_booster(x, y, params, prebinned=staged,
                                         device=dev)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
    if any(hc.launches.values()):
        raise AssertionError("the plain-histogram fit launched a kernel")
    ref_margin = ref.raw_score_device(x, device=dev)[:, 0] + ref_base
    ref_logloss, ref_auc = _metrics(ref_margin, d_y)
    same_splits = float((ref.split_feature == booster.split_feature).mean())
    log(f"[main] plain-histogram fit on the card: {ref_s:.3f} s "
        f"({N_ROWS * N_ITERS / ref_s:.4g} rows*iters/s); logloss "
        f"{ref_logloss:.6f}, AUC {ref_auc:.6f}; split features equal at "
        f"{same_splits:.3f} of nodes; max |margin diff| "
        f"{float((margin - ref_margin).abs().max()):.3g}")
    if abs(logloss - ref_logloss) > _METRIC_TOL or \
            abs(auc - ref_auc) > _METRIC_TOL:
        raise AssertionError("kernel fit and plain-histogram fit disagree")
    if not auc > 0.8:
        raise AssertionError(f"train AUC {auc} is not a trained model")

    # deep path: the deepest level's m*B outgrows shared memory; counts
    # set to 0 just before, read just after
    deep = dataclasses.replace(params, num_iterations=1, max_depth=11)
    hc.reset_launches()
    t0 = time.perf_counter()
    fit_booster(x, y, deep, prebinned=staged, device=dev)
    torch.cuda.synchronize()
    deep_s = time.perf_counter() - t0
    deep_launches = dict(hc.launches)
    if deep_launches != dict(hist_smem=10, hist_global=1):
        raise AssertionError(f"deep fit launches {deep_launches}, expected "
                             f"10 shared-memory and 1 global")
    log(f"[main] max_depth=11 fit, 1 iteration: {deep_s:.3f} s; launches "
        f"{deep_launches} (levels 0-9 shared memory, level 10 global "
        f"atomics)")

    if profile:
        from torch.profiler import ProfilerActivity, profile as tprof
        one = dataclasses.replace(params, num_iterations=1)
        with tprof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            fit_booster(x, y, one, prebinned=staged, device=dev)
            torch.cuda.synchronize()
        log(prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25))
    return dict(launches=launches, deep_launches=deep_launches)


def _flash_cases():
    """(label, Sq, Sk, H, D, timed) of the flash kernel phase, each run in
    f32 and bf16, causal and not. The first is the main path's shape."""
    return [("main", SEQ, SEQ, 8, 128, True),
            ("d64", SEQ, SEQ, 8, 64, True),
            ("ragged", SEQ - 384, SEQ - 384, 8, 128, False),
            ("cross", 96, 40, 2, 32, False),
            ("d16", SEQ // 4, SEQ // 4, 8, 16, False)]


def _flash_bound(sq, sk, h, d, dtype, causal):
    """(ms, "bytes" or "operations"): 4 * (visible q/k pairs) * D * H
    FLOPs over the dtype's peak (f32 FMAs; bf16 tensor cores), against
    q, k, v read once and out, lse written once."""
    import torch
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    peak = PEAK_BF16_FLOP_PER_S if dtype == torch.bfloat16 \
        else PEAK_F32_FLOP_PER_S
    t_ops = 4 * pairs * d * h / peak
    size = torch.tensor([], dtype=dtype).element_size()
    t_bytes = ((2 * sq + 2 * sk) * h * d * size + 4 * h * sq) \
        / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        ("bytes" if t_bytes > t_ops else "operations")


def _sdpa_call(q, k, v, causal, scale):
    """The library yardstick: ONE `scaled_dot_product_attention` call on
    (1, H, S, D) copies of the same inputs (the copies are outside the
    timing). The port never calls it."""
    import torch
    import torch.nn.functional as F
    qh, kh, vh = (t.permute(1, 0, 2).unsqueeze(0).contiguous()
                  for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                  is_causal=causal,
                                                  scale=scale)


def _bf16_limit(q, k, v, causal, scale, want):
    """The per-element limit on |kernel - plain| of a bf16 output."""
    from mmlspark_tpu_torch.ops import flash_attention as fa
    r = fa._bf16_rounding_scale(q, k, v, causal, scale)
    return _BF16_OUT_ULP * want.float().abs() + _BF16_P_NOISE * r


def _limit_used(got, want, lim):
    """max |got - want| / limit over the elements."""
    return float(((got.float() - want.float()).abs() / lim).max())


def _bf16_check_sees_faults(q, k, v, causal, scale, want, lim, tag):
    """The bf16 limit must reject the kernel's output on V shifted by one
    key (a load one row off: a fault of the size of a typical output).
    Also reports what it makes of the f32 plain version rounded to bf16:
    that differs from the plain bf16 version by where p is rounded, as
    the kernel does, so the limit cannot and does not reject it."""
    import torch
    from mmlspark_tpu_torch.ops import flash_attention as fa
    shifted = fa.flash_fwd(q, k, v.roll(1, 0), causal, scale)[0]
    over = float(((shifted.float() - want.float()).abs() > lim)
                 .float().mean())
    if over < 0.5:
        raise AssertionError(f"{tag}: the bf16 limit lets V read one key "
                             f"off pass at {1 - over:.3f} of the outputs")
    f32 = fa._flash_forward_lse_plain(q.float(), k.float(), v.float(),
                                      causal, scale)[0].to(torch.bfloat16)
    log(f"[kernel] {tag}: V read one key off fails the bf16 limit at "
        f"{over:.4f} of the outputs; the f32 plain version rounded to "
        f"bf16 uses {_limit_used(f32, want, lim):.3f} of it")


def flash_kernel_phase(dev):
    """`flash_fwd` against `_flash_forward_lse_plain` on the same CUDA
    tensors, out and lse; the main-path shapes timed."""
    import torch
    from mmlspark_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(2)
    results = []
    for label, sq, sk, h, d, is_timed in _flash_cases():
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                q = torch.randn(sq, h, d, device=dev, generator=gen)
                k = torch.randn(sk, h, d, device=dev, generator=gen)
                v = torch.randn(sk, h, d, device=dev, generator=gen)
                q, k, v = (t.to(dtype) for t in (q, k, v))
                scale = 1.0 / d ** 0.5
                got, got_lse = fa.flash_fwd(q, k, v, causal, scale)
                want, want_lse = fa._flash_forward_lse_plain(q, k, v,
                                                             causal, scale)
                torch.cuda.synchronize()
                tag = (f"flash_fwd {label} Sq={sq} Sk={sk} H={h} D={d} "
                       f"{str(dtype)[6:]} causal={causal}")
                torch.testing.assert_close(got_lse, want_lse,
                                           rtol=_LSE_TOL[0],
                                           atol=_LSE_TOL[1], msg=tag)
                err = float((got.float() - want.float()).abs().max())
                lse_err = float((got_lse - want_lse).abs().max())
                row = dict(case=label, sq=sq, sk=sk, h=h, d=d,
                           dtype=str(dtype)[6:], causal=causal,
                           max_abs_err=err, lse_max_abs_err=lse_err)
                msg = f"[kernel] {tag}: match (out {err:.3g}, lse " \
                      f"{lse_err:.3g})"
                if dtype == torch.float32:
                    torch.testing.assert_close(
                        got, want, rtol=_FLASH_F32_TOL[0],
                        atol=_FLASH_F32_TOL[1], msg=tag)
                else:
                    lim = _bf16_limit(q, k, v, causal, scale, want)
                    used = _limit_used(got, want, lim)
                    if used > 1:
                        raise AssertionError(f"{tag}: out off by {used:.3g}"
                                             f" x the bf16 limit")
                    row["bf16_limit_used"] = used
                    msg += f", {used:.3f} of the bf16 limit"
                    if label == "main":
                        _bf16_check_sees_faults(q, k, v, causal, scale,
                                                want, lim, tag)
                    del lim
                del got, want, got_lse, want_lse
                if is_timed:
                    row["ms"] = timed(lambda: fa.flash_fwd(q, k, v, causal,
                                                           scale),
                                      warmup=2, reps=10)
                    row["plain_ms"] = timed(
                        lambda: fa._flash_forward_lse_plain(q, k, v, causal,
                                                            scale),
                        warmup=1, reps=3)
                    lib = _sdpa_call(q, k, v, causal, scale)
                    row["library_ms"] = timed(lib, warmup=2, reps=10)
                    del lib
                    row["bound_ms"], row["bound_by"] = _flash_bound(
                        sq, sk, h, d, dtype, causal)
                    msg += (f"; kernel {row['ms']:.3f} ms, plain "
                            f"{row['plain_ms']:.3f} ms, one SDPA "
                            f"{row['library_ms']:.3f} ms, bound "
                            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
                log(msg)
                results.append(row)
                del q, k, v
                torch.cuda.empty_cache()
    return results


def _documents(n_docs, max_words, seed=0):
    """Seeded documents: 1..max_words words from a 20k-word vocabulary of
    random lowercase strings."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(rng.choice(letters, size=rng.integers(2, 10)))
             for _ in range(20_000)]
    return np.array([" ".join(vocab[i] for i in rng.integers(
        0, len(vocab), size=rng.integers(1, max_words + 1)))
        for _ in range(n_docs)], dtype=object)


def encoder_phase(dev, profile: bool):
    """The encoder's main path at the flagship width, through the stage."""
    import torch
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.models.dnn import (TransformerSentenceEncoder,
                                               init_transformer,
                                               transformer_apply)
    from mmlspark_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    tree = init_transformer(1 << ENCODER["vocab_bits"], ENCODER["d_model"],
                            ENCODER["n_heads"], ENCODER["n_layers"],
                            ENCODER["d_ff"], ENCODER["max_len"], seed=0)
    enc = TransformerSentenceEncoder(**ENCODER, input_col="text",
                                     output_col="emb", device=dev)
    enc.set_params_tree(tree)
    del tree

    def count(node):
        if isinstance(node, dict):
            return sum(count(v) for k, v in node.items() if k != "meta")
        if isinstance(node, list):
            return sum(count(v) for v in node)
        return node.numel()
    n_params = count(enc._ensure_params())
    log(f"[encoder] {ENCODER}: {n_params / 1e6:.1f}M parameters from "
        f"init_transformer(seed=0) in {time.perf_counter() - t0:.1f} s")
    tokens = np.random.default_rng(0).integers(0, 1 << ENCODER["vocab_bits"],
                                               SEQ)
    enc.set(attention="flash")
    enc.encode_long(tokens[:1024])       # warm-up: cuBLAS, kernel load
    torch.cuda.synchronize()

    def run(label, fn):
        """fn() with the flash count set to 0 just before and read just
        after; wall time and peak memory of the call."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        n = fa.launches["flash_fwd"]
        peak = torch.cuda.max_memory_allocated()
        log(f"[encoder] {label}: {wall:.3f} s = {SEQ / wall:.4g} tokens/s; "
            f"flash launches {n}; peak memory {peak / 2**30:.2f} GiB")
        return out, n, wall, peak

    paths = {}
    for adt in (None, "bfloat16"):
        enc.set(attention="flash", attention_dtype=adt)
        flash, n, wall, peak = run(f"encode_long flash {adt or 'float32'}",
                                   lambda: enc.encode_long(tokens))
        if n != ENCODER["n_layers"]:
            raise AssertionError(f"flash encode launched flash_fwd {n} "
                                 f"times, expected {ENCODER['n_layers']}")
        if flash.shape != (SEQ, ENCODER["d_model"]) or \
                not np.isfinite(flash).all():
            raise AssertionError("flash encode is not finite "
                                 "(seq, d_model) values")
        enc.set(attention="dense")
        dense, n_dense, dense_wall, dense_peak = run(
            f"encode_long dense {adt or 'float32'}",
            lambda: enc.encode_long(tokens))
        diff = float(np.abs(flash - dense).max())
        log(f"[encoder] flash vs dense {adt or 'float32'}: max |diff| "
            f"{diff:.3g} (limit {_ENCODE_TOL[adt]})")
        if n_dense != 0 or diff > _ENCODE_TOL[adt]:
            raise AssertionError("flash and dense encodes disagree")
        paths[adt or "float32"] = dict(launches=n, s=wall, peak=peak,
                                       dense_s=dense_wall,
                                       dense_peak=dense_peak, diff=diff)
        del flash, dense

    params = enc._ensure_params()
    tok = torch.as_tensor(tokens, device=dev)
    with torch.inference_mode():
        lm, n, wall, peak = run("causal transformer_apply flash (LM "
                                "forward)", lambda: transformer_apply(
                                    params, tok, causal=True,
                                    attention="flash"))
        lm_dense = transformer_apply(params, tok, causal=True)
    diff = float((lm - lm_dense).abs().max())
    log(f"[encoder] causal flash vs dense: max |diff| {diff:.3g}")
    if n != ENCODER["n_layers"] or diff > _ENCODE_TOL[None] or \
            not bool(torch.isfinite(lm).all()):
        raise AssertionError(f"causal flash forward: {n} launches, "
                             f"diff {diff}")
    paths["causal"] = dict(launches=n, s=wall, peak=peak, diff=diff)
    del lm, lm_dense
    torch.cuda.empty_cache()

    docs = _documents(N_DOCS, MAX_WORDS)
    t1 = time.perf_counter()
    emb = enc.transform(Table({"text": docs}))["emb"]
    tr_s = time.perf_counter() - t1
    alone = enc.transform(Table({"text": docs[:1]}))["emb"][0]
    pad_diff = float(np.abs(alone - emb[0]).max())
    lengths = [min(len(d.split()), ENCODER["max_len"]) for d in docs]
    n_tok, width = sum(lengths), 1 << (max(lengths) - 1).bit_length()
    log(f"[encoder] transform: {N_DOCS} documents ({n_tok} tokens, dense, "
        f"batched at width {width}) in {tr_s:.3f} s = {n_tok / tr_s:.4g} "
        f"tokens/s; doc 0 alone vs in the batch: max |diff| "
        f"{pad_diff:.3g} (limit {_PAD_TOL})")
    if emb.shape != (N_DOCS, ENCODER["d_model"]) or \
            not np.isfinite(emb).all() or pad_diff > _PAD_TOL:
        raise AssertionError("transform embeddings are wrong")

    if profile:
        from torch.profiler import ProfilerActivity, profile as tprof
        enc.set(attention="flash", attention_dtype=None)
        with tprof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            enc.encode_long(tokens)
            torch.cuda.synchronize()
        log(prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=15))
    return paths


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "mmlspark_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi, name = card_phase()
    build_phase()
    dev = torch.device("cuda")
    kres = kernel_phase(dev)
    fres = flash_kernel_phase(dev)
    if "--sweep" in argv:
        sweep_phase(dev)
    paths = main_path_phase(dev, "--profile" in argv)
    enc_paths = encoder_phase(dev, "--profile" in argv)

    smem8 = [r for r in kres["hist_smem"] if r["m"] == 8][0]
    glob = kres["hist_global"][0]
    main_flash = [r for r in fres if r["case"] == "main"
                  and r["dtype"] == "float32" and not r["causal"]][0]
    src = "mmlspark_tpu_torch/ops/csrc/histogram.cu"
    kernels = [
        dict(name="hist_smem", route="cuda", source=src,
             replaces="mmlspark_tpu/ops/histogram_pallas.py:172 "
                      "(_hist_kernel) and :216 (_hist_kernel_joint)",
             path="headline fit", launches=paths["launches"]["hist_smem"],
             passed=True,
             **{k: smem8[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "library_ms")},
             shape=dict(n=smem8["n"], f=smem8["f"], b=smem8["b"], m=8),
             per_m=[{k: r[k] for k in ("m", "ms", "plain_ms", "library_ms",
                                       "bound_ms", "max_abs_err")}
                    for r in kres["hist_smem"]]),
        dict(name="hist_global", route="cuda", source=src,
             replaces="mmlspark_tpu/ops/histogram.py:32 (_xla_hist, the "
                      "route past M_MAX)",
             path="max_depth=11 fit",
             launches=paths["deep_launches"]["hist_global"],
             passed=True,
             **{k: glob[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
             shape=dict(n=glob["n"], f=glob["f"], b=glob["b"], m=glob["m"])),
        dict(name="flash_fwd", route="cuda",
             source="mmlspark_tpu_torch/ops/csrc/flash_attention.cu",
             replaces="mmlspark_tpu/ops/flash_attention.py:87 (_flash_kernel, "
                      "normalized; pallas_call :417 in _flash_forward_lse)",
             path="encode_long attention=flash f32, 16384 tokens",
             launches=enc_paths["float32"]["launches"], passed=True,
             **{k: main_flash[k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms")},
             shape=dict(s=SEQ, h=main_flash["h"], d=main_flash["d"],
                        dtype="float32", causal=False),
             launches_per_path={k: v["launches"]
                                for k, v in enc_paths.items()},
             variants=[{k: r.get(k) for k in (
                 "d", "dtype", "causal", "ms", "plain_ms", "library_ms",
                 "bound_ms", "max_abs_err", "bf16_limit_used")}
                 for r in fres if "ms" in r]),
    ]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} never launched on the main "
                                 f"path")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
