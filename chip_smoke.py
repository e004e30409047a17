#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mmlspark_tpu_torch`) on one card.

    python3 chip_smoke.py            # the check: needs one CUDA card
    python3 chip_smoke.py --profile  # also prints a torch.profiler table
                                     # of one boosting iteration
    python3 chip_smoke.py --sweep    # also times the shared-memory
                                     # kernel's launch geometries

Phases (any failure exits non-zero before the last line is printed):
  1. card: name and power limit (nvidia-smi), torch's device name;
  2. build: every CUDA source of the port with nvcc for sm_90a, with the
     build seconds and the -Xptxas -v register/shared-memory report;
  3. kernels vs plain: each kernel entry point against its plain PyTorch
     version on the same CUDA tensors, at the main path's shapes
     (8M rows x 32 features x 64 bins, m in {1, 2, 4, 8}, with inactive
     rows, both without count_w, as the trainer calls it, and with it)
     and, for the global-atomics kernel, at an m*B too large for shared
     memory. Counts must be exactly equal; grad/hess within the
     tolerance stated at `_HIST_RTOL_OF_ABS_SUM`. Times of the call the
     trainer makes (no count_w) from CUDA events after warm-up, beside
     the plain version, one `index_add_` call (the library yardstick)
     and the bound;
  4. main path, two runs, each with the launch counts set to 0 just
     before it and read just after: the headline fit (binning on the
     card, `fit_booster` binary, depth 5, 31 leaves, 64 bins,
     10 iterations at 8M x 32) with exactly 50 shared-memory launches,
     then a 1-iteration max_depth=11 fit whose deepest level needs the
     global-atomics kernel (10 + 1 launches). Between them: bulk and
     serving-sized scoring through `Booster`, and train logloss/AUC
     against a fit whose histograms come from the plain version on the
     card.
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
    from mmlspark_tpu_torch.ops import _build
    for name in sorted(f[:-3] for f in os.listdir(_build.CSRC)
                       if f.endswith(".cu")):
        t0 = time.perf_counter()
        report = _build.build(name)
        if report is None:
            log(f"[build] {name}.cu: already built")
            continue
        log(f"[build] {name}.cu: nvcc {time.perf_counter() - t0:.2f} s; "
            f"ptxas report:")
        for line in report.splitlines():
            if "ptxas" in line or "registers" in line or "spill" in line:
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
    if "--sweep" in argv:
        sweep_phase(dev)
    paths = main_path_phase(dev, "--profile" in argv)

    smem8 = [r for r in kres["hist_smem"] if r["m"] == 8][0]
    glob = kres["hist_global"][0]
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
