#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mmlspark_tpu_torch`) on one card.

    python3 chip_smoke.py            # the check: needs one CUDA card
    python3 chip_smoke.py --profile  # also prints torch.profiler tables
                                     # of one boosting iteration (numeric
                                     # and categorical), of one flash
                                     # encode_long and of one LM
                                     # training step (bf16 and f32)
                                     # without and with the ring
    python3 chip_smoke.py --sweep    # also times the tiled histogram
                                     # kernel over its planner's knobs
    python3 chip_smoke.py --versus DIR
                                     # also times the f32 forward, f32
                                     # encode_long, f32 LM step, the
                                     # headline fit and the planes fit of
                                     # the checkout at DIR (e.g. the
                                     # parent commit's) and of this one,
                                     # and DIR's planes kernel in the
                                     # [planes] phase: parent, change,
                                     # change, parent
    python3 chip_smoke.py --only PHASE
                                     # card, build, the headline data and
                                     # one phase (e.g. multiprocess), with
                                     # every check of that phase; prints
                                     # no result line (the full run is the
                                     # proof run)

Phases (any failure exits non-zero before the last line is printed):
  1. card: name and power limit (nvidia-smi), torch's device name;
  2. build: every CUDA source of the port with nvcc for sm_90a, one nvcc
     per source, all started together, with the build seconds and the
     -Xptxas -v register/shared-memory report; every instantiation of the
     flash forward (f32 and bf16, both forms) and of the backward must
     hold tensor-core instructions (HMMA or HGMMA in `cuobjdump -sass`)
     and have no ptxas spills, nor may the tiled histogram kernel; every
     instantiation of the planes kernel must hold HMMA and no
     shared-memory atomics (ATOMS) and have no spills; registers, shared
     memory per block and blocks per SM at D=128, and the histogram
     planners' launches at the headline's levels;
  3. kernels vs plain: each kernel entry point against its plain PyTorch
     version on the same CUDA tensors, at the main path's shapes.
     Histograms (`hist_tiled`, the planner's launch): 8M rows x 32
     features x 64 bins, m in {1, 2, 4, 8}, with inactive rows, both
     without count_w, as the trainer calls it, and with it, and two levels
     whose m*B outgrows one block (m=128 at B=256; the deep fit's m=512).
     Counts must be exactly equal; grad/hess within the
     tolerance stated at `_HIST_RTOL_OF_ABS_SUM`. Flash forward: out and
     lse at S=16384, H=8, D in {128, 64} (the shapes of bench.py's flash
     mode), a ragged S=16000, a cross shape Sq=96/Sk=40 and D=16, each
     in f32 and bf16, causal and not, within `_FLASH_F32_TOL` and the
     bf16 limit at `_BF16_OUT_ULP`, which is shown to reject a kernel
     that reads V one key off. Times from
     CUDA events after warm-up, beside the plain version, one library
     call as the yardstick (`index_add_`; `scaled_dot_product_attention`)
     and the bound (f32 flash rows: also at the split's tensor-core rate,
     six bf16 products per product);
  4. GBDT main path, two runs, each with the launch counts set to 0 just
     before it and read just after: the headline fit (binning on the
     card, `fit_booster` binary, depth 5, 31 leaves, 64 bins,
     10 iterations at 8M x 32) with exactly 50 `hist_tiled` launches,
     then a 1-iteration max_depth=11 fit whose deepest level splits its
     nodes over tiles (11 launches). Between them: bulk and
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
  6. LM training path at the flagship width (bench.py:1965-2009, nothing
     cut): `PipelinedLMTrainer(attention="flash", compute_dtype=
     "bfloat16", remat="save_attn")`, Adam, 201.4M parameters, one
     (1, 16384) sequence; one untimed step, one step with exactly 12
     `flash_fwd`, 12 `flash_bwd_dq` and 12 `flash_bwd_dkv` launches, then
     `run` of 3 timed steps (36 of each): s/step, tokens/s,
     `lm_train_mfu` (bench.py's model FLOPs against 989 TFLOP/s), peak
     memory, a falling loss; the same steps at the trainer's default
     compute_dtype="float32" (s/step, tokens/s, peak memory, 12 / 12 / 12
     launches a step, a falling loss); then one SGD step at S=2048 with
     flash and with dense attention from the same weights, in bf16 and
     f32, whose updated weights must agree within `_TRAIN_TOL`.
  7. GBDT planes path (slice 4): `hist_planes` against
     `_torch_hist_planes` on the same CUDA tensors at 8M x 32 x 64 bins
     (LO = 16), m in {1, 2, 4}, and B = 256 (LO = 64) at m = 4, with
     inactive rows, without and with count_w (counts exact, grad/hess
     within `_HIST_RTOL_OF_ABS_SUM`); the check shown to reject the
     kernel run on a plan of the bins shifted by one row; its largest
     difference from `hist_tiled` on the same inputs as a share of sum |g|
     per bin (at most bf16's 2^-8); times beside `hist_tiled`, the plain
     version, one `index_add_` of the bf16-rounded stats, the bound with
     the plan's bytes, the sector floor (the plan's 32-byte sectors that
     hold an active row, read whole) and the dense one-hot product at the
     bf16 tensor-core peak. Then the headline fit with
     MMLSPARK_TPU_HIST=planes set in the process, bagging 0.8/1 and
     feature_fraction 0.8: exactly 40 `hist_planes` and 10 `hist_tiled`
     launches, the plan's bytes, peak memory, logloss/AUC against the
     same fit on the plain histograms;
  8. boosting modes at the headline width: goss (0.2/0.1), dart
     (LightGBM's defaults) and rf (bagging 0.8/1), each a counted, timed
     10-iteration fit and a 3-iteration fit held against its
     plain-histogram twin within `_METRIC_TOL`;
  9. ranker: `GBDTRanker` on seeded data shaped like LightGBM's MS LTR
     experiment (2,270,296 x 137, queries of 100-140 documents, labels
     0-4, 256 bins, depth 8), 5 counted iterations, NDCG@10 rising over
     them, and NDCG@10 after 3 trees against a 3-iteration fit on the
     plain histograms.
  10. ring attention (slice 5): the flash kernel's stats form
     (`flash_stats_fwd`) against `_flash_stats_plain` at the flagship
     shard shape (S_loc = 4096, H = 8, D = 128, f32 and bf16) on every
     pair of a four-shard ring step: diagonal, fully visible, fully masked
     (every row flagged: acc = 0, l = 0, m = -1e30) and non-causal, held on
     the rows with a visible key (`_stats_check`), shown to reject
     k_offset one 64-key tile late (by the flagged rows) and one tile
     early (by the value limits), timed beside the plain version, one
     SDPA on the same pair and the bound; four shards merged on the card
     against the plain attention of all 16,384 tokens and `flash_fwd`.
     The backward kernels at the same offsets (lse := m, dsum := -d_l,
     dO := d_acc in f32) against `_flash_backward_plain` within
     `_BWD_TOL`, timed. Then the flagship LM on the ring mesh
     (data, pipe, model, seq) = (1, 1, 1, 4), four positions on one card:
     one counted step with exactly 192 `flash_stats_fwd`, 192
     `flash_bwd_dq`, 192 `flash_bwd_dkv` and 0 `flash_fwd` launches
     (12 layers x 16 pairs) and its loss against the [train] trainer's
     first loss within `_RING_LOSS_TOL`, `run` of 3 timed steps (s/step,
     tokens/s, `lm_train_mfu`, peak memory, a falling loss), and one SGD
     step at S=2048, f32 and bf16, on the ring mesh and on a (1, 1, 1, 1)
     mesh (the degenerate route: 12 `flash_fwd`, no stats launch) whose
     updated weights agree within `_TRAIN_TOL`. The encoder phase (5)
     also runs `encode_long` with attention="ring" over 4 positions of
     the card, held against its flash encode within `_ENCODE_TOL`.
  11. categorical (slice 11): the headline's rows with columns 24-31
     replaced by category ids (4-64 levels, frequencies 1/(id + 1), numpy
     seed 1) and a label with one seeded effect per category; the
     headline fit with `categorical_features` 24-31: 3 timed fits of
     exactly 50 `hist_tiled` launches beside the numeric median, its
     plain-histogram twin within `_METRIC_TOL`, categorical splits
     present, train AUC above the ordinal twin's (the same bins, no
     categorical slots) by more than `_CAT_AUC_LIFT`, one fit under
     MMLSPARK_TPU_HIST=planes (40 `hist_planes` + 10 `hist_tiled`) held to
     its planes plain twin, bulk and serving scoring; then
     `Pipeline([GBDTClassifier(categorical_slot_names=...)])` fitted on the
     card from `feature_names` metadata, saved, loaded and scored in a
     subprocess that has not imported the estimators: predictions and
     probabilities bit-identical, save/load seconds and bytes.
  12. resume (slice 12): the fixed-order histogram kernels
     (`hist_tiled_fixed`, `hist_planes_fixed`) at the headline's levels,
     the ranker's widest level, the deep fit's split levels, the leaf
     sums' shape and the planes levels: two launches equal bit for bit,
     with and without count_w, and `_check_hist`'s limits against the
     plain versions; times beside the atomic kernels, the plain versions,
     one `index_add_` and the bounds, with the plans and scratch bytes.
     Whether `torch.cumsum` repeated itself on the split search's
     lattices. The checkpointed headline fit (bagging 0.8/1,
     feature_fraction 0.8, a checkpoint every 3 iterations) beside the
     default fit, 3 each, with exactly 60 `hist_tiled_fixed` launches and
     no other, logloss/AUC within `_METRIC_TOL`, save seconds and bytes.
     On the default route, under MMLSPARK_TPU_HIST=planes (40
     `hist_planes_fixed` + 20 `hist_tiled_fixed`) and on the categorical
     data: two uninterrupted checkpointed `GBDTClassifier` fits, a 6 -> 10
     resume, and a subprocess SIGTERMed after its second checkpoint and
     resumed in a fresh process, margins, split_feature, threshold and
     leaf_value all equal bit for bit. The flagship bf16 LM: two steps,
     `save_checkpoint`, a trainer of another seed restores: parameters
     equal, the next loss within rtol 1e-6; save and restore seconds and
     bytes. Checkpoints go to a temporary directory, deleted after.
  13. introspect (slice 13), on the headline fit's and the categorical
     fit's boosters: `predict_leaf` on 1,048,576 rows on the card equal to
     the host descent, their leaf values summing to `raw_score` within
     1e-5; device TreeSHAP (`shap_device.shap_contributions_device`,
     torch ops, no kernel) within 1e-4 of the float64 host oracle on 2,048
     rows, and on 65,536 rows (SHAP rows/s, peak memory) summing to the
     raw score plus the init score within 1e-4; split importances summing
     to the internal node count; a native model file saved, loaded and
     scoring bit-identically; a model's transform filling the leaf and
     SHAP columns.
  14. data_parallel (slice 13): `fit_booster_distributed` over a mesh of
     4 positions on the card (`data_mesh(devices=[cuda:0] * 4)`): the
     headline fit timed beside the one-position fit, in turn, 3 each,
     with exactly 200 `hist_tiled` launches against 50, train
     logloss/AUC within `_METRIC_TOL` of it and the first tree's split
     features equal; a ragged fit of 8,000,003 rows (root covers count
     the real rows, the base is unmoved, AUC within 0.02 of the
     one-position fit); voting_parallel with top_k=8 (AUC within 0.01 of
     data_parallel, the voted features' share of the summed histograms per
     level at most 2k/F); the planes route over the mesh (160
     `hist_planes` + 40 `hist_tiled`) within `_METRIC_TOL` of the
     one-position planes fit; a fixed-order checkpointed fit (240
     `hist_tiled_fixed`) that repeats itself bit for bit and whose 6 -> 10
     resume equals it bit for bit.
  15. pipe train (slice 14): `flash_fwd`, `flash_bwd_dq` and
     `flash_bwd_dkv` at a model position's shape (16384, 4, 128), bf16,
     causal, against their plain versions (timed); the flagship LM
     (bf16, Adam, remat="save_attn", flash) on a (data, pipe, model,
     seq) = (1, 4, 2, 1) mesh of one card, tokens (2, 16384) in two
     microbatches: one step with exactly 48 `flash_fwd`, 48
     `flash_bwd_dq` and 48 `flash_bwd_dkv` launches, then `run` of 3
     timed steps (s/step, tokens/s, `lm_train_mfu`, peak memory, a
     falling loss) beside the one-position [train] step; one SGD step at
     S=2048 on (1, 4, 2, 1) and (1, 2, 2, 2) against (1, 1, 1, 1), f32
     and bf16, updated weights within `_TRAIN_TOL`, losses within
     `_PIPE_LOSS_TOL`, launches exact; `ShardedLMTrainer` at the flagship
     width on a (2, 2) data x model mesh, f32, 3 Adam steps within rtol
     2e-4 of mesh=None.
  16. ingest (slice 15), on the headline's rows: `stage_binned` with 8
     thread workers and prefetch 2 (bins `torch.equal` to
     `apply_bins_device`'s; seconds beside the serial fit_bins +
     apply_bins_device, the card's idle share under torch.profiler), the
     process pool's start-up, a `ChunkStager` over the rows saved as a
     memory-mapped .npy under a 256 MiB residency budget (bins equal, the
     resident gauge within the budget), `fit_booster(ingest=...)` and
     `fit_booster(x.npy, oocore=...)` (exactly 50 `hist_tiled` each,
     metrics within `_METRIC_TOL` of [main]'s), and the out-of-core
     checkpointed `GBDTClassifier` uninterrupted and after a child staging
     the same file is SIGTERMed mid-staging and a fresh process resumes
     from the spill cache's cursor: booster equal field for field, 60
     `hist_tiled_fixed` launches as [resume]'s.
  17. stream train (slice 15): `ShardedLMTrainer` at the flagship width,
     f32, dense, on 12 seeded (4, 2048) batches: `run_stream(prefetch=2)`
     losses equal a `step()` loop's; supervised with a checkpoint every 6
     batches, uninterrupted and with an injected train.step7 crash absorbed
     in-run (losses and parameters bit-identical); a child SIGTERMed after
     5 steps and resumed in a fresh process (the loss history and the
     parameters bit-identical); s/step, tokens/s, prefetch stalls and the
     checkpoint write seconds.
  18. multiprocess (slice 16): the headline fit over 2 processes on the
     card under gloo (`parallel.cluster`, a data axis that spans them, one
     position each), each rank memory-mapping the staged bins saved once
     to an .npy: the whole-table fit, default (50 `hist_tiled` a rank) and
     fixed order (50 + 10 leaf-sum `hist_tiled_fixed` a rank), and the
     scale-out form (each rank reads its `process_row_range` only, the
     leader's mapper broadcast). The ranks' boosters bit-identical in
     every fit; the fixed-order fit bit-identical to this process's
     `data_mesh(devices=[dev] * 2)` fit; the scale-out fit's split
     features equal the whole-table fixed-order fit's, margins within
     ROADMAP Queue 3 (e)'s limits; logloss/AUC within `_METRIC_TOL` of
     the one-position fit; per rank the fit's seconds against the
     one-process 2-position fit, the exchange's seconds and share, peak
     memory. A second pair: rank 1 SIGKILLed mid-fit, rank 0's
     `HostLeases` must declare it dead within the lease budget.
  19. multiprocess lm (slice 17): the flagship LM over 2 gloo ranks on
     the card, each configuration of `MPLM` first in this process on a
     mesh of the same shape (`devices=[dev] * n`), then in the ranks: (a)
     `PipelinedLMTrainer` bf16, Adam, flash, remat="save_attn" on
     (data, pipe, model, seq) = (1, 2, 2, 1), two (1, 16384) sequences in
     two microbatches, 3 steps, the pipe axis across the ranks; (b)
     `ShardedLMTrainer` f32 dense on (2, 2), [stream train]'s seeded
     (4, 2048) batches, 3 steps, the data axis across the ranks; (c)
     `PipelinedLMTrainer` bf16 flash on (1, 1, 1, 2), one (1, 16384)
     sequence, 2 steps, the ring's seq axis across the ranks; (d) as (c)
     on (1, 1, 2, 1), the model axis across the ranks (Megatron's f and
     g, the messages a checkpointed region keeps for its recompute). Per
     configuration both ranks' losses equal and within `_MPLM_LOSS_TOL`
     of this process's, every replicated master bit-identical across the
     ranks ((d) has none), the flash launches of step 1 per rank summing
     to this process's (each rank launching); (a), (c), (d) one SGD step at
     S=2048 whose updates agree with this process's within
     `_MPLM_UPDATE_TOL`, (b) the Adam updates' norms within
     `_MPLM_ADAM_F32_TOL`; s/step per rank beside this process's, the
     exchange's seconds, bytes and share of the step by primitive (copies
     and wire), `lm_train_mfu` and peak memory per rank.
The headline fit (4) is timed 3 times (min and median), and every
phase's seconds are printed.
The kernel phase (3) also holds the flash backward kernels, dq and dk/dv,
against `_flash_backward_plain` at the flash forward's shapes, per
element within `flash_attention._BWD_TOL`, shows that the bf16 and the
f32 limits reject dO shifted by one query row, and times them beside the
plain version, one SDPA backward and the bound (f32 rows: also the bound
at the f32 kernels' own rate, 6 bf16 tensor-core products per product).
Then one JSON line of kernels, the nvidia-smi line, and, last:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import json
import os
import re
import shutil
import signal
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
FIT_REPEATS = 3
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
# ~0.013 and the limit ~3e-4. On an H100 (80GB HBM3, 700 W) the CUDA-core
# kernel and then the tensor-core kernel each used 0.620-0.756 of this
# limit over the phase's bf16 shapes (0.657 and 0.664 at S=16384, H=8,
# D=128, non-causal and causal); their output on V shifted by one key
# failed it at 98.5% of the outputs.
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
    return dict(fwd=_fwd_build_checks(reports["flash_attention"][0]),
                bwd=_bwd_build_checks(reports["flash_attention_bwd"][0]),
                hist=_hist_build_checks(reports["histogram"][0]))


# the tensor-core kernels by mangled name. Backward: (kernel, dO's type, D),
# bf16 dO is dtype code 1, f32 dO code 2; forward: (form, D)
_BWD_MMA = re.compile(r"flash_bwd_(dq|dkv)_mmaI(13__nv_bfloat16|f)Li(\d+)E")
_BWD_SPLIT3 = re.compile(r"flash_bwd_(dq|dkv)_split3ILi(\d+)E")
_FWD_MMA = re.compile(r"flash_fwd_(mma|split3)ILi(\d+)ELb([01])E")
_HIST_TILE = re.compile(r"hist_tile_kernelILb([01])ELb([01])E")
# bytes of spill stores or loads allowed in hist_tile_kernel<false, true>
_FIXED_SPILL_MAX = 4
_HIST_PLANES = re.compile(r"hist_planes_kernelILi(\d+)ELi(\d)E")


def _bwd_mma_key(line):
    """(kernel, dtype code, D) of a tensor-core backward kernel named in a
    line of ptxas or cuobjdump output, else None: `*_mma` for codes 1 and
    2, `*_split3` (f32 as three bf16 terms) for code 0."""
    m = _BWD_MMA.search(line)
    if m:
        return (m.group(1), 1 if m.group(2) != "f" else 2, int(m.group(3)))
    m = _BWD_SPLIT3.search(line)
    return (m.group(1), 0, int(m.group(2))) if m else None


def _fwd_mma_key(line):
    """("normalized" or "stats", dtype code, D) of a tensor-core forward
    kernel named in a line of ptxas or cuobjdump output, else None:
    `flash_fwd_mma` for code 1 (bf16), `flash_fwd_split3` (f32 as three
    bf16 terms) for code 0."""
    m = _FWD_MMA.search(line)
    return ("normalized" if m.group(3) == "1" else "stats",
            1 if m.group(1) == "mma" else 0, int(m.group(2))) if m else None


def _hist_tile_key(line):
    """"cnt" or "no cnt" (with or without a count operand), and " fixed"
    for the fixed-order form, of a tiled histogram kernel named in a line
    of ptxas output, else None."""
    m = _HIST_TILE.search(line)
    if m is None:
        return None
    return ("cnt" if m.group(1) == "1" else "no cnt") + \
        (" fixed" if m.group(2) == "1" else "")


def _hist_planes_key(line):
    """(LO, HT) (the plan's digit width, h-tiles of 8 hi digits) of a
    planes kernel named in a line of ptxas or cuobjdump output, else
    None."""
    m = _HIST_PLANES.search(line)
    return (int(m.group(1)), int(m.group(2))) if m else None


def _mma_build_checks(source, report, key, want):
    """The tensor-core kernels of one built source, each named by `key`
    (a line of ptxas or cuobjdump output -> its key, else None): every key
    in `want` must hold tensor-core instructions (HMMA or HGMMA in
    `cuobjdump -sass`), and ptxas must report no spills for them (when this
    run built the library). Returns {key: {"HMMA": n, "HGMMA": n, "ATOMS":
    n, "span": n}} (ATOMS: shared-memory atomics; span: the instructions
    from the first tensor-core instruction to the last, the product
    loop's unrolled body); raises on a kernel without tensor-core
    instructions or with spills."""
    from mmlspark_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [tool, "-sass", str(_build._target(source))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    counts, name, seen, first = {}, None, 0, None
    for line in sass.splitlines():
        if "Function :" in line:
            name, seen, first = key(line), 0, None
            if name is not None:
                counts[name] = {"HMMA": 0, "HGMMA": 0, "ATOMS": 0,
                                "span": 0}
        elif name is not None and re.search(r"/\*[0-9a-f]{4,}\*/\s+[@A-Z]",
                                            line):
            seen += 1
            for op in ("HGMMA", "HMMA", "ATOMS"):
                if op + "." in line:
                    counts[name][op] += 1
                    if op != "ATOMS":
                        first = seen if first is None else first
                        counts[name]["span"] = seen - first + 1
                    break
    missing = sorted(w for w in want
                     if sum(counts.get(w, {}).values()) == 0)
    if missing:
        raise AssertionError(f"no tensor-core instructions in the "
                             f"tensor-core kernels {missing} of "
                             f"{source}.cu")
    spills = {}
    if report is not None:
        fn = None
        for line in report.splitlines():
            if "entry function" in line:
                fn = key(line)
            elif fn is not None and "spill" in line:
                n = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
                if any(n):
                    spills[fn] = n
        if spills:
            raise AssertionError(f"ptxas spills in the tensor-core kernels "
                                 f"of {source}.cu: {spills}")
    return counts


def _fwd_build_checks(report):
    """The forward kernels, from the built library: every instantiation
    (bf16 and f32, both forms, each D) holds tensor-core instructions and
    has no ptxas spills (`_mma_build_checks`); registers (from ptxas),
    shared memory per block and blocks per SM at D=128 for both forms, f32
    and bf16."""
    from mmlspark_tpu_torch.ops import flash_attention as fa
    counts = _mma_build_checks(
        "flash_attention", report, _fwd_mma_key,
        {(f, c, d) for f in ("normalized", "stats") for c in (0, 1)
         for d in (16, 32, 64, 128)})
    for (f, c, d), ops in sorted(counts.items()):
        if d == 128:
            log(f"[build] flash_fwd {f} code {c} D=128: SASS {ops['HMMA']} "
                f"HMMA, {ops['HGMMA']} HGMMA")
    ptxas = _ptxas_registers(report, _fwd_mma_key)
    occupancy = {}
    for f in ("normalized", "stats"):
        for c in (0, 1):
            regs, smem, blocks = fa.flash_fwd_occupancy(f == "normalized", c,
                                                        128)
            occupancy[f"{f} code {c}"] = dict(registers=regs, smem=smem,
                                              blocks_per_sm=blocks,
                                              ptxas_registers=ptxas.get(
                                                  (f, c, 128)))
            log(f"[build] flash_fwd {f} code {c} D=128: {regs} registers, "
                f"{smem} B shared memory per block, {blocks} block(s) per SM")
    return dict(sass={f"{f} code {c} D={d}": ops
                      for (f, c, d), ops in sorted(counts.items())},
                spills_checked=report is not None, occupancy=occupancy)


def _hist_build_checks(report):
    """The histogram kernels, from the built library. The tiled kernel: no
    ptxas spills in any instantiation (atomic or fixed-order, with or
    without a count operand) but the fixed-order one without a count, at
    most `_FIXED_SPILL_MAX` bytes there; registers, and the
    shared memory and blocks per SM of the planner's launches at the
    headline's shapes (8M x 32 x 64 bins, m = 1, 2, 4, 8) and at m=128,
    B=256 (`histogram_cuda.tile_occupancy`), and of the fixed-order
    plans at the headline's, the leaf sums' and the ranker's shapes.
    The planes kernel: every instantiation (LO = 16 at HT = 1-4, LO = 64
    at HT = 1-2) holds tensor-core instructions, no shared-memory atomics
    and no ptxas spills; its registers, and the shared memory and blocks
    per SM of `plan_planes`' launches at the [planes] phase's shapes."""
    from mmlspark_tpu_torch.ops import histogram as hist
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    regs, spills, fn = {}, {}, None
    for line in (report or "").splitlines():
        if "entry function" in line:
            fn = _hist_tile_key(line)
        elif fn is not None and "registers" in line:
            regs[fn] = int(re.search(r"Used (\d+) registers", line).group(1))
        elif fn is not None and "spill" in line:
            n = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
            if any(n):
                spills[fn] = n
    # no instantiation may spill but the fixed-order one without a count
    # (a 64-bit compare-and-swap loop per add), where ptxas stores and
    # reloads one 4-byte value at any register budget: at most that
    over = {k: v for k, v in spills.items()
            if k != "no cnt fixed" or max(v) > _FIXED_SPILL_MAX}
    if over:
        raise AssertionError(f"ptxas spills in hist_tile_kernel (stores, "
                             f"loads in bytes; 'no cnt fixed' may spill "
                             f"{_FIXED_SPILL_MAX}): {over}")
    log(f"[build] hist_tile_kernel spills (stores, loads in bytes): "
        f"{spills if report is not None else 'unreported'}")
    occupancy = {}
    for m, b in ((1, 64), (2, 64), (4, 64), (8, 64), (128, 256)):
        plan = hc.plan_tiles(N_ROWS, N_FEAT, m, b, *hc._card(0))
        blocks = hc.tile_occupancy(plan, False)
        occupancy[f"m={m} B={b}"] = dict(plan._asdict(), blocks_per_sm=blocks)
        log(f"[build] hist_tile_kernel m={m} B={b}: {plan}; {blocks} "
            f"block(s) per SM")
    for n, f, m, b in ((N_ROWS, N_FEAT, 1, 64), (N_ROWS, N_FEAT, 8, 64),
                       (N_ROWS, 1, 2 ** (DEPTH + 1) - 1, 1),
                       (LTR_ROWS, LTR_FEAT, 64, 256)):
        plan = hc.plan_tiles(n, f, m, b, *hc._card(0), fixed=True)
        blocks = hc.tile_occupancy(plan, False, fixed=True)
        occupancy[f"fixed n={n} F={f} m={m} B={b}"] = dict(
            plan._asdict(), blocks_per_sm=blocks)
        log(f"[build] hist_tile_kernel fixed-order n={n} F={f} m={m} "
            f"B={b}: {plan}; {blocks} block(s) per SM")
    log(f"[build] hist_tile_kernel registers: "
        f"{regs if report is not None else 'already built'}")
    planes = _mma_build_checks("histogram", report, _hist_planes_key,
                               {(16, 1), (16, 2), (16, 3), (16, 4),
                                (64, 1), (64, 2)})
    shared = {k: c["ATOMS"] for k, c in planes.items() if c["ATOMS"]}
    if shared:
        raise AssertionError(f"shared-memory atomics in hist_planes_kernel "
                             f"((LO, HT): count): {shared}")
    planes_regs = _ptxas_registers(report, _hist_planes_key)
    for (lo, ht), ops in sorted(planes.items()):
        log(f"[build] hist_planes_kernel<{lo}, {ht}>: SASS {ops['HMMA']} "
            f"HMMA, {ops['ATOMS']} ATOMS, {ops['span']} instructions from "
            f"the first HMMA to the last, "
            f"{planes_regs.get((lo, ht), 'unreported')} registers, "
            f"{'no spills' if report is not None else 'spills unchecked'}")
    planes_occ = {}
    for m, b in PLANES_CASES:
        lo = hist.plan_lo_bins(b)
        plan = hc.plan_planes(N_ROWS, N_FEAT, m, b, lo, *hc._card(0))
        smem, blocks = hc.planes_occupancy(plan, N_FEAT, lo)
        if smem != plan.smem:
            raise AssertionError(f"plan_planes counts {plan.smem} B of "
                                 f"shared memory, the kernel {smem}")
        planes_occ[f"m={m} B={b}"] = dict(plan._asdict(), blocks_per_sm=blocks)
        log(f"[build] hist_planes_kernel m={m} B={b}: {plan}; {blocks} "
            f"block(s) per SM")
    return dict(registers=regs, spills=spills,
                spills_checked=report is not None, occupancy=occupancy,
                planes=dict(sass={f"LO={lo} HT={ht}": ops
                                  for (lo, ht), ops in sorted(planes.items())},
                            registers={f"LO={lo} HT={ht}": r
                                       for (lo, ht), r in planes_regs.items()},
                            spills_checked=report is not None,
                            occupancy=planes_occ))


def _ptxas_registers(report, key):
    """{key: registers per thread} of the kernels `key` names in a ptxas
    report ({} when this run did not build the library)."""
    regs, fn = {}, None
    for line in (report or "").splitlines():
        if "entry function" in line:
            fn = key(line)
        elif fn is not None and "registers" in line:
            regs[fn] = int(re.search(r"Used (\d+) registers", line)
                           .group(1))
    return regs


def _bwd_build_checks(report):
    """The backward kernels, from the built library: every instantiation
    (codes 0-2, both kernels, each D) holds tensor-core instructions and
    has no ptxas spills (`_mma_build_checks`); registers (from ptxas),
    shared memory per block and blocks per SM at D=128 for codes 0-2."""
    from mmlspark_tpu_torch.ops import flash_attention as fa
    counts = _mma_build_checks(
        "flash_attention_bwd", report, _bwd_mma_key,
        {(k, c, d) for k in ("dq", "dkv") for c in (0, 1, 2)
         for d in (16, 32, 64, 128)})
    for (k, c, d), ops in sorted(counts.items()):
        if d == 128:
            log(f"[build] flash_bwd_{k} code {c} D=128: SASS "
                f"{ops['HMMA']} HMMA, {ops['HGMMA']} HGMMA")
    regs = _ptxas_registers(report, _bwd_mma_key)
    occupancy = {}
    for k in ("dq", "dkv"):
        for c in (0, 1, 2):
            smem, blocks = fa.flash_bwd_occupancy(k, c, 128)
            r = regs.get((k, c, 128))
            occupancy[f"{k} code {c}"] = dict(registers=r, smem=smem,
                                              blocks_per_sm=blocks)
            log(f"[build] flash_bwd {k} code {c} D=128: "
                f"{r if r is not None else 'unreported'} registers, {smem} "
                f"B shared memory per block, {blocks} block(s) per SM")
    return dict(sass={f"{k} code {c} D={d}": ops
                      for (k, c, d), ops in sorted(counts.items())},
                spills_checked=report is not None, occupancy=occupancy)


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


# the tiled histogram kernel's cases: the headline's levels (8M x 32 x 64
# bins, m = 1, 2, 4, 8), a level whose m*B outgrows one block (m=128,
# B=256: 3 * 128 * 256 * 4 B = 384 KiB a feature) and the deep fit's
# deepest level (m=512)
HIST_CASES = [(1, 64), (2, 64), (4, 64), (8, 64), (128, 256), (512, 64)]


def kernel_phase(dev):
    """The tiled kernel against `_torch_hist` on the same CUDA tensors at
    every case of `HIST_CASES`, at the planner's launch."""
    import torch
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    from mmlspark_tpu_torch.ops.histogram import _torch_hist
    gen = torch.Generator(device=dev).manual_seed(0)
    results = []
    for m, b in HIST_CASES:
        f = N_FEAT
        inputs = _hist_inputs(gen, dev, N_ROWS, f, b, m)
        bins, grad, hess, node, active, cw = inputs
        plan = hc.plan_tiles(N_ROWS, f, m, b, *hc._card(dev.index or 0))
        abs_grad = _torch_hist(bins, grad.abs(), hess, node, active, m, b)[0]
        err = 0.0
        # the trainer passes no count_w (every row counts 1); the
        # reference's callers with weights pass one
        for w in (None, cw):
            got = hc.hist_tiled(*inputs[:5], m, b, count_w=w)
            want = _torch_hist(*inputs[:5], m, b, count_w=w)
            torch.cuda.synchronize()
            label = f"hist_tiled m={m} B={b} count_w " + \
                ("set" if w is not None else "None")
            err = max(err, _check_hist(got, want, abs_grad, label))
            del got, want
        del abs_grad
        ms = timed(lambda: hc.hist_tiled(*inputs[:5], m, b))
        plain_ms = timed(lambda: _torch_hist(*inputs[:5], m, b),
                         warmup=1, reps=5)
        lib = _index_add_call(*inputs[:5], torch.ones_like(cw), m, b)
        library_ms = timed(lib, warmup=1, reps=5)
        del lib
        bound_ms, bound_by = _bound(N_ROWS, int(active.sum()), f, b, m,
                                    with_count=False)
        # each active row's stats are read once per feature tile
        log(f"[kernel] hist_tiled n={N_ROWS} F={f} B={b} m={m}: match with "
            f"and without count_w (counts exact, max abs err {err:.3g}); "
            f"{plan.node_tiles} x {plan.feat_tiles} tiles of {plan.mt} "
            f"nodes x {plan.ft} features, {plan.copies} copies, "
            f"{plan.threads} threads, {plan.row_blocks} row blocks, "
            f"{plan.smem} B (stats read {plan.feat_tiles} time(s), node "
            f"{plan.node_tiles * plan.feat_tiles}); kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, one index_add_ {library_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        results.append(dict(
            m=m, n=N_ROWS, f=f, b=b, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
            bound_by=bound_by, plan=plan._asdict()))
        del inputs, bins, grad, hess, node, active, cw
        torch.cuda.empty_cache()
    return results


# the sweep's knobs of the tiled kernel: features per tile, nodes per tile
# (None: as many as fit), threads per block, copies of the histograms
# (taken only where the tile leaves room)
SWEEP_FT = (8, 16, 32)
SWEEP_MT = (None, 2)
SWEEP_THREADS = (256, 512, 1024)
SWEEP_COPIES = (1, 2, 4)


def sweep_phase(dev):
    """Time `hist_tile_kernel` at the headline's shapes (m = 1, 2, 4, 8)
    and at m=128, B=256 over the planner's knobs: features per tile, nodes
    per tile, threads per block and copies. Every launch's output is
    checked against the plain version."""
    import torch
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    from mmlspark_tpu_torch.ops.histogram import _torch_hist
    gen = torch.Generator(device=dev).manual_seed(1)
    card = hc._card(dev.index or 0)
    rows = {}
    for m, b in HIST_CASES[:5]:
        inputs = _hist_inputs(gen, dev, N_ROWS, N_FEAT, b, m)
        want = _torch_hist(*inputs[:5], m, b)
        abs_grad = _torch_hist(inputs[0], inputs[1].abs(),
                               *inputs[2:5], m, b)[0]
        ops, _ = hc._prepare(*inputs[:5], m, b, None)
        chosen = hc.plan_tiles(N_ROWS, N_FEAT, m, b, *card)
        row, seen = [], set()
        for ft, mt, threads, copies in itertools.product(
                SWEEP_FT, SWEEP_MT, SWEEP_THREADS, SWEEP_COPIES):
            plan = hc.plan_tiles(N_ROWS, N_FEAT, m, b, *card,
                                 threads=threads, copies=copies, ft=ft, mt=mt)
            if plan in seen:
                continue           # a cap or copies that changed nothing
            seen.add(plan)
            outs = [torch.zeros(m, N_FEAT, b, device=dev)
                    for _ in range(3)]

            def launch():
                for o in outs:
                    o.zero_()
                hc._launch_tiled(ops, outs, N_ROWS, N_FEAT, m, b,
                                 plan)
            launch()
            torch.cuda.synchronize()
            _check_hist(outs, want, abs_grad,
                        f"sweep m={m} B={b} {plan}")
            ms = timed(launch, warmup=2, reps=10)
            mark = "*" if plan == chosen else ""
            row.append(f"ft{plan.ft}/mt{plan.mt}/t{threads}/"
                       f"c{plan.copies}:{ms:.3f}{mark}")
            rows.setdefault(f"m={m} B={b}", []).append(
                dict(plan._asdict(), ms=ms, chosen=bool(mark)))
        log(f"[sweep] m={m} B={b} (ms, zeroing included; * = the planner's "
            f"choice) " + " ".join(row))
        del inputs, want, abs_grad, ops
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def plain_histograms():
    """Route the trainer's histograms through the plain versions for one
    reference fit, with the port's routing (`_torch_hist_planes` where a
    plan and the level allow, else `_torch_hist`); the port itself never
    does: a CUDA tensor always goes to a kernel."""
    from mmlspark_tpu_torch.models.gbdt import trainer
    from mmlspark_tpu_torch.ops import histogram as hist

    def plain(bins, grad, hess, node_local, active, n_nodes, n_bins,
              count_w=None, lo_planes=None, plane_lo=0, fixed_order=False):
        # the plain versions add in a fixed order already
        if hist.planes_route(n_nodes, n_bins, lo_planes is not None):
            return hist._torch_hist_planes(
                bins, grad, hess, node_local, active, n_nodes, n_bins,
                count_w=count_w, lo_planes=lo_planes, plane_lo=plane_lo)
        return hist._torch_hist(bins, grad, hess, node_local, active,
                                n_nodes, n_bins, count_w=count_w)
    saved = trainer.node_feature_histograms
    trainer.node_feature_histograms = plain
    try:
        yield
    finally:
        trainer.node_feature_histograms = saved


@contextlib.contextmanager
def env(name, value):
    """Set one environment variable for the block, as a user would set it
    for the process."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            del os.environ[name]
        else:
            os.environ[name] = saved


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


def headline_data(dev):
    """The headline's 8M x 32 rows from numpy seed 0, binned on the card
    (bench.py::run_shape's `prebinned` staging)."""
    import torch
    from mmlspark_tpu_torch.ops import binning

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
    return dict(x=x, y=y, staged=(mapper, d_bins, d_y), d_y=d_y)


def _headline_params(**kw):
    from mmlspark_tpu_torch.models.gbdt import BoostParams
    return BoostParams(objective="binary", num_iterations=N_ITERS,
                       num_leaves=31, max_depth=DEPTH, max_bin=MAX_BIN,
                       min_data_in_leaf=20, **kw)


def _counted_fit(x, y, params, staged, dev, want):
    """One fit with the launch counts set to 0 just before and read just
    after; fails unless they equal `want`. Returns (booster, base, s,
    peak bytes)."""
    import torch
    from mmlspark_tpu_torch.models.gbdt import fit_booster
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    torch.cuda.synchronize()
    hc.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    booster, base, _ = fit_booster(x, y, params, prebinned=staged,
                                   device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: v for k, v in hc.launches.items() if v}
    if launches != want:
        raise AssertionError(f"histogram launches {launches}, expected "
                             f"{want}")
    return booster, base, fit_s, torch.cuda.max_memory_allocated()


def main_path_phase(dev, data, profile: bool):
    import dataclasses

    import torch
    from mmlspark_tpu_torch.models.gbdt import fit_booster
    from mmlspark_tpu_torch.ops import histogram_cuda as hc

    x, y, staged, d_y = data["x"], data["y"], data["staged"], data["d_y"]
    params = _headline_params()
    # warm-up (CUDA context, kernel load, allocator) with 1 iteration
    fit_booster(x, y, dataclasses.replace(params, num_iterations=1),
                prebinned=staged, device=dev)
    torch.cuda.synchronize()

    # headline path, timed FIT_REPEATS times: counts set to 0 just
    # before each fit, read just after
    launches = dict(hist_tiled=N_ITERS * DEPTH)
    fit_times = []
    for _ in range(FIT_REPEATS):
        booster, base, fit_s, peak = _counted_fit(x, y, params, staged, dev,
                                                  launches)
        fit_times.append(fit_s)
    fit_s = float(np.median(fit_times))
    log(f"[main] fit_booster binary depth {DEPTH} leaves 31 B={MAX_BIN + 1} "
        f"{N_ITERS} iters, {FIT_REPEATS} fits: "
        f"{', '.join(f'{t:.4f}' for t in fit_times)} s; min "
        f"{min(fit_times):.4f} s, median {fit_s:.4f} s = "
        f"{N_ROWS * N_ITERS / fit_s:.4g} rows*iters/s; histogram launches "
        f"{launches} per fit; peak memory {peak / 2**30:.2f} GiB "
        f"(max_memory_allocated); {booster.n_trees} trees")

    # bulk scoring on the card, then serving-sized host batches
    t0 = time.perf_counter()
    margin = booster.raw_score_device(x, device=dev)[:, 0] + base
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    if margin.shape != (N_ROWS,) or not bool(torch.isfinite(margin).all()):
        raise AssertionError("bulk margins are not finite (n,) values")
    _serving_check(booster, base, x, dev, "main")
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

    # deep path: the deepest level's m*B outgrows one block, so its nodes
    # are split over tiles; counts set to 0 just before, read just after
    deep = dataclasses.replace(params, num_iterations=1, max_depth=11)
    hc.reset_launches()
    t0 = time.perf_counter()
    fit_booster(x, y, deep, prebinned=staged, device=dev)
    torch.cuda.synchronize()
    deep_s = time.perf_counter() - t0
    deep_launches = {k: v for k, v in hc.launches.items() if v}
    if deep_launches != dict(hist_tiled=11):
        raise AssertionError(f"deep fit launches {deep_launches}, expected "
                             f"11 of the tiled kernel")
    log(f"[main] max_depth=11 fit, 1 iteration: {deep_s:.3f} s; launches "
        f"{deep_launches} (levels 0-10, the last split over node tiles)")

    if profile:
        from torch.profiler import ProfilerActivity, profile as tprof
        one = dataclasses.replace(params, num_iterations=1)
        with tprof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            fit_booster(x, y, one, prebinned=staged, device=dev)
            torch.cuda.synchronize()
        log(prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25))
    return dict(launches=launches, deep_launches=deep_launches,
                fit_times=fit_times, booster=booster, base=base)


def _bf16(t):
    import torch
    return t.to(torch.bfloat16).to(torch.float32)


def _planes_bound(n, n_active, f, b, m, lo, with_count):
    """`_bound` with the plan's bytes added: LO bytes for each active
    (row, feature)."""
    nbytes = (4 * n + n_active * (f * (1 + lo) + 8 + 4 * with_count)
              + 3 * m * f * b * 4)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 3 * n_active * f / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def _planes_sector_floor(node, f, b, m, lo, with_count):
    """`_planes_bound`'s bytes with the plan counted in 32-byte sectors,
    the least a kernel can read of it: a sector that holds any active
    row's plan bytes is read whole (at LO = 16 two rows share one), so at
    m/(m+1) of the rows active nearly every sector is read. Returns ms at
    PEAK_BYTES_PER_S."""
    import torch
    n = node.shape[0]
    active = (node >= 0) & (node < m)
    n_active = int(active.sum())
    per = max(1, 32 // lo)                        # rows a sector
    active = torch.cat([active, active.new_zeros((-n) % per)])
    sectors = int(active.reshape(-1, per).any(1).sum())
    nbytes = (4 * n + n_active * (f + 8 + 4 * with_count)
              + f * sectors * max(32, per * lo) + 3 * m * f * b * 4)
    return nbytes / PEAK_BYTES_PER_S * 1e3


def _planes_tc_ms(n_active, f, b, m, lo):
    """The TPU kernel's dense one-hot product, (3 m B/LO, rows) @ (rows,
    LO) per feature over the active rows, at the card's dense bf16
    tensor-core peak: ms."""
    return 2 * 3 * m * (b // lo) * lo * n_active * f \
        / PEAK_BF16_FLOP_PER_S * 1e3


def _parent_histogram_cuda(parent):
    """The `histogram_cuda` module of the checkout at `parent`, imported
    beside this one's as package `chip_parent_ops` (its `_build` builds
    that checkout's sources into that checkout's build directory)."""
    import importlib
    import importlib.util
    root = os.path.join(os.path.abspath(parent), "mmlspark_tpu_torch", "ops")
    spec = importlib.util.spec_from_file_location(
        "chip_parent_ops", os.path.join(root, "__init__.py"),
        submodule_search_locations=[root])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["chip_parent_ops"] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module("chip_parent_ops.histogram_cuda")


# the planes kernel's cases (m, B): the planes fit's levels at the
# headline's 64 bins (LO = 16) and one B = 256 level (LO = 64)
PLANES_CASES = [(1, 64), (2, 64), (4, 64), (4, 256)]


def planes_kernel_phase(dev, parent=None):
    """`hist_planes` against `_torch_hist_planes` on the same CUDA
    tensors: 8M x 32 x 64 bins (LO = 16) at m in {1, 2, 4} and one
    B = 256 (LO = 64) case, with inactive rows, without and with count_w.
    A plan of the bins shifted by one row must fail the same check. Beside
    the times: `hist_tiled` on the same inputs and its largest difference
    from the planes kernel as a share of sum |g| per bin; the bound, the
    sector floor and the dense product's tensor-core time; with `parent`
    (a checkout, `--versus`), that checkout's `hist_planes` on the same
    inputs, timed parent, change, change, parent."""
    import torch
    from mmlspark_tpu_torch.ops import histogram as hist
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    gen = torch.Generator(device=dev).manual_seed(2)
    results = []
    parent_hc = _parent_histogram_cuda(parent) if parent else None
    for m, b in PLANES_CASES:
        f = N_FEAT
        inputs = _hist_inputs(gen, dev, N_ROWS, f, b, m)
        bins, grad, hess, node, active, cw = inputs
        lo = hist.plan_lo_bins(b)
        t0 = time.perf_counter()
        plan = hist.build_hist_plan(bins, b)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        kw = dict(lo_planes=plan, plane_lo=lo)
        # the limit scale: sum of |g| per bin of the stats both sides add
        abs_grad = hist._torch_hist(bins, _bf16(grad).abs(), hess, node,
                                    active, m, b)[0]
        err = 0.0
        for w in (None, cw):
            got = hc.hist_planes(*inputs[:5], m, b, count_w=w, **kw)
            want = hist._torch_hist_planes(*inputs[:5], m, b, count_w=w,
                                           **kw)
            torch.cuda.synchronize()
            label = f"hist_planes m={m} B={b} count_w " + \
                ("set" if w is not None else "None")
            err = max(err, _check_hist(got, want, abs_grad, label))
        shifted = hist.build_hist_plan(torch.roll(bins, 1, 0), b)
        bad = hc.hist_planes(*inputs[:5], m, b, lo_planes=shifted,
                             plane_lo=lo)
        torch.cuda.synchronize()
        try:
            _check_hist(bad, want, abs_grad, "shifted plan")
        except AssertionError as e:
            caught = str(e)
        else:
            raise AssertionError(f"m={m} B={b}: the check passed the kernel "
                                 f"run on a plan of shifted bins")
        del shifted, bad
        # planes (bf16 stats) against hist_tiled (f32 stats), same inputs
        tiled = hc.hist_tiled(*inputs[:5], m, b, count_w=cw)
        f32_abs = hist._torch_hist(bins, grad.abs(), hess, node, active, m,
                                   b)[0]
        nz = f32_abs > 0
        vs_tiled = float(((got[0] - tiled[0]).abs()[nz] / f32_abs[nz]).max())
        if not vs_tiled <= 2.0 ** -8:
            raise AssertionError(f"hist_planes vs hist_tiled: {vs_tiled} of "
                                 f"sum |g| per bin, above bf16's 2^-8")
        del got, want, tiled, f32_abs, abs_grad
        ms = timed(lambda: hc.hist_planes(*inputs[:5], m, b, **kw))
        parent_ms = None
        if parent_hc is not None:
            runs = [timed(lambda: mod.hist_planes(*inputs[:5], m, b, **kw))
                    for mod in (parent_hc, hc, hc, parent_hc)]
            parent_ms = (runs[0] + runs[3]) / 2
            log(f"[planes] versus m={m} B={b} (parent, change, change, "
                f"parent): {', '.join(f'{x:.3f}' for x in runs)} ms")
        tiled_ms = timed(lambda: hc.hist_tiled(*inputs[:5], m, b))
        plain_ms = timed(lambda: hist._torch_hist_planes(*inputs[:5], m, b,
                                                         **kw),
                         warmup=1, reps=3)
        lib = _index_add_call(bins, _bf16(grad), _bf16(hess), node, active,
                              torch.ones_like(cw), m, b)
        library_ms = timed(lib, warmup=1, reps=5)
        del lib
        n_active = int(active.sum())
        bound_ms, bound_by = _planes_bound(N_ROWS, n_active, f, b, m, lo,
                                           with_count=False)
        sector_ms = _planes_sector_floor(node, f, b, m, lo, False)
        tc_ms = _planes_tc_ms(n_active, f, b, m, lo)
        log(f"[planes] hist_planes n={N_ROWS} F={f} B={b} LO={lo} m={m}: "
            f"plan {plan.numel() / 1e9:.3f} GB built in {plan_s:.3f} s; "
            f"match with and without count_w (counts exact, max abs err "
            f"{err:.3g}); shifted plan rejected ({caught[:60]}...); "
            f"vs hist_tiled {vs_tiled:.3g} of sum |g| per bin; kernel "
            f"{ms:.3f} ms (parent "
            f"{'not measured' if parent_ms is None else f'{parent_ms:.3f}'}"
            f"), hist_tiled {tiled_ms:.3f} ms, plain {plain_ms:.3f} "
            f"ms, one index_add_ {library_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        log(f"[planes]   m={m} B={b}: sector floor {sector_ms:.4f} ms "
            f"(kernel {ms / sector_ms:.2f}x); dense product at the bf16 "
            f"tensor-core peak {tc_ms:.4f} ms; kernel {ms / bound_ms:.2f}x "
            f"the bound")
        results.append(dict(
            m=m, n=N_ROWS, f=f, b=b, lo=lo, max_abs_err=err, ms=ms,
            parent_ms=parent_ms, tiled_ms=tiled_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            sector_floor_ms=sector_ms, tc_ms=tc_ms, vs_tiled=vs_tiled,
            plan_bytes=plan.numel()))
        del inputs, bins, grad, hess, node, active, cw, plan, kw
        torch.cuda.empty_cache()
    return results


def _fit_metrics(booster, base, x, d_y, dev):
    margin = booster.raw_score_device(x, device=dev)[:, 0] + base
    if margin.shape != (N_ROWS,) or not bool(margin.isfinite().all()):
        raise AssertionError("margins are not finite (n,) values")
    return _metrics(margin, d_y)


def planes_path_phase(dev, data):
    """The headline fit with MMLSPARK_TPU_HIST=planes set in the process,
    bagging 0.8 every iteration and feature_fraction 0.8: exactly 40
    planes (m = 1, 1, 2, 4 per tree) and 10 `hist_tiled` (m = 8)
    launches; its train logloss/AUC against the same fit, from the same
    seed, whose histograms come from the plain versions on the card."""
    import dataclasses

    import torch
    from mmlspark_tpu_torch.models.gbdt import fit_booster
    from mmlspark_tpu_torch.ops import histogram as hist
    from mmlspark_tpu_torch.ops import histogram_cuda as hc

    x, y, staged, d_y = data["x"], data["y"], data["staged"], data["d_y"]
    params = _headline_params(bagging_fraction=0.8, bagging_freq=1,
                              feature_fraction=0.8)
    want = dict(hist_tiled=N_ITERS, hist_planes=N_ITERS * (DEPTH - 1))
    plan_bytes = N_FEAT * N_ROWS * hist.plan_lo_bins(MAX_BIN + 1)
    with env("MMLSPARK_TPU_HIST", "planes"):
        fit_booster(x, y, dataclasses.replace(params, num_iterations=1),
                    prebinned=staged, device=dev)
        booster, base, fit_s, peak = _counted_fit(x, y, params, staged, dev,
                                                  want)
        logloss, auc = _fit_metrics(booster, base, x, d_y, dev)
        hc.reset_launches()
        with plain_histograms():
            t0 = time.perf_counter()
            ref, ref_base, _ = fit_booster(x, y, params, prebinned=staged,
                                           device=dev)
            torch.cuda.synchronize()
            ref_s = time.perf_counter() - t0
    if any(hc.launches.values()):
        raise AssertionError("the plain-histogram fit launched a kernel")
    ref_logloss, ref_auc = _fit_metrics(ref, ref_base, x, d_y, dev)
    log(f"[planes] MMLSPARK_TPU_HIST=planes fit, bagging 0.8/1, "
        f"feature_fraction 0.8, {N_ITERS} iters: {fit_s:.4f} s = "
        f"{N_ROWS * N_ITERS / fit_s:.4g} rows*iters/s; launches {want}; plan "
        f"{plan_bytes / 1e9:.3f} GB; peak memory {peak / 2**30:.2f} GiB; "
        f"logloss {logloss:.6f}, AUC {auc:.6f}; plain-histogram twin "
        f"{ref_s:.2f} s: logloss {ref_logloss:.6f}, AUC {ref_auc:.6f}; "
        f"split features equal at "
        f"{float((ref.split_feature == booster.split_feature).mean()):.3f}")
    if abs(logloss - ref_logloss) > _METRIC_TOL or \
            abs(auc - ref_auc) > _METRIC_TOL:
        raise AssertionError("planes fit and plain-histogram fit disagree")
    if not auc > 0.8:
        raise AssertionError(f"train AUC {auc} is not a trained model")
    return dict(launches=want, fit_s=fit_s, peak=peak, plan_bytes=plan_bytes,
                logloss=logloss, auc=auc)


# LightGBM's defaults for goss and dart; rf with bagging, as it needs
BOOSTING_MODES = {
    "goss": dict(boosting="goss", top_rate=0.2, other_rate=0.1),
    "dart": dict(boosting="dart", drop_rate=0.1, skip_drop=0.5, max_drop=50),
    "rf": dict(boosting="rf", bagging_fraction=0.8, bagging_freq=1),
}
TWIN_ITERS = 3


def modes_phase(dev, data):
    """goss, dart and rf at the headline width: a counted, timed fit of
    N_ITERS iterations each, then a TWIN_ITERS-iteration fit held against
    its twin whose histograms come from the plain version on the card."""
    import dataclasses

    import torch
    from mmlspark_tpu_torch.models.gbdt import fit_booster

    x, y, staged, d_y = data["x"], data["y"], data["staged"], data["d_y"]
    out = {}
    for name, kw in BOOSTING_MODES.items():
        params = _headline_params(**kw)
        booster, base, fit_s, peak = _counted_fit(
            x, y, params, staged, dev, dict(hist_tiled=N_ITERS * DEPTH))
        logloss, auc = _fit_metrics(booster, base, x, d_y, dev)
        short = dataclasses.replace(params, num_iterations=TWIN_ITERS)
        twin, twin_base, _, _ = _counted_fit(
            x, y, short, staged, dev, dict(hist_tiled=TWIN_ITERS * DEPTH))
        t_ll, t_auc = _fit_metrics(twin, twin_base, x, d_y, dev)
        with plain_histograms():
            ref, ref_base, _ = fit_booster(x, y, short, prebinned=staged,
                                           device=dev)
            torch.cuda.synchronize()
        r_ll, r_auc = _fit_metrics(ref, ref_base, x, d_y, dev)
        log(f"[modes] {name} {kw}: {N_ITERS} iters {fit_s:.4f} s = "
            f"{N_ROWS * N_ITERS / fit_s:.4g} rows*iters/s, peak "
            f"{peak / 2**30:.2f} GiB, logloss {logloss:.6f}, AUC {auc:.6f}; "
            f"{TWIN_ITERS} iters: kernel logloss {t_ll:.6f} AUC {t_auc:.6f}, "
            f"plain {r_ll:.6f} / {r_auc:.6f}")
        if abs(t_ll - r_ll) > _METRIC_TOL or abs(t_auc - r_auc) > _METRIC_TOL:
            raise AssertionError(f"{name}: kernel and plain-histogram fits "
                                 f"disagree")
        if not (np.isfinite([logloss, auc]).all() and auc > 0.7):
            raise AssertionError(f"{name}: AUC {auc} is not a trained model")
        out[name] = dict(fit_s=fit_s, peak=peak, logloss=logloss, auc=auc,
                         twin=(t_ll, t_auc), plain=(r_ll, r_auc))
    return out


# LightGBM's "MS LTR" experiment (docs/Experiments.rst): 2,270,296 rows x
# 137 features, max_bin 255, 255 leaves (max_depth 8 here); ~120
# documents a query, relevance labels 0-4
LTR_ROWS, LTR_FEAT, LTR_ITERS = 2_270_296, 137, 5
LTR_PARAMS = dict(max_bin=255, max_depth=8, num_leaves=255,
                  min_data_in_leaf=100, learning_rate=0.1)


def _ltr_data():
    rng = np.random.default_rng(0)
    sizes = rng.integers(100, 141, LTR_ROWS // 100)
    sizes = sizes[:np.searchsorted(np.cumsum(sizes), LTR_ROWS) + 1]
    sizes[-1] -= sizes.sum() - LTR_ROWS
    group = np.repeat(np.arange(len(sizes)), sizes)
    x = rng.standard_normal((LTR_ROWS, LTR_FEAT), dtype=np.float32)
    rel = x[:, :20] @ rng.normal(size=20) + rng.normal(scale=2.0,
                                                       size=LTR_ROWS)
    y = np.digitize(rel, np.quantile(rel, [0.5, 0.75, 0.9, 0.97]))
    return x, y.astype(np.float32), group


def _ndcg_at(scores, labels, g_idx, k=10):
    """Mean NDCG@k over the queries with a relevant document; ties rank
    in data order."""
    import torch
    valid = g_idx >= 0
    idx = g_idx.clamp(min=0).to(torch.int64)
    s = torch.where(valid, scores[idx], -torch.inf)
    gains = torch.where(valid, 2.0 ** labels[idx] - 1, 0.0)
    disc = 1.0 / torch.log2(torch.arange(k, device=scores.device) + 2.0)
    top = torch.argsort(-s, dim=1, stable=True)[:, :k]
    dcg = (gains.gather(1, top) * disc).sum(1)
    ideal = (gains.sort(dim=1, descending=True).values[:, :k] * disc).sum(1)
    ok = ideal > 0
    return float((dcg[ok] / ideal[ok]).mean())


def ranker_phase(dev):
    """`GBDTRanker` on seeded data shaped like LightGBM's MS LTR
    experiment: LTR_ITERS iterations with the launch counts set to 0 just
    before and read just after; NDCG@10 after 1..LTR_ITERS trees must
    rise, and after TWIN_ITERS trees agree with a plain-histogram fit of
    TWIN_ITERS iterations."""
    import torch
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.models.gbdt import GBDTRanker
    from mmlspark_tpu_torch.models.gbdt.objectives import make_group_index
    from mmlspark_tpu_torch.ops import histogram_cuda as hc

    t0 = time.perf_counter()
    x, y, group = _ltr_data()
    table = Table({"features": x, "label": y, "group": group})
    g_idx = torch.as_tensor(make_group_index(group)).to(dev)
    log(f"[ranker] data {LTR_ROWS} x {LTR_FEAT} f32, {g_idx.shape[0]} "
        f"queries of {int((g_idx >= 0).sum(1).min())}-{g_idx.shape[1]} "
        f"documents, labels 0-4 {np.bincount(y.astype(int)).tolist()}, from "
        f"numpy seed 0 in {time.perf_counter() - t0:.1f} s")
    d_x = torch.as_tensor(x).to(dev)
    d_y = torch.as_tensor(y).to(dev)

    def fit(iters):
        return GBDTRanker(num_iterations=iters, device=dev,
                          **LTR_PARAMS).fit(table)

    fit(1)                                  # warm-up
    torch.cuda.synchronize()
    hc.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = fit(LTR_ITERS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: v for k, v in hc.launches.items() if v}
    peak = torch.cuda.max_memory_allocated()
    depth = LTR_PARAMS["max_depth"]
    if launches != dict(hist_tiled=LTR_ITERS * depth):
        raise AssertionError(f"ranker fit launches {launches}")
    booster = model.booster
    ndcg = [_ndcg_at(torch.zeros(LTR_ROWS, device=dev), d_y, g_idx)]
    for t in range(1, LTR_ITERS + 1):
        raw = booster.raw_score_device(d_x, device=dev,
                                       trees=slice(0, t))[:, 0]
        ndcg.append(_ndcg_at(raw, d_y, g_idx))
    with plain_histograms():
        t0 = time.perf_counter()
        ref = fit(TWIN_ITERS)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
    ref_ndcg = _ndcg_at(ref.booster.raw_score_device(d_x, device=dev)[:, 0],
                        d_y, g_idx)
    log(f"[ranker] GBDTRanker {LTR_PARAMS}, {LTR_ITERS} iters: "
        f"{fit_s:.3f} s (binning included) = "
        f"{LTR_ROWS * LTR_ITERS / fit_s:.4g} rows*iters/s; launches "
        f"{launches} (the deepest level m=64 x 256 bins: nodes split over "
        f"tiles); peak {peak / 2**30:.2f} GiB; NDCG@10 after 0.."
        f"{LTR_ITERS} trees {[round(v, 6) for v in ndcg]}; plain-histogram "
        f"fit of {TWIN_ITERS} iters {ref_s:.2f} s, NDCG@10 {ref_ndcg:.6f}")
    if not ndcg[0] < ndcg[1] < ndcg[LTR_ITERS]:
        raise AssertionError(f"NDCG@10 does not rise: {ndcg}")
    if abs(ndcg[TWIN_ITERS] - ref_ndcg) > _METRIC_TOL:
        raise AssertionError("ranker kernel fit and plain-histogram fit "
                             "disagree")
    return dict(launches=launches, fit_s=fit_s, peak=peak, ndcg=ndcg,
                ref_ndcg=ref_ndcg)


# the [categorical] configuration: the headline's rows with columns 24-31
# replaced by category ids of these level counts, drawn with frequencies
# proportional to 1 / (id + 1) (id order is frequency order, as LightGBM
# asks of categorical columns); the label adds one seeded effect per
# category (a permutation of linspace(-1, 1, K)) to the 24 numeric
# columns' linear part (weights of std 0.5, so that both kinds of split
# carry weight)
CAT_COLS = tuple(range(24, 32))
CAT_LEVELS = (4, 8, 16, 24, 32, 48, 64, 64)
# train AUC of the categorical fit over the same fit with no categorical
# slots (tests/test_gbdt_categorical.py::test_categorical_beats_ordinal)
_CAT_AUC_LIFT = 0.02
# rows the pipeline transforms before and after its save and load
PIPE_ROWS = 1 << 20


def categorical_data(dev, data):
    """The headline's x (numpy seed 0) with CAT_COLS replaced by category
    ids from numpy seed 1, its label, and its bins on the card (identity
    bins for CAT_COLS)."""
    import torch
    from mmlspark_tpu_torch.ops import binning

    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    x = data["x"].copy()
    n = x.shape[0]
    z = x[:, :CAT_COLS[0]] @ rng.normal(scale=0.5, size=CAT_COLS[0])
    for col, k in zip(CAT_COLS, CAT_LEVELS):
        p = 1.0 / np.arange(1, k + 1)
        ids = rng.choice(k, size=n, p=p / p.sum())
        z += rng.permutation(np.linspace(-1.0, 1.0, k))[ids]
        x[:, col] = ids
    y = (z + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    log(f"[categorical] data {n} x {x.shape[1]}: columns {CAT_COLS[0]}-"
        f"{CAT_COLS[-1]} category ids of {CAT_LEVELS} levels (numpy seed "
        f"1), positive share {float(y.mean()):.4f}, in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mapper = binning.fit_bins(x, max_bin=MAX_BIN, seed=0,
                              categorical_features=CAT_COLS)
    d_bins = binning.apply_bins_device(mapper, x, device=dev)
    d_y = torch.as_tensor(y).to(dev)
    torch.cuda.synchronize()
    log(f"[categorical] fit_bins + apply_bins_device on the card: "
        f"{time.perf_counter() - t0:.2f} s")
    if not np.array_equal(d_bins[:100_000].cpu().numpy(),
                          binning.apply_bins(mapper, x[:100_000])):
        raise AssertionError("device bins differ from host apply_bins")
    return dict(x=x, y=y, staged=(mapper, d_bins, d_y), d_y=d_y)


def _root_hist_accuracy(staged, d_y, dev):
    """The root level's histograms of the categorical bins with the first
    iteration's binary gradients (two values, so rounding has one sign)
    against a float64 sum: the kernel, the plain version (row-block
    partials) and one f32 `index_add_` per statistic (the plain version
    before slice 11), as max |error| / sum |stat| of a bin. The first two
    must be within `_HIST_RTOL_OF_ABS_SUM`; counts exact."""
    import torch
    from mmlspark_tpu_torch.ops import histogram as hist

    bins = staged[1]
    n, f = bins.shape
    p0 = float(d_y.mean())
    grad = (p0 - d_y).float()
    hess = torch.full_like(grad, p0 * (1 - p0))
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    act = torch.ones(n, dtype=torch.bool, device=dev)
    keys = (torch.arange(f, device=dev)[None, :] * (MAX_BIN + 1)
            + bins.long()).reshape(-1)

    def scatter(dtype, *stats):
        outs = []
        for v in stats:
            o = torch.zeros(f * (MAX_BIN + 1), dtype=dtype, device=dev)
            o.index_add_(0, keys, v.to(dtype)[:, None].expand(n, f)
                         .reshape(-1))
            outs.append(o.reshape(1, f, MAX_BIN + 1))
        return outs
    exact = scatter(torch.float64, grad, hess, torch.ones_like(grad))
    mags = scatter(torch.float64, grad.abs(), hess)
    out = {}
    for name, got in (("kernel", hist.node_feature_histograms(
            bins, grad, hess, node, act, 1, MAX_BIN + 1)),
            ("plain", hist._torch_hist(bins, grad, hess, node, act, 1,
                                       MAX_BIN + 1)),
            ("one index_add_", scatter(torch.float32, grad, hess,
                                       torch.ones_like(grad)))):
        errs = [float(((g.double() - e).abs() / m.clamp(min=1e-30)).max())
                for g, e, m in zip(got[:2], exact[:2], mags)]
        if not torch.equal(got[2].double(), exact[2]):
            raise AssertionError(f"{name}: root counts are not exact")
        out[name] = errs
    log("[categorical] root histograms against a float64 sum, max |error| "
        "/ sum |stat| of a bin (grad, hess): " + "; ".join(
            f"{k} {v[0]:.3g}, {v[1]:.3g}" for k, v in out.items()))
    for name in ("kernel", "plain"):
        if max(out[name]) > _HIST_RTOL_OF_ABS_SUM:
            raise AssertionError(f"{name} root histograms are off the "
                                 f"float64 sum by {max(out[name])}")
    return out


def _serving_check(booster, base, x, dev, tag):
    """scoring_plan batches of 1, 16 and 256 rows against bulk device
    scoring, and the auto route (host under 4096 rows) against the host."""
    bulk = booster.raw_score(x[:200_000], base, backend="device",
                             device=dev)
    plan = booster.scoring_plan(base)
    for rows in (1, 16, 256):
        batch = x[1000:1000 + rows]
        t1 = time.perf_counter()
        served = plan(batch)
        t_plan = time.perf_counter() - t1
        auto = booster.raw_score(batch, base)
        if not (np.allclose(served, bulk[1000:1000 + rows], rtol=1e-5,
                            atol=1e-5)
                and np.array_equal(auto, booster.raw_score(
                    batch, base, backend="host"))):
            raise AssertionError(f"{tag}: serving batch of {rows} disagrees "
                                 f"with bulk device scoring")
        log(f"[{tag}] serving batch {rows} rows: scoring_plan "
            f"{t_plan * 1e3:.3f} ms, agrees with device scoring")


_PIPE_LOAD = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
from mmlspark_tpu_torch.core import PipelineModel, Table
mod = "mmlspark_tpu_torch.models.gbdt.estimators"
before = mod in sys.modules
t0 = time.perf_counter()
model = PipelineModel.load(sys.argv[2])
load_s = time.perf_counter() - t0
out = model.transform(Table({"features": np.load(sys.argv[3])}))
np.save(sys.argv[4], out["prediction"])
np.save(sys.argv[5], out["probabilities"])
print(json.dumps({"imported_before_load": before, "load_s": load_s,
                  "device": str(model.get_or_default("stages")[0].device)}))
"""


def pipeline_check(dev, x, y):
    """`Pipeline([GBDTClassifier(categorical_slot_names=...)])` fitted on
    the card from a table whose features carry `feature_names`; saved,
    loaded in a subprocess that has not imported the estimators, and
    scored there: predictions and probabilities bit for bit the fitted
    model's."""
    import shutil
    import tempfile

    import torch
    from mmlspark_tpu_torch.core import Pipeline, Table
    from mmlspark_tpu_torch.models.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.ops import histogram_cuda as hc

    names = [f"num{i}" for i in range(CAT_COLS[0])] + [
        f"cat{i}_{k}" for i, k in enumerate(CAT_LEVELS)]
    table = Table({"features": x, "label": y}).with_column_meta(
        "features", feature_names=names)
    est = GBDTClassifier(categorical_slot_names=tuple(names[CAT_COLS[0]:]),
                         num_iterations=N_ITERS, num_leaves=31,
                         max_depth=DEPTH, max_bin=MAX_BIN,
                         min_data_in_leaf=20, device=dev)
    torch.cuda.synchronize()
    hc.reset_launches()
    t0 = time.perf_counter()
    model = Pipeline([est]).fit(table)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: v for k, v in hc.launches.items() if v}
    if launches != dict(hist_tiled=N_ITERS * DEPTH):
        raise AssertionError(f"pipeline fit launches {launches}")
    booster = model.get_or_default("stages")[0].booster
    if booster.split_is_cat is None or not booster.split_is_cat.any():
        raise AssertionError("the pipeline's model has no categorical split")
    score = Table({"features": x[:PIPE_ROWS]})
    t0 = time.perf_counter()
    want = model.transform(score)
    transform_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    try:
        path = os.path.join(tmp, "model")
        t0 = time.perf_counter()
        model.save(path)
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(path) for f in fs)
        files = [os.path.join(tmp, f) for f in ("x.npy", "pred.npy",
                                                 "proba.npy")]
        np.save(files[0], x[:PIPE_ROWS])
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _PIPE_LOAD, HERE, path,
                               *files], capture_output=True, text=True,
                              timeout=600)
        sub_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"loading in a subprocess failed:\n"
                                 f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        sub = json.loads(proc.stdout.strip().splitlines()[-1])
        pred, proba = np.load(files[1]), np.load(files[2])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if sub["imported_before_load"]:
        raise AssertionError("the subprocess had imported the estimators")
    same = (np.array_equal(pred, want["prediction"])
            and np.array_equal(proba, want["probabilities"]))
    log(f"[categorical] Pipeline([GBDTClassifier(categorical_slot_names="
        f"{len(CAT_COLS)} names)]) fit on the card {fit_s:.3f} s (binning "
        f"included), launches {launches}; transform of {PIPE_ROWS} rows "
        f"{transform_s:.3f} s; save {save_s:.4f} s, {size} bytes; load in a "
        f"subprocess {sub['load_s']:.4f} s (on {sub['device']}; the "
        f"subprocess {sub_s:.1f} s in all); predictions and probabilities "
        f"after the load bit-identical: {same}")
    if not same:
        raise AssertionError("the loaded pipeline scores differently")
    return dict(fit_s=fit_s, launches=launches, save_s=save_s,
                load_s=sub["load_s"], bytes=size)


@contextlib.contextmanager
def _cat_ranges():
    """torch.profiler ranges around the categorical split search and the
    categorical routing step, for `--profile`."""
    from torch.profiler import record_function
    from mmlspark_tpu_torch.models.gbdt import trainer
    saved = trainer._best_splits_for_level, trainer._cat_go_left

    def split(*a, **k):
        with record_function("cat.split_search"):
            return saved[0](*a, **k)

    def route(*a, **k):
        with record_function("cat.route"):
            return saved[1](*a, **k)
    trainer._best_splits_for_level, trainer._cat_go_left = split, route
    try:
        yield
    finally:
        trainer._best_splits_for_level, trainer._cat_go_left = saved


def _device_us(evt, own=False):
    """Device microseconds of a profiler event (the name of the attribute
    changed across torch versions)."""
    for name in (("self_device_time_total", "self_cuda_time_total") if own
                 else ("device_time_total", "cuda_time_total")):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _profile_categorical(x, y, params, staged, dev):
    """torch.profiler of one categorical iteration: kernel time in all (the
    host-side events' own device time, so the annotation ranges' GPU spans
    are not counted twice), the split search's and the categorical
    routing's kernels, and the sorts' (aten::sort, which argsort calls)."""
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprof
    from mmlspark_tpu_torch.models.gbdt import fit_booster
    one = dataclasses.replace(params, num_iterations=1)
    with _cat_ranges(), tprof(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit_booster(x, y, one, prebinned=staged, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30))
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    total = sum(_device_us(e, own=True) for e in host)

    def under(name):
        return sum(_device_us(e) for e in host if e.name == name)
    split, route, sort = (under("cat.split_search"), under("cat.route"),
                          under("aten::sort"))
    log(f"[categorical] profile of one iteration: {total / 1e3:.3f} ms of "
        f"kernel time in {wall * 1e3:.1f} ms of wall (idle "
        f"{100 * (1 - total / 1e3 / (wall * 1e3)):.1f}%); split search "
        f"{split / 1e3:.3f} ms ({100 * split / max(total, 1):.2f}%), of "
        f"which sorts {sort / 1e3:.3f} ms ({100 * sort / max(total, 1):.2f}"
        f"%); categorical routing {route / 1e3:.3f} ms "
        f"({100 * route / max(total, 1):.2f}%)")
    return dict(kernel_ms=total / 1e3, wall_ms=wall * 1e3,
                split_ms=split / 1e3, sort_ms=sort / 1e3,
                route_ms=route / 1e3)


def categorical_phase(dev, data, numeric_times, profile: bool):
    """The [categorical] configuration at the headline's width: a warm-up,
    FIT_REPEATS counted fits (50 `hist_tiled` each), its plain-histogram
    twin within `_METRIC_TOL`, categorical splits present, train AUC over
    the ordinal twin (the same bins, no categorical slots) by more than
    `_CAT_AUC_LIFT`; one counted fit under MMLSPARK_TPU_HIST=planes and its
    planes plain twin; bulk and serving scoring; the pipeline's save and
    load (`pipeline_check`)."""
    import dataclasses

    import torch
    from mmlspark_tpu_torch.models.gbdt import fit_booster
    from mmlspark_tpu_torch.ops import histogram_cuda as hc

    cat = categorical_data(dev, data)
    x, y, staged, d_y = cat["x"], cat["y"], cat["staged"], cat["d_y"]
    root = _root_hist_accuracy(staged, d_y, dev)
    params = _headline_params(categorical_features=CAT_COLS)
    fit_booster(x, y, dataclasses.replace(params, num_iterations=1),
                prebinned=staged, device=dev)
    torch.cuda.synchronize()
    want = dict(hist_tiled=N_ITERS * DEPTH)
    fit_times = []
    for _ in range(FIT_REPEATS):
        booster, base, fit_s, peak = _counted_fit(x, y, params, staged, dev,
                                                  want)
        fit_times.append(fit_s)
    fit_s = float(np.median(fit_times))
    num_s = float(np.median(numeric_times))
    if booster.split_is_cat is None or not booster.split_is_cat.any():
        raise AssertionError("the categorical fit has no categorical split")
    n_cat = int(booster.split_is_cat.sum())
    n_split = int((booster.split_feature >= 0).sum())
    log(f"[categorical] fit_booster binary depth {DEPTH} leaves 31 B="
        f"{MAX_BIN + 1}, categorical_features {CAT_COLS}, {N_ITERS} iters, "
        f"{FIT_REPEATS} fits: {', '.join(f'{t:.4f}' for t in fit_times)} "
        f"s; median {fit_s:.4f} s = {N_ROWS * N_ITERS / fit_s:.4g} "
        f"rows*iters/s (the numeric headline's median in this run "
        f"{num_s:.4f} s, x{fit_s / num_s:.3f}); launches {want} per fit; "
        f"peak memory {peak / 2**30:.2f} GiB; {n_cat} of {n_split} splits "
        f"categorical")

    t0 = time.perf_counter()
    logloss, auc = _fit_metrics(booster, base, x, d_y, dev)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    _serving_check(booster, base, x, dev, "categorical")
    hc.reset_launches()
    with plain_histograms():
        ref, ref_base, _ = fit_booster(x, y, params, prebinned=staged,
                                       device=dev)
    if any(hc.launches.values()):
        raise AssertionError("the plain-histogram fit launched a kernel")
    r_ll, r_auc = _fit_metrics(ref, ref_base, x, d_y, dev)
    ordinal = dataclasses.replace(params, categorical_features=())
    o_b, o_base, o_s, _ = _counted_fit(x, y, ordinal, staged, dev, want)
    o_ll, o_auc = _fit_metrics(o_b, o_base, x, d_y, dev)
    log(f"[categorical] bulk raw_score + metrics on the card {score_s:.3f} "
        f"s; logloss {logloss:.6f}, AUC {auc:.6f}; plain-histogram twin "
        f"logloss {r_ll:.6f}, AUC {r_auc:.6f}, categorical words equal at "
        f"{float(np.mean(ref.cat_words == booster.cat_words)):.4f}; "
        f"ordinal twin (no categorical slots) {o_s:.4f} s, logloss "
        f"{o_ll:.6f}, AUC {o_auc:.6f}: lift {auc - o_auc:.6f}")
    if abs(logloss - r_ll) > _METRIC_TOL or abs(auc - r_auc) > _METRIC_TOL:
        raise AssertionError("categorical kernel fit and plain-histogram fit "
                             "disagree")
    if not auc > o_auc + _CAT_AUC_LIFT:
        raise AssertionError(f"categorical AUC {auc} does not beat the "
                             f"ordinal twin's {o_auc} by {_CAT_AUC_LIFT}")

    planes_want = dict(hist_tiled=N_ITERS, hist_planes=N_ITERS * (DEPTH - 1))
    with env("MMLSPARK_TPU_HIST", "planes"):
        p_b, p_base, p_s, p_peak = _counted_fit(x, y, params, staged, dev,
                                                planes_want)
        p_ll, p_auc = _fit_metrics(p_b, p_base, x, d_y, dev)
        hc.reset_launches()
        with plain_histograms():
            pr, pr_base, _ = fit_booster(x, y, params, prebinned=staged,
                                         device=dev)
    if any(hc.launches.values()):
        raise AssertionError("the planes plain twin launched a kernel")
    pr_ll, pr_auc = _fit_metrics(pr, pr_base, x, d_y, dev)
    log(f"[categorical] MMLSPARK_TPU_HIST=planes fit: {p_s:.4f} s, launches "
        f"{planes_want}, peak {p_peak / 2**30:.2f} GiB; logloss "
        f"{p_ll:.6f}, AUC {p_auc:.6f}; planes plain twin logloss "
        f"{pr_ll:.6f}, AUC {pr_auc:.6f}")
    if abs(p_ll - pr_ll) > _METRIC_TOL or abs(p_auc - pr_auc) > _METRIC_TOL:
        raise AssertionError("categorical planes fit and its plain twin "
                             "disagree")
    if p_b.split_is_cat is None or not p_b.split_is_cat.any():
        raise AssertionError("the planes fit has no categorical split")

    pipe = pipeline_check(dev, x, y)
    prof = (_profile_categorical(x, y, params, staged, dev) if profile
            else None)
    return dict(launches=want, fit_times=fit_times, fit_s=fit_s, peak=peak,
                auc=auc, ordinal_auc=o_auc, planes_launches=planes_want,
                root_hist_errors=root,
                planes_s=p_s, pipeline=pipe, profile=prof, booster=booster,
                base=base, x_head=x[:INTROSPECT_ROWS].copy())


def _flash_cases():
    """(label, Sq, Sk, H, D, timed) of the flash kernel phase, each run in
    f32 and bf16, causal and not. The first is the main path's shape."""
    return [("main", SEQ, SEQ, 8, 128, True),
            ("d64", SEQ, SEQ, 8, 64, True),
            ("ragged", SEQ - 384, SEQ - 384, 8, 128, False),
            ("cross", 96, 40, 2, 32, False),
            ("d16", SEQ // 4, SEQ // 4, 8, 16, False)]


def _visible_pairs(sq, sk, q_off, k_off, causal):
    """(query, key) pairs the mask keeps at global offsets."""
    if not causal:
        return sq * sk
    return sum(min(max(q_off + i - k_off + 1, 0), sk) for i in range(sq))


def _peak_flops(dtype, split3=False):
    """The rate of the flash kernels' products: bf16 tensor cores, f32
    FMAs, or (split3) the f32 kernels' own rate, six bf16 tensor-core
    products per product."""
    import torch
    if split3:
        return PEAK_BF16_FLOP_PER_S / 6
    return PEAK_BF16_FLOP_PER_S if dtype == torch.bfloat16 \
        else PEAK_F32_FLOP_PER_S


def _flash_bound(sq, sk, h, d, dtype, causal, split3=False):
    """(ms, "bytes" or "operations"): 4 * (visible q/k pairs) * D * H
    FLOPs over the dtype's peak (f32 FMAs; bf16 tensor cores; `split3`:
    the f32 kernel's own rate, `_peak_flops`), against q, k, v read once
    and out, lse written once."""
    import torch
    pairs = _visible_pairs(sq, sk, 0, 0, causal)
    peak = _peak_flops(dtype, split3)
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


def _bf16_limit(q, k, v, causal, scale, want, q_off=0, k_off=0):
    """The per-element limit on |kernel - plain| of a bf16 output, causal
    at the given global offsets."""
    from mmlspark_tpu_torch.ops import flash_attention as fa
    r = fa._bf16_rounding_scale(q, k, v, causal, scale, q_off, k_off)
    return _BF16_OUT_ULP * want.float().abs() + _BF16_P_NOISE * r


def _limit_used(got, want, lim):
    """max |got - want| / limit over the elements, where an exact match
    counts 0 even at a limit of 0 (a fully masked pair's) and any other
    difference there counts inf."""
    import torch
    diff = (got.float() - want.float()).abs()
    return float(torch.where(diff == 0, 0.0, diff / lim).max())


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


def _fwd_case(dev, gen, label, sq, sk, h, d, is_timed, dtype,
              causal):
    """One case of `flash_kernel_phase`: `flash_fwd` against the plain
    version at (Sq, Sk, H, D, dtype, causal), timed if `is_timed`;
    returns its row."""
    import torch
    from mmlspark_tpu_torch.ops import flash_attention as fa
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
        if dtype == torch.float32:
            row["split3_bound_ms"] = _flash_bound(
                sq, sk, h, d, dtype, causal, split3=True)[0]
            msg += (f", {row['split3_bound_ms']:.4f} ms at the "
                    f"split's tensor-core rate")
    log(msg)
    del q, k, v
    torch.cuda.empty_cache()
    return row


def flash_kernel_phase(dev):
    """`flash_fwd` against `_flash_forward_lse_plain` on the same CUDA
    tensors, out and lse; the main-path shapes timed."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(2)
    return [_fwd_case(dev, gen, *case, dtype, causal)
            for case in _flash_cases()
            for dtype in (torch.float32, torch.bfloat16)
            for causal in (False, True)]


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
    from mmlspark_tpu_torch.parallel import data_mesh

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
        if adt is None:
            flash32 = flash
        del flash, dense

    # the sequence-parallel encode: attention="ring" (dense blocks, as the
    # reference's encoder runs it) over 4 positions of this card
    mesh = data_mesh(devices=[dev] * 4)
    enc.set(attention="ring", attention_dtype=None)
    ring, n, wall, peak = run("encode_long ring float32, 4 positions",
                              lambda: enc.encode_long(tokens, mesh=mesh))
    diff = float(np.abs(ring - flash32).max())
    log(f"[encoder] ring vs flash float32: max |diff| {diff:.3g} (limit "
        f"{_ENCODE_TOL[None]})")
    if any(fa.launches.values()) or not np.isfinite(ring).all() or \
            ring.shape != flash32.shape or diff > _ENCODE_TOL[None]:
        raise AssertionError("ring and flash encodes disagree")
    paths["ring"] = dict(launches=n, s=wall, peak=peak, diff=diff)
    del ring, flash32

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


def _bwd_bound(sq, sk, h, d, dtype, causal, kernel, q_off=0, k_off=0,
               do_dtype=None, split3=False):
    """(ms, "bytes" or "operations") of the flash backward's `kernel`, causal
    at the global offsets: "dq" computes 3 products of 2 * (visible q/k
    pairs) * D per head (S, dP, dQ) and writes dq; "dkv" 4 (S, dP, dV, dK)
    and writes dk, dv; "all", the whole backward, 5 and writes all three.
    Where any pair is visible it reads q, k, v, dO (in `do_dtype`, else the
    inputs' dtype) and the f32 lse and dsum once; where none is, its
    outputs are zeros whatever the inputs, so it need only write them.
    f32 products count at the 67 TFLOP/s of f32 FMAs, or, with `split3`,
    as 6 bf16 tensor-core products each (the f32 kernels' three-term
    split) at 989 TFLOP/s."""
    import torch
    n_products, n_out = {"dq": (3, sq), "dkv": (4, 2 * sk),
                         "all": (5, sq + 2 * sk)}[kernel]
    pairs = _visible_pairs(sq, sk, q_off, k_off, causal)
    peak = PEAK_BF16_FLOP_PER_S if dtype == torch.bfloat16 \
        else PEAK_BF16_FLOP_PER_S / 6 if split3 else PEAK_F32_FLOP_PER_S
    t_ops = n_products * 2 * pairs * d * h / peak
    size = torch.tensor([], dtype=dtype).element_size()
    do_size = torch.tensor([], dtype=do_dtype or dtype).element_size()
    reads = ((sq + 2 * sk) * h * d * size + sq * h * d * do_size
             + 8 * h * sq) if pairs else 0
    t_bytes = (reads + n_out * h * d * size) / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        ("bytes" if t_bytes > t_ops else "operations")


def _sdpa_backward_call(q, k, v, do, causal, scale):
    """The library yardstick: the backward of ONE
    `scaled_dot_product_attention` call on (1, H, S, D) copies of the same
    inputs, `out.backward(dO, retain_graph=True)` timed on its own (the
    forward and the copies are outside the timing). The port never calls
    it."""
    import torch.nn.functional as F
    qh, kh, vh = (t.permute(1, 0, 2).unsqueeze(0).contiguous()
                  .requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                         scale=scale)
    g = do.permute(1, 0, 2).unsqueeze(0).contiguous()
    return lambda: out.backward(g, retain_graph=True)


def _bwd_case(dev, gen, label, sq, sk, h, d, is_timed, dtype,
              causal):
    """One case of `flash_bwd_kernel_phase`: `flash_bwd_dq` and
    `flash_bwd_dkv` against the plain version at (Sq, Sk, H, D, dtype,
    causal), timed if `is_timed`; returns its row."""
    import torch
    from mmlspark_tpu_torch.ops import flash_attention as fa
    q, k, v, do = (torch.randn(s, h, d, device=dev,
                               generator=gen).to(dtype)
                   for s in (sq, sk, sk, sq))
    scale = 1.0 / d ** 0.5
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    dsum = (do.float() * out.float()).sum(-1).T.contiguous()
    del out
    ops = (q, k, v, do, lse, dsum)
    got = (fa.flash_bwd_dq(*ops, causal, scale),
           *fa.flash_bwd_dkv(*ops, causal, scale))
    want = fa._flash_backward_plain(*ops, causal, scale)
    torch.cuda.synchronize()
    lims = fa._bwd_limits(*ops, causal, scale, want)
    tag = (f"flash_bwd {label} Sq={sq} Sk={sk} H={h} D={d} "
           f"{str(dtype)[6:]} causal={causal}")
    used, errs = [], []
    for name, g, w, lim in zip(("dq", "dk", "dv"), got, want,
                               lims):
        if g.dtype != dtype or not bool(
                torch.isfinite(g.float()).all()):
            raise AssertionError(f"{tag}: {name} is not finite "
                                 f"{dtype}")
        used.append(_limit_used(g, w, lim))
        errs.append(float((g.float() - w.float()).abs().max()))
    if max(used) > 1:
        raise AssertionError(f"{tag}: off by {max(used):.3g} x "
                             f"the limit (dq, dk, dv: {used})")
    row = dict(case=label, sq=sq, sk=sk, h=h, d=d,
               dtype=str(dtype)[6:], causal=causal,
               max_abs_err=max(errs), limit_used=max(used),
               err_dq_dk_dv=errs, used_dq_dk_dv=used)
    msg = (f"[kernel] {tag}: match, max abs err dq/dk/dv "
           f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g}, "
           f"{used[0]:.3f}/{used[1]:.3f}/{used[2]:.3f} of the "
           f"limit")
    if label == "main":
        _bwd_check_sees_faults(ops, causal, scale, want, lims,
                               tag)
    del got, want, lims
    if is_timed:
        row["dq_ms"] = timed(lambda: fa.flash_bwd_dq(
            *ops, causal, scale), warmup=1, reps=5)
        row["dkv_ms"] = timed(lambda: fa.flash_bwd_dkv(
            *ops, causal, scale), warmup=1, reps=5)
        row["plain_ms"] = timed(lambda: fa._flash_backward_plain(
            *ops, causal, scale), warmup=1, reps=2)
        lib = _sdpa_backward_call(q, k, v, do, causal, scale)
        row["library_ms"] = timed(lib, warmup=1, reps=5)
        del lib
        for key, kernel in (("bound", "all"),
                            ("dq_bound", "dq"),
                            ("dkv_bound", "dkv")):
            row[f"{key}_ms"], row[f"{key}_by"] = _bwd_bound(
                sq, sk, h, d, dtype, causal, kernel)
        msg += (f"; dq {row['dq_ms']:.3f} ms (bound "
                f"{row['dq_bound_ms']:.4f}), dk/dv "
                f"{row['dkv_ms']:.3f} ms (bound "
                f"{row['dkv_bound_ms']:.4f}), together bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}); "
                f"plain {row['plain_ms']:.3f} ms, one SDPA "
                f"backward {row['library_ms']:.3f} ms")
        if dtype == torch.float32:
            msg += _split3_bounds(
                row, (sq, sk, h, d, dtype, causal),
                ("all", "dq", "dkv"))
    log(msg)
    del q, k, v, do, lse, dsum, ops
    torch.cuda.empty_cache()
    return row


def flash_bwd_kernel_phase(dev):
    """`flash_bwd_dq` and `flash_bwd_dkv` against `_flash_backward_plain`
    on the same CUDA tensors, dq, dk and dv per element within
    `flash_attention._BWD_TOL`; lse and dsum from `flash_fwd` (the same
    inputs to both sides). The main-path shapes timed."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(3)
    return [_bwd_case(dev, gen, *case, dtype, causal)
            for case in _flash_cases()
            for dtype in (torch.float32, torch.bfloat16)
            for causal in (False, True)]


def _split3_bounds(row, shape, kernels, offsets=(0, 0)):
    """Adds to an f32 row the bounds of `kernels` ("all", "dq", "dkv") at
    the f32 kernels' own rate, 6 bf16 tensor-core products per product
    (`_bwd_bound(split3=True)`): `split3_bound_ms` for the whole backward,
    `dq_split3_bound_ms`, `dkv_split3_bound_ms`. Returns the text that
    reports them."""
    import torch
    parts = []
    for kernel in kernels:
        key = "split3_bound_ms" if kernel == "all" \
            else f"{kernel}_split3_bound_ms"
        row[key] = _bwd_bound(*shape, kernel, *offsets, torch.float32,
                              split3=True)[0]
        parts.append(f"{kernel} {row[key]:.4f} ms")
    return ("; bounds at the split's tensor-core rate (6 bf16 products "
            "each): " + ", ".join(parts))


def _bwd_check_sees_faults(ops, causal, scale, want, lims, tag):
    """The limit of the inputs' dtype must reject the kernels' gradients on
    dO shifted by one query row (a load one row off) at most outputs of
    each; reported beside it: lse taken from the neighbouring row."""
    from mmlspark_tpu_torch.ops import flash_attention as fa
    q, k, v, do, lse, dsum = ops
    limit = f"{str(q.dtype)[6:]} limit"
    fracs = {}
    for fault, args in (("dO one row off", (q, k, v, do.roll(1, 0), lse,
                                            dsum)),
                        ("lse of the neighbouring row",
                         (q, k, v, do, lse.roll(1, 1), dsum))):
        got = (fa.flash_bwd_dq(*args, causal, scale),
               *fa.flash_bwd_dkv(*args, causal, scale))
        fracs[fault] = [float(((g.float() - w.float()).abs() > lim).float()
                              .mean()) for g, w, lim in zip(got, want, lims)]
        del got
    if min(fracs["dO one row off"]) < 0.5:
        raise AssertionError(f"{tag}: the {limit} lets dO one row off "
                             f"pass at most outputs: {fracs}")
    log(f"[kernel] {tag}: share of dq/dk/dv outside the {limit}: "
        + "; ".join(f"{f} {'/'.join(f'{x:.4f}' for x in v)}"
                    for f, v in fracs.items()))


# one ring step's (q shard, kv shard) pairs at the flagship shard shape:
# S_loc = 16384 / 4, global offsets (q_offset, k_offset, causal)
STATS_SHARD, STATS_H, STATS_D = SEQ // 4, 8, 128
STATS_PAIRS = {"diagonal": (STATS_SHARD, STATS_SHARD, True),
               "full": (3 * STATS_SHARD, 0, True),
               "masked": (0, 3 * STATS_SHARD, True),
               "noncausal": (0, 3 * STATS_SHARD, False)}


def _stats_bound(sq, sk, h, d, dtype, q_off, k_off, causal, split3=False):
    """(ms, "bytes" or "operations") of the stats form: 4 * (visible
    pairs) * D * H FLOPs over the dtype's peak (`split3`: the f32 kernel's
    own rate, `_peak_flops`), against the f32 acc, m and l written once
    and, where any pair is visible, q, k, v read once (a pair with no
    visible key has acc = 0, l = 0, m = -1e30 whatever the inputs)."""
    import torch
    pairs = _visible_pairs(sq, sk, q_off, k_off, causal)
    peak = _peak_flops(dtype, split3)
    t_ops = 4 * pairs * d * h / peak
    size = torch.tensor([], dtype=dtype).element_size()
    reads = (sq + 2 * sk) * h * d * size if pairs else 0
    t_bytes = (reads + 4 * sq * h * d + 8 * h * sq) / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        ("bytes" if t_bytes > t_ops else "operations")


def _stats_check(got, want, q, k, v, q_off, k_off, causal, scale):
    """The stats form's check. Raises unless acc and l are finite and the
    rows without a visible key (flagged by the plain version's m) are
    exactly those of the kernel's, with acc = 0, l = 0, m = -1e30. Returns,
    over the other rows, the share of the limit used (max |got - plain| /
    limit; above 1 is a miss) by m and lse = m + log l (`_LSE_TOL`) and by
    acc / l (`_FLASH_F32_TOL` in f32, the bf16 limit at the pair's
    offsets), the share of acc / l's elements outside that limit, and
    max |acc - plain|."""
    import torch
    acc, m, l = got
    w_acc, w_m, w_l = want
    if not bool(torch.isfinite(acc).all() and torch.isfinite(l).all()):
        raise AssertionError("acc or l not finite")
    flagged = w_m <= -1e29
    if not (torch.equal(m <= -1e29, flagged)
            and bool((acc[flagged.T] == 0).all())
            and bool((l[flagged] == 0).all())):
        raise AssertionError("rows without a visible key are not acc = 0, "
                             "l = 0, m = -1e30")
    live = ~flagged
    if not bool(live.any()):
        return dict(m=0.0, lse=0.0, out=0.0, out_outside=0.0, err=0.0)
    rows = live.T
    out = acc / l.clamp_min(1e-30).T[:, :, None]
    w_out = w_acc / w_l.clamp_min(1e-30).T[:, :, None]
    if q.dtype == torch.float32:
        lim = _FLASH_F32_TOL[1] + _FLASH_F32_TOL[0] * w_out.abs()
    else:
        lim = _bf16_limit(q, k, v, causal, scale, w_out, q_off, k_off)
    lse, w_lse = m + l.log(), w_m + w_l.log()
    return dict(
        m=_limit_used(m[live], w_m[live],
                      _LSE_TOL[1] + _LSE_TOL[0] * w_m[live].abs()),
        lse=_limit_used(lse[live], w_lse[live],
                        _LSE_TOL[1] + _LSE_TOL[0] * w_lse[live].abs()),
        out=_limit_used(out[rows], w_out[rows], lim[rows]),
        out_outside=float(((out - w_out).abs() > lim)[rows].float().mean()),
        err=float((acc - w_acc)[rows].abs().max()))


def _stats_sdpa(q, k, v, pair, scale):
    """The library yardstick of a pair: one SDPA call on the same q, k, v,
    causal where the pair is diagonal, full where every key is visible,
    None for a fully masked pair (nothing to compute). SDPA returns the
    normalized output, not (acc, m, l)."""
    q_off, k_off, causal = STATS_PAIRS[pair]
    if causal and q_off < k_off:
        return None
    return _sdpa_call(q, k, v, causal and q_off == k_off, scale)


def _stats_check_sees_faults(q, k, v, want, q_off, k_off, scale, tag):
    """The check must reject the kernel run with k_offset one 64-key tile
    off, both ways, on a causal pair. One tile late, the first 64 rows lose
    every key, so the flagged rows differ. One tile early, every row keeps
    a visible key and sees 64 more, so the flags agree and the value limits
    must do the work: acc / l outside its limit at most live outputs.
    Returns the report for the log line."""
    from mmlspark_tpu_torch.ops import flash_attention as fa
    late = fa.flash_stats_fwd(q, k, v, q_off, k_off + 64, True, scale)
    try:
        _stats_check(late, want, q, k, v, q_off, k_off, True, scale)
    except AssertionError:
        pass
    else:
        raise AssertionError(f"{tag}: k_offset one tile late passes the "
                             f"check")
    del late
    early = fa.flash_stats_fwd(q, k, v, q_off, k_off - 64, True, scale)
    res = _stats_check(early, want, q, k, v, q_off, k_off, True, scale)
    if res["out_outside"] < 0.5:
        raise AssertionError(f"{tag}: the acc / l limit lets k_offset one "
                             f"tile early pass at {1 - res['out_outside']:.3f}"
                             f" of the live outputs")
    return (f"; k_offset one tile late fails on the flagged rows; one tile "
            f"early puts {res['out_outside']:.4f} of acc / l outside its "
            f"limit (m / lse use {res['m']:.3g} / {res['lse']:.3g} of "
            f"theirs)")


def stats_kernel_phase(dev):
    """`flash_stats_fwd` against `_flash_stats_plain` on the same CUDA
    tensors at the flagship shard shape, every pair of a ring step, f32 and
    bf16, timed beside the plain version, SDPA and the bound; the check
    shown to reject k_offset one 64-key tile off
    (`_stats_check_sees_faults`); then a ring of four shards on the card
    against the plain attention of the whole 16,384 tokens and against
    `flash_fwd`."""
    import torch
    from mmlspark_tpu_torch.ops import flash_attention as fa
    from mmlspark_tpu_torch.parallel import data_mesh
    from mmlspark_tpu_torch.parallel.ring_attention import ring_attention
    gen = torch.Generator(device=dev).manual_seed(4)
    scale = 1.0 / STATS_D ** 0.5
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(STATS_SHARD, STATS_H, STATS_D, device=dev,
                               generator=gen).to(dtype) for _ in range(3))
        for pair, (q_off, k_off, causal) in STATS_PAIRS.items():
            got = fa.flash_stats_fwd(q, k, v, q_off, k_off, causal, scale)
            want = fa._flash_stats_plain(q, k, v, q_off, k_off, causal,
                                         scale)
            torch.cuda.synchronize()
            tag = (f"flash_stats_fwd {pair} S_loc={STATS_SHARD} "
                   f"offsets=({q_off}, {k_off}) causal={causal} "
                   f"{str(dtype)[6:]}")
            res = _stats_check(got, want, q, k, v, q_off, k_off, causal,
                               scale)
            used = {x: res[x] for x in ("m", "lse", "out")}
            if max(used.values()) > 1:
                raise AssertionError(f"{tag}: off by {max(used.values()):.3g}"
                                     f" x the limit (m, lse, acc / l: "
                                     f"{used})")
            n_flagged = int((got[1] <= -1e29).sum())
            fault = ""
            if pair == "diagonal":
                fault = _stats_check_sees_faults(q, k, v, want, q_off, k_off,
                                                 scale, tag)
            del got, want
            row = dict(pair=pair, q_off=q_off, k_off=k_off, causal=causal,
                       dtype=str(dtype)[6:], max_abs_err=res["err"],
                       limit_used=used, flagged_rows=n_flagged)
            row["ms"] = timed(lambda: fa.flash_stats_fwd(
                q, k, v, q_off, k_off, causal, scale), warmup=2, reps=10)
            row["plain_ms"] = timed(lambda: fa._flash_stats_plain(
                q, k, v, q_off, k_off, causal, scale), warmup=1, reps=3)
            lib = _stats_sdpa(q, k, v, pair, scale)
            row["library_ms"] = (timed(lib, warmup=2, reps=10)
                                 if lib is not None else None)
            del lib
            row["bound_ms"], row["bound_by"] = _stats_bound(
                STATS_SHARD, STATS_SHARD, STATS_H, STATS_D, dtype, q_off,
                k_off, causal)
            split = ""
            if dtype == torch.float32:
                row["split3_bound_ms"] = _stats_bound(
                    STATS_SHARD, STATS_SHARD, STATS_H, STATS_D, dtype,
                    q_off, k_off, causal, split3=True)[0]
                split = (f", {row['split3_bound_ms']:.4f} ms at the split's "
                         f"tensor-core rate")
            lib_s = (f"{row['library_ms']:.3f} ms"
                     if row["library_ms"] is not None else "none (no key "
                     "visible)")
            log(f"[stats kernel] {tag}: match (acc {res['err']:.3g}; m / "
                f"lse / acc / l use {used['m']:.3f} / {used['lse']:.3f} / "
                f"{used['out']:.3f} of their limits; {n_flagged} flagged "
                f"rows{fault}); kernel {row['ms']:.3f} ms, plain "
                f"{row['plain_ms']:.3f} ms, one SDPA {lib_s}, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}){split}")
            results.append(row)
        del q, k, v
        torch.cuda.empty_cache()

    # four shards merged on the card, as the ring merges them
    mesh = data_mesh(devices=[dev] * 4)
    merged = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(SEQ, STATS_H, STATS_D, device=dev,
                               generator=gen).to(dtype) for _ in range(3))
        fa.reset_launches()
        ring = ring_attention(q, k, v, mesh=mesh, causal=True,
                              block_impl="flash")
        n = fa.launches["flash_stats_fwd"]
        single = fa.flash_fwd(q, k, v, True, scale)[0]
        want = fa._flash_forward_lse_plain(q, k, v, True, scale)[0]
        torch.cuda.synchronize()
        tag = f"ring of 4 shards, S={SEQ}, causal, {str(dtype)[6:]}"
        if dtype == torch.float32:
            torch.testing.assert_close(ring, want, rtol=_FLASH_F32_TOL[0],
                                       atol=_FLASH_F32_TOL[1], msg=tag)
            used = 0.0
        else:
            used = _limit_used(ring, want, _bf16_limit(q, k, v, True, scale,
                                                       want))
            if used > 1:
                raise AssertionError(f"{tag}: off by {used:.3g} x the bf16 "
                                     f"limit")
        vs_single = float((ring.float() - single.float()).abs().max())
        if n != 16:
            raise AssertionError(f"{tag}: {n} stats launches, expected 16")
        log(f"[stats kernel] {tag}: {n} stats launches; matches the plain "
            f"attention of all {SEQ} tokens"
            + (f" ({used:.3f} of the bf16 limit)" if used else "")
            + f"; max |ring - flash_fwd| {vs_single:.3g}")
        merged[str(dtype)[6:]] = dict(vs_flash_fwd=vs_single,
                                      bf16_limit_used=used)
        del q, k, v, ring, single, want
        torch.cuda.empty_cache()
    return dict(pairs=results, merged=merged)


def stats_bwd_kernel_phase(dev):
    """`flash_bwd_dq` and `flash_bwd_dkv` at the stats pairs' offsets
    (lse := m from the stats kernel, dsum := -d_l, dO := d_acc in f32, d_acc
    and d_l seeded) against `_flash_backward_plain` at the same offsets,
    per element within `flash_attention._BWD_TOL`; the bf16 check shown
    to reject k_offset one tile off; timed beside the plain version, one
    SDPA backward and the bound."""
    import torch
    from mmlspark_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(5)
    scale = 1.0 / STATS_D ** 0.5
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(STATS_SHARD, STATS_H, STATS_D, device=dev,
                               generator=gen).to(dtype) for _ in range(3))
        d_acc = torch.randn(STATS_SHARD, STATS_H, STATS_D, device=dev,
                            generator=gen)
        dsum = -torch.randn(STATS_H, STATS_SHARD, device=dev, generator=gen)
        for pair, (q_off, k_off, causal) in STATS_PAIRS.items():
            m = fa.flash_stats_fwd(q, k, v, q_off, k_off, causal, scale)[1]
            ops = (q, k, v, d_acc, m, dsum)
            off = (q_off, k_off)
            got = (fa.flash_bwd_dq(*ops, causal, scale, *off),
                   *fa.flash_bwd_dkv(*ops, causal, scale, *off))
            want = fa._flash_backward_plain(*ops, causal, scale, *off)
            torch.cuda.synchronize()
            lims = fa._bwd_limits(*ops, causal, scale, want, *off)
            tag = (f"flash_bwd stats {pair} S_loc={STATS_SHARD} offsets="
                   f"({q_off}, {k_off}) causal={causal} {str(dtype)[6:]}")
            used, errs = [], []
            for name, g, w, lim in zip(("dq", "dk", "dv"), got, want, lims):
                if g.dtype != dtype or not bool(
                        torch.isfinite(g.float()).all()):
                    raise AssertionError(f"{tag}: {name} is not finite "
                                         f"{dtype}")
                used.append(_limit_used(g, w, lim))
                errs.append(float((g.float() - w.float()).abs().max()))
            if max(used) > 1:
                raise AssertionError(f"{tag}: off by {max(used):.3g} x the "
                                     f"limit (dq, dk, dv: {used})")
            msg = (f"[stats backward] {tag}: match, max abs err dq/dk/dv "
                   f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g}, "
                   f"{used[0]:.3f}/{used[1]:.3f}/{used[2]:.3f} of the limit")
            if pair == "diagonal" and dtype == torch.bfloat16:
                bad = (fa.flash_bwd_dq(*ops, causal, scale, q_off,
                                       k_off + 64),
                       *fa.flash_bwd_dkv(*ops, causal, scale, q_off,
                                         k_off + 64))
                over = [float(((g.float() - w.float()).abs() > lim).float()
                              .mean()) for g, w, lim in zip(bad, want, lims)]
                if min(over) == 0:
                    raise AssertionError(f"{tag}: k_offset one tile off "
                                         f"passes the check: {over}")
                msg += ("; k_offset one tile off: share outside the limit "
                        + "/".join(f"{x:.4f}" for x in over))
                del bad
            del got, want, lims
            row = dict(pair=pair, q_off=q_off, k_off=k_off, causal=causal,
                       dtype=str(dtype)[6:], max_abs_err=max(errs),
                       limit_used=max(used))
            row["dq_ms"] = timed(lambda: fa.flash_bwd_dq(
                *ops, causal, scale, *off), warmup=1, reps=5)
            row["dkv_ms"] = timed(lambda: fa.flash_bwd_dkv(
                *ops, causal, scale, *off), warmup=1, reps=5)
            row["plain_ms"] = timed(lambda: fa._flash_backward_plain(
                *ops, causal, scale, *off), warmup=1, reps=2)
            if causal and q_off < k_off:
                row["library_ms"] = None
            else:
                lib = _sdpa_backward_call(q, k, v, d_acc.to(dtype),
                                          causal and q_off == k_off, scale)
                row["library_ms"] = timed(lib, warmup=1, reps=5)
                del lib
            for kernel in ("dq", "dkv"):
                row[f"{kernel}_bound_ms"], row[f"{kernel}_bound_by"] = \
                    _bwd_bound(STATS_SHARD, STATS_SHARD, STATS_H, STATS_D,
                               dtype, causal, kernel, q_off, k_off,
                               torch.float32)
            lib_s = (f"{row['library_ms']:.3f} ms"
                     if row["library_ms"] is not None else "none")
            msg += (f"; dq {row['dq_ms']:.3f} ms (bound "
                    f"{row['dq_bound_ms']:.4f} {row['dq_bound_by']}), dk/dv "
                    f"{row['dkv_ms']:.3f} ms (bound "
                    f"{row['dkv_bound_ms']:.4f} {row['dkv_bound_by']}); "
                    f"plain {row['plain_ms']:.3f} ms, one SDPA backward "
                    f"{lib_s}")
            if dtype == torch.float32:
                msg += _split3_bounds(
                    row, (STATS_SHARD, STATS_SHARD, STATS_H, STATS_D, dtype,
                          causal), ("dq", "dkv"), off)
            log(msg)
            results.append(row)
            del ops, m
        del q, k, v, d_acc, dsum
        torch.cuda.empty_cache()
    return results


# the flagship LM training step (bench.py:1965-2009, `BENCH_MODE=lm`),
# nothing cut: one (1, 16384) sequence, bf16 compute with f32 master
# weights and Adam, remat="save_attn", flash forward and backward
LM = dict(vocab_size=32768, d_model=1024, n_heads=8, n_layers=12,
          d_ff=4096, max_len=16384)
LM_SEQ, LM_STEPS = 16384, 3
# the restored flagship LM's fourth-step loss against the original's: the
# reference's rtol 1e-6 holds for the third step, whose weights are the
# checkpoint's; the fourth's come from step 3's atomic gradient sums (the
# embedding's and the log-probabilities' backward) in a bf16 model
LM_STEP4_RTOL = 1e-4
# the S=2048 flash-vs-dense SGD check, per leaf: max |w_flash - w_dense|
# <= this x max |w_dense - w_0|. f32: the two attentions sum the same
# exact products in other orders. bf16: the flash backward rounds ds to
# bf16 before its products, the dense one's autograd keeps ds in f32, and
# the forwards round p against other maxima (a tile's running max, the
# row's max); each term is off by up to 2^-9 relative, and the
# differences pass through 12 layers. The same check at S=512 on the CPU
# (full width, plain versions) read 3.3e-5 (f32) and 1.75e-2 (bf16).
_TRAIN_TOL = {"float32": 3e-4, "bfloat16": 5e-2}
_TRAIN_CHECK_SEQ = 2048


def _lm_flops_per_step():
    """bench.py's model FLOPs (:2025-2027): forward matmuls 2 * S * L *
    (4 d^2 + 2 d d_ff) + the logits 2 * S * d * V + causal attention
    L * 2 * S^2 * d; a training step is 3x the forward (remat's recompute
    is not credited)."""
    s, n, d = LM_SEQ, LM["n_layers"], LM["d_model"]
    fwd = (2 * s * n * (4 * d * d + 2 * d * LM["d_ff"])
           + 2 * s * d * LM["vocab_size"] + n * 2 * s * s * d)
    return 3 * fwd


# the attention weights of a layer: their gradients come through the flash
# backward's dq, dk, dv (wq, wk, wv) or its output (wo)
_ATTN_LEAVES = ("layers/wq", "layers/wk", "layers/wv", "layers/wo")


def _named_leaves(tree, path=""):
    """(name, tensor) of a parameter tree (dicts and lists), in order."""
    if isinstance(tree, (dict, list)):
        items = (tree.items() if isinstance(tree, dict)
                 else enumerate(tree))
        for k, v in items:
            yield from _named_leaves(v, f"{path}/{k}" if path else str(k))
    else:
        yield path, tree


def _update_disagreement(names, start, got, ref):
    """Per leaf, max |got - ref| over max |ref - start|: (the largest, its
    leaf's name, the largest over the attention weights alone)."""
    ratios = {}
    for name, w0, wg, wr in zip(names, start, got, ref):
        step = float((wr - w0).abs().max())
        ratios[name] = float((wg - wr).abs().max()) / max(step, 1e-30)
    leaf = max(ratios, key=ratios.get)
    return ratios[leaf], leaf, max(ratios[n] for n in _ATTN_LEAVES)


def _train_update_check(dev, compute_dtype):
    """One SGD step at S=2048 with attention="flash" and with "dense" from
    the same weights: the per-leaf disagreement of the updated weights
    over the larger update (`_update_disagreement`) and both losses."""
    import torch
    from mmlspark_tpu_torch.models.dnn import PipelinedLMTrainer
    toks = np.random.default_rng(1).integers(
        0, LM["vocab_size"], size=(1, _TRAIN_CHECK_SEQ)).astype(np.int32)
    updated, losses = {}, {}
    for attention in ("flash", "dense"):
        t = PipelinedLMTrainer(n_microbatches=1, attention=attention,
                               optimizer="sgd", lr=1.0, seed=0,
                               compute_dtype=compute_dtype,
                               remat="save_attn", device=dev, **LM)
        if attention == "flash":
            names, start = zip(*((n, a.detach().clone())
                                 for n, a in _named_leaves(t.params)))
        losses[attention] = t.step(toks)
        updated[attention] = [a.detach()
                              for _, a in _named_leaves(t.params)]
        del t
    disagreement = _update_disagreement(names, start, updated["flash"],
                                        updated["dense"])
    del start, updated
    torch.cuda.empty_cache()
    return disagreement, losses


def _flagship_steps(dev, compute_dtype, profile: bool):
    """The flagship LM's training steps through `PipelinedLMTrainer` at
    `compute_dtype` (flash, remat="save_attn", Adam, one LM_SEQ-token
    sequence): one untimed step, one step with the launch counts set to 0
    just before and read just after (12 of each kernel but the stats
    form), then `run` of LM_STEPS timed steps (counts again set to 0 before
    and read after): s/step, tokens/s, peak memory, a finite falling
    loss."""
    import torch
    from mmlspark_tpu_torch.models.dnn import PipelinedLMTrainer
    from mmlspark_tpu_torch.models.dnn.pp_training import _leaves
    from mmlspark_tpu_torch.ops import flash_attention as fa

    tag = "[train]" if compute_dtype == "bfloat16" else "[train f32]"
    t0 = time.perf_counter()
    trainer = PipelinedLMTrainer(
        n_microbatches=1, attention="flash", optimizer="adam", seed=0,
        compute_dtype=compute_dtype, remat="save_attn", device=dev, **LM)
    n_params = sum(a.numel() for a in _leaves(trainer.params))
    log(f"{tag} {LM}: {n_params / 1e6:.1f}M parameters from "
        f"init_transformer(seed=0) in {time.perf_counter() - t0:.1f} s; "
        f"{compute_dtype} compute, f32 master + Adam, remat=save_attn, "
        f"flash")
    toks = np.random.default_rng(0).integers(
        0, LM["vocab_size"], size=(1, LM_SEQ)).astype(np.int32)
    t0 = time.perf_counter()
    loss1 = trainer.step(toks)                 # warm-up: cuBLAS, kernels
    log(f"{tag} step 1 (untimed): loss {loss1:.4f} in "
        f"{time.perf_counter() - t0:.2f} s")

    want_step = {k: LM["n_layers"] for k in fa.launches}
    want_step["flash_stats_fwd"] = 0       # no seq axis: no ring
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    loss2 = trainer.step(toks)
    step_s = time.perf_counter() - t0
    per_step = dict(fa.launches)
    if per_step != want_step:
        raise AssertionError(f"one {compute_dtype} training step launched "
                             f"{per_step}, expected {want_step}")
    log(f"{tag} step 2: loss {loss2:.4f} in {step_s:.3f} s; launches "
        f"{per_step}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    loss_last = trainer.run(toks, LM_STEPS)    # one host sync, at the end
    run_s = time.perf_counter() - t0
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    if launches != {k: LM_STEPS * v for k, v in want_step.items()}:
        raise AssertionError(f"run({LM_STEPS}) launched {launches}")
    s_step = run_s / LM_STEPS
    log(f"{tag} run({LM_STEPS}): {s_step:.4f} s/step = "
        f"{LM_SEQ / s_step:.4g} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB (max_memory_allocated); launches "
        f"{launches}; last loss {loss_last:.4f}")
    if not (np.isfinite([loss1, loss2, loss_last]).all()
            and loss_last < loss1):
        raise AssertionError(f"losses {loss1}, {loss2}, {loss_last}: not "
                             f"finite and falling")

    if profile:
        from torch.profiler import ProfilerActivity, profile as tprof
        with tprof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            trainer.step(toks)
            torch.cuda.synchronize()
        log(prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25))
    del trainer
    torch.cuda.empty_cache()
    return dict(launches=launches, per_step=per_step, s_step=s_step,
                tokens_per_s=LM_SEQ / s_step, peak=peak, n_params=n_params,
                losses=[loss1, loss2, loss_last])


def lm_train_phase(dev, profile: bool):
    """The LM training path at the flagship width through
    `PipelinedLMTrainer` (`_flagship_steps`, with `--profile` a
    torch.profiler table of one step each): bf16 compute, as bench.py
    trains it, with `lm_train_mfu`; then the trainer's default f32
    compute; then the S=2048 flash-vs-dense update checks."""
    res = _flagship_steps(dev, "bfloat16", profile)
    res["mfu"] = _lm_flops_per_step() / res["s_step"] / PEAK_BF16_FLOP_PER_S
    log(f"[train] lm_train_mfu {res['mfu']:.4f} (model FLOPs "
        f"{_lm_flops_per_step():.4g}/step against 989 TFLOP/s bf16)")
    res["f32"] = _flagship_steps(dev, "float32", profile)

    checks = {}
    for cdt in ("bfloat16", "float32"):
        (worst, leaf, attn), losses = _train_update_check(dev, cdt)
        log(f"[train] S={_TRAIN_CHECK_SEQ} SGD step {cdt}, flash vs dense "
            f"from the same weights: losses {losses['flash']:.6f} / "
            f"{losses['dense']:.6f}; updated weights differ by at most "
            f"{worst:.3g} of the update per leaf ({leaf}; the attention "
            f"weights alone {attn:.3g}; limit {_TRAIN_TOL[cdt]})")
        if worst > _TRAIN_TOL[cdt]:
            raise AssertionError(f"flash and dense training disagree ({cdt})")
        checks[cdt] = dict(worst=worst, leaf=leaf, attention=attn)
    return dict(res, checks=checks)


# the ring trainer: the flagship LM on the four-card context-parallel
# layout run on one card, (data, pipe, model, seq) = (1, 1, 1, 4)
RING_MESH = (1, 1, 1, 4)
# its first-step loss against the trainer without a seq axis (the same
# weights and tokens, bf16): both average 16,383 next-token losses of
# ~10.4 (ln 32768); the two attentions round p to bf16 against other
# maxima (a shard pair's tile against the whole row's tile) and the ring
# merges f32 accumulators before rounding the output, so each layer's
# output moves by bf16 ulps of random sign (~3e-3 of a logit), and the
# mean over the tokens moves by ~1e-5; 1e-3 (1e-4 of the loss) leaves room
# for a systematic part. At initialization the loss hardly depends on
# attention, so the S=2048 update checks below (f32 and bf16, the dtype
# of this run) are what hold the ring's gradients
_RING_LOSS_TOL = 1e-3


def _ring_update_check(dev, compute_dtype):
    """One SGD step at S=2048 with attention="flash" on the ring mesh and
    on a (1, 1, 1, 1) mesh from the same weights (the latter is
    the degenerate route: no stats kernel, 12 `flash_fwd`). Returns the
    per-leaf disagreement of the updated weights over the larger update
    (`_update_disagreement`), both steps' launches and losses."""
    import torch
    from mmlspark_tpu_torch.models.dnn import PipelinedLMTrainer
    from mmlspark_tpu_torch.ops import flash_attention as fa
    from mmlspark_tpu_torch.parallel import (DATA_AXIS, MODEL_AXIS,
                                             PIPE_AXIS, SEQ_AXIS, grid_mesh)
    axes = (DATA_AXIS, PIPE_AXIS, MODEL_AXIS, SEQ_AXIS)
    toks = np.random.default_rng(1).integers(
        0, LM["vocab_size"], size=(1, _TRAIN_CHECK_SEQ)).astype(np.int32)
    updated, losses, launches = {}, {}, {}
    for shape in (RING_MESH, (1, 1, 1, 1)):
        mesh = grid_mesh(shape, axes, devices=[dev] * int(np.prod(shape)))
        t = PipelinedLMTrainer(mesh=mesh, n_microbatches=1,
                               attention="flash", optimizer="sgd", lr=1.0,
                               seed=0, compute_dtype=compute_dtype,
                               remat="save_attn", **LM)
        if shape == RING_MESH:
            names, start = zip(*((n, a.detach().clone())
                                 for n, a in _named_leaves(t.params)))
        torch.cuda.synchronize()
        fa.reset_launches()
        losses[shape] = t.step(toks)
        launches[shape] = dict(fa.launches)
        updated[shape] = [a.detach() for _, a in _named_leaves(t.params)]
        del t
    disagreement = _update_disagreement(names, start, updated[RING_MESH],
                                        updated[(1, 1, 1, 1)])
    del start, updated
    torch.cuda.empty_cache()
    return disagreement, losses, launches


def ring_train_phase(dev, cp1_first_loss: float, profile: bool):
    """The LM training path on the ring mesh at the flagship width: one
    step with the launch counts set to 0 just before and read just after,
    then `run` of LM_STEPS timed steps (counts again set to 0 before and
    read after); then the S=2048 ring-vs-degenerate update checks, f32
    and bf16."""
    import torch
    from mmlspark_tpu_torch.models.dnn import PipelinedLMTrainer
    from mmlspark_tpu_torch.ops import flash_attention as fa
    from mmlspark_tpu_torch.parallel import (DATA_AXIS, MODEL_AXIS,
                                             PIPE_AXIS, SEQ_AXIS, grid_mesh)
    mesh = grid_mesh(RING_MESH, (DATA_AXIS, PIPE_AXIS, MODEL_AXIS, SEQ_AXIS),
                     devices=[dev] * int(np.prod(RING_MESH)))
    cp = RING_MESH[-1]
    trainer = PipelinedLMTrainer(
        mesh=mesh, n_microbatches=1, attention="flash", optimizer="adam",
        seed=0, compute_dtype="bfloat16", remat="save_attn", **LM)
    log(f"[ring train] {LM} on {mesh}: bf16 compute, f32 master + Adam, "
        f"remat=save_attn, flash stats blocks")
    toks = np.random.default_rng(0).integers(
        0, LM["vocab_size"], size=(1, LM_SEQ)).astype(np.int32)
    want_step = {"flash_fwd": 0, "flash_stats_fwd": LM["n_layers"] * cp * cp,
                 "flash_bwd_dq": LM["n_layers"] * cp * cp,
                 "flash_bwd_dkv": LM["n_layers"] * cp * cp}
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    loss1 = trainer.step(toks)
    step1_s = time.perf_counter() - t0
    per_step = dict(fa.launches)
    log(f"[ring train] step 1 (untimed): loss {loss1:.6f} in {step1_s:.2f} "
        f"s; launches {per_step}; the trainer without a seq axis: "
        f"{cp1_first_loss:.6f} (|diff| {abs(loss1 - cp1_first_loss):.3g}, "
        f"limit {_RING_LOSS_TOL})")
    if per_step != want_step:
        raise AssertionError(f"one ring training step launched {per_step}, "
                             f"expected {want_step}")
    if not abs(loss1 - cp1_first_loss) <= _RING_LOSS_TOL:
        raise AssertionError("the ring trainer's first loss differs from "
                             "the trainer without a seq axis")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    loss_last = trainer.run(toks, LM_STEPS)    # one host sync, at the end
    run_s = time.perf_counter() - t0
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    if launches != {k: LM_STEPS * v for k, v in want_step.items()}:
        raise AssertionError(f"run({LM_STEPS}) launched {launches}")
    s_step = run_s / LM_STEPS
    mfu = _lm_flops_per_step() / s_step / PEAK_BF16_FLOP_PER_S
    log(f"[ring train] run({LM_STEPS}): {s_step:.4f} s/step = "
        f"{LM_SEQ / s_step:.4g} tokens/s; lm_train_mfu {mfu:.4f}; peak "
        f"memory {peak / 2**30:.2f} GiB; launches {launches}; last loss "
        f"{loss_last:.4f}")
    if not (np.isfinite([loss1, loss_last]).all() and loss_last < loss1):
        raise AssertionError(f"losses {loss1}, {loss_last}: not finite and "
                             f"falling")
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprof
        with tprof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            trainer.step(toks)
            torch.cuda.synchronize()
        log(prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25))
    del trainer
    torch.cuda.empty_cache()

    checks = {}
    for cdt in ("float32", "bfloat16"):
        (worst, leaf, attn), losses, check_launches = _ring_update_check(
            dev, cdt)
        degenerate = check_launches[(1, 1, 1, 1)]
        log(f"[ring train] S={_TRAIN_CHECK_SEQ} SGD step {cdt}, mesh "
            f"{RING_MESH} vs (1, 1, 1, 1) from the same weights: losses "
            f"{losses[RING_MESH]:.6f} / {losses[(1, 1, 1, 1)]:.6f}; updated "
            f"weights differ by at most {worst:.3g} of the update per leaf "
            f"({leaf}; the attention weights alone {attn:.3g}; limit "
            f"{_TRAIN_TOL[cdt]}); launches {check_launches[RING_MESH]} / "
            f"{degenerate}")
        if worst > _TRAIN_TOL[cdt]:
            raise AssertionError(f"ring and single-shard training disagree "
                                 f"({cdt})")
        if degenerate != {"flash_fwd": LM["n_layers"], "flash_stats_fwd": 0,
                          "flash_bwd_dq": LM["n_layers"],
                          "flash_bwd_dkv": LM["n_layers"]}:
            raise AssertionError(f"the (1, 1, 1, 1) mesh launched "
                                 f"{degenerate}")
        checks[cdt] = dict(worst=worst, leaf=leaf, attention=attn)
    return dict(launches=launches, per_step=per_step, s_step=s_step,
                tokens_per_s=LM_SEQ / s_step, mfu=mfu, peak=peak,
                losses=[loss1, loss_last], cp1_first_loss=cp1_first_loss,
                checks=checks)



# ------------------------------------------------------------ [pipe train]
# slice 14: pipeline and tensor parallelism. The flagship LM on the
# four-stage, two-way Megatron layout of eight positions, run on one card:
# (data, pipe, model, seq) = (1, 4, 2, 1), 3 layers a stage, 4 heads and
# d_ff 2048 a model position; two 16,384-token sequences a step in two
# microbatches
PIPE_MESH = (1, 4, 2, 1)
# the reference's 4D composition for the S=2048 update checks: a ring over
# two 1,024-token shards inside each of two model positions of 4 heads
PIPE_4D_MESH = (1, 2, 2, 2)
PIPE_BATCH, PIPE_MICROBATCHES = 2, 2
# the check meshes' losses against the one-position trainer's, in f32 and
# bf16, as `_RING_LOSS_TOL`
_PIPE_LOSS_TOL = 1e-3
# ShardedLMTrainer on a data x model mesh against mesh=None: the
# reference's own tolerance (tests/test_lm_training.py:37-48)
SHARDED_MESH, SHARDED_STEPS = (2, 2), 3
_SHARDED_RTOL, _SHARDED_ATOL = 2e-4, 2e-5
_PIPE_AXES = ("data", "pipe", "model", "seq")


def _pipe_launches(shape, seq, n_seqs):
    """The flash launches of one step of the flagship LM on `shape`: each
    layer runs at every model position for every sequence, normalized
    without a seq axis, stats blocks over cp^2 shard pairs with one."""
    _, _, tp, cp = shape
    per = LM["n_layers"] * tp * n_seqs
    if cp == 1:
        return {"flash_fwd": per, "flash_stats_fwd": 0,
                "flash_bwd_dq": per, "flash_bwd_dkv": per}
    return {"flash_fwd": 0, "flash_stats_fwd": per * cp * cp,
            "flash_bwd_dq": per * cp * cp, "flash_bwd_dkv": per * cp * cp}


def _pipe_trainer(dev, shape, **kw):
    from mmlspark_tpu_torch.models.dnn import PipelinedLMTrainer
    from mmlspark_tpu_torch.parallel import grid_mesh
    mesh = grid_mesh(shape, _PIPE_AXES, devices=[dev] * int(np.prod(shape)))
    return PipelinedLMTrainer(mesh=mesh, n_microbatches=PIPE_MICROBATCHES,
                              attention="flash", remat="save_attn", seed=0,
                              **kw, **LM)


def _pipe_update_check(dev, compute_dtype):
    """One SGD step at S=2048 on (1, 4, 2, 1), (1, 2, 2, 2) and (1, 1, 1, 1)
    from the same weights, tokens (2, 2048) in two microbatches: per mesh
    its launches, loss and the per-leaf disagreement of its updated
    weights with the one-position trainer's (`_update_disagreement`)."""
    import torch
    from mmlspark_tpu_torch.ops import flash_attention as fa
    toks = np.random.default_rng(1).integers(
        0, LM["vocab_size"], size=(PIPE_BATCH, _TRAIN_CHECK_SEQ)).astype(
        np.int32)
    one = (1, 1, 1, 1)
    updated, losses, launches = {}, {}, {}
    for shape in (one, PIPE_MESH, PIPE_4D_MESH):
        t = _pipe_trainer(dev, shape, optimizer="sgd", lr=1.0,
                          compute_dtype=compute_dtype)
        if shape == one:
            names, start = zip(*((n, a.detach().clone())
                                 for n, a in _named_leaves(t.params)))
        torch.cuda.synchronize()
        fa.reset_launches()
        losses[shape] = t.step(toks)
        launches[shape] = dict(fa.launches)
        updated[shape] = [a.detach().clone()
                          for _, a in _named_leaves(t.params)]
        del t
        torch.cuda.empty_cache()
    out = {shape: _update_disagreement(names, start, updated[shape],
                                       updated[one])
           for shape in (PIPE_MESH, PIPE_4D_MESH)}
    del start, updated
    torch.cuda.empty_cache()
    return out, losses, launches


def _sharded_check(dev):
    """ShardedLMTrainer at the flagship width, f32, on a (2, 2) data x
    model mesh of one card and with mesh=None from the same seed:
    SHARDED_STEPS Adam steps on tokens (2, 2048). Dense attention: no
    kernel launches."""
    import torch
    from mmlspark_tpu_torch.models.dnn import ShardedLMTrainer
    from mmlspark_tpu_torch.ops import flash_attention as fa
    from mmlspark_tpu_torch.parallel import grid_mesh
    toks = np.random.default_rng(2).integers(
        0, LM["vocab_size"], size=(2, _TRAIN_CHECK_SEQ)).astype(np.int32)
    losses, seconds = {}, {}
    for name, mesh in (("mesh", grid_mesh(SHARDED_MESH,
                                          devices=[dev] * 4)),
                       ("none", None)):
        t = ShardedLMTrainer(mesh=mesh, seed=0,
                             device=None if mesh else dev, **LM)
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        losses[name] = [t.step(toks) for _ in range(SHARDED_STEPS)]
        seconds[name] = (time.perf_counter() - t0) / SHARDED_STEPS
        if any(fa.launches.values()):
            raise AssertionError(f"ShardedLMTrainer launched {fa.launches}")
        del t
        torch.cuda.empty_cache()
    return losses, seconds


def pipe_train_phase(dev, train):
    """The LM training path on pipe and model axes at the flagship width:
    the flash kernels at the model position's 4 heads against their plain
    versions; one step of the flagship LM on PIPE_MESH with the launch
    counts set to 0 just before and read just after, then `run` of
    LM_STEPS timed steps (counts again set to 0 before and read after),
    beside `train`, the one-position [train] result; the S=2048 update
    checks of PIPE_MESH and PIPE_4D_MESH against (1, 1, 1, 1) in f32 and
    bf16; ShardedLMTrainer on a data x model mesh against mesh=None."""
    import torch
    from mmlspark_tpu_torch.ops import flash_attention as fa

    h_loc = LM["n_heads"] // PIPE_MESH[2]
    d = LM["d_model"] // LM["n_heads"]
    gen = torch.Generator(device=dev).manual_seed(14)
    kernels = {"fwd": _fwd_case(dev, gen, "h4", LM_SEQ, LM_SEQ, h_loc, d,
                                True, torch.bfloat16, True),
               "bwd": _bwd_case(dev, gen, "h4", LM_SEQ, LM_SEQ, h_loc, d,
                                True, torch.bfloat16, True)}

    trainer = _pipe_trainer(dev, PIPE_MESH, optimizer="adam",
                            compute_dtype="bfloat16")
    log(f"[pipe train] {LM} on {trainer.mesh}: {PIPE_MICROBATCHES} "
        f"microbatches of {PIPE_BATCH // PIPE_MICROBATCHES} x {LM_SEQ} "
        f"tokens, {LM['n_layers'] // PIPE_MESH[1]} layers a stage, "
        f"{h_loc} heads a model position; bf16 compute, f32 master + "
        f"Adam, remat=save_attn, flash")
    toks = np.random.default_rng(0).integers(
        0, LM["vocab_size"], size=(PIPE_BATCH, LM_SEQ)).astype(np.int32)
    want_step = _pipe_launches(PIPE_MESH, LM_SEQ, PIPE_BATCH)
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    loss1 = trainer.step(toks)
    step1_s = time.perf_counter() - t0
    per_step = dict(fa.launches)
    log(f"[pipe train] step 1 (untimed): loss {loss1:.6f} in "
        f"{step1_s:.2f} s; launches {per_step}")
    if per_step != want_step:
        raise AssertionError(f"one pipe training step launched {per_step}, "
                             f"expected {want_step}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    loss_last = trainer.run(toks, LM_STEPS)    # one host sync, at the end
    run_s = time.perf_counter() - t0
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    if launches != {k: LM_STEPS * v for k, v in want_step.items()}:
        raise AssertionError(f"run({LM_STEPS}) launched {launches}")
    s_step = run_s / LM_STEPS
    tokens = PIPE_BATCH * LM_SEQ
    flops = PIPE_BATCH * _lm_flops_per_step()
    mfu = flops / s_step / PEAK_BF16_FLOP_PER_S
    log(f"[pipe train] run({LM_STEPS}): {s_step:.4f} s/step = "
        f"{tokens / s_step:.4g} tokens/s; lm_train_mfu {mfu:.4f} (model "
        f"FLOPs {flops:.4g}/step); peak memory {peak / 2**30:.2f} GiB; "
        f"launches {launches}; losses {loss1:.4f} -> {loss_last:.4f}; "
        f"[train] one position, {LM_SEQ} tokens: {train['s_step']:.4f} "
        f"s/step, {train['tokens_per_s']:.4g} tokens/s, peak "
        f"{train['peak'] / 2**30:.2f} GiB")
    if not (np.isfinite([loss1, loss_last]).all() and loss_last < loss1):
        raise AssertionError(f"losses {loss1}, {loss_last}: not finite and "
                             f"falling")
    del trainer
    torch.cuda.empty_cache()

    checks = {}
    one = (1, 1, 1, 1)
    for cdt in ("float32", "bfloat16"):
        worst, losses, check_launches = _pipe_update_check(dev, cdt)
        for shape, (w, leaf, attn) in worst.items():
            log(f"[pipe train] S={_TRAIN_CHECK_SEQ} SGD step {cdt}, mesh "
                f"{shape} vs {one} from the same weights: losses "
                f"{losses[shape]:.6f} / {losses[one]:.6f}; updated weights "
                f"differ by at most {w:.3g} of the update per leaf ({leaf};"
                f" the attention weights alone {attn:.3g}; limit "
                f"{_TRAIN_TOL[cdt]}); launches {check_launches[shape]}")
            if w > _TRAIN_TOL[cdt]:
                raise AssertionError(f"mesh {shape} and one-position "
                                     f"training disagree ({cdt})")
            if not abs(losses[shape] - losses[one]) <= _PIPE_LOSS_TOL:
                raise AssertionError(f"mesh {shape}'s loss differs from "
                                     f"the one-position trainer's ({cdt})")
            checks[f"{cdt} {shape}"] = dict(worst=w, leaf=leaf,
                                            attention=attn,
                                            loss=losses[shape],
                                            one_loss=losses[one])
        for shape in (one, PIPE_MESH, PIPE_4D_MESH):
            want = _pipe_launches(shape, _TRAIN_CHECK_SEQ, PIPE_BATCH)
            if check_launches[shape] != want:
                raise AssertionError(f"mesh {shape} launched "
                                     f"{check_launches[shape]}, expected "
                                     f"{want}")

    sharded, sharded_s = _sharded_check(dev)
    rel = max(abs(a - b) / abs(b) for a, b in zip(sharded["mesh"],
                                                   sharded["none"]))
    log(f"[pipe train] ShardedLMTrainer f32 on a {SHARDED_MESH} data x "
        f"model mesh: losses {', '.join(f'{x:.6f}' for x in sharded['mesh'])}"
        f" ({sharded_s['mesh']:.3f} s/step); mesh=None "
        f"{', '.join(f'{x:.6f}' for x in sharded['none'])} "
        f"({sharded_s['none']:.3f} s/step); largest relative difference "
        f"{rel:.3g} (rtol {_SHARDED_RTOL}, atol {_SHARDED_ATOL})")
    np.testing.assert_allclose(sharded["mesh"], sharded["none"],
                               rtol=_SHARDED_RTOL, atol=_SHARDED_ATOL)
    if not sharded["mesh"][-1] < sharded["mesh"][0]:
        raise AssertionError(f"ShardedLMTrainer's losses {sharded['mesh']} "
                             f"do not fall")
    return dict(launches=launches, per_step=per_step, s_step=s_step,
                tokens_per_s=tokens / s_step, mfu=mfu, peak=peak,
                losses=[loss1, loss_last], checks=checks, kernels=kernels,
                sharded=dict(losses=sharded, s_step=sharded_s, rel=rel))

# parent against change in one call: the f32 forward at the main shape,
# the f32 encode_long, the f32 LM step, the headline fit and the planes
# fit, each tree in its own process, in the order parent, change, change,
# parent
# ------------------------------------------------------------ [resume]
# slice 12: checkpoint/resume on the card. The fixed-order kernels'
# cases (kind, n, F, B, m): the headline's levels (8M x 32, 64 bins), the
# ranker's widest level (2,270,296 x 137, 256 bins, m = 64), the deep
# fit's split levels (m = 128 at B = 256, m = 512), the leaf sums (one
# feature, one bin, a node per heap node of a depth-5 tree) and the planes
# form at the [planes] phase's levels
FIXED_CASES = ([("tiled", N_ROWS, N_FEAT, 64, m) for m in (1, 2, 4, 8)]
               + [("tiled", LTR_ROWS, LTR_FEAT, 256, 64),
                  ("tiled", N_ROWS, N_FEAT, 256, 128),
                  ("tiled", N_ROWS, N_FEAT, 64, 512),
                  ("leaf", N_ROWS, 1, 1, 2 ** (DEPTH + 1) - 1)]
               + [("planes", N_ROWS, N_FEAT, b, m) for m, b in PLANES_CASES])
# the checkpointed fits: the headline's with bagging 0.8/1 and
# feature_fraction 0.8 (so the draws must line up across a resume) and a
# checkpoint every 3 iterations
RESUME_INTERVAL = 3
RESUME_PARAMS = dict(num_iterations=N_ITERS, max_depth=DEPTH, num_leaves=31,
                     max_bin=MAX_BIN, min_data_in_leaf=20,
                     bagging_fraction=0.8, bagging_freq=1,
                     feature_fraction=0.8,
                     checkpoint_interval=RESUME_INTERVAL)
# a subprocess fit that SIGTERMs itself right after its second periodic
# checkpoint (phase "kill") or resumes from the directory (phase
# "resume"); it writes the booster and its margins
_RESUME_PROC = """
import json, os, signal, sys
import numpy as np
import torch
sys.path.insert(0, {here!r})
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.models.gbdt import GBDTClassifier
from mmlspark_tpu_torch.utils.checkpoint import CheckpointManager

phase, xfile, yfile, ckdir, params, device, out = sys.argv[1:8]
if phase == "kill":
    orig = CheckpointManager.save
    def save(self, step, payload, prune_newer=False):
        orig(self, step, payload, prune_newer=prune_newer)
        if step >= 2 * {interval} and not payload.get("final"):
            os.kill(os.getpid(), signal.SIGTERM)
    CheckpointManager.save = save
x, y = np.load(xfile, mmap_mode="r"), np.load(yfile)
model = GBDTClassifier(checkpoint_dir=ckdir, checkpoint_async=False,
                       device=device, **json.loads(params)).fit(
    Table({{"features": x, "label": y}}))
raw = model.booster.raw_score(x, model._init_score, device=device)
np.savez(out, raw=raw, booster=model.booster.save_model_string())
"""


def _fixed_inputs(gen, dev, kind, n, f, b, m):
    """`_hist_inputs`, with the leaf sums' layout for kind "leaf": every
    row active at its heap node, one zero bin column."""
    import torch
    inputs = _hist_inputs(gen, dev, n, f, b, m)
    if kind != "leaf":
        return inputs
    node = torch.randint(0, m, (n,), dtype=torch.int32, device=dev,
                         generator=gen)
    return (inputs[0], inputs[1], inputs[2], node, node >= 0, inputs[5])


def fixed_kernel_phase(dev):
    """Each fixed-order kernel (`hist_tiled_fixed`, `hist_planes_fixed`)
    at every case of `FIXED_CASES`: two launches equal bit for bit
    (`torch.equal`), with and without count_w; counts exact and grad/hess
    within `_check_hist`'s limits of the plain version (`_torch_hist`,
    `_torch_hist_planes`); times beside the atomic kernel on the same
    inputs, the plain version, one `index_add_` and the bound; the plan
    and the scratch (the int64 sums)."""
    import torch
    from mmlspark_tpu_torch.ops import histogram as hist
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    gen = torch.Generator(device=dev).manual_seed(12)
    results = []
    for kind, n, f, b, m in FIXED_CASES:
        inputs = _fixed_inputs(gen, dev, kind, n, f, b, m)
        bins, grad, hess, node, active, cw = inputs
        kw, lo = {}, 0
        if kind == "planes":
            lo = hist.plan_lo_bins(b)
            kw = dict(lo_planes=hist.build_hist_plan(bins, b), plane_lo=lo)
            fixed, atomic = hc.hist_planes_fixed, hc.hist_planes
            plain = hist._torch_hist_planes
            plan = hc.plan_planes(n, f, m, b, lo, *hc._card(0))
            abs_grad = hist._torch_hist(bins, _bf16(grad).abs(), hess, node,
                                        active, m, b)[0]
        else:
            fixed, atomic, plain = (hc.hist_tiled_fixed, hc.hist_tiled,
                                    hist._torch_hist)
            plan = hc.plan_tiles(n, f, m, b, *hc._card(0), fixed=True)
            abs_grad = hist._torch_hist(bins, grad.abs(), hess, node, active,
                                        m, b)[0]
        err = 0.0
        for w in (None, cw):
            label = f"{fixed.__name__} {kind} n={n} F={f} B={b} m={m} " \
                f"count_w {'set' if w is not None else 'None'}"
            got = fixed(*inputs[:5], m, b, count_w=w, **kw)
            again = fixed(*inputs[:5], m, b, count_w=w, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{label}: two launches differ")
            want = plain(*inputs[:5], m, b, count_w=w, **kw)
            err = max(err, _check_hist(got, want, abs_grad, label))
            del got, again, want
        del abs_grad
        ms = timed(lambda: fixed(*inputs[:5], m, b, **kw))
        atomic_ms = timed(lambda: atomic(*inputs[:5], m, b, **kw))
        plain_ms = timed(lambda: plain(*inputs[:5], m, b, **kw), warmup=1,
                         reps=3)
        if kind == "planes":
            lib = _index_add_call(bins, _bf16(grad), _bf16(hess), node,
                                  active, torch.ones_like(cw), m, b)
        else:
            lib = _index_add_call(*inputs[:5], torch.ones_like(cw), m, b)
        library_ms = timed(lib, warmup=1, reps=5)
        del lib
        n_active = int(active.sum())
        bound_ms, bound_by = (
            _planes_bound(n, n_active, f, b, m, lo, with_count=False)
            if kind == "planes" else
            _bound(n, n_active, f, b, m, with_count=False))
        scratch = hc.fixed_scratch_bytes(m, f, b)
        log(f"[resume] {fixed.__name__} {kind} n={n} F={f} B={b} m={m}: "
            f"two launches equal, match with and without count_w (counts "
            f"exact, max abs err {err:.3g}); kernel {ms:.3f} ms, atomic "
            f"{atomic.__name__} {atomic_ms:.3f} ms ({ms / atomic_ms:.2f}x), "
            f"plain {plain_ms:.3f} ms, one index_add_ {library_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}); scratch {scratch} B; "
            f"{plan}")
        results.append(dict(
            kernel=fixed.__name__, kind=kind, n=n, f=f, b=b, m=m, lo=lo,
            max_abs_err=err, ms=ms, atomic_ms=atomic_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            scratch_bytes=scratch, plan=plan._asdict()))
        del inputs, bins, grad, hess, node, active, cw, kw
        torch.cuda.empty_cache()
    return results


def _cumsum_repeats(dev):
    """Whether `torch.cumsum` along the last axis of the split search's
    (m, F, B) lattices gave one result over repeated calls on this card:
    the fixed-order fit takes it as it is (`trainer` module docstring).
    Returns the number of (shape, call) pairs that differed from the
    first call."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(5)
    differ = 0
    for shape in ((16, N_FEAT, 64), (64, LTR_FEAT, 256), (16, 40, 64)):
        x = torch.randn(shape, device=dev, generator=gen)
        first = torch.cumsum(x, dim=-1)
        differ += sum(not torch.equal(first, torch.cumsum(x, dim=-1))
                      for _ in range(50))
    return differ


def _ckpt_fit(x, y, ckdir, dev, **kw):
    """A checkpointed `GBDTClassifier` fit on `dev` (periodic writes in
    the background, as by default); returns (model, s)."""
    import torch
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.models.gbdt import GBDTClassifier
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = GBDTClassifier(checkpoint_dir=ckdir, device=str(dev),
                           **{**RESUME_PARAMS, **kw}).fit(
        Table({"features": x, "label": y}))
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def _same_fit(a_raw, a_booster, b_raw, b_booster, what):
    """Margins, split features, thresholds and leaf values equal bit for
    bit, or fail naming `what`."""
    if not np.array_equal(a_raw, b_raw):
        raise AssertionError(f"{what}: margins differ at "
                             f"{int((a_raw != b_raw).sum())} rows")
    for field in ("split_feature", "threshold", "leaf_value"):
        if not np.array_equal(getattr(a_booster, field),
                              getattr(b_booster, field)):
            raise AssertionError(f"{what}: {field} differs")


# the histogram launches of one checkpointed fit on each route: a tree's
# five levels and its leaf sums, the planes route's three shallowest
# levels (m = 1, 1, 2, 4) through the planes form
_RESUME_LAUNCHES = {
    "default": dict(hist_tiled_fixed=N_ITERS * (DEPTH + 1)),
    "planes": dict(hist_planes_fixed=N_ITERS * 4,
                   hist_tiled_fixed=N_ITERS * 2),
    "categorical": dict(hist_tiled_fixed=N_ITERS * (DEPTH + 1))}


def _resume_route(dev, tmp, route, x, y, xfile, yfile, **kw):
    """The resume contract on one route (`route`: a key of
    `_RESUME_LAUNCHES`; MMLSPARK_TPU_HIST is set by the caller): two
    uninterrupted checkpointed fits (the first with the launch counts set
    to 0 just before and read just after), a fit of 6 iterations resumed
    to 10, and a subprocess SIGTERMed after its second periodic checkpoint
    and resumed in a fresh process, all equal bit for bit. Returns the
    seconds and the launches."""
    from mmlspark_tpu_torch.models.gbdt import Booster
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    from mmlspark_tpu_torch.utils.checkpoint import CheckpointManager
    d = os.path.join(tmp, route)
    hc.reset_launches()
    fits = [_ckpt_fit(x, y, os.path.join(d, "full0"), dev, **kw)]
    launches = {k: v for k, v in hc.launches.items() if v}
    if launches != _RESUME_LAUNCHES[route]:
        raise AssertionError(f"{route}: a checkpointed fit launched "
                             f"{launches}, expected "
                             f"{_RESUME_LAUNCHES[route]}")
    fits.append(_ckpt_fit(x, y, os.path.join(d, "full1"), dev, **kw))
    raws = [m.booster.raw_score(x, m._init_score, device=dev)
            for m, _ in fits]
    _same_fit(raws[0], fits[0][0].booster, raws[1], fits[1][0].booster,
              f"{route}: two uninterrupted checkpointed fits")
    ck6 = os.path.join(d, "six")
    _ckpt_fit(x, y, ck6, dev, num_iterations=6, **kw)
    resumed, resume_s = _ckpt_fit(x, y, ck6, dev, **kw)
    if resumed.booster.n_trees != N_ITERS:
        raise AssertionError(f"{route}: the resumed fit has "
                             f"{resumed.booster.n_trees} trees")
    _same_fit(raws[0], fits[0][0].booster,
              resumed.booster.raw_score(x, resumed._init_score, device=dev),
              resumed.booster, f"{route}: 6 -> {N_ITERS} resume")

    script = os.path.join(d, "fit.py")
    with open(script, "w") as fh:
        fh.write(_RESUME_PROC.format(here=HERE, interval=RESUME_INTERVAL))
    params = json.dumps({k: list(v) if isinstance(v, tuple) else v
                         for k, v in {**RESUME_PARAMS, **kw}.items()})
    ck = os.path.join(d, "killed")
    procs = {}
    for phase in ("kill", "resume"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, script, phase, xfile, yfile, ck, params,
             str(dev), os.path.join(d, f"{phase}.npz")],
            capture_output=True, text=True, timeout=600)
        procs[phase] = (proc.returncode, time.perf_counter() - t0)
        if phase == "kill":
            steps = CheckpointManager(ck).all_steps()
            if proc.returncode != -signal.SIGTERM or \
                    steps != [RESUME_INTERVAL, 2 * RESUME_INTERVAL]:
                raise AssertionError(
                    f"{route}: the killed fit exited {proc.returncode} with "
                    f"steps {steps}: {proc.stderr[-2000:]}")
        elif proc.returncode != 0:
            raise AssertionError(f"{route}: the resumed process failed: "
                                 f"{proc.stderr[-2000:]}")
    out = np.load(os.path.join(d, "resume.npz"))
    _same_fit(raws[0], fits[0][0].booster, out["raw"],
              Booster.load_model_string(str(out["booster"])),
              f"{route}: SIGTERM kill and resume in a fresh process")
    fit_s = [s for _, s in fits]
    log(f"[resume] {route}: two uninterrupted checkpointed GBDTClassifier "
        f"fits ({', '.join(f'{t:.3f}' for t in fit_s)} s, binning "
        f"included), the 6 -> {N_ITERS} resume ({resume_s:.3f} s) and the "
        f"SIGTERM kill (exit {procs['kill'][0]}, {procs['kill'][1]:.1f} s, "
        f"steps {RESUME_INTERVAL} and {2 * RESUME_INTERVAL} on disk) and "
        f"resume in a fresh process ({procs['resume'][1]:.1f} s): margins, "
        f"split_feature, threshold and leaf_value equal bit for bit; "
        f"launches {launches} a fit")
    return dict(fit_s=fit_s, resume_s=resume_s, launches=launches,
                proc_s={k: v[1] for k, v in procs.items()})


def _checkpointed_fit_cost(dev, data, tmp, default_times):
    """The checkpointed headline fit against the default one, both
    `prebinned` with `fit_booster`, FIT_REPEATS each in this run: with a
    checkpoint callback that writes every RESUME_INTERVAL iterations
    (`CheckpointManager.save` on this thread: the booster and the 32 MB
    margin), and with one that writes nothing (fixed order alone). Counts
    set to 0 just before a counted checkpointed fit and read just after.
    Train logloss/AUC of the checkpointed fit within `_METRIC_TOL` of the
    default fit's. Returns the numbers."""
    import shutil as _shutil

    import torch
    from mmlspark_tpu_torch.models.gbdt import BoostParams, fit_booster
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    from mmlspark_tpu_torch.utils.checkpoint import CheckpointManager
    x, y, staged, d_y = data["x"], data["y"], data["staged"], data["d_y"]
    params = BoostParams(objective="binary", **{
        k: v for k, v in RESUME_PARAMS.items() if k != "checkpoint_interval"})
    saves = []

    def write(ckdir):
        mgr = CheckpointManager(ckdir)

        def ck(it, booster, base, final=False, margin=None, rng_key=None):
            t0 = time.perf_counter()
            mgr.save(it, {"booster": booster.save_model_string(),
                          "iteration": it, "base": float(base),
                          "final": bool(final), "margin": margin})
            saves.append((time.perf_counter() - t0, sum(
                os.path.getsize(os.path.join(mgr._step_dir(it), fn))
                for fn in os.listdir(mgr._step_dir(it)))))
        return ck

    def fit(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fit_booster(x, y, params, prebinned=staged, device=dev,
                          checkpoint_interval=RESUME_INTERVAL, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def nothing(*a, **k):
        return None
    default = [fit()[1] for _ in range(FIT_REPEATS)]
    fixed_only = [fit(checkpoint_fn=nothing)[1] for _ in range(FIT_REPEATS)]
    written = []
    for i in range(FIT_REPEATS):
        ckdir = os.path.join(tmp, f"cost{i}")
        written.append(fit(checkpoint_fn=write(ckdir))[1])
        _shutil.rmtree(ckdir)
    torch.cuda.synchronize()
    hc.reset_launches()
    (booster, base, _), _ = fit(checkpoint_fn=nothing)
    torch.cuda.synchronize()
    launches = {k: v for k, v in hc.launches.items() if v}
    want = dict(hist_tiled_fixed=N_ITERS * (DEPTH + 1))
    if launches != want:
        raise AssertionError(f"checkpointed fit launched {launches}, "
                             f"expected {want}")
    (ref, ref_base, _), _ = fit()
    got_m = booster.raw_score_device(x, device=dev)[:, 0] + base
    ref_m = ref.raw_score_device(x, device=dev)[:, 0] + ref_base
    (ll, auc), (ref_ll, ref_auc) = _metrics(got_m, d_y), _metrics(ref_m, d_y)
    if abs(ll - ref_ll) > _METRIC_TOL or abs(auc - ref_auc) > _METRIC_TOL:
        raise AssertionError(f"checkpointed fit logloss/AUC {ll}/{auc} "
                             f"against the default fit's {ref_ll}/{ref_auc}")
    med = {k: float(np.median(v)) for k, v in (
        ("default", default), ("fixed_only", fixed_only),
        ("written", written))}
    save_s = float(np.median([t for t, _ in saves]))
    save_bytes = int(np.median([nb for _, nb in saves]))
    log(f"[resume] headline fit (prebinned, bagging 0.8/1, "
        f"feature_fraction 0.8), {FIT_REPEATS} each: default "
        f"{', '.join(f'{t:.4f}' for t in default)} s (median "
        f"{med['default']:.4f}; [main]'s unbagged median "
        f"{float(np.median(default_times)):.4f}); fixed order, no write "
        f"{', '.join(f'{t:.4f}' for t in fixed_only)} s (median "
        f"{med['fixed_only']:.4f}, {med['fixed_only'] / med['default']:.3f}x"
        f"); checkpointed every {RESUME_INTERVAL} "
        f"{', '.join(f'{t:.4f}' for t in written)} s (median "
        f"{med['written']:.4f}, {med['written'] / med['default']:.3f}x); "
        f"a save {save_s:.4f} s, {save_bytes} bytes (median of "
        f"{len(saves)}); launches {launches} a fit; logloss {ll:.6f} / "
        f"{ref_ll:.6f}, AUC {auc:.6f} / {ref_auc:.6f} (checkpointed / "
        f"default)")
    return dict(medians=med, default=default, fixed_only=fixed_only,
                written=written, save_s=save_s, save_bytes=save_bytes,
                launches=launches, logloss=(ll, ref_ll), auc=(auc, ref_auc))


def _lm_resume(dev, tmp):
    """The flagship bf16 LM (`PipelinedLMTrainer`, flash, remat=
    "save_attn", Adam): two steps, `save_checkpoint`, a third and a
    fourth step; a trainer of another seed restores: its parameters and
    Adam's state (step count, exp_avg, exp_avg_sq) equal the saved ones
    bit for bit, its third-step loss equals the original's within rtol
    1e-6 (the reference's) and its fourth within `LM_STEP4_RTOL`: step 3
    adds the embedding's and the log-probabilities' gradients with
    atomics, as every step does, so step 4 starts from weights that may
    differ in their last bits."""
    import torch
    from mmlspark_tpu_torch.models.dnn import PipelinedLMTrainer
    from mmlspark_tpu_torch.models.dnn.lm_training import _adam_leaves
    from mmlspark_tpu_torch.models.dnn.transformer import _flatten

    def adam_state(t):
        return [torch.as_tensor(x).clone() for x in _adam_leaves(t.params,
                                                                  t._opt)]

    def trainer(seed):
        return PipelinedLMTrainer(
            n_microbatches=1, attention="flash", optimizer="adam", seed=seed,
            compute_dtype="bfloat16", remat="save_attn", device=dev, **LM)
    toks = np.random.default_rng(0).integers(
        0, LM["vocab_size"], size=(1, LM_SEQ)).astype(np.int32)
    ckdir = os.path.join(tmp, "lm")
    a = trainer(0)
    a.step(toks)
    a.step(toks)
    saved = [t.detach().clone() for t in _flatten(a.params)]
    saved_opt = adam_state(a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.save_checkpoint(ckdir, 2)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(r, fn))
                 for r, _, fns in os.walk(ckdir) for fn in fns)
    want = [a.step(toks), a.step(toks)]
    del a
    torch.cuda.empty_cache()
    b = trainer(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = b.restore_checkpoint(ckdir)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same = all(torch.equal(x, y) for x, y in zip(_flatten(b.params), saved))
    got_opt = adam_state(b)
    same_opt = (len(got_opt) == len(saved_opt) == 1 + 2 * len(saved)
                and all(torch.equal(x, y) for x, y in zip(got_opt, saved_opt)))
    del saved, saved_opt, got_opt
    got = [b.step(toks), b.step(toks)]
    del b
    torch.cuda.empty_cache()
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    log(f"[resume] flagship LM bf16 ({LM_SEQ} tokens): save_checkpoint "
        f"{save_s:.2f} s, {nbytes} bytes; restore into a trainer of seed 1 "
        f"{restore_s:.2f} s (step {step}), parameters equal to the saved "
        f"ones: {same}, Adam's state: {same_opt}; step 3 loss {got[0]:.7f} against {want[0]:.7f} "
        f"(relative {rel[0]:.3g}); step 4 {got[1]:.7f} against "
        f"{want[1]:.7f} (relative {rel[1]:.3g}, the atomic gradient sums "
        f"of step 3 between them)")
    if (step != 2 or not same or not same_opt or not rel[0] <= 1e-6
            or not rel[1] <= LM_STEP4_RTOL):
        raise AssertionError("the flagship LM did not resume from its "
                             "checkpoint")
    return dict(save_s=save_s, restore_s=restore_s, bytes=nbytes,
                losses=want, resumed_losses=got, rel=rel,
                same_params=same, same_adam=same_opt)


def resume_phase(dev, data, default_times):
    """[resume]: the fixed-order kernels, then the GBDT resume contract on
    the default route, the planes route and the categorical data, the
    checkpointed fit's cost, and the flagship LM's save and restore; all
    checkpoints in a temporary directory, deleted after."""
    import tempfile

    import torch
    kernels = fixed_kernel_phase(dev)
    differ = _cumsum_repeats(dev)
    log(f"[resume] torch.cumsum over (m, F, B) lattices, 50 repeats of 3 "
        f"shapes: {differ} differed from the first call")
    if differ:
        raise AssertionError("torch.cumsum did not repeat itself on the "
                             "split search's lattices")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as tmp:
        cost = _checkpointed_fit_cost(dev, data, tmp, default_times)
        routes = {}
        cat = categorical_data(dev, data)
        for route, dset, kw in (("default", data, {}),
                                ("planes", data, {}),
                                ("categorical", cat, dict(
                                    categorical_slot_indexes=CAT_COLS))):
            xfile = os.path.join(tmp, f"{route}_x.npy")
            yfile = os.path.join(tmp, f"{route}_y.npy")
            np.save(xfile, dset["x"])
            np.save(yfile, dset["y"])
            ctx = (env("MMLSPARK_TPU_HIST", "planes") if route == "planes"
                   else contextlib.nullcontext())
            with ctx:
                routes[route] = _resume_route(dev, tmp, route, dset["x"],
                                              dset["y"], xfile, yfile, **kw)
            os.remove(xfile)
            torch.cuda.empty_cache()
        del cat
        torch.cuda.empty_cache()
        lm = _lm_resume(dev, tmp)
    return dict(kernels=kernels, cumsum_differ=differ, cost=cost,
                routes=routes, lm=lm)


# ------------------------------------------------------------ [introspect]
# slice 13: Booster introspection on the card. Leaf indices of this many
# rows against the host descent; device TreeSHAP against the float64 host
# oracle on SHAP_ORACLE_ROWS rows (the reference's limit,
# tests/test_shap_device.py:28) and local accuracy on SHAP_ROWS rows
INTROSPECT_ROWS = 1 << 20
SHAP_ORACLE_ROWS = 2048
SHAP_ROWS = 65536
_SHAP_ATOL = 1e-4
_LEAF_SUM_ATOL = 1e-5


def _introspect_one(tag, booster, base, x, dev, tmp):
    """[introspect] on one fitted booster: leaf indices on the card
    against the host descent, their leaf values against raw_score, device
    TreeSHAP against the host oracle and summing to the raw score plus the
    init score, split importances against the node count, a native model
    file round trip and a model's transform with both new columns."""
    import torch
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.models.gbdt import load_native_model
    from mmlspark_tpu_torch.models.gbdt.estimators import (
        GBDTClassificationModel)
    from mmlspark_tpu_torch.models.gbdt.shap_device import (
        shap_contributions_device)

    n = INTROSPECT_ROWS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    leaves = booster.predict_leaf_device(x[:n], device=dev)
    torch.cuda.synchronize()
    leaf_s = time.perf_counter() - t0
    leaves = leaves.cpu().numpy()
    host = booster.predict_leaf(x[:n], backend="host")
    if leaves.shape != (n, booster.n_trees) or not np.array_equal(leaves,
                                                                  host):
        raise AssertionError(f"{tag}: device leaf indices differ from the "
                             f"host descent")
    lv_sum = booster.leaf_value[np.arange(booster.n_trees)[None, :],
                                leaves].sum(1, dtype=np.float64)
    raw = booster.raw_score(x[:n], device=dev)[:, 0]
    leaf_err = float(np.abs(lv_sum - raw).max())
    if leaf_err > _LEAF_SUM_ATOL:
        raise AssertionError(f"{tag}: leaf values sum {leaf_err} from the "
                             f"raw score")

    s = booster._used_trees()
    ic, cw = booster._cat_args(s)
    args = (booster.split_feature[s], booster.threshold[s],
            booster.leaf_value[s], booster.cover[s], booster.n_features,
            booster.max_depth)
    m = SHAP_ORACLE_ROWS
    got = shap_contributions_device(x[:m], *args, split_is_cat=ic,
                                    cat_words=cw, device=dev)
    t0 = time.perf_counter()
    oracle = booster.feature_contributions(x[:m], backend="host")
    oracle_s = time.perf_counter() - t0
    shap_err = float(np.abs(got.cpu().numpy().astype(np.float64)
                            - oracle).max())
    if shap_err > _SHAP_ATOL:
        raise AssertionError(f"{tag}: device TreeSHAP {shap_err} from the "
                             f"host oracle")
    xs = torch.as_tensor(x[:SHAP_ROWS]).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    phi = shap_contributions_device(xs, *args, split_is_cat=ic,
                                    cat_words=cw, device=dev)
    torch.cuda.synchronize()
    shap_s = time.perf_counter() - t0
    shap_peak = torch.cuda.max_memory_allocated()
    # the same call under torch.profiler: its kernels' time against the
    # unprofiled wall says how much of it the card is busy
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprof
    with tprof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        shap_contributions_device(xs, *args, split_is_cat=ic, cat_words=cw,
                                  device=dev)
        torch.cuda.synchronize()
    shap_kernel_s = sum(_device_us(e, own=True) for e in prof.events()
                        if e.device_type == DeviceType.CPU) / 1e6
    n_kernels = sum(1 for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    if phi.shape != (SHAP_ROWS, booster.n_features + 1) or not bool(
            phi.isfinite().all()):
        raise AssertionError(f"{tag}: SHAP values are not finite "
                             f"(n, F + 1) values")
    acc_err = float((phi.sum(1).double() + base - torch.as_tensor(
        booster.raw_score(x[:SHAP_ROWS], base, device=dev)[:, 0],
        device=dev).double()).abs().max())
    if acc_err > _SHAP_ATOL:
        raise AssertionError(f"{tag}: SHAP rows sum {acc_err} from the raw "
                             f"score plus init")

    split = booster.feature_importances("split")
    n_internal = int((booster.split_feature >= 0).sum())
    if split.sum() != n_internal:
        raise AssertionError(f"{tag}: split importances sum {split.sum()}, "
                             f"{n_internal} internal nodes")
    gain = booster.feature_importances("gain")

    model = GBDTClassificationModel(
        booster=booster, init_score=base, device=str(dev),
        leaf_prediction_col="leaves", features_shap_col="shap")
    path = os.path.join(tmp, f"{tag}_native.json")
    model.save_native_model(path)
    back = load_native_model(path, GBDTClassificationModel)
    back.set(device=str(dev))
    probe = x[:200_000]
    if not np.array_equal(back.booster.raw_score(probe, back._init_score,
                                                 device=dev),
                          booster.raw_score(probe, base, device=dev)):
        raise AssertionError(f"{tag}: the native model's predictions "
                             f"differ after a load")
    t0 = time.perf_counter()
    out = model.transform(Table({"features": x[:SHAP_ROWS]}))
    transform_s = time.perf_counter() - t0
    cols = np.asarray(out["shap"])
    if (np.asarray(out["leaves"]).shape != (SHAP_ROWS, booster.n_trees)
            or cols.shape != (SHAP_ROWS, booster.n_features + 1)
            or float(np.abs(cols.sum(1) - np.asarray(
                out["raw_prediction"])[:, 0]).max()) > _SHAP_ATOL):
        raise AssertionError(f"{tag}: the transform's leaf/SHAP columns "
                             f"are wrong")
    log(f"[introspect] {tag}: predict_leaf on the card {n} rows x "
        f"{booster.n_trees} trees in {leaf_s:.4f} s ({n / leaf_s:.4g} "
        f"rows/s), equal to the host descent, leaf values within "
        f"{leaf_err:.3g} of raw_score; device TreeSHAP {m} rows within "
        f"{shap_err:.3g} of the float64 host oracle ({oracle_s:.3f} s on "
        f"the host); {SHAP_ROWS} rows in {shap_s:.4f} s = "
        f"{SHAP_ROWS / shap_s:.4g} SHAP rows/s, peak "
        f"{shap_peak / 2**20:.1f} MiB, {shap_kernel_s * 1e3:.2f} ms of "
        f"kernel time in {n_kernels} kernels (busy "
        f"{100 * shap_kernel_s / shap_s:.1f}% of the wall), rows sum to "
        f"raw + init within "
        f"{acc_err:.3g}; split importances sum {int(split.sum())} = "
        f"internal nodes, top gain feature {int(gain.argmax())}; native "
        f"model {os.path.getsize(path)} bytes, bit-identical after a "
        f"load; transform with leaf and SHAP columns {transform_s:.3f} s")
    return dict(leaf_s=leaf_s, leaf_rows_per_s=n / leaf_s,
                leaf_err=leaf_err, shap_err=shap_err, shap_s=shap_s,
                shap_rows_per_s=SHAP_ROWS / shap_s, shap_peak=shap_peak,
                shap_kernel_s=shap_kernel_s, shap_kernels=n_kernels,
                acc_err=acc_err, oracle_s=oracle_s,
                transform_s=transform_s)


def introspect_phase(dev, data, headline, cat):
    """[introspect] on the headline fit's and the categorical fit's
    boosters."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        return {tag: _introspect_one(tag, b["booster"], b["base"], x, dev,
                                     tmp)
                for tag, b, x in (("headline", headline, data["x"]),
                                  ("categorical", cat, cat["x_head"]))}


# ------------------------------------------------------------ [data_parallel]
# slice 13: data-/voting-parallel GBDT over a mesh of DP_POSITIONS
# positions on one card (the ring's layout, `devices=[cuda:0] * 4`)
DP_POSITIONS = 4
DP_TOP_K = 8               # voting: 2k = 16 of the 32 features are summed
_RAGGED_EXTRA = 3          # 8,000,003 rows: one padding row
_RAGGED_AUC_TOL = 0.02     # the reference's tests/test_gbdt.py:277-290
_VOTING_AUC_TOL = 0.01


def _dp_fit(x, y, params, staged, mesh, want, **kw):
    """One `fit_booster_distributed` over `mesh` with the launch counts set
    to 0 just before and read just after; fails unless they equal
    `want`. Returns (booster, base, s, peak bytes)."""
    import torch
    from mmlspark_tpu_torch.models.gbdt import fit_booster_distributed
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    torch.cuda.synchronize()
    hc.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    booster, base, _ = fit_booster_distributed(x, y, params, mesh=mesh,
                                               prebinned=staged, **kw)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: v for k, v in hc.launches.items() if v}
    if launches != want:
        raise AssertionError(f"data-parallel launches {launches}, expected "
                             f"{want}")
    return booster, base, fit_s, torch.cuda.max_memory_allocated()


@contextlib.contextmanager
def _voting_shares(shares):
    """Record, per voting level, the share of (node, feature) histograms
    that cross the sum (elected and voted for); read after the fit."""
    from mmlspark_tpu_torch.models.gbdt import trainer
    saved = trainer._voting_feature_mask

    def spy(local_hists, feature_mask, cfg, top_k, exchange=None):
        vidx, has_vote = saved(local_hists, feature_mask, cfg, top_k,
                               exchange)
        shares.append((has_vote.sum(), has_vote.shape[0] * cfg.n_features))
        return vidx, has_vote
    trainer._voting_feature_mask = spy
    try:
        yield
    finally:
        trainer._voting_feature_mask = saved


def data_parallel_phase(dev, data):
    """[data_parallel]: the headline fit over DP_POSITIONS positions of
    the card beside the one-position fit, a ragged fit, a voting fit, the
    planes route, and a fixed-order checkpointed fit's repeat and 6 -> 10
    resume."""
    import dataclasses

    import torch
    from mmlspark_tpu_torch.parallel import data_mesh

    x, y, staged, d_y = data["x"], data["y"], data["staged"], data["d_y"]
    mesh = data_mesh(devices=[dev] * DP_POSITIONS)
    params = _headline_params()
    per_fit = N_ITERS * DEPTH
    dp_want = dict(hist_tiled=per_fit * DP_POSITIONS)
    _dp_fit(x, y, dataclasses.replace(params, num_iterations=1), staged,
            mesh, dict(hist_tiled=DEPTH * DP_POSITIONS))
    one_times, dp_times = [], []
    for _ in range(FIT_REPEATS):
        one, one_base, s1, one_peak = _counted_fit(
            x, y, params, staged, dev, dict(hist_tiled=per_fit))
        one_times.append(s1)
        dp, dp_base, s4, dp_peak = _dp_fit(x, y, params, staged, mesh,
                                           dp_want)
        dp_times.append(s4)
    one_ll, one_auc = _fit_metrics(one, one_base, x, d_y, dev)
    dp_ll, dp_auc = _fit_metrics(dp, dp_base, x, d_y, dev)
    same_first = bool(np.array_equal(dp.split_feature[0],
                                     one.split_feature[0]))
    log(f"[data_parallel] mesh {mesh}: fit_booster_distributed "
        f"data_parallel {FIT_REPEATS} fits "
        f"{', '.join(f'{t:.4f}' for t in dp_times)} s (median "
        f"{float(np.median(dp_times)):.4f} s) against the one-position fit's "
        f"{', '.join(f'{t:.4f}' for t in one_times)} s (median "
        f"{float(np.median(one_times)):.4f} s) in turn; launches {dp_want} "
        f"a fit against {dict(hist_tiled=per_fit)}; peak "
        f"{dp_peak / 2**30:.2f} GiB against {one_peak / 2**30:.2f} GiB; "
        f"logloss {dp_ll:.6f} / {one_ll:.6f}, AUC {dp_auc:.6f} / "
        f"{one_auc:.6f}; first tree's split features equal: {same_first}; "
        f"split features equal at "
        f"{float(np.mean(dp.split_feature == one.split_feature)):.3f}")
    if abs(dp_ll - one_ll) > _METRIC_TOL or abs(dp_auc - one_auc) > \
            _METRIC_TOL:
        raise AssertionError("the data-parallel fit and the one-position "
                             "fit disagree")
    if not same_first:
        raise AssertionError("the first tree's split features differ")

    # ragged: 8,000,003 rows, padded to a multiple of the positions
    n_r = N_ROWS + _RAGGED_EXTRA
    x_r = np.concatenate([x, x[:_RAGGED_EXTRA]])
    y_r = np.concatenate([y, y[:_RAGGED_EXTRA]])
    mapper, d_bins, _ = staged
    staged_r = (mapper, torch.cat([d_bins, d_bins[:_RAGGED_EXTRA]]),
                torch.cat([d_y, d_y[:_RAGGED_EXTRA]]))
    r_one, r_one_base, _, _ = _counted_fit(x_r, y_r, params, staged_r, dev,
                                           dict(hist_tiled=per_fit))
    r_dp, r_dp_base, r_s, _ = _dp_fit(x_r, y_r, params, staged_r, mesh,
                                      dp_want)
    _, r_one_auc = _metrics(r_one.raw_score_device(x_r, device=dev)[:, 0]
                            + r_one_base, staged_r[2])
    _, r_dp_auc = _metrics(r_dp.raw_score_device(x_r, device=dev)[:, 0]
                           + r_dp_base, staged_r[2])
    roots = set(r_dp.cover[:, 0].tolist())
    log(f"[data_parallel] ragged {n_r} rows (padded to "
        f"{n_r + (-n_r) % DP_POSITIONS}): {r_s:.4f} s; root covers "
        f"{sorted(roots)} (padding presence 0), base {r_dp_base:.9f} "
        f"against the one-position fit's {r_one_base:.9f} (padding weight "
        f"0); AUC {r_dp_auc:.6f} against {r_one_auc:.6f}")
    if roots != {float(n_r)} or abs(r_dp_base - r_one_base) > 1e-12:
        raise AssertionError("the padding rows counted or weighed")
    if abs(r_dp_auc - r_one_auc) > _RAGGED_AUC_TOL:
        raise AssertionError("the ragged fit's AUC moved")
    del x_r, y_r, staged_r

    # voting: only the elected features' histograms are summed
    shares = []
    with _voting_shares(shares):
        v, v_base, v_s, v_peak = _dp_fit(x, y, params, staged, mesh, dp_want,
                                         parallelism="voting_parallel",
                                         top_k=DP_TOP_K)
    per_level = [[] for _ in range(DEPTH)]
    for i, (voted, cells) in enumerate(shares):
        per_level[i % DEPTH].append(float(voted) / cells)
    level_share = [float(np.mean(v)) for v in per_level]
    _, v_auc = _fit_metrics(v, v_base, x, d_y, dev)
    log(f"[data_parallel] voting_parallel top_k {DP_TOP_K}: {v_s:.4f} s, "
        f"launches {dp_want}, peak {v_peak / 2**30:.2f} GiB; voted "
        f"features' share of the summed histograms per level "
        f"{', '.join(f'{r:.4f}' for r in level_share)}; AUC {v_auc:.6f} "
        f"against data_parallel {dp_auc:.6f}")
    if abs(v_auc - dp_auc) > _VOTING_AUC_TOL:
        raise AssertionError("the voting fit's AUC is off the "
                             "data-parallel fit's")
    if max(level_share) > 2 * DP_TOP_K / N_FEAT:
        raise AssertionError("more than 2k features crossed the sum")

    # the planes route, over the positions (a plan per position)
    planes_want = dict(hist_tiled=N_ITERS * DP_POSITIONS,
                       hist_planes=N_ITERS * (DEPTH - 1) * DP_POSITIONS)
    with env("MMLSPARK_TPU_HIST", "planes"):
        p_one, p_one_base, _, _ = _counted_fit(
            x, y, params, staged, dev,
            dict(hist_tiled=N_ITERS, hist_planes=N_ITERS * (DEPTH - 1)))
        p_dp, p_dp_base, p_s, p_peak = _dp_fit(x, y, params, staged, mesh,
                                               planes_want)
    p_one_ll, p_one_auc = _fit_metrics(p_one, p_one_base, x, d_y, dev)
    p_ll, p_auc = _fit_metrics(p_dp, p_dp_base, x, d_y, dev)
    log(f"[data_parallel] MMLSPARK_TPU_HIST=planes over the mesh: "
        f"{p_s:.4f} s, launches {planes_want}, peak "
        f"{p_peak / 2**30:.2f} GiB; logloss {p_ll:.6f}, AUC {p_auc:.6f} "
        f"against the one-position planes fit's {p_one_ll:.6f}, "
        f"{p_one_auc:.6f}")
    if abs(p_ll - p_one_ll) > _METRIC_TOL or abs(p_auc - p_one_auc) > \
            _METRIC_TOL:
        raise AssertionError("the data-parallel planes fit disagrees")

    # fixed order: a checkpointed fit repeats itself, and its resume from
    # the iteration-6 checkpoint equals it bit for bit
    ck_params = dataclasses.replace(
        params, bagging_fraction=0.8, bagging_freq=1, feature_fraction=0.8)
    fixed_want = dict(hist_tiled_fixed=N_ITERS * (DEPTH + 1) * DP_POSITIONS)
    runs = []
    for _ in range(2):
        saved = {}

        def ck(it, booster, base, final=False, margin=None, rng_key=None,
               saved=saved):
            saved[it] = (booster, base, margin)
        b, base, f_s, f_peak = _dp_fit(
            x, y, ck_params, staged, mesh, fixed_want, checkpoint_fn=ck,
            checkpoint_interval=RESUME_INTERVAL)
        runs.append((b, base, f_s, saved))
    (a, a_base, a_s, a_saved), (b, b_base, b_s, b_saved) = runs
    a_raw = a.raw_score(x, a_base, device=dev)
    _same_fit(a_raw, a, b.raw_score(x, b_base, device=dev), b,
              "two fixed-order data-parallel fits")
    if not np.array_equal(a_saved[9][2], b_saved[9][2]):
        raise AssertionError("two fixed-order data-parallel fits' margins "
                             "differ")
    b6, base6, m6 = a_saved[6]
    resumed = {}

    def ck_resumed(it, booster, base, final=False, margin=None,
                   rng_key=None):
        resumed[it] = margin
    r, _, r_s, _ = _dp_fit(
        x, y, dataclasses.replace(ck_params, num_iterations=N_ITERS - 6),
        staged, mesh,
        dict(hist_tiled_fixed=(N_ITERS - 6) * (DEPTH + 1) * DP_POSITIONS),
        init_booster=b6, init_base=base6, init_margin=m6, iter_offset=6,
        checkpoint_fn=ck_resumed, checkpoint_interval=RESUME_INTERVAL)
    _same_fit(a_raw, a, r.raw_score(x, base6, device=dev), r,
              "the data-parallel 6 -> 10 resume")
    if not np.array_equal(resumed[3], a_saved[9][2]):
        raise AssertionError("the resumed data-parallel margin differs")
    log(f"[data_parallel] fixed-order checkpointed fit (bagging 0.8/1, "
        f"feature_fraction 0.8, a checkpoint every {RESUME_INTERVAL}): "
        f"{a_s:.4f} / {b_s:.4f} s, launches {fixed_want}, peak "
        f"{f_peak / 2**30:.2f} GiB; two fits equal bit for bit; 6 -> "
        f"{N_ITERS} resume ({r_s:.4f} s) equal to the uninterrupted fit bit "
        f"for bit")
    return dict(launches=dp_want, one_times=one_times, dp_times=dp_times,
                peak=dp_peak, one_peak=one_peak, logloss=dp_ll, auc=dp_auc,
                one_logloss=one_ll, one_auc=one_auc, ragged_s=r_s,
                ragged_auc=r_dp_auc, voting_s=v_s, voting_auc=v_auc,
                voting_share=level_share, planes_launches=planes_want,
                planes_s=p_s, fixed_launches=fixed_want,
                fixed_s=[a_s, b_s], resume_s=r_s)


VERSUS_ORDER = ("parent", "change", "change", "parent")


def _versus_measure():
    """One tree's numbers for `versus_phase`, in a process whose first
    `sys.path` entry is that tree (its `mmlspark_tpu_torch` is the one
    driven; this file's functions drive it). Prints one JSON line."""
    import torch
    from mmlspark_tpu_torch.models.dnn import (TransformerSentenceEncoder,
                                               init_transformer)
    from mmlspark_tpu_torch.models.gbdt import fit_booster
    from mmlspark_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    res = {}
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(SEQ, 8, 128, device=dev, generator=gen)
               for _ in range(3))
    for causal in (False, True):
        res[f"flash_fwd_f32_causal={causal}_ms"] = timed(
            lambda: fa.flash_fwd(q, k, v, causal, 128 ** -0.5),
            warmup=2, reps=10)
    del q, k, v

    tree = init_transformer(1 << ENCODER["vocab_bits"], ENCODER["d_model"],
                            ENCODER["n_heads"], ENCODER["n_layers"],
                            ENCODER["d_ff"], ENCODER["max_len"], seed=0)
    enc = TransformerSentenceEncoder(**ENCODER, input_col="text",
                                     output_col="emb", device=dev)
    enc.set_params_tree(tree)
    enc.set(attention="flash", attention_dtype=None)
    tokens = np.random.default_rng(0).integers(0, 1 << ENCODER["vocab_bits"],
                                               SEQ)
    enc.encode_long(tokens[:1024])
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc.encode_long(tokens)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    res["encode_long_f32_s"] = walls
    del enc, tree
    torch.cuda.empty_cache()

    res["lm_step_f32_s"] = _flagship_steps(dev, "float32", False)["s_step"]
    torch.cuda.empty_cache()

    data = headline_data(dev)
    params = _headline_params()
    import dataclasses
    fit_booster(data["x"], data["y"],             # warm-up, 1 iteration
                dataclasses.replace(params, num_iterations=1),
                prebinned=data["staged"], device=dev)
    fits = []
    for _ in range(FIT_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit_booster(data["x"], data["y"], params, prebinned=data["staged"],
                    device=dev)
        torch.cuda.synchronize()
        fits.append(time.perf_counter() - t0)
    res["headline_fit_s"] = fits
    # the [planes path] fit: MMLSPARK_TPU_HIST=planes, bagging 0.8/1,
    # feature_fraction 0.8
    params = _headline_params(bagging_fraction=0.8, bagging_freq=1,
                              feature_fraction=0.8)
    fits = []
    with env("MMLSPARK_TPU_HIST", "planes"):
        fit_booster(data["x"], data["y"],
                    dataclasses.replace(params, num_iterations=1),
                    prebinned=data["staged"], device=dev)
        for _ in range(FIT_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit_booster(data["x"], data["y"], params,
                        prebinned=data["staged"], device=dev)
            torch.cuda.synchronize()
            fits.append(time.perf_counter() - t0)
    res["planes_fit_s"] = fits
    print(json.dumps(res), flush=True)


def versus_phase(parent):
    """`_versus_measure` of the parent tree (a checkout at `parent`) and of
    this one, in the order of `VERSUS_ORDER`, each in its own process."""
    import torch
    torch.cuda.empty_cache()
    code = ("import importlib.util, sys; sys.path.insert(0, sys.argv[1]); "
            "spec = importlib.util.spec_from_file_location('chip_smoke_vs', "
            "sys.argv[2]); m = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(m); m._versus_measure()")
    trees = {"parent": os.path.abspath(parent), "change": HERE}
    runs = []
    for who in VERSUS_ORDER:
        proc = subprocess.run(
            [sys.executable, "-c", code, trees[who], os.path.abspath(__file__)],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"versus run of the {who} failed:\n"
                                 f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        log(f"[versus] {who} ({trees[who]}): {json.dumps(res)}")
        runs.append(dict(who=who, **res))
    return runs


# ------------------------------------------------------------ [ingest]
# slice 15: the data plane on the card. The headline's rows staged by host
# workers chunk by chunk while earlier chunks ride to the card
# (`data.stage_binned`), the same rows memory-mapped from a 1 GiB .npy
# under a residency budget (`data.ChunkStager`), the ingest fit, and the
# out-of-core checkpointed estimator killed mid-staging and resumed in a
# fresh process
INGEST_WORKERS = 8
INGEST_PREFETCH = 2
OOCORE_BUDGET = 256 << 20
# the killed child's injected delay before each chunk's commit, and the
# cursor past which the parent sends it SIGTERM
OOCORE_DELAY_S = 0.15
OOCORE_KILL_CURSOR = 5
OOCORE_PARAMS = dict(num_iterations=N_ITERS, max_depth=DEPTH, num_leaves=31,
                     max_bin=MAX_BIN, min_data_in_leaf=20,
                     checkpoint_interval=RESUME_INTERVAL, out_of_core=True,
                     max_resident_bytes=OOCORE_BUDGET,
                     num_ingest_workers=INGEST_WORKERS,
                     ingest_prefetch=INGEST_PREFETCH)
# phase "kill": stage the file into the estimator's spill cache with a
# delay injector of its own, until the parent's SIGTERM; phase "resume":
# the estimator's fit from that directory (the stager resumes from the
# cache's cursor), writing its booster, its launches and the first chunk
# it staged itself
_OOCORE_PROC = """
import json, os, sys
import numpy as np
import torch
sys.path.insert(0, {here!r})
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.data import ChunkStager, OocoreOptions, oocore
from mmlspark_tpu_torch.models.gbdt import GBDTClassifier
from mmlspark_tpu_torch.ops import binning
from mmlspark_tpu_torch.ops import histogram_cuda as hc
from mmlspark_tpu_torch.reliability import FaultInjector

phase, xfile, yfile, ckdir, params, device, out = sys.argv[1:8]
params = json.loads(params)
if phase == "kill":
    x = np.load(xfile, mmap_mode="r")
    mapper = binning.fit_bins(x, max_bin=params["max_bin"], seed=0)
    faults = FaultInjector(seed=0, rules=[
        {{"site": "data.oocore.stage*", "kind": "delay", "prob": 1.0,
          "param": {delay}}}])
    opts = OocoreOptions(
        max_resident_bytes=params["max_resident_bytes"],
        cache_path=os.path.join(ckdir, "oocore_bins.npy"),
        num_workers=params["num_ingest_workers"], mode="thread",
        prefetch=params["ingest_prefetch"])
    print("STAGING", flush=True)
    ChunkStager(xfile, mapper, opts, faults=faults).stage(device=device)
    print("DONE", flush=True)
    sys.exit(0)
commits = []
commit = oocore.ChunkStager._commit
def counted(self, index):
    commits.append(index)
    commit(self, index)
oocore.ChunkStager._commit = counted
x, y = np.load(xfile), np.load(yfile)
hc.reset_launches()
model = GBDTClassifier(checkpoint_dir=ckdir, device=device, **params).fit(
    Table({{"features": x, "label": y}}))
np.savez(out, booster=model.booster.save_model_string(),
         init_score=model._init_score,
         launches=json.dumps({{k: v for k, v in hc.launches.items() if v}}),
         first_commit=commits[0] if commits else -1, commits=len(commits))
"""


def _staging_busy_s(fn):
    """Device seconds of the kernels and copies that `fn` issues, from
    torch.profiler (the busy share against an unprofiled wall)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprof
    with tprof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(_device_us(e, own=True) for e in prof.events()
               if e.device_type == DeviceType.CPU) / 1e6


def _sidecar_cursor(cache):
    try:
        with open(cache + ".cursor.json") as f:
            return int(json.load(f)["cursor"])
    except (OSError, ValueError, KeyError):
        return 0


def _oocore_estimator(dev, tmp, x, y, xfile, yfile, n_chunks, resume):
    """The out-of-core checkpointed GBDTClassifier uninterrupted (counted),
    then a child staging the same file with a delay injector, SIGTERMed
    once its cursor is past OOCORE_KILL_CURSOR, and a fresh process that
    resumes the estimator's fit from that cache: booster equal field for
    field, fixed-order launches equal [resume]'s checkpointed fit's."""
    import torch
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.models.gbdt import Booster, GBDTClassifier
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    from mmlspark_tpu_torch.utils.checkpoint import CheckpointManager
    full_dir = os.path.join(tmp, "oocore_full")
    torch.cuda.synchronize()
    hc.reset_launches()
    t0 = time.perf_counter()
    full = GBDTClassifier(checkpoint_dir=full_dir, device=str(dev),
                          **OOCORE_PARAMS).fit(
        Table({"features": x, "label": y}))
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    launches = {k: v for k, v in hc.launches.items() if v}
    want_launches = (resume["routes"]["default"]["launches"]
                     if resume is not None else _RESUME_LAUNCHES["default"])
    if launches != want_launches:
        raise AssertionError(f"the out-of-core checkpointed fit launched "
                             f"{launches}, expected {want_launches}")
    payload = CheckpointManager(full_dir).restore()
    if payload.get("oocore_cursor") != n_chunks:
        raise AssertionError(f"the out-of-core fit's last checkpoint has "
                             f"oocore_cursor {payload.get('oocore_cursor')},"
                             f" not {n_chunks}")

    script = os.path.join(tmp, "oocore_fit.py")
    with open(script, "w") as fh:
        fh.write(_OOCORE_PROC.format(here=HERE, delay=OOCORE_DELAY_S))
    params = json.dumps(OOCORE_PARAMS)
    ck = os.path.join(tmp, "oocore_killed")
    cache = os.path.join(ck, "oocore_bins.npy")
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, script, "kill", xfile, yfile, ck, params,
         str(dev), "-"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        if not child.stdout.readline().startswith("STAGING"):
            raise AssertionError(f"the staging child did not start: "
                                 f"{child.stderr.read()[-2000:]}")
        deadline = time.time() + 300
        while (_sidecar_cursor(cache) <= OOCORE_KILL_CURSOR
               and child.poll() is None and time.time() < deadline):
            time.sleep(0.02)
        child.send_signal(signal.SIGTERM)
        code = child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    kill_s = time.perf_counter() - t0
    cursor = _sidecar_cursor(cache)
    if code != -signal.SIGTERM or not OOCORE_KILL_CURSOR < cursor < n_chunks:
        raise AssertionError(f"the staging child exited {code} at cursor "
                             f"{cursor} of {n_chunks} chunks")
    t0 = time.perf_counter()
    out = os.path.join(tmp, "oocore_resume.npz")
    proc = subprocess.run(
        [sys.executable, script, "resume", xfile, yfile, ck, params,
         str(dev), out],
        capture_output=True, text=True, timeout=600)
    resume_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the resumed estimator fit failed: "
                             f"{proc.stderr[-3000:]}")
    res = np.load(out)
    got = Booster.load_model_string(str(res["booster"]))
    want = Booster.load_model_string(full.booster.save_model_string())
    for field in want._fields:
        if not np.array_equal(np.asarray(getattr(want, field)),
                              np.asarray(getattr(got, field))):
            raise AssertionError(f"the resumed out-of-core fit's {field} "
                                 f"differs from the uninterrupted fit's")
    if float(res["init_score"]) != full._init_score:
        raise AssertionError("the resumed out-of-core fit's init score "
                             "differs")
    resumed_launches = json.loads(str(res["launches"]))
    first = int(res["first_commit"])
    if resumed_launches != want_launches or first != cursor or \
            int(res["commits"]) != n_chunks - cursor:
        raise AssertionError(
            f"the resumed fit launched {resumed_launches} (expected "
            f"{want_launches}) and staged from chunk {first} "
            f"({int(res['commits'])} chunks; the cursor was {cursor})")
    log(f"[ingest] GBDTClassifier(out_of_core=True, max_resident_bytes="
        f"{OOCORE_BUDGET}, num_ingest_workers={INGEST_WORKERS}, "
        f"checkpoint_interval={RESUME_INTERVAL}): {full_s:.3f} s "
        f"uninterrupted, {n_chunks} chunks, launches {launches}, "
        f"oocore_cursor {n_chunks} in its last checkpoint; a child staging "
        f"with {OOCORE_DELAY_S} s a chunk SIGTERMed at cursor {cursor} "
        f"(exit {code}, {kill_s:.1f} s), a fresh process resumed from chunk "
        f"{first} ({resume_s:.1f} s, process start included): booster "
        f"equal field for field, launches {resumed_launches}")
    return dict(full_s=full_s, launches=launches, n_chunks=n_chunks,
                kill_cursor=cursor, kill_s=kill_s, resume_s=resume_s,
                resumed_launches=resumed_launches)


def ingest_phase(dev, data, paths, resume):
    """[ingest]: `stage_binned` (INGEST_WORKERS thread workers, prefetch
    INGEST_PREFETCH) against the serial card path on the headline's rows,
    the memory-mapped `ChunkStager` under OOCORE_BUDGET, the ingest fit
    (exactly 50 `hist_tiled`, metrics within `_METRIC_TOL` of [main]'s),
    and the out-of-core estimator's kill and resume."""
    import tempfile

    import torch
    from mmlspark_tpu_torch.data import (ChunkStager, IngestOptions,
                                         OocoreOptions, parallel_apply_bins,
                                         stage_binned)
    from mmlspark_tpu_torch.models.gbdt import fit_booster
    from mmlspark_tpu_torch.ops import binning
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    from mmlspark_tpu_torch.reliability import names as rnames
    from mmlspark_tpu_torch.reliability import reliability_metrics

    x, y, d_y = data["x"], data["y"], data["d_y"]
    mapper, want = data["staged"][0], data["staged"][1]
    opts = IngestOptions(num_workers=INGEST_WORKERS, mode="thread",
                         prefetch=INGEST_PREFETCH)
    # the serial path, timed in this phase: host fit_bins, then one
    # searchsorted pass on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial_mapper = binning.fit_bins(x, max_bin=MAX_BIN, seed=0)
    fit_bins_s = time.perf_counter() - t0
    serial = binning.apply_bins_device(serial_mapper, x, device=dev)
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    if not torch.equal(serial, want):
        raise AssertionError("the serial card bins differ from [main]'s")
    del serial
    # one staging run, timed under torch.profiler (a few hundred host
    # ops: its overhead is noise against seconds of host binning)
    staged = {}

    def stage():
        staged["bins"] = stage_binned(mapper, x, opts, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    busy_s = _staging_busy_s(stage)
    stage_s = time.perf_counter() - t0
    if not torch.equal(staged.pop("bins"), want):
        raise AssertionError("stage_binned's bins differ from "
                             "apply_bins_device's")
    idle = 1.0 - busy_s / stage_s
    log(f"[ingest] stage_binned {N_ROWS} x {N_FEAT} f32, {INGEST_WORKERS} "
        f"thread workers, prefetch {INGEST_PREFETCH}: {stage_s:.3f} s "
        f"(under the profiler), bins torch.equal "
        f"to apply_bins_device's; the serial path fit_bins + "
        f"apply_bins_device {serial_s:.3f} s (fit_bins {fit_bins_s:.3f} s); "
        f"the card busy {busy_s * 1e3:.2f} ms of the staging (idle "
        f"{100 * idle:.2f}%)")
    # a process worker imports torch with the binning module: the pool's
    # spawn and import cost, on two tiny chunks
    t0 = time.perf_counter()
    small = parallel_apply_bins(mapper, x[:8192], IngestOptions(
        num_workers=2, mode="process", chunk_rows=4096))
    spawn_s = time.perf_counter() - t0
    if not np.array_equal(small, want[:8192].cpu().numpy()):
        raise AssertionError("process-worker bins differ")
    log(f"[ingest] process workers (spawn): 2 workers on 8,192 rows "
        f"{spawn_s:.2f} s, their start-up and `import torch` included")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ingest_") as tmp:
        xfile = os.path.join(tmp, "x.npy")
        yfile = os.path.join(tmp, "y.npy")
        np.save(xfile, x)
        np.save(yfile, y)
        reliability_metrics.reset(prefix="data.")
        stager = ChunkStager(xfile, mapper, OocoreOptions(
            max_resident_bytes=OOCORE_BUDGET, num_workers=INGEST_WORKERS,
            prefetch=INGEST_PREFETCH))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged = stager.stage(device=dev)
        torch.cuda.synchronize()
        oocore_s = time.perf_counter() - t0
        resident = reliability_metrics.peek_gauge(
            rnames.DATA_OOCORE_RESIDENT_BYTES)
        n_chunks = len(stager.source)
        if not torch.equal(staged, want) or stager.cursor != n_chunks:
            raise AssertionError("the memory-mapped ChunkStager's bins "
                                 "differ")
        if resident is None or resident > OOCORE_BUDGET:
            raise AssertionError(f"resident bytes {resident} above the "
                                 f"budget {OOCORE_BUDGET}")
        del staged
        log(f"[ingest] ChunkStager over a memory-mapped {os.path.getsize(xfile)}"
            f"-byte .npy, max_resident_bytes {OOCORE_BUDGET}: {n_chunks} "
            f"chunks of {stager.source.chunk_rows} rows in {oocore_s:.3f} s, "
            f"bins torch.equal; data.oocore.resident_bytes {resident:.0f}")

        main_ll, main_auc = _fit_metrics(paths["booster"], paths["base"], x,
                                         d_y, dev)
        torch.cuda.synchronize()
        hc.reset_launches()
        t0 = time.perf_counter()
        booster, base, _ = fit_booster(x, y, _headline_params(),
                                       ingest=opts, device=dev)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {k: v for k, v in hc.launches.items() if v}
        if launches != dict(hist_tiled=N_ITERS * DEPTH):
            raise AssertionError(f"the ingest fit launched {launches}")
        logloss, auc = _fit_metrics(booster, base, x, d_y, dev)
        log(f"[ingest] fit_booster(ingest=IngestOptions({INGEST_WORKERS} "
            f"workers)) at the headline parameters: {fit_s:.3f} s, binning "
            f"included; launches {launches}; logloss {logloss:.6f}, AUC "
            f"{auc:.6f} ([main] {main_ll:.6f} / {main_auc:.6f})")
        if abs(logloss - main_ll) > _METRIC_TOL or \
                abs(auc - main_auc) > _METRIC_TOL:
            raise AssertionError("the ingest fit and [main]'s disagree")
        torch.cuda.synchronize()
        hc.reset_launches()
        t0 = time.perf_counter()
        booster, base, _ = fit_booster(xfile, y, _headline_params(),
                                       oocore=OocoreOptions(
                                           max_resident_bytes=OOCORE_BUDGET,
                                           num_workers=INGEST_WORKERS,
                                           prefetch=INGEST_PREFETCH),
                                       device=dev)
        torch.cuda.synchronize()
        oofit_s = time.perf_counter() - t0
        oofit_launches = {k: v for k, v in hc.launches.items() if v}
        if oofit_launches != dict(hist_tiled=N_ITERS * DEPTH):
            raise AssertionError(f"the out-of-core fit launched "
                                 f"{oofit_launches}")
        oo_ll, oo_auc = _fit_metrics(booster, base, x, d_y, dev)
        log(f"[ingest] fit_booster(x.npy, oocore=OocoreOptions("
            f"max_resident_bytes={OOCORE_BUDGET})): {oofit_s:.3f} s, "
            f"staging included; launches {oofit_launches}; logloss "
            f"{oo_ll:.6f}, AUC {oo_auc:.6f}")
        if abs(oo_ll - main_ll) > _METRIC_TOL or \
                abs(oo_auc - main_auc) > _METRIC_TOL:
            raise AssertionError("the out-of-core fit and [main]'s disagree")
        est = _oocore_estimator(dev, tmp, x, y, xfile, yfile, n_chunks,
                                resume)
    torch.cuda.empty_cache()
    return dict(stage_s=stage_s, serial_s=serial_s,
                fit_bins_s=fit_bins_s, busy_s=busy_s, idle=idle,
                spawn_s=spawn_s, oocore_s=oocore_s, n_chunks=n_chunks,
                resident=resident, fit_s=fit_s, launches=launches,
                logloss=logloss, auc=auc, oofit_s=oofit_s,
                oofit_launches=oofit_launches, estimator=est)


# ------------------------------------------------------- [stream train]
# slice 15: `ShardedLMTrainer.run_stream` at the flagship width, f32,
# dense attention, on STREAM_BATCHES seeded (4, 2048) batches of Zipf
# token ids: against a
# `step()` loop, then supervised (a checkpoint every STREAM_EVERY batches)
# with and without an injected crash, and a child preempted by SIGTERM
# and resumed in a fresh process
STREAM_BATCHES = 12
STREAM_SHAPE = (4, 2048)
STREAM_EVERY = 6
STREAM_CRASH_STEP = 7
STREAM_KILL_AFTER = 5
_STREAM_PROC = """
import json, os, signal, sys
import numpy as np
import torch
sys.path.insert(0, {here!r})
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke
from mmlspark_tpu_torch.models.dnn import ShardedLMTrainer
from mmlspark_tpu_torch.reliability import Preempted

phase, ckdir, cfg, device, out = sys.argv[1:6]
cfg = json.loads(cfg)
batches = chip_smoke._stream_batches(cfg["lm"], cfg["shape"], cfg["n"])
t = ShardedLMTrainer(seed=0, device=device, **cfg["lm"])
if phase == "kill":
    update, done = t._update, []
    def counted(tok):
        loss = update(tok)
        done.append(1)
        if len(done) == cfg["kill_after"]:
            os.kill(os.getpid(), signal.SIGTERM)
        return loss
    t._update = counted
    try:
        t.run_stream(batches, checkpoint_dir=ckdir,
                     checkpoint_every=cfg["every"])
    except Preempted as e:
        with open(out, "w") as f:
            json.dump(dict(step=e.step, signum=e.signum), f)
        sys.exit(0)
    sys.exit(3)
losses = t.run_stream(batches, checkpoint_dir=ckdir,
                      checkpoint_every=cfg["every"])
with open(out, "w") as f:
    json.dump(dict(losses=losses,
                   digests=chip_smoke._param_digests(t)), f)
"""


def _stream_batches(lm, shape, n):
    """n seeded batches of Zipf-distributed token ids (a = 1.2): a stream
    whose unigram statistics a model learns within a few steps, so the
    loss falls across batches that never repeat."""
    rng = np.random.default_rng(11)
    return [((rng.zipf(1.2, size=tuple(shape)) - 1) % lm["vocab_size"])
            .astype(np.int32) for _ in range(n)]


def _param_digests(trainer):
    import hashlib

    from mmlspark_tpu_torch.models.dnn.transformer import _flatten
    return [hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()
            for t in _flatten(trainer.params)]


def _stream_child(script, phase, ck, dev, out):
    cfg = json.dumps(dict(lm=LM, shape=STREAM_SHAPE, n=STREAM_BATCHES,
                          every=STREAM_EVERY, kill_after=STREAM_KILL_AFTER))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, script, phase, ck, cfg, str(dev),
                           out],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the {phase} child exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    with open(out) as f:
        return json.load(f), time.perf_counter() - t0


def stream_train_phase(dev):
    """[stream train]: a `step()` loop, then `run_stream(prefetch=2)`
    supervised (a checkpoint every STREAM_EVERY batches) from the same
    initial state, uninterrupted (losses equal the loop's) and with an
    injected train.step{STREAM_CRASH_STEP} crash absorbed in-run (losses
    and parameters bit-identical), and a child SIGTERMed after
    STREAM_KILL_AFTER steps and resumed in a fresh process (the full loss
    history and the parameters bit-identical). s/step and tokens/s of the
    stream's steps (its goodput clock's step walls), the prefetcher's
    stalls and the checkpoint write seconds. One trainer serves the three
    in-process runs: its initial state, as a payload, is restored before
    each (building the flagship from its seed takes ~12 s on the host)."""
    import tempfile

    import torch
    from mmlspark_tpu_torch.models.dnn import ShardedLMTrainer
    from mmlspark_tpu_torch.models.dnn.lm_training import (
        lm_state_from_payload, lm_state_payload)
    from mmlspark_tpu_torch.ops import flash_attention as fa
    from mmlspark_tpu_torch.reliability import (FaultInjector,
                                                reliability_metrics)
    from mmlspark_tpu_torch.reliability import names as rnames
    from mmlspark_tpu_torch.telemetry import StepClock
    from mmlspark_tpu_torch.utils.checkpoint import CheckpointManager

    batches = _stream_batches(LM, STREAM_SHAPE, STREAM_BATCHES)
    tokens = STREAM_SHAPE[0] * STREAM_SHAPE[1]
    t = ShardedLMTrainer(seed=0, device=dev, **LM)
    init = lm_state_payload(t.params, t._opt, t.meta, t._blocks)

    def from_init():
        lm_state_from_payload(init, t.params, t._opt, t.meta, t._blocks)

    def timed_run(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / len(batches)

    fa.reset_launches()
    want, step_s = timed_run(lambda: [t.step(b) for b in batches])
    write = reliability_metrics.histogram(rnames.CHECKPOINT_WRITE)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as tmp:
        from_init()
        clock = StepClock()
        stalls0 = reliability_metrics.get(rnames.DATA_PREFETCH_STALLS)
        n0, ms0 = write.count, write.snapshot()["sum"]
        sup, sup_s = timed_run(lambda: t.run_stream(
            batches, prefetch=2, checkpoint_dir=os.path.join(tmp, "a"),
            checkpoint_every=STREAM_EVERY, step_clock=clock))
        stalls = reliability_metrics.get(
            rnames.DATA_PREFETCH_STALLS) - stalls0
        writes = write.count - n0
        save_s = (write.snapshot()["sum"] - ms0) / 1e3 / max(writes, 1)
        acct = clock.snapshot()
        stream_s = (acct["wall_s"] - acct["phases"]["checkpoint_s"]) \
            / acct["steps"]
        log(f"[stream train] ShardedLMTrainer flagship f32, "
            f"{STREAM_BATCHES} batches {STREAM_SHAPE}: step() loop "
            f"{step_s:.4f} s/step; run_stream(prefetch=2), a checkpoint "
            f"every {STREAM_EVERY} batches: {stream_s:.4f} s a step = "
            f"{tokens / stream_s:.4g} tokens/s ({sup_s:.4f} s/step with "
            f"the checkpoints: {writes} writes of {save_s:.2f} s each), "
            f"{stalls} prefetch stalls, goodput {acct['goodput']:.3f}; "
            f"losses equal the loop's: {sup == want} ({want[0]:.6f} -> "
            f"{want[-1]:.6f})")
        if sup != want or not want[-1] < want[0]:
            raise AssertionError("run_stream's losses differ from the "
                                 "step() loop's, or do not fall")
        digests = _param_digests(t)
        from_init()
        restarts0 = reliability_metrics.get(rnames.TRAIN_STEP_RESTARTS)
        crashed, crash_s = timed_run(lambda: t.run_stream(
            batches, checkpoint_dir=os.path.join(tmp, "b"),
            checkpoint_every=STREAM_EVERY, faults=FaultInjector(
                seed=7, rules=[{"site": f"train.step{STREAM_CRASH_STEP}",
                                "kind": "crash", "at": [0]}])))
        restarts = reliability_metrics.get(rnames.TRAIN_STEP_RESTARTS) \
            - restarts0
        same_params = _param_digests(t) == digests
        del t, init
        torch.cuda.empty_cache()
        if any(fa.launches.values()):
            raise AssertionError(f"ShardedLMTrainer launched {fa.launches}")
        log(f"[stream train] with an injected train.step{STREAM_CRASH_STEP} "
            f"crash ({restarts} restart from the step-{STREAM_EVERY} "
            f"snapshot): {crash_s:.4f} s/step with the checkpoints; losses "
            f"equal the uninterrupted run's: {crashed == sup}; parameters "
            f"equal: {same_params}")
        if crashed != sup or not same_params or restarts != 1:
            raise AssertionError("the in-run restart is not bit-identical")

        script = os.path.join(tmp, "stream.py")
        with open(script, "w") as fh:
            fh.write(_STREAM_PROC.format(here=HERE))
        ck = os.path.join(tmp, "killed")
        killed, kill_s = _stream_child(script, "kill", ck, dev,
                                       os.path.join(tmp, "kill.json"))
        # the final checkpoint's scalars (meta.json), not its 2.4 GB
        mgr = CheckpointManager(ck)
        with open(os.path.join(mgr._step_dir(mgr.latest_step()),
                               "meta.json")) as f:
            on_disk = json.load(f)
        if killed["signum"] != signal.SIGTERM or \
                killed["step"] != STREAM_KILL_AFTER or \
                on_disk.get("sup_step") != STREAM_KILL_AFTER or \
                on_disk.get("sup_preempted") is not True:
            raise AssertionError(f"the preempted child wrote {killed}, step "
                                 f"{on_disk.get('sup_step')} on disk")
        resumed, resume_s = _stream_child(script, "resume", ck, dev,
                                          os.path.join(tmp, "resume.json"))
    log(f"[stream train] a child SIGTERMed after {STREAM_KILL_AFTER} steps "
        f"(Preempted at step {killed['step']}, final checkpoint written; "
        f"{kill_s:.1f} s) and a fresh process resumed ({resume_s:.1f} s, "
        f"process start included): loss history equal: "
        f"{resumed['losses'] == sup}, parameters equal: "
        f"{resumed['digests'] == digests}")
    if resumed["losses"] != sup or resumed["digests"] != digests:
        raise AssertionError("the preempted and resumed run is not "
                             "bit-identical")
    return dict(step_s=step_s, stream_s=stream_s, tokens_per_s=tokens /
                stream_s, stalls=stalls, sup_s=sup_s, crash_s=crash_s,
                save_s=save_s, writes=writes, goodput=acct["goodput"],
                kill_s=kill_s, resume_s=resume_s, losses=sup)


# ------------------------------------------------------- [multiprocess]
MP_RANKS = 2
MP_LEASE_S = 3.0           # the SIGKILL run's lease budget
_MP_KILL_SLACK_S = 2.0     # beats every 0.1 s, leases checked every 0.1 s
# the scale-out form's init score comes from float64 partial sums, so its
# trees may differ from the whole-table fit's in near ties: ROADMAP
# Queue 3 (e)'s limits
_SCALE_OUT_MARGIN_ATOL = 1e-4
_SCALE_OUT_MARGIN_SHARE = 0.999
_SCALE_OUT_LOGLOSS_TOL = 1e-4
_MP_PROC = """
import json, os, pickle, sys, threading, time
import numpy as np
import torch
sys.path.insert(0, {here!r})
from mmlspark_tpu_torch.models.gbdt import BoostParams, fit_booster_distributed
from mmlspark_tpu_torch.ops import histogram_cuda as hc
from mmlspark_tpu_torch.parallel import cluster, data_mesh
from mmlspark_tpu_torch.parallel.cluster import Heartbeat
from mmlspark_tpu_torch.reliability import HostLeases, MetricsRegistry

mode, rank, tmp, params = sys.argv[1], int(sys.argv[2]), sys.argv[3], \\
    json.loads(sys.argv[4])
cluster.initialize_cluster(init_method="file://" + os.path.join(
    tmp, f"rdv_{{mode}}"), num_processes={ranks}, process_id=rank,
    timeout_s=120)
assert cluster.backend_name() == "gloo", cluster.backend_name()
dev = cluster.local_device()
torch.cuda.set_device(dev)
mesh = data_mesh()
bins = np.load(os.path.join(tmp, "bins.npy"), mmap_mode="r")
y = np.load(os.path.join(tmp, "y.npy"))
mapper = None
if rank == 0:
    with open(os.path.join(tmp, "mapper.pkl"), "rb") as f:
        mapper = pickle.load(f)
mapper = cluster.broadcast_from_leader(mapper)
# a prebinned fit reads only the shape of x: a zero-stride stand-in
x = np.broadcast_to(np.float32(0), bins.shape)
p = BoostParams(**params)
noop = lambda *a, **k: None


def fit(**kw):
    return fit_booster_distributed(x, y, p, mesh=mesh,
                                   prebinned=(mapper, bins, y), **kw)


if mode == "kill":
    hb = Heartbeat(os.path.join(tmp, "hb"), process_id=rank)
    leases = HostLeases(hb, lease_timeout_s={lease}, metrics=MetricsRegistry())
    state = dict(killed_at=None)

    def beat():
        i = 0
        while True:
            hb.beat(i)
            i += 1
            if rank == 0:
                dead = leases.check()
                if dead:
                    with open(os.path.join(tmp, "dead.json"), "w") as f:
                        json.dump(dict(dead=dead, t=time.time(),
                                       live=leases.live), f)
                    os._exit(0)
            time.sleep(0.1)
    threading.Thread(target=beat, daemon=True).start()
    print("FITTING", flush=True)
    try:
        while True:
            fit()
    except Exception:
        # the peer is gone mid-exchange: the leases decide, not this
        while True:
            time.sleep(1.0)
out = {{}}
p1 = BoostParams(**dict(params, num_iterations=1))
for kw in ({{}}, dict(checkpoint_fn=noop)):     # warm-up, not counted
    fit_booster_distributed(x, y, p1, mesh=mesh,
                            prebinned=(mapper, bins, y), **kw)
for name, kw, reps in (("default", {{}}, {reps}),
                       ("fixed", dict(checkpoint_fn=noop), 1)):
    for rep in range(reps):
        torch.cuda.synchronize()
        hc.reset_launches()
        mesh.exchange.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        b, base, _ = fit(**kw)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {{k: v for k, v in hc.launches.items() if v}}
        runs = out.setdefault(name, dict(runs=[]))["runs"]
        runs.append(dict(s=fit_s, launches=launches,
                         exchange=mesh.exchange.stats(),
                         peak=torch.cuda.max_memory_allocated()))
    np.savez(os.path.join(tmp, f"{{name}}_{{rank}}.npz"), base=base,
             **b.to_dict())
# the exchange alone, back to back after a barrier: the deepest level's
# (3, 8 left nodes, F, B) histograms, 60 times as in a fit
probe = torch.zeros((1, 3, 2 ** (p.max_depth - 2), bins.shape[1],
                     p.max_bin + 1), device=mesh.devices[0])
cluster.barrier("probe")
mesh.exchange.reset_stats()
for _ in range(60):
    mesh.exchange.gather(probe)
out["bare_exchange"] = mesh.exchange.stats()
# the scale-out form: only this rank's rows are read
lo, hi = cluster.process_row_range(bins.shape[0])
torch.cuda.synchronize()
hc.reset_launches()
t0 = time.perf_counter()
b, base, _ = fit_booster_distributed(
    x[lo:hi], y[lo:hi], p, mesh=mesh, local_rows=True, checkpoint_fn=noop,
    prebinned=(mapper, np.array(bins[lo:hi]), y[lo:hi]))
torch.cuda.synchronize()
out["scale_out"] = dict(s=time.perf_counter() - t0, rows=[lo, hi],
                        launches={{k: v for k, v in hc.launches.items()
                                  if v}})
np.savez(os.path.join(tmp, f"scale_out_{{rank}}.npz"), base=base,
         **b.to_dict())
with open(os.path.join(tmp, f"out_{{rank}}.json"), "w") as f:
    json.dump(out, f)
cluster.barrier("done")
cluster.shutdown()
"""


def _mp_load(path):
    from mmlspark_tpu_torch.models.gbdt import Booster
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    return Booster.from_dict(d), float(d["base"])


def _mp_same(a, b, what):
    for f in a._fields:
        va, vb = getattr(a, f), getattr(b, f)
        same = (np.array_equal(va, vb) if isinstance(va, np.ndarray)
                or isinstance(vb, np.ndarray) else va == vb)
        if not same:
            raise AssertionError(f"[multiprocess] {what}: {f} differs")


def _mp_spawn(script, mode, tmp, params):
    return [subprocess.Popen(
        [sys.executable, script, mode, str(r), tmp, json.dumps(params)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(MP_RANKS)]


def _mp_reap(procs, timeout):
    """Wait for the ranks; kill any left after `timeout` s. Returns their
    outputs; a rank that failed fails the run."""
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=timeout)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for r, (pr, out) in enumerate(zip(procs, outs)):
        if pr.returncode != 0:
            raise AssertionError(f"[multiprocess] rank {r} exited "
                                 f"{pr.returncode}:\n{out[-3000:]}")
    return outs


def multiprocess_phase(dev, data):
    """[multiprocess]: the headline fit over MP_RANKS processes on the
    card under gloo, one position each (`parallel.cluster`, a data axis
    that spans the processes). The staged bins are saved once to an .npy;
    each rank memory-maps it and fits 10 iterations in the whole-table
    form (default and fixed order) and once in the scale-out form (its
    `process_row_range` only, the leader's broadcast mapper). The ranks'
    boosters must be bit-identical; the fixed-order fit also equal to
    this process's `data_mesh(devices=[dev] * 2)` fit; the scale-out fit
    must have its split features with margins within Queue 3 (e)'s
    limits; logloss and AUC within _METRIC_TOL of the one-position fit;
    50 `hist_tiled` a rank (default), 50 + 10 leaf sums
    `hist_tiled_fixed` (fixed). Then a second pair: rank 1 SIGKILLed
    mid-fit, and rank 0's HostLeases must declare it dead within
    MP_LEASE_S (+ _MP_KILL_SLACK_S)."""
    import dataclasses
    import pickle
    import tempfile

    import torch
    from mmlspark_tpu_torch.models.gbdt import fit_booster_distributed
    from mmlspark_tpu_torch.parallel import data_mesh

    x, y, staged, d_y = data["x"], data["y"], data["staged"], data["d_y"]
    params = _headline_params()
    pdict = dict(objective="binary", num_iterations=N_ITERS,
                 num_leaves=31, max_depth=DEPTH, max_bin=MAX_BIN,
                 min_data_in_leaf=20)
    per_fit = N_ITERS * DEPTH
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    try:
        t0 = time.perf_counter()
        np.save(os.path.join(tmp, "bins.npy"), staged[1].cpu().numpy())
        np.save(os.path.join(tmp, "y.npy"), y)
        with open(os.path.join(tmp, "mapper.pkl"), "wb") as f:
            pickle.dump(staged[0], f)
        save_s = time.perf_counter() - t0
        script = os.path.join(tmp, "rank.py")
        with open(script, "w") as f:
            f.write(_MP_PROC.format(here=HERE, ranks=MP_RANKS,
                                    lease=MP_LEASE_S, reps=FIT_REPEATS))
        # first this process alone on the card: the one-position fit and
        # the one-process two-position fits of the same data, warm
        noop = lambda *a, **k: None   # noqa: E731
        mesh2 = data_mesh(devices=[dev] * MP_RANKS)
        one = dataclasses.replace(params, num_iterations=1)
        for mesh_w in (data_mesh(devices=[dev]), mesh2):
            for kw in ({}, dict(checkpoint_fn=noop)):
                fit_booster_distributed(x, y, one, mesh=mesh_w,
                                        prebinned=staged, **kw)
        one_b, one_base, one_s, _ = _counted_fit(x, y, params, staged, dev,
                                                 dict(hist_tiled=per_fit))
        times2 = []
        for kw in [{}] * FIT_REPEATS + [dict(checkpoint_fn=noop)]:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fixed2, fixed2_base, _ = fit_booster_distributed(
                x, y, params, mesh=mesh2, prebinned=staged, **kw)
            torch.cuda.synchronize()
            times2.append(time.perf_counter() - t1)
        two_s, two_fixed_s = float(np.median(times2[:-1])), times2[-1]
        t0 = time.perf_counter()
        procs = _mp_spawn(script, "fit", tmp, pdict)
        _mp_reap(procs, 600)
        wall_s = time.perf_counter() - t0
        res = []
        for r in range(MP_RANKS):
            with open(os.path.join(tmp, f"out_{r}.json")) as f:
                res.append(json.load(f))
        fits = {name: [_mp_load(os.path.join(tmp, f"{name}_{r}.npz"))
                       for r in range(MP_RANKS)]
                for name in ("default", "fixed", "scale_out")}
        for name, boosters in fits.items():
            for r in range(1, MP_RANKS):
                if boosters[r][1] != boosters[0][1]:
                    raise AssertionError(f"[multiprocess] {name}: bases "
                                         f"differ between ranks")
                _mp_same(boosters[0][0], boosters[r][0],
                         f"{name} rank 0 against rank {r}")
        _mp_same(fits["fixed"][0][0], fixed2, "fixed-order fit against "
                 "the one-process two-position fit")
        if fits["fixed"][0][1] != fixed2_base:
            raise AssertionError("[multiprocess] fixed-order base differs")
        want = {"default": dict(hist_tiled=per_fit),
                "fixed": dict(hist_tiled_fixed=per_fit + N_ITERS),
                "scale_out": dict(hist_tiled_fixed=per_fit + N_ITERS)}
        for r, out in enumerate(res):
            for name, w in want.items():
                for run in out[name].get("runs", [out[name]]):
                    if run["launches"] != w:
                        raise AssertionError(
                            f"[multiprocess] rank {r} {name} launches "
                            f"{run['launches']}, expected {w}")
        # metrics of the ranks' default booster against the one-position
        # fit's, on the card
        booster, base = fits["default"][0]
        margin = booster.raw_score_device(x, device=dev)[:, 0] + base
        logloss, auc = _metrics(margin, d_y)
        one_margin = one_b.raw_score_device(x, device=dev)[:, 0] + one_base
        one_logloss, one_auc = _metrics(one_margin, d_y)
        if abs(logloss - one_logloss) > _METRIC_TOL or \
                abs(auc - one_auc) > _METRIC_TOL:
            raise AssertionError(
                f"[multiprocess] logloss/AUC {logloss}/{auc} against the "
                f"one-position fit's {one_logloss}/{one_auc}")
        # the scale-out form against the whole-table fixed-order fit
        sb, sbase = fits["scale_out"][0]
        fb, fbase = fits["fixed"][0]
        if not np.array_equal(sb.split_feature, fb.split_feature):
            raise AssertionError("[multiprocess] scale-out split features "
                                 "differ from the whole-table fit's")
        s_margin = sb.raw_score_device(x, device=dev)[:, 0] + sbase
        f_margin = fb.raw_score_device(x, device=dev)[:, 0] + fbase
        close = float(((s_margin - f_margin).abs()
                       <= _SCALE_OUT_MARGIN_ATOL).float().mean())
        s_logloss, _ = _metrics(s_margin, d_y)
        f_logloss, _ = _metrics(f_margin, d_y)
        if close < _SCALE_OUT_MARGIN_SHARE or \
                abs(s_logloss - f_logloss) > _SCALE_OUT_LOGLOSS_TOL:
            raise AssertionError(
                f"[multiprocess] scale-out margins within "
                f"{_SCALE_OUT_MARGIN_ATOL} for {close:.6f} of the rows, "
                f"logloss {s_logloss} against {f_logloss}")

        # the SIGKILL run: rank 1 killed mid-fit, rank 0's leases
        procs = _mp_spawn(script, "kill", tmp, pdict)
        try:
            line = ""
            deadline = time.monotonic() + 300
            while "FITTING" not in line and time.monotonic() < deadline:
                line = procs[1].stdout.readline()
                if not line and procs[1].poll() is not None:
                    break
            if "FITTING" not in line:
                raise AssertionError("[multiprocess] rank 1 never started "
                                     "its fit")
            time.sleep(2.0)                    # mid-fit
            procs[1].send_signal(signal.SIGKILL)
            killed = time.time()
            procs[1].wait()
            dead_file = os.path.join(tmp, "dead.json")
            while not os.path.exists(dead_file) and time.time() < \
                    killed + MP_LEASE_S + _MP_KILL_SLACK_S + 30:
                time.sleep(0.05)
            if not os.path.exists(dead_file):
                raise AssertionError("[multiprocess] rank 0 never declared "
                                     "rank 1 dead")
            with open(dead_file) as f:
                verdict = json.load(f)
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                pr.wait()
        detect_s = verdict["t"] - killed
        if verdict["dead"] != [1] or \
                detect_s > MP_LEASE_S + _MP_KILL_SLACK_S:
            raise AssertionError(f"[multiprocess] verdict {verdict} "
                                 f"{detect_s:.2f} s after the kill")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # per rank: the median of its default fits, and that fit's exchange
    med = [sorted(r["default"]["runs"], key=lambda run: run["s"])[
        len(r["default"]["runs"]) // 2] for r in res]
    d_s = [m["s"] for m in med]
    ex = [m["exchange"] for m in med]
    fixed_s = [r["fixed"]["runs"][0]["s"] for r in res]
    peak = [max(run["peak"] for run in r["default"]["runs"]
                + r["fixed"]["runs"]) for r in res]

    def per_rank(vals, fmt="{:.4f}"):
        return ", ".join(fmt.format(v) for v in vals)
    log(f"[multiprocess] {MP_RANKS} ranks under gloo on one card, one "
        f"position each: bins saved in {save_s:.2f} s; the ranks' pass "
        f"{wall_s:.1f} s with start-up; default fit per rank, median of "
        f"{FIT_REPEATS}: {per_rank(d_s)} s (all: "
        f"{'; '.join(per_rank([run['s'] for run in r['default']['runs']]) for r in res)})"
        f" against the one-process 2-position fit's {two_s:.4f} s (all: "
        f"{per_rank(times2[:-1])}) and one position's {one_s:.4f} s; "
        f"exchange per rank {per_rank([e['seconds'] for e in ex])} s in "
        f"{per_rank([e['calls'] for e in ex], '{}')} calls "
        f"({per_rank([e['bytes'] for e in ex], '{}')} B), share of the fit "
        f"{per_rank([e['seconds'] / s for e, s in zip(ex, d_s)], '{:.3f}')}"
        f" (copies to and from the card "
        f"{per_rank([e['copy_seconds'] for e in ex])} s, the collective "
        f"with the wait for the peer "
        f"{per_rank([e['gather_seconds'] for e in ex])} s; every run's "
        f"share: "
        f"{'; '.join(per_rank([run['exchange']['seconds'] / run['s'] for run in r['default']['runs']], '{:.3f}') for r in res)})"
        f", wait for the card before it "
        f"{per_rank([e['wait_seconds'] for e in ex])} s; 60 bare exchanges "
        f"of the deepest level's "
        f"{res[0]['bare_exchange']['bytes'] // 60 // MP_RANKS} B a rank, "
        f"back to back: {per_rank([r['bare_exchange']['seconds'] for r in res])}"
        f" s (copies "
        f"{per_rank([r['bare_exchange']['copy_seconds'] for r in res])} s)"
        f"; fixed order per "
        f"rank {per_rank(fixed_s)} s against {two_fixed_s:.4f} s, bit for "
        f"bit; scale-out {per_rank([r['scale_out']['s'] for r in res])} s,"
        f" margins within {_SCALE_OUT_MARGIN_ATOL} for {close:.6f} of the "
        f"rows; peak memory per rank "
        f"{per_rank([v / 2**20 for v in peak], '{:.1f}')} MiB; logloss "
        f"{logloss:.6f}, AUC {auc:.6f} (one position {one_logloss:.6f}, "
        f"{one_auc:.6f}); SIGKILLed rank 1 declared dead {detect_s:.2f} s "
        f"after the kill (lease {MP_LEASE_S} s)")
    return dict(launches=med[0]["launches"],
                fixed_launches=res[0]["fixed"]["runs"][0]["launches"],
                scale_out_launches=res[0]["scale_out"]["launches"],
                fit_s=d_s, fixed_s=fixed_s, two_pos_s=[two_s, two_fixed_s],
                one_s=one_s, exchange=ex, peak=peak, detect_s=detect_s,
                bare_exchange=[r["bare_exchange"] for r in res],
                auc=auc, logloss=logloss)


# ----------------------------------------------------- [multiprocess lm]
# slice 17: LM training over MP_RANKS gloo ranks on the one card, each
# configuration at the flagship width (`LM`) beside the same mesh shape
# in this one process. (a) GPipe stages across the ranks, two model
# positions a rank; (b) the data axis across the ranks; (c) the ring's
# seq axis across the ranks; (d) the model axis across the ranks, where
# no master has a replica on another rank (`replicas` False)
MPLM = {
    "a": dict(kind="pipelined", mesh=(1, 2, 2, 1), steps=3,
              batch=(PIPE_BATCH, LM_SEQ), microbatches=PIPE_MICROBATCHES),
    "b": dict(kind="sharded", mesh=SHARDED_MESH, steps=3,
              batch=STREAM_SHAPE),
    "c": dict(kind="pipelined", mesh=(1, 1, 1, 2), steps=2,
              batch=(1, LM_SEQ), microbatches=1),
    "d": dict(kind="pipelined", mesh=(1, 1, 2, 1), steps=2,
              batch=(1, LM_SEQ), microbatches=1, replicas=False),
}
# the ranks' losses against this process's: bf16 as `_PIPE_LOSS_TOL`,
# f32 as tests/test_torch_lm_training_pp.py's Adam trajectories
_MPLM_LOSS_TOL = {"a": _PIPE_LOSS_TOL, "b": 1e-5, "c": _PIPE_LOSS_TOL,
                  "d": _PIPE_LOSS_TOL}
# the updates of one SGD step at S=_TRAIN_CHECK_SEQ (a, c, d: the ranks'
# against this process's, per leaf over the larger update,
# `_update_disagreement`): PR 14's bf16 measurement of its meshes against
# (1, 1, 1, 1). Adam's final weights are no probe of the gradients: its
# first steps move each weight by about lr * sign(g), so a gradient that
# two sum orders round to opposite signs moves that weight 2 lr apart.
# (b), f32 Adam: per leaf, the L2 norm of the difference of the two runs'
# updates over the norm of this process's update
_MPLM_UPDATE_TOL = 1.54e-2
_MPLM_ADAM_F32_TOL = 1e-4
_MPLM_PROC = """
import json, os, sys
import torch
sys.path.insert(0, {here!r})
import chip_smoke
from mmlspark_tpu_torch.parallel import cluster

rank, tmp = int(sys.argv[1]), sys.argv[2]
cluster.initialize_cluster(init_method="file://" + os.path.join(tmp, "rdv"),
                           num_processes={ranks}, process_id=rank,
                           timeout_s=600)
assert cluster.backend_name() == "gloo", cluster.backend_name()
dev = cluster.local_device()
torch.cuda.set_device(dev)
out = chip_smoke._mplm_all(dev, True, tmp)
out["bare"] = chip_smoke._mplm_bare(dev, out["b"]["masters"])
with open(os.path.join(tmp, f"out_{{rank}}.json"), "w") as f:
    json.dump(out, f)
cluster.barrier("done")
cluster.shutdown()
"""


def _mplm_tokens(name):
    cfg = MPLM[name]
    if cfg["kind"] == "sharded":
        return _stream_batches(LM, cfg["batch"], cfg["steps"])
    toks = np.random.default_rng(0).integers(
        0, LM["vocab_size"], size=cfg["batch"]).astype(np.int32)
    return [toks] * cfg["steps"]


def _mplm_trainer(name, dev, span, **kw):
    """Configuration `name`'s trainer on its mesh of `dev`: over the
    ranks (`span`, this process's share of the positions) or all in this
    process."""
    from mmlspark_tpu_torch.models.dnn import (PipelinedLMTrainer,
                                               ShardedLMTrainer)
    from mmlspark_tpu_torch.parallel import grid_mesh
    cfg = MPLM[name]
    n = int(np.prod(cfg["mesh"]))
    devs = [dev] * (n // MP_RANKS if span else n)
    if cfg["kind"] == "sharded":
        return ShardedLMTrainer(mesh=grid_mesh(cfg["mesh"], devices=devs),
                                seed=0, **LM)
    return PipelinedLMTrainer(
        mesh=grid_mesh(cfg["mesh"], _PIPE_AXES, devices=devs),
        n_microbatches=cfg["microbatches"], attention="flash",
        remat="save_attn", compute_dtype="bfloat16", seed=0, **kw, **LM)


def _mplm_replicas(trainer):
    """blake2b of every master this process holds that another one holds
    too, by key and path."""
    import hashlib
    from mmlspark_tpu_torch.models.dnn.pp_training import _paths
    span = trainer._span
    return {f"{key}/{'/'.join(map(str, path))}": hashlib.blake2b(
        a.detach().cpu().numpy().tobytes()).hexdigest()
        for key, tree in trainer._blocks.trees.items()
        if len(span.replicas[key]) > 1 for path, a in _paths(tree)}


def _mplm_flat(trainer):
    """The full parameters (a collective over ranks): their
    `_named_leaves` names and host arrays."""
    names, arrays = zip(*((n, a.detach().to("cpu", copy=True).numpy())
                          for n, a in _named_leaves(trainer.params)))
    return list(names), list(arrays)


def _mplm_adam(name, dev, span, tmp):
    """Configuration `name`'s Adam steps: step 1 with the flash launch
    counts set to 0 just before and read just after, then the rest timed
    (s/step, peak memory, the exchange by primitive). Over the ranks also
    the replicated masters' digests; (b) writes its final parameters."""
    import torch
    from mmlspark_tpu_torch.ops import flash_attention as fa
    cfg = MPLM[name]
    t0 = time.perf_counter()
    trainer = _mplm_trainer(name, dev, span)
    init_s = time.perf_counter() - t0
    batches = _mplm_tokens(name)
    start = _mplm_flat(trainer) if name == "b" and not span else None
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    losses = [trainer.step(batches[0])]
    step1_s = time.perf_counter() - t0
    launches = dict(fa.launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if span:
        trainer.mesh.exchange.reset_stats()
    t0 = time.perf_counter()
    for toks in batches[1:]:
        losses.append(trainer.step(toks))
    torch.cuda.synchronize()
    timed = time.perf_counter() - t0
    out = dict(losses=losses, launches=launches, init_s=init_s,
               step1_s=step1_s, s_step=timed / (cfg["steps"] - 1),
               peak=torch.cuda.max_memory_allocated(),
               masters=sum(m.numel() for m in trainer._blocks.masters()))
    if span:
        out["exchange"] = trainer.mesh.exchange.stats()["primitives"]
        out["replicas"] = _mplm_replicas(trainer)
    if name == "b":
        names, final = _mplm_flat(trainer)
        if not span:
            out.update(names=names, start=start[1], final=final)
        elif trainer._span.rank == 0:
            np.savez(os.path.join(tmp, "b_final.npz"), *final)
    # a process's first torch.optim constructor leaves its caller's
    # frame (the trainer's __init__) in a reference cycle through a
    # lazy import, so only the collector frees that trainer: collected
    # here, the next configuration's peak is its own
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mplm_probe(name, dev, span, tmp):
    """One SGD step (lr 1) of configuration `name` at S=_TRAIN_CHECK_SEQ:
    the loss, the launches and the updated parameters (this process:
    kept with the start; the ranks: written by rank 0)."""
    import torch
    from mmlspark_tpu_torch.ops import flash_attention as fa
    cfg = MPLM[name]
    trainer = _mplm_trainer(name, dev, span, optimizer="sgd", lr=1.0)
    toks = np.random.default_rng(1).integers(
        0, LM["vocab_size"], size=(cfg["batch"][0], _TRAIN_CHECK_SEQ)
    ).astype(np.int32)
    start = None if span else _mplm_flat(trainer)[1]
    torch.cuda.synchronize()
    fa.reset_launches()
    loss = trainer.step(toks)
    out = dict(loss=loss, launches=dict(fa.launches))
    names, updated = _mplm_flat(trainer)
    if not span:
        out.update(names=names, start=start, updated=updated)
    elif trainer._span.rank == 0:
        np.savez(os.path.join(tmp, f"{name}_probe.npz"), *updated)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mplm_all(dev, span, tmp):
    """Every configuration's Adam steps and (a, c, d) its SGD probe, in
    this process or in a rank."""
    out = {}
    for name in MPLM:
        out[name] = _mplm_adam(name, dev, span, tmp)
        if MPLM[name]["kind"] == "pipelined":
            out[name]["probe"] = _mplm_probe(name, dev, span, tmp)
    return out


def _mplm_bare(dev, n):
    """The messages alone, between two ranks after a barrier: 10 round
    trips of one hop's activation ((1, LM_SEQ, d_model) bf16, 32 MiB)
    and 2 ordered sums of `n` f32 values (the whole model's gradient).
    Seconds each and the exchange's stats by primitive."""
    import torch
    from mmlspark_tpu_torch.parallel import cluster
    ex = cluster.Exchange()
    peer = 1 - ex.rank
    hop = torch.zeros((1, LM_SEQ, LM["d_model"]), dtype=torch.bfloat16,
                      device=dev)
    grads = torch.zeros(n, dtype=torch.float32, device=dev)
    cluster.barrier("bare")
    t0 = time.perf_counter()
    for i in range(10):
        if ex.rank == 0:
            ex.send(hop, peer, 2 * i)
            ex.recv(hop.shape, hop.dtype, dev, peer, 2 * i + 1)
        else:
            got = ex.recv(hop.shape, hop.dtype, dev, peer, 2 * i)
            ex.send(got, peer, 2 * i + 1)
        ex.wait_sends()
    hop_s = (time.perf_counter() - t0) / 10
    hop_stats = ex.stats()["primitives"]
    ex.reset_stats()
    t0 = time.perf_counter()
    for i in range(2):
        ex.ordered_sum(grads, range(MP_RANKS),
                       cluster.MessageTags.SUM_TAGS + i)
    sum_s = (time.perf_counter() - t0) / 2
    return dict(hop_bytes=hop.numel() * hop.element_size(),
                hop_round_trip_s=hop_s, hop=hop_stats,
                sum_bytes=grads.numel() * grads.element_size(),
                sum_s=sum_s, sum=ex.stats()["primitives"]["sum"])


def _mplm_flops(name):
    """bench.py's model FLOPs of one step of configuration `name`
    (`_lm_flops_per_step` at its sequence length, times its sequences)."""
    b, s = MPLM[name]["batch"]
    n, d = LM["n_layers"], LM["d_model"]
    fwd = (2 * s * n * (4 * d * d + 2 * d * LM["d_ff"])
           + 2 * s * d * LM["vocab_size"] + n * 2 * s * s * d)
    return 3 * fwd * b


def _mplm_launches(mplm, kernel):
    """`kernel`'s launches in one step of each [multiprocess lm]
    configuration, per rank, beside the one-process count."""
    return {f"multiprocess lm ({n}) step, per rank ({MP_RANKS} ranks; one "
            f"process {r['one_launches'][kernel]})":
            [g[kernel] for g in r["launches"]] for n, r in mplm.items()
            if MPLM[n]["kind"] == "pipelined"}


def multiprocess_lm_phase(dev):
    """[multiprocess lm]: the flagship LM over MP_RANKS gloo ranks on the
    card (`MPLM`): each configuration first in this process on a mesh of
    the same shape (`devices=[dev] * n`), then in the ranks. Per
    configuration: both ranks' losses equal and within `_MPLM_LOSS_TOL`
    of this process's, every replicated master bit-identical across the
    ranks, the ranks' flash launches of one step summing to this
    process's count, each rank launching; (a, c, d) one SGD step's updates
    within `_MPLM_UPDATE_TOL` of this process's, (b) the Adam updates'
    norms within `_MPLM_ADAM_F32_TOL`. Prints s/step per rank beside this
    process's, the exchange's seconds, bytes and share of the step
    (copies and wire), `lm_train_mfu` and peak memory per rank."""
    import tempfile

    import torch
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mplm_")
    try:
        t0 = time.perf_counter()
        one = _mplm_all(dev, False, tmp)
        one_s = time.perf_counter() - t0
        script = os.path.join(tmp, "rank.py")
        with open(script, "w") as f:
            f.write(_MPLM_PROC.format(here=HERE, ranks=MP_RANKS))
        torch.cuda.empty_cache()       # the card to the ranks
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, script, str(r), tmp], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(MP_RANKS)]
        _mp_reap(procs, 600)
        wall_s = time.perf_counter() - t0
        res = []
        for r in range(MP_RANKS):
            with open(os.path.join(tmp, f"out_{r}.json")) as f:
                res.append(json.load(f))
        saved = {}
        for name in [f"{n}_probe" for n, c in MPLM.items()
                     if c["kind"] == "pipelined"] + ["b_final"]:
            with np.load(os.path.join(tmp, f"{name}.npz")) as z:
                saved[name] = [z[f"arr_{i}"] for i in range(len(z.files))]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = {}
    for name, cfg in MPLM.items():
        want, got = one[name], [r[name] for r in res]
        tag = f"[multiprocess lm] ({name})"
        if got[1]["losses"] != got[0]["losses"]:
            raise AssertionError(f"{tag} the ranks' losses differ: "
                                 f"{got[0]['losses']} / {got[1]['losses']}")
        losses = got[0]["losses"]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"{tag} losses {losses}: not finite and "
                                 f"falling")
        loss_err = max(abs(a - b) for a, b in zip(losses, want["losses"]))
        if loss_err > _MPLM_LOSS_TOL[name]:
            raise AssertionError(f"{tag} losses {losses} against one "
                                 f"process's {want['losses']}")
        common = got[0]["replicas"].keys() & got[1]["replicas"].keys()
        if bool(common) != cfg.get("replicas", True) or any(
                got[0]["replicas"][k] != got[1]["replicas"][k]
                for k in common):
            raise AssertionError(f"{tag} replicated masters differ between "
                                 f"the ranks ({len(common)} shared)")
        summed = {k: sum(g["launches"][k] for g in got)
                  for k in want["launches"]}
        if summed != want["launches"] or (
                cfg["kind"] == "pipelined" and not all(
                    any(g["launches"].values()) for g in got)):
            raise AssertionError(f"{tag} launches per rank "
                                 f"{[g['launches'] for g in got]} against "
                                 f"one process's {want['launches']}")
        row = dict(losses=losses, one_losses=want["losses"],
                   loss_err=loss_err, replicas=len(common),
                   launches=[g["launches"] for g in got],
                   one_launches=want["launches"],
                   s_step=[g["s_step"] for g in got],
                   one_s_step=want["s_step"],
                   step1_s=[g["step1_s"] for g in got],
                   peak=[g["peak"] for g in got], one_peak=want["peak"],
                   exchange=[g["exchange"] for g in got])
        dtype = torch.float32 if cfg["kind"] == "sharded" else torch.bfloat16
        row["mfu"] = [_mplm_flops(name) / s / _peak_flops(dtype)
                      for s in row["s_step"]]
        row["one_mfu"] = _mplm_flops(name) / want["s_step"] / \
            _peak_flops(dtype)
        if cfg["kind"] == "pipelined":
            pw, pg = want["probe"], [g["probe"] for g in got]
            if pg[0]["loss"] != pg[1]["loss"] or \
                    abs(pg[0]["loss"] - pw["loss"]) > _PIPE_LOSS_TOL:
                raise AssertionError(f"{tag} SGD probe losses "
                                     f"{[p['loss'] for p in pg]} against "
                                     f"{pw['loss']}")
            worst, leaf, attn = _update_disagreement(
                pw["names"], [torch.as_tensor(a) for a in pw["start"]],
                [torch.as_tensor(a) for a in saved[f"{name}_probe"]],
                [torch.as_tensor(a) for a in pw["updated"]])
            if worst > _MPLM_UPDATE_TOL:
                raise AssertionError(f"{tag} SGD probe updates differ by "
                                     f"{worst:.3g} of the update ({leaf})")
            summed = {k: sum(p["launches"][k] for p in pg)
                      for k in pw["launches"]}
            if summed != pw["launches"]:
                raise AssertionError(f"{tag} SGD probe launches "
                                     f"{[p['launches'] for p in pg]} against "
                                     f"{pw['launches']}")
            row["probe"] = dict(worst=worst, leaf=leaf, attention=attn,
                                loss=pg[0]["loss"], one_loss=pw["loss"])
        else:
            worst, leaf = 0.0, None
            for nm, a0, ag, aw in zip(want["names"], want["start"],
                                      saved["b_final"], want["final"]):
                d = float(np.linalg.norm((ag - a0) - (aw - a0))) / max(
                    float(np.linalg.norm(aw - a0)), 1e-30)
                if d > worst:
                    worst, leaf = d, nm
            if worst > _MPLM_ADAM_F32_TOL:
                raise AssertionError(f"{tag} Adam updates differ by "
                                     f"{worst:.3g} in norm ({leaf})")
            row["adam_update_norm"] = dict(worst=worst, leaf=leaf)
        summary[name] = row
    for name, row in summary.items():
        ex = row["exchange"]
        prim = [sum(e[p]["seconds"] for p in ("send", "recv", "sum"))
                for e in ex]
        copy = [sum(e[p]["copy_seconds"] for p in ("send", "recv", "sum"))
                for e in ex]
        nbytes = [sum(e[p]["bytes"] for p in ("send", "recv", "sum"))
                  for e in ex]
        timed = [s * (MPLM[name]["steps"] - 1) for s in row["s_step"]]
        row["exchange_share"] = [p / t for p, t in zip(prim, timed)]
        probe = row.get("probe") or row.get("adam_update_norm")
        log(f"[multiprocess lm] ({name}) {MPLM[name]['kind']} mesh "
            f"{MPLM[name]['mesh']}, {MP_RANKS} gloo ranks on one card, "
            f"batch {MPLM[name]['batch']}: losses "
            f"{', '.join(f'{x:.6f}' for x in row['losses'])} on both ranks "
            f"(one process {', '.join(f'{x:.6f}' for x in row['one_losses'])}"
            f", largest difference {row['loss_err']:.3g}); {row['replicas']}"
            f" replicated masters bit-identical; s/step per rank "
            f"{', '.join(f'{x:.4f}' for x in row['s_step'])} (step 1 "
            f"{', '.join(f'{x:.2f}' for x in row['step1_s'])}) against one "
            f"process's {row['one_s_step']:.4f}; exchange per rank "
            f"{', '.join(f'{x:.4f}' for x in prim)} s over "
            f"{MPLM[name]['steps'] - 1} timed steps, "
            f"{', '.join(str(x) for x in nbytes)} B, share "
            f"{', '.join(f'{x:.3f}' for x in row['exchange_share'])} (copies "
            f"{', '.join(f'{x:.4f}' for x in copy)} s, the rest the wire and "
            f"the wait for the peer; by primitive "
            f"{[{p: round(e[p]['seconds'], 4) for p in ('send', 'recv', 'sum')} for e in ex]}"
            f"); lm_train_mfu per rank "
            f"{', '.join(f'{x:.4f}' for x in row['mfu'])} (one process "
            f"{row['one_mfu']:.4f}); peak memory per rank "
            f"{', '.join(f'{x / 2**30:.2f}' for x in row['peak'])} GiB (one "
            f"process {row['one_peak'] / 2**30:.2f}); flash launches of one "
            f"step per rank {row['launches']} = one process's "
            f"{row['one_launches']}; parameters {probe}")
    bare = [r["bare"] for r in res]
    hop_s = [b["hop_round_trip_s"] for b in bare]
    hop_copy = [sum(b["hop"][p]["copy_seconds"] for p in ("send", "recv"))
                / 10 for b in bare]
    sum_s = [b["sum_s"] for b in bare]
    sum_copy = [b["sum"]["copy_seconds"] / 2 for b in bare]
    log(f"[multiprocess lm] the messages alone, after a barrier: a "
        f"{bare[0]['hop_bytes']} B hop there and back "
        f"{', '.join(f'{x:.4f}' for x in hop_s)} s per rank (copies "
        f"{', '.join(f'{x:.4f}' for x in hop_copy)} s); an ordered sum of "
        f"{bare[0]['sum_bytes']} B {', '.join(f'{x:.4f}' for x in sum_s)} "
        f"s per rank (copies {', '.join(f'{x:.4f}' for x in sum_copy)} s)")
    log(f"[multiprocess lm] this process's runs {one_s:.1f} s, the ranks' "
        f"{wall_s:.1f} s with start-up")
    return summary


def only_phase(name, dev, phase, t_start) -> int:
    """`--only NAME`: one phase after card and build (with the headline
    data where it needs them), for runs that iterate on that phase; the
    full run stays the proof run."""
    import torch
    needs_data = {"main": lambda d, data: main_path_phase(d, data, False),
                  "planes path": planes_path_phase,
                  "boosting modes": modes_phase,
                  "data_parallel": data_parallel_phase,
                  "multiprocess": multiprocess_phase}
    alone = {"kernel": kernel_phase, "planes kernel": planes_kernel_phase,
             "flash kernel": flash_kernel_phase,
             "flash backward kernel": flash_bwd_kernel_phase,
             "stats kernel": stats_kernel_phase,
             "stats backward": stats_bwd_kernel_phase,
             "ranker": ranker_phase, "stream train": stream_train_phase,
             "multiprocess_lm": multiprocess_lm_phase}
    if name in needs_data:
        data = phase("headline data", headline_data, dev)
        phase(name, needs_data[name], dev, data)
    elif name in alone:
        phase(name, alone[name], dev)
    else:
        raise SystemExit(f"--only {name!r}: one of "
                         f"{sorted(set(needs_data) | set(alone))}")
    log(f"[only] {name}: {time.perf_counter() - t_start:.1f} s in all")
    torch.cuda.synchronize()
    return 0


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
    phase_s = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        log(f"[time] {name}: {phase_s[name]:.1f} s")
        return out
    smi, card = phase("card", card_phase)
    build = phase("build", build_phase)
    dev = torch.device("cuda")
    profile = "--profile" in argv
    if "--only" in argv:
        return only_phase(argv[argv.index("--only") + 1], dev, phase,
                          t_start)
    kres = phase("kernel", kernel_phase, dev)
    parent = argv[argv.index("--versus") + 1] if "--versus" in argv else None
    pres = phase("planes kernel", planes_kernel_phase, dev, parent)
    fres = phase("flash kernel", flash_kernel_phase, dev)
    bres = phase("flash backward kernel", flash_bwd_kernel_phase, dev)
    sres = phase("stats kernel", stats_kernel_phase, dev)
    sbres = phase("stats backward", stats_bwd_kernel_phase, dev)
    if "--sweep" in argv:
        phase("sweep", sweep_phase, dev)
    data = phase("headline data", headline_data, dev)
    paths = phase("main", main_path_phase, dev, data, profile)
    planes = phase("planes path", planes_path_phase, dev, data)
    modes = phase("boosting modes", modes_phase, dev, data)
    cat = phase("categorical", categorical_phase, dev, data,
                paths["fit_times"], profile)
    resume = phase("resume", resume_phase, dev, data, paths["fit_times"])
    intro = phase("introspect", introspect_phase, dev, data, paths, cat)
    dp = phase("data_parallel", data_parallel_phase, dev, data)
    mp = phase("multiprocess", multiprocess_phase, dev, data)
    ingest = phase("ingest", ingest_phase, dev, data, paths, resume)
    del data
    torch.cuda.empty_cache()
    ranker = phase("ranker", ranker_phase, dev)
    torch.cuda.empty_cache()
    enc_paths = phase("encoder", encoder_phase, dev, profile)
    train = phase("lm training", lm_train_phase, dev, profile)
    ring = phase("ring training", ring_train_phase, dev, train["losses"][0],
                 profile)
    pipe = phase("pipe training", pipe_train_phase, dev, train)
    stream = phase("stream train", stream_train_phase, dev)
    mplm = phase("multiprocess lm", multiprocess_lm_phase, dev)
    if "--versus" in argv:
        phase("versus", versus_phase, parent)

    hist8 = [r for r in kres if r["m"] == 8][0]
    planes4 = [r for r in pres if r["m"] == 4 and r["b"] == MAX_BIN + 1][0]
    main_flash = [r for r in fres if r["case"] == "main"
                  and r["dtype"] == "float32" and not r["causal"]][0]
    # the training path's shape: bf16, causal
    main_flash_bf16 = [r for r in fres if r["case"] == "main"
                       and r["dtype"] == "bfloat16" and r["causal"]][0]

    def fwd_build(form):
        return dict(
            build={k: v for k, v in build["fwd"]["sass"].items()
                   if k.startswith(form + " ")},
            occupancy={k: v for k, v in build["fwd"]["occupancy"].items()
                       if k.startswith(form + " ")})
    src = "mmlspark_tpu_torch/ops/csrc/histogram.cu"
    kernels = [
        dict(name="hist_tiled", route="cuda", source=src,
             replaces="mmlspark_tpu/ops/histogram_pallas.py:172 "
                      "(_hist_kernel; pallas_call :438) and :216 "
                      "(_hist_kernel_joint; pallas_call :421); "
                      "mmlspark_tpu/ops/histogram.py:32 (_xla_hist, the "
                      "route past M_MAX)",
             path="headline fit", launches=paths["launches"]["hist_tiled"],
             launches_per_path={"headline_fit": paths["launches"][
                 "hist_tiled"], "max_depth=11 fit": paths["deep_launches"][
                 "hist_tiled"], "categorical fit": cat["launches"][
                 "hist_tiled"], "categorical pipeline fit": cat["pipeline"][
                 "launches"]["hist_tiled"],
                 "data_parallel fit (4 positions)": dp["launches"][
                     "hist_tiled"],
                 "voting_parallel fit (4 positions)": dp["launches"][
                     "hist_tiled"],
                 "data_parallel planes fit (4 positions)": dp[
                     "planes_launches"]["hist_tiled"],
                 "ingest fit": ingest["launches"]["hist_tiled"],
                 "out-of-core fit": ingest["oofit_launches"]["hist_tiled"],
                 "multiprocess fit (per rank, 2 ranks on one card)": mp[
                     "launches"]["hist_tiled"]},
             passed=True,
             **{k: hist8[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "library_ms")},
             shape=dict(n=hist8["n"], f=hist8["f"], b=hist8["b"], m=8),
             build={k: v for k, v in build["hist"].items() if k != "planes"},
             per_m=[{k: r[k] for k in ("m", "b", "ms", "plain_ms",
                                       "library_ms", "bound_ms",
                                       "max_abs_err", "plan")}
                    for r in kres]),
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
             bf16_causal={k: main_flash_bf16[k] for k in (
                 "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                 "max_abs_err", "bf16_limit_used")},
             **fwd_build("normalized"),
             launches_per_path={**{k: v["launches"]
                                   for k, v in enc_paths.items()},
                                "lm_train_step": train["per_step"][
                                    "flash_fwd"],
                                "pipe_train_step": pipe["per_step"][
                                    "flash_fwd"],
                                "pipe_train_run": pipe["launches"][
                                    "flash_fwd"],
                                **_mplm_launches(mplm, "flash_fwd")},
             pipe_h4={k: pipe["kernels"]["fwd"].get(k) for k in (
                 "sq", "h", "d", "dtype", "causal", "ms", "plain_ms",
                 "library_ms", "bound_ms", "bound_by", "max_abs_err",
                 "bf16_limit_used")},
             variants=[{k: r.get(k) for k in (
                 "d", "dtype", "causal", "ms", "plain_ms", "library_ms",
                 "bound_ms", "split3_bound_ms", "max_abs_err",
                 "bf16_limit_used")}
                 for r in fres if "ms" in r]),
        dict(name="hist_planes", route="cuda", source=src,
             replaces="mmlspark_tpu/ops/histogram_pallas.py:259 "
                      "(_hist_kernel_planes; pallas_call :397)",
             path="headline fit under MMLSPARK_TPU_HIST=planes, bagging "
                  "0.8/1, feature_fraction 0.8",
             launches=planes["launches"]["hist_planes"], passed=True,
             launches_per_path={"planes headline fit": planes["launches"][
                 "hist_planes"], "categorical planes fit": cat[
                 "planes_launches"]["hist_planes"],
                 "data_parallel planes fit (4 positions)": dp[
                     "planes_launches"]["hist_planes"]},
             **{k: planes4[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")},
             library="one index_add_ of the bf16-rounded stats",
             shape=dict(n=planes4["n"], f=planes4["f"], b=planes4["b"],
                        lo=planes4["lo"], m=4),
             build=build["hist"]["planes"],
             per_m=[{k: r[k] for k in ("m", "b", "lo", "ms", "parent_ms",
                                       "tiled_ms", "plain_ms", "library_ms",
                                       "bound_ms", "sector_floor_ms", "tc_ms",
                                       "max_abs_err", "vs_tiled")}
                    for r in pres]),
    ]
    # the fixed-order forms: the headline's m=8 level and the planes
    # form's m=4 level at 64 bins, as for their atomic kernels
    fixed8 = [r for r in resume["kernels"] if r["kind"] == "tiled"
              and r["m"] == 8 and r["b"] == MAX_BIN + 1][0]
    fixed_planes4 = [r for r in resume["kernels"] if r["kind"] == "planes"
                     and r["m"] == 4 and r["b"] == MAX_BIN + 1][0]
    for name, row, replaces, path, launches in (
            ("hist_tiled_fixed", fixed8, kernels[0]["replaces"],
             "checkpointed headline fit (bagging 0.8/1, feature_fraction "
             "0.8): its levels and leaf sums",
             resume["cost"]["launches"]["hist_tiled_fixed"]),
            ("hist_planes_fixed", fixed_planes4, kernels[2]["replaces"],
             "checkpointed GBDTClassifier headline fit under "
             "MMLSPARK_TPU_HIST=planes",
             resume["routes"]["planes"]["launches"]["hist_planes_fixed"])):
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            path=path, launches=launches, passed=True,
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
            atomic_ms=row["atomic_ms"], scratch_bytes=row["scratch_bytes"],
            plan=row["plan"], shape=dict(n=row["n"], f=row["f"], b=row["b"],
                                         m=row["m"]),
            launches_per_path={
                **{r: v["launches"].get(name, 0)
                   for r, v in resume["routes"].items()},
                "checkpointed data_parallel fit (4 positions)":
                    dp["fixed_launches"].get(name, 0),
                "out-of-core checkpointed fit": ingest["estimator"][
                    "launches"].get(name, 0),
                "out-of-core checkpointed fit, resumed after SIGTERM":
                    ingest["estimator"]["resumed_launches"].get(name, 0),
                "multiprocess fixed-order fit (per rank, 2 ranks)":
                    mp["fixed_launches"].get(name, 0),
                "multiprocess scale-out fit (per rank, 2 ranks)":
                    mp["scale_out_launches"].get(name, 0)},
            per_case=[{k: r[k] for k in (
                "kind", "n", "f", "b", "m", "ms", "atomic_ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by", "max_abs_err",
                "scratch_bytes")} for r in resume["kernels"]
                if r["kernel"] == name]))
    # the ring training path's pair: the diagonal, bf16 (the full pairs'
    # times are in `variants`)
    diag = [r for r in sres["pairs"] if r["pair"] == "diagonal"
            and r["dtype"] == "bfloat16"][0]
    ring_path = (f"PipelinedLMTrainer.run, {LM_STEPS} steps, flagship LM "
                 f"bf16 at {LM_SEQ} tokens on a {RING_MESH} mesh of one card")
    kernels.append(dict(
        name="flash_stats_fwd", route="cuda",
        source="mmlspark_tpu_torch/ops/csrc/flash_attention.cu",
        replaces="mmlspark_tpu/ops/flash_attention.py:87 (_flash_kernel, "
                 "stats form; pallas_call :373 in _flash_stats_forward)",
        path=ring_path, launches=ring["launches"]["flash_stats_fwd"],
        launches_per_step=ring["per_step"]["flash_stats_fwd"], passed=True,
        launches_per_path=_mplm_launches(mplm, "flash_stats_fwd"),
        **{k: diag[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")},
        library="one scaled_dot_product_attention (normalized output) on "
                "the same pair",
        shape=dict(s_loc=STATS_SHARD, h=STATS_H, d=STATS_D, dtype="bfloat16",
                   q_off=diag["q_off"], k_off=diag["k_off"], causal=True),
        merged=sres["merged"],
        **fwd_build("stats"),
        variants=[{k: r.get(k) for k in (
            "pair", "dtype", "q_off", "k_off", "causal", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "split3_bound_ms",
            "max_abs_err", "limit_used", "flagged_rows")}
            for r in sres["pairs"]]))
    # the training path's shape: S=16384, H=8, D=128, bf16, causal
    main_bwd = [r for r in bres if r["case"] == "main"
                and r["dtype"] == "bfloat16" and r["causal"]][0]
    bwd_src = "mmlspark_tpu_torch/ops/csrc/flash_attention_bwd.cu"
    for kname, key, replaces in (
            ("flash_bwd_dq", "dq", "mmlspark_tpu/ops/flash_attention.py:478 "
             "(_flash_bwd_dq_kernel; pallas_call :621 in _flash_backward)"),
            ("flash_bwd_dkv", "dkv", "mmlspark_tpu/ops/flash_attention.py:516"
             " (_flash_bwd_dkv_kernel; pallas_call :642 in "
             "_flash_backward)")):
        kernels.append(dict(
            name=kname, route="cuda", source=bwd_src, replaces=replaces,
            path=f"PipelinedLMTrainer.run, {LM_STEPS} steps, flagship LM "
                 f"bf16 at {LM_SEQ} tokens",
            launches=train["launches"][kname],
            launches_per_step=train["per_step"][kname],
            launches_per_path={"lm_train_step": train["per_step"][kname],
                               "lm_train_f32_step":
                                   train["f32"]["per_step"][kname],
                               "ring_train_step": ring["per_step"][kname],
                               "ring_train_run": ring["launches"][kname],
                               "pipe_train_step": pipe["per_step"][kname],
                               "pipe_train_run": pipe["launches"][kname],
                               **_mplm_launches(mplm, kname)},
            pipe_h4={k: pipe["kernels"]["bwd"].get(k) for k in (
                "sq", "h", "d", "dtype", "causal", f"{key}_ms", "plain_ms",
                "library_ms", f"{key}_bound_ms", f"{key}_bound_by",
                "max_abs_err", "limit_used")},
            passed=True,
            max_abs_err=main_bwd["max_abs_err"], ms=main_bwd[f"{key}_ms"],
            plain_ms=main_bwd["plain_ms"],
            bound_ms=main_bwd[f"{key}_bound_ms"],
            bound_by=main_bwd[f"{key}_bound_by"],
            library_ms=main_bwd["library_ms"],
            library="one scaled_dot_product_attention backward (dq, dk, dv)",
            build={k: v for k, v in build["bwd"]["sass"].items()
                   if k.startswith(key + " ")},
            occupancy={k: v for k, v in build["bwd"]["occupancy"].items()
                       if k.startswith(key + " ")},
            shape=dict(s=LM_SEQ, h=main_bwd["h"], d=main_bwd["d"],
                       dtype="bfloat16", causal=True),
            variants=[{k: r.get(k) for k in (
                "d", "dtype", "causal", "dq_ms", "dkv_ms", "plain_ms",
                "library_ms", "bound_ms", "dq_bound_ms", "dkv_bound_ms",
                "split3_bound_ms", "dq_split3_bound_ms",
                "dkv_split3_bound_ms", "max_abs_err", "limit_used")}
                for r in bres if "dq_ms" in r],
            ring_pairs=[{k: r.get(k) for k in (
                "pair", "dtype", "q_off", "k_off", "causal", f"{key}_ms",
                "plain_ms", "library_ms", f"{key}_bound_ms",
                f"{key}_bound_by", f"{key}_split3_bound_ms", "max_abs_err",
                "limit_used")} for r in sbres]))
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} never launched on the main "
                                 f"path")
    log(f"[train] lm_train_mfu {train['mfu']:.4f}, "
        f"{train['s_step']:.4f} s/step, {train['tokens_per_s']:.4g} "
        f"tokens/s, peak {train['peak'] / 2**30:.2f} GiB; f32 compute "
        f"{train['f32']['s_step']:.4f} s/step, "
        f"{train['f32']['tokens_per_s']:.4g} tokens/s, peak "
        f"{train['f32']['peak'] / 2**30:.2f} GiB")
    log(f"[ring train] mesh {RING_MESH}: lm_train_mfu {ring['mfu']:.4f}, "
        f"{ring['s_step']:.4f} s/step, {ring['tokens_per_s']:.4g} "
        f"tokens/s, peak {ring['peak'] / 2**30:.2f} GiB; encoder ring "
        f"encode {enc_paths['ring']['s']:.3f} s")
    log(f"[pipe train] mesh {PIPE_MESH}: lm_train_mfu {pipe['mfu']:.4f}, "
        f"{pipe['s_step']:.4f} s/step, {pipe['tokens_per_s']:.4g} tokens/s, "
        f"peak {pipe['peak'] / 2**30:.2f} GiB; flash at "
        f"{LM['n_heads'] // PIPE_MESH[2]} heads: "
        f"fwd {pipe['kernels']['fwd']['ms']:.3f} ms, dq "
        f"{pipe['kernels']['bwd']['dq_ms']:.3f} ms, dk/dv "
        f"{pipe['kernels']['bwd']['dkv_ms']:.3f} ms")
    log(f"[gbdt] headline fit min {min(paths['fit_times']):.4f} s, median "
        f"{float(np.median(paths['fit_times'])):.4f} s; planes fit "
        f"{planes['fit_s']:.4f} s; " + ", ".join(
            f"{k} {v['fit_s']:.4f} s" for k, v in modes.items())
        + f"; ranker {ranker['fit_s']:.3f} s, NDCG@10 "
        f"{ranker['ndcg'][-1]:.6f}; categorical median {cat['fit_s']:.4f} "
        f"s, AUC {cat['auc']:.6f} (ordinal twin {cat['ordinal_auc']:.6f}), "
        f"planes {cat['planes_s']:.4f} s; pipeline save "
        f"{cat['pipeline']['save_s']:.4f} s, load "
        f"{cat['pipeline']['load_s']:.4f} s, {cat['pipeline']['bytes']} "
        f"bytes")
    med = resume["cost"]["medians"]
    log(f"[resume] checkpointed headline fit median {med['written']:.4f} s "
        f"(fixed order alone {med['fixed_only']:.4f} s) against the "
        f"default fit's {med['default']:.4f} s; save "
        f"{resume['cost']['save_s']:.4f} s, {resume['cost']['save_bytes']} "
        f"bytes; bit-identical resume on "
        f"{', '.join(resume['routes'])}; LM save "
        f"{resume['lm']['save_s']:.2f} s, restore "
        f"{resume['lm']['restore_s']:.2f} s, {resume['lm']['bytes']} bytes")
    log(f"[introspect] SHAP rows/s on the card: " + ", ".join(
        f"{k} {v['shap_rows_per_s']:.4g} (peak {v['shap_peak'] / 2**20:.1f} "
        f"MiB, busy {100 * v['shap_kernel_s'] / v['shap_s']:.1f}%, "
        f"{v['shap_err']:.3g} from the oracle)" for k, v in
        intro.items()) + "; predict_leaf rows/s: " + ", ".join(
        f"{k} {v['leaf_rows_per_s']:.4g}" for k, v in intro.items()))
    log(f"[data_parallel] {DP_POSITIONS} positions on one card: median "
        f"{float(np.median(dp['dp_times'])):.4f} s a fit against the "
        f"one-position fit's {float(np.median(dp['one_times'])):.4f} s; "
        f"AUC {dp['auc']:.6f} / {dp['one_auc']:.6f}; voting "
        f"{dp['voting_s']:.4f} s, AUC {dp['voting_auc']:.6f}; planes "
        f"{dp['planes_s']:.4f} s; fixed order "
        f"{', '.join(f'{t:.4f}' for t in dp['fixed_s'])} s, resume "
        f"{dp['resume_s']:.4f} s, bit for bit")
    est = ingest["estimator"]
    log(f"[ingest] stage_binned {ingest['stage_s']:.3f} s against the "
        f"serial card path's {ingest['serial_s']:.3f} s (card idle "
        f"{100 * ingest['idle']:.2f}% of the staging); ChunkStager "
        f"{ingest['oocore_s']:.3f} s, {ingest['n_chunks']} chunks, resident "
        f"{ingest['resident']:.0f} bytes; ingest fit {ingest['fit_s']:.3f} "
        f"s, out-of-core fit {ingest['oofit_s']:.3f} s; out-of-core "
        f"estimator {est['full_s']:.3f} s, killed at cursor "
        f"{est['kill_cursor']} and resumed bit for bit")
    log(f"[stream train] run_stream {stream['stream_s']:.4f} s/step "
        f"({stream['tokens_per_s']:.4g} tokens/s, {stream['stalls']} "
        f"stalls) against step() {stream['step_s']:.4f}; supervised "
        f"{stream['sup_s']:.4f} s/step, {stream['writes']} checkpoint writes "
        f"of {stream['save_s']:.2f} s; crash and SIGTERM resumes bit for "
        f"bit")
    log(f"[multiprocess] {MP_RANKS} ranks: default fit "
        f"{', '.join(f'{v:.4f}' for v in mp['fit_s'])} s against the "
        f"one-process 2-position fit's {mp['two_pos_s'][0]:.4f} s; "
        f"exchange share "
        f"{', '.join(f'{e_s:.3f}' for e_s in (e['seconds'] / v for e, v in zip(mp['exchange'], mp['fit_s'])))}; "
        f"peak {', '.join(f'{v / 2**20:.1f}' for v in mp['peak'])} MiB; "
        f"death by lease in {mp['detect_s']:.2f} s")
    log("[multiprocess lm] " + "; ".join(
        f"({n}) s/step per rank {', '.join(f'{x:.4f}' for x in r['s_step'])}"
        f" against one process's {r['one_s_step']:.4f}, exchange share "
        f"{', '.join(f'{x:.3f}' for x in r['exchange_share'])}, "
        f"lm_train_mfu {', '.join(f'{x:.4f}' for x in r['mfu'])}, peak "
        f"{', '.join(f'{x / 2**30:.2f}' for x in r['peak'])} GiB"
        for n, r in mplm.items()))
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all; phases "
        + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
