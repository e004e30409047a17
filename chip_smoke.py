#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mmlspark_tpu_torch`) on one card.

    python3 chip_smoke.py            # the check: needs one CUDA card
    python3 chip_smoke.py --profile  # also prints torch.profiler tables
                                     # of one boosting iteration (numeric
                                     # and categorical), of one flash
                                     # encode_long and of one LM
                                     # training step (bf16 and f32)
                                     # without and with the ring, and
                                     # counts one LR fit's launches
                                     # ([automl], in a process of its
                                     # own)
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
     data, each on the first `RESUME_ROUTE_ROWS` rows: two uninterrupted
     checkpointed `GBDTClassifier` fits, a 6 -> 10 resume, and a
     subprocess SIGTERMed after its second checkpoint and resumed in a
     fresh process (the three routes' processes at once), margins,
     split_feature, threshold and leaf_value all equal bit for bit. The flagship-width bf16 LM at 2 of
     its 12 layers (cut to pay for [fleet] and [cyber]): two steps,
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
     at 4 of its 12 layers (bf16, Adam, remat="save_attn", flash) on a
     (data, pipe, model, seq) = (1, 4, 2, 1) mesh of one card, tokens
     (2, 16384) in two microbatches: one step with exactly 16
     `flash_fwd`, 16 `flash_bwd_dq` and 16 `flash_bwd_dkv` launches
     (layers x model positions x sequences), then `run` of 3
     timed steps (s/step, tokens/s, `lm_train_mfu`, peak memory, a
     falling loss) beside the one-position [train] step; one SGD step at
     S=2048 on (1, 4, 2, 1) and (1, 2, 2, 2) against (1, 1, 1, 1), f32
     and bf16, updated weights within `_TRAIN_TOL`, losses within
     `_PIPE_LOSS_TOL`, launches exact; `ShardedLMTrainer` at the same
     width and depth on a (2, 2) data x model mesh, f32, 3 Adam steps within rtol
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
  17. stream train (slice 15): `ShardedLMTrainer` at the flagship width
     and 2 of its 12 layers (cut to pay for [fleet] and [automl]), f32,
     dense, on 12 seeded (4, 2048) batches: `run_stream(prefetch=2)`
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
  19. multiprocess lm (slice 17): the flagship LM (the pipelined
     configurations at 2 of its 12 layers, 4 before [images]) over 2 gloo
     ranks on the card,
     each configuration of `MPLM` first in this process on a
     mesh of the same shape (`devices=[dev] * n`), then in the ranks: (a)
     `PipelinedLMTrainer` bf16, Adam, flash, remat="save_attn" on
     (data, pipe, model, seq) = (1, 2, 2, 1), two (1, 16384) sequences in
     two microbatches, 2 steps (3 before [cyber]), the pipe axis across
     the ranks; (b)
     `ShardedLMTrainer` f32 dense on (2, 2), [stream train]'s seeded
     (4, 2048) batches, 2 steps (3 before [cyber]), the data axis
     across the ranks; (c)
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
  20. dnn (slice 18; no kernel of its own: convolutions, pooling and
     norms are torch ops on cuDNN), with PyTorch's default cuDNN TF32
     flag ON so the port must scope TF32 off itself: (a)
     `ImageFeaturizer(model_name="resnet50")` at 224 x 224 on 1,024
     seeded 256 x 256 uint8 images (the antialiased resize on the card),
     batch 32, bf16 and f32: images/s after one warm-up pass, s per
     batch, peak memory, the conv work (4.1 GMAC an image) as TFLOP/s
     against the dense peak; f32 features of 8 images within
     `_DNN_F32_TOL` of the port's CPU path (the same forward with the
     port's TF32 scope taken out must fail it), bf16 within
     `_DNN_BF16_TOL` of f32, the card's resize equal to the CPU's bit for
     bit; (b) tests/data/torch_resnet.py's seeded ResNet-18 exported as
     ONNX at 224: `load_onnx` on the card within `_ONNX_TOL` of torch's
     forward of the module (TF32 off), then `ImageFeaturizer(onnx_model=)`
     512-d features, images/s; (c) `DeepTransferClassifier` head mode on
     ResNet-50 at 224 (512 colour-coded images of 10 classes, 5 epochs)
     and full mode on ResNet-18 at 32 (1,024 images, 3 epochs): fit s,
     falling per-epoch losses, train accuracy above chance by
     `_TRANSFER_MARGIN`, transform images/s, equal probabilities after a
     save and load; (d) a `DNNModel` of ResNet-18 bf16 at 224 saved as a
     torch.export program on the card and loaded: equal outputs.
  21. serving (slice 19; no kernel of its own: GBDT scores on the host
     plan, the encoder's dense attention and the ResNet on cuBLAS/cuDNN):
     `serve_pipeline` over localhost HTTP, driven by the port's
     `io.loadgen.run_load`. (a) bench.py's serving model,
     `GBDTClassifier(num_iterations=20, max_depth=5)` fit on the card on
     20,000 x 16 seeded rows (`hist_tiled` counted over the fit):
     microbatch, max_batch 256, linger 0, 16 clients x 125 requests;
     continuous, 4 x 250; 100 serial requests: req/s, p50/p99, the
     `serving.request.{queue,transform,reply,e2e}` percentiles, plan hits
     and misses (misses equal the distinct buckets), peak memory. 512
     distinct rows each served equal the card's offline `transform`
     (labels equal, probabilities within `_SERVE_PROBA_TOL`); a hot-swap
     to a second fit during load and one `inject_fault` mid-load drop no
     request. (b) `TransformerSentenceEncoder` at its default Params on
     the card, 256 documents of 16-512 words from 8 clients: each reply
     within `_SERVE_EMB_TOL` of the offline transform. (c) a ResNet-18
     f32 `DNNModel` served on 2 partitions with the TF32 flag ON: every
     reply within `_SERVE_DNN_TOL` (relative) of the single-threaded
     output, which the forward with the TF32 scope taken out misses.
     Any reply that is not 200 and was not asked for fails the run.
  22. fleet (slice 20; no kernel of its own: gathers, cuBLAS products
     and torch top-k; every kernel's launch count must stand still across
     the phase): (a) `IsolationForestScorer` with the reference's defaults
     (100 trees of 256 samples) on 1,000,000 x 16 seeded rows with 1%
     shifted outliers, supervised with a checkpoint every 25 trees: every
     row scored on the card, 65,536 within rtol 1e-6 of the CPU path, the
     outliers' AUC above 0.9, served replies equal to `transform`; (b)
     `SARServing` (jaccard, support 2, 30-day decay) on MovieLens-1M-shaped
     events (6,040 users, 3,706 items, 1,000,209 ratings, Zipf popularity,
     three years): two fits on the card bit-identical, top-10 for every
     user on a 1- and a 4-position mesh equal, 512 users against float64
     numpy up to ties; (c) `KNN` and `ConditionalKNN` (100,000 x 128, 8,192
     queries, k = 10, 16 labels) with cuBLAS's TF32 flag ON outside the
     port's scope: 512 queries within rtol 1e-5 of the CPU path, indices
     equal up to ties; (d) `start_distributed_serving` on two gloo ranks
     of the card serving the SAR model's id-keyed plan: 500 requests
     (2,000 before [cyber])
     from a `RegistryClient` (every reply 200 and equal to the card's
     plan, both ranks serving), a worker death on rank 1 healed by replay,
     `scrape_cluster(versions=True)`'s merged count equal to the
     client's, `rollout_skew` after a swap on rank 1 alone, and rank 1
     SIGTERMed under `drain_on_signal`: out of the registry, the client's
     later requests failing over and answered. req/s, p50, p99.
  23. online (slice 21; no kernel of its own: gathers, sorts and
     segmented sums; every kernel's launch count must stand still across
     the phase): (a) VW on the Criteo display-ads layout (13 integer and
     26 categorical features, 1,000,000 seeded rows of 39 pairs at 18
     bits, a 100,000-row holdout): the adaptive classifier twice (bit for
     bit, within 1e-5 of max |w| of the CPU fit on 50,000 rows, the
     launches of one batch and the card's busy time counted in a process
     of its own, the batch loop timed alone), over 4 positions of the
     card, an sgd + l1 regressor (each within 1e-4 of the CPU fit on
     50,000 rows), BFGS at 25 iterations (at 6, within 1e-4 of the CPU
     fit), each holdout AUC over 0.7, a contextual bandit's
     `parallel_fit` of 4 policies at 200,000 rows (each policy's holdout
     AUC over 0.55), fit s, rows/s, holdout logloss and AUC, peak memory;
     a `Pipeline` of the featurizer (its pairs equal to the hashed rows)
     and a classifier on 20,000 string rows, saved, loaded, equal; (b)
     bench.py::_bench_online's 4-pass incumbent served with
     fast_path=True (the sparse-pair kernel) and False, 16 x 125,
     max_batch 128: req/s, p50/p99, plan misses equal to the buckets, 512
     replies on rows whose slots vary equal to `transform`, the kernel's
     margins within 1e-5 of max |m| of `predict_vw` on the CPU; (c) 64
     chunks of 256 through two `OnlineLearner`s, bit-identical; (d) 72
     requests with a 5-sigma shift, one `ContinuousLearner.run_once` to a
     promotion with 0 dropped, a crash-retried refit equal to the clean
     run, a poisoned candidate rolled back.
  24. automl (slice 22; no kernel of its own but the GBDT learner's
     `hist_tiled`: the linear fits, the lasso and `to_dense` are torch
     ops, and the flash counts must stand still): a seeded table shaped
     like Adult Census Income, 1,000,000 rows (six numeric columns with
     NaNs, eight string categoricals at Adult's cardinalities, a string
     label about 24% ">50K"), split 80/20. (a) `TrainClassifier` with the
     default `LogisticRegression` and with `GBDTClassifier` (100
     iterations, 31 leaves; its `hist_tiled` launches counted, none for
     LR): fit s, rows/s, peak memory, `ComputeModelStatistics` holdout AUC
     over `AUTOML_AUC_FLOOR`; the card LR held to the port's CPU fit on
     50,000 rows within `_AUTOML_FIT_TOL`; the GBDT composite refit with
     the plain histograms (no kernel launched), its holdout logloss and
     AUC within `_METRIC_TOL` of the kernel fit's; with --profile, one LR
     fit's launches and the card's busy share from torch.profiler in a
     process of its own. (b)
     `TuneHyperparameters` over both learners on 100,000 rows (200,000
     before [images]; 4 random
     draws each, 3 folds), `FindBestModel` on the holdout; the same
     tuning with 2 draws each and 2 folds on 50,000 of those rows at
     parallelism 1 and 4, the GBDT fits in fixed order: times, LR scores
     equal,
     GBDT's within `_AUTOML_PAR_GBDT_TOL`. (c)
     `TextFeaturizer` at 2^18 slots on 100,000 seeded documents of 40
     Zipf tokens (vocabulary 50,000), `LogisticRegression` on the sparse
     pairs twice (bit for bit), held to the CPU fit on 10,000 documents
     within `_AUTOML_TEXT_TOL`.
     (d) `TabularLIME` on (a)'s LR model, 256 rows x 1,000 samples x 108
     features at lambda 0 and `AUTOML_LIME['lam']`, each within
     `_AUTOML_LASSO_TOL` of the CPU path; the logit of the same weights
     explained recovers them within `_AUTOML_RECOVER_TOL`. (e)
     `ImageLIME` on 2 images of 224 x 224, 900 masks each, through the
     port's ResNet-18 `ImageFeaturizer` (random weights from seed 0): the
     card lasso against the CPU's on the same masks and scores.
  25. telemetry (slice 23; no kernel of its own, run right after the
     main path: the process's first profiler captures): (a) CUPTI started
     by a warm-up capture (its seconds printed), then one headline
     iteration fit on a thread of its own inside a `ProfileSession`
     capture: a device table parsed, `hist_tile_kernel` in `gbdt.hist`
     equal to the wrapper's count, `gbdt.hist`, `gbdt.split` and
     `gbdt.route` each with device time and together within the
     device-busy time, their roofline rows (analytic bytes, the chip
     table's peaks); an annotated tree under
     `torch.cuda.set_sync_debug_mode("error")`. (b) One bf16 flagship LM
     step through `TrainingSupervisor.run` captured: 12 of each flash
     kernel in `train.step`, its device time against the step's wall.
     (c) A two-partition ResNet-18 `DNNModel` (GBDT serves on its host
     plan and launches nothing) under load: `GET /debug/profile?ms=200`
     200 with `serving.plan.run` device time, then 429; the [serving]
     GBDT model: `GET /debug/bundle` 200 then 429, an injected SLO burn
     dumping one bundle and none while it stays burning, the bundle's
     files the reference's, a scrape with the device memory gauges.
  26. cyber (slice 24; no kernel of its own: torch products and
     batched solves, gathers): one tenant shaped like LANL's users x
     computers (12,425 x 17,684, 50 groups with Zipf popularity, 20
     servers everyone reaches) and a small second tenant, at
     AccessAnomaly's defaults. (a) The IdIndexer -> AccessAnomaly
     pipeline fit twice, bit-identical (host aggregation, the dense
     ratings and weights on the card, 25 ALS rounds of batched ridge
     solves), the ALS's busy share in a `ProfileSession`, peak memory,
     scoring rows/s of 100,000 unseen intra-group and 100,000
     cross-group pairs and their AUC over `CYBER_AUC_FLOOR`, unseen ids
     scoring 0, the card against the CPU fit on 2,000 x 1,500 within
     `_CYBER_FACTOR_RTOL` / `_CYBER_SCORE_RTOL`. (b) 200,000 access-log
     lines written in pieces to 4 CSV files with a torn last line,
     scored through `FileStreamSource(mode="csv")` / `FileStreamQuery`
     into a sink that fails once: the epoch replays, every row scored
     once, equal to the bulk transform bit for bit. (c) The pipeline
     behind `serve_pipeline`, 1,000 rows through `SimpleHTTPTransformer`
     at concurrency 4, answers equal to the bulk transform; the scores
     through `powerbi.write` to a local endpoint, every row once.
  27. images (slice 25; kernels D1-D4, `ops/csrc/image_decode.cu` and
     `resample.cu`, none of them in place of a TPU kernel: the reference
     decodes with PIL on the host): (a) every fixture of
     tests/data/images through `read_image_dir` and `read_images(size=
     (224, 224))` on the card, equal to PIL's SHA-256 digests
     (expected.json); D1-D4 against their plain versions (`torch.equal`)
     on the six 500 x 375 photos, timed beside the plain versions, the
     byte bound and, for D4, one `F.interpolate(bicubic, antialias)`;
     (b) a folder of 64 copies of the photos through `read_images(size=
     (224, 224))` into the ResNet-50 bf16 `ImageFeaturizer`, the counts
     set to 0 just before (exactly 1 D1, 1 D2, 1 D3 and 2 D4 launches),
     images/s from files to features, each image's digest, then the
     same run in a `ProfileSession` capture split into
     `image.decode.host`, `image.decode.card` and the featurizer; (c)
     `read_image_dir` on the folder.
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
        from torch.profiler import ProfilerActivity
        from mmlspark_tpu_torch.telemetry.profiler import (
            exclusive_profiler as tprof)
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
    from torch.profiler import ProfilerActivity
    from mmlspark_tpu_torch.telemetry.profiler import (
        exclusive_profiler as tprof)
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
        from torch.profiler import ProfilerActivity
        from mmlspark_tpu_torch.telemetry.profiler import (
            exclusive_profiler as tprof)
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


def _lm_flops_per_step(lm=None):
    """bench.py's model FLOPs (:2025-2027) of the LM `lm` (the flagship
    by default): forward matmuls 2 * S * L * (4 d^2 + 2 d d_ff) + the
    logits 2 * S * d * V + causal attention L * 2 * S^2 * d; a training
    step is 3x the forward (remat's recompute is not credited)."""
    lm = lm or LM
    s, n, d = LM_SEQ, lm["n_layers"], lm["d_model"]
    fwd = (2 * s * n * (4 * d * d + 2 * d * lm["d_ff"])
           + 2 * s * d * lm["vocab_size"] + n * 2 * s * s * d)
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
        from torch.profiler import ProfilerActivity
        from mmlspark_tpu_torch.telemetry.profiler import (
            exclusive_profiler as tprof)
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
        from torch.profiler import ProfilerActivity
        from mmlspark_tpu_torch.telemetry.profiler import (
            exclusive_profiler as tprof)
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
# slice 14: pipeline and tensor parallelism. The flagship LM's width on the
# four-stage, two-way Megatron layout of eight positions, run on one card:
# (data, pipe, model, seq) = (1, 4, 2, 1), 4 heads and d_ff 2048 a model
# position; two 16,384-token sequences a step in two microbatches. Its
# depth is cut to 4 of 12 layers (one a stage; PIPE_LM), as RESUME_LM and
# MPLM_LM are cut, to keep the script inside its time limit; every check
# is kept
PIPE_MESH = (1, 4, 2, 1)
PIPE_LM = dict(LM, n_layers=4)
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
    """The flash launches of one step of PIPE_LM on `shape`: each layer
    runs at every model position for every sequence, normalized without a
    seq axis, stats blocks over cp^2 shard pairs with one."""
    _, _, tp, cp = shape
    per = PIPE_LM["n_layers"] * tp * n_seqs
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
                              **kw, **PIPE_LM)


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
    """ShardedLMTrainer at PIPE_LM (the flagship width), f32, on a (2, 2)
    data x model mesh of one card and with mesh=None from the same seed:
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
                             device=None if mesh else dev, **PIPE_LM)
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
    """The LM training path on pipe and model axes at the flagship width
    (PIPE_LM's depth):
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
    log(f"[pipe train] {PIPE_LM} on {trainer.mesh}: {PIPE_MICROBATCHES} "
        f"microbatches of {PIPE_BATCH // PIPE_MICROBATCHES} x {LM_SEQ} "
        f"tokens, {PIPE_LM['n_layers'] // PIPE_MESH[1]} layers a stage, "
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
    flops = PIPE_BATCH * _lm_flops_per_step(PIPE_LM)
    mfu = flops / s_step / PEAK_BF16_FLOP_PER_S
    log(f"[pipe train] run({LM_STEPS}): {s_step:.4f} s/step = "
        f"{tokens / s_step:.4g} tokens/s; lm_train_mfu {mfu:.4f} (model "
        f"FLOPs {flops:.4g}/step); peak memory {peak / 2**30:.2f} GiB; "
        f"launches {launches}; losses {loss1:.4f} -> {loss_last:.4f}; "
        f"[train] one position, {LM['n_layers']} layers, {LM_SEQ} tokens: "
        f"{train['s_step']:.4f} s/step, {train['tokens_per_s']:.4g} tokens/s, peak "
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
# the resume contract's three routes run on the headline's first
# RESUME_ROUTE_ROWS rows (a quarter: each route bins them in two fits of
# its own and in two fresh processes), cut to pay for [automl] inside the
# run's time limit; the checkpointed fit's cost stays at the headline's
RESUME_ROUTE_ROWS = 2_000_000
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


def _resume_route(dev, tmp, route, x, y, **kw):
    """The in-process half of the resume contract on one route (`route`:
    a key of `_RESUME_LAUNCHES`; MMLSPARK_TPU_HIST is set by the caller):
    two uninterrupted checkpointed fits (the first with the launch counts
    set to 0 just before and read just after) and a fit of 6 iterations
    resumed to 10, all equal bit for bit. Returns the seconds, the
    launches and the first fit's margins and booster, which
    `_resume_in_processes` holds the fresh processes to."""
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
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
    return dict(fit_s=[s for _, s in fits], resume_s=resume_s,
                launches=launches, raw=raws[0], booster=fits[0][0].booster)


def _resume_in_processes(dev, tmp, routes, kws):
    """The fresh-process half of the resume contract, every route's
    processes at once (each process's start-up is most of its time): a
    subprocess per route SIGTERMed after its second periodic checkpoint,
    then a fresh one per route resumed from it, equal bit for bit to the
    route's uninterrupted fit (`routes[route]`, from `_resume_route`; the
    data in `<route>_x.npy` / `<route>_y.npy`). Logs each route's line."""
    from mmlspark_tpu_torch.models.gbdt import Booster
    from mmlspark_tpu_torch.utils.checkpoint import CheckpointManager
    script = os.path.join(tmp, "fit.py")
    with open(script, "w") as fh:
        fh.write(_RESUME_PROC.format(here=HERE, interval=RESUME_INTERVAL))
    procs = {route: {} for route in routes}
    for phase in ("kill", "resume"):
        running = {}
        for route in routes:
            d = os.path.join(tmp, route)
            params = json.dumps({k: list(v) if isinstance(v, tuple) else v
                                 for k, v in {**RESUME_PARAMS,
                                              **kws[route]}.items()})
            env = {k: v for k, v in os.environ.items()
                   if k != "MMLSPARK_TPU_HIST"}
            if route == "planes":
                env["MMLSPARK_TPU_HIST"] = "planes"
            err = open(os.path.join(d, f"{phase}.err"), "w")
            running[route] = (subprocess.Popen(
                [sys.executable, script, phase,
                 os.path.join(tmp, f"{route}_x.npy"),
                 os.path.join(tmp, f"{route}_y.npy"),
                 os.path.join(d, "killed"), params, str(dev),
                 os.path.join(d, f"{phase}.npz")],
                stdout=subprocess.DEVNULL, stderr=err, env=env), err,
                time.perf_counter())
        for route, (proc, err, t0) in running.items():
            rc = proc.wait(timeout=600)
            procs[route][phase] = (rc, time.perf_counter() - t0)
            err.close()
            with open(err.name) as fh:
                stderr = fh.read()[-2000:]
            if phase == "kill":
                steps = CheckpointManager(os.path.join(
                    tmp, route, "killed")).all_steps()
                if rc != -signal.SIGTERM or \
                        steps != [RESUME_INTERVAL, 2 * RESUME_INTERVAL]:
                    raise AssertionError(
                        f"{route}: the killed fit exited {rc} with steps "
                        f"{steps}: {stderr}")
            elif rc != 0:
                raise AssertionError(f"{route}: the resumed process "
                                     f"failed: {stderr}")
    for route, res in routes.items():
        out = np.load(os.path.join(tmp, route, "resume.npz"))
        _same_fit(res["raw"], res["booster"], out["raw"],
                  Booster.load_model_string(str(out["booster"])),
                  f"{route}: SIGTERM kill and resume in a fresh process")
        kill, resume = procs[route]["kill"], procs[route]["resume"]
        log(f"[resume] {route}: two uninterrupted checkpointed "
            f"GBDTClassifier fits ("
            f"{', '.join(f'{t:.3f}' for t in res['fit_s'])} s, binning "
            f"included), the 6 -> {N_ITERS} resume ({res['resume_s']:.3f} "
            f"s) and the SIGTERM kill (exit {kill[0]}, {kill[1]:.1f} s, "
            f"steps {RESUME_INTERVAL} and {2 * RESUME_INTERVAL} on disk) "
            f"and resume in a fresh process ({resume[1]:.1f} s; the three "
            f"routes' processes run at once): margins, split_feature, "
            f"threshold and leaf_value equal bit for bit; launches "
            f"{res['launches']} a fit")
        res["proc_s"] = {k: v[1] for k, v in procs[route].items()}
        del res["raw"], res["booster"]


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


# the LM [resume] saves and restores: the flagship's width at a sixth of
# its depth (2 of 12 layers), cut to 4 to pay for [fleet], then to 2 for
# [cyber], inside the run's time limit
RESUME_LM = dict(LM, n_layers=2)


def _lm_resume(dev, tmp):
    """The flagship-width bf16 LM at `RESUME_LM`'s depth
    (`PipelinedLMTrainer`, flash, remat="save_attn", Adam): two steps,
    `save_checkpoint`, a third and a
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
            compute_dtype="bfloat16", remat="save_attn", device=dev,
            **RESUME_LM)
    toks = np.random.default_rng(0).integers(
        0, RESUME_LM["vocab_size"], size=(1, LM_SEQ)).astype(np.int32)
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
    log(f"[resume] flagship-width LM bf16, {RESUME_LM['n_layers']} layers "
        f"({LM_SEQ} tokens): save_checkpoint "
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
        head = {k: data[k][:RESUME_ROUTE_ROWS] for k in ("x", "y")}
        cat = categorical_data(dev, head)
        kws = {"default": {}, "planes": {},
               "categorical": dict(categorical_slot_indexes=CAT_COLS)}
        for route, dset in (("default", head), ("planes", head),
                            ("categorical", cat)):
            np.save(os.path.join(tmp, f"{route}_x.npy"), dset["x"])
            np.save(os.path.join(tmp, f"{route}_y.npy"), dset["y"])
            ctx = (env("MMLSPARK_TPU_HIST", "planes") if route == "planes"
                   else contextlib.nullcontext())
            with ctx:
                routes[route] = _resume_route(dev, tmp, route, dset["x"],
                                              dset["y"], **kws[route])
            torch.cuda.empty_cache()
        del cat
        torch.cuda.empty_cache()
        _resume_in_processes(dev, tmp, routes, kws)
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
    from torch.profiler import ProfilerActivity
    from mmlspark_tpu_torch.telemetry.profiler import (
        exclusive_profiler as tprof)
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
    from torch.profiler import ProfilerActivity
    from mmlspark_tpu_torch.telemetry.profiler import (
        exclusive_profiler as tprof)
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
# slice 15: `ShardedLMTrainer.run_stream` at the flagship width and a
# sixth of its depth (STREAM_LM: 2 layers, so each checkpoint is ~0.6 GB,
# not 2.4, and a process builds the model in a fraction of the time; cut
# to 4 layers to pay for [fleet], then to 2 for [automl], inside the
# run's time limit), f32,
# dense attention, on
# STREAM_BATCHES seeded (4, 2048) batches of Zipf token ids: against a
# `step()` loop, then supervised (a checkpoint every STREAM_EVERY batches)
# with and without an injected crash, and a child preempted by SIGTERM
# and resumed in a fresh process
STREAM_LM = dict(LM, n_layers=2)
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
    cfg = json.dumps(dict(lm=STREAM_LM, shape=STREAM_SHAPE, n=STREAM_BATCHES,
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

    batches = _stream_batches(STREAM_LM, STREAM_SHAPE, STREAM_BATCHES)
    tokens = STREAM_SHAPE[0] * STREAM_SHAPE[1]
    t = ShardedLMTrainer(seed=0, device=dev, **STREAM_LM)
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
        log(f"[stream train] ShardedLMTrainer flagship width f32, "
            f"{STREAM_LM['n_layers']} layers, {STREAM_BATCHES} batches "
            f"{STREAM_SHAPE}: step() loop "
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
# the pipelined configurations' LM: the flagship's width at a sixth of
# its depth (2 of 12 layers; 4 before [images]), cut to keep the run
# inside its time limit. (b) keeps the 12 layers: its check that the
# loss falls from the first stream batch to the last held there over 3
# steps (4 layers: 10.58, 8.69, 11.69). (a) and (b) run 2 steps since
# [cyber]
MPLM_LM = dict(LM, n_layers=2)
MPLM = {
    "a": dict(kind="pipelined", mesh=(1, 2, 2, 1), steps=2,
              batch=(PIPE_BATCH, LM_SEQ), microbatches=PIPE_MICROBATCHES,
              lm=MPLM_LM),
    "b": dict(kind="sharded", mesh=SHARDED_MESH, steps=2,
              batch=STREAM_SHAPE, lm=LM),
    "c": dict(kind="pipelined", mesh=(1, 1, 1, 2), steps=2,
              batch=(1, LM_SEQ), microbatches=1, lm=MPLM_LM),
    "d": dict(kind="pipelined", mesh=(1, 1, 2, 1), steps=2,
              batch=(1, LM_SEQ), microbatches=1, replicas=False,
              lm=MPLM_LM),
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
        return _stream_batches(cfg["lm"], cfg["batch"], cfg["steps"])
    toks = np.random.default_rng(0).integers(
        0, cfg["lm"]["vocab_size"], size=cfg["batch"]).astype(np.int32)
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
                                seed=0, **cfg["lm"])
    return PipelinedLMTrainer(
        mesh=grid_mesh(cfg["mesh"], _PIPE_AXES, devices=devs),
        n_microbatches=cfg["microbatches"], attention="flash",
        remat="save_attn", compute_dtype="bfloat16", seed=0, **kw,
        **cfg["lm"])


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
        0, cfg["lm"]["vocab_size"], size=(cfg["batch"][0], _TRAIN_CHECK_SEQ)
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
    lm = MPLM[name]["lm"]
    n, d = lm["n_layers"], lm["d_model"]
    fwd = (2 * s * n * (4 * d * d + 2 * d * lm["d_ff"])
           + 2 * s * d * lm["vocab_size"] + n * 2 * s * s * d)
    return 3 * fwd * b


def _mplm_launches(mplm, kernel):
    """`kernel`'s launches in one step of each [multiprocess lm]
    configuration, per rank, beside the one-process count."""
    return {f"multiprocess lm ({n}) step, per rank ({MP_RANKS} ranks; one "
            f"process {r['one_launches'][kernel]})":
            [g[kernel] for g in r["launches"]] for n, r in mplm.items()
            if MPLM[n]["kind"] == "pipelined"}


def multiprocess_lm_phase(dev):
    """[multiprocess lm]: the flagship LM (each configuration's `lm`)
    over MP_RANKS gloo ranks on the card (`MPLM`): each configuration
    first in this process on a mesh of the same shape
    (`devices=[dev] * n`), then in the ranks. Per
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


# -- [dnn] (slice 18): the deep-net image path ------------------------------
# ResNet-50 at 224 x 224 through ImageFeaturizer, from 256 x 256 images so
# the antialiased downsampling runs on the card; weights seeded-random, as
# the reference's offline zoo (models/dnn/resnet.py:125)
DNN_IMAGES, DNN_SRC, DNN_SIZE, DNN_BATCH = 1024, 256, 224, 32
DNN_CHECK = 8                   # images held against the CPU path
# ResNet-50's convolution work at 224 x 224 (He et al. 2015, Table 1):
# 4.1e9 multiply-adds an image
RESNET50_MACS = 4.1e9
# f32 features on the card against the port's plain CPU path, relative to
# the largest |feature|: the same f32 math in other summation orders. The
# card keeps PyTorch's process-wide cuDNN TF32 flag ON through the phase,
# so the bound holds only because the port scopes TF32 off; the phase
# shows that the same forward without that scope fails it.
_DNN_F32_TOL = 1e-4
# bf16 features against f32 on the card, relative to the largest |f32
# feature|: every convolution output and BN rounded to bf16 over 50
# layers (tests/test_torch_dnn_resnet.py's bound; 0.6-1.1% measured at
# 32 x 32 against the reference on the CPU)
_DNN_BF16_TOL = 3e-2
# the ONNX graph's logits against torch's forward of the same module on
# the card, relative to the largest |logit| (tests/test_onnx_import.py:
# 162-165)
_ONNX_TOL = 1e-4
# transfer learning: 10 classes, each a colour of `_PALETTE` under noise;
# train accuracy must beat chance (0.1) by this much
TRANSFER_CLASSES = 10
_TRANSFER_MARGIN = 0.3
TRANSFER_HEAD = dict(model_name="resnet50", mode="head", images=512,
                     size=224, src=256, epochs=5)
TRANSFER_FULL = dict(model_name="resnet18", mode="full", images=1024,
                     size=32, src=32, epochs=3)
DNN_EXPORT_ROWS = 64


def _colour_images(n, size, seed):
    """n uint8 images of `size`, class i % 10 a colour of a fixed palette
    (RGB corners and mid-greys) under per-pixel noise."""
    rng = np.random.default_rng(seed)
    palette = np.array([[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255],
                        [255, 255, 0], [255, 0, 255], [0, 255, 255],
                        [255, 255, 255], [128, 64, 0], [64, 128, 192]],
                       np.float64)
    y = np.arange(n) % TRANSFER_CLASSES
    noise = rng.normal(0, 40, size=(n, size, size, 3))
    imgs = np.clip(palette[y][:, None, None, :] * 0.6 + 50 + noise, 0, 255)
    return imgs.astype(np.uint8), y.astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _onnx_resnet18(path):
    """Export the seeded ResNet-18 of tests/data/torch_resnet.py at 224 with
    torch's own exporter; returns (module, example input)."""
    sys.path.insert(0, os.path.join(HERE, "tests", "data"))
    try:
        from torch_resnet import export_resnet18_onnx
    finally:
        sys.path.pop(0)
    model, x, _ = export_resnet18_onnx(path, seed=0, spatial=DNN_SIZE)
    return model, x


def _featurize_timed(fz, imgs):
    """(features, seconds, peak bytes) of `fz` over `imgs` after one
    warm-up pass over the same images."""
    import torch
    from mmlspark_tpu_torch import Table
    t = Table({"image": imgs})
    fz.transform(t)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    feats = fz.transform(t)["features"]
    torch.cuda.synchronize()
    return feats, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def _unscoped_f32(kw, check):
    """The f32 featurizer on the card with the port's TF32 scope taken
    out (`device.exact_f32` made a no-op where the path enters it)."""
    import contextlib
    from mmlspark_tpu_torch.models.dnn import ImageFeaturizer
    from mmlspark_tpu_torch.models.dnn import model as dnn_model
    from mmlspark_tpu_torch.models.dnn import resnet as rn
    with contextlib.ExitStack() as undo:
        for mod in (rn, dnn_model):
            undo.callback(setattr, mod, "exact_f32", mod.exact_f32)
            mod.exact_f32 = contextlib.nullcontext
        return ImageFeaturizer(dtype="float32", **kw).transform(
            check)["features"]


def _profile_featurizer(fz, imgs, dtype):
    """torch.profiler of one pass of `fz` over `imgs`: kernel time against
    wall time (the card's idle share) and the operators with the most
    device time of their own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from mmlspark_tpu_torch.telemetry.profiler import (
        exclusive_profiler as tprof)
    from mmlspark_tpu_torch import Table
    t = Table({"image": imgs})
    with tprof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fz.transform(t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    own = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            own[e.key] = own.get(e.key, 0.0) + _device_us(e, own=True)
    total = sum(own.values())
    top = sorted(own.items(), key=lambda kv: -kv[1])[:8]
    log(f"[dnn] profile, {dtype} featurizer, {len(imgs)} images: "
        f"{total / 1e3:.2f} ms of kernel time in {wall * 1e3:.1f} ms of "
        f"wall (idle {100 * (1 - total / 1e3 / (wall * 1e3)):.1f}%); "
        + ", ".join(f"{k} {v / 1e3:.2f} ms ({100 * v / max(total, 1):.1f}%)"
                    for k, v in top))
    return dict(kernel_ms=total / 1e3, wall_ms=wall * 1e3,
                top={k: v / 1e3 for k, v in top})


def _dnn_featurizer(dev, imgs, out):
    """(a) ResNet-50 features at 224 in bf16 and f32, timed; f32 against
    the CPU path; bf16 against f32; the card's resize against the CPU's."""
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.image import ops as image_ops
    from mmlspark_tpu_torch.models.dnn import ImageFeaturizer
    from mmlspark_tpu_torch.models.dnn import resnet as rn

    sub = torch.from_numpy(imgs[:DNN_CHECK])
    for fn in (image_ops.resize_float, image_ops.resize_images):
        if not torch.equal(fn(sub.to(dev), DNN_SIZE, DNN_SIZE).cpu(),
                           fn(sub, DNN_SIZE, DNN_SIZE)):
            raise AssertionError(f"[dnn] the card's {fn.__name__} differs "
                                 f"from the CPU's")
    variables = rn.init_resnet(rn.resnet50(), seed=0)
    kw = dict(model_name="resnet50", variables=variables,
              image_height=DNN_SIZE, image_width=DNN_SIZE,
              batch_size=DNN_BATCH)
    feats = {}
    for dtype in ("bfloat16", "float32"):
        fz = ImageFeaturizer(dtype=dtype, **kw)
        f, s, peak = _featurize_timed(fz, imgs)
        if f.shape != (DNN_IMAGES, 2048) or not np.isfinite(f).all():
            raise AssertionError(f"[dnn] {dtype} features {f.shape}, "
                                 f"finite {np.isfinite(f).all()}")
        peak_flops = PEAK_BF16_FLOP_PER_S if dtype == "bfloat16" \
            else PEAK_F32_FLOP_PER_S
        tflops = 2 * RESNET50_MACS * DNN_IMAGES / s / 1e12
        out[f"resnet50_{dtype}"] = dict(
            images_per_s=DNN_IMAGES / s, s=s,
            s_per_batch=s / -(-DNN_IMAGES // DNN_BATCH), peak=peak,
            tflops=tflops, peak_share=tflops * 1e12 / peak_flops)
        feats[dtype] = f
        out[f"resnet50_{dtype}"]["profile"] = _profile_featurizer(
            fz, imgs[:4 * DNN_BATCH], dtype)
        log(f"[dnn] (a) ResNet-50 ImageFeaturizer {dtype}, {DNN_IMAGES} "
            f"images {DNN_SRC}x{DNN_SRC} -> {DNN_SIZE}, batch {DNN_BATCH}: "
            f"{DNN_IMAGES / s:.1f} images/s, {s / -(-DNN_IMAGES // DNN_BATCH):.4f} "
            f"s/batch, peak {peak / 2**30:.2f} GiB, conv work "
            f"{tflops:.1f} TFLOP/s = {100 * tflops * 1e12 / peak_flops:.2f}% "
            f"of the {peak_flops / 1e12:.0f} TFLOP/s dense "
            f"{'bf16' if dtype == 'bfloat16' else 'f32'} peak")
    # f32 against the port's plain CPU path on the same weights
    check = Table({"image": imgs[:DNN_CHECK]})
    cpu = ImageFeaturizer(dtype="float32", device="cpu", **kw).transform(
        check)["features"]
    err = _rel(feats["float32"][:DNN_CHECK], cpu)
    tf32_err = _rel(_unscoped_f32(kw, check), cpu)
    if err > _DNN_F32_TOL or tf32_err <= _DNN_F32_TOL:
        raise AssertionError(f"[dnn] f32 card vs CPU {err:.3g} (limit "
                             f"{_DNN_F32_TOL}); without the TF32 scope "
                             f"{tf32_err:.3g} (must exceed it)")
    bf_err = _rel(feats["bfloat16"], feats["float32"])
    if bf_err > _DNN_BF16_TOL:
        raise AssertionError(f"[dnn] bf16 vs f32 features {bf_err:.3g} > "
                             f"{_DNN_BF16_TOL}")
    out["checks"] = dict(f32_vs_cpu=err, tf32_vs_cpu=tf32_err,
                         bf16_vs_f32=bf_err)
    log(f"[dnn] (a) f32 card vs CPU on {DNN_CHECK} images {err:.3g} of max "
        f"|feature| (limit {_DNN_F32_TOL}; with TF32 unscoped {tf32_err:.3g}"
        f"); bf16 vs f32 {bf_err:.3g} (limit {_DNN_BF16_TOL}); the card's "
        f"resize equal to the CPU's bit for bit")


def _dnn_onnx(dev, imgs, tmp, out):
    """(b) ResNet-18 exported by torch as ONNX: the port's importer on the
    card against torch's forward of the module; then ImageFeaturizer."""
    import torch
    from mmlspark_tpu_torch.models.dnn import ImageFeaturizer, load_onnx
    from mmlspark_tpu_torch.models.dnn.model import params_to_device

    path = os.path.join(tmp, "resnet18.onnx")
    t0 = time.perf_counter()
    model, x = _onnx_resnet18(path)
    export_s = time.perf_counter() - t0
    with open(path, "rb") as f:
        data = f.read()
    apply_fn, params = load_onnx(data)
    xd = torch.from_numpy(x).to(dev)
    model = model.to(dev)
    cudnn = torch.backends.cudnn
    with torch.no_grad(), cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=False, allow_tf32=False):
        want = model(xd).cpu().numpy()
    got = apply_fn(params_to_device(params, dev), xd).cpu().numpy()
    err = _rel(got, want)
    if got.shape != want.shape or err > _ONNX_TOL:
        raise AssertionError(f"[dnn] ONNX ResNet-18 {got.shape} vs torch "
                             f"{want.shape}: {err:.3g} > {_ONNX_TOL}")
    fz = ImageFeaturizer(onnx_model=data, image_height=DNN_SIZE,
                         image_width=DNN_SIZE, batch_size=DNN_BATCH)
    f, s, peak = _featurize_timed(fz, imgs)
    if f.shape != (DNN_IMAGES, 512) or not np.isfinite(f).all():
        raise AssertionError(f"[dnn] ONNX features {f.shape}")
    out["onnx_resnet18"] = dict(err=err, images_per_s=DNN_IMAGES / s, s=s,
                                peak=peak, export_s=export_s,
                                bytes=len(data))
    log(f"[dnn] (b) ResNet-18 as ONNX ({len(data)} B, exported in "
        f"{export_s:.1f} s): logits vs torch's forward on the card "
        f"{err:.3g} of max |logit| (limit {_ONNX_TOL}); ImageFeaturizer "
        f"bf16 512-d features {DNN_IMAGES / s:.1f} images/s, peak "
        f"{peak / 2**30:.2f} GiB")


def _dnn_transfer(dev, tmp, out):
    """(c) head mode on ResNet-50 at 224 and full mode on ResNet-18 at 32:
    fit seconds, falling losses, train accuracy, transform images/s, and
    equal probabilities after a save and a load."""
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.core import serialize
    from mmlspark_tpu_torch.models.dnn import DeepTransferClassifier
    from mmlspark_tpu_torch.models.dnn import resnet as rn

    for cfg in (TRANSFER_HEAD, TRANSFER_FULL):
        imgs, y = _colour_images(cfg["images"], cfg["src"],
                                 seed=cfg["images"])
        t = Table({"image": imgs, "label": y})
        t0 = time.perf_counter()
        variables = rn.init_resnet(getattr(rn, cfg["model_name"])(
            num_classes=TRANSFER_CLASSES), seed=0)
        init_s = time.perf_counter() - t0
        est = DeepTransferClassifier(
            variables=variables, model_name=cfg["model_name"],
            mode=cfg["mode"],
            num_classes=TRANSFER_CLASSES, epochs=cfg["epochs"],
            image_height=cfg["size"], image_width=cfg["size"], seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = est.fit(t)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        scored = m.transform(t)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        acc = float((scored["prediction"] == y).mean())
        losses = m.training_losses
        path = os.path.join(tmp, f"transfer_{cfg['mode']}")
        m.save(path)
        back = serialize.load_stage(path).transform(t)
        same = np.array_equal(back["probabilities"], scored["probabilities"])
        tag = (f"[dnn] (c) {cfg['mode']} mode, {cfg['model_name']} at "
               f"{cfg['size']}, {cfg['images']} images of "
               f"{TRANSFER_CLASSES} colours")
        if not (losses[-1] < losses[0] and acc > 1 / TRANSFER_CLASSES
                + _TRANSFER_MARGIN and same
                and np.isfinite(scored["probabilities"]).all()):
            raise AssertionError(f"{tag}: losses {losses}, accuracy {acc}, "
                                 f"equal after a reload {same}")
        out[f"transfer_{cfg['mode']}"] = dict(
            fit_s=fit_s, init_s=init_s, losses=losses, accuracy=acc,
            peak=peak, transform_images_per_s=cfg["images"] / score_s)
        log(f"{tag}, {cfg['epochs']} epochs: seeded backbone drawn on the "
            f"host in {init_s:.2f} s, then fit {fit_s:.2f} s, losses "
            f"{', '.join(f'{v:.4f}' for v in losses)}, train accuracy "
            f"{acc:.4f} (chance {1 / TRANSFER_CLASSES}, margin "
            f"{_TRANSFER_MARGIN}), transform "
            f"{cfg['images'] / score_s:.1f} images/s, peak "
            f"{peak / 2**30:.2f} GiB; probabilities equal after a reload")


def _dnn_export(dev, tmp, out):
    """(d) a DNNModel of ResNet-18 at 224 saved as a torch.export program
    on the card and loaded: equal outputs."""
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.core import serialize
    from mmlspark_tpu_torch.models.dnn import DNNModel
    from mmlspark_tpu_torch.models.dnn import resnet as rn

    model = rn.resnet18(dtype="bfloat16")
    state = rn.resnet_params_from_numpy(rn.init_resnet(model, seed=1), dev)
    x = np.random.default_rng(5).random(
        (DNN_EXPORT_ROWS, 3, DNN_SIZE, DNN_SIZE)).astype(np.float32)
    m = DNNModel(apply_fn=model, params=state, batch_size=DNN_BATCH)
    want = m.transform(Table({"features": x}))["scores"]
    path = os.path.join(tmp, "dnn")
    t0 = time.perf_counter()
    m.save(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = serialize.load_stage(path)
    got = back.transform(Table({"features": x}))["scores"]
    load_s = time.perf_counter() - t0
    if back._apply_fn is not None or not np.array_equal(got, want) or \
            not np.isfinite(got).all():
        raise AssertionError("[dnn] (d) the torch.export round trip "
                             "changed the outputs")
    out["export"] = dict(save_s=save_s, load_s=load_s,
                         bytes=os.path.getsize(os.path.join(
                             path, "arrays.npz")))
    log(f"[dnn] (d) DNNModel ResNet-18 bf16 at {DNN_SIZE}: saved as a "
        f"torch.export program in {save_s:.2f} s "
        f"({out['export']['bytes']} B of arrays), loaded and scored "
        f"{DNN_EXPORT_ROWS} rows in {load_s:.2f} s, equal outputs")


def dnn_phase(dev):
    """[dnn]: ImageFeaturizer (ResNet-50, bf16 and f32), ONNX ResNet-18,
    transfer learning in both modes and DNNModel's torch.export round
    trip, with PyTorch's default cuDNN TF32 flag on."""
    import tempfile
    import torch
    t_phase = time.perf_counter()
    imgs = np.random.default_rng(18).integers(
        0, 256, size=(DNN_IMAGES, DNN_SRC, DNN_SRC, 3), dtype=np.uint8)
    out = {}
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            _dnn_featurizer(dev, imgs, out)
            torch.cuda.empty_cache()
            _dnn_onnx(dev, imgs, tmp, out)
            torch.cuda.empty_cache()
            _dnn_transfer(dev, tmp, out)
            _dnn_export(dev, tmp, out)
    finally:
        torch.backends.cudnn.allow_tf32 = before
        torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_phase
    log(f"[dnn] the phase {out['s']:.1f} s")
    return out


SERVE_ROWS, SERVE_FEAT = 20_000, 16          # bench.py:897-903
SERVE_CHECK_ROWS = 512
SERVE_DOCS = 256
SERVE_DOC_WORDS = (16, 512)
SERVE_DNN = dict(size=64, images=16, batch=4, classes=10)
_SERVE_PROBA_TOL = 1e-6
_SERVE_EMB_TOL = 1e-5
_SERVE_DNN_TOL = 1e-6


def _serve_post_all(address, bodies, timeout=30):
    """Each body POSTed in turn on one keep-alive connection:
    [(status, headers, payload)]."""
    import http.client
    host, port = address[len("http://"):].rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    out = []
    try:
        for b in bodies:
            conn.request("POST", "/", body=b)
            resp = conn.getresponse()
            out.append((resp.status, dict(resp.getheaders()), resp.read()))
    finally:
        conn.close()
    return out


def _serve_statuses_ok(out, what):
    bad = [s for s, _, _ in out if s != 200]
    if bad:
        raise AssertionError(f"[serving] {what}: {len(bad)} replies not "
                             f"200 ({sorted(set(bad))})")


def _serve_load(server, body, clients, per_client, post=None):
    """run_load against `server`; fails on any error, dropped request or
    non-200 reply."""
    from mmlspark_tpu_torch.io.loadgen import run_load
    host, port = server._httpd.server_address[:2]
    res = run_load(host, port, body, n_clients=clients,
                   per_client=per_client, timeout=60, post=post)
    if res.errors or res.n_dropped or set(res.n_by_status or {}) != {200}:
        raise AssertionError(
            f"[serving] load: {len(res.errors)} errors "
            f"({res.errors[:2]}), {res.n_dropped} dropped, statuses "
            f"{res.n_by_status}")
    return res


def _serve_section(res, transform):
    """req/s, latency and the serving.request.* stage percentiles of one
    run, with the plan cache's counts (misses == distinct buckets)."""
    from mmlspark_tpu_torch.reliability.metrics import reliability_metrics
    snap = reliability_metrics.snapshot()
    stats = transform.stats()
    if stats["misses"] != stats["buckets"] or stats["evictions"]:
        raise AssertionError(f"[serving] plan misses {stats['misses']} != "
                             f"distinct buckets {stats['buckets']}")
    out = dict(req_per_s=res.req_per_sec, p50_ms=res.p50_ms,
               p99_ms=res.p99_ms, requests=res.n_ok,
               plan_hits=stats["hits"], plan_misses=stats["misses"])
    for stage in ("queue", "transform", "reply", "e2e"):
        for q in ("p50", "p99"):
            key = f"serving.request.{stage}.{q}"
            if key not in snap:
                raise AssertionError(f"[serving] {key} was not recorded")
            out[f"{stage}_{q}_ms"] = snap[key]
    return out


def _serve_log(tag, sect):
    log(f"[serving] {tag}: {sect['req_per_s']:.1f} req/s, p50 "
        f"{sect['p50_ms']:.3f} ms, p99 {sect['p99_ms']:.3f} ms; queue/"
        f"transform/reply/e2e p50 " + "/".join(
            f"{sect[f'{s}_p50_ms']:.3f}" for s in (
                "queue", "transform", "reply", "e2e"))
        + " ms, p99 " + "/".join(
            f"{sect[f'{s}_p99_ms']:.3f}" for s in (
                "queue", "transform", "reply", "e2e"))
        + f" ms; plan hits {sect['plan_hits']}, misses "
        f"{sect['plan_misses']} (= distinct buckets); peak "
        f"{sect.get('peak', 0) / 2**20:.1f} MiB")


def _serving_gbdt(dev, out):
    """(a) bench.py's serving model, fit on the card, served from the
    host plan."""
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.io import serve_pipeline
    from mmlspark_tpu_torch.models.gbdt.estimators import GBDTClassifier
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    from mmlspark_tpu_torch.reliability.metrics import reliability_metrics
    rng = np.random.default_rng(0)
    x = rng.normal(size=(SERVE_ROWS, SERVE_FEAT)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float32)
    torch.cuda.synchronize()
    hc.reset_launches()
    t0 = time.perf_counter()
    model = GBDTClassifier(num_iterations=20, max_depth=5).fit(
        Table({"features": x, "label": y}))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: v for k, v in hc.launches.items() if v}
    if launches.get("hist_tiled", 0) < 1:
        raise AssertionError(f"[serving] the fit launched {launches}")
    out["fit"] = dict(s=fit_s, launches=launches)
    body = json.dumps({"features": [0.1] * SERVE_FEAT})
    for tag, mode, clients, per in (("microbatch", "microbatch", 16, 125),
                                    ("continuous", "continuous", 4, 250)):
        reliability_metrics.reset("serving.")
        torch.cuda.reset_peak_memory_stats()
        server, q = serve_pipeline(model, ["features"], mode=mode,
                                   max_batch=256, batch_linger_ms=0.0)
        try:
            res = _serve_load(server, body, clients, per)
            sect = _serve_section(res, q.transform_fn)
        finally:
            q.stop()
            server.stop()
        sect["peak"] = torch.cuda.max_memory_allocated()
        out[tag] = sect
        _serve_log(f"(a) GBDT {tag}, {clients} x {per}", sect)
    server, q = serve_pipeline(model, ["features"], mode="continuous")
    try:
        _serve_statuses_ok(_serve_post_all(server.address, [body]), "warm")
        lat = []
        for _ in range(100):
            t0 = time.perf_counter()
            got = _serve_post_all(server.address, [body])
            lat.append(time.perf_counter() - t0)
            _serve_statuses_ok(got, "serial")
        lat.sort()
        out["serial"] = dict(p50_ms=lat[50] * 1e3, p99_ms=lat[99] * 1e3)
        log(f"[serving] (a) GBDT serial: p50 {lat[50] * 1e3:.3f} ms, p99 "
            f"{lat[99] * 1e3:.3f} ms (100 requests, new connection each)")
    finally:
        q.stop()
        server.stop()
    out["breakdown"] = _serving_breakdown(model)
    # 512 distinct rows, each served, against the card's offline transform
    rows = np.random.default_rng(1).normal(
        size=(SERVE_CHECK_ROWS, SERVE_FEAT)).astype(np.float32)
    offline = model.transform(Table({"features": rows}))
    bodies = [json.dumps({"features": r.tolist()}).encode() for r in rows]
    for col in ("prediction", "probabilities"):
        server, q = serve_pipeline(model, ["features"], output_col=col,
                                   max_batch=256)
        try:
            got = _serve_post_all(server.address, bodies)
        finally:
            q.stop()
            server.stop()
        _serve_statuses_ok(got, f"{col} check")
        served = np.asarray([json.loads(p)[col] for _, _, p in got])
        want = np.asarray(offline[col], np.float64).reshape(served.shape)
        err = float(np.abs(served - want).max())
        if (col == "prediction" and not np.array_equal(served, want)) or \
                err > _SERVE_PROBA_TOL:
            raise AssertionError(f"[serving] {col}: served rows differ "
                                 f"from the offline transform by {err}")
        out[f"{col}_err"] = err
    log(f"[serving] (a) {SERVE_CHECK_ROWS} distinct rows served: labels "
        f"equal to the card's transform, probabilities within "
        f"{out['probabilities_err']:.3g}; fit {fit_s:.3f} s, launches "
        f"{launches}")
    _serving_swap_and_fault(model, x, y, body, out)


def _serving_breakdown(model, n=16, reps=200):
    """Host ms of one served batch of `n` rows, outside HTTP: the GBDT
    host plan alone, the compiled transform (decode, plan, encode, the
    version split) without the quality tap, and with it (every row folded
    into the live sketches, the reference's default sample of 1.0)."""
    from mmlspark_tpu_torch.io.plan import compile_serving_transform
    from mmlspark_tpu_torch.telemetry import quality
    rows = np.random.default_rng(3).normal(
        size=(n, SERVE_FEAT)).astype(np.float32)
    bodies = [json.dumps({"features": r.tolist()}).encode() for r in rows]
    kernel = model._serving_kernel("prediction")

    def ms(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    out = {"plan_ms": ms(lambda: kernel(rows))}
    quality.reset_monitor()            # no reference: the tap is off
    tf = compile_serving_transform(model, ["features"])
    quality.reset_monitor()
    out["transform_ms"] = ms(lambda: tf(bodies))
    tf = compile_serving_transform(model, ["features"])   # installs it
    out["with_quality_ms"] = ms(lambda: tf(bodies))
    log(f"[serving] (a) a batch of {n} rows outside HTTP: host plan "
        f"{out['plan_ms']:.3f} ms, transform without the quality tap "
        f"{out['transform_ms']:.3f} ms, with it "
        f"{out['with_quality_ms']:.3f} ms")
    return out


def _serving_swap_and_fault(model, x, y, body, out):
    """A hot-swap to a second fit during load, then one injected worker
    death mid-load: no request dropped, every reply 200."""
    import threading
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.io import serve_pipeline
    from mmlspark_tpu_torch.models.gbdt.estimators import GBDTClassifier
    from mmlspark_tpu_torch.reliability.metrics import reliability_metrics
    from mmlspark_tpu_torch.telemetry import lineage
    from mmlspark_tpu_torch.telemetry import names as tnames
    flip = np.random.default_rng(2).permutation(SERVE_ROWS)
    model_b = GBDTClassifier(num_iterations=20, max_depth=5).fit(
        Table({"features": x[flip], "label": y[flip]}))
    reliability_metrics.reset()
    lineage.reset_version_registry()
    server, q = serve_pipeline(model, ["features"], max_batch=256)
    try:
        transform = q.transform_fn
        incumbent = transform.version
        results = []
        load = threading.Thread(target=lambda: results.append(
            _serve_load(server, body, 8, 100)), daemon=True)
        load.start()
        deadline = time.monotonic() + 30
        while (reliability_metrics.get(tnames.SERVING_REQUEST_TOTAL) < 100
               and time.monotonic() < deadline):
            time.sleep(0.001)
        swap = transform.install_model(model_b)
        load.join(timeout=120)
        if not results:
            raise AssertionError("[serving] the load across the swap "
                                 "failed")
        with_headers = _serve_post_all(server.address, [body])
        _serve_statuses_ok(with_headers, "after the swap")
        if with_headers[0][1].get("X-Model-Version") != swap["new"] or \
                swap["old"] != incumbent:
            raise AssertionError(f"[serving] swap {swap}, reply stamped "
                                 f"{with_headers[0][1]}")
        exp = json.loads(_urllib_get(server.address + "/versions"))
        counts = {v: e["metrics"]["counters"][tnames.SERVING_REQUEST_TOTAL]
                  for v, e in exp["versions"].items()}
        if sum(counts.values()) != 8 * 100 + 1 or \
                not counts.get(incumbent):
            raise AssertionError(f"[serving] /versions splits {counts}")
        out["swap"] = dict(requests=counts, **swap)
        # one injected worker death mid-load: replay answers every request
        results = []
        load = threading.Thread(target=lambda: results.append(
            _serve_load(server, body, 8, 100)), daemon=True)
        load.start()
        deadline = time.monotonic() + 30
        while (reliability_metrics.get(tnames.SERVING_REQUEST_TOTAL) < 1000
               and time.monotonic() < deadline):
            time.sleep(0.001)
        q.inject_fault(0)
        load.join(timeout=120)
        replayed = reliability_metrics.get(tnames.SERVING_REPLAYED_EPOCHS)
        if not results or q._recoveries < 1 or replayed < 1:
            raise AssertionError(f"[serving] injected fault: recoveries "
                                 f"{q._recoveries}, replayed {replayed}")
        out["fault"] = dict(recoveries=q._recoveries, replayed=replayed)
    finally:
        q.stop()
        server.stop()
    log(f"[serving] (a) hot-swap {swap['old']} -> {swap['new']} under 8 x "
        f"100 requests: none dropped, splits {counts}; one injected worker "
        f"death mid-load: {out['fault']['replayed']} epoch replayed, every "
        f"request answered 200")


def _urllib_get(url, timeout=30):
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def _serving_documents(n, seed=19):
    """`n` seeded documents of SERVE_DOC_WORDS words."""
    lo, hi = SERVE_DOC_WORDS
    docs = [d for d in _documents(4 * n, hi, seed=seed)
            if len(d.split()) >= lo]
    if len(docs) < n:
        raise AssertionError("[serving] too few documents")
    return docs[:n]


def _serving_encoder(dev, out):
    """(b) the encoder at its default Params on the card."""
    import threading
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.io import serve_pipeline
    from mmlspark_tpu_torch.models.dnn.transformer import \
        TransformerSentenceEncoder
    from mmlspark_tpu_torch.reliability.metrics import reliability_metrics
    enc = TransformerSentenceEncoder(input_col="text", output_col="emb")
    docs = _serving_documents(SERVE_DOCS)
    want = np.concatenate([
        enc.transform(Table({"text": np.array(docs[i:i + 32])}))["emb"]
        for i in range(0, len(docs), 32)])
    bodies = [json.dumps({"text": d}).encode() for d in docs]
    reliability_metrics.reset("serving.")
    torch.cuda.reset_peak_memory_stats()
    server, q = serve_pipeline(enc, ["text"], output_col="emb",
                               max_batch=64)
    served = {}
    lock = threading.Lock()
    nxt = itertools.count()
    local = threading.local()

    def post(_body):
        import http.client
        i = next(nxt)
        conn = getattr(local, "conn", None)
        if conn is None:
            host, port = server._httpd.server_address[:2]
            conn = local.conn = http.client.HTTPConnection(host, port,
                                                           timeout=60)
        conn.request("POST", "/", body=bodies[i])
        resp = conn.getresponse()
        payload = resp.read()
        if resp.status == 200:
            with lock:
                served[i] = json.loads(payload)["emb"]
        return resp.status, payload

    try:
        res = _serve_load(server, None, 8, SERVE_DOCS // 8, post=post)
        sect = _serve_section(res, q.transform_fn)
    finally:
        q.stop()
        server.stop()
    sect["peak"] = torch.cuda.max_memory_allocated()
    got = np.asarray([served[i] for i in range(SERVE_DOCS)])
    err = float(np.abs(got - want).max())
    if got.shape != want.shape or not np.isfinite(got).all() or \
            err > _SERVE_EMB_TOL:
        raise AssertionError(f"[serving] encoder: served embeddings "
                             f"{got.shape} differ from the transform by "
                             f"{err}")
    sect["emb_err"] = err
    words = [len(d.split()) for d in docs]
    sect["words"] = (min(words), max(words), sum(words))
    sect["tokens_per_s"] = sum(words) * res.req_per_sec / len(docs)
    out["encoder"] = sect
    _serve_log(f"(b) encoder d_model {enc.d_model}, 8 clients, "
               f"{SERVE_DOCS} documents of {min(words)}-{max(words)} words",
               sect)
    log(f"[serving] (b) embeddings within {err:.3g} of the card's "
        f"transform; {sect['tokens_per_s']:.4g} tokens/s served")


def _serve_unscoped(net, state, x, batch):
    """The DNNModel's output with the port's TF32 scope taken out
    (`device.exact_f32` made a no-op where the path enters it)."""
    import contextlib
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.models.dnn import model as dnn_model
    from mmlspark_tpu_torch.models.dnn import resnet as rn
    with contextlib.ExitStack() as undo:
        for mod in (rn, dnn_model):
            undo.callback(setattr, mod, "exact_f32", mod.exact_f32)
            mod.exact_f32 = contextlib.nullcontext
        return dnn_model.DNNModel(apply_fn=net, params=state,
                                  batch_size=batch).transform(
                                      Table({"features": x}))["scores"]


def _serving_dnn(dev, out):
    """(c) a ResNet-18 f32 DNNModel on two partitions, TF32 flag ON."""
    import threading
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.io import serve_pipeline
    from mmlspark_tpu_torch.models.dnn import model as dnn_model
    from mmlspark_tpu_torch.models.dnn import resnet as rn
    cfg = SERVE_DNN
    net = rn.resnet18(num_classes=cfg["classes"])
    state = rn.resnet_params_from_numpy(rn.init_resnet(net, seed=1), dev)
    m = dnn_model.DNNModel(apply_fn=net, params=state,
                           batch_size=cfg["batch"])
    x = np.random.default_rng(6).random(
        (cfg["images"], 3, cfg["size"], cfg["size"])).astype(np.float32)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        # the single-threaded output, from a twin of the served model (a
        # model that has transformed exports its graph when installed)
        want = dnn_model.DNNModel(apply_fn=net, params=state,
                                  batch_size=cfg["batch"]).transform(
                                      Table({"features": x}))["scores"]
        unscoped = _serve_unscoped(net, state, x, cfg["batch"])
        server, q = serve_pipeline(m, ["features"], output_col="scores",
                                   num_partitions=2, max_batch=cfg["batch"])
        got = {}

        def client(lo):
            bodies = [json.dumps({"features": x[i].tolist()}).encode()
                      for i in range(lo, cfg["images"], 4)]
            replies = _serve_post_all(server.address, bodies)
            _serve_statuses_ok(replies, "dnn")
            for k, (_, _, p) in enumerate(replies):
                got[lo + 4 * k] = json.loads(p)["scores"]

        try:
            threads = [threading.Thread(target=client, args=(lo,),
                                        daemon=True) for lo in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
        finally:
            q.stop()
            server.stop()
    finally:
        torch.backends.cudnn.allow_tf32 = before
    if sorted(got) != list(range(cfg["images"])):
        raise AssertionError(f"[serving] dnn: replies {sorted(got)}")
    served = np.asarray([got[i] for i in range(cfg["images"])])
    scale = float(np.abs(want).max())
    err = float(np.abs(served - want).max()) / scale
    unscoped_err = float(np.abs(unscoped - want).max()) / scale
    if err > _SERVE_DNN_TOL or unscoped_err <= _SERVE_DNN_TOL:
        raise AssertionError(f"[serving] dnn: two partitions {err:.3g}, "
                             f"unscoped TF32 {unscoped_err:.3g} against "
                             f"{_SERVE_DNN_TOL}")
    out["dnn"] = dict(err=err, unscoped_err=unscoped_err)
    log(f"[serving] (c) ResNet-18 f32 DNNModel on 2 partitions, TF32 flag "
        f"on: {cfg['images']} replies within {err:.3g} (relative) of the "
        f"single-threaded output; with the TF32 scope taken out "
        f"{unscoped_err:.3g}")


def serving_phase(dev):
    """[serving]: the HTTP serving path on the card."""
    import torch
    from mmlspark_tpu_torch.telemetry import lineage, quality
    t_phase = time.perf_counter()
    out = {}
    quality.reset_monitor()
    lineage.reset_version_registry()
    _serving_gbdt(dev, out)
    torch.cuda.empty_cache()
    _serving_encoder(dev, out)
    torch.cuda.empty_cache()
    _serving_dnn(dev, out)
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_phase
    log(f"[serving] the phase {out['s']:.1f} s")
    return out


# ------------------------------------------------------------- [fleet]
# (a) the isolation forest: 1M x 16 seeded rows, 1% shifted by +4 in
# every feature; the reference's defaults (models/isolation_forest.py:
# 61-65), a supervisor checkpoint every 25 trees
FLEET_IF = dict(rows=1_000_000, features=16, outliers=0.01, shift=4.0,
                trees=100, max_samples=256, checkpoint_every=25)
FLEET_IF_CHECK = 65536        # rows held against the port's CPU path
FLEET_IF_SERVE = 256          # rows served and held against transform
_FLEET_IF_RTOL = 1e-6
_FLEET_AUC_MIN = 0.9
# (b) SAR at the shape of MovieLens-1M (6,040 users, 3,706 items,
# 1,000,209 ratings), synthetic: Zipf item popularity (a = 1), each
# (user, item) pair rated once, ratings 1-5, timestamps over three years
FLEET_SAR = dict(users=6040, items=3706, events=1_000_209, years=3, k=10,
                 support=2, decay_days=30, positions=4)
FLEET_SAR_CHECK = 512         # users held against float64 numpy
# (b) also an implicit-feedback log at the same users, items and event
# count: (user, item) pairs Zipf-popular (a = 1.2), so pairs repeat (the
# most-used one ~1e5 times), no ratings; its affinity against float64
FLEET_SAR_ZIPF = 1.2
_FLEET_SAR_RTOL = 1e-6
# (c) KNN: 100,000 x 128 index vectors, 8,192 queries, 16 labels
FLEET_KNN = dict(index=100_000, dim=128, queries=8192, k=10, labels=16)
FLEET_KNN_CHECK = 512         # queries held against the port's CPU path
_FLEET_TIE_RTOL = 1e-5        # two scores this close are a tie
_FLEET_DIST_RTOL = 1e-5
# (d) two gloo ranks on the card behind the registry; 500 requests, cut
# from 2,000 to pay for [cyber] (every check holds on the shorter run)
FLEET_REQUESTS = 500
FLEET_AFTER_DRAIN = 50
_FLEET_PROC = """
import json, os, signal, sys, time
import numpy as np
import torch
sys.path.insert(0, {here!r})
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from mmlspark_tpu_torch.core import PipelineStage
from mmlspark_tpu_torch.io import (RegistryClient, compile_serving_transform,
                                   list_services, start_distributed_serving)
from mmlspark_tpu_torch.io.serving import drain_on_signal
from mmlspark_tpu_torch.ops import flash_attention as fa
from mmlspark_tpu_torch.ops import histogram_cuda as hc
from mmlspark_tpu_torch.parallel import cluster
from mmlspark_tpu_torch.reliability.metrics import reliability_metrics
from mmlspark_tpu_torch.telemetry import names as tnames
from mmlspark_tpu_torch.telemetry.exposition import scrape_cluster
from mmlspark_tpu_torch.telemetry.lineage import rollout_skew

rank, tmp, cfg = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
cluster.initialize_cluster(init_method="file://" + os.path.join(tmp, "rdv"),
                           num_processes=2, process_id=rank, timeout_s=300)
assert cluster.backend_name() == "gloo", cluster.backend_name()
torch.cuda.set_device(cluster.local_device())
model = PipelineStage.load(cfg["model"])
transform = compile_serving_transform(model, ["user"],
                                      output_col="recommendations")
registry, server, query, addr = start_distributed_serving(
    transform, name="sar", num_partitions=1, mode="continuous")
pids = cluster.all_gather_object(os.getpid())
if rank == 1:
    query.inject_fault(0)     # the next batch read dies before its commit
cluster.barrier("armed")
res = dict()
if rank == 0:
    want = np.load(cfg["want"])
    users = np.random.default_rng(23).integers(0, want.shape[0],
                                               cfg["requests"])
    client = RegistryClient(addr, "sar")
    lat, bad, wrong = [], [], 0
    t0 = time.perf_counter()
    for u in users:
        t1 = time.perf_counter()
        status, body = client.post(json.dumps(dict(user=int(u))).encode())
        lat.append(time.perf_counter() - t1)
        if status != 200:
            bad.append(status)
            continue
        items = json.loads(body)["recommendations"][0]
        wrong += items != want[u, 0].tolist()
    wall = time.perf_counter() - t0
    res.update(req_per_s=len(users) / wall, wall_s=wall, bad=bad,
               wrong=wrong, p50_ms=float(np.percentile(lat, 50)) * 1e3,
               p99_ms=float(np.percentile(lat, 99)) * 1e3,
               client_total=len(users))
    snap = scrape_cluster(addr, "sar", versions=True)
    res["merged_total"] = snap.merged.get(tnames.SERVING_REQUEST_TOTAL)
    res["per_worker"] = [st["counters"].get(tnames.SERVING_REQUEST_TOTAL, 0)
                         for _, st in snap.workers]
cluster.barrier("traffic")
res["recoveries"] = query._recoveries
if rank == 1:
    swap = transform.install_model(model.copy(dict(remove_seen=True)))
    res["swap"] = [swap["old"], swap["new"]]
cluster.barrier("swapped")
if rank == 0:
    snap = scrape_cluster(addr, "sar", versions=True)
    res["skew"] = rollout_skew(snap.versions["current_by_worker"])
cluster.barrier("scraped")
if rank == 1:
    # the port's drain: the stopping server unregisters itself, answers
    # what is in flight, then the query stops
    drain_on_signal(servers=[server], queries=[query], exit_code=None)
cluster.barrier("handler_set")
if rank == 0:
    t0 = time.perf_counter()
    os.kill(pids[1], signal.SIGTERM)
    while time.perf_counter() - t0 < 30 and len(
            list_services(addr, "sar")) != 1:
        time.sleep(0.02)
    res["left_s"] = time.perf_counter() - t0
    res["left"] = [s.process_id for s in list_services(addr, "sar")]
    # rank 1's server is down now, not mid-drain (where it answers 503)
    cluster.barrier("drained")
    res["after_drain"] = [
        client.post(json.dumps(dict(user=int(u))).encode())[0]
        for u in range(cfg["after"])]
else:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 60 and reliability_metrics.get(
            tnames.SERVING_SIGNAL_DRAINS) < 1:
        time.sleep(0.02)
    # the handler runs whole on this thread before the loop reads on
    res["drained"] = not server._thread.is_alive()
    res["signal_drains"] = reliability_metrics.get(
        tnames.SERVING_SIGNAL_DRAINS)
    cluster.barrier("drained")
cluster.barrier("down")
res["launches"] = dict(**hc.launches, **fa.launches)
with open(os.path.join(tmp, "fleet_%d.json" % rank), "w") as f:
    json.dump(res, f)
if rank == 0:
    query.stop()
    server.stop()
    registry.stop()
cluster.barrier("stopped")
cluster.shutdown()
"""


def _fleet_topk_check(idx, exact, k, what):
    """Each row of `idx` (n, k) against the float64 scores `exact`
    (n, m): its entries' exact scores are the k largest, in order, up to
    ties (scores within `_FLEET_TIE_RTOL` of each other). Returns the
    rows whose list differs from the stable float64 order (at ties)."""
    order = np.argsort(-exact, axis=1, kind="stable")[:, :k]
    top = np.take_along_axis(exact, order, axis=1)
    got = np.take_along_axis(exact, idx.astype(np.int64), axis=1)
    tol = _FLEET_TIE_RTOL * np.maximum(np.abs(top), 1e-30)
    finite = np.isfinite(top)
    off = np.where(finite, np.abs(got - top) > tol, got != top)
    if off.any():
        r = int(np.argwhere(off)[0][0])
        raise AssertionError(f"[fleet] {what}: row {r} is not a top-{k} "
                             f"list: {idx[r].tolist()} scores "
                             f"{got[r].tolist()} against {top[r].tolist()}")
    return int((idx != order).any(axis=1).sum())


def _fleet_iforest(dev, tmp, out):
    """(a) the isolation forest: the supervised fit, every row scored on
    the card, 65,536 rows against the CPU path, the outliers' AUC, and
    the serving plan's replies against `transform`."""
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.io.serving import serve_pipeline
    from mmlspark_tpu_torch.train.metrics import auc
    from mmlspark_tpu_torch.workloads import IsolationForestScorer
    cfg = FLEET_IF
    rng = np.random.default_rng(20)
    n = cfg["rows"]
    x = rng.standard_normal((n, cfg["features"]), dtype=np.float32)
    y = np.zeros(n, np.int64)
    y[rng.choice(n, int(n * cfg["outliers"]), replace=False)] = 1
    x[y == 1] += np.float32(cfg["shift"])
    table = Table({"features": x})
    t0 = time.perf_counter()
    model = IsolationForestScorer(
        num_estimators=cfg["trees"], max_samples=cfg["max_samples"], seed=0,
        checkpoint_dir=os.path.join(tmp, "iforest"),
        checkpoint_every=cfg["checkpoint_every"]).fit(table)
    fit_s = time.perf_counter() - t0
    head = Table({"features": x[:FLEET_IF_CHECK]})
    model.transform(head)                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = model.transform(table)["outlierScore"]
    score_s = time.perf_counter() - t0
    cpu = model.copy({"device": "cpu"})
    want = cpu.transform(head)["outlierScore"]
    err = float(np.max(np.abs(scores[:FLEET_IF_CHECK] - want)
                       / np.abs(want)))
    area = auc(y, scores)
    server, q = serve_pipeline(model, ["features"], output_col="outlierScore")
    try:
        replies = _serve_post_all(server.address, [json.dumps(
            {"features": x[i].tolist()}).encode()
            for i in range(FLEET_IF_SERVE)])
    finally:
        q.stop()
        server.stop()
    _serve_statuses_ok(replies, "isolation forest")
    served = np.array([json.loads(p)["outlierScore"] for _, _, p in replies])
    served_equal = bool(np.array_equal(served, scores[:FLEET_IF_SERVE]))
    out["iforest"] = dict(fit_s=fit_s, score_s=score_s,
                          rows_per_s=n / score_s, max_rel_err=err, auc=area,
                          served_equal=served_equal)
    log(f"[fleet] (a) IsolationForestScorer, {cfg['trees']} trees of "
        f"{cfg['max_samples']} on {n} x {cfg['features']} rows "
        f"({int(y.sum())} outliers), a checkpoint every "
        f"{cfg['checkpoint_every']} trees: fit {fit_s:.3f} s; scored on the "
        f"card in {score_s:.4f} s = {n / score_s:.4g} rows/s; "
        f"{FLEET_IF_CHECK} rows {err:.3g} from the CPU path (rtol "
        f"{_FLEET_IF_RTOL}); AUC {area:.6f} (> {_FLEET_AUC_MIN}); "
        f"{FLEET_IF_SERVE} served replies equal transform: {served_equal}")
    if err > _FLEET_IF_RTOL or area <= _FLEET_AUC_MIN or not served_equal:
        raise AssertionError("[fleet] (a) the isolation forest failed its "
                             "checks")


def _ml1m_events(cfg):
    """MovieLens-1M-shaped events from the seed: every (user, item) pair
    once, items drawn with Zipf popularity (a = 1) over a shuffled id
    space, ratings 1-5, timestamps uniform over `years` years."""
    rng = np.random.default_rng(21)
    users, items, n = cfg["users"], cfg["items"], cfg["events"]
    pop = 1.0 / np.arange(1, items + 1)
    ids = rng.permutation(items)
    keys = np.zeros(0, np.int64)
    while True:
        u = rng.integers(0, users, 2 * n)
        it = ids[rng.choice(items, 2 * n, p=pop / pop.sum())]
        keys = np.concatenate([keys, u * items + it])
        _, first = np.unique(keys, return_index=True)
        if len(first) >= n:
            break
    keys = keys[np.sort(first)[:n]]
    t0 = 1.0e9
    ev = {"user": keys // items, "item": keys % items,
          "rating": rng.integers(1, 6, n).astype(np.float64),
          "timestamp": rng.uniform(t0, t0 + cfg["years"] * 365 * 86400.0, n)}
    if ev["user"].max() + 1 != users or ev["item"].max() + 1 != items:
        raise AssertionError("[fleet] the MovieLens-1M shape was not drawn")
    return ev


def _implicit_events(cfg):
    """An implicit-feedback log from the seed: `events` (user, item)
    pairs drawn with Zipf popularity over the pair space (a bijective
    hash spreads the ranks), no ratings, timestamps over `years` years."""
    rng = np.random.default_rng(22)
    users, items, n = cfg["users"], cfg["items"], cfg["events"]
    pairs = users * items
    keys = (rng.zipf(FLEET_SAR_ZIPF, n) % pairs) * 2_654_435_761 % pairs
    t0 = 1.0e9
    return {"user": keys // items, "item": keys % items,
            "timestamp": rng.uniform(t0, t0 + cfg["years"] * 365 * 86400.0,
                                     n)}


def _fleet_sar_implicit(est, cfg):
    """Two card fits of the implicit log (equal bit for bit; the last
    one timed) and the affinity against float64 numpy's sums."""
    import torch
    from mmlspark_tpu_torch import Table
    ev = _implicit_events(cfg)
    fits = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits.append((est.fit(Table(ev)), time.perf_counter() - t0))
    (model, _), (again, fit_s) = fits
    same = bool(np.array_equal(model._affinity, again._affinity)
                and np.array_equal(model._similarity, again._similarity))
    ts = ev["timestamp"]
    w = np.power(2.0, -(ts.max() - ts) / (cfg["decay_days"] * 86400.0))
    n_u, n_i = model._affinity.shape
    want = np.zeros((n_u, n_i))
    np.add.at(want, (ev["user"], ev["item"]), w)
    want = want.astype(np.float32)
    nz = want != 0
    rel = float(np.max(np.abs(model._affinity[nz] - want[nz]) / want[nz]))
    reps = np.unique(ev["user"] * n_i + ev["item"], return_counts=True)[1]
    return dict(fit_s=fit_s, first_fit_s=fits[0][1], same_fit=same,
                rel_f64=rel, zero_equal=bool(
                    np.array_equal(model._affinity[~nz], want[~nz])),
                pairs=int(len(reps)), max_repeat=int(reps.max()))


def _fleet_sar(dev, tmp, out):
    """(b) SAR at the shape of MovieLens-1M: two fits on the card (equal
    bit for bit), top-10 for every user on a 1- and a 4-position mesh
    (equal), 512 users against float64 numpy. Returns the model and the
    1-position answer."""
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.parallel import data_mesh
    from mmlspark_tpu_torch.workloads import SARServing
    cfg = FLEET_SAR
    ev = _ml1m_events(cfg)
    est = SARServing(similarity_function="jaccard",
                     support_threshold=cfg["support"],
                     time_decay_coeff=cfg["decay_days"],
                     num_recommendations=cfg["k"])
    fits = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits.append((est.fit(Table(ev)), time.perf_counter() - t0))
    (model, _), (again, fit_s) = fits
    same = bool(np.array_equal(model._affinity, again._affinity)
                and np.array_equal(model._similarity, again._similarity))
    ids = np.arange(cfg["users"])
    answers, times = {}, {}
    for p in (1, cfg["positions"]):
        plan = model.recommend_plan(mesh=data_mesh(
            devices=[dev] * p, span_processes=False))
        plan(ids[:64])                          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers[p] = plan(ids)
        times[p] = time.perf_counter() - t0
    meshes_equal = bool(np.array_equal(answers[1], answers[cfg["positions"]]))
    chk = FLEET_SAR_CHECK
    exact = (model._affinity[:chk].astype(np.float64)
             @ model._similarity.astype(np.float64))
    tied_rows = _fleet_topk_check(answers[1][:chk, 0], exact, cfg["k"],
                                  "SAR top-10")
    # users outside the fitted range answer -1 / NaN on the card, and
    # the card keeps answering (no device-side assert)
    probe = np.array([-1, cfg["users"], 10**6, 0])
    rec = model.recommend_for_user_subset(probe, cfg["k"])
    unknown_ok = bool(
        (rec["recommendations"][:3] == -1).all()
        and np.isnan(rec["ratings"][:3]).all()
        and np.array_equal(rec["recommendations"][3], answers[1][0, 0])
        and np.array_equal(model.recommend_plan()(ids[:64]),
                           answers[1][:64]))
    implicit = _fleet_sar_implicit(est, cfg)
    out["sar"] = dict(fit_s=fit_s, first_fit_s=fits[0][1],
                      unknown_ok=unknown_ok, implicit=implicit,
                      users_per_s=cfg["users"] / times[1],
                      users_per_s_mesh=cfg["users"] / times[cfg["positions"]],
                      same_fit=same, meshes_equal=meshes_equal,
                      tied_rows=tied_rows,
                      nonzero_affinity=int((model._affinity > 0).sum()))
    log(f"[fleet] (b) SARServing jaccard, support {cfg['support']}, decay "
        f"{cfg['decay_days']} days on {cfg['users']} users x {cfg['items']} "
        f"items, {cfg['events']} events: fit {fit_s:.3f} s on the card "
        f"(first {fits[0][1]:.3f} s), two fits bit-identical: {same}; "
        f"top-{cfg['k']} for every user {cfg['users'] / times[1]:.4g} "
        f"users/s on 1 position, {cfg['users'] / times[cfg['positions']]:.4g}"
        f" on {cfg['positions']}, equal: {meshes_equal}; {chk} users match "
        f"float64 numpy ({tied_rows} rows differ only at ties); unknown "
        f"users -1/NaN with the card still answering: {unknown_ok}")
    log(f"[fleet] (b) implicit log, {cfg['events']} events on "
        f"{implicit['pairs']} pairs (one repeated {implicit['max_repeat']} "
        f"times): fit {implicit['fit_s']:.3f} s on the card (first "
        f"{implicit['first_fit_s']:.3f} s), two fits bit-identical: "
        f"{implicit['same_fit']}; affinity {implicit['rel_f64']:.3g} from "
        f"float64 numpy (rtol {_FLEET_SAR_RTOL})")
    if not (same and meshes_equal and unknown_ok and implicit["same_fit"]
            and implicit["zero_equal"]
            and implicit["rel_f64"] <= _FLEET_SAR_RTOL):
        raise AssertionError("[fleet] (b) SAR failed its checks")
    return model, answers[1]


def _fleet_knn(dev, out):
    """(c) KNN and ConditionalKNN on the card with the caller's cuBLAS
    TF32 flag ON: 8,192 queries timed, 512 held against the CPU path and
    float64 numpy."""
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.nn import KNN, ConditionalKNN
    cfg = FLEET_KNN
    rng = np.random.default_rng(22)
    x = rng.standard_normal((cfg["index"], cfg["dim"]), dtype=np.float32)
    labels = rng.integers(0, cfg["labels"], cfg["index"])
    q = rng.standard_normal((cfg["queries"], cfg["dim"]), dtype=np.float32)
    conds = np.empty(cfg["queries"], dtype=object)
    for i in range(cfg["queries"]):
        conds[i] = rng.choice(cfg["labels"], size=rng.integers(1, 5),
                              replace=False).tolist()
    index = Table({"features": x, "values": np.arange(cfg["index"]),
                   "labels": labels})
    queries = Table({"features": q, "conditioner": conds})
    chk = FLEET_KNN_CHECK
    head = Table({"features": q[:chk], "conditioner": conds[:chk]})
    exact = q[:chk].astype(np.float64) @ x.astype(np.float64).T
    allowed = np.stack([np.isin(labels, c) for c in conds[:chk]])
    matmul = torch.backends.cuda.matmul
    matmul.allow_tf32 = True
    try:
        xd = torch.as_tensor(x, device=dev)
        tf32 = (torch.as_tensor(q[:chk], device=dev) @ xd.t()).cpu().numpy()
        tf32_err = float(np.max(np.abs(tf32 - exact) / np.abs(exact).max()))
        del xd
        for name, est in (("knn", KNN(k=cfg["k"])),
                          ("conditional", ConditionalKNN(k=cfg["k"]))):
            model = est.fit(index)
            model.transform(head)               # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = model.transform(queries)
            s = time.perf_counter() - t0
            want = model.copy({"device": "cpu"}).transform(head)
            dist_err = float(np.max(np.abs(
                got["output.distance"][:chk] - want["output.distance"])
                / np.abs(want["output.distance"])))
            ex = exact if name == "knn" else np.where(allowed, exact, -np.inf)
            tied = _fleet_topk_check(got["output.value"][:chk], ex,
                                     cfg["k"], f"{name} on the card")
            _fleet_topk_check(want["output.value"], ex, cfg["k"],
                              f"{name} on the CPU")
            swapped = int((got["output.value"][:chk]
                           != want["output.value"]).any(axis=1).sum())
            out[name] = dict(queries_per_s=cfg["queries"] / s, s=s,
                             dist_err=dist_err, tied_rows=tied,
                             rows_unlike_cpu=swapped)
            log(f"[fleet] (c) {name}: {cfg['queries']} queries x "
                f"{cfg['index']} x {cfg['dim']}, k={cfg['k']} in {s:.4f} s "
                f"= {cfg['queries'] / s:.4g} queries/s; {chk} queries: "
                f"distances {dist_err:.3g} from the CPU path (rtol "
                f"{_FLEET_DIST_RTOL}), {swapped} rows ordered unlike it, all "
                f"at ties; top-{cfg['k']} of float64 numpy up to ties")
            if dist_err > _FLEET_DIST_RTOL:
                raise AssertionError(f"[fleet] (c) {name} disagrees")
        flag = matmul.allow_tf32
    finally:
        matmul.allow_tf32 = False
    out["tf32_unscoped_err"] = tf32_err
    log(f"[fleet] (c) cuBLAS's TF32 flag was ON around the searches and is "
        f"still ON after them: {flag}; the same product unscoped is "
        f"{tf32_err:.3g} (of the largest |score|) from float64")
    if flag is not True:
        raise AssertionError("[fleet] the port's f32 scope leaked")


def _fleet_distributed(dev, tmp, model, want, out):
    """(d) two gloo ranks on the card serving SAR's id-keyed plan behind
    the leader's registry (the child script `_FLEET_PROC`)."""
    path = os.path.join(tmp, "sar_model")
    model.save(path)
    np.save(os.path.join(tmp, "want.npy"), want)
    script = os.path.join(tmp, "fleet.py")
    with open(script, "w") as fh:
        fh.write(_FLEET_PROC.format(here=HERE))
    cfg = dict(model=path, want=os.path.join(tmp, "want.npy"),
               requests=FLEET_REQUESTS, after=FLEET_AFTER_DRAIN)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), tmp, json.dumps(cfg)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=300)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for r, (pr, o) in enumerate(zip(procs, outs)):
        if pr.returncode != 0:
            raise AssertionError(f"[fleet] rank {r} exited "
                                 f"{pr.returncode}:\n{o[-3000:]}")
    r0, r1 = (json.load(open(os.path.join(tmp, f"fleet_{r}.json")))
              for r in range(2))
    wall = time.perf_counter() - t0
    old, new = r1["swap"]
    checks = {
        "every reply 200": not r0["bad"],
        "replies equal the card's plan": r0["wrong"] == 0,
        "both ranks served": min(r0["per_worker"]) > 0
        and len(r0["per_worker"]) == 2,
        "worker death healed by replay": r1["recoveries"] >= 1,
        "merged count equals the client's":
            r0["merged_total"] == r0["client_total"],
        "rollout skew one worker each": r0["skew"] == {old: 1, new: 1},
        "rank 1 drained on SIGTERM": r1["drained"]
        and r1["signal_drains"] == 1,
        "its entry left the registry": r0["left"] == [0],
        "later requests fail over": r0["after_drain"]
        == [200] * FLEET_AFTER_DRAIN,
        "no kernel launched": not any(r0["launches"].values())
        and not any(r1["launches"].values())}
    out["distributed"] = dict(
        req_per_s=r0["req_per_s"], p50_ms=r0["p50_ms"], p99_ms=r0["p99_ms"],
        requests=r0["client_total"], per_worker=r0["per_worker"],
        recoveries=r1["recoveries"], left_s=r0["left_s"], s=wall)
    log(f"[fleet] (d) 2 gloo ranks on the card, SAR's id-keyed plan behind "
        f"the registry: {r0['client_total']} requests from a RegistryClient "
        f"{r0['req_per_s']:.1f} req/s, p50 {r0['p50_ms']:.3f} ms, p99 "
        f"{r0['p99_ms']:.3f} ms; per rank {r0['per_worker']}; rank 1 "
        f"recoveries {r1['recoveries']}; merged scrape "
        f"{r0['merged_total']}; skew after rank 1's swap {r0['skew']}; "
        f"SIGTERM to rank 1 out of the registry in {r0['left_s']:.3f} s, "
        f"{FLEET_AFTER_DRAIN} later requests {sorted(set(r0['after_drain']))}"
        f"; {wall:.1f} s with start-up; " + ", ".join(
            f"{k}: {v}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"[fleet] (d) failed: " + ", ".join(
            k for k, v in checks.items() if not v))


def fleet_phase(dev):
    """[fleet]: the fleet workloads and distributed serving on the card
    (no kernel of their own: gathers, cuBLAS products and torch top-k).
    Every kernel wrapper's launch count must stand still across it."""
    import tempfile

    import torch
    from mmlspark_tpu_torch.ops import flash_attention as fa
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    from mmlspark_tpu_torch.telemetry import lineage, quality
    t_phase = time.perf_counter()
    before = dict(**hc.launches, **fa.launches)
    quality.reset_monitor()
    lineage.reset_version_registry()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        _fleet_iforest(dev, tmp, out)
        torch.cuda.empty_cache()
        model, answer = _fleet_sar(dev, tmp, out)
        torch.cuda.empty_cache()
        _fleet_knn(dev, out)
        torch.cuda.empty_cache()
        _fleet_distributed(dev, tmp, model, answer, out)
    after = dict(**hc.launches, **fa.launches)
    if after != before:
        raise AssertionError(f"[fleet] a kernel launched: {before} -> "
                             f"{after}")
    out["s"] = time.perf_counter() - t_phase
    log(f"[fleet] kernel launches unchanged across the phase: {after}; the "
        f"phase {out['s']:.1f} s")
    return out


# ---------------------------------------------------------------- [online]
# (a) the Criteo display-ads layout (Kaggle Display Advertising Challenge:
# 13 integer features I1-I13, 26 categorical C1-C26) at VW's default 18
# bits; the categorical namespaces' cardinalities are the challenge's
# training set's, capped at ONLINE_VOCAB_CAP (values drawn Zipf: the tail
# past the cap is rarely drawn, and the hash space holds 2^18)
CRITEO_VOCAB = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145,
                5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4,
                7046547, 18, 15, 286181, 105, 142572)
ONLINE_ROWS = 1_000_000
ONLINE_HOLDOUT = 100_000
ONLINE_BITS = 18
ONLINE_BATCH = 256
ONLINE_VOCAB_CAP = 20_000
ONLINE_DP_POSITIONS = 4
ONLINE_CPU_ROWS = 50_000    # rows of the card-against-CPU fit
ONLINE_BFGS_ITERS = 25
ONLINE_BANDIT_ROWS = 200_000
ONLINE_BANDIT_SWEEP = ({"learning_rate": 0.1}, {"learning_rate": 0.5},
                       {"l2": 1e-6}, {"power_t": 0.3})
ONLINE_PIPE_ROWS = 20_000
# (b)-(d): bench.py::_bench_online's configuration
ONLINE_SERVE = dict(rows=20_000, k=16, bits=16, passes=4, clients=16,
                    per_client=125, max_batch=128)
ONLINE_CHECK_ROWS = 512
ONLINE_CHUNKS = 64
ONLINE_CHUNK_ROWS = 256
ONLINE_SHIFT_REQUESTS = 72
_ONLINE_CARD_TOL = 1e-5     # card weights against the CPU fit, of max |w|
# the other fits: AdaGrad divides a slot's first gradient by
# sqrt(g^2 + 1e-8), so the rounding of a sum that nearly cancels moves a
# rare slot's step by up to lr * 1e-4 of its size; on the CPU alone, these
# fits move by 1.1e-5 (4 positions) to 7.9e-3 (a bandit policy at lr 0.5)
# of max |w| when their segment sums are rounded from float64. The card
# against the CPU: 1.31e-5 (4 positions), 2.33e-5 (the bandit at lr 0.1);
# the bandit's lr 0.5 policies (6.68e-3) are held by an AUC floor instead
_ONLINE_FIT_TOL = 1e-4
# BFGS against the CPU at the gpu test's 6 iterations: L-BFGS amplifies
# the f32 summation differences of its gradient (1.55e-4 of max |w| at
# 12 iterations, 2.76e-3 at 25, on the card); the 25-iteration fit clears
# ONLINE_AUC_FLOOR
_ONLINE_BFGS_TOL = 1e-4
ONLINE_BFGS_CHECK_ITERS = 6
_ONLINE_MARGIN_TOL = 1e-5   # served margins against predict_vw, of max |m|
ONLINE_AUC_FLOOR = 0.7      # every holdout fit; a diverged fit is near 0.5
# a bandit policy's mean predicted cost against the click: IPS weights up
# to 10 at lr 0.5 reach 0.61 on the CPU, lr 0.1 0.745
ONLINE_BANDIT_AUC_FLOOR = 0.55


def _zipf_ranks(rng, n, vocab):
    """n draws of ranks 0..vocab-1, Zipf with exponent 1 (P(r) near
    1/(r+1)) by the inverse of its continuous CDF, (vocab+1)^u - 1."""
    r = np.floor(np.exp(rng.random(n) * np.log(vocab + 1.0))) - 1.0
    return np.clip(r, 0, vocab - 1).astype(np.int64)


def _criteo_rows(n, seed, bits=ONLINE_BITS, strings=False):
    """Seeded Criteo-shaped rows: the hashed (idx, val) pairs the
    featurizer makes of I1-I13 (log1p of lognormal counts) and C1-C26
    (hex tokens drawn Zipf), labels from a hidden logistic model over the
    hashed slots (about a quarter positive, Criteo's click rate). With
    `strings`, also the raw table the featurizer reads."""
    from mmlspark_tpu_torch.models.vw.featurizer import namespace_seed
    from mmlspark_tpu_torch.ops.hashing import murmur3_32
    rng = np.random.default_rng(seed)
    mask = (1 << bits) - 1
    counts = np.floor(rng.lognormal(1.0, 1.5, size=(n, 13)))
    num = np.log1p(counts).astype(np.float32)
    idx = np.empty((n, 39), np.int32)
    val = np.ones((n, 39), np.float32)
    val[:, :13] = num
    raw = {}
    for j in range(13):
        name = f"I{j + 1}"
        idx[:, j] = murmur3_32(name.encode(), namespace_seed(name)) & mask
        raw[name] = num[:, j]
    for j, card in enumerate(CRITEO_VOCAB):
        name = f"C{j + 1}"
        vocab = min(card, ONLINE_VOCAB_CAP)
        ranks = _zipf_ranks(rng, n, vocab)
        # each value's token is a fixed hex string of its rank; only the
        # ranks drawn are hashed
        seen, inverse = np.unique(ranks, return_inverse=True)
        seed_j = namespace_seed(name)
        codes = np.fromiter(
            (murmur3_32(f"{name}={(r * 2654435761) & 0xFFFFFFFF:08x}"
                        .encode(), seed_j) & mask for r in seen),
            np.int64, count=len(seen))
        idx[:, 13 + j] = codes[inverse]
        if strings:
            raw[name] = np.array([f"{(r * 2654435761) & 0xFFFFFFFF:08x}"
                                  for r in ranks], dtype=object)
    truth = np.random.default_rng(1234).normal(
        0.0, 0.25, size=1 << bits).astype(np.float32)
    margin = (truth[idx] * val).sum(1) - 2.1
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
    return idx, val, y, raw


def _online_metrics(p, y):
    """Holdout logloss (scores clipped to [1e-15, 1 - 1e-15]) and AUC (of
    the unclipped scores, so a regressor's scores outside [0, 1] keep
    their order)."""
    from mmlspark_tpu_torch.train.metrics import auc
    p = np.asarray(p, np.float64)
    q = np.clip(p, 1e-15, 1 - 1e-15)
    logloss = float(-np.mean(y * np.log(q) + (1 - y) * np.log1p(-q)))
    return logloss, float(auc(y, p))


def _online_fit(tag, est, table, hold, out):
    """One timed fit on the card and its holdout metrics."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = est.fit(table)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    scored = model.transform(hold)
    p = (np.asarray(scored["probabilities"])[:, 1]
         if "probabilities" in scored.columns
         else np.asarray(scored["prediction"]))
    yh = np.asarray(hold["label"])
    logloss, auc_v = _online_metrics(p, yh)
    n = len(table)
    res = dict(fit_s=fit_s, rows_per_s=n / fit_s, logloss=logloss,
               auc=auc_v, rmse=float(np.sqrt(np.mean((p - yh) ** 2))),
               peak=torch.cuda.max_memory_allocated(),
               final_loss=model._stats.get("final_loss"))
    out[tag] = res
    log(f"[online] (a) {tag}: fit {fit_s:.3f} s, {res['rows_per_s']:.4g} "
        f"rows/s, holdout logloss {logloss:.6f}, AUC {auc_v:.6f}, RMSE "
        f"{res['rmse']:.6f}, peak "
        f"{res['peak'] / 2**20:.1f} MiB")
    if not auc_v >= ONLINE_AUC_FLOOR:
        raise AssertionError(f"[online] {tag}: holdout AUC {auc_v} under "
                             f"{ONLINE_AUC_FLOOR}")
    return model


def _online_card_vs_cpu(tag, make, cut, tol, out):
    """`make(device=...)`'s fit on the card against its fit on the CPU
    (the port's plain path) on the slice `cut`: the largest difference of
    the weights and bias, over the CPU fit's largest |w| or |b|, within
    `tol`."""
    card, cpu = make(None).fit(cut), make("cpu").fit(cut)
    scale = max(float(np.abs(cpu._weights).max()), abs(cpu._bias))
    err = max(float(np.abs(card._weights - cpu._weights).max()),
              abs(card._bias - cpu._bias)) / scale
    if not err <= tol:
        raise AssertionError(f"[online] {tag}: the card fit is {err} of "
                             f"max |w| from the CPU fit")
    out.setdefault("card_vs_cpu", {})[tag] = err


def _time_sgd_loop(dev, idx, val, y, kw):
    """Wall ms per batch of one adaptive pass's batch loop alone
    (`learner._run_pass` over batches already on the card, a synchronize
    at each end): no host padding, copy or observability in it."""
    import torch
    from mmlspark_tpu_torch.models.vw import learner
    p = learner.VWParams(num_bits=kw["num_bits"], loss_function="logistic",
                         batch_size=kw["batch_size"])
    w = np.ones(len(y), np.float32)
    bi, bv, by, bw, nb = learner._pad_batches(idx, val, y, w, p.batch_size)
    batches = learner._to_device((bi, bv, by, bw), dev)
    state = learner._init_state(p, None, None, dev)
    losses = torch.zeros(nb, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learner._run_pass(state, batches, p, losses)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / nb


def _sgd_batch_launches(dev):
    """(device launches, launches by kernel name, the device's busy
    microseconds: the sum of those kernels' durations) of one adaptive
    minibatch step (`_sgd_batch`) at [online] (a)'s shape, from
    torch.profiler's device events."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity
    from mmlspark_tpu_torch.models.vw import learner
    from mmlspark_tpu_torch.telemetry.profiler import (
        exclusive_profiler as profile)
    idx, val, y, _ = _criteo_rows(ONLINE_BATCH, 25)
    p = learner.VWParams(num_bits=ONLINE_BITS, loss_function="logistic")
    state = learner._init_state(p, None, None, dev)
    c = torch.ones((), dtype=torch.float32, device=dev)
    args = [torch.as_tensor(a).to(dev)
            for a in (idx, val, y, np.ones(len(y), np.float32))]
    learner._sgd_batch(*state, *args, p, c)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        learner._sgd_batch(*state, *args, p, c)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    names = collections.Counter(e.name[:60] for e in dev_events)
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    return sum(names.values()), dict(names), busy_us


_LAUNCH_PROC = """
import json, sys
import torch
sys.path.insert(0, {here!r})
import chip_smoke
n, names, busy = chip_smoke._sgd_batch_launches(torch.device("cuda"))
print(json.dumps({{"n": n, "names": names, "busy_us": busy}}))
"""


def _fresh_sgd_batch_launches():
    """`_sgd_batch_launches` in a process of its own: a profiler session
    after others in one process (the [ingest] and [dnn] phases') has
    recorded a fraction of the device events (14 of 63)."""
    proc = subprocess.run(
        [sys.executable, "-c", _LAUNCH_PROC.format(here=HERE)],
        capture_output=True, text=True, timeout=300)
    if proc.returncode:
        raise AssertionError(f"[online] the launch count failed: "
                             f"{proc.stderr[-2000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    if not got["n"]:
        raise AssertionError("[online] torch.profiler recorded no device "
                             "event of an SGD batch")
    return got["n"], got["names"], got["busy_us"]


def _online_batch(dev, out):
    """(a) VW on the Criteo layout: adaptive classifier (two fits, bit
    for bit), the same over 4 positions of the card, sgd regressor with
    l1, BFGS, and the contextual bandit's parallel_fit; each held against
    the CPU fit on a slice but the bandit, each holdout AUC over its
    floor."""
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.models.vw import (VowpalWabbitClassifier,
                                              VowpalWabbitContextualBandit,
                                              VowpalWabbitRegressor)
    from mmlspark_tpu_torch.parallel import data_mesh
    from mmlspark_tpu_torch.train.metrics import auc
    t0 = time.perf_counter()
    idx, val, y, _ = _criteo_rows(ONLINE_ROWS + ONLINE_HOLDOUT, 21)
    out["data_s"] = time.perf_counter() - t0
    n = ONLINE_ROWS
    train = Table({"features_idx": idx[:n], "features_val": val[:n],
                   "label": y[:n]})
    hold = Table({"features_idx": idx[n:], "features_val": val[n:],
                  "label": y[n:]})
    log(f"[online] (a) {n} Criteo-shaped rows x 39 pairs at {ONLINE_BITS} "
        f"bits, positive rate {float(y[:n].mean()):.4f}, made in "
        f"{out['data_s']:.2f} s")
    kw = dict(features_col="features", label_col="label",
              num_bits=ONLINE_BITS, batch_size=ONLINE_BATCH)
    est = VowpalWabbitClassifier(**kw)
    first = _online_fit("adaptive", est, train, hold, out)
    if first.quality_profile is None or first.lineage is None or \
            first.lineage.get("estimator") != "VowpalWabbitClassifier":
        raise AssertionError("[online] the card fit left no quality "
                             "profile or lineage")
    again = _online_fit("adaptive_again", est, train, hold, out)
    if not (np.array_equal(first._weights, again._weights)
            and first._bias == again._bias):
        raise AssertionError("[online] two adaptive fits on the card "
                             "differ")
    # every card fit against the port's plain CPU path on one slice
    cut = Table({c: train[c][:ONLINE_CPU_ROWS] for c in train.columns})
    _online_card_vs_cpu("adaptive", lambda d: VowpalWabbitClassifier(
        device=d, **kw), cut, _ONLINE_CARD_TOL, out)
    nb = -(-n // ONLINE_BATCH)
    out["batches"] = nb
    out["ms_per_batch_fit_wall"] = 1e3 * out["adaptive"]["fit_s"] / nb
    out["ms_per_batch"] = _time_sgd_loop(dev, idx[:n], val[:n], y[:n], kw)
    out["launches_per_batch"], names, busy_us = _fresh_sgd_batch_launches()
    out["busy_ms_per_batch"] = busy_us / 1e3
    log(f"[online] (a) the device launches of one SGD batch by kernel: "
        f"{names}")
    log(f"[online] (a) two adaptive fits bit-identical; "
        f"{out['launches_per_batch']} device launches per SGD batch, "
        f"the card busy {out['busy_ms_per_batch']:.4f} ms of it "
        f"(profiled); the batch loop alone {out['ms_per_batch']:.4f} ms "
        f"per batch over {nb} batches (busy share "
        f"{out['busy_ms_per_batch'] / out['ms_per_batch']:.3f}); fit wall "
        f"over batches {out['ms_per_batch_fit_wall']:.4f} ms")
    mesh = data_mesh(devices=[dev] * ONLINE_DP_POSITIONS)
    dp = _online_fit("adaptive_4_positions", VowpalWabbitClassifier(
        num_tasks=ONLINE_DP_POSITIONS, mesh=mesh, **kw), train, hold, out)
    if np.array_equal(dp._weights, first._weights):
        raise AssertionError("[online] the 4-position fit equals one "
                             "position's: no averaging happened")
    cpu_mesh = data_mesh(devices=[torch.device("cpu")] * ONLINE_DP_POSITIONS)
    _online_card_vs_cpu(
        "adaptive_4_positions", lambda d: VowpalWabbitClassifier(
            num_tasks=ONLINE_DP_POSITIONS, device=d,
            mesh=mesh if d is None else cpu_mesh, **kw),
        cut, _ONLINE_FIT_TOL, out)
    # plain SGD diverges at VW's default rate on these unnormalized
    # counts (lr 0.5: RMSE 8.2e11 on the card); 0.05 converges
    sgd_kw = dict(mode="sgd", l1=1e-7, learning_rate=0.05, **kw)
    reg = _online_fit("sgd_l1_regressor", VowpalWabbitRegressor(**sgd_kw),
                      train, hold, out)
    out["sgd_l1_regressor"]["nonzero"] = int((reg._weights != 0).sum())
    _online_card_vs_cpu("sgd_l1_regressor", lambda d: VowpalWabbitRegressor(
        device=d, **sgd_kw), cut, _ONLINE_FIT_TOL, out)
    bfgs_kw = dict(mode="bfgs", bfgs_iters=ONLINE_BFGS_ITERS, **kw)
    _online_fit("bfgs", VowpalWabbitClassifier(**bfgs_kw), train, hold, out)
    _online_card_vs_cpu("bfgs", lambda d: VowpalWabbitClassifier(
        device=d, **dict(bfgs_kw, bfgs_iters=ONLINE_BFGS_CHECK_ITERS)),
        cut, _ONLINE_BFGS_TOL, out)
    log(f"[online] (a) each fit within its tolerance of the CPU fit on "
        f"{len(cut)} rows (of max |w|): {out['card_vs_cpu']}")
    # the contextual bandit: 4 policies over one featurization
    rng = np.random.default_rng(22)
    m = ONLINE_BANDIT_ROWS
    actions = rng.integers(1, 5, m)
    prob = rng.uniform(0.1, 1.0, m).astype(np.float32)
    cost = (1.0 - y[:m] - 0.1 * (actions == 2)).astype(np.float32)
    bt = Table({"features_idx": idx[:m], "features_val": val[:m],
                "chosen_action": actions, "cost": cost, "probability": prob})
    cb_kw = dict(features_col="features", num_bits=ONLINE_BITS,
                 num_actions=4, batch_size=ONLINE_BATCH)
    cb = VowpalWabbitContextualBandit(**cb_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    swept = cb.parallel_fit(bt, list(ONLINE_BANDIT_SWEEP))
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    aucs = []
    for pm, policy in zip(ONLINE_BANDIT_SWEEP, swept):
        scores = np.asarray(policy.transform(hold)["action_scores"])
        aucs.append(float(auc(np.asarray(hold["label"]),
                              -scores.mean(1))))
        if not (np.isfinite(scores).all()
                and aucs[-1] >= ONLINE_BANDIT_AUC_FLOOR):
            raise AssertionError(f"[online] bandit policy {pm}: holdout "
                                 f"AUC {aucs[-1]} under "
                                 f"{ONLINE_BANDIT_AUC_FLOOR}")
    out["bandit"] = dict(sweep_s=sweep_s,
                         rows_per_s=len(ONLINE_BANDIT_SWEEP) * m / sweep_s,
                         ips=[s._stats["ips_estimate"] for s in swept],
                         auc=aucs)
    log(f"[online] (a) bandit parallel_fit: {len(ONLINE_BANDIT_SWEEP)} "
        f"policies x {m} rows in {sweep_s:.3f} s "
        f"({out['bandit']['rows_per_s']:.4g} rows/s); holdout AUC of the "
        f"mean predicted cost {', '.join(f'{a:.6f}' for a in aucs)}")


def _online_pipeline(dev, tmp, out):
    """(a) the featurizer and a classifier as one Pipeline over the
    Criteo-shaped string table: fit on the card, saved, loaded, equal."""
    from mmlspark_tpu_torch import Pipeline, PipelineModel, Table
    from mmlspark_tpu_torch.models.vw import (VowpalWabbitClassifier,
                                              VowpalWabbitFeaturizer)
    idx, val, y, raw = _criteo_rows(ONLINE_PIPE_ROWS, 23, strings=True)
    cols = [f"I{j + 1}" for j in range(13)] + \
        [f"C{j + 1}" for j in range(26)]
    table = Table({**raw, "label": y})
    feat = VowpalWabbitFeaturizer(input_cols=cols, output_col="features",
                                  num_bits=ONLINE_BITS)
    made = feat.transform(table)
    if not (np.array_equal(made["features_idx"], idx)
            and np.array_equal(made["features_val"], val)):
        raise AssertionError("[online] the featurizer's pairs differ from "
                             "the hashed rows")
    t0 = time.perf_counter()
    model = Pipeline([feat, VowpalWabbitClassifier(
        features_col="features", label_col="label", num_bits=ONLINE_BITS,
        batch_size=ONLINE_BATCH)]).fit(table)
    fit_s = time.perf_counter() - t0
    path = os.path.join(tmp, "vw_pipeline")
    t0 = time.perf_counter()
    model.save(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = PipelineModel.load(path)
    load_s = time.perf_counter() - t0
    rows = Table(raw)
    a = model.transform(rows)["probabilities"]
    b = loaded.transform(rows)["probabilities"]
    if not np.array_equal(a, b):
        raise AssertionError("[online] the loaded pipeline scores "
                             "differently")
    out["pipeline"] = dict(fit_s=fit_s, save_s=save_s, load_s=load_s)
    log(f"[online] (a) Pipeline(featurizer, classifier) on "
        f"{ONLINE_PIPE_ROWS} string rows: featurizer pairs equal the "
        f"hashed rows, fit {fit_s:.3f} s, save {save_s:.3f} s, load "
        f"{load_s:.3f} s, probabilities equal after the load")


def _online_incumbent():
    """bench.py::_bench_online's serving data and 4-pass incumbent."""
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.models.vw import VowpalWabbitClassifier
    cfg = ONLINE_SERVE
    rng = np.random.default_rng(0)
    n, k, bits = cfg["rows"], cfg["k"], cfg["bits"]
    slots = rng.integers(0, 1 << bits, size=k).astype(np.int32)
    idx = np.tile(slots, (n, 1))
    val = rng.normal(size=(n, k)).astype(np.float32)
    beta = rng.normal(size=k).astype(np.float32)
    y = (val @ beta > 0).astype(np.float32)
    model = VowpalWabbitClassifier(
        features_col="features", label_col="label", num_bits=bits,
        num_passes=cfg["passes"]).fit(
            Table({"features_idx": idx, "features_val": val, "label": y}))
    return model, dict(idx=idx, val=val, y=y, beta=beta, slots=slots)


def _online_serving(dev, model, data, out):
    """(b) the incumbent behind serve_pipeline: the sparse-kernel plan
    (fast_path=True) against the Table path, req/s and latency, plan
    misses equal to the distinct buckets, replies equal to transform on
    rows whose slots vary, and the kernel's margins equal to predict_vw's
    on the CPU."""
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.io import serve_pipeline
    from mmlspark_tpu_torch.models.vw import VowpalWabbitRegressionModel
    from mmlspark_tpu_torch.models.vw.learner import predict_vw
    from mmlspark_tpu_torch.reliability.metrics import reliability_metrics
    from mmlspark_tpu_torch.telemetry import lineage, quality
    cfg = ONLINE_SERVE
    cols = ["features_idx", "features_val"]
    body = json.dumps({"features_idx": data["slots"].tolist(),
                       "features_val": [0.1] * cfg["k"]})
    # check rows: each draws its k slots from the incumbent's (with
    # repeats, in any order) and a quarter from the whole table, so every
    # row gathers its own weights
    rng = np.random.default_rng(24)
    shape = (ONLINE_CHECK_ROWS, cfg["k"])
    idx = rng.choice(data["slots"], size=shape).astype(np.int32)
    wide = rng.random(shape) < 0.25
    idx[wide] = rng.integers(0, 1 << cfg["bits"], int(wide.sum()))
    rows = rng.normal(size=shape).astype(np.float32)
    offline = model.transform(Table({
        "features_idx": idx, "features_val": rows}))["prediction"]
    bodies = [json.dumps({"features_idx": i.tolist(),
                          "features_val": r.tolist()}).encode()
              for i, r in zip(idx, rows)]
    # the serving kernel's margins (a regression model over the same
    # weights: the same kernel, no link) against predict_vw on the CPU
    margins = VowpalWabbitRegressionModel(
        weights=model._weights, bias=model._bias, num_bits=cfg["bits"],
        features_col="features")._serving_kernel("prediction")(idx, rows)
    want = predict_vw(model._weights, model._bias, idx, rows, device="cpu")
    m_err = float(np.abs(margins - want).max())
    m_scale = float(np.abs(want).max())
    if not m_err <= _ONLINE_MARGIN_TOL * m_scale:
        raise AssertionError(f"[online] the serving kernel's margins are "
                             f"{m_err} from predict_vw's (max |m| "
                             f"{m_scale})")
    out["kernel_margin_err"] = m_err / m_scale
    log(f"[online] (b) the serving kernel's margins on "
        f"{ONLINE_CHECK_ROWS} rows within {m_err / m_scale:.3g} of max "
        f"|m| = {m_scale:.4g} of predict_vw's on the CPU")
    for fast in (True, False):
        tag = "sparse_kernel" if fast else "table"
        reliability_metrics.reset()
        quality.reset_monitor()
        lineage.reset_version_registry()
        torch.cuda.reset_peak_memory_stats()
        server, q = serve_pipeline(model, cols, mode="microbatch",
                                   max_batch=cfg["max_batch"],
                                   fast_path=fast)
        try:
            if fast and not getattr(q.transform_fn._handle.kernel,
                                    "sparse_pairs", False):
                raise AssertionError("[online] the served plan is not the "
                                     "sparse-pair kernel")
            res = _serve_load(server, body, cfg["clients"],
                              cfg["per_client"])
            sect = dict(req_per_s=res.req_per_sec, p50_ms=res.p50_ms,
                        p99_ms=res.p99_ms)
            if fast:
                stats = q.transform_fn.stats()
                if stats["misses"] != stats["buckets"] \
                        or stats["evictions"]:
                    raise AssertionError(
                        f"[online] plan misses {stats['misses']} != "
                        f"distinct buckets {stats['buckets']}")
                sect.update(plan_hits=stats["hits"],
                            plan_misses=stats["misses"],
                            recompiles=reliability_metrics.get(
                                "plan.recompiles"))
            got = _serve_post_all(server.address, bodies)
        finally:
            q.stop()
            server.stop()
        _serve_statuses_ok(got, f"online {tag} check")
        served = np.asarray([json.loads(p)["prediction"]
                             for _, _, p in got])
        if not np.array_equal(served, np.asarray(offline, np.float64)):
            raise AssertionError(f"[online] {tag}: replies differ from "
                                 f"transform")
        sect["peak"] = torch.cuda.max_memory_allocated()
        out[tag] = sect
        log(f"[online] (b) {tag} (fast_path={fast}), {cfg['clients']} x "
            f"{cfg['per_client']}, max_batch {cfg['max_batch']}: "
            f"{sect['req_per_s']:.1f} req/s, p50 {sect['p50_ms']:.3f} ms, "
            f"p99 {sect['p99_ms']:.3f} ms"
            + (f", plan hits {sect['plan_hits']}, misses "
               f"{sect['plan_misses']} (= distinct buckets), recompiles "
               f"{sect['recompiles']}" if fast else "")
            + f"; {ONLINE_CHECK_ROWS} replies equal to transform")


def _online_updates(dev, model, data, out):
    """(c) OnlineLearner.partial_fit at the fixed (256, 16) bucket; two
    learners fed the same chunks end bit-identical."""
    import torch
    from mmlspark_tpu_torch.models.vw.learner import VWParams
    from mmlspark_tpu_torch.online import OnlineLearner
    cfg = ONLINE_SERVE
    idx, val, y = data["idx"], data["val"], data["y"]
    n, r = cfg["rows"], ONLINE_CHUNK_ROWS
    snaps = []
    for run in range(2):
        lrn = OnlineLearner(VWParams(loss_function="logistic",
                                     num_bits=cfg["bits"]),
                            warm_start=model, rows=r, k=cfg["k"])
        lrn.partial_fit(idx[:r], val[:r], y[:r])       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in range(ONLINE_CHUNKS):
            lo = (c * r) % (n - r)
            lrn.partial_fit(idx[lo:lo + r], val[lo:lo + r], y[lo:lo + r])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        snaps.append(lrn.snapshot())
        out.setdefault("updates_per_s", []).append(ONLINE_CHUNKS * r / wall)
    a, b = snaps
    if not (np.array_equal(a["weights"], b["weights"])
            and np.array_equal(a["acc"], b["acc"])
            and a["bias"] == b["bias"]):
        raise AssertionError("[online] two learners fed the same chunks "
                             "differ")
    log(f"[online] (c) {ONLINE_CHUNKS} chunks of {r} at k = {cfg['k']}: "
        f"{', '.join(f'{u:.4g}' for u in out['updates_per_s'])} "
        f"examples/s; the two learners bit-identical")


def _online_adapt(dev, model, data, out):
    """(d) a 5-sigma shift on a continuous server: one run_once goes
    drift trip -> refit -> RolloutDriver -> promoted, with no request
    dropped; a crash-retried refit equals the clean run; a poisoned
    candidate is rolled back."""
    import urllib.request

    from mmlspark_tpu_torch.control import (Observation, RolloutConfig,
                                            RolloutDriver)
    from mmlspark_tpu_torch.control import rollout as ctl
    from mmlspark_tpu_torch.io import serve_pipeline
    from mmlspark_tpu_torch.io.plan import compile_serving_transform
    from mmlspark_tpu_torch.models.vw.learner import VWParams
    from mmlspark_tpu_torch.online import (ContinuousLearner, LabelFeed,
                                           OnlineConfig, OnlineLearner,
                                           OnlineObservation)
    from mmlspark_tpu_torch.reliability.faults import FaultInjector
    from mmlspark_tpu_torch.reliability.metrics import reliability_metrics
    from mmlspark_tpu_torch.telemetry import lineage, quality
    cfg = ONLINE_SERVE
    idx, val, beta = data["idx"], data["val"], data["beta"]
    params = VWParams(loss_function="logistic", num_bits=cfg["bits"])
    reliability_metrics.reset()
    quality.reset_monitor()
    lineage.reset_version_registry()
    shift = (5.0 * beta / np.linalg.norm(beta)).astype(np.float32)
    server, q = serve_pipeline(model, ["features_idx", "features_val"],
                               mode="continuous")
    statuses = []
    try:
        mon = quality.get_monitor()
        if not mon.active:
            raise AssertionError("[online] the incumbent installed no "
                                 "quality profile")
        mon.configure(sample=1.0, min_live=24)
        feed = LabelFeed(evaluator=mon.evaluator)
        lrn = OnlineLearner(params, warm_start=model, rows=64, k=cfg["k"])

        def post(row_idx, row_val, label):
            req = urllib.request.Request(
                server.address, data=json.dumps({
                    "features_idx": row_idx.tolist(),
                    "features_val": row_val.tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            resp = urllib.request.urlopen(req, timeout=30)
            resp.read()
            statuses.append(resp.status)
            rid = resp.headers["X-Request-Id"]
            feed.record_features([rid], row_idx[None, :], row_val[None, :])
            quality.record_label(rid, float(label))

        def deploy(candidate):
            sched = iter([Observation()] * 10)
            drv = RolloutDriver(
                {"w0": q.transform_fn}, model, lambda: candidate,
                observe=lambda: next(sched),
                config=RolloutConfig(traffic_steps=(1.0,), step_polls=1,
                                     soak_polls=1, poll_interval_s=0.0),
                sleep=lambda s: None)
            return drv.run()["state"] == ctl.PROMOTED

        loop = ContinuousLearner(
            lrn, feed, deploy=deploy,
            config=OnlineConfig(min_pairs=32, max_drift=0.5,
                                poll_interval_s=0.0),
            sleep=lambda s: None)
        shifted = val + shift
        y_shift = (shifted @ beta > 0).astype(np.float32)
        t0 = time.perf_counter()
        for i in range(ONLINE_SHIFT_REQUESTS):
            post(idx[i], shifted[i], y_shift[i])
        status = loop.run_once()
        adapt_s = time.perf_counter() - t0
        served_version = q.transform_fn.version
    finally:
        q.stop()
        server.stop()
    dropped = sum(1 for s in statuses if s != 200)
    if status.get("outcome") != "promoted" or dropped:
        raise AssertionError(f"[online] adaptation: {status}, {dropped} "
                             f"requests dropped")
    if served_version != status["version"]:
        raise AssertionError("[online] the promoted candidate is not the "
                             "one serving")
    out["adapt"] = dict(s=adapt_s, dropped=dropped,
                        requests=len(statuses))
    log(f"[online] (d) {ONLINE_SHIFT_REQUESTS} requests with a 5-sigma "
        f"shift, then one run_once: drift trip -> refit -> rollout -> "
        f"promoted in {adapt_s:.3f} s, {dropped} requests dropped")

    # the chaos site on the card: a crash mid-refit retried from the
    # snapshot reaches the clean run's weights exactly
    def learner_and_feed():
        lrn = OnlineLearner(params, warm_start=model, rows=64, k=cfg["k"])
        feed = LabelFeed()
        rids = [f"r{i}" for i in range(128)]
        feed.record_features(rids, idx[:128], shifted[:128])
        for i, rid in enumerate(rids):
            feed.on_join(rid, 1.0, float(y_shift[i]))
        return lrn, feed

    def once():
        fired = {"n": 0}

        def observe():
            fired["n"] += 1
            return OnlineObservation(drift_tripped=fired["n"] == 1,
                                     pairs=999)
        return observe

    runs = []
    for faults in (None, FaultInjector(seed=5, rules=[
            {"site": "online.refit", "kind": "crash", "at": [0]}])):
        lrn, feed = learner_and_feed()
        cl = ContinuousLearner(lrn, feed, deploy=lambda m: True,
                               observe=once(), faults=faults,
                               config=OnlineConfig(min_pairs=8),
                               sleep=lambda s: None)
        if cl.run_once().get("outcome") != "promoted":
            raise AssertionError("[online] a chaos refit did not promote")
        runs.append(lrn.snapshot())
    if not (np.array_equal(runs[0]["weights"], runs[1]["weights"])
            and np.array_equal(runs[0]["acc"], runs[1]["acc"])):
        raise AssertionError("[online] the crash-retried refit differs "
                             "from the clean run")
    # a poisoned candidate burns its canary and is rolled back
    lrn, feed = learner_and_feed()
    worker = compile_serving_transform(model, ["features_idx",
                                               "features_val"])
    inc_version = worker.version
    snap = lrn.snapshot()

    def burning_gate(candidate):
        sched = iter([Observation(burning=True), Observation(),
                      Observation(), Observation()])
        drv = RolloutDriver(
            {"w0": worker}, model, candidate, observe=lambda: next(sched),
            config=RolloutConfig(traffic_steps=(1.0,), step_polls=2,
                                 poll_interval_s=0.0, recover_polls=1),
            sleep=lambda s: None)
        return drv.run()["state"] == ctl.PROMOTED

    cl = ContinuousLearner(lrn, feed, deploy=burning_gate, observe=once(),
                           config=OnlineConfig(min_pairs=8),
                           sleep=lambda s: None)
    st = cl.run_once()
    if st.get("outcome") != "rolled-back" or worker.version != inc_version \
            or not np.array_equal(lrn.snapshot()["weights"],
                                  snap["weights"]):
        raise AssertionError(f"[online] the poisoned candidate was not "
                             f"rolled back: {st}")
    out["rollback"] = st["outcome"]
    log("[online] (d) a crash-retried refit equals the clean run bit for "
        "bit; a poisoned candidate rolled back, the incumbent serving and "
        "the learner rewound")


def online_phase(dev):
    """[online]: VW and the online loop on the card (no kernel of their
    own: gathers, sorts and segmented sums; every kernel wrapper's launch
    count must stand still across the phase)."""
    import tempfile

    import torch
    from mmlspark_tpu_torch.ops import flash_attention as fa
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    from mmlspark_tpu_torch.telemetry import lineage, quality
    t_phase = time.perf_counter()
    before = dict(**hc.launches, **fa.launches)
    quality.reset_monitor()
    lineage.reset_version_registry()
    out = {}
    _online_batch(dev, out)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_online_") as tmp:
        _online_pipeline(dev, tmp, out)
    model, data = _online_incumbent()
    _online_serving(dev, model, data, out)
    _online_updates(dev, model, data, out)
    _online_adapt(dev, model, data, out)
    after = dict(**hc.launches, **fa.launches)
    if after != before:
        raise AssertionError(f"[online] a kernel launched: {before} -> "
                             f"{after}")
    out["s"] = time.perf_counter() - t_phase
    log(f"[online] kernel launches unchanged across the phase: {after}; "
        f"the phase {out['s']:.1f} s")
    return out


AUTOML_ROWS = 1_000_000
AUTOML_TRAIN = 800_000          # the 80/20 split: train rows first
# Adult Census Income's columns (UCI adult.names): six numeric, eight
# categorical at Adult's cardinalities; the numeric columns are drawn as
# z-scores (the reference's learners do not standardise)
AUTOML_NUMERIC = ("age", "fnlwgt", "education_num", "capital_gain",
                  "capital_loss", "hours_per_week")
AUTOML_CATEGORICAL = (("workclass", 9), ("education", 16),
                      ("marital_status", 7), ("occupation", 15),
                      ("relationship", 6), ("race", 5), ("sex", 2),
                      ("native_country", 42))
AUTOML_FEATURES = 6 + 102       # Featurize: 6 numeric + 102 one-hot
AUTOML_NAN_RATE = 0.05
AUTOML_POSITIVE = 0.24
AUTOML_GBDT = dict(num_iterations=100, num_leaves=31)
AUTOML_CPU_ROWS = 50_000        # rows of the LR card-against-CPU fit
# holdout AUC floors, set before the first card run: the generating
# logit's own holdout AUC is 0.9157 (host numpy), and a learner that
# recovers it loses a little to the imputed NaNs
AUTOML_AUC_FLOOR = {"lr": 0.88, "gbdt": 0.88}
_AUTOML_FIT_TOL = 1e-5          # card LR against the CPU fit, of max |w|
# the sparse text fit against the CPU fit, of max |w|: a slot whose
# contributions nearly cancel takes Adam's first steps by the sign of its
# rounding (ROADMAP Queue 3 (ag); on the CPU, hashed Zipf tokens' f32 and
# float64 fits part by 7.5e-4, tests/test_torch_linear.py::
# test_adam_sign_steps_amplify_rounding)
_AUTOML_TEXT_TOL = 1e-4
AUTOML_TUNE_ROWS = 100_000       # 200,000 before [images]
AUTOML_TUNE = dict(number_of_iterations=4, number_of_folds=3, seed=3)
# the parallelism 1 against 4 comparison: the same tuning with 2 draws of
# each learner and 2 folds on 50,000 of its rows, cut to pay for its two
# runs (only their scores are compared; 4 threads cost about as much on
# 50,000 rows as on 200,000), the folds from 3 for [cyber]
AUTOML_PAR_ROWS = 50_000
AUTOML_PAR_TUNE = dict(AUTOML_TUNE, number_of_iterations=2,
                       number_of_folds=2)
# their GBDT CV scores at parallelism 1 against 4, fits in fixed order
_AUTOML_PAR_GBDT_TOL = 1e-4
AUTOML_TUNE_GBDT = dict(num_iterations=20)
AUTOML_TEXT = dict(docs=100_000, tokens=40, vocab=50_000, bits=18,
                   cpu_docs=10_000)
AUTOML_LIME = dict(rows=256, samples=1000, lam=1e-3)
# card lasso against the CPU path, of the largest row norm of the CPU
# coefficients: f32 solves whose inputs (the inner model's scores)
# differ in the last bits between the card and the CPU; the `gpu` test's
# limit (tests/test_torch_automl_cuda.py::_LASSO_RTOL)
_AUTOML_LASSO_TOL = 1e-4
# the explanation of the logit (a linear model) against its weights, of
# max |w|: the 1e-6 ridge jitter over the smallest perturbed variance;
# tests/test_torch_lime.py's limit
_AUTOML_RECOVER_TOL = 1e-3
AUTOML_IMAGE = dict(images=2, size=224, samples=900)


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


def _adult_rows(n=AUTOML_ROWS, seed=22):
    """(columns, true logit) of a seeded Adult-shaped table: six numeric
    columns with NaNs, eight string categoricals drawn Zipf at Adult's
    cardinalities, and the string label `income` (">50K" / "<=50K",
    AUTOML_POSITIVE positive) from a logistic function of the columns."""
    rng = np.random.default_rng(seed)
    cols, z = {}, np.zeros(n)
    for name in AUTOML_NUMERIC:
        v = rng.normal(size=n)
        z += rng.normal(0.0, 0.6) * v
        v[rng.random(n) < AUTOML_NAN_RATE] = np.nan
        cols[name] = v
    for name, card in AUTOML_CATEGORICAL:
        p = 1.0 / np.arange(1, card + 1)
        codes = rng.choice(card, size=n, p=p / p.sum())
        z += rng.normal(0.0, 0.5, card)[codes]
        levels = np.array([f"{name}_{i}" for i in range(card)])
        cols[name] = levels[codes]
    lo, hi = -10.0, 10.0
    for _ in range(60):   # the intercept that makes AUTOML_POSITIVE
        mid = 0.5 * (lo + hi)
        lo, hi = ((lo, mid) if _sigmoid(z + mid).mean() > AUTOML_POSITIVE
                  else (mid, hi))
    z += 0.5 * (lo + hi)
    y = rng.random(n) < _sigmoid(z)
    cols["income"] = np.where(y, ">50K", "<=50K")
    return cols, z


def _indexed(model, t):
    """The holdout's label as the composite's class index (float)."""
    lab = model._label_model.transform(t)
    return np.asarray(lab["__label_idx"], np.float64)


def _holdout_stats(model, hold):
    """ComputeModelStatistics of a fitted TrainClassifier on the holdout,
    and the holdout logloss."""
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.train import ComputeModelStatistics
    scored = model.transform(hold)
    label = _indexed(model, hold)
    probs = np.asarray(scored["probabilities"], np.float64)
    stats = ComputeModelStatistics(
        label_col="label", evaluation_metric="classification"
    ).transform(Table({"label": label, "probabilities": probs,
                       "prediction": scored["prediction"]}))
    p = np.clip(probs[np.arange(len(label)), label.astype(np.int64)],
                1e-15, 1.0)
    return dict(logloss=float(-np.log(p).mean()),
                **{k: float(np.asarray(stats[k])[0])
                   for k in ("AUC", "accuracy", "precision", "recall")})


def _automl_train(dev, train, hold, z_hold, out):
    """(a) TrainClassifier with the default LogisticRegression and with
    GBDTClassifier on the 800,000 training rows; ComputeModelStatistics
    on the 200,000 holdout rows; the LR fit held to the port's CPU fit on
    AUTOML_CPU_ROWS rows; the GBDT fit's `hist_tiled` launches, and its
    twin with the plain histograms at the same shapes, whose holdout
    logloss and AUC agree within _METRIC_TOL."""
    import torch
    from mmlspark_tpu_torch.featurize import Featurize
    from mmlspark_tpu_torch.models.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    from mmlspark_tpu_torch.train import TrainClassifier
    from mmlspark_tpu_torch.train.metrics import auc
    out["bayes_auc"] = float(auc((np.asarray(hold["income"]) == ">50K")
                                 .astype(np.float64), z_hold))
    t0 = time.perf_counter()
    feat = Featurize(dense_output=True, label_col="income").fit(train)
    width = feat.transform(train)["features"].shape[1]
    out["featurize_s"] = time.perf_counter() - t0
    if width != AUTOML_FEATURES:
        raise AssertionError(f"[automl] Featurize made {width} columns, "
                             f"not {AUTOML_FEATURES}")
    models = {}
    for tag, inner in (("lr", None),
                       ("gbdt", GBDTClassifier(device=dev, **AUTOML_GBDT))):
        est = TrainClassifier(label_col="income", model=inner, device=dev)
        hc.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = est.fit(train)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(hc.launches)
        peak = torch.cuda.max_memory_allocated()
        res = dict(fit_s=fit_s, rows_per_s=len(train) / fit_s, peak=peak,
                   launches=launches, **_holdout_stats(model, hold))
        out[tag] = res
        models[tag] = model
        log(f"[automl] (a) TrainClassifier {tag}: fit {fit_s:.3f} s "
            f"({res['rows_per_s']:.4g} rows/s, featurize alone "
            f"{out['featurize_s']:.3f} s), peak {peak / 2**20:.1f} MiB, "
            f"holdout AUC {res['AUC']:.6f} (the generating logit's "
            f"{out['bayes_auc']:.6f}), logloss {res['logloss']:.6f}, "
            f"accuracy {res['accuracy']:.6f}; launches {launches}")
        if not res["AUC"] >= AUTOML_AUC_FLOOR[tag]:
            raise AssertionError(f"[automl] {tag}: holdout AUC "
                                 f"{res['AUC']} under "
                                 f"{AUTOML_AUC_FLOOR[tag]}")
    if out["gbdt"]["launches"].get("hist_tiled", 0) < 1:
        raise AssertionError("[automl] the GBDT fit launched no hist_tiled")
    if any(out["lr"]["launches"].values()):
        raise AssertionError(f"[automl] the LR fit launched a kernel: "
                             f"{out['lr']['launches']}")
    hc.reset_launches()
    with plain_histograms():
        t0 = time.perf_counter()
        twin = TrainClassifier(
            label_col="income", device=dev,
            model=GBDTClassifier(device=dev, **AUTOML_GBDT)).fit(train)
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t0
    if any(hc.launches.values()):
        raise AssertionError(f"[automl] the plain-histogram twin launched "
                             f"{dict(hc.launches)}")
    plain = _holdout_stats(twin, hold)
    out["gbdt_plain"] = dict(fit_s=twin_s, **plain)
    kern = out["gbdt"]
    log(f"[automl] (a) GBDT plain-histogram twin: fit {twin_s:.3f} s, "
        f"holdout logloss {plain['logloss']:.6f}, AUC {plain['AUC']:.6f} "
        f"(kernel fit {kern['logloss']:.6f}, {kern['AUC']:.6f})")
    if abs(plain["logloss"] - kern["logloss"]) > _METRIC_TOL or \
            abs(plain["AUC"] - kern["AUC"]) > _METRIC_TOL:
        raise AssertionError("[automl] the GBDT kernel fit and its "
                             "plain-histogram twin disagree")
    cut = train.take(AUTOML_CPU_ROWS)
    card = TrainClassifier(label_col="income", device=dev).fit(cut)
    cpu = TrainClassifier(label_col="income", device="cpu").fit(cut)
    cw, gw = cpu.inner_model._w, card.inner_model._w
    err = max(float(np.abs(gw - cw).max()),
              float(np.abs(card.inner_model._b - cpu.inner_model._b).max())
              ) / float(np.abs(cw).max())
    out["lr_card_vs_cpu"] = err
    log(f"[automl] (a) LR card fit against the CPU fit on "
        f"{AUTOML_CPU_ROWS} rows: {err:.3g} of max |w|")
    if not err <= _AUTOML_FIT_TOL:
        raise AssertionError(f"[automl] the card LR fit is {err} of max "
                             f"|w| from the CPU fit")
    return models


def _linear_fit_profile(dev):
    """(launches, launches a step, device-busy seconds, wall seconds) of
    one LogisticRegression fit at (a)'s shape (800,000 x 108, 300 steps):
    the wall of an unprofiled fit, the launches and the sum of kernel
    durations from torch.profiler over a second one."""
    import torch
    from torch.profiler import ProfilerActivity
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.models.linear import LogisticRegression
    from mmlspark_tpu_torch.telemetry.profiler import (
        exclusive_profiler as profile)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((AUTOML_TRAIN, AUTOML_FEATURES), np.float32)
    y = (rng.random(AUTOML_TRAIN) < 0.24).astype(np.float64)
    t = Table({"features": x, "label": y})
    est = LogisticRegression(device=dev)
    est.fit(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.fit(t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        est.fit(t)
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in events) * 1e-6
    return len(events), len(events) / est.max_iter, busy, wall


_LINEAR_PROFILE_PROC = """
import json, sys
import torch
sys.path.insert(0, {here!r})
import chip_smoke
n, per_step, busy, wall = chip_smoke._linear_fit_profile(
    torch.device("cuda"))
print(json.dumps({{"n": n, "per_step": per_step, "busy_s": busy,
                  "wall_s": wall}}))
"""


def _automl_fit_profile(out):
    """`_linear_fit_profile` in a process of its own (a profiler session
    after others in one process records a fraction of the device
    events; see `_fresh_sgd_batch_launches`)."""
    proc = subprocess.run(
        [sys.executable, "-c", _LINEAR_PROFILE_PROC.format(here=HERE)],
        capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"[automl] the LR fit profile failed: "
                             f"{proc.stderr[-2000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    if not got["n"]:
        raise AssertionError("[automl] torch.profiler recorded no device "
                             "event of an LR fit")
    got["busy_share"] = got["busy_s"] / got["wall_s"]
    out["lr_profile"] = got
    log(f"[automl] (a) one LR fit (800,000 x 108, 300 steps): {got['n']} "
        f"launches ({got['per_step']:.1f} a step), the card busy "
        f"{got['busy_s']:.4f} s of {got['wall_s']:.4f} s (share "
        f"{got['busy_share']:.3f})")


@contextlib.contextmanager
def _fixed_order_gbdt(on: bool = True):
    """Within the block, the GBDT estimators' fits grow their trees in
    fixed order: `fit_booster` with a checkpoint callback that keeps
    nothing, the route a checkpointed fit takes
    (models/gbdt/boosting.py's `fixed_order`), whose histograms and leaf
    sums add in one order on the card. Two fits of one candidate are then
    equal bit for bit whichever thread runs them."""
    import functools

    from mmlspark_tpu_torch.models.gbdt import estimators as gest
    real = gest.fit_booster

    def keep_nothing(it, booster, base, final=False):
        return None
    if on:
        gest.fit_booster = functools.partial(real,
                                             checkpoint_fn=keep_nothing)
    try:
        yield
    finally:
        gest.fit_booster = real


def _automl_tune(dev, models, train, hold, out):
    """(b) TuneHyperparameters over LogisticRegression and GBDTClassifier
    on AUTOML_TUNE_ROWS featurized rows (4 random draws each, 3 folds:
    24 fits), then FindBestModel on the featurized holdout over the tuned
    best and (a)'s two inner models; the same tuning with 2 draws each on
    the first AUTOML_PAR_ROWS of those rows at parallelism 1 and 4, its
    GBDT fits in fixed order (`_fixed_order_gbdt`), equal scores."""
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.automl import (DiscreteHyperParam,
                                           FindBestModel, RangeHyperParam,
                                           TuneHyperparameters)
    from mmlspark_tpu_torch.models.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.models.linear import LogisticRegression
    lr = models["lr"]

    def featurized(t):
        f = lr._featurizer.transform(t)
        return Table({"__train_features": f["__train_features"],
                      "label": _indexed(lr, t)})
    ft = featurized(train.take(AUTOML_TUNE_ROWS))
    fh = featurized(hold)
    space = {"learning_rate": RangeHyperParam(0.02, 0.3, log=True),
             "reg_param": DiscreteHyperParam([0.0, 1e-4, 1e-3]),
             "num_leaves": DiscreteHyperParam([15, 31])}
    common = dict(features_col="__train_features", device=dev)
    runs = {}
    for name, rows, par, draws in (("tune", AUTOML_TUNE_ROWS, 1, AUTOML_TUNE),
                                   (1, AUTOML_PAR_ROWS, 1, AUTOML_PAR_TUNE),
                                   (4, AUTOML_PAR_ROWS, 4, AUTOML_PAR_TUNE)):
        tuner = TuneHyperparameters(
            models=[LogisticRegression(**common),
                    GBDTClassifier(**common, **AUTOML_TUNE_GBDT)],
            hyperparam_space=space, parallelism=par, **draws)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _fixed_order_gbdt(name != "tune"):
            tuned = tuner.fit(ft.take(rows))
        torch.cuda.synchronize()
        runs[name] = dict(s=time.perf_counter() - t0, model=tuned,
                          scores=[s for _, s in tuned._all_scores])
        log(f"[automl] (b) TuneHyperparameters on {rows} rows, parallelism "
            f"{par}: {runs[name]['s']:.3f} s for "
            f"{len(tuned._all_scores) * draws['number_of_folds']} "
            f"fits and the refit; best {type(tuned.best_model).__name__} "
            f"{tuned._best_params}, CV AUC {tuned.best_metric:.6f}")
    one, four = runs[1]["scores"], runs[4]["scores"]
    n_lr = AUTOML_PAR_TUNE["number_of_iterations"]
    diff_lr = max(abs(a - b) for a, b in zip(one[:n_lr], four[:n_lr]))
    diff_gbdt = max(abs(a - b) for a, b in zip(one[n_lr:], four[n_lr:]))
    if diff_lr != 0.0:
        raise AssertionError(f"[automl] LR CV scores moved with "
                             f"parallelism by {diff_lr}")
    # the GBDT candidates grew their trees in fixed order, so a fit is the
    # same whichever thread runs it (the default histograms' atomics
    # moved these scores by up to 2.2e-4: ROADMAP Queue 3 (aj))
    if not diff_gbdt <= _AUTOML_PAR_GBDT_TOL:
        raise AssertionError(f"[automl] GBDT CV scores moved with "
                             f"parallelism by {diff_gbdt}")
    cands = [runs["tune"]["model"].best_model, lr.inner_model,
             models["gbdt"].inner_model]
    best = FindBestModel(models=cands).fit(fh)
    out["tune"] = dict(s=runs["tune"]["s"], s_par1=runs[1]["s"],
                       s_par4=runs[4]["s"], scores=runs["tune"]["scores"],
                       diff_gbdt=diff_gbdt,
                       best=type(runs["tune"]["model"].best_model).__name__,
                       find_best=[float(s) for s in best._scores],
                       find_best_i=cands.index(best.best_model))
    log(f"[automl] (b) CV scores equal across parallelism (LR exactly, "
        f"GBDT in fixed order within {diff_gbdt:.3g}); FindBestModel "
        f"holdout AUC "
        f"{', '.join(f'{s:.6f}' for s in best._scores)} -> candidate "
        f"{out['tune']['find_best_i']}")


def _text_rows(n, seed=23):
    """n seeded documents of AUTOML_TEXT['tokens'] tokens drawn Zipf from
    a vocabulary of AUTOML_TEXT['vocab'], and a label from a logistic
    function of the tokens' hidden weights."""
    rng = np.random.default_rng(seed)
    k, vocab = AUTOML_TEXT["tokens"], AUTOML_TEXT["vocab"]
    ranks = _zipf_ranks(rng, n * k, vocab).reshape(n, k)
    words = np.array([f"tok{i}" for i in range(vocab)], dtype=object)
    docs = np.array([" ".join(words[r]) for r in ranks], dtype=object)
    weight = rng.normal(0.0, 1.0, vocab)
    z = weight[ranks].sum(1) / np.sqrt(k)
    y = (rng.random(n) < _sigmoid(z - np.median(z))).astype(np.float64)
    return docs, y


def _automl_text(dev, out):
    """(c) TextFeaturizer at 2^18 slots on AUTOML_TEXT['docs'] documents,
    then LogisticRegression on the sparse pairs: two card fits bit for
    bit, the card held to the CPU fit on AUTOML_TEXT['cpu_docs']
    documents."""
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.featurize import TextFeaturizer
    from mmlspark_tpu_torch.models.linear import LogisticRegression
    docs, y = _text_rows(AUTOML_TEXT["docs"])
    t0 = time.perf_counter()
    tf = TextFeaturizer(input_col="text", output_col="features",
                        num_features=1 << AUTOML_TEXT["bits"],
                        device=dev).fit(Table({"text": docs}))
    feats = tf.transform(Table({"text": docs, "label": y}))
    feat_s = time.perf_counter() - t0
    if feats.column_meta("features_idx").get("logical_width") != \
            1 << AUTOML_TEXT["bits"]:
        raise AssertionError("[automl] the text pairs lost logical_width")
    fits = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = LogisticRegression(device=dev).fit(feats)
        torch.cuda.synchronize()
        fits.append((m, time.perf_counter() - t0,
                     torch.cuda.max_memory_allocated()))
    (a, fit_s, peak), (b, _, _) = fits
    if a._w.tobytes() != b._w.tobytes() or a._b.tobytes() != b._b.tobytes():
        raise AssertionError("[automl] two sparse card fits differ")
    cut = feats.take(AUTOML_TEXT["cpu_docs"])
    card = LogisticRegression(device=dev).fit(cut)
    cpu = LogisticRegression(device="cpu").fit(cut)
    err = max(float(np.abs(card._w - cpu._w).max()),
              float(np.abs(card._b - cpu._b).max())) / float(
                  np.abs(cpu._w).max())
    pairs = int(np.count_nonzero(feats["features_val"]))
    out["text"] = dict(featurize_s=feat_s, fit_s=fit_s,
                       docs_per_s=len(docs) / fit_s, peak=peak,
                       pairs=pairs, width=feats["features_idx"].shape[1],
                       card_vs_cpu=err)
    log(f"[automl] (c) TextFeaturizer {feat_s:.3f} s for {len(docs)} "
        f"documents ({pairs} pairs, width "
        f"{feats['features_idx'].shape[1]}); sparse LR fit {fit_s:.3f} s "
        f"({out['text']['docs_per_s']:.4g} docs/s), peak "
        f"{peak / 2**20:.1f} MiB, two fits bit-identical, card against "
        f"CPU on {AUTOML_TEXT['cpu_docs']} documents {err:.3g} of max |w|")
    if not err <= _AUTOML_TEXT_TOL:
        raise AssertionError(f"[automl] the sparse card fit is {err} of "
                             f"max |w| from the CPU fit")


def _automl_lime(dev, models, hold, out):
    """(d) TabularLIME on (a)'s LR model: AUTOML_LIME['rows'] holdout rows
    x AUTOML_LIME['samples'] perturbations x 108 features at lambda 0 and
    AUTOML_LIME['lam'], each held to the CPU path (inner model and lasso
    on the CPU); and the logit of the same weights (a linear model)
    explained at lambda 0 recovers them."""
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.lime import TabularLIME
    from mmlspark_tpu_torch.models.linear import LinearRegressionModel
    lr = models["lr"]
    inner = lr.inner_model
    x = np.asarray(lr._featurizer.transform(
        hold.take(4096))["__train_features"], np.float64)
    rows = Table({"__train_features": x[:AUTOML_LIME["rows"]]})
    fit_t = Table({"__train_features": x})
    logit = LinearRegressionModel(features_col="__train_features",
                                  device=dev)
    logit._set_state({"w": inner._w[:, 0], "b": inner._b[0]})
    res = {}
    for lam in (0.0, AUTOML_LIME["lam"]):
        kw = dict(input_col="__train_features",
                  prediction_col="probabilities", regularization=lam,
                  n_samples=AUTOML_LIME["samples"], seed=11)
        card_m = TabularLIME(model=inner, device=dev, **kw).fit(fit_t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = np.asarray(list(card_m.transform(rows)["output"]))
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        want = np.asarray(list(TabularLIME(model=inner.copy({"device": "cpu"}),
                                           device="cpu",
                                           **kw).fit(fit_t)
                               .transform(rows)["output"]))
        err = float(np.abs(got - want).max()
                    / np.linalg.norm(want, axis=1).max())
        res[lam] = dict(s=s, rows_per_s=AUTOML_LIME["rows"] / s,
                        card_vs_cpu=err)
        log(f"[automl] (d) TabularLIME lambda {lam}: {s:.3f} s "
            f"({res[lam]['rows_per_s']:.4g} rows/s, "
            f"{AUTOML_LIME['rows']} x {AUTOML_LIME['samples']} x "
            f"{x.shape[1]}), card against CPU {err:.3g} of the largest "
            f"row norm")
        if not err <= _AUTOML_LASSO_TOL:
            raise AssertionError(f"[automl] TabularLIME lambda {lam}: the "
                                 f"card is {err} from the CPU path")
    kw = dict(input_col="__train_features", prediction_col="prediction",
              n_samples=AUTOML_LIME["samples"], seed=12)
    coefs = np.asarray(list(TabularLIME(model=logit, device=dev, **kw)
                            .fit(fit_t).transform(rows)["output"]))
    moving = x.std(axis=0) > 0
    w = inner._w[:, 0]
    rec = float(np.abs(coefs[:, moving] - w[moving]).max()
                / np.abs(w).max())
    res["recover"] = rec
    out["lime"] = res
    log(f"[automl] (d) the logit's explanation recovers its weights "
        f"within {rec:.3g} of max |w| ({int(moving.sum())} columns that "
        f"vary)")
    if not rec <= _AUTOML_RECOVER_TOL:
        raise AssertionError(f"[automl] the linear explanation is {rec} of "
                             f"max |w| from the model's weights")


class _Recording:
    """A transformer wrapper that keeps the scores it returned."""

    def __init__(self, inner, col):
        self.inner, self.col, self.scores = inner, col, []

    def transform(self, t):
        out = self.inner.transform(t)
        self.scores.append(np.asarray(out[self.col]))
        return out


def _automl_image(dev, out):
    """(e) ImageLIME on AUTOML_IMAGE['images'] images of 224 x 224 with
    AUTOML_IMAGE['samples'] masks each, the inner model the port's
    ResNet-18 ImageFeaturizer (random weights from seed 0), explaining
    the last feature; each image's coefficients held to the CPU lasso on
    the same masks and scores."""
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.lime import ImageLIME, batched_lasso
    from mmlspark_tpu_torch.models.dnn import ImageFeaturizer
    imgs, _ = _colour_images(AUTOML_IMAGE["images"], AUTOML_IMAGE["size"],
                             seed=24)
    fz = _Recording(ImageFeaturizer(model_name="resnet18", device=dev),
                    "features")
    lime = ImageLIME(input_col="image", prediction_col="features",
                     model=fz, n_samples=AUTOML_IMAGE["samples"], seed=13,
                     device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = lime.transform(Table({"image": imgs}))
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    rng = np.random.default_rng(13)
    errs = []
    for i in range(len(imgs)):
        k = int(got["superpixels"][i].max()) + 1
        states = rng.random((AUTOML_IMAGE["samples"], k)) < \
            lime.sampling_fraction
        pred = fz.scores[i][..., -1].astype(np.float64)
        want = batched_lasso(states[None].astype(np.float64), pred[None],
                             lime.regularization, device="cpu")[0]
        coef = np.asarray(got["output"][i])
        if coef.shape != (k,) or not np.isfinite(coef).all():
            raise AssertionError(f"[automl] ImageLIME image {i}: "
                                 f"coefficients {coef.shape}, finite "
                                 f"{np.isfinite(coef).all()}")
        errs.append(float(np.abs(coef - want).max()
                          / max(np.linalg.norm(want), 1e-30)))
    n_img = AUTOML_IMAGE["images"] * AUTOML_IMAGE["samples"]
    out["image"] = dict(s=s, images_per_s=n_img / s,
                        peak=torch.cuda.max_memory_allocated(),
                        card_vs_cpu=max(errs))
    log(f"[automl] (e) ImageLIME {s:.3f} s for {AUTOML_IMAGE['images']} "
        f"images x {AUTOML_IMAGE['samples']} masks ({n_img / s:.4g} masked "
        f"images/s), peak {out['image']['peak'] / 2**20:.1f} MiB, the card "
        f"lasso against the CPU's {max(errs):.3g} of the norm")
    if not max(errs) <= _AUTOML_LASSO_TOL:
        raise AssertionError(f"[automl] ImageLIME: the card lasso is "
                             f"{max(errs)} from the CPU's")


def automl_phase(dev, profile: bool = False):
    """[automl]: the AutoML and explanation path on the card (no kernel
    of its own but the GBDT learner's `hist_tiled`: the linear fits, the
    lasso and `to_dense` are torch ops; the flash kernels must stand
    still). With `profile`, also one LR fit's launches and the card's
    busy share, in a process of its own."""
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.ops import flash_attention as fa
    t_phase = time.perf_counter()
    flash_before = dict(fa.launches)
    cols, z = _adult_rows()
    train = Table({k: v[:AUTOML_TRAIN] for k, v in cols.items()})
    hold = Table({k: v[AUTOML_TRAIN:] for k, v in cols.items()})
    out = {"parts_s": {"data": time.perf_counter() - t_phase}}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        got = fn(*args)
        torch.cuda.empty_cache()
        out["parts_s"][name] = time.perf_counter() - t0
        return got
    models = part("(a)", _automl_train, dev, train, hold, z[AUTOML_TRAIN:],
                  out)
    if profile:
        part("(a) profile", _automl_fit_profile, out)
    part("(b)", _automl_tune, dev, models, train, hold, out)
    part("(c)", _automl_text, dev, out)
    part("(d)", _automl_lime, dev, models, hold, out)
    part("(e)", _automl_image, dev, out)
    if dict(fa.launches) != flash_before:
        raise AssertionError(f"[automl] a flash kernel launched: "
                             f"{flash_before} -> {dict(fa.launches)}")
    out["s"] = time.perf_counter() - t_phase
    log(f"[automl] the phase {out['s']:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["parts_s"].items()))
    return out


# ---------------------------------------------------------------- [cyber]
# one tenant shaped like the users x computers of LANL's "Comprehensive,
# Multi-Source Cyber-Security Events" authentication data (Kent 2015:
# 12,425 users, 17,684 computers), seeded synthetic: users in `groups`
# groups, each reaching its own group's computers with Zipf popularity,
# and every user reaching the `shared` servers (DataFactory's "ffa" join
# at scale); a second, small tenant for the per-tenant loop
CYBER = dict(users=12_425, computers=17_684, groups=50, shared=20,
             own_draws=24, zipf=1.1, event_p=0.3, seed=24)
CYBER_SMALL = dict(users=600, computers=400, groups=8, shared=4,
                   own_draws=12, zipf=1.1, event_p=0.3, seed=25)
# AccessAnomaly's reference defaults
CYBER_FIT = dict(rank=10, max_iter=25, reg_param=1.0, low_value=5.0,
                 high_value=10.0, complementset_factor=2, neg_score=1.0)
CYBER_PROBE = 100_000        # unseen intra-group pairs, and cross-group
# the card fit against the port's CPU fit on a reduced tenant, of the
# largest |factor| and |score| (the CPU parity file measured the port
# against the reference up to 1.9e-5 of max |factor|: the same f32 sums
# in another order)
CYBER_CPU = dict(CYBER, users=2_000, computers=1_500, groups=10, seed=26)
_CYBER_FACTOR_RTOL = 1e-4
_CYBER_SCORE_RTOL = 1e-4
# the AUC of cross-group over unseen intra-group pairs, set before the
# first card run from a CPU rehearsal at a quarter of the shape
CYBER_AUC_FLOOR = 0.9
CYBER_STREAM = dict(rows=200_000, files=4, chunk=65_536)
CYBER_HTTP = dict(rows=1_000, concurrency=4)
CYBER_PBI_BATCH = 1_000


def _cyber_log(cfg, tenant):
    """(columns tenant/user/res, one row an event, shuffled; user group,
    computer group (-1 shared), the sorted unique pair keys u * C + c)."""
    rng = np.random.default_rng(cfg["seed"])
    n_u, n_c, g, n_s = (cfg["users"], cfg["computers"], cfg["groups"],
                        cfg["shared"])
    own = n_c - n_s                   # computer c < own is in group c % g
    user_group = rng.integers(0, g, n_u)
    comp_group = np.concatenate([np.arange(own) % g, np.full(n_s, -1)])
    draws = rng.poisson(cfg["own_draws"], n_u) + 1
    users = np.repeat(np.arange(n_u), draws)
    ranks = _cyber_zipf_ranks(rng, len(users), own // g, cfg["zipf"])
    comps = user_group[users] + g * ranks
    users = np.concatenate([users, np.repeat(np.arange(n_u), n_s)])
    comps = np.concatenate([comps, np.tile(np.arange(own, n_c), n_u)])
    keys = np.unique(users.astype(np.int64) * n_c + comps)
    counts = rng.geometric(cfg["event_p"], len(keys))
    ev = np.repeat(keys, counts)[rng.permutation(int(counts.sum()))]
    cols = {"tenant": np.full(len(ev), tenant, np.int64),
            "user": ev // n_c, "res": ev % n_c}
    return dict(cols=cols, user_group=user_group, comp_group=comp_group,
                keys=keys, n_c=n_c)


def _cyber_zipf_ranks(rng, n, m, s):
    """n ranks in [0, m) with P(r) proportional to 1 / (r + 1)^s."""
    cdf = np.cumsum(1.0 / np.arange(1, m + 1) ** s)
    return np.searchsorted(cdf / cdf[-1], rng.random(n), side="right")


def _cyber_probes(cfg, log, n, seed):
    """n unseen intra-group pairs (a computer of the user's group by the
    training popularity, never observed for that user) and n cross-group
    pairs (a computer of another group): (users, computers) each."""
    rng = np.random.default_rng(seed)
    g, n_c = cfg["groups"], cfg["computers"]
    own = n_c - cfg["shared"]
    out = []
    for cross in (False, True):
        u = rng.integers(0, cfg["users"], 3 * n)
        grp = log["user_group"][u]
        if cross:
            grp = (grp + rng.integers(1, g, 3 * n)) % g
        c = grp + g * _cyber_zipf_ranks(rng, 3 * n, own // g, cfg["zipf"])
        key = u.astype(np.int64) * n_c + c
        fresh = ~np.isin(key, log["keys"])
        out.append((u[fresh][:n], c[fresh][:n]))
        if fresh.sum() < n:
            raise AssertionError(f"[cyber] only {fresh.sum()} fresh probe "
                                 f"pairs")
    return out


def _cyber_auc(neg, pos):
    """AUC of pos over neg scores (ties count half)."""
    from mmlspark_tpu_torch.train.metrics import auc
    y = np.concatenate([np.zeros(len(neg)), np.ones(len(pos))])
    return float(auc(y, np.concatenate([neg, pos])))


def _cyber_table(tenant, users, res, **extra):
    from mmlspark_tpu_torch import Table
    return Table({"tenant": np.full(len(users), tenant, np.int64),
                  "user": np.asarray(users, np.int64),
                  "res": np.asarray(res, np.int64), **extra})


def _cyber_pipeline(dev):
    from mmlspark_tpu_torch.core import Pipeline
    from mmlspark_tpu_torch.cyber import AccessAnomaly, IdIndexer
    return Pipeline(stages=[
        IdIndexer(input_col="user", output_col="user_ix"),
        IdIndexer(input_col="res", output_col="res_ix"),
        AccessAnomaly(user_col="user_ix", res_col="res_ix", device=dev,
                      **CYBER_FIT)])


def _cyber_same_fit(a, b):
    """Two AccessAnomalyModels equal bit for bit: levels, factors and
    statistics of every tenant."""
    import torch
    if sorted(a._models) != sorted(b._models):
        return False
    for k, (ul, uv, rl, rv, mean, std) in a._models.items():
        ul2, uv2, rl2, rv2, mean2, std2 = b._models[k]
        if not (np.array_equal(ul, ul2) and np.array_equal(rl, rl2)
                and torch.equal(uv, uv2) and torch.equal(rv, rv2)
                and mean == mean2 and std == std2):
            return False
    return True


def _cyber_fit_and_score(dev, out):
    """(a) the pipeline (two IdIndexers, AccessAnomaly) fit on the card
    twice, bit-identical; the ALS under a ProfileSession; scoring of the
    probes and their AUC; the card against the CPU on CYBER_CPU."""
    import tempfile

    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.cyber import AccessAnomaly
    from mmlspark_tpu_torch.cyber import access_anomaly as aa
    from mmlspark_tpu_torch.telemetry import profiler
    t0 = time.perf_counter()
    big, small = _cyber_log(CYBER, 0), _cyber_log(CYBER_SMALL, 1)
    cols = {k: np.concatenate([big["cols"][k], small["cols"][k]])
            for k in big["cols"]}
    train = Table(cols)
    out["data_s"] = time.perf_counter() - t0
    n_pairs = len(big["keys"])
    per_user = n_pairs / CYBER["users"]
    log(f"[cyber] (a) LANL-shaped tenant: {CYBER['users']} users x "
        f"{CYBER['computers']} computers in {CYBER['groups']} groups + "
        f"{CYBER['shared']} shared servers, {n_pairs} observed pairs "
        f"({per_user:.1f} distinct computers a user), "
        f"{len(big['cols']['user'])} events; tenant 1 "
        f"{CYBER_SMALL['users']} x {CYBER_SMALL['computers']}, "
        f"{len(small['cols']['user'])} events; generated in "
        f"{out['data_s']:.2f} s")
    fits = []
    for i in range(2):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model = _cyber_pipeline(dev).fit(train)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t1
        aam = model.stages[-1]
        fits.append(dict(model=model, fit_s=fit_s, split=dict(
            aam.fit_seconds), peak=torch.cuda.max_memory_allocated() - base))
        log(f"[cyber] (a) fit {i + 1}: {fit_s:.3f} s (AccessAnomaly: host "
            f"aggregation {aam.fit_seconds['aggregate']:.3f} s, matrices "
            f"on the card {aam.fit_seconds['matrices']:.3f} s, ALS "
            f"{aam.fit_seconds['als']:.3f} s, statistics "
            f"{aam.fit_seconds['stats']:.3f} s), peak "
            f"{fits[-1]['peak'] / 2**30:.3f} GiB over the resident")
    if not _cyber_same_fit(fits[0]["model"].stages[-1],
                           fits[1]["model"].stages[-1]):
        raise AssertionError("[cyber] (a) two card fits differ")
    model = fits[0]["model"]
    del fits[1]["model"]
    torch.cuda.empty_cache()
    out.update(fit_s=[f["fit_s"] for f in fits],
               split=[f["split"] for f in fits],
               peak=max(f["peak"] for f in fits))

    # the ALS alone under a ProfileSession: the card's busy share
    u_l, u_ix = np.unique(big["cols"]["user"], return_inverse=True)
    r_l, r_ix = np.unique(big["cols"]["res"], return_inverse=True)
    keys, sums = aa.pair_sums(u_ix, r_ix, np.ones(len(u_ix)), len(r_l))
    ratings, weights = aa.tenant_matrices(
        keys, sums, len(u_l), len(r_l), CYBER_FIT["low_value"],
        CYBER_FIT["high_value"], CYBER_FIT["neg_score"],
        CYBER_FIT["complementset_factor"], dev)
    u0, v0 = aa.initial_factors(len(u_l), len(r_l), CYBER_FIT["rank"], 0)
    u0, v0 = torch.as_tensor(u0, device=dev), torch.as_tensor(v0, device=dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cyber_prof_")
    try:
        session = profiler.ProfileSession(profile_dir=tmp,
                                          min_interval_s=0.0)
        with session.session(reason="warm-up"):
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with session.session(reason="cyber-als") as info:
            aa.als(ratings, weights, u0, v0, CYBER_FIT["max_iter"],
                   CYBER_FIT["reg_param"])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del ratings, weights
    torch.cuda.empty_cache()
    dev_sum = info.get("device") or {}
    if not dev_sum.get("device_events"):
        raise AssertionError(f"[cyber] (a) the ALS capture parsed no device "
                             f"events: {dev_sum}")
    busy = dev_sum["busy_us"] * 1e-6
    top = [(r["op"], r["self_time_us"]) for r in info["ops"][:4]]
    out["als_profile"] = dict(busy_s=busy, wall_s=wall, share=busy / wall,
                              events=dev_sum["device_events"], top=top)
    log(f"[cyber] (a) ALS under a ProfileSession: the card busy "
        f"{busy:.4f} s of {wall:.4f} s (share {busy / wall:.3f}), "
        f"{dev_sum['device_events']} device events; top "
        + ", ".join(f"{op[:48]} {us / 1e3:.2f} ms" for op, us in top))

    # scoring: unseen intra-group against cross-group pairs
    (iu, ic), (cu, cc) = _cyber_probes(CYBER, big, CYBER_PROBE, 27)
    scores = {}
    t1 = time.perf_counter()
    for name, (u, c) in (("intra", (iu, ic)), ("cross", (cu, cc))):
        scores[name] = model.transform(_cyber_table(0, u, c))[
            "anomaly_score"]
    score_s = time.perf_counter() - t1
    auc_v = _cyber_auc(scores["intra"], scores["cross"])
    out.update(score_rows_per_s=2 * CYBER_PROBE / score_s, auc=auc_v,
               intra_mean=float(scores["intra"].mean()),
               cross_mean=float(scores["cross"].mean()))
    log(f"[cyber] (a) scored {CYBER_PROBE} unseen intra-group and "
        f"{CYBER_PROBE} cross-group pairs in {score_s:.3f} s "
        f"({out['score_rows_per_s']:.4g} rows/s): mean score "
        f"{out['intra_mean']:.4f} / {out['cross_mean']:.4f}, AUC "
        f"{auc_v:.6f} (floor {CYBER_AUC_FLOOR})")
    if not auc_v > CYBER_AUC_FLOOR:
        raise AssertionError(f"[cyber] (a) AUC {auc_v} under its floor "
                             f"{CYBER_AUC_FLOOR}")
    unseen = model.transform(_cyber_table(
        0, [CYBER["users"] + 5, 3], [7, CYBER["computers"] + 9]))
    if not (unseen["anomaly_score"] == 0.0).all():
        raise AssertionError(f"[cyber] (a) unseen ids scored "
                             f"{unseen['anomaly_score']}")

    # the card against the port's CPU fit on a reduced tenant
    red = _cyber_log(CYBER_CPU, 0)
    t_red = Table(red["cols"])
    fitted = {}
    for where in (dev, "cpu"):
        fitted[str(where)] = AccessAnomaly(device=where,
                                           **CYBER_FIT).fit(t_red)
    card, cpu = fitted[str(dev)], fitted["cpu"]
    _, uv, _, rv, _, _ = card._models["0"]
    _, cuv, _, crv, _, _ = cpu._models["0"]
    f_err = max(_rel(uv.cpu().numpy(), cuv.numpy()),
                _rel(rv.cpu().numpy(), crv.numpy()))
    (pu, pc), (qu, qc) = _cyber_probes(CYBER_CPU, red, 2_000, 28)
    probe = _cyber_table(0, np.concatenate([pu, qu]),
                         np.concatenate([pc, qc]))
    s_err = _rel(card.transform(probe)["anomaly_score"],
                 cpu.transform(probe)["anomaly_score"])
    out.update(cpu_factor_err=f_err, cpu_score_err=s_err)
    log(f"[cyber] (a) card against the CPU fit on {CYBER_CPU['users']} x "
        f"{CYBER_CPU['computers']}: factors {f_err:.3g} of max |factor| "
        f"(limit {_CYBER_FACTOR_RTOL}), scores {s_err:.3g} of max |score| "
        f"(limit {_CYBER_SCORE_RTOL})")
    if not (f_err <= _CYBER_FACTOR_RTOL and s_err <= _CYBER_SCORE_RTOL):
        raise AssertionError("[cyber] (a) the card fit left the CPU's")
    return model, big


def _cyber_stream(dev, model, big, out):
    """(b) a writer thread appends access-log lines to CYBER_STREAM
    ['files'] CSV files in pieces that cut lines (and leaves a torn last
    line); a FileStreamSource(mode="csv") / FileStreamQuery scores them
    with the fitted pipeline into a sink that fails once. The failed
    epoch replays; every row is scored exactly once, and the scores equal
    one bulk transform of the same rows."""
    import tempfile
    import threading

    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.io import FileStreamQuery, FileStreamSource
    n = CYBER_STREAM["rows"]
    rng = np.random.default_rng(29)
    pick = rng.integers(0, len(big["cols"]["user"]), n // 2)
    (iu, ic), (cu, cc) = _cyber_probes(CYBER, big, n // 4, 30)
    users = np.concatenate([big["cols"]["user"][pick], iu, cu])
    comps = np.concatenate([big["cols"]["res"][pick], ic, cc])
    users, comps = users[:n], comps[:n]
    want = model.transform(_cyber_table(0, users, comps))["anomaly_score"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cyber_stream_")
    header = "seq,tenant,user,res\n"
    paths = [os.path.join(tmp, f"auth-{i}.csv")
             for i in range(CYBER_STREAM["files"])]
    for p in paths:
        with open(p, "w") as f:
            f.write(header)
    got, failed, lock = [], [0], threading.Lock()

    def score(t):
        rows = Table({"tenant": np.asarray(t["tenant"], np.int64),
                      "user": np.asarray(t["user"], np.int64),
                      "res": np.asarray(t["res"], np.int64)})
        s = model.transform(rows)["anomaly_score"]
        return Table({"seq": np.asarray(t["seq"], np.int64),
                      "anomaly_score": s})

    def sink(t):
        with lock:
            if not failed[0]:
                failed[0] = len(t)
                raise RuntimeError("sink down once")
            got.append((t["seq"], t["anomaly_score"]))

    def writer():
        per = -(-n // len(paths))
        for i, p in enumerate(paths):
            lo, hi = i * per, min(n, (i + 1) * per)
            text = "".join(f"{j},0,{users[j]},{comps[j]}\n"
                           for j in range(lo, hi)).encode()
            with open(p, "ab") as f:
                for a in range(0, len(text), CYBER_STREAM["chunk"]):
                    f.write(text[a:a + CYBER_STREAM["chunk"]])
                    f.flush()
        with open(paths[0], "ab") as f:
            f.write(f"{n},0,1,".encode())     # a torn last line
    src = FileStreamSource(os.path.join(tmp, "*.csv"), mode="csv")
    query = FileStreamQuery(src, score, sink, poll_interval=0.01)
    t0 = time.perf_counter()
    query.start()
    th = threading.Thread(target=writer, name="cyber-writer")
    th.start()
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            with lock:
                done = sum(len(s) for s, _ in got)
            if done >= n:
                break
            time.sleep(0.005)
        stream_s = time.perf_counter() - t0
        th.join(timeout=60)
        time.sleep(0.1)     # polls that would pick up a torn line
    finally:
        query.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    seq = np.concatenate([s for s, _ in got])
    sc = np.concatenate([v for _, v in got])
    order = np.argsort(seq, kind="stable")
    if not np.array_equal(seq[order], np.arange(n)):
        raise AssertionError(f"[cyber] (b) rows not scored exactly once: "
                             f"{len(seq)} scores for {n} rows, "
                             f"{len(np.unique(seq))} distinct")
    if not np.array_equal(sc[order].view(np.uint64), want.view(np.uint64)):
        raise AssertionError("[cyber] (b) streamed scores differ from the "
                             "bulk transform")
    if query._recoveries < 1 or not failed[0]:
        raise AssertionError("[cyber] (b) the sink's failure never "
                             "replayed")
    out["stream"] = dict(rows=n, s=stream_s, rows_per_s=n / stream_s,
                         batches=len(got), replayed_rows=failed[0],
                         recoveries=query._recoveries)
    log(f"[cyber] (b) streamed {n} rows through {len(paths)} tailed CSV "
        f"files in {stream_s:.3f} s ({n / stream_s:.4g} rows/s, "
        f"{len(got)} epochs); the sink failed once on {failed[0]} rows, "
        f"which replayed; every row scored once, equal to the bulk "
        f"transform bit for bit; the torn last line held back")


def _cyber_http(dev, model, big, out):
    """(c) the pipeline served by `serve_pipeline`; rows scored through
    SimpleHTTPTransformer (JSONInputParser -> HTTPTransformer ->
    JSONOutputParser) at concurrency CYBER_HTTP['concurrency'], the
    answers equal to the bulk transform; the scores written with
    `powerbi.write` in batches to a local endpoint, every row once."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.io import (JSONInputParser, JSONOutputParser,
                                       SimpleHTTPTransformer, powerbi,
                                       serve_pipeline)
    n = CYBER_HTTP["rows"]
    (iu, ic), (cu, cc) = _cyber_probes(CYBER, big, n // 2, 31)
    users, comps = np.concatenate([iu, cu]), np.concatenate([ic, cc])
    want = model.transform(_cyber_table(0, users, comps))["anomaly_score"]
    rows = np.empty(n, dtype=object)
    for i in range(n):
        rows[i] = {"tenant": 0, "user": int(users[i]), "res": int(comps[i])}
    server, query = serve_pipeline(model, ["tenant", "user", "res"],
                                   output_col="anomaly_score")
    try:
        url = server.address + "/"
        client = SimpleHTTPTransformer(
            input_col="row", output_col="reply", url=url,
            concurrency=CYBER_HTTP["concurrency"], timeout=60.0,
            input_parser=JSONInputParser(url=url),
            output_parser=JSONOutputParser())
        client.transform(Table({"row": rows[:8]}))       # warm the plans
        t0 = time.perf_counter()
        replies = client.transform(Table({"row": rows}))["reply"]
        http_s = time.perf_counter() - t0
    finally:
        query.stop()
        server.stop()
    bad = [i for i, r in enumerate(replies)
           if r is None or r.get("anomaly_score") != want[i]]
    if bad:
        raise AssertionError(f"[cyber] (c) {len(bad)} served answers differ "
                             f"from the bulk transform, e.g. row {bad[0]}: "
                             f"{replies[bad[0]]} against {want[bad[0]]}")

    seen, lock = [], threading.Lock()

    class _PowerBI(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 (stdlib naming)
            body = self.rfile.read(int(self.headers["Content-Length"]))
            with lock:
                seen.extend(r["seq"] for r in json.loads(body))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _PowerBI)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        t0 = time.perf_counter()
        sent = powerbi.write(
            Table({"seq": np.arange(n), "anomaly_score": want}),
            f"http://127.0.0.1:{httpd.server_address[1]}/",
            batch_size=CYBER_PBI_BATCH, concurrency=4, timeout=60.0)
        pbi_s = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
    if sorted(seen) != list(range(n)) or sent != -(-n // CYBER_PBI_BATCH):
        raise AssertionError(f"[cyber] (c) Power BI received {len(seen)} "
                             f"rows ({len(set(seen))} distinct) of {n} in "
                             f"{sent} batches")
    out["http"] = dict(rows=n, s=http_s, req_per_s=n / http_s,
                       powerbi_s=pbi_s, powerbi_batches=sent)
    log(f"[cyber] (c) {n} rows served at concurrency "
        f"{CYBER_HTTP['concurrency']} in {http_s:.3f} s "
        f"({n / http_s:.1f} req/s), every answer equal to the bulk "
        f"transform; powerbi.write {sent} batches of {CYBER_PBI_BATCH} in "
        f"{pbi_s:.3f} s, every row once")


def cyber_phase(dev):
    """[cyber]: CyberML and io/ on the card: (a) the AccessAnomaly
    pipeline fit at the LANL shape (host aggregation, dense matrices on
    the card, ALS as batched ridge solves), two fits bit-identical, the
    ALS's busy share, scoring rows/s and the AUC of cross-group over
    unseen intra-group pairs, the card against the CPU on a reduced
    tenant; (b) the CSV file stream scored into a sink that fails once;
    (c) HTTP out and back and the Power BI writer. No port kernel is on
    this path: the histogram and flash counts must stand still."""
    import torch
    from mmlspark_tpu_torch.ops import flash_attention as fa
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    t_phase = time.perf_counter()
    before = {**hc.launches, **fa.launches}
    out = {"parts_s": {}}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        got = fn(*args)
        out["parts_s"][name] = time.perf_counter() - t0
        return got
    model, big = part("(a)", _cyber_fit_and_score, dev, out)
    part("(b)", _cyber_stream, dev, model, big, out)
    part("(c)", _cyber_http, dev, model, big, out)
    del model
    torch.cuda.empty_cache()
    after = {**hc.launches, **fa.launches}
    if after != before:
        raise AssertionError(f"[cyber] a port kernel launched: {before} -> "
                             f"{after}")
    out["s"] = time.perf_counter() - t_phase
    log(f"[cyber] kernel launches unchanged across the phase; the phase "
        f"{out['s']:.1f} s: " + ", ".join(
            f"{k} {v:.1f}" for k, v in out["parts_s"].items()))
    return out


# ------------------------------------------------------------- [telemetry]
TELE_PROFILE_MS = 200          # the /debug/profile window under load
TELE_LOAD = (4, 40)            # clients x requests a client, per server
TELE_LM_KERNELS = {"flash_fwd": "flash_fwd_", "flash_bwd_dq": "flash_bwd_dq",
                   "flash_bwd_dkv": "flash_bwd_dkv"}
# the flight bundle's files, in the manifest's order (the reference's
# telemetry/perf.py:724-764)
TELE_BUNDLE_FILES = ("spans.jsonl", "pending.jsonl", "metrics.json",
                     "metrics_window.json", "slo.json", "compiles.json",
                     "memory.json", "goodput.json", "roofline.json",
                     "quality.json", "versions.json", "manifest.json")
# self times are rounded to 1e-3 us per op row: the most the three
# regions' rounded sum may exceed the device-busy union by
_TELE_ROUND_US = 5e-4


def _region_kernels(ops, token, region=None):
    """Occurrences of the device ops whose name holds `token` (in
    `region`, or in any region when None)."""
    return sum(r["occurrences"] for r in ops if token in r["op"]
               and (region is None or r["region"] == region))


def _iteration_bytes(n, f, b, depth):
    """Analytic bytes one headline iteration moves, per region: the
    histogram kernel's (`_bound`'s count: node ids, bins/grad/hess of the
    active rows, the three outputs; after depth 0 the left children
    only), the split search's (the three (m, F, B) f32 histograms read
    twice: cumsum and gain), the routing's (node ids read and written,
    one bin byte and the active flag a row)."""
    hist = split = 0.0
    for d in range(depth):
        m_built = 1 if d == 0 else 2 ** (d - 1)
        active = n if d == 0 else n // 2
        hist += 4 * n + active * (f + 8) + 3 * m_built * f * b * 4
        split += 2 * 3 * (2 ** d) * f * b * 4
    return {"gbdt.hist": hist, "gbdt.split": split,
            "gbdt.route": float(depth * n * (4 + 4 + 1 + 1))}


def _telemetry_gbdt(dev, data, tmp, out):
    """(a) one headline boosting iteration on a thread the profiler does
    not follow (as a triggered `capture` sees a fit): gbdt.hist's
    hist_tile_kernel count against the wrapper's, the three regions
    within the device-busy time, the roofline rows; then an annotated
    tree grown under torch.cuda.set_sync_debug_mode("error")."""
    import dataclasses
    import threading

    import torch
    from mmlspark_tpu_torch.models.gbdt import fit_booster
    from mmlspark_tpu_torch.models.gbdt import trainer as gtrainer
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    from mmlspark_tpu_torch.telemetry import profiler
    x, y, staged = data["x"], data["y"], data["staged"]
    session = profiler.ProfileSession(
        profile_dir=os.path.join(tmp, "gbdt"), min_interval_s=0.0)
    # the first capture of the process starts CUPTI: paid here, outside
    # the measured one
    t0 = time.perf_counter()
    with session.session(reason="warm-up") as info:
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
    out["cupti_start_s"] = time.perf_counter() - t0
    params = dataclasses.replace(_headline_params(), num_iterations=1)
    fit_booster(x, y, params, prebinned=staged, device=dev)
    torch.cuda.synchronize()
    box = {}

    def fit():
        try:
            t1 = time.perf_counter()
            fit_booster(x, y, params, prebinned=staged, device=dev)
            torch.cuda.synchronize()
            box["wall"] = time.perf_counter() - t1
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["err"] = e

    profiler.get_roofline().clear()
    hc.reset_launches()
    t0 = time.perf_counter()
    with session.session(reason="headline-iteration") as info:
        th = threading.Thread(target=fit, name="telemetry-fit")
        th.start()
        th.join()
    capture_s = time.perf_counter() - t0
    if "err" in box:
        raise box["err"]
    launches = {k: v for k, v in hc.launches.items() if v}
    ops, dev_sum, regions = info["ops"], info["device"], info["regions"]
    if not dev_sum.get("device_events"):
        raise AssertionError(f"[telemetry] (a) the capture of a fit that "
                             f"launched {launches} parsed no device "
                             f"events: {dev_sum}")
    in_hist = _region_kernels(ops, "hist_tile_kernel", "gbdt.hist")
    anywhere = _region_kernels(ops, "hist_tile_kernel")
    if launches != {"hist_tiled": DEPTH} or in_hist != DEPTH \
            or anywhere != DEPTH:
        raise AssertionError(f"[telemetry] (a) hist_tile_kernel in "
                             f"gbdt.hist {in_hist} (anywhere {anywhere}), "
                             f"the wrapper counted {launches}; expected "
                             f"{DEPTH}")
    names = ("gbdt.hist", "gbdt.split", "gbdt.route")
    us = {r: regions.get(r, {}).get("self_time_us", 0.0) for r in names}
    if min(us.values()) <= 0.0:
        raise AssertionError(f"[telemetry] (a) a region has no device "
                             f"time: {regions}")
    total = sum(r["self_time_us"] for r in ops)
    busy = dev_sum["busy_us"]
    if sum(us.values()) > busy + _TELE_ROUND_US * len(ops):
        raise AssertionError(f"[telemetry] (a) the regions' {us} sum past "
                             f"the device-busy {busy} us")
    # roofline: each region's analytic bytes over the iteration against
    # its device time, at the chip table's peaks (the ledger's cost is a
    # device op's share: the region's bytes over its op count)
    n, f = staged[1].shape
    cost = _iteration_bytes(n, f, MAX_BIN + 1, DEPTH)
    ledger = profiler.get_roofline()
    for region in names:
        ledger.set_cost(region, bytes_accessed=cost[region]
                        / regions[region]["occurrences"])
    rows = ledger.rows()
    peaks = profiler.resolve_peaks()
    for region in names:
        row = rows.get(region, {})
        if row.get("source") != "device" or "hbm_util" not in row:
            raise AssertionError(f"[telemetry] (a) roofline row {region}: "
                                 f"{row}")
    if not str(peaks["source"]).startswith("chip-table:"):
        raise AssertionError(f"[telemetry] (a) peaks {peaks}")
    other = total - sum(us.values())
    out["gbdt"] = dict(us=us, busy_us=busy, total_us=total,
                       other_share=other / total, launches=launches,
                       in_hist=in_hist, device=dev_sum, wall_s=box["wall"],
                       capture_s=capture_s,
                       roofline={r: rows[r] for r in names})
    log(f"[telemetry] (a) CUPTI start {out['cupti_start_s']:.2f} s (a "
        f"warm-up capture); one headline iteration on a thread of its "
        f"own, {box['wall'] * 1e3:.1f} ms wall, captured in "
        f"{capture_s:.2f} s: {dev_sum['device_events']} device events, "
        f"{total / 1e3:.3f} ms of device time, busy {busy / 1e3:.3f} ms; "
        + ", ".join(f"{r} {us[r] / 1e3:.3f} ms ({100 * us[r] / total:.1f}"
                    f"%, {rows[r]['occurrences']} kernels, "
                    f"{rows[r]['achieved_hbm_bytes_per_s'] / 1e9:.1f} GB/s"
                    f" = {100 * rows[r]['hbm_util']:.2f}% of "
                    f"{peaks['hbm_bytes_per_s'] / 1e12:.2f} TB/s)"
                    for r in names)
        + f"; in no region {other / 1e3:.3f} ms ({100 * other / total:.1f}"
        f"%); hist_tile_kernel in gbdt.hist {in_hist} = the wrapper's "
        f"{launches['hist_tiled']}; attributed by launch "
        f"{dev_sum['by_launch']}, by waiting thread "
        f"{dev_sum['by_waiting_thread']}, by device range "
        f"{dev_sum['by_device_range']} ({peaks['source']})")
    # an annotated tree under sync-debug "error": the regions add no
    # host synchronisation
    _, d_bins, d_y = staged
    grad = torch.sigmoid(torch.zeros_like(d_y)) - d_y
    hess = torch.full_like(d_y, 0.25)
    fmask = torch.ones(f, dtype=torch.bool, device=dev)
    cfg = gtrainer.TreeConfig(n_features=f, max_depth=DEPTH, num_leaves=31,
                              n_bins=MAX_BIN + 1)
    gtrainer.train_one_tree(d_bins, grad, hess, fmask, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gtrainer.train_one_tree(d_bins, grad, hess, fmask, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("[telemetry] (a) an annotated tree (train_one_tree, headline "
        "shape) under torch.cuda.set_sync_debug_mode('error'): no host "
        "synchronisation")


def _telemetry_lm(dev, tmp, out):
    """(b) one bf16 flagship LM step through `TrainingSupervisor.run`,
    captured: its train.step region holds the step's flash launches."""
    import torch
    from mmlspark_tpu_torch.models.dnn import PipelinedLMTrainer
    from mmlspark_tpu_torch.ops import flash_attention as fa
    from mmlspark_tpu_torch.reliability import TrainingSupervisor
    from mmlspark_tpu_torch.telemetry import profiler
    trainer = PipelinedLMTrainer(
        n_microbatches=1, attention="flash", optimizer="adam", seed=0,
        compute_dtype="bfloat16", remat="save_attn", device=dev, **LM)
    toks = np.random.default_rng(0).integers(
        0, LM["vocab_size"], size=(1, LM_SEQ)).astype(np.int32)
    trainer.step(toks)
    torch.cuda.synchronize()
    sup = TrainingSupervisor(os.path.join(tmp, "lm_ckpt"), lambda: {},
                             lambda payload: None, checkpoint_every=0,
                             handle_signals=False)
    session = profiler.ProfileSession(
        profile_dir=os.path.join(tmp, "lm"), min_interval_s=0.0)
    fa.reset_launches()
    with session.session(reason="lm-step") as info:
        t0 = time.perf_counter()
        losses = sup.run(lambda step: trainer.step(toks), 1, resume=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sup.close()
    launches = {k: v for k, v in fa.launches.items() if v}
    ops, dev_sum = info["ops"], info["device"]
    if not dev_sum.get("device_events"):
        raise AssertionError(f"[telemetry] (b) the step's capture parsed "
                             f"no device events: {dev_sum}")
    in_step = {k: _region_kernels(ops, tok, "train.step")
               for k, tok in TELE_LM_KERNELS.items()}
    want = {k: LM["n_layers"] for k in TELE_LM_KERNELS}
    if in_step != want or launches != want:
        raise AssertionError(f"[telemetry] (b) flash kernels in "
                             f"train.step {in_step}, launched {launches}; "
                             f"expected {want}")
    step_us = info["regions"].get("train.step", {}).get("self_time_us", 0)
    total = sum(r["self_time_us"] for r in ops)
    if not (np.isfinite(losses).all() and step_us > 0):
        raise AssertionError(f"[telemetry] (b) loss {losses}, train.step "
                             f"{step_us} us")
    out["lm"] = dict(step_us=step_us, total_us=total, wall_s=wall,
                     in_step=in_step, device=dev_sum)
    log(f"[telemetry] (b) one bf16 flagship LM step through "
        f"TrainingSupervisor.run: train.step {step_us / 1e3:.2f} ms of "
        f"device time ({100 * step_us / total:.1f}% of the capture's "
        f"{total / 1e3:.2f} ms) in a {wall * 1e3:.1f} ms wall; flash in "
        f"train.step {in_step}; attributed by launch "
        f"{dev_sum['by_launch']}, by waiting thread "
        f"{dev_sum['by_waiting_thread']}")
    del trainer
    torch.cuda.empty_cache()


def _tele_get(address, path):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(address + path, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _telemetry_serving(dev, tmp, out):
    """(c) `/debug/profile` under load on a served card model (the
    [serving] phase's ResNet-18 DNNModel: GBDT serves from its host plan
    and launches nothing), then the [serving] GBDT model: `/debug/bundle`
    200 then 429, an injected SLO burn dumping exactly one bundle (none
    while it stays burning), the bundle's files, a scrape's device
    memory gauges."""
    import threading

    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.io import serve_pipeline
    from mmlspark_tpu_torch.io.plan import compile_serving_transform
    from mmlspark_tpu_torch.io.serving import ServingQuery, ServingServer
    from mmlspark_tpu_torch.models.dnn import model as dnn_model
    from mmlspark_tpu_torch.models.dnn import resnet as rn
    from mmlspark_tpu_torch.models.gbdt.estimators import GBDTClassifier
    from mmlspark_tpu_torch.telemetry import names as tnames
    from mmlspark_tpu_torch.telemetry import perf, profiler, slo
    session = profiler.configure_profile_session(
        profile_dir=os.path.join(tmp, "serving"), min_interval_s=60.0)
    recorder = perf.configure_flight_recorder(
        bundle_dir=os.path.join(tmp, "bundles"), min_interval_s=60.0)
    cfg = SERVE_DNN
    net = rn.resnet18(num_classes=cfg["classes"])
    state = rn.resnet_params_from_numpy(rn.init_resnet(net, seed=1), dev)
    m = dnn_model.DNNModel(apply_fn=net, params=state,
                           batch_size=cfg["batch"])
    img = np.random.default_rng(6).random(
        (3, cfg["size"], cfg["size"])).astype(np.float32)
    body = json.dumps({"features": img.tolist()})
    server = ServingServer(num_partitions=2, transport="threading").start()
    q = ServingQuery(server, compile_serving_transform(
        m, ["features"], output_col="scores"), mode="continuous",
        max_batch=cfg["batch"]).start()
    load = {}
    try:
        _serve_statuses_ok(_serve_post_all(server.address,
                                           [body.encode()] * 4), "warm")
        th = threading.Thread(target=lambda: load.setdefault(
            "res", _serve_load(server, body, *TELE_LOAD)), daemon=True)
        th.start()
        time.sleep(0.5)
        status, prof = _tele_get(server.address,
                                 f"/debug/profile?ms={TELE_PROFILE_MS}")
        again, _ = _tele_get(server.address, "/debug/profile?ms=5")
        th.join(timeout=300)
    finally:
        q.stop()
        server.stop()
    if "res" not in load:
        raise AssertionError("[telemetry] (c) the load did not finish")
    plan_run = (prof.get("regions") or {}).get("serving.plan.run", {})
    if status != 200 or again != 429 or not prof["device"].get(
            "device_events") or plan_run.get("self_time_us", 0) <= 0:
        raise AssertionError(f"[telemetry] (c) /debug/profile {status} "
                             f"then {again}; serving.plan.run {plan_run}, "
                             f"device {prof.get('device')}")
    out["profile"] = dict(plan_run=plan_run, device=prof["device"],
                          req_per_s=load["res"].req_per_sec)
    log(f"[telemetry] (c) ResNet-18 DNNModel on 2 partitions under "
        f"{TELE_LOAD[0]} x {TELE_LOAD[1]} requests "
        f"({load['res'].req_per_sec:.1f} req/s): GET /debug/profile?ms="
        f"{TELE_PROFILE_MS} 200, serving.plan.run "
        f"{plan_run['self_time_us'] / 1e3:.3f} ms of device time in "
        f"{plan_run['occurrences']} device ops of "
        f"{prof['device']['device_events']} (by launch "
        f"{prof['device']['by_launch']}, by waiting thread "
        f"{prof['device']['by_waiting_thread']}); a second call 429")

    # the [serving] GBDT model: the flight recorder over HTTP
    rng = np.random.default_rng(0)
    x = rng.normal(size=(SERVE_ROWS, SERVE_FEAT)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float32)
    model = GBDTClassifier(num_iterations=20, max_depth=5).fit(
        Table({"features": x, "label": y}))
    body = json.dumps({"features": [0.1] * SERVE_FEAT})
    server, q = serve_pipeline(model, ["features"], mode="continuous")
    bundles = os.path.join(tmp, "bundles")
    try:
        _serve_load(server, body, *TELE_LOAD)
        first, manifest = _tele_get(server.address, "/debug/bundle")
        second, _ = _tele_get(server.address, "/debug/bundle")
        # an injected burn: an objective no served request can meet
        recorder.configure(min_interval_s=0.0)
        engine = slo.SLOEngine(objectives=[slo.Objective(
            name="telemetry.burn", kind=slo.LATENCY,
            metric=tnames.SERVING_REQUEST_E2E, threshold_ms=1e-3,
            quantile=50.0, window_s=60.0)])
        before = len(os.listdir(bundles))
        v1 = engine.verdict()
        after_burn = len(os.listdir(bundles))
        v2 = engine.verdict()
        after_stay = len(os.listdir(bundles))
        status, state = _tele_get(server.address, "/metrics.json")
    finally:
        q.stop()
        server.stop()
        recorder.configure(bundle_dir="", min_interval_s=60.0)
        session.configure(profile_dir="")
    if (first, second) != (200, 429):
        raise AssertionError(f"[telemetry] (c) /debug/bundle {first} then "
                             f"{second}")
    if not (v1["burning"] and v2["burning"]) or \
            (after_burn - before, after_stay - after_burn) != (1, 0):
        raise AssertionError(f"[telemetry] (c) burn dumped "
                             f"{after_burn - before}, staying burning "
                             f"{after_stay - after_burn}")
    got = sorted(os.listdir(manifest["path"]))
    if tuple(manifest["files"]) != TELE_BUNDLE_FILES or \
            got != sorted(TELE_BUNDLE_FILES):
        raise AssertionError(f"[telemetry] (c) bundle files {got}, "
                             f"manifest {manifest['files']}")
    gauges = state["gauges"]
    mem = perf.sample_resource_stats()
    if status != 200 or not mem["devices"] or not gauges.get(
            tnames.DEVICE_MEM_BYTES_IN_USE) or not gauges.get(
            tnames.device_mem_in_use(torch.cuda.current_device())):
        raise AssertionError(f"[telemetry] (c) scrape {status} without the "
                             f"device memory gauges: {sorted(gauges)}")
    out["bundle"] = dict(files=got, gauges={
        k: v for k, v in gauges.items() if k.startswith(("device", "host"))})
    log(f"[telemetry] (c) GBDT served: GET /debug/bundle 200 then 429; an "
        f"injected SLO burn dumped {after_burn - before} bundle, staying "
        f"burning {after_stay - after_burn}; the bundle's "
        f"{len(got)} files the reference's; /metrics.json "
        f"{tnames.DEVICE_MEM_BYTES_IN_USE} "
        f"{gauges[tnames.DEVICE_MEM_BYTES_IN_USE] / 2**20:.1f} MiB, "
        f"{tnames.DEVICE_MEM_PEAK_BYTES} "
        f"{gauges[tnames.DEVICE_MEM_PEAK_BYTES] / 2**20:.1f} MiB, "
        f"{tnames.HOST_RSS_BYTES} {gauges[tnames.HOST_RSS_BYTES] / 2**20:.1f}"
        f" MiB")


def telemetry_phase(dev, data):
    """[telemetry]: the device telemetry on the card (no kernel of its
    own; the regions must add no launch): (a) a headline iteration's
    kernel time by region, (b) an LM step's train.step, (c) the debug
    endpoints and the flight recorder of a served model."""
    import tempfile

    import torch
    from mmlspark_tpu_torch.ops import flash_attention as fa
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    t_phase = time.perf_counter()
    out = {"parts_s": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_telemetry_") as tmp:
        for name, fn, args in (("(a)", _telemetry_gbdt, (dev, data)),
                               ("(b)", _telemetry_lm, (dev,)),
                               ("(c)", _telemetry_serving, (dev,))):
            t0 = time.perf_counter()
            fn(*args, tmp, out)
            torch.cuda.empty_cache()
            out["parts_s"][name] = time.perf_counter() - t0
    hc.reset_launches()
    fa.reset_launches()
    out["s"] = time.perf_counter() - t_phase
    log(f"[telemetry] the phase {out['s']:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["parts_s"].items()))
    return out


IMAGES_DIR = os.path.join(HERE, "tests", "data", "images")
IMAGES_SIZE = (224, 224)
IMAGES_FOLDER = 64             # files in (b)'s folder, copies of the photos
IMAGES_REPLACES = ("none: the reference decodes with PIL on the host "
                   "(mmlspark_tpu/io/sources.py:64-88 read_images, "
                   "mmlspark_tpu/image/ops.py:30-52 read_image_dir)")


def _sha256(a) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _images_expected():
    with open(os.path.join(IMAGES_DIR, "expected.json")) as f:
        return json.load(f)


def _images_fixtures(dev, expected, out):
    """(a) every committed fixture decoded on the card against PIL's
    digests, at its own size and through read_images(size=(224, 224))."""
    import glob
    from mmlspark_tpu_torch.image.ops import read_image_dir
    from mmlspark_tpu_torch.io.sources import read_images
    files = expected["files"]
    t = read_image_dir(IMAGES_DIR, device=dev)
    names = [os.path.basename(p) for p in t["path"]]
    if names != sorted(files):
        raise AssertionError(f"[images] read_image_dir kept {len(names)} "
                             f"files, the fixtures are {len(files)}")
    bad = [n for n, im in zip(names, t["image"])
           if list(im.shape) != files[n]["shape"]
           or _sha256(im) != files[n]["rgb_sha256"]]
    r = read_images(os.path.join(IMAGES_DIR, "*.[jp][pn]g"),
                    size=tuple(expected["resize"]), device=dev)
    bad += [f"{os.path.basename(p)} (resized)" for p, im in
            zip(r["path"], r["image"]) if _sha256(im) != files[
                os.path.basename(p)]["resized_sha256"]]
    if bad or len(glob.glob(os.path.join(IMAGES_DIR, "*.[jp][pn]g"))) != len(
            files):
        raise AssertionError(f"[images] fixtures off PIL's digests: {bad}")
    out["fixtures"] = len(files)
    log(f"[images] (a) {len(files)} fixtures (PNG of every colour type and "
        f"depth, Adam7, JPEG 4:4:4/4:2:2/4:2:0/grey, restarts) decoded on "
        f"the card equal PIL's digests, at their size and resized to "
        f"{IMAGES_SIZE}")


def _kernel_row(name, src, fn, plain, args, n_bytes, library=None):
    """A kernel against its plain version on the same CUDA tensors: equal
    bit for bit, times (the plain version's from its one call), and the
    byte bound."""
    import torch
    got = fn(*args)
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    want = plain(*args)
    t1.record()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
        raise AssertionError(f"[images] {name} differs from its plain "
                             f"version: {int((diff > 0).sum())} bytes, max "
                             f"{int(diff.max())}")
    return dict(name=name, route="cuda", source=src,
                replaces=IMAGES_REPLACES, max_abs_err=0.0,
                ms=timed(lambda: fn(*args)),
                plain_ms=t0.elapsed_time(t1),
                bound_ms=n_bytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
                library_ms=library() if library else None,
                bytes=int(n_bytes)), got


def _images_kernels(dev, out):
    """(a) D1-D4 against their plain versions at the photos' size (the 4
    JPEGs and 2 PNGs of 500 x 375), timed; D4 on all six to 224 x 224,
    beside one F.interpolate(bicubic, antialias) of the same six images
    in float32 as the yardstick of time."""
    import glob
    import torch
    import torch.nn.functional as F
    from mmlspark_tpu_torch.image import decode, jpeg, png, resample
    from mmlspark_tpu_torch.ops import image_decode as kern
    src = "mmlspark_tpu_torch/ops/csrc/image_decode.cu"
    parsed = [decode.parse_file(p) for p in sorted(glob.glob(
        os.path.join(IMAGES_DIR, "photo_*")))]
    jp = [p for p in parsed if isinstance(p, jpeg.JpegImage)]
    pn = [p for p in parsed if isinstance(p, png.PngImage)]
    rows = {}
    a = decode.jpeg_inputs(jp, dev)
    args = (a["coefs"], a["quant"], a["block_plane"], a["planes"],
            a["plane_bytes"])
    rows["jpeg_idct_islow"], planes = _kernel_row(
        "jpeg_idct_islow", src, kern.jpeg_idct, kern._idct_plain, args,
        sum(t.numel() * t.element_size() for t in args[:4])
        + a["plane_bytes"])
    args = (planes, a["color"], a["rgb_bytes"])
    rows["jpeg_upsample_ycc_rgb"], _ = _kernel_row(
        "jpeg_upsample_ycc_rgb", src, kern.jpeg_color, kern._color_plain,
        args, a["plane_bytes"] + a["color"].numel() * 8 + a["rgb_bytes"])
    b = decode.png_inputs(pn, dev)
    args = (b["data"], b["passes"], b["raw_bytes"])
    rows["png_unfilter"], _ = _kernel_row(
        "png_unfilter", src, kern.png_unfilter, kern._unfilter_plain, args,
        b["data"].numel() + b["passes"].numel() * 8 + b["raw_bytes"])
    images = decode._jpegs(jp, dev) + decode._pngs(pn, dev)
    plans = [resample.plan(*im.shape[:2], *IMAGES_SIZE) for im in images]
    passes = {}
    for axis in ("h", "v"):
        r = decode.resample_inputs(images, plans, axis, dev)
        args = (r["images"], r["info"], r["bounds"], r["coefs"],
                r["vertical"], r["total"])
        passes[axis], flat = _kernel_row(
            "resample_bicubic_u8", "mmlspark_tpu_torch/ops/csrc/resample.cu",
            kern.resample, kern._resample_plain, args,
            r["images"].numel() + r["info"].numel() * 8
            + 4 * (r["bounds"].numel() + r["coefs"].numel()) + r["total"])
        images = [flat[o:o + h * w * 3].view(h, w, 3) for o, h, w in r["outs"]]
    x = torch.stack([im for im in decode._jpegs(jp, dev)
                     + decode._pngs(pn, dev)]).permute(0, 3, 1, 2).float()
    library = timed(lambda: F.interpolate(x, size=IMAGES_SIZE, mode="bicubic",
                                          antialias=True, align_corners=False))
    d4 = dict(passes["h"], ms=passes["h"]["ms"] + passes["v"]["ms"],
              plain_ms=passes["h"]["plain_ms"] + passes["v"]["plain_ms"],
              bound_ms=(x.numel() + len(images) * IMAGES_SIZE[0]
                        * IMAGES_SIZE[1] * 3) / PEAK_BYTES_PER_S * 1e3,
              library_ms=library,
              library="one F.interpolate(mode='bicubic', antialias=True) of "
                      "the same six images in float32 (N, 3, 375, 500)",
              per_pass={k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                               "bytes")}
                        for k, v in passes.items()})
    rows["resample_bicubic_u8"] = d4
    out["kernels"] = rows
    shape = dict(jpegs=len(jp), blocks=int(a["coefs"].shape[0]),
                 pngs=len(pn), png_passes=int(b["passes"].shape[0]),
                 images=len(images), size=list(IMAGES_SIZE))
    out["kernel_shape"] = shape
    log(f"[images] (a) D1-D4 equal their plain versions bit for bit on the "
        f"500x375 photos ({shape}); " + "; ".join(
            f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.3f}, bound "
            f"{v['bound_ms']:.4f}"
            + (f", F.interpolate {v['library_ms']:.4f}" if v["library_ms"]
               else "") + ")" for k, v in rows.items()))


def _region_walls(info) -> dict:
    """Host seconds of each profile region a capture noted
    (regions.json's intervals, summed per region)."""
    with open(os.path.join(info["path"], "regions.json")) as f:
        intervals = json.load(f)["intervals"]
    walls = {}
    for *_, t0, t1, name in intervals:
        walls[name] = walls.get(name, 0.0) + (t1 - t0) * 1e-9
    return walls


def _images_path(dev, tmp, expected, out):
    """(b) files -> features: a folder of IMAGES_FOLDER copies of the
    photos through read_images(size=(224, 224)) into the ResNet-50 bf16
    ImageFeaturizer, counted and timed, then the same run inside a
    ProfileSession capture split by region; (c) read_image_dir on it."""
    import glob
    import tempfile
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.image.ops import read_image_dir
    from mmlspark_tpu_torch.io.sources import read_images
    from mmlspark_tpu_torch.models.dnn import ImageFeaturizer
    from mmlspark_tpu_torch.models.dnn import resnet as rn
    from mmlspark_tpu_torch.ops import image_decode as kern
    from mmlspark_tpu_torch.telemetry import profiler
    photos = sorted(glob.glob(os.path.join(IMAGES_DIR, "photo_*")))
    folder = os.path.join(tmp, "photos")
    os.makedirs(folder)
    for i in range(IMAGES_FOLDER):
        shutil.copy(photos[i % len(photos)], os.path.join(
            folder, f"{i:03d}_{os.path.basename(photos[i % len(photos)])}"))
    pattern = os.path.join(folder, "*")
    fz = ImageFeaturizer(model_name="resnet50", dtype="bfloat16",
                         variables=rn.init_resnet(rn.resnet50(), seed=0),
                         image_height=IMAGES_SIZE[0],
                         image_width=IMAGES_SIZE[1], batch_size=DNN_BATCH)

    def files_to_features():
        t0 = time.perf_counter()
        table = read_images(pattern, size=IMAGES_SIZE, device=dev)
        t1 = time.perf_counter()
        feats = fz.transform(table)["features"]
        torch.cuda.synchronize()
        return table, feats, t1 - t0, time.perf_counter() - t1
    # warm-up: cuDNN's plans for the featurizer's batches
    fz.transform(Table({"image": np.zeros((IMAGES_FOLDER,) + IMAGES_SIZE
                                          + (3,), np.float32)}))
    kern.reset_launches()
    table, feats, decode_s, feat_s = files_to_features()
    launches = dict(kern.launches)
    want = {"jpeg_idct_islow": 1, "jpeg_upsample_ycc_rgb": 1,
            "png_unfilter": 1, "resample_bicubic_u8": 2}
    if launches != want:
        raise AssertionError(f"[images] (b) launches {launches}, want {want}")
    if feats.shape != (IMAGES_FOLDER, 2048) or not np.isfinite(feats).all():
        raise AssertionError(f"[images] (b) features {feats.shape}, finite "
                             f"{np.isfinite(feats).all()}")
    bad = [p for p, im in zip(table["path"], table["image"])
           if _sha256(im) != expected["files"][os.path.basename(p)[4:]][
               "resized_sha256"]]
    if bad or table["image"].dtype != np.float32:
        raise AssertionError(f"[images] (b) decoded images off PIL's: {bad}")
    wall = decode_s + feat_s
    prof_dir = tempfile.mkdtemp(prefix="chip_smoke_images_prof_", dir=tmp)
    session = profiler.ProfileSession(profile_dir=prof_dir,
                                      min_interval_s=0.0)
    with session.session(reason="warm-up"):
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with session.session(reason="files-to-features") as info:
        files_to_features()
    prof_wall = time.perf_counter() - t0
    dev_sum = info.get("device") or {}
    if not dev_sum.get("device_events"):
        raise AssertionError(f"[images] (b) the capture parsed no device "
                             f"events: {dev_sum}")
    walls = _region_walls(info)
    regions = {k: v["self_time_us"] * 1e-3 for k, v in info["regions"].items()}
    host = walls.get("image.decode.host", 0.0)
    card = walls.get("image.decode.card", 0.0)
    out["path"] = dict(
        files=IMAGES_FOLDER, images_per_s=IMAGES_FOLDER / wall, wall_s=wall,
        decode_s=decode_s, featurize_s=feat_s, launches=launches,
        profiled=dict(wall_s=prof_wall, host_region_s=host,
                      card_region_s=card,
                      featurizer_s=prof_wall - host - card,
                      device_ms_by_region=regions,
                      busy_ms=dev_sum.get("busy_us", 0.0) * 1e-3))
    log(f"[images] (b) {IMAGES_FOLDER} files (500x375: 4 JPEGs and 2 PNGs, "
        f"cycled) -> read_images(size={IMAGES_SIZE}) -> ResNet-50 bf16 "
        f"ImageFeaturizer: {IMAGES_FOLDER / wall:.2f} images/s ({wall:.3f} "
        f"s: decode {decode_s:.3f} s, featurize {feat_s:.3f} s), launches "
        f"{launches}; under a ProfileSession ({prof_wall:.3f} s): "
        f"image.decode.host {host:.3f} s, image.decode.card {card:.3f} s of "
        f"host time, the rest (featurizer) {prof_wall - host - card:.3f} s; "
        f"device ms by region " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(regions.items()))
        + f"; busy {dev_sum.get('busy_us', 0.0) * 1e-3:.3f} ms")
    kern.reset_launches()
    t0 = time.perf_counter()
    t = read_image_dir(folder, device=dev)
    dir_s = time.perf_counter() - t0
    if t["image"].shape != (IMAGES_FOLDER, 375, 500, 3) or any(
            _sha256(im) != expected["files"][os.path.basename(p)[4:]][
                "rgb_sha256"] for p, im in zip(t["path"], t["image"])):
        raise AssertionError(f"[images] (c) read_image_dir gave "
                             f"{t['image'].shape} or pixels off PIL's")
    out["read_image_dir"] = dict(s=dir_s, images_per_s=IMAGES_FOLDER / dir_s,
                                 launches=dict(kern.launches))
    log(f"[images] (c) read_image_dir on the folder: {dir_s:.3f} s "
        f"({IMAGES_FOLDER / dir_s:.2f} images/s), uint8 "
        f"{t['image'].shape}, launches {dict(kern.launches)}")


def images_phase(dev):
    """[images]: the image decoders on the card (slice 25)."""
    import tempfile
    import torch
    t_phase = time.perf_counter()
    expected = _images_expected()
    out = {}
    _images_fixtures(dev, expected, out)
    _images_kernels(dev, out)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        _images_path(dev, tmp, expected, out)
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_phase
    log(f"[images] the phase {out['s']:.1f} s")
    return out


def only_phase(name, dev, phase, t_start, profile=False) -> int:
    """`--only NAME`: one phase after card and build (with the headline
    data where it needs them), for runs that iterate on that phase; the
    full run stays the proof run."""
    import torch
    needs_data = {"main": lambda d, data: main_path_phase(d, data, False),
                  "planes path": planes_path_phase,
                  "boosting modes": modes_phase,
                  "data_parallel": data_parallel_phase,
                  "multiprocess": multiprocess_phase,
                  "telemetry": telemetry_phase}
    alone = {"kernel": kernel_phase, "planes kernel": planes_kernel_phase,
             "flash kernel": flash_kernel_phase,
             "flash backward kernel": flash_bwd_kernel_phase,
             "stats kernel": stats_kernel_phase,
             "stats backward": stats_bwd_kernel_phase,
             "ranker": ranker_phase, "stream train": stream_train_phase,
             "pipe training": lambda d: pipe_train_phase(
                 d, lm_train_phase(d, False)),
             "multiprocess_lm": multiprocess_lm_phase, "dnn": dnn_phase,
             "serving": serving_phase, "fleet": fleet_phase,
             "online": online_phase,
             "automl": lambda d: automl_phase(d, profile),
             "cyber": cyber_phase, "images": images_phase}
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
                          t_start, profile)
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
    # the first profiler captures of the process: before any phase's own
    # torch.profiler tables
    tele = phase("telemetry", telemetry_phase, dev, data)
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
    torch.cuda.empty_cache()
    dnn = phase("dnn", dnn_phase, dev)
    torch.cuda.empty_cache()
    serve = phase("serving", serving_phase, dev)
    torch.cuda.empty_cache()
    fleet = phase("fleet", fleet_phase, dev)
    torch.cuda.empty_cache()
    online = phase("online", online_phase, dev)
    torch.cuda.empty_cache()
    automl = phase("automl", automl_phase, dev, profile)
    torch.cuda.empty_cache()
    cyber = phase("cyber", cyber_phase, dev)
    torch.cuda.empty_cache()
    images = phase("images", images_phase, dev)
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
                     "launches"]["hist_tiled"],
                 "serving model fit (20k x 16, 20 iterations)": serve[
                     "fit"]["launches"].get("hist_tiled", 0),
                 "TrainClassifier GBDT fit (800k x 108, 100 iterations)":
                     automl["gbdt"]["launches"]["hist_tiled"]},
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
    for kname, row in images["kernels"].items():
        kernels.append(dict(
            row, launches=images["path"]["launches"][kname],
            path=f"read_images(size={IMAGES_SIZE}) of {IMAGES_FOLDER} "
                 f"500x375 files into the ResNet-50 bf16 ImageFeaturizer",
            launches_per_path={
                "files -> features": images["path"]["launches"][kname],
                "read_image_dir": images["read_image_dir"]["launches"][
                    kname]},
            passed=True, shape=images["kernel_shape"]))
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
    log(f"[dnn] ResNet-50 features "
        f"{dnn['resnet50_bfloat16']['images_per_s']:.1f} images/s bf16, "
        f"{dnn['resnet50_float32']['images_per_s']:.1f} f32; ONNX ResNet-18 "
        f"{dnn['onnx_resnet18']['images_per_s']:.1f} images/s; transfer fit "
        f"head {dnn['transfer_head']['fit_s']:.2f} s, full "
        f"{dnn['transfer_full']['fit_s']:.2f} s; the phase {dnn['s']:.1f} s")
    log(f"[serving] GBDT {serve['microbatch']['req_per_s']:.1f} req/s "
        f"microbatch, {serve['continuous']['req_per_s']:.1f} continuous, "
        f"serial p50 {serve['serial']['p50_ms']:.3f} ms; encoder "
        f"{serve['encoder']['req_per_s']:.1f} req/s; the phase "
        f"{serve['s']:.1f} s")
    log(f"[fleet] isolation forest fit {fleet['iforest']['fit_s']:.3f} s, "
        f"{fleet['iforest']['rows_per_s']:.4g} rows/s; SAR fit "
        f"{fleet['sar']['fit_s']:.3f} s (implicit log "
        f"{fleet['sar']['implicit']['fit_s']:.3f} s), "
        f"{fleet['sar']['users_per_s']:.4g} users/s; KNN {fleet['knn']['queries_per_s']:.4g} queries/s, "
        f"conditional {fleet['conditional']['queries_per_s']:.4g}; two "
        f"ranks {fleet['distributed']['req_per_s']:.1f} req/s, p50 "
        f"{fleet['distributed']['p50_ms']:.3f} ms, p99 "
        f"{fleet['distributed']['p99_ms']:.3f} ms; the phase "
        f"{fleet['s']:.1f} s")
    log(f"[online] VW adaptive fit {online['adaptive']['fit_s']:.3f} s "
        f"({online['adaptive']['rows_per_s']:.4g} rows/s, AUC "
        f"{online['adaptive']['auc']:.6f}), 4 positions "
        f"{online['adaptive_4_positions']['fit_s']:.3f} s, sgd+l1 "
        f"{online['sgd_l1_regressor']['fit_s']:.3f} s, BFGS "
        f"{online['bfgs']['fit_s']:.3f} s; serving "
        f"{online['sparse_kernel']['req_per_s']:.1f} req/s sparse kernel "
        f"against {online['table']['req_per_s']:.1f} table; "
        f"{max(online['updates_per_s']):.4g} online examples/s; adapted in "
        f"{online['adapt']['s']:.3f} s; the phase {online['s']:.1f} s")
    tune = automl["tune"]
    log(f"[automl] TrainClassifier LR fit {automl['lr']['fit_s']:.3f} s "
        f"(AUC {automl['lr']['AUC']:.6f}), GBDT {automl['gbdt']['fit_s']:.3f} "
        f"s (AUC {automl['gbdt']['AUC']:.6f}, "
        f"{automl['gbdt']['launches']['hist_tiled']} hist_tiled; its "
        f"plain-histogram twin {automl['gbdt_plain']['AUC']:.6f}); tuning "
        f"{tune['s']:.3f} s on {AUTOML_TUNE_ROWS} rows; on "
        f"{AUTOML_PAR_ROWS} rows {tune['s_par1']:.3f} s at parallelism 1, "
        f"{tune['s_par4']:.3f} s at 4; sparse LR {automl['text']['fit_s']:.3f} s; TabularLIME "
        f"{automl['lime'][0.0]['s']:.3f} / "
        f"{automl['lime'][AUTOML_LIME['lam']]['s']:.3f} s; ImageLIME "
        f"{automl['image']['s']:.3f} s; the phase {automl['s']:.1f} s")
    log(f"[cyber] AccessAnomaly pipeline fit "
        f"{', '.join(f'{v:.3f}' for v in cyber['fit_s'])} s (ALS "
        f"{cyber['split'][-1]['als']:.3f} s, the card busy "
        f"{cyber['als_profile']['share']:.3f} of it), peak "
        f"{cyber['peak'] / 2**30:.2f} GiB, two fits bit-identical; scoring "
        f"{cyber['score_rows_per_s']:.4g} rows/s, AUC {cyber['auc']:.6f}; "
        f"stream {cyber['stream']['rows_per_s']:.4g} rows/s; HTTP "
        f"{cyber['http']['req_per_s']:.1f} req/s; the phase "
        f"{cyber['s']:.1f} s")
    ip = images["path"]
    log(f"[images] files -> features {ip['images_per_s']:.2f} images/s "
        f"(decode {ip['decode_s']:.3f} s, featurize {ip['featurize_s']:.3f} "
        f"s for {ip['files']} files); read_image_dir "
        f"{images['read_image_dir']['images_per_s']:.2f} images/s; "
        f"{images['fixtures']} fixtures equal PIL's; the phase "
        f"{images['s']:.1f} s")
    tg = tele["gbdt"]
    log(f"[telemetry] headline iteration by region: " + ", ".join(
        f"{r} {v / 1e3:.3f} ms" for r, v in tg["us"].items())
        + f", none {100 * tg['other_share']:.1f}% of "
        f"{tg['total_us'] / 1e3:.3f} ms; LM step train.step "
        f"{tele['lm']['step_us'] / 1e3:.2f} ms of device time in "
        f"{tele['lm']['wall_s'] * 1e3:.1f} ms; CUPTI start "
        f"{tele['cupti_start_s']:.2f} s; the phase {tele['s']:.1f} s")
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
