"""PyTorch/CUDA port of `mmlspark_tpu` for one NVIDIA H100.

The JAX package beside this one is the reference; this package keeps its
layout and names so each module's counterpart is easy to find, and imports
neither `jax` nor anything of `mmlspark_tpu`. Ported so far:

- GBDT fit -> predict (binning, the histogram kernels, split search, row
  routing, the boosting loop with its stochastic modes, lambdarank and
  native categorical splits, `Booster` scoring and the GBDT estimators);
- the pipeline core (`core`: `Table`, `Params`, `Pipeline`, save/load);
- checkpoint/resume (`utils.checkpoint`, `reliability`): GBDT fits that
  resume bit for bit on fixed-order histogram kernels, the LM trainers'
  checkpoints in the reference's format;
- GBDT introspection (leaf indices, exact TreeSHAP, importances, native
  model files) and data-/voting-parallel fits over a mesh's data axis;
- transformer encoder serving and causal LM training (`models.dnn`, with
  the flash-attention kernels), over a mesh (`parallel`) of data, pipe,
  model and seq axes in one process, with ring and Ulysses attention;
- the data plane (`data`): chunked parallel ingest, out-of-core staging
  with a durable cursor, the device prefetcher, and the supervised
  `ShardedLMTrainer.run_stream` (`reliability.TrainingSupervisor`,
  `telemetry.goodput.StepClock`);
- GBDT over several processes (`parallel.cluster` on `torch.distributed`,
  a data axis that spans processes), with heartbeats, leases, straggler
  detection and elastic shrink (`reliability.elastic`), and the fit-time
  quality profile (`telemetry.quality`);
- LM training over several processes, and the deep-net image path
  (`models.dnn`: `DNNModel`, ResNets, ONNX import, transfer learning;
  `image`);
- HTTP model serving (`io`: `serve_pipeline`, the plan cache, epoch
  replay, hot-swap) with the serving half of `telemetry` (spans, windowed
  metrics, Prometheus exposition, model versions, the quality tap), the
  service registry and the fleet workloads (isolation forest, SAR, KNN);
- Vowpal Wabbit (`models.vw`) and continuous learning on the serving
  stream (`online`), with the control plane that closes its loop
  (`control`: rollout, admission, routing, scaling; `telemetry.slo`,
  `telemetry.watch`);
- AutoML and explanation: the linear learners (`models.linear`), the
  featurizers (`featurize`), `train` (TrainClassifier, TrainRegressor,
  model statistics), `automl` (TuneHyperparameters, FindBestModel) and
  LIME (`lime`, with its batched lasso on the card).

Entry points run on the card unless the caller passes `device="cpu"`; with
no card they raise (see `device.resolve_device`).
"""
__version__ = "0.1.0"

from .core import (Estimator, Model, Param, Params, Pipeline, PipelineModel,
                   Table, Transformer)
from .device import resolve_device

__all__ = ["Table", "Pipeline", "PipelineModel", "Estimator", "Transformer",
           "Model", "Params", "Param", "__version__", "resolve_device"]
