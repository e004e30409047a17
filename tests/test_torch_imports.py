"""The port stands alone: importing `mmlspark_tpu_torch` loads neither jax
nor any module of the JAX package, and no source file of the port (or
chip_smoke.py) imports them."""
import ast
import os
import subprocess
import sys

import pytest
import torch

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_no_jax():
    code = ("import sys\n"
            "import mmlspark_tpu_torch\n"
            "import mmlspark_tpu_torch.models.gbdt\n"
            "import mmlspark_tpu_torch.models.gbdt.convert\n"
            "import mmlspark_tpu_torch.core.serialize\n"
            "import mmlspark_tpu_torch.core.model_equality\n"
            "import mmlspark_tpu_torch.ops.histogram_cuda\n"
            "import mmlspark_tpu_torch.models.dnn.transformer\n"
            "import mmlspark_tpu_torch.ops.flash_attention\n"
            "import mmlspark_tpu_torch.models.dnn.pp_training\n"
            "import mmlspark_tpu_torch.models.dnn.lm_training\n"
            "import mmlspark_tpu_torch.parallel.mesh\n"
            "import mmlspark_tpu_torch.parallel.ring_attention\n"
            "import mmlspark_tpu_torch.models.dnn.payload\n"
            "import mmlspark_tpu_torch.reliability\n"
            "import mmlspark_tpu_torch.utils.checkpoint\n"
            "import mmlspark_tpu_torch.data\n"
            "import mmlspark_tpu_torch.telemetry\n"
            "import mmlspark_tpu_torch.utils.async_utils\n"
            "import mmlspark_tpu_torch.utils.tracing\n"
            "import mmlspark_tpu_torch.parallel.cluster\n"
            "import mmlspark_tpu_torch.reliability.elastic\n"
            "import mmlspark_tpu_torch.telemetry.quality\n"
            "import mmlspark_tpu_torch.image\n"
            "import mmlspark_tpu_torch.downloader\n"
            "import mmlspark_tpu_torch.models.dnn.model\n"
            "import mmlspark_tpu_torch.models.dnn.resnet\n"
            "import mmlspark_tpu_torch.models.dnn.onnx_import\n"
            "import mmlspark_tpu_torch.models.dnn.image_featurizer\n"
            "import mmlspark_tpu_torch.models.dnn.transfer\n"
            "import mmlspark_tpu_torch.io\n"
            "import mmlspark_tpu_torch.io.serving\n"
            "import mmlspark_tpu_torch.io.plan\n"
            "import mmlspark_tpu_torch.io.loadgen\n"
            "import mmlspark_tpu_torch.stages.batching\n"
            "import mmlspark_tpu_torch.train.metrics\n"
            "import mmlspark_tpu_torch.utils.stats\n"
            "import mmlspark_tpu_torch.telemetry.names\n"
            "import mmlspark_tpu_torch.telemetry.spans\n"
            "import mmlspark_tpu_torch.telemetry.window\n"
            "import mmlspark_tpu_torch.telemetry.exposition\n"
            "import mmlspark_tpu_torch.telemetry.lineage\n"
            "import mmlspark_tpu_torch.telemetry.perf\n"
            "import mmlspark_tpu_torch.io.registry\n"
            "import mmlspark_tpu_torch.models.isolation_forest\n"
            "import mmlspark_tpu_torch.recommendation\n"
            "import mmlspark_tpu_torch.nn\n"
            "import mmlspark_tpu_torch.workloads\n"
            "import mmlspark_tpu_torch.ops.topk\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'mmlspark_tpu.')) "
            "or m == 'mmlspark_tpu')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_sources_import_no_jax_or_reference():
    files = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(_REPO, "mmlspark_tpu_torch")):
        files += [os.path.join(root, n) for n in sorted(names)
                  if n.endswith(".py")]
    assert len(files) > 10
    for path in sorted(files):
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "mmlspark_tpu"), \
                f"{os.path.relpath(path, _REPO)} imports {mod}"


@pytest.mark.parametrize("module, names", [
    ("", ["Table", "Pipeline", "PipelineModel", "Estimator", "Transformer",
          "Model", "Params", "Param", "__version__"]),
    ("models.gbdt", ["LightGBMClassifier", "LightGBMClassificationModel",
                     "LightGBMRegressor", "LightGBMRegressionModel",
                     "LightGBMRanker", "LightGBMRankerModel", "Tree",
                     "TreeConfig", "train_one_tree"]),
    ("parallel", ["device_count", "initialize_cluster", "ClusterInfo",
                  "Heartbeat", "barrier", "broadcast_from_leader",
                  "global_array", "padded_process_rows",
                  "process_row_range", "cluster"]),
    ("reliability", ["Attempt", "ElasticPlan", "FleetCheckpoint",
                     "HostLeases", "leader"]),
    ("models.dnn", ["DNNModel", "ResNet", "resnet18", "resnet50",
                    "ImageFeaturizer", "TransformerSentenceEncoder",
                    "init_transformer", "transformer_apply",
                    "ShardedLMTrainer", "DeepTransferClassifier",
                    "DeepTransferModel", "load_onnx"]),
    ("image", ["ImageSetAugmenter", "ImageTransformer",
               "ResizeImageTransformer", "UnrollImage"]),
    ("io", ["Reply", "ServingServer", "ServingQuery", "serve_pipeline",
            "ServingTransform", "compile_serving_transform",
            "RegistryClient", "ServiceInfo", "ServiceRegistry",
            "list_services", "report_server_to_registry",
            "start_distributed_serving"]),
    ("recommendation", ["SAR", "SARModel", "RankingAdapter",
                        "RankingAdapterModel", "RankingEvaluator",
                        "RankingTrainValidationSplit",
                        "RankingTrainValidationSplitModel",
                        "RecommendationIndexer",
                        "RecommendationIndexerModel", "ranking_metrics"]),
    ("nn", ["KNN", "KNNModel", "ConditionalKNN", "ConditionalKNNModel"]),
    ("workloads", ["attach_workload_observability", "IsolationForestScorer",
                   "IsolationForestScorerModel", "SARServing",
                   "SARServingModel"]),
    ("stages", ["FixedMiniBatchTransformer", "DynamicMiniBatchTransformer",
                "TimeIntervalMiniBatchTransformer", "FlattenBatch"]),
    ("telemetry", ["Tracer", "Span", "SpanContext", "get_tracer",
                   "configure", "head_sampled", "parse_trace_header",
                   "read_jsonl", "wall_now", "TRACE_HEADER",
                   "render_prometheus", "metrics_http_response",
                   "merge_states", "state_snapshot", "WindowedHistogram",
                   "WindowedCounter", "ModelVersion", "RunLedger",
                   "model_version", "configure_run_ledger",
                   "get_version_registry", "export_versions",
                   "QualityMonitor", "StreamingEvaluator", "get_monitor",
                   "record_label", "export_quality", "CompileLog",
                   "record_plan_compile", "compile_stats", "StepClock",
                   "scrape_cluster", "ClusterSnapshot",
                   "merge_version_exports", "rollout_skew"]),
])
def test_reference_exports_are_the_port_s(module, names):
    """ROADMAP Queue 3 (v): the names the reference's packages export
    import from the port's, and each is in its `__all__`."""
    import importlib
    port = importlib.import_module(
        "mmlspark_tpu_torch" + ("." + module if module else ""))
    ref = importlib.import_module(
        "mmlspark_tpu" + ("." + module if module else ""))
    for name in names:
        assert hasattr(ref, name), name
        assert hasattr(port, name), name
        assert name in port.__all__, name
    if not module:
        assert port.__version__ == ref.__version__


@pytest.mark.parametrize("module, names", [
    ("io", ["ServingServer", "ServingQuery", "serve_pipeline", "Reply",
            "ServingTransform", "compile_serving_transform"]),
    ("io.registry", ["ServiceInfo", "ServiceRegistry", "RegistryClient",
                     "report_server_to_registry", "list_services",
                     "start_distributed_serving", "_advertised_host"]),
    ("models.isolation_forest", ["IsolationForest", "IsolationForestModel",
                                 "_avg_path_length", "_score_forest"]),
    ("recommendation.sar", ["SAR", "SARModel"]),
    ("recommendation.ranking", ["ranking_metrics", "RankingEvaluator",
                                "RecommendationIndexer",
                                "RecommendationIndexerModel",
                                "RankingAdapter", "RankingAdapterModel",
                                "RankingTrainValidationSplit",
                                "RankingTrainValidationSplitModel"]),
    ("nn.knn", ["KNN", "KNNModel", "ConditionalKNN", "ConditionalKNNModel",
                "_QUERY_TILE", "_top_k_inner_products"]),
    ("workloads.base", ["attach_workload_observability"]),
    ("workloads.iforest", ["IsolationForestScorer",
                           "IsolationForestScorerModel", "_grow_tree",
                           "_gather_subsamples"]),
    ("workloads.sar_serving", ["SARServing", "SARServingModel", "_NEG"]),
    ("io.serving", ["Reply", "CachedRequest", "ServingServer",
                    "ServingQuery", "serve_pipeline", "drain_on_signal",
                    "EXPOSITION_PATHS", "MAX_BODY_BYTES"]),
    ("io.plan", ["pipeline_fingerprint", "ServingTransform",
                 "compile_serving_transform"]),
    ("io.loadgen", ["LoadResult", "run_load"]),
    ("stages.batching", ["shape_bucket", "pad_rows_to_bucket",
                         "FixedMiniBatchTransformer", "FlattenBatch"]),
    ("train.metrics", ["ConfusionState", "RegressionState",
                       "binary_metrics", "multiclass_metrics",
                       "regression_metrics", "auc", "pr_auc",
                       "ndcg_at_k"]),
    ("utils.stats", ["merge_moments"]),
    ("utils.tracing", ["trace", "annotate", "wall_clock"]),
    ("telemetry.spans", ["Tracer", "get_tracer", "configure", "TRACE_HEADER",
                         "head_sampled", "parse_trace_header", "wall_now",
                         "read_jsonl"]),
    ("telemetry.window", ["WindowedHistogram", "WindowedCounter",
                          "set_clock"]),
    ("telemetry.quality", ["StreamingEvaluator", "QualityMonitor",
                           "get_monitor", "reset_monitor",
                           "configure_quality", "observe_serving",
                           "record_label", "export_quality",
                           "refresh_quality_gauges",
                           "quality_http_response",
                           "merge_quality_exports"]),
    ("telemetry.lineage", ["ModelVersion", "model_version", "RunLedger",
                           "configure_run_ledger", "VersionRegistry",
                           "export_versions", "refresh_canary_gauges",
                           "versions_http_response",
                           "merge_version_exports", "rollout_skew"]),
    ("telemetry.perf", ["CompileLog", "record_plan_compile",
                        "compile_stats"]),
    ("telemetry.exposition", ["prom_name", "render_prometheus",
                              "metrics_http_response", "merge_states",
                              "state_snapshot", "scrape_cluster",
                              "ClusterSnapshot"]),
    ("reliability.metrics", ["histogram_bounds_ms", "MetricsRegistry",
                             "Histogram"]),
])
def test_serving_slice_names_are_the_reference_s(module, names):
    """Each name of the serving slice exists in both packages' module of
    that path."""
    import importlib
    port = importlib.import_module("mmlspark_tpu_torch." + module)
    ref = importlib.import_module("mmlspark_tpu." + module)
    for name in names:
        assert hasattr(ref, name), name
        assert hasattr(port, name), name


@pytest.mark.parametrize("module, name, item", [
    ("io", "HTTPTransformer", "27"), ("io", "FileStreamSource", "27"),
    ("io", "SharedVariable", "27"),
    ("io.plan", "serving_plan_contract", "24"),
    ("workloads.iforest", "iforest_score_contract", "24"),
    ("workloads.sar_serving", "sar_score_sharded_contract", "24"),
    ("telemetry", "SLOEngine", "27"), ("telemetry", "TelemetryPoller", "27"),
    ("telemetry", "FlightRecorder", "23"), ("telemetry", "AotCache", "23"),
    ("telemetry", "ProfileSession", "23"),
    ("telemetry.perf", "FlightRecorder", "23"),
    ("telemetry.perf", "executable_analysis", "23"),
    ("telemetry.exposition", "ExpositionServer", "27"),
])
def test_left_out_names_raise_naming_their_item(module, name, item):
    import importlib
    mod = importlib.import_module("mmlspark_tpu_torch." + module)
    with pytest.raises(NotImplementedError) as err:
        getattr(mod, name)
    assert f"item {item}" in str(err.value)


@pytest.mark.parametrize("module, item", [
    ("http", "27"), ("powerbi", "27"), ("streaming", "27"), ("sources", "27"),
    ("shared", "27")])
def test_left_out_io_modules_raise_naming_their_item(module, item):
    import importlib
    import sys
    name = "mmlspark_tpu_torch.io." + module
    sys.modules.pop(name, None)
    with pytest.raises(NotImplementedError) as err:
        importlib.import_module(name)
    assert f"item {item}" in str(err.value)
