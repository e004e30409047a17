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
