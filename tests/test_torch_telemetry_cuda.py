"""Device telemetry on the card: the profile session's per-region kernel
time, the roofline rows, the debug endpoints and the flight recorder of a
served model, at small shapes.

Every test here carries the `gpu` marker and skips without a card. This
file imports neither jax nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_telemetry_cuda.py

The checks are exact counts: the `hist_tile_kernel` events a capture
attributes to `gbdt.hist` equal the launches the histogram wrapper
counted, the flash kernels in `train.step` equal the trainer's launch
counts, the three GBDT regions' device time sums to no more than the
device-busy union (up to the parse's rounding of 1e-3 us per op row),
one SLO burn dumps exactly one bundle. An annotated tree grows under
`torch.cuda.set_sync_debug_mode("error")`: the regions add no host
synchronisation.
"""
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.telemetry import names, perf, profiler, slo

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_ROUND_US = 5e-4
_GBDT = dict(n=200_000, f=8, max_bin=63, depth=4)
_LM = dict(vocab_size=512, d_model=256, n_heads=2, n_layers=2, d_ff=512,
           max_len=512)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _gbdt_data(dev):
    from mmlspark_tpu_torch.ops import binning
    rng = np.random.default_rng(0)
    x = rng.normal(size=(_GBDT["n"], _GBDT["f"])).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float32)
    mapper = binning.fit_bins(x, max_bin=_GBDT["max_bin"], seed=0)
    d_bins = binning.apply_bins_device(mapper, x, device=dev)
    return x, y, (mapper, d_bins, torch.as_tensor(y).to(dev))


def _kernels(ops, token, region=None):
    return sum(r["occurrences"] for r in ops if token in r["op"]
               and (region is None or r["region"] == region))


@pytest.mark.gpu
def test_gbdt_iteration_kernel_time_by_region(cuda_device, tmp_path):
    from mmlspark_tpu_torch.models.gbdt import BoostParams, fit_booster
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    x, y, staged = _gbdt_data(cuda_device)
    params = BoostParams(objective="binary", num_iterations=1,
                         max_depth=_GBDT["depth"], num_leaves=15,
                         max_bin=_GBDT["max_bin"])
    fit_booster(x, y, params, prebinned=staged, device=cuda_device)
    torch.cuda.synchronize()
    ledger = profiler.RooflineLedger()
    s = profiler.ProfileSession(profile_dir=str(tmp_path), ledger=ledger)
    err = []

    def fit():
        try:
            fit_booster(x, y, params, prebinned=staged, device=cuda_device)
            torch.cuda.synchronize()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            err.append(e)

    hc.reset_launches()
    with s.session(reason="iteration") as info:
        th = threading.Thread(target=fit)   # a thread the profiler
        th.start()                          # does not follow
        th.join()
    assert not err, err
    ops, dev_sum = info["ops"], info["device"]
    assert dev_sum["device_events"] > 0
    assert hc.launches["hist_tiled"] == _GBDT["depth"]
    assert _kernels(ops, "hist_tile_kernel", "gbdt.hist") == \
        _kernels(ops, "hist_tile_kernel") == _GBDT["depth"]
    us = [info["regions"][r]["self_time_us"]
          for r in ("gbdt.hist", "gbdt.split", "gbdt.route")]
    assert min(us) > 0
    assert sum(us) <= dev_sum["busy_us"] + _ROUND_US * len(ops)
    for r in ("gbdt.hist", "gbdt.split", "gbdt.route"):
        ledger.set_cost(r, bytes_accessed=1e6)
    rows = ledger.rows()
    for r in ("gbdt.hist", "gbdt.split", "gbdt.route"):
        assert rows[r]["source"] == "device"
        assert rows[r]["hbm_util"] > 0
    assert profiler.resolve_peaks()["source"].startswith("chip-table:")


@pytest.mark.gpu
def test_annotated_tree_adds_no_host_sync(cuda_device):
    from mmlspark_tpu_torch.models.gbdt import trainer
    _, _, (_, d_bins, d_y) = _gbdt_data(cuda_device)
    grad = torch.sigmoid(torch.zeros_like(d_y)) - d_y
    hess = torch.full_like(d_y, 0.25)
    fmask = torch.ones(_GBDT["f"], dtype=torch.bool, device=cuda_device)
    cfg = trainer.TreeConfig(n_features=_GBDT["f"], n_bins=_GBDT["max_bin"]
                             + 1, max_depth=_GBDT["depth"], num_leaves=15)
    trainer.train_one_tree(d_bins, grad, hess, fmask, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tree, delta = trainer.train_one_tree(d_bins, grad, hess, fmask, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(delta).all())


@pytest.mark.gpu
def test_lm_step_flash_launches_in_train_step(cuda_device, tmp_path):
    from mmlspark_tpu_torch.models.dnn import PipelinedLMTrainer
    from mmlspark_tpu_torch.ops import flash_attention as fa
    from mmlspark_tpu_torch.reliability import TrainingSupervisor
    trainer = PipelinedLMTrainer(
        n_microbatches=1, attention="flash", optimizer="adam", seed=0,
        compute_dtype="bfloat16", remat="save_attn", device=cuda_device,
        **_LM)
    toks = np.random.default_rng(0).integers(
        0, _LM["vocab_size"], size=(1, _LM["max_len"])).astype(np.int32)
    trainer.step(toks)
    torch.cuda.synchronize()
    sup = TrainingSupervisor(str(tmp_path / "ck"), lambda: {},
                             lambda payload: None, checkpoint_every=0,
                             handle_signals=False)
    s = profiler.ProfileSession(profile_dir=str(tmp_path / "p"),
                                ledger=profiler.RooflineLedger())
    fa.reset_launches()
    with s.session(reason="lm-step") as info:
        sup.run(lambda step: trainer.step(toks), 1, resume=False)
        torch.cuda.synchronize()
    sup.close()
    want = {"flash_fwd": _LM["n_layers"], "flash_bwd_dq": _LM["n_layers"],
            "flash_bwd_dkv": _LM["n_layers"]}
    assert {k: v for k, v in fa.launches.items() if v} == want
    ops = info["ops"]
    assert {k: _kernels(ops, tok, "train.step") for k, tok in (
        ("flash_fwd", "flash_fwd_"), ("flash_bwd_dq", "flash_bwd_dq"),
        ("flash_bwd_dkv", "flash_bwd_dkv"))} == want
    assert info["regions"]["train.step"]["self_time_us"] > 0


def _get(address, path):
    try:
        with urllib.request.urlopen(address + path, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture
def process_defaults(tmp_path):
    rec = perf.configure_flight_recorder(bundle_dir=str(tmp_path / "b"),
                                         min_interval_s=60.0)
    sess = profiler.configure_profile_session(
        profile_dir=str(tmp_path / "p"), min_interval_s=60.0)
    rec._last_dump = sess._last = None
    rec._burn_state.clear()
    yield rec, sess
    rec.configure(bundle_dir="", min_interval_s=60.0)
    sess.configure(profile_dir="")
    rec._last_dump = sess._last = None
    rec._burn_state.clear()


@pytest.mark.gpu
def test_debug_profile_under_load_sees_plan_run(cuda_device,
                                                process_defaults):
    from mmlspark_tpu_torch.io.plan import compile_serving_transform
    from mmlspark_tpu_torch.io.serving import ServingQuery, ServingServer
    from mmlspark_tpu_torch.models.dnn import model as dnn_model
    from mmlspark_tpu_torch.models.dnn import resnet as rn
    net = rn.resnet18(num_classes=10)
    state = rn.resnet_params_from_numpy(rn.init_resnet(net, seed=1),
                                        cuda_device)
    m = dnn_model.DNNModel(apply_fn=net, params=state, batch_size=4)
    img = np.random.default_rng(6).random((3, 32, 32)).astype(np.float32)
    body = json.dumps({"features": img.tolist()}).encode()
    server = ServingServer(num_partitions=2, transport="threading").start()
    q = ServingQuery(server, compile_serving_transform(
        m, ["features"], output_col="scores"), mode="continuous").start()
    # the first batch of a bucket builds its plan (the first forward):
    # served before the capture, so the capture sees steady serving
    for _ in range(4):
        req = urllib.request.Request(server.address, data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
    stop = threading.Event()

    def client():
        while not stop.is_set():
            req = urllib.request.Request(server.address, data=body,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                r.read()

    try:
        client_threads = [threading.Thread(target=client, daemon=True)
                          for _ in range(3)]
        for th in client_threads:
            th.start()
        time.sleep(0.5)
        status, prof = _get(server.address, "/debug/profile?ms=200")
        again, _ = _get(server.address, "/debug/profile?ms=5")
    finally:
        stop.set()
        for th in client_threads:
            th.join(timeout=60)
        q.stop()
        server.stop()
    assert (status, again) == (200, 429)
    assert prof["device"]["device_events"] > 0
    run = prof["regions"]["serving.plan.run"]
    assert run["self_time_us"] > 0 and run["occurrences"] > 0


@pytest.mark.gpu
def test_bundle_endpoint_burn_and_gauges(cuda_device, process_defaults):
    from mmlspark_tpu_torch.io import serve_pipeline
    from mmlspark_tpu_torch.models.gbdt.estimators import GBDTClassifier
    rec, _ = process_defaults
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2000, 8)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    model = GBDTClassifier(num_iterations=3, max_depth=3,
                           device=str(cuda_device)).fit(
        Table({"features": x, "label": y}))
    server, q = serve_pipeline(model, ["features"], mode="continuous")
    try:
        for row in x[:8]:
            req = urllib.request.Request(
                server.address, data=json.dumps(
                    {"features": row.tolist()}).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 200
        first, manifest = _get(server.address, "/debug/bundle")
        second, _ = _get(server.address, "/debug/bundle")
        rec.configure(min_interval_s=0.0)
        engine = slo.SLOEngine(objectives=[slo.Objective(
            name="burn", kind=slo.LATENCY, metric=names.SERVING_REQUEST_E2E,
            threshold_ms=1e-3, quantile=50.0)])
        before = len(os.listdir(rec.bundle_dir))
        assert engine.verdict()["burning"]
        burned = len(os.listdir(rec.bundle_dir))
        assert engine.verdict()["burning"]
        stayed = len(os.listdir(rec.bundle_dir))
        status, state = _get(server.address, "/metrics.json")
    finally:
        q.stop()
        server.stop()
    assert (first, second) == (200, 429)
    assert (burned - before, stayed - burned) == (1, 0)
    assert sorted(os.listdir(manifest["path"])) == sorted(manifest["files"])
    assert "roofline.json" in manifest["files"]
    gauges = state["gauges"]
    assert status == 200
    assert gauges[names.DEVICE_MEM_BYTES_IN_USE] > 0
    assert gauges[names.device_mem_peak(torch.cuda.current_device())] > 0
    assert perf.sample_resource_stats()["devices"][0]["stats"][
        "bytes_limit"] > 0
