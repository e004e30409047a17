"""Serving on the card: the port's `serve_pipeline` with models on CUDA,
and `device.exact_f32` under two threads.

Every test here carries the `gpu` marker and skips without a card. This
file imports neither jax nor the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_serving_cuda.py

Tolerances: a ResNet-18 f32 forward from two threads at once within 1e-6
(relative to the largest |output|) of the single-threaded output, with
PyTorch's cuDNN TF32 flag ON, so a TF32 convolution (~4e-4) fails it; a
GBDT fit on the card and served from its host plan: labels equal to the
card's `transform`, probabilities within 1e-6; the encoder served on the
card within 1e-5 of the same documents' CPU transform.
"""
import http.client
import json
import threading

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.io import plan, serving
from mmlspark_tpu_torch.models.dnn import resnet as rn
from mmlspark_tpu_torch.models.dnn.model import DNNModel
from mmlspark_tpu_torch.models.dnn.transformer import (
    TransformerSentenceEncoder, init_transformer)
from mmlspark_tpu_torch.models.gbdt.estimators import GBDTClassifier

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_THREAD_TOL = 1e-6
_PROBA_TOL = 1e-6
_EMB_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def tf32_on():
    """PyTorch's default: cuDNN may run f32 convolutions in TF32."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32 = before


@pytest.fixture
def running():
    """Collects (server, query) pairs and stops every one afterwards."""
    started = []
    yield started.append
    for server, q in reversed(started):
        q.stop()
        server.stop(drain=False)


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _post_all(address, bodies, timeout=10):
    host, port = address[len("http://"):].rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    out = []
    try:
        for b in bodies:
            conn.request("POST", "/", body=b)
            resp = conn.getresponse()
            out.append((resp.status, resp.read()))
    finally:
        conn.close()
    return out


def _serve(model, cols, output_col, transport, **kw):
    server = serving.ServingServer(transport=transport,
                                   num_partitions=kw.pop("num_partitions",
                                                         1)).start()
    q = serving.ServingQuery(
        server, plan.compile_serving_transform(model, cols, output_col),
        **kw).start()
    return server, q


@pytest.mark.gpu
def test_resnet18_f32_two_threads_match_one(cuda_device, tf32_on):
    net = rn.resnet18(num_classes=10)
    state = rn.resnet_params_from_numpy(rn.init_resnet(net, seed=1),
                                        cuda_device)
    model = DNNModel(apply_fn=net, params=state, batch_size=4)
    x = np.random.default_rng(2).random((8, 3, 64, 64)).astype(np.float32)
    want = model.transform(Table({"features": x}))["scores"]
    outs, start = [], threading.Barrier(2)

    def score():
        start.wait(10)
        for _ in range(6):
            outs.append(model.transform(Table({"features": x}))["scores"])

    threads = [threading.Thread(target=score, daemon=True)
               for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert len(outs) == 12
    assert max(_rel_err(o, want) for o in outs) <= _THREAD_TOL
    assert torch.backends.cudnn.allow_tf32 is True


@pytest.mark.gpu
@pytest.mark.parametrize("transport", ["selector", "threading"])
def test_gbdt_fit_on_the_card_served_equals_transform(cuda_device, running,
                                                      transport):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(20_000, 16)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float32)
    model = GBDTClassifier(num_iterations=10, max_depth=5).fit(
        Table({"features": x, "label": y}))
    rows = np.random.default_rng(1).normal(size=(128, 16)).astype(
        np.float32)
    offline = model.transform(Table({"features": rows}))
    bodies = [json.dumps({"features": r.tolist()}).encode() for r in rows]
    for col in ("prediction", "probabilities"):
        server, q = _serve(model, ["features"], col, transport,
                           max_batch=64)
        running((server, q))
        got = _post_all(server.address, bodies)
        assert [s for s, _ in got] == [200] * len(rows)
        served = np.asarray([json.loads(p)[col] for _, p in got])
        want = np.asarray(offline[col], np.float64).reshape(served.shape)
        if col == "prediction":
            np.testing.assert_array_equal(served, want)
        else:
            np.testing.assert_allclose(served, want, rtol=0,
                                       atol=_PROBA_TOL)


@pytest.mark.gpu
def test_encoder_served_on_the_card_equals_cpu_transform(cuda_device,
                                                         running):
    kw = dict(input_col="text", output_col="emb", d_model=64, n_heads=4,
              n_layers=2, d_ff=128, max_len=128)
    tree = init_transformer(1 << 14, 64, 4, 2, 128, 128, 3)
    card = TransformerSentenceEncoder(**kw).set_params_tree(tree)
    cpu = TransformerSentenceEncoder(**kw, device="cpu").set_params_tree(
        tree)
    rng = np.random.default_rng(4)
    words = [f"w{i}" for i in range(500)]
    docs = [" ".join(rng.choice(words, size=int(rng.integers(4, 100))))
            for _ in range(24)]
    want = cpu.transform(Table({"text": np.array(docs)}))["emb"]
    server, q = _serve(card, ["text"], "emb", "selector", max_batch=8,
                       num_partitions=2)
    running((server, q))
    got = _post_all(server.address,
                    [json.dumps({"text": d}).encode() for d in docs])
    assert [s for s, _ in got] == [200] * len(docs)
    emb = np.asarray([json.loads(p)["emb"] for _, p in got])
    np.testing.assert_allclose(emb, want, rtol=0, atol=_EMB_TOL)
    assert card._ensure_params()["embed"].device.type == "cuda"
