"""Port parity: the ONNX importer (`mmlspark_tpu_torch.models.dnn.
onnx_import`) against torch's own forward and the JAX package's importer,
on the CPU.

Fixtures come from torch's protobuf writer (tests/data/
make_onnx_fixtures.py, tests/data/torch_resnet.py), so reader and writer
are independent. Tolerances, as the reference's tests state them: the
fixtures within rtol 1e-4, atol 1e-5 of torch's outputs
(`onnx_expected.npz`); ResNet-18 within 1e-4 of torch's forward relative
to its largest |logit|; single ops within rtol 1e-5, atol 1e-5 of the
reference's `_eval_node` (both f32, other summation orders). The wire
reader is the reference's, and its results are equal.
"""
import os
import sys
import tempfile
import unittest.mock as mock

import numpy as np
import pytest
import torch

import mmlspark_tpu_torch.core as port_core
from mmlspark_tpu.models.dnn import onnx_import as ref_onnx
from mmlspark_tpu_torch.core import serialize as port_serialize
from mmlspark_tpu_torch.models.dnn import onnx_import as port_onnx
from mmlspark_tpu_torch.models.dnn.image_featurizer import ImageFeaturizer
from mmlspark_tpu_torch.models.dnn.model import DNNModel, params_to_device

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
_TOL = dict(rtol=1e-5, atol=1e-5)


def _expected():
    return np.load(os.path.join(DATA, "onnx_expected.npz"))


def _run(path, x, cut=None):
    apply_fn, params = port_onnx.load_onnx(path, cut=cut)
    return apply_fn(params_to_device(params, "cpu"),
                    torch.from_numpy(np.asarray(x))).numpy()


@pytest.mark.parametrize("name, xk, yk", [("mlp", "x1", "y1"),
                                          ("convnet", "x2", "y2")])
def test_fixtures_match_torch_and_reference(name, xk, yk):
    """Gemm/Relu (mlp); Conv, BatchNormalization, MaxPool, strided Conv,
    GlobalAveragePool, Flatten, Gemm (convnet)."""
    path = os.path.join(DATA, f"{name}.onnx")
    exp = _expected()
    got = _run(path, exp[xk])
    np.testing.assert_allclose(got, exp[yk], rtol=1e-4, atol=1e-5)
    ref_fn, ref_params = ref_onnx.load_onnx(path)
    np.testing.assert_allclose(got, np.asarray(ref_fn(ref_params, exp[xk])),
                               **_TOL)
    _, params = port_onnx.load_onnx(path)
    assert sorted(params) == sorted(ref_params)
    for k in params:
        np.testing.assert_array_equal(params[k], ref_params[k])


def test_scores_through_dnnmodel_and_saves(tmp_path):
    """The imported graph is a DNNModel: padded minibatch scoring, then a
    save and load through a torch.export program."""
    apply_fn, params = port_onnx.load_onnx(os.path.join(DATA, "mlp.onnx"))
    exp = _expected()
    x = np.tile(exp["x1"], (3, 1))[:10].astype(np.float32)
    m = DNNModel(apply_fn=apply_fn, params=params, input_col="f",
                 output_col="s", batch_size=4, device="cpu")
    out = m.transform(port_core.Table({"f": x}))["s"]
    np.testing.assert_allclose(out, np.tile(exp["y1"], (3, 1))[:10],
                               rtol=1e-4, atol=1e-5)
    m.save(str(tmp_path / "m"))
    back = port_serialize.load_stage(str(tmp_path / "m"))
    back.set(device="cpu")
    assert back._apply_fn is None
    np.testing.assert_array_equal(
        back.transform(port_core.Table({"f": x}))["s"], out)


def _node(op, attrs, inputs=("x",)):
    return {"op": op, "name": f"{op.lower()}1", "inputs": list(inputs),
            "outputs": ["y"], "attrs": attrs}


def _both(node, env):
    """(port, reference) evaluations of one node on numpy inputs."""
    got = port_onnx._eval_node(
        node, {k: torch.from_numpy(np.asarray(v)) for k, v in env.items()})
    want = np.asarray(ref_onnx._eval_node(node, env))
    return got.numpy(), want


_RNG = np.random.default_rng(7)
_X = _RNG.normal(size=(2, 3, 9, 8)).astype(np.float32)
_W = _RNG.normal(size=(4, 3, 3, 3)).astype(np.float32)
_B = _RNG.normal(size=(4,)).astype(np.float32)


@pytest.mark.parametrize("op, attrs", [
    ("Conv", {"pads": [1, 1, 1, 1], "strides": [1, 1]}),
    ("Conv", {"pads": [0, 2, 1, 0], "strides": [2, 1]}),      # asymmetric
    ("Conv", {"pads": [2, 2, 2, 2], "dilations": [2, 2]}),
    ("MaxPool", {"kernel_shape": [3, 3], "strides": [2, 2],
                 "pads": [1, 1, 1, 1]}),
    ("MaxPool", {"kernel_shape": [2, 3], "pads": [1, 0, 0, 2]}),
    ("AveragePool", {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1]}),
    ("AveragePool", {"kernel_shape": [3, 2], "strides": [2, 2],
                     "pads": [0, 1, 2, 0]}),
    ("AveragePool", {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1],
                     "count_include_pad": 1}),
    ("AveragePool", {"kernel_shape": [2, 2], "strides": [2, 2]}),
    ("GlobalAveragePool", {}),
    ("Relu", {}),
    ("Identity", {}),
    ("Flatten", {"axis": 1}),
    ("Flatten", {"axis": 2}),
    ("Flatten", {"axis": 0}),
])
def test_spatial_ops_match_reference(op, attrs):
    inputs = ("x", "w", "b") if op == "Conv" else ("x",)
    got, want = _both(_node(op, attrs, inputs), {"x": _X, "w": _W, "b": _B})
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **_TOL)


def test_averagepool_excludes_padding_by_default():
    """Border windows divide by the count of valid cells, unless
    count_include_pad (reference test_onnx_import.py:55-73)."""
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    node = _node("AveragePool", {"kernel_shape": [3, 3], "strides": [1, 1],
                                 "pads": [1, 1, 1, 1]})
    got = port_onnx._eval_node(node, {"x": torch.from_numpy(x)}).numpy()
    assert got[0, 0, 0, 0] == np.float32(x[0, 0, :2, :2].mean())
    assert abs(got[0, 0, 1, 1] - x[0, 0, :3, :3].mean()) < 1e-6
    node["attrs"]["count_include_pad"] = 1
    got2 = port_onnx._eval_node(node, {"x": torch.from_numpy(x)}).numpy()
    assert abs(got2[0, 0, 0, 0] - x[0, 0, :2, :2].sum() / 9.0) < 1e-6


def test_maxpool_pads_with_minus_infinity():
    x = -np.ones((1, 1, 2, 2), np.float32) * 5
    node = _node("MaxPool", {"kernel_shape": [2, 2], "pads": [1, 1, 1, 1]})
    got = port_onnx._eval_node(node, {"x": torch.from_numpy(x)}).numpy()
    assert (got == -5).all()


def test_grouped_conv_is_the_groups_convs():
    """The reference refuses group != 1; the port evaluates it, equal to
    the reference's convolution of each group's channels."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 4, 7, 7)).astype(np.float32)
    w = rng.normal(size=(6, 2, 3, 3)).astype(np.float32)
    node = _node("Conv", {"group": 2, "pads": [1, 1, 1, 1]}, ("x", "w"))
    got = port_onnx._eval_node(node, {"x": torch.from_numpy(x),
                                      "w": torch.from_numpy(w)}).numpy()
    one = _node("Conv", {"pads": [1, 1, 1, 1]}, ("x", "w"))
    want = np.concatenate([np.asarray(ref_onnx._eval_node(
        one, {"x": x[:, 2 * g:2 * g + 2], "w": w[3 * g:3 * g + 3]}))
        for g in range(2)], axis=1)
    np.testing.assert_allclose(got, want, **_TOL)
    with pytest.raises(NotImplementedError, match="group"):
        ref_onnx._eval_node(node, {"x": x, "w": w})


@pytest.mark.parametrize("attrs", [
    {}, {"transA": 1}, {"transB": 1}, {"alpha": np.float32(0.5),
                                       "beta": np.float32(2.0)},
    {"transA": 1, "transB": 1, "alpha": np.float32(-1.5)}])
def test_gemm_matches_reference(attrs):
    rng = np.random.default_rng(9)
    a = rng.normal(size=(5, 4) if not attrs.get("transA") else (4, 5))
    b = rng.normal(size=(4, 3) if not attrs.get("transB") else (3, 4))
    c = rng.normal(size=(3,))
    env = {"a": a.astype(np.float32), "b": b.astype(np.float32),
           "c": c.astype(np.float32)}
    got, want = _both(_node("Gemm", attrs, ("a", "b", "c")), env)
    np.testing.assert_allclose(got, want, **_TOL)
    got, want = _both(_node("Gemm", attrs, ("a", "b")), env)
    np.testing.assert_allclose(got, want, **_TOL)


def test_matmul_add_reshape_batchnorm_match_reference():
    rng = np.random.default_rng(10)
    a = rng.normal(size=(2, 3, 4)).astype(np.float32)
    b = rng.normal(size=(4, 5)).astype(np.float32)
    got, want = _both(_node("MatMul", {}, ("a", "b")), {"a": a, "b": b})
    np.testing.assert_allclose(got, want, **_TOL)
    row = rng.normal(size=(4,)).astype(np.float32)
    got, want = _both(_node("Add", {}, ("a", "r")), {"a": a, "r": row})
    np.testing.assert_array_equal(got, want)
    for shape in ([0, -1], [2, 0, 2, -1], [-1]):
        node = _node("Reshape", {}, ("a", "s"))
        env = {"a": torch.from_numpy(a), "s": np.asarray(shape, np.int64)}
        got = port_onnx._eval_node(node, env).numpy()
        want = np.asarray(ref_onnx._eval_node(
            node, {"a": a, "s": np.asarray(shape, np.int64)}))
        np.testing.assert_array_equal(got, want)
    scale, bias, mean = (rng.normal(size=(3,)).astype(np.float32)
                         for _ in range(3))
    var = rng.random(3).astype(np.float32) + 0.5
    env = {"x": _X, "s": scale, "b": bias, "m": mean, "v": var}
    node = _node("BatchNormalization", {"epsilon": np.float32(1e-3)},
                 ("x", "s", "b", "m", "v"))
    got, want = _both(node, env)
    np.testing.assert_allclose(got, want, **_TOL)


def test_constant_attribute_forms():
    """Every attribute form evaluates (float64 arrives as float32); an
    unknown form raises with the node name."""
    for attrs, expect in [({"value_float": 2.5}, 2.5),
                          ({"value_int": 7}, 7),
                          ({"value_ints": [1, 2, 3]}, [1, 2, 3]),
                          ({"value_floats": [0.5, 1.5]}, [0.5, 1.5]),
                          ({"value": np.ones((2, 2), np.float32)},
                           np.ones((2, 2)))]:
        node = _node("Constant", attrs, ())
        got = port_onnx._eval_node(node, {}, torch.device("cpu"))
        np.testing.assert_allclose(got.numpy(), expect)
        assert got.dtype != torch.float64
    bad = _node("Constant", {"sparse_value": object()}, ())
    with pytest.raises(NotImplementedError, match="constant1.*sparse_value"):
        port_onnx._eval_node(bad, {})


def test_refusals_use_the_reference_s_words():
    """auto_pad, ceil_mode, an unsupported op and a consumed secondary
    output are refused with the reference's messages."""
    x = np.zeros((1, 1, 4, 4), np.float32)
    cases = [
        _node("MaxPool", {"kernel_shape": [2, 2], "auto_pad": "SAME_UPPER"}),
        _node("MaxPool", {"kernel_shape": [2, 2], "ceil_mode": 1}),
        _node("Conv", {"auto_pad": "VALID"}, ("x", "w")),
        {"op": "LSTM", "name": "rnn1", "inputs": [], "outputs": ["y"],
         "attrs": {}}]
    for node in cases:
        env = {"x": x, "w": np.zeros((1, 1, 1, 1), np.float32)}
        with pytest.raises(NotImplementedError) as want:
            ref_onnx._eval_node(node, env)
        with pytest.raises(NotImplementedError) as got:
            port_onnx._eval_node(node, {k: torch.from_numpy(v)
                                        for k, v in env.items()})
        assert str(got.value) == str(want.value)
    g = {"nodes": [
        {"op": "BatchNormalization", "name": "bn1", "inputs": ["x"],
         "outputs": ["y", "saved_mean"], "attrs": {}},
        {"op": "Relu", "name": "r1", "inputs": ["saved_mean"],
         "outputs": ["z"], "attrs": {}}],
        "initializers": {}, "inputs": ["x"], "outputs": ["z"]}
    messages = []
    for mod in (ref_onnx, port_onnx):
        with mock.patch.object(mod, "parse_onnx", return_value=g):
            with pytest.raises(NotImplementedError,
                               match="r1.*saved_mean.*bn1") as err:
                mod.load_onnx(b"ignored")
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    with pytest.raises(ValueError, match="cut must be"):
        port_onnx.load_onnx(b"", cut="logits")


def test_wire_reader_is_the_reference_s():
    from mmlspark_tpu_torch.models.dnn.onnx_import import (_read_tensor,
                                                           _varint)
    assert _varint(bytes([0x96, 0x01]), 0) == (150, 2)
    raw = np.arange(4, dtype=np.float32).tobytes()
    buf = (bytes([0x0A, 0x02, 0x02, 0x02]) + bytes([0x10, 0x01])
           + bytes([0x42, 0x02]) + b"t0" + bytes([0x4A, len(raw)]) + raw)
    name, arr = _read_tensor(buf)
    assert name == "t0"
    np.testing.assert_array_equal(arr, np.arange(4, dtype=np.float32)
                                  .reshape(2, 2))
    with open(os.path.join(DATA, "convnet.onnx"), "rb") as f:
        data = f.read()
    want, got = ref_onnx.parse_onnx(data), port_onnx.parse_onnx(data)
    assert [n["op"] for n in got["nodes"]] == [n["op"] for n in
                                               want["nodes"]]
    assert got["inputs"] == want["inputs"]
    assert got["outputs"] == want["outputs"]


@pytest.fixture(scope="module")
def resnet18_onnx():
    """A seeded ResNet-18 exported by torch's own exporter at 64 x 64
    (the ~45 MB graph is generated, not committed)."""
    sys.path.insert(0, DATA)
    try:
        from torch_resnet import export_resnet18_onnx
    finally:
        sys.path.remove(DATA)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "r18.onnx")
        model, x, y = export_resnet18_onnx(path, seed=0, spatial=64,
                                           num_classes=10)
        with open(path, "rb") as f:
            yield f.read(), model, x, y


def test_resnet18_onnx_matches_torch_and_the_cut(resnet18_onnx, tmp_path):
    """The full ResNet-18 graph (stem, 8 BasicBlocks with identity and
    projection shortcuts, GAP, Flatten, Gemm) within 1e-4 of torch's own
    forward; the feature cut gives the 512-d pooled vector, equal to the
    reference's cut within rtol 1e-5; ImageFeaturizer scores the same
    bytes, its state holds them and no second copy of the weights, and it
    round-trips through save/load."""
    data, model, x, y_torch = resnet18_onnx
    y = _run(data, x)
    rel = np.abs(y - y_torch).max() / (np.abs(y_torch).max() + 1e-9)
    assert rel < 1e-4, rel
    feats = _run(data, x, cut="features")
    assert feats.shape == (2, 512)
    ref_fn, ref_params = ref_onnx.load_onnx(data, cut="features")
    np.testing.assert_allclose(feats, np.asarray(ref_fn(ref_params, x)),
                               rtol=1e-5, atol=1e-5)
    imgs = np.transpose(x, (0, 2, 3, 1))          # NHWC
    fz = ImageFeaturizer(onnx_model=data, image_height=64, image_width=64,
                         scale=1.0, dtype="float32", device="cpu")
    t = port_core.Table({"image": imgs})
    got = fz.transform(t)["features"]
    np.testing.assert_allclose(got, feats, rtol=1e-5, atol=1e-5)
    state = fz._get_state()
    assert "onnx_bytes" in state and "n_leaves" not in state
    fz.clear("device")
    fz.save(str(tmp_path / "fz"))
    back = port_serialize.load_stage(str(tmp_path / "fz"))
    back.set(device="cpu")
    np.testing.assert_array_equal(back.transform(t)["features"], got)
    logits = ImageFeaturizer(onnx_model=data, image_height=64,
                             image_width=64, scale=1.0, dtype="float32",
                             cut_output_layers=0, device="cpu")
    np.testing.assert_allclose(logits.transform(t)["features"], y,
                               rtol=1e-5, atol=1e-5)
