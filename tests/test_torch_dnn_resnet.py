"""Port parity: the ResNet zoo, DNNModel, ImageFeaturizer and the offline
model repository (`mmlspark_tpu_torch.models.dnn`, `.downloader`) against
the JAX package's, on the CPU.

Tolerances, relative to the largest |value| of the reference's output:
- f32 features and logits within 1e-4 (both packages compute f32; the
  convolutions sum in other orders);
- bf16 within 3e-2: each package rounds every convolution's output and
  every BN to bf16 (2^-8 relative) and the roundings compound over 18-50
  layers in other orders; measured 0.6-1.1% at 32 x 32.
Weight carry-over (`resnet_params_from_numpy` / `_to_numpy`,
`load_torch_state_dict`), the featurizer's and the repository's states
and the DNNModel outputs that do not depend on rounding are exact.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmlspark_tpu.core as ref_core
import mmlspark_tpu_torch.core as port_core
from mmlspark_tpu import downloader as ref_dl
from mmlspark_tpu.models.dnn import image_featurizer as ref_if
from mmlspark_tpu.models.dnn import model as ref_model
from mmlspark_tpu.models.dnn import resnet as ref_rn
from mmlspark_tpu_torch import downloader as port_dl
from mmlspark_tpu_torch.core import serialize as port_serialize
from mmlspark_tpu_torch.models.dnn import image_featurizer as port_if
from mmlspark_tpu_torch.models.dnn import model as port_model
from mmlspark_tpu_torch.models.dnn import resnet as port_rn

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_F32_TOL = 1e-4
_BF16_TOL = 3e-2


@functools.lru_cache(maxsize=None)
def _ref_variables(name, num_classes=10, seed=0):
    """Variables in the reference's layout (a numpy tree, HWIO kernels):
    the port's seeded init with BN's scale, bias and statistics drawn at
    random, so BN is a real affine map. Shared, never mutated."""
    v = port_rn.init_resnet(getattr(port_rn, name)(num_classes=num_classes),
                            seed=seed)
    rng = np.random.default_rng(seed + 1)

    def draw(path, leaf):
        kind = path[-1]
        if kind in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if kind in ("bias", "mean"):
            return rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        return leaf
    return port_rn._map(v, draw)


def _rel_err(got, want):
    return float(np.abs(np.asarray(got) - want).max()
                 / np.abs(want).max())


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).random((3, 32, 32, 3)).astype(
        np.float32)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_matches_reference(name, dtype, images):
    """Features and logits from the reference's variables, NHWC images
    transposed to the port's NCHW at the boundary."""
    v = _ref_variables(name)
    state = port_rn.resnet_params_from_numpy(v, "cpu")
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    tol = _F32_TOL if dtype == "float32" else _BF16_TOL
    for cut, width in (("logits", 10), ("features", 2048 if name ==
                                        "resnet50" else 512)):
        ref = getattr(ref_rn, name)(num_classes=10, dtype=jnp.dtype(dtype),
                                    cut=cut)
        want = np.asarray(jax.jit(ref.apply)(v, jnp.asarray(images)))
        port = getattr(port_rn, name)(num_classes=10, dtype=dtype, cut=cut)
        got = port(state, x)
        assert got.dtype == torch.float32 and got.shape == (3, width)
        assert _rel_err(got, want) < tol, (cut, _rel_err(got, want))


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_variables_carry_over(name):
    """The port's init has the reference's tree, shapes and dtypes (read
    from flax's init by `jax.eval_shape`); a reference tree goes to the
    port's state and back unchanged."""
    ref = getattr(ref_rn, name)(num_classes=7)
    shapes = jax.eval_shape(lambda: ref_rn.init_resnet(ref, (32, 32, 3)))
    port_v = port_rn.init_resnet(getattr(port_rn, name)(num_classes=7))
    assert jax.tree_util.tree_structure(port_v) == \
        jax.tree_util.tree_structure(shapes)
    for a, b in zip(jax.tree_util.tree_leaves(port_v),
                    jax.tree_util.tree_leaves(shapes)):
        assert a.shape == b.shape and a.dtype == b.dtype
    # BN starts at unit scale and statistics; kernels have variance 1/fan_in
    bn = port_v["batch_stats"]["bn_init"]
    assert (bn["var"] == 1).all() and (bn["mean"] == 0).all()
    k = port_v["params"]["conv_init"]["kernel"]
    assert abs(float(k.std()) * np.sqrt(7 * 7 * 3) - 1) < 0.1
    v = _ref_variables(name)
    back = port_rn.resnet_params_to_numpy(
        port_rn.resnet_params_from_numpy(v, "cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(a, b)


def test_load_torch_state_dict_matches_reference():
    """A torchvision-convention state dict (the reference's names, OIHW
    kernels, (out, in) fc) loads to the reference's variables in both
    packages, the same arrays."""
    v = _ref_variables("resnet18")
    sd = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(v)[0]:
        fk = tuple(p.key for p in path)
        w = np.asarray(leaf)
        if fk[-1] == "kernel" and w.ndim == 4:
            w = w.transpose(3, 2, 0, 1)
        elif fk[-1] == "kernel":
            w = w.T
        sd[port_rn._torch_key(fk)] = torch.from_numpy(w.copy())
    want = ref_rn.load_torch_state_dict(
        ref_rn.resnet18(num_classes=10), {k: t.numpy() for k, t in
                                          sd.items()}, (32, 32, 3))
    got = port_rn.load_torch_state_dict(port_rn.resnet18(num_classes=10), sd)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    del sd["layer1.0.conv1.weight"]
    with pytest.raises(KeyError, match="layer1.0.conv1.weight"):
        port_rn.load_torch_state_dict(port_rn.resnet18(num_classes=10), sd)


# ---------------------------------------------------------------- DNNModel
def _mlp_params():
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(8, 3)).astype(np.float32),
            "b": np.zeros(3, np.float32)}


def _port_mlp(p, xb):
    h = torch.tanh(xb @ p["w"] + p["b"])
    return h, {"double": h * 2, "sum": h.sum(-1)}


def _ref_mlp(p, xb):
    h = jnp.tanh(xb @ p["w"] + p["b"])
    return h, {"double": h * 2, "sum": h.sum(-1)}


def _score_both(x, batch, **kw):
    """(port, reference) DNNModel scores of x through the same network."""
    calls = []

    def port_fn(p, xb):
        calls.append(tuple(xb.shape))
        return _port_mlp(p, xb)

    pm = port_model.DNNModel(apply_fn=port_fn, params=_mlp_params(),
                             batch_size=batch, device="cpu", **kw)
    rm = ref_model.DNNModel(apply_fn=_ref_mlp, params=_mlp_params(),
                            batch_size=batch, **kw)
    got = pm.transform(port_core.Table({"features": x}))["scores"]
    want = rm.transform(ref_core.Table({"features": x}))["scores"]
    assert set(calls) == {(batch, 8)}    # every batch padded to one shape
    return got, want


@pytest.mark.parametrize("n, batch", [(37, 16), (16, 16), (5, 64)])
def test_dnn_model_pads_and_selects_outputs(n, batch):
    """Ragged last batches are padded to batch_size and cut off after;
    output_index picks one output of a tuple; the scores agree with the
    reference's within rtol 1e-5, atol 1e-6 (torch's and XLA's f32 tanh
    differ by a few ulps)."""
    x = np.random.default_rng(1).normal(size=(n, 8)).astype(np.float32)
    got, want = _score_both(x, batch, output_index=0)
    assert got.shape == (n, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_dnn_model_output_index_on_a_dict():
    """output_index names a key when the selected output is a dict."""
    x = np.random.default_rng(2).normal(size=(10, 8)).astype(np.float32)

    def port_dict(p, xb):
        return _port_mlp(p, xb)[1]

    def ref_dict(p, xb):
        return _ref_mlp(p, xb)[1]

    pm = port_model.DNNModel(apply_fn=port_dict, params=_mlp_params(),
                             batch_size=4, output_index="sum", device="cpu")
    rm = ref_model.DNNModel(apply_fn=ref_dict, params=_mlp_params(),
                            batch_size=4, output_index="sum")
    got = pm.transform(port_core.Table({"features": x}))["scores"]
    want = rm.transform(ref_core.Table({"features": x}))["scores"]
    assert got.shape == (10,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


_LOAD_CHILD = """
import sys
import numpy as np
from mmlspark_tpu_torch.core import serialize
m = serialize.load_stage(sys.argv[1])
assert m._apply_fn is None, "the graph must come from the artifact"
m.set(device="cpu")
x = np.load(sys.argv[2])
np.save(sys.argv[3], m.transform(__import__(
    "mmlspark_tpu_torch").Table({"features": x}))["scores"])
"""


def test_dnn_model_saves_a_torch_export_program(tmp_path):
    """save() stores the params in the reference's layout and the graph
    as a torch.export program; a fresh process that never saw the apply
    function loads it and scores bit for bit alike."""
    x = np.random.default_rng(3).normal(size=(16, 8)).astype(np.float32)
    m = port_model.DNNModel(apply_fn=lambda p, xb: _port_mlp(p, xb)[0],
                            params=_mlp_params(), batch_size=16,
                            device="cpu")
    want = m.transform(port_core.Table({"features": x}))["scores"]
    state = m._get_state()
    assert {"treedef", "n_leaves", "leaf_0", "leaf_1",
            "torch_export"} <= set(state)
    np.testing.assert_array_equal(state["leaf_1"], _mlp_params()["w"])
    m.save(str(tmp_path / "dnn"))
    np.save(tmp_path / "x.npy", x)
    proc = subprocess.run(
        [sys.executable, "-c", _LOAD_CHILD, str(tmp_path / "dnn"),
         str(tmp_path / "x.npy"), str(tmp_path / "y.npy")],
        cwd=_REPO, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want)


def test_dnn_model_refuses_a_stablehlo_artifact(tmp_path):
    """A reference artifact holds its graph as StableHLO, which the port
    cannot run: loading it raises and says so."""
    x = np.random.default_rng(4).normal(size=(4, 8)).astype(np.float32)
    rm = ref_model.DNNModel(apply_fn=lambda p, xb: _ref_mlp(p, xb)[0],
                            params=_mlp_params(), batch_size=4)
    rm.transform(ref_core.Table({"features": x}))
    rm.save(str(tmp_path / "ref"))
    with pytest.raises(ValueError, match="StableHLO"):
        port_serialize.load_stage(str(tmp_path / "ref"))


# ---------------------------------------------------------- ImageFeaturizer
def _small_images(n=5, size=16, seed=5):
    return np.random.default_rng(seed).integers(
        0, 256, size=(n, size, size, 3)).astype(np.uint8)


@pytest.mark.parametrize("name, cut", [("resnet18", 1), ("resnet18", 0)])
def test_image_featurizer_matches_reference(name, cut):
    """16 x 16 images resized to the model's 32 x 32 (a 2x upsampling,
    whose weights 1, 0.75 and 0.25 sum exactly in both packages), scaled
    and featurized in f32 from the same variables, batch 2 (a ragged
    last batch)."""
    v = _ref_variables(name)
    imgs = _small_images()
    kw = dict(model_name=name, cut_output_layers=cut, image_height=32,
              image_width=32, batch_size=2, dtype="float32", num_classes=10)
    want = ref_if.ImageFeaturizer(variables=v, **kw).transform(
        ref_core.Table({"image": imgs}))["features"]
    got = port_if.ImageFeaturizer(variables=v, device="cpu", **kw).transform(
        port_core.Table({"image": imgs}))["features"]
    assert got.shape == want.shape
    assert _rel_err(got, want) < _F32_TOL


def test_image_featurizer_seeded_init_and_bf16():
    """Without variables the port draws its own seeded weights (the same
    for the same seed); bf16 features stay within the bf16 bound of the
    f32 ones."""
    imgs = _small_images(n=3, size=32)
    t = port_core.Table({"image": imgs})
    kw = dict(image_height=32, image_width=32, device="cpu", seed=3)
    f32 = port_if.ImageFeaturizer(dtype="float32", **kw).transform(t)
    again = port_if.ImageFeaturizer(dtype="float32", **kw).transform(t)
    bf16 = port_if.ImageFeaturizer(dtype="bfloat16", **kw).transform(t)
    np.testing.assert_array_equal(f32["features"], again["features"])
    assert _rel_err(bf16["features"], f32["features"]) < _BF16_TOL


def test_image_featurizer_state_crosses_between_packages(tmp_path):
    """A featurizer saved by the reference loads in the port and scores
    alike, and the port's loads in the reference."""
    imgs = _small_images(n=3, size=32)
    kw = dict(model_name="resnet18", image_height=32, image_width=32,
              dtype="float32", num_classes=10)
    ref = ref_if.ImageFeaturizer(variables=_ref_variables("resnet18"), **kw)
    want = ref.transform(ref_core.Table({"image": imgs}))["features"]
    ref.save(str(tmp_path / "ref"))
    port = port_serialize.load_stage(str(tmp_path / "ref"))
    assert isinstance(port, port_if.ImageFeaturizer)
    port.set(device="cpu")
    got = port.transform(port_core.Table({"image": imgs}))["features"]
    assert _rel_err(got, want) < _F32_TOL
    port.clear("device")
    port.save(str(tmp_path / "port"))
    back = ref_core.PipelineStage.load(str(tmp_path / "port"))
    assert isinstance(back, ref_if.ImageFeaturizer)
    again = back.transform(ref_core.Table({"image": imgs}))["features"]
    np.testing.assert_allclose(again, want, rtol=1e-6, atol=1e-6)


def test_local_repo_crosses_between_packages(tmp_path):
    """A repo written by either package lists and reads in the other, and
    its schema's variables drive the port's featurizer (set_model)."""
    v = _ref_variables("resnet18")
    ref_repo = ref_dl.LocalRepo(str(tmp_path / "a"))
    ref_repo.put_model(ref_dl.ModelSchema(
        name="resnet18", input_shape=(32, 32, 3), num_classes=10,
        variables=v))
    got = port_dl.LocalRepo(str(tmp_path / "a")).get_model("resnet18")
    assert (got.name, got.input_shape, got.num_classes) == \
        ("resnet18", (32, 32, 3), 10)
    for a, b in zip(jax.tree_util.tree_leaves(got.variables),
                    jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(a, b)
    imgs = _small_images(n=2, size=32)
    f = port_if.ImageFeaturizer(image_height=32, image_width=32,
                                dtype="float32", device="cpu").set_model(got)
    out = f.transform(port_core.Table({"image": imgs}))["features"]
    want = ref_if.ImageFeaturizer(image_height=32, image_width=32,
                                  dtype="float32").set_model(
        ref_repo.get_model("resnet18")).transform(
        ref_core.Table({"image": imgs}))["features"]
    assert out.shape == (2, 512) and _rel_err(out, want) < _F32_TOL
    port_repo = port_dl.LocalRepo(str(tmp_path / "b"))
    port_repo.put_model(port_dl.ModelSchema(
        name="r18", variables=port_rn.resnet_params_from_numpy(v, "cpu")))
    port_repo.put_model(port_dl.ModelSchema(name="bare", num_classes=3))
    back = ref_dl.LocalRepo(str(tmp_path / "b"))
    assert [s.name for s in back.list_models()] == ["r18", "bare"]
    assert back.get_model("bare").variables is None
    k = back.get_model("r18").variables["params"]["conv_init"]["kernel"]
    # the port's state holds OIHW kernels: the repo stores what it is given
    np.testing.assert_array_equal(
        k, v["params"]["conv_init"]["kernel"].transpose(3, 2, 0, 1))
    with pytest.raises(KeyError, match="nope"):
        port_repo.get_model("nope")
