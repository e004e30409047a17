"""Port parity: transfer learning (`mmlspark_tpu_torch.models.dnn.transfer`)
against the JAX package's, on the CPU, from the reference's variables and
the reference's head draw (`transfer._head_draw` replaced by jax's
threefry normal: torch cannot reproduce threefry, ROADMAP Queue 3 (b)).

- Gradients: in full mode the reference trains the whole variable tree,
  BN's running statistics included (they feed the inference-form BN). The
  port's gradients of every leaf, the statistics' too, are held to jax's
  within 1e-3 of each leaf's largest |gradient| (f32, other orders).
- Fits, f32, resnet18 at 32 x 32 from 16 x 16 images (a 2x upsampling,
  exact in both packages): head mode's per-epoch losses within 1e-5, full
  mode's within 1e-4, predictions equal and probabilities within 1e-4.
  Head mode trains at learning_rate 1e-2, full mode at 3e-4 (the
  backbone at 3e-5): Adam's first updates are about lr * sign(g), so a
  weight whose gradient is near zero can move up to 2 lr apart in the
  two packages each step; the fitted variables are held within that
  bound. At larger rates those differences compound into the losses
  (head at 2e-2: 1.6e-5 apart by the third epoch; full at 1e-3: 1.05e-4
  by the second, against ~1e-6 at 3e-4): rounding, not semantics, which
  the gradient test pins.
- The fitted model's state crosses between the packages both ways.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import mmlspark_tpu.core as ref_core
import mmlspark_tpu_torch.core as port_core
from mmlspark_tpu.models.dnn import resnet as ref_rn
from mmlspark_tpu.models.dnn import transfer as ref_tr
from mmlspark_tpu_torch.core import serialize as port_serialize
from mmlspark_tpu_torch.models.dnn import resnet as port_rn
from mmlspark_tpu_torch.models.dnn import transfer as port_tr
from mmlspark_tpu_torch.models.dnn.transformer import _flatten

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_N, _C = 16, 3


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    y = (np.arange(_N) % _C).astype(np.float32)
    imgs = rng.normal(0.45, 0.1, size=(_N, 16, 16, 3))
    for c in range(_C):                 # each class brightens one channel
        imgs[y == c, ..., c] += 0.35
    imgs = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
    # the reference's layout from the port's seeded init, BN's scale,
    # bias and statistics drawn at random so BN is a real affine map
    v = port_rn.init_resnet(port_rn.resnet18(num_classes=_C), seed=0)
    draw = np.random.default_rng(1)

    def bn(path, leaf):
        if path[-1] in ("scale", "var"):
            return draw.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if path[-1] in ("bias", "mean"):
            return draw.normal(0, 0.1, leaf.shape).astype(np.float32)
        return leaf
    return imgs, y, port_rn._map(v, bn)


@pytest.fixture
def reference_head(monkeypatch):
    """The port's head starts from the reference's threefry draw."""
    def draw(seed, d, c):
        return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                            (d, c)))
    monkeypatch.setattr(port_tr, "_head_draw", draw)


def _kw(mode, epochs, lr):
    return dict(model_name="resnet18", num_classes=_C, mode=mode,
                epochs=epochs, batch_size=8, image_height=32, image_width=32,
                learning_rate=lr, seed=0, dtype="float32")


def _fit_both(data, mode, epochs, lr):
    imgs, y, v = data
    ref = ref_tr.DeepTransferClassifier(variables=v, **_kw(
        mode, epochs, lr)).fit(ref_core.Table({"image": imgs, "label": y}))
    port = port_tr.DeepTransferClassifier(
        variables=v, device="cpu", **_kw(mode, epochs, lr)).fit(
        port_core.Table({"image": imgs, "label": y}))
    return ref, port


def _scores(ref, port, imgs):
    want = ref.transform(ref_core.Table({"image": imgs}))
    got = port.transform(port_core.Table({"image": imgs}))
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    np.testing.assert_allclose(got["probabilities"], want["probabilities"],
                               rtol=0, atol=1e-4)
    return got


def test_head_mode_matches_reference(data, reference_head, tmp_path):
    """Head mode's fit, then the fitted model's state across the packages
    both ways (saved by one, loaded and scored by the other)."""
    ref, port = _fit_both(data, "head", epochs=3, lr=1e-2)
    np.testing.assert_allclose(port.training_losses, ref.training_losses,
                               rtol=0, atol=1e-5)
    assert port.training_losses[-1] < port.training_losses[0]
    got = _scores(ref, port, data[0])["probabilities"]
    # the frozen backbone comes back as it went in
    for a, b in zip(_flatten(port._variables), _flatten(data[2])):
        np.testing.assert_array_equal(a, b)
    imgs = data[0]
    want = ref.transform(ref_core.Table({"image": imgs}))["probabilities"]
    ref.save(str(tmp_path / "ref"))
    loaded = port_serialize.load_stage(str(tmp_path / "ref"))
    assert isinstance(loaded, port_tr.DeepTransferModel)
    assert loaded.training_losses == ref.training_losses
    loaded.set(device="cpu")
    np.testing.assert_allclose(loaded.transform(port_core.Table(
        {"image": imgs}))["probabilities"], want, rtol=0, atol=1e-4)
    port.clear("device")
    port.save(str(tmp_path / "port"))
    back = ref_core.PipelineStage.load(str(tmp_path / "port"))
    assert back.training_losses == port.training_losses
    np.testing.assert_allclose(
        back.transform(ref_core.Table({"image": imgs}))["probabilities"],
        got, rtol=0, atol=1e-4)


def test_full_mode_matches_reference(data, reference_head):
    epochs, lr = 2, 3e-4
    ref, port = _fit_both(data, "full", epochs, lr)
    np.testing.assert_allclose(port.training_losses, ref.training_losses,
                               rtol=0, atol=1e-4)
    _scores(ref, port, data[0])
    steps = epochs * (_N // 8)
    bound = 2 * lr * 0.1 * steps
    moved = 0.0
    for a, b, start in zip(_flatten(port._variables),
                           _flatten(jax.tree_util.tree_map(
                               np.asarray, ref._variables)),
                           _flatten(data[2])):
        assert np.abs(a - b).max() <= bound
        moved = max(moved, float(np.abs(a - start).max()))
    assert moved > 0
    # Adam moved the BN statistics in both packages, alike
    stats = port._variables["batch_stats"]["bn_init"]
    want = np.asarray(ref._variables["batch_stats"]["bn_init"]["mean"])
    assert np.abs(stats["mean"]).max() > 0
    assert np.abs(stats["mean"] - want).max() <= bound


def test_full_mode_gradients_reach_bn_statistics(data):
    """One batch's loss gradient in the port and in jax, every leaf of the
    variable tree (BN means and variances too)."""
    imgs, y, v = data
    x = np.repeat(np.repeat(imgs[:8], 2, 1), 2, 2).astype(np.float32) / 255
    head_w = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (512, _C)))
    labels = y[:8].astype(np.int32)
    ref_model = ref_rn.resnet18(num_classes=_C, cut="features")

    def ref_loss(variables):
        feats = ref_model.apply(variables, jnp.asarray(x))
        logits = feats @ head_w / np.sqrt(512)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()
    want = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(ref_loss))(v))

    state = port_rn.resnet_params_from_numpy(v, "cpu")
    leaves = port_tr._trainable(state)
    feats = port_rn.resnet18(num_classes=_C, cut="features")(
        state, torch.from_numpy(x).permute(0, 3, 1, 2))
    logits = feats @ torch.from_numpy(head_w) / np.sqrt(512)
    F.cross_entropy(logits, torch.from_numpy(labels).long()).backward()
    grads = port_rn.resnet_params_to_numpy(
        port_rn._map(state, lambda p, t: t.grad if t.grad is not None
                     else torch.zeros_like(t)))
    assert len(leaves) == len(_flatten(want))
    for g, w in zip(_flatten(grads), _flatten(want)):
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max() + 1e-12
    stats = _flatten(grads["batch_stats"])
    assert all(np.abs(g).max() > 0 for g in stats)


def test_port_fit_saves_loads_and_repeats(data, tmp_path):
    """The port's own head draw is seeded: two fits agree bit for bit, and
    a saved model scores bit for bit alike after a load."""
    imgs, y, _ = data
    kw = dict(_kw("head", 2, 2e-2), device="cpu")
    t = port_core.Table({"image": imgs, "label": y})
    a = port_tr.DeepTransferClassifier(**kw).fit(t)
    b = port_tr.DeepTransferClassifier(**kw).fit(t)
    assert a.training_losses == b.training_losses
    want = a.transform(t)["probabilities"]
    a.save(str(tmp_path / "m"))
    back = port_serialize.load_stage(str(tmp_path / "m"))
    np.testing.assert_array_equal(back.transform(t)["probabilities"], want)
