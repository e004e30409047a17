"""Port parity: the transformer encoder (`mmlspark_tpu_torch.models.dnn`).

The same seeded inputs and the same weights (each package's
`init_transformer` with one seed, or one tree converted) go through both
packages, JAX on the CPU with its flash kernel in interpret mode:
- f32 encodes at 2e-4, the tolerance of tests/test_transformer.py's
  flash-vs-dense check (two layers of f32 matmuls summed in other orders);
- bf16 `attention_dtype` at 0.05, the tolerance of its bf16 check (p is
  rounded to bf16 against a block's running max in the reference's flash,
  against the row's max in the port's plain version);
- `hash_token` bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu import Table as JaxTable
from mmlspark_tpu.models.dnn import transformer as ref
from mmlspark_tpu.ops.hashing import hash_token as jax_hash_token
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.models.dnn import transformer as port
from mmlspark_tpu_torch.ops import flash_attention as fa
from mmlspark_tpu_torch.ops.hashing import hash_token

_SMALL = dict(vocab_size=50, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              max_len=96, seed=0)
_STAGE = dict(input_col="text", output_col="emb", d_model=32, n_heads=4,
              n_layers=1, d_ff=64)
_DOCS = ["the quick brown fox", "lazy dogs sleep all day", "",
         "the quick brown fox", " ".join(["word"] * 60)]


def _leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, list):
        for item in tree:
            yield from _leaves(item)
    else:
        yield tree


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: v if k == "meta" else _as_numpy(v)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_numpy(v) for v in tree]
    return np.asarray(tree)


def test_init_transformer_is_bit_identical():
    a, b = ref.init_transformer(**_SMALL), port.init_transformer(**_SMALL)
    assert a["meta"] == b["meta"]
    la, lb = list(_leaves(a)), list(_leaves(b))
    # meta's 2 ints, embed, pos, final_ln's 2, and 12 leaves per layer
    assert len(la) == len(lb) == 6 + 2 * 12
    for x, y in zip(la, lb):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_transformer_apply_matches_jax(attention, causal):
    tree = ref.init_transformer(**_SMALL)
    toks = np.random.default_rng(0).integers(0, 50, 96).astype(np.int32)
    want = np.asarray(ref.transformer_apply(tree, toks, causal=causal,
                                            attention=attention))
    params = port.params_from_numpy(tree, device="cpu")
    got = port.transformer_apply(params, torch.as_tensor(toks),
                                 causal=causal, attention=attention)
    assert got.shape == (96, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_bf16_attention_dtype_matches_jax(attention):
    tree = ref.init_transformer(**_SMALL)
    toks = np.arange(96, dtype=np.int32) % 50
    want = np.asarray(ref.transformer_apply(
        tree, toks, causal=True, attention=attention,
        attention_dtype=jnp.bfloat16))
    params = port.params_from_numpy(tree, device="cpu")
    got = port.transformer_apply(params, torch.as_tensor(toks), causal=True,
                                 attention=attention,
                                 attention_dtype=torch.bfloat16)
    assert got.dtype == torch.float32      # the residual stream stays f32
    np.testing.assert_allclose(got.numpy(), want, rtol=0.05, atol=0.05)


def test_stage_transform_matches_jax_and_ignores_padding():
    want = ref.TransformerSentenceEncoder(**_STAGE).transform(
        JaxTable({"text": np.array(_DOCS, dtype=object)}))["emb"]
    enc = port.TransformerSentenceEncoder(**_STAGE, device="cpu")
    got = enc.transform(Table({"text": np.array(_DOCS, dtype=object)}))["emb"]
    assert got.shape == (5, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(got[2], np.zeros(32, np.float32))  # empty
    # a document alone (width 4) embeds as it does padded to width 64
    alone = enc.transform(Table({"text": np.array(_DOCS[:1],
                                                  dtype=object)}))["emb"]
    np.testing.assert_allclose(alone[0], got[0], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("attention_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_encode_long_matches_jax(attention, attention_dtype):
    kw = dict(d_model=32, n_heads=2, n_layers=1, d_ff=64, max_len=128,
              attention=attention, attention_dtype=attention_dtype)
    toks = np.arange(100, dtype=np.int32) % 50
    want = ref.TransformerSentenceEncoder(**kw).encode_long(toks)
    enc = port.TransformerSentenceEncoder(**kw, device="cpu")
    fa.reset_launches()
    got = enc.encode_long(toks)
    assert got.shape == (100, 32) and got.dtype == np.float32
    tol = 2e-4 if attention_dtype is None else 0.05
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert not any(fa.launches.values())   # a CPU tensor takes the plain


def test_set_params_tree_takes_a_jax_encoders_weights():
    """`params_from_numpy` over np.asarray of a JAX encoder's `_params`
    (list-of-layers layout with meta): both encoders give one encoding."""
    jax_enc = ref.TransformerSentenceEncoder(d_model=32, n_heads=4,
                                             n_layers=2, d_ff=64, seed=3,
                                             max_len=64, attention="flash")
    toks = np.arange(64, dtype=np.int32) % 40
    want = jax_enc.encode_long(toks)
    tree = jax_enc._ensure_params()
    enc = port.TransformerSentenceEncoder(d_model=32, n_heads=4, n_layers=2,
                                          d_ff=64, max_len=64,
                                          attention="flash", device="cpu")
    enc.set_params_tree(_as_numpy(tree))
    np.testing.assert_allclose(enc.encode_long(toks), want, rtol=2e-4,
                               atol=2e-4)


def test_reference_errors_are_kept():
    params = port.params_from_numpy(port.init_transformer(
        vocab_size=10, d_model=32, n_heads=2, n_layers=1, d_ff=64,
        max_len=16), device="cpu")
    toks = torch.zeros(16, dtype=torch.long)
    with pytest.raises(ValueError, match="key_mask"):
        port.transformer_apply(params, toks, attention="flash",
                               key_mask=torch.ones(16, dtype=torch.bool))
    with pytest.raises(ValueError, match="max_len"):
        port.transformer_apply(params, torch.zeros(17, dtype=torch.long))
    with pytest.raises(ValueError, match="attention must be one of"):
        port.transformer_apply(params, toks, attention="sparse")
    for strategy in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError, match="item 15"):
            port.transformer_apply(params, toks, attention=strategy)
        with pytest.raises(NotImplementedError, match="item 15"):
            port.TransformerSentenceEncoder(
                attention=strategy, device="cpu").encode_long(toks.numpy())
    with pytest.raises(ValueError, match="failed validation"):
        port.TransformerSentenceEncoder(attention_dtype="float16")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.TransformerSentenceEncoder(d_model=16, n_heads=2).encode_long(
            np.zeros(4, np.int32))


def test_hash_token_is_bit_identical():
    rng = np.random.default_rng(11)
    alphabet = list("abcdefghijklmnopqrstuvwxyz0123456789-_äöüß€漢字")
    words = ["".join(rng.choice(alphabet, size=rng.integers(0, 17)))
             for _ in range(300)]
    for seed in (0, 42):
        assert [hash_token(w, seed) for w in words] == \
            [jax_hash_token(w, seed) for w in words]
