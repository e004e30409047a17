"""Port parity: the featurizers (`featurize/`: ValueIndexer, IndexToValue,
CleanMissingData, Featurize, CountSelector, DataConversion,
TextFeaturizer).

The same seeded tables go through both packages, JAX on the CPU and the
port with `device="cpu"` where a stage reaches a device. Every output
column equals the reference's bit for bit, dtype and shape included, and
so does each column's metadata (the sparse pairs' `logical_width`, the
indexers' `categorical_levels`).
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu.core import Table as RefTable
from mmlspark_tpu.featurize import CleanMissingData as RefClean
from mmlspark_tpu.featurize import CountSelector as RefCountSelector
from mmlspark_tpu.featurize import DataConversion as RefConversion
from mmlspark_tpu.featurize import Featurize as RefFeaturize
from mmlspark_tpu.featurize import IndexToValue as RefIndexToValue
from mmlspark_tpu.featurize import TextFeaturizer as RefText
from mmlspark_tpu.featurize import ValueIndexer as RefIndexer
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.core.serialize import load_stage, save_stage
from mmlspark_tpu_torch.featurize import (CleanMissingData, CountSelector,
                                          DataConversion, Featurize,
                                          IndexToValue, TextFeaturizer,
                                          ValueIndexer)

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_N = 2000
# Adult Census Income's categorical cardinalities: workclass, education,
# marital-status, occupation, relationship, race, sex, native-country
_ADULT_CARDS = (9, 16, 7, 15, 6, 5, 2, 42)


def _mixed(seed=0, n=_N):
    rng = np.random.default_rng(seed)
    num = rng.normal(size=n)
    num[rng.random(n) < 0.1] = np.nan
    return {
        "num": num,
        "count": rng.integers(0, 50, n).astype(np.int64),
        "f32": rng.normal(size=n).astype(np.float32),
        "cat": rng.choice(["x", "y", "z"], n),
        "obj": np.array([f"o{v}" for v in rng.integers(0, 12, n)],
                        dtype=object),
        "wide": np.array([f"w{v}" for v in rng.integers(0, 500, n)],
                         dtype=object),
        "vec": rng.normal(size=(n, 3)).astype(np.float32),
        "label": rng.integers(0, 2, n).astype(np.float64),
    }


def _adult(seed=1, n=_N):
    rng = np.random.default_rng(seed)
    cols = {}
    for j in range(6):
        v = rng.normal(size=n)
        v[rng.random(n) < 0.05] = np.nan
        cols[f"n{j}"] = v
    for j, card in enumerate(_ADULT_CARDS):
        cols[f"c{j}"] = np.array([f"c{j}_{v}" for v in
                                  rng.integers(0, card, n)], dtype=object)
    cols["label"] = rng.choice([">50K", "<=50K"], n)
    return cols


def _same_tables(ref, got):
    assert list(got.columns) == list(ref.columns)
    for c in ref.columns:
        a, b = np.asarray(ref[c]), np.asarray(got[c])
        assert (a.dtype, a.shape) == (b.dtype, b.shape), c
        if a.dtype == object:
            assert all(x == y for x, y in zip(a.ravel(), b.ravel())), c
        else:
            assert a.tobytes() == b.tobytes(), c
        assert got.column_meta(c) == ref.column_meta(c), c


def _both(cols):
    return RefTable(dict(cols)), Table(dict(cols))


@pytest.mark.parametrize("kw", [
    {}, {"dense_output": False}, {"dense_output": True},
    {"num_features": 1 << 10}, {"one_hot_encode_categoricals": False},
    {"impute_missing": False}, {"max_onehot_cardinality": 4},
    {"input_cols": ["num", "cat", "wide"], "output_col": "feats"}])
def test_featurize_matches_reference(kw):
    rt, pt = _both(_mixed())
    ref = RefFeaturize(**kw).fit(rt)
    got = Featurize(**kw).fit(pt)
    assert got.num_output_features == ref.num_output_features
    _same_tables(ref.transform(rt), got.transform(pt))


def test_featurize_adult_shape_is_108_columns(tmp_path):
    cols = _adult()
    rt, pt = _both(cols)
    ref = RefFeaturize(dense_output=True).fit(rt)
    got = Featurize(dense_output=True).fit(pt)
    out = got.transform(pt)
    assert out["features"].shape == (_N, 102 + 6)
    _same_tables(ref.transform(rt), out)
    save_stage(got, str(tmp_path / "f"))
    _same_tables(out, load_stage(str(tmp_path / "f")).transform(pt))


def test_indexers_and_cleaning_match_reference():
    rt, pt = _both(_mixed())
    for c in ("cat", "obj", "count"):
        ref = RefIndexer(input_col=c, output_col="ix").fit(rt)
        got = ValueIndexer(input_col=c, output_col="ix").fit(pt)
        rout, pout = ref.transform(rt), got.transform(pt)
        _same_tables(rout, pout)
        back_ref = RefIndexToValue(levels=ref.levels, input_col="ix",
                                   output_col="back").transform(rout)
        back = IndexToValue(levels=got.levels, input_col="ix",
                            output_col="back").transform(pout)
        _same_tables(back_ref, back)
    for mode in ("Mean", "Median", "Custom"):
        kw = dict(cleaning_mode=mode, custom_value=-1.0)
        _same_tables(RefClean(**kw).fit(rt).transform(rt),
                     CleanMissingData(**kw).fit(pt).transform(pt))
    kw = dict(input_cols=["num"], output_cols=["num_clean"])
    _same_tables(RefClean(**kw).fit(rt).transform(rt),
                 CleanMissingData(**kw).fit(pt).transform(pt))
    # a None among object levels: both fit, and both refuse to look it up
    # (numpy cannot order None against str)
    cols = _mixed()
    cols["obj"][::7] = None
    rt, pt = _both(cols)
    for cls, t in ((RefIndexer, rt), (ValueIndexer, pt)):
        m = cls(input_col="obj", output_col="ix").fit(t)
        with pytest.raises(TypeError):
            m.transform(t)


def test_count_selector_and_conversion_match_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(_N, 8)).astype(np.float32)
    x[:, [1, 6]] = 0.0
    rt, pt = _both({"features": x, "n": rng.integers(0, 9, _N)})
    _same_tables(RefCountSelector(output_col="sel").fit(rt).transform(rt),
                 CountSelector(output_col="sel").fit(pt).transform(pt))
    kw = dict(cols=["n"], convert_to="float32")
    _same_tables(RefConversion(**kw).transform(rt),
                 DataConversion(**kw).transform(pt))


def _docs(seed=2, n=400, vocab=300):
    rng = np.random.default_rng(seed)
    return np.array([" ".join(f"W{w}" for w in rng.integers(
        0, vocab, rng.integers(0, 30))) for _ in range(n)], dtype=object)


@pytest.mark.parametrize("kw", [
    {}, {"num_features": 1 << 10}, {"use_ngram": True, "n_gram_length": 3},
    {"use_idf": False}, {"min_doc_freq": 3, "num_features": 1 << 10},
    {"to_lower_case": False, "use_tokenizer": False},
    {"dense_output": True, "num_features": 1 << 12}])
def test_text_featurizer_matches_reference(kw, tmp_path):
    rt, pt = _both({"text": _docs()})
    ref = RefText(input_col="text", output_col="tf", **kw).fit(rt)
    got = TextFeaturizer(input_col="text", output_col="tf", device="cpu",
                         **kw).fit(pt)
    out = got.transform(pt)
    _same_tables(ref.transform(rt), out)
    save_stage(got, str(tmp_path / "t"))
    _same_tables(out, load_stage(str(tmp_path / "t")).transform(pt))
