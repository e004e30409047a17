"""Port parity: the pipeline core (`mmlspark_tpu_torch.core`) against the
JAX package's, on the CPU.

- `Table` and `Params` methods called the same way on both packages'
  objects give equal results; column metadata follows its column through
  select, rename, filter, take and with_column; `shuffle` and `split` give
  the same rows for the same seed; tensor columns stay tensors.
- The same two-stage pipeline (a column-selecting Transformer written
  here, then `GBDTClassifier`) built from either package's stages fits and
  transforms alike: probabilities within rtol 1e-4, atol 1e-4, the
  tolerance of tests/test_torch_boosting.py, predictions equal.
- `save` then `load` round trips: the GBDT models and
  `TransformerSentenceEncoder` come back equal by `assert_stages_equal`
  and transform bit for bit alike; a reference encoder's state loads into
  the port's stage within the encoder's tolerance (2e-4, atol 2e-5, as in
  tests/test_torch_transformer.py); tensors keep their dtype, bfloat16
  included; a saved model loads in a process that has not imported its
  class; an unknown class raises naming it.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_gbdt_categorical import _cat_data

import mmlspark_tpu.core as ref_core
import mmlspark_tpu_torch.core as port_core
from mmlspark_tpu.models.dnn import transformer as ref_tr
from mmlspark_tpu.models.gbdt import GBDTClassifier as RefClassifier
from mmlspark_tpu_torch.core.model_equality import (assert_stages_equal,
                                                    stages_equal)
from mmlspark_tpu_torch.models.dnn import transformer as port_tr
from mmlspark_tpu_torch.models.gbdt import (GBDTClassifier, GBDTRanker,
                                            GBDTRegressor)

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOL = dict(rtol=1e-4, atol=1e-4)
_N = 40


def _columns(n=_N, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=n).astype(np.float32),
            "b": rng.normal(size=(n, 3)).astype(np.float32),
            "c": rng.integers(0, 5, n)}


def _table(core, cols=None):
    return (core.Table(cols or _columns(), npartitions=2)
            .with_column_meta("b", feature_names=["x", "y", "z"])
            .with_column_meta("c", categorical_levels=["p", "q", "r", "s",
                                                       "t"]))


def _host(col):
    return col.cpu().numpy() if isinstance(col, torch.Tensor) else col


def _assert_same_table(got, want):
    assert got.columns == want.columns
    assert len(got) == len(want) and got.npartitions == want.npartitions
    for name in want.columns:
        np.testing.assert_array_equal(_host(got[name]), want[name],
                                      err_msg=name)
        assert got.column_meta(name) == want.column_meta(name), name


_OPS = {
    "select": lambda t: t.select(["c", "b"]),
    "drop": lambda t: t.drop("a"),
    "rename": lambda t: t.rename({"b": "feats", "a": "z"}),
    "filter": lambda t: t.filter(np.arange(len(t)) % 3 == 0),
    "take": lambda t: t.take(7),
    "with_column_new": lambda t: t.with_column("n", np.arange(len(t))),
    "with_column_replace": lambda t: t.with_column(
        "b", np.zeros((len(t), 2), np.float32)),
    "with_columns": lambda t: t.with_columns({"n": np.ones(len(t)),
                                              "c": np.zeros(len(t))}),
    "concat": lambda t: t.concat(t.take(5)),
    "concat_all": lambda t: type(t).concat_all([t.take(3), t, t.take(1)]),
    "repartition": lambda t: t.repartition(3),
    "partition": lambda t: t.repartition(4).partition(2),
    "partitions": lambda t: list(t.repartition(3).partitions())[1],
    "map_partitions": lambda t: t.repartition(3).map_partitions(
        lambda p: p.take(2)),
    "shuffle": lambda t: t.shuffle(7),
    "split_train": lambda t: t.split(0.7, seed=3)[0],
    "split_test": lambda t: t.split(0.7, seed=3)[1],
    "materialize": lambda t: t.materialize(),
    "from_pandas": lambda t: type(t).from_pandas(
        t.select(["a", "c"]).to_pandas(), npartitions=2),
}


@pytest.mark.parametrize("op", sorted(_OPS))
def test_table_methods_match_reference(op):
    got = _OPS[op](_table(port_core))
    want = _OPS[op](_table(ref_core))
    _assert_same_table(got, want)


@pytest.mark.parametrize("op", sorted(_OPS))
def test_tensor_columns_stay_tensors(op):
    """The same ops on a table of tensor columns keep them tensors and
    give the numpy columns' values."""
    cols = {k: torch.as_tensor(v) for k, v in _columns().items()}
    got = _OPS[op](_table(port_core, cols))
    host = set(got.columns) if op in ("materialize", "from_pandas") else {
        "with_column_new": {"n"}, "with_column_replace": {"b"},
        "with_columns": {"n", "c"}}.get(op, set())
    for name in got.columns:
        assert isinstance(got[name], np.ndarray if name in host
                          else torch.Tensor), name
    _assert_same_table(got, _OPS[op](_table(ref_core)))


def test_table_queries_match_reference():
    got, want = _table(port_core), _table(ref_core)
    assert got.schema() == want.schema()
    assert got.partition_bounds() == want.partition_bounds()
    assert got.categorical_levels("c") == want.categorical_levels("c")
    assert got.categorical_levels("a") is want.categorical_levels("a")
    for prefix in ("a", "fresh"):
        assert got.find_unused_column_name(prefix) == \
            want.find_unused_column_name(prefix)
    assert got.to_pandas().equals(want.to_pandas())
    with pytest.raises(KeyError, match="nope"):
        got.with_column_meta("nope", x=1)
    # a tensor mask filters a numpy column, a numpy mask a tensor column
    mask = np.arange(_N) % 2 == 0
    t = port_core.Table({"n": np.arange(_N), "t": torch.arange(_N)})
    both = t.filter(torch.as_tensor(mask))
    np.testing.assert_array_equal(both["n"], np.arange(_N)[mask])
    np.testing.assert_array_equal(t.filter(mask)["t"].numpy(),
                                  np.arange(_N)[mask])


def test_shuffle_takes_a_torch_generator():
    t = _table(port_core)
    gen = torch.Generator().manual_seed(5)
    a = t.shuffle(gen)
    b = t.shuffle(torch.Generator().manual_seed(5))
    _assert_same_table(a, b)
    np.testing.assert_array_equal(np.sort(a["a"]), np.sort(t["a"]))
    train, test = t.split(0.25, seed=torch.Generator().manual_seed(1))
    assert (len(train), len(test)) == (10, 30)
    assert train.column_meta("b") == t.column_meta("b")


def _knobs(core):
    class Knobs(core.HasInputCols, core.HasScoresCol,
                core.HasScoredLabelsCol, core.HasProbabilitiesCol):
        depth = core.Param("depth", "tree depth", 5,
                           validator=core.positive)
        mode = core.Param("mode", "a or b", "a",
                          validator=core.one_of("a", "b"))
    return Knobs


def test_params_methods_match_reference():
    got_k, want_k = _knobs(port_core)(depth=3), _knobs(ref_core)(depth=3)
    for k in (got_k, want_k):
        k.set(input_cols=["u", "v"])
    assert sorted(got_k.params()) == sorted(want_k.params())
    assert got_k.params()["depth"].owner == want_k.params()["depth"].owner
    for name in ("depth", "mode", "nope"):
        assert got_k.has_param(name) == want_k.has_param(name)
    assert got_k.get("depth") == want_k.get("depth") == 3
    assert got_k.get("mode") is want_k.get("mode") is None
    assert got_k.param_map() == want_k.param_map()
    assert got_k.explain_params() == want_k.explain_params()
    for k in (got_k, want_k):
        k.clear("depth")
    assert got_k.param_map() == want_k.param_map()
    assert got_k.depth == 5
    for k in (got_k, want_k):
        with pytest.raises(ValueError, match="failed validation"):
            k.set(depth=-1)
        with pytest.raises(KeyError, match="nope"):
            k.get("nope")
    assert port_core.HasSeed().seed == ref_core.HasSeed().seed == 0


def _selector(core):
    """A column-selecting stage written against either package's core:
    stacks `input_cols` into one f32 matrix column. Private by name, so
    the reference's stage-coverage meta test (tests/test_zz_fuzz_meta.py)
    does not count this test helper as a public stage."""
    class _Select(core.Transformer, core.HasInputCols, core.HasOutputCol):
        def _transform(self, t):
            cols = [np.asarray(t[c], np.float32).reshape(len(t), -1)
                    for c in self.input_cols]
            return t.with_column(self.output_col, np.concatenate(cols, 1))
    return _Select


PortSelect = _selector(port_core)
RefSelect = _selector(ref_core)


def _pipeline_table(core, x, y):
    return core.Table({"num": x[:, :3], "color": x[:, 3], "shape": x[:, 4],
                       "label": y})


_GBDT = dict(num_iterations=5, max_depth=3, max_bin=63, min_data_in_leaf=10,
             num_tasks=1, categorical_slot_indexes=(3, 4))
_SEL = dict(input_cols=["num", "color", "shape"], output_col="features")


def test_pipeline_matches_reference():
    x, y = _cat_data(seed=11)
    got_m = port_core.Pipeline([PortSelect(**_SEL), GBDTClassifier(
        device="cpu", **_GBDT)]).fit(_pipeline_table(port_core, x, y))
    want_m = ref_core.Pipeline([RefSelect(**_SEL), RefClassifier(
        quality_profile=False, **_GBDT)]).fit(_pipeline_table(ref_core, x, y))
    assert isinstance(got_m, port_core.PipelineModel)
    got = got_m.transform(_pipeline_table(port_core, x, y))
    want = want_m(_pipeline_table(ref_core, x, y))
    assert got.columns == want.columns
    np.testing.assert_allclose(got["probabilities"], want["probabilities"],
                               **_TOL)
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    np.testing.assert_array_equal(
        got_m.get_or_default("stages")[1].booster.cat_words,
        want_m.get_or_default("stages")[1].booster.cat_words)
    assert port_core.ml_transform(_pipeline_table(port_core, x, y),
                                  got_m).columns == got.columns
    assert isinstance(port_core.ml_fit(
        _pipeline_table(port_core, x, y), port_core.Pipeline(
            [PortSelect(**_SEL)])), port_core.PipelineModel)


def _round_trip(stage, path):
    stage.save(str(path))
    loaded = port_core.PipelineStage.load(str(path))
    assert_stages_equal(stage, loaded)
    assert stages_equal(stage, loaded)
    return loaded


def _fitted(kind):
    x, y = _cat_data("regression" if kind == "regression" else "binary",
                     seed=12)
    t = port_core.Table({"features": x, "label": y,
                         "group": np.arange(len(y)) // 20})
    kw = dict(_GBDT, device="cpu")
    est = {"classification": GBDTClassifier(**kw),
           "regression": GBDTRegressor(**kw),
           "ranker": GBDTRanker(**dict(kw, categorical_slot_indexes=()))}
    return est[kind].fit(t), t


@pytest.mark.parametrize("kind", ["classification", "regression", "ranker"])
def test_gbdt_models_save_and_load(tmp_path, kind):
    model, t = _fitted(kind)
    loaded = _round_trip(model, tmp_path / "m")
    assert loaded.booster._replace() == loaded.booster
    got, want = loaded.transform(t), model.transform(t)
    for name in want.columns:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    if kind == "classification":
        np.testing.assert_array_equal(loaded.booster.cat_words,
                                      model.booster.cat_words)


def test_pipeline_model_with_stages_saves_and_loads(tmp_path):
    x, y = _cat_data(seed=13)
    t = _pipeline_table(port_core, x, y)
    model = port_core.Pipeline([PortSelect(**_SEL), GBDTClassifier(
        device=torch.device("cpu"), **_GBDT)]).fit(t)
    loaded = _round_trip(model, tmp_path / "pm")
    assert loaded.get_or_default("stages")[1].device == torch.device("cpu")
    np.testing.assert_array_equal(loaded.transform(t)["probabilities"],
                                  model.transform(t)["probabilities"])


def test_load_in_a_fresh_process(tmp_path):
    """A process that imported only the core loads a categorical GBDT
    pipeline model: the class's module is in this package, so load
    imports it."""
    x, y = _cat_data(seed=14)
    t = port_core.Table({"features": x, "label": y}).with_column_meta(
        "features", feature_names=["a", "b", "c", "color", "shape"])
    model = port_core.Pipeline([GBDTClassifier(
        device="cpu", **dict(_GBDT, categorical_slot_indexes=(),
                             categorical_slot_names=("color", "shape")))]
    ).fit(t)
    model.save(str(tmp_path / "pm"))
    np.save(tmp_path / "x.npy", x)
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from mmlspark_tpu_torch.core import PipelineModel, Table\n"
        "mod = 'mmlspark_tpu_torch.models.gbdt.estimators'\n"
        "assert mod not in sys.modules\n"
        f"m = PipelineModel.load({str(tmp_path / 'pm')!r})\n"
        "assert mod in sys.modules\n"
        f"x = np.load({str(tmp_path / 'x.npy')!r})\n"
        "out = m.transform(Table({'features': x}))\n"
        f"np.save({str(tmp_path / 'p.npy')!r}, out['probabilities'])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=_REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    np.testing.assert_array_equal(np.load(tmp_path / "p.npy"),
                                  model.transform(t)["probabilities"])


_ENC = dict(input_col="text", output_col="emb", d_model=32, n_heads=4,
            n_layers=2, d_ff=64, max_len=64, seed=3)
_DOCS = np.array(["the quick brown fox", "lazy dogs sleep all day", "",
                  "a b c d e f g"], dtype=object)


def test_encoder_saves_and_loads(tmp_path):
    enc = port_tr.TransformerSentenceEncoder(device="cpu", **_ENC)
    t = port_core.Table({"text": _DOCS})
    want = enc.transform(t)["emb"]
    loaded = _round_trip(enc, tmp_path / "enc")
    np.testing.assert_array_equal(loaded.transform(t)["emb"], want)
    # a custom tree that the architecture Params do not describe is refused
    other = port_tr.TransformerSentenceEncoder(device="cpu", **dict(
        _ENC, n_layers=1))
    other.set_params_tree(enc._ensure_params() | {"meta": {
        "n_heads": 4, "d_model": 32}})
    with pytest.raises(ValueError, match="architecture Params"):
        other.save(str(tmp_path / "bad"))


def test_encoder_state_crosses_between_packages():
    """The reference's `leaf_{i}` state (tree_flatten order) loads into
    the port's stage, and the port's into the reference's."""
    ref_enc = ref_tr.TransformerSentenceEncoder(**_ENC)
    want = ref_enc.transform(ref_core.Table({"text": _DOCS}))["emb"]
    enc = port_tr.TransformerSentenceEncoder(device="cpu",
                                             **dict(_ENC, seed=9))
    enc._set_state(ref_enc._get_state())
    got = enc.transform(port_core.Table({"text": _DOCS}))["emb"]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    back = ref_tr.TransformerSentenceEncoder(**dict(_ENC, seed=9))
    back._set_state({k: v.numpy() for k, v in enc._get_state().items()})
    np.testing.assert_allclose(
        back.transform(ref_core.Table({"text": _DOCS}))["emb"], want,
        rtol=1e-6, atol=1e-7)


class _TensorState(port_core.Model):
    """A stage whose state holds tensors of several dtypes."""
    device = port_core.Param("device", "torch device", None)

    def __init__(self, **kw):
        super().__init__(**kw)
        self.state = {}

    def _get_state(self):
        return self.state

    def _set_state(self, s):
        self.state = s


def test_tensors_keep_their_dtype(tmp_path):
    g = torch.Generator().manual_seed(0)
    stage = _TensorState(device=torch.device("cpu"))
    stage.state = {"bf16": torch.randn(4, 3, generator=g).bfloat16(),
                   "f32": torch.randn(5, generator=g),
                   "i64": torch.arange(6), "flags": torch.arange(4) > 1,
                   "host": np.arange(3.0), "note": "text"}
    loaded = _round_trip(stage, tmp_path / "s")
    for key, want in stage.state.items():
        got = loaded.state[key]
        if isinstance(want, torch.Tensor):
            assert got.dtype == want.dtype and got.device.type == "cpu"
            assert torch.equal(got, want), key
        else:
            np.testing.assert_array_equal(got, want)
    assert loaded.device == torch.device("cpu")


def test_unknown_class_raises_naming_it(tmp_path):
    for name in ("elsewhere.module.Missing",
                 "mmlspark_tpu_torch.models.gbdt.estimators.NoSuchModel"):
        os.makedirs(tmp_path / name, exist_ok=True)
        with open(tmp_path / name / "metadata.json", "w") as f:
            json.dump({"class": name, "uid": "u", "params": {}}, f)
        with pytest.raises(KeyError, match=name.replace(".", r"\.")):
            port_core.PipelineStage.load(str(tmp_path / name))
