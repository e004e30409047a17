"""Port parity: GBDT checkpoint and resume (`fit_booster`'s continuation
keywords, `Callbacks`, `Booster.merge`, the estimators' `checkpoint_dir`
and `num_batches`), on the CPU.

The resume contract is the reference's (tests/test_supervisor.py): a
checkpointed fit that is stopped and resumed, in-process or by SIGTERM in
a subprocess, gives `np.array_equal` predictions and trees to an
uninterrupted checkpointed fit. Against the reference the fits run without
bagging (the two packages' draws differ, ROADMAP Queue 3 (b)) and are
held at test_torch_boosting.py's parity tolerances.
"""
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from test_torch_boosting import _COMMON, _TOL, _assert_same_model, _data
from test_torch_boosting_modes import _ranking_data

from mmlspark_tpu.core import Table as RefTable
from mmlspark_tpu.models.gbdt import GBDTRegressor as RefRegressor
from mmlspark_tpu.models.gbdt.booster import Booster as RefBooster
from mmlspark_tpu.models.gbdt.boosting import BoostParams as RefParams
from mmlspark_tpu.models.gbdt.boosting import Callbacks as RefCallbacks
from mmlspark_tpu.models.gbdt.boosting import fit_booster as ref_fit
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.models.gbdt import (Booster, BoostParams, Callbacks,
                                            GBDTRanker, GBDTRegressor,
                                            fit_booster)
from mmlspark_tpu_torch.ops.binning import apply_bins, fit_bins
from mmlspark_tpu_torch.utils.checkpoint import CheckpointManager

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _table(cls=Table, n=400):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    y = (x @ [1, -2, 0.5, 0, 3]
         + 0.05 * rng.normal(size=n)).astype(np.float32)
    return cls({"features": x, "label": y})


def _assert_bit_identical(a, b, table):
    pa = np.asarray(a.transform(table)["prediction"])
    pb = np.asarray(b.transform(table)["prediction"])
    assert np.array_equal(pa, pb)
    for field in ("split_feature", "threshold", "leaf_value"):
        assert np.array_equal(getattr(a.booster, field),
                              getattr(b.booster, field)), field


def test_gbdt_resume_scores_bit_identical(tmp_path):
    """A bagged fit stopped at its iteration-6 checkpoint and resumed to
    12 equals the uninterrupted checkpointed fit bit for bit."""
    t = _table()
    kw = dict(num_iterations=12, seed=3, bagging_fraction=0.7,
              bagging_freq=1, checkpoint_interval=3, device="cpu")
    full = GBDTRegressor(checkpoint_dir=str(tmp_path / "full"), **kw).fit(t)
    ck = str(tmp_path / "ck")
    GBDTRegressor(checkpoint_dir=ck, **{**kw, "num_iterations": 6}).fit(t)
    assert CheckpointManager(ck).all_steps() == [3, 6]
    resumed = GBDTRegressor(checkpoint_dir=ck, **kw).fit(t)
    assert resumed.booster.n_trees == 12
    _assert_bit_identical(full, resumed, t)
    # a finished fit's newest checkpoint holds every iteration: a re-fit
    # returns it without training
    again = GBDTRegressor(checkpoint_dir=ck, **kw).fit(t)
    _assert_bit_identical(full, again, t)


def test_ranker_resume_scores_bit_identical(tmp_path):
    """The lambdarank objective under checkpointing: a ranker fit stopped
    at its iteration-4 checkpoint and resumed to 8 equals the
    uninterrupted checkpointed fit bit for bit (its gradients' index_add_
    takes one add per kept row, objectives.lambdarank_grad_hess)."""
    x, y, group = _ranking_data(seed=28)
    t = Table({"features": x, "label": y, "group": group})
    kw = dict(num_iterations=8, max_depth=4, num_leaves=15, max_bin=63,
              min_data_in_leaf=10, max_position=8, seed=5,
              bagging_fraction=0.8, bagging_freq=1, checkpoint_interval=2,
              device="cpu")
    full = GBDTRanker(checkpoint_dir=str(tmp_path / "full"), **kw).fit(t)
    ck = str(tmp_path / "ck")
    GBDTRanker(checkpoint_dir=ck, **{**kw, "num_iterations": 4}).fit(t)
    resumed = GBDTRanker(checkpoint_dir=ck, **kw).fit(t)
    assert resumed.booster.n_trees == 8
    _assert_bit_identical(full, resumed, t)


def test_fit_booster_legacy_checkpoint_fn_signature():
    """A callback of the signature before margins (it, booster, base,
    final=False) keeps working; an extended one gets the live margin."""
    t = _table()
    x = np.asarray(t["features"])
    y = np.asarray(t["label"])
    seen, margins = [], []

    def legacy_ck(it, booster, base, final=False):
        seen.append((it, bool(final), booster.n_trees))

    def ck(it, booster, base, final=False, margin=None, rng_key=None):
        margins.append((it, margin, rng_key))

    p = BoostParams(num_iterations=4, seed=0, objective="regression")
    fit_booster(x, y, p, checkpoint_fn=legacy_ck, checkpoint_interval=2,
                device="cpu")
    assert seen == [(2, False, 2), (4, False, 4)]
    b, base, _ = fit_booster(x, y, p, checkpoint_fn=ck,
                             checkpoint_interval=2, device="cpu")
    assert [m[0] for m in margins] == [2, 4]
    assert all(isinstance(m[1], np.ndarray) and m[1].shape == (len(y),)
               and m[2] is None for m in margins)
    # the live margin of the last checkpoint is the model's score
    np.testing.assert_allclose(margins[-1][1],
                               b.raw_score(x, base)[:, 0], rtol=1e-5,
                               atol=1e-5)


_SUBPROC = """
import os, signal, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.models.gbdt import GBDTRegressor
from mmlspark_tpu_torch.utils.checkpoint import CheckpointManager

phase, ckdir, outfile = sys.argv[1], sys.argv[2], sys.argv[3]
rng = np.random.default_rng(0)
x = rng.normal(size=(300, 5)).astype(np.float32)
y = (x @ [1, -2, 0.5, 0, 3] + 0.05 * rng.normal(size=300)).astype(np.float32)
t = Table({{"features": x, "label": y}})

if phase == "kill":
    # SIGTERM this process right after the second periodic checkpoint:
    # a kill mid-boosting at a known point
    orig = CheckpointManager.save
    def save(self, step, payload, prune_newer=False):
        orig(self, step, payload, prune_newer=prune_newer)
        if step >= 6 and not payload.get("final"):
            os.kill(os.getpid(), signal.SIGTERM)
    CheckpointManager.save = save

model = GBDTRegressor(num_iterations=12, seed=3, bagging_fraction=0.7,
                      bagging_freq=1, checkpoint_interval=3,
                      checkpoint_async=False, checkpoint_dir=ckdir,
                      device="cpu").fit(t)
np.savez(outfile, scores=np.asarray(model.transform(t)["prediction"]),
         leaves=model.booster.leaf_value, n_trees=model.booster.n_trees)
print("DONE", model.booster.n_trees)
"""


def test_gbdt_sigterm_subprocess_kill_resume(tmp_path):
    """A subprocess fit SIGTERMed right after its iteration-6 checkpoint,
    resumed by a fresh process, equals an uninterrupted subprocess fit
    bit for bit."""
    script = tmp_path / "gbdt_fit.py"
    script.write_text(textwrap.dedent(_SUBPROC.format(repo=_REPO)))

    def run(phase, ckdir, out):
        return subprocess.run(
            [sys.executable, str(script), phase, ckdir, out],
            capture_output=True, text=True, timeout=300)

    full = run("full", str(tmp_path / "ck_full"), str(tmp_path / "f.npz"))
    assert full.returncode == 0, full.stdout + full.stderr
    killed = run("kill", str(tmp_path / "ck"), str(tmp_path / "k.npz"))
    assert killed.returncode == -signal.SIGTERM, (killed.returncode,
                                                  killed.stderr[-500:])
    assert CheckpointManager(str(tmp_path / "ck")).all_steps() == [3, 6]
    resumed = run("resume", str(tmp_path / "ck"), str(tmp_path / "r.npz"))
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    f, r = np.load(tmp_path / "f.npz"), np.load(tmp_path / "r.npz")
    assert int(r["n_trees"]) == 12
    assert np.array_equal(f["scores"], r["scores"])
    assert np.array_equal(f["leaves"], r["leaves"])


def _reg_kw():
    # num_tasks=1: the single-device reference (the test session's 8
    # virtual CPU devices would shard its fit)
    return dict(num_iterations=8, max_depth=4, num_leaves=15, max_bin=63,
                min_data_in_leaf=20, checkpoint_interval=3, seed=0,
                num_tasks=1)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_resume_matches_reference(tmp_path, writer):
    """A fit stopped at 4 of 8 iterations and resumed, without bagging,
    against the reference's uninterrupted fit: the same trees at the
    parity tolerances. The first half is written by the port, or by the
    reference (its checkpoint carries a threefry `rng_key`, which the
    port does not use: its draws come from (seed, iteration))."""
    x, y = _data("regression")
    ck = str(tmp_path / "ck")
    first = {**_reg_kw(), "num_iterations": 4}
    if writer == "port":
        GBDTRegressor(checkpoint_dir=ck, device="cpu", **first).fit(
            Table({"features": x, "label": y}))
    else:
        RefRegressor(checkpoint_dir=ck, **first).fit(
            RefTable({"features": x, "label": y}))
        assert "rng_key" in CheckpointManager(ck).restore()
    got = GBDTRegressor(checkpoint_dir=ck, device="cpu", **_reg_kw()).fit(
        Table({"features": x, "label": y})).booster
    want = RefRegressor(**_reg_kw()).fit(
        RefTable({"features": x, "label": y})).booster
    assert got.n_trees == want.n_trees == 8
    _assert_same_model(got, want, apply_bins(fit_bins(x, max_bin=63, seed=0),
                                             x))


def _trees(b, trees):
    """`b` cut to the trees `trees` (a slice)."""
    return b._replace(**{f: getattr(b, f)[trees] for f in (
        "split_feature", "threshold", "split_bin", "leaf_value",
        "tree_class")}, best_iteration=-1)


def test_num_batches_matches_reference():
    """Batch continuation: two row batches, the second's trees fitting the
    first's residuals, against the reference's."""
    x, y = _data("regression")
    kw = {**_reg_kw(), "num_batches": 2}
    del kw["checkpoint_interval"]
    got = GBDTRegressor(device="cpu", **kw).fit(
        Table({"features": x, "label": y}))
    want = RefRegressor(**kw).fit(RefTable({"features": x, "label": y}))
    assert got.booster.n_trees == want.booster.n_trees == 16
    # each batch bins its own rows: its trees' ties are read on its bins
    for rows, trees in zip(np.array_split(np.arange(len(x)), 2),
                           (slice(0, 8), slice(8, 16))):
        _assert_same_model(*(_trees(b.booster, trees) for b in (got, want)),
                           apply_bins(fit_bins(x[rows], max_bin=63, seed=0),
                                      x[rows]))
    np.testing.assert_allclose(
        np.asarray(got.transform(Table({"features": x}))["prediction"]),
        np.asarray(want.transform(RefTable({"features": x}))["prediction"]),
        **_TOL)


def test_learning_rate_schedule_and_hooks_match_reference():
    """`Callbacks`: a decaying learning rate and the before/after hooks,
    called as the reference calls them."""
    x, y = _data("binary")
    vx, vy = _data("binary", n=500, seed=9)
    kw = dict(_COMMON, objective="binary", early_stopping_round=50)
    logs = {}

    def callbacks(cls, tag):
        log = logs.setdefault(tag, [])
        return cls(before_iteration=lambda it: log.append(("before", it)),
                   after_iteration=lambda it, m: log.append(
                       ("after", it, round(m, 4))),
                   get_learning_rate=lambda it: 0.3 * 0.8 ** it)
    want, _, _ = ref_fit(x, y, RefParams(**kw), valid=(vx, vy),
                         callbacks=callbacks(RefCallbacks, "ref"))
    got, _, _ = fit_booster(x, y, BoostParams(**kw), valid=(vx, vy),
                            callbacks=callbacks(Callbacks, "port"),
                            device="cpu")
    _assert_same_model(got, want, apply_bins(fit_bins(x, max_bin=63, seed=0),
                                             x))
    assert logs["port"] == logs["ref"]
    assert len(logs["port"]) == 2 * kw["num_iterations"]


def _cat_booster(cls, fit, params, width):
    """A small fit with one categorical column of `width` bins' ids."""
    rng = np.random.default_rng(width)
    x = rng.normal(size=(600, 3)).astype(np.float32)
    x[:, 2] = rng.integers(0, 12, size=600)
    y = (x[:, 0] + (x[:, 2] % 3 == 0) > 0.5).astype(np.float32)
    b, _, _ = fit(x, y, params(num_iterations=2, max_bin=width - 1,
                               categorical_features=(2,),
                               min_data_in_leaf=5, max_depth=3))
    return b


def test_booster_merge_matches_reference():
    """`merge`, numeric (different depths) and categorical (equal widths,
    and a numeric side widened), against the reference's, and the
    refusal to widen a categorical side's words."""
    x, y = _data("binary", n=500)

    def ref_and_port(**kw):
        b = ref_fit(x, y, RefParams(objective="binary", max_bin=63,
                                    **kw))[0]
        return b, Booster.load_model_string(b.save_model_string())
    ra, pa = ref_and_port(num_iterations=2, max_depth=3)
    rb, pb = ref_and_port(num_iterations=3, max_depth=5,
                          early_stopping_round=2)
    rb = rb._replace(best_iteration=1)
    pb = pb._replace(best_iteration=1)
    want, got = ra.merge(rb), pa.merge(pb)
    for field in Booster._fields:
        w, g = getattr(want, field), getattr(got, field)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=field)
        else:
            assert g == w, field
    assert got.n_trees == 5 and got.max_depth == 5
    assert got.best_iteration == 2 + 1

    def port_fit(x_, y_, p):
        return fit_booster(x_, y_, p, device="cpu")
    for params_cls, fit, bcls in ((RefParams, ref_fit, RefBooster),
                                  (BoostParams, port_fit, Booster)):
        c64 = _cat_booster(bcls, fit, params_cls, 64)
        c16 = _cat_booster(bcls, fit, params_cls, 16)
        assert c64.cat_words.shape[2] == 4 and c16.cat_words.shape[2] == 1
        both = c64.merge(c64)
        assert both.n_trees == 4 and both.cat_words.shape[2] == 4
        with pytest.raises(ValueError, match="categorical bin widths"):
            c64.merge(c16)
    # a numeric side merges with a categorical one: its words widen
    ref_cat = _cat_booster(RefBooster, ref_fit, RefParams, 64)
    port_cat = Booster.load_model_string(ref_cat.save_model_string())
    num = fit_booster(_data("binary", n=300, f=3)[0],
                      _data("binary", n=300, f=3)[1],
                      BoostParams(num_iterations=1, max_bin=63,
                                  max_depth=3), device="cpu")[0]
    ref_num = RefBooster.load_model_string(num.save_model_string())
    got, want = num.merge(port_cat), ref_num.merge(ref_cat)
    for field in ("split_feature", "split_is_cat", "cat_words",
                  "leaf_value"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


def test_rf_resume_rescales_restored_trees(tmp_path):
    """rf leaves carry 1/total weights: a 4-tree forest extended to 8
    from its checkpoint halves the restored trees' leaves, and the new
    trees take 1/8 too."""
    t = _table()
    kw = dict(boosting="rf", bagging_fraction=0.7, bagging_freq=1,
              checkpoint_interval=2, seed=1, device="cpu")
    ck = str(tmp_path / "ck")
    four = GBDTRegressor(checkpoint_dir=ck, num_iterations=4, **kw).fit(t)
    assert int(CheckpointManager(ck).restore()["rf_denom"]) == 4
    eight = GBDTRegressor(checkpoint_dir=ck, num_iterations=8, **kw).fit(t)
    assert eight.booster.n_trees == 8
    np.testing.assert_array_equal(eight.booster.leaf_value[:4],
                                  (four.booster.leaf_value * 0.5)
                                  .astype(np.float32))
    np.testing.assert_array_equal(eight.booster.split_feature[:4],
                                  four.booster.split_feature)
    # an 8-tree forest's leaves are 1/8 of a tree's output: the new trees'
    # magnitudes are those of the rescaled old ones, not twice them
    old = np.abs(eight.booster.leaf_value[:4]).max()
    new = np.abs(eight.booster.leaf_value[4:]).max()
    assert 0.5 < new / old < 2.0


def test_early_stop_checkpoint_is_final(tmp_path):
    """An early stop writes the truncated model as a final checkpoint,
    pruning any later step; a re-fit returns it without training."""
    t = _table()
    ind = np.zeros(len(t), bool)
    ind[::4] = True
    t = t.with_column("val", ind)
    ck = str(tmp_path / "es")
    kw = dict(num_iterations=300, early_stopping_round=4, seed=8,
              validation_indicator_col="val", checkpoint_dir=ck,
              checkpoint_interval=7, device="cpu")
    first = GBDTRegressor(**kw).fit(t)
    assert first.booster.n_trees < 300
    payload = CheckpointManager(ck).restore()
    assert payload["final"] is True
    assert int(payload["iteration"]) == first.booster.n_trees
    again = GBDTRegressor(**kw).fit(t)
    assert again.booster.n_trees == first.booster.n_trees
    assert np.array_equal(again.booster.leaf_value, first.booster.leaf_value)
