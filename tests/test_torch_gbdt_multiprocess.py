"""GBDT over two real processes on the CPU: `parallel.cluster` on
`torch.distributed` (gloo, a `file://` rendezvous in `tmp_path`), a data
axis of two positions that spans the processes, one position each.

Every fit runs in both child processes; the test process holds their
boosters against each other, against the one-process fit over a mesh of
the same two positions (`data_mesh(devices=["cpu"] * 2)`), and against
the JAX reference's `fit_booster_distributed` over two of conftest's
virtual CPU devices, at `tests/test_torch_gbdt_distributed.py`'s
tolerances:

- (i) the booster is bit-identical on both ranks, in every fit;
- (ii) under fixed order (`checkpoint_fn`) it is bit-identical to the
  one-process two-position fit: whole-table data-parallel, voting with
  a ragged row count, goss with feature_fraction, and the
  regression_l1 renewal with a validation set and early stopping;
- (iii) the default fit matches the reference's;
- (iv) the scale-out form (`local_rows=True`, each process binning only
  its `process_row_range` with the leader's broadcast mapper) gives equal
  boosters on both ranks and the whole-table fit's split features with
  margins within ROADMAP Queue 3 (e)'s tolerances;
- lambdarank groups that straddle the processes raise.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from test_torch_boosting import _assert_same_model, _data

from mmlspark_tpu.models.gbdt.boosting import BoostParams as RefParams
from mmlspark_tpu.models.gbdt.distributed import (
    fit_booster_distributed as ref_fit_dist)
from mmlspark_tpu_torch import parallel
from mmlspark_tpu_torch.models.gbdt import (BoostParams, Booster,
                                            fit_booster,
                                            fit_booster_distributed)
from mmlspark_tpu_torch.ops.binning import apply_bins, fit_bins

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOL = dict(rtol=1e-4, atol=1e-4)
_COMMON = dict(num_iterations=4, max_depth=3, num_leaves=7, max_bin=63,
               min_data_in_leaf=10)

# name -> (data (objective, n, seed), params, fit keywords); the child
# builds a no-op checkpoint_fn for "fixed"
FITS = {
    "default": (("binary", 1000, 1), {}, {}),
    "fixed": (("binary", 1000, 1), {}, dict(fixed=True)),
    "ragged_fixed": (("binary", 1003, 2), {}, dict(fixed=True)),
    "voting_ragged": (("binary", 1003, 3), {},
                      dict(fixed=True, parallelism="voting_parallel",
                           top_k=2)),
    "goss_ff": (("binary", 1000, 4),
                dict(boosting="goss", feature_fraction=0.6),
                dict(fixed=True)),
    "l1_valid": (("regression", 1001, 5),
                 dict(objective="regression_l1", num_iterations=8,
                      early_stopping_round=2),
                 dict(fixed=True, valid=True)),
}

_CHILD = """
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
FITS, _COMMON = {fits!r}, {common!r}


def _data(objective, n, f, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    z = x @ rng.normal(size=f) + 0.3 * rng.normal(size=n)
    y = (z > 0) if objective == "binary" else z
    return x, y.astype(np.float32)


def _fit_data(objective, n, seed, with_valid=False):
    x, y = _data(objective, n, 6, seed)
    valid = _data(objective, 301, 6, seed + 100) if with_valid else None
    return x, y, valid


from mmlspark_tpu_torch.models.gbdt import BoostParams, fit_booster_distributed
from mmlspark_tpu_torch.ops.binning import apply_bins, fit_bins
from mmlspark_tpu_torch.parallel import cluster, data_mesh

pid, rdv, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
info = cluster.initialize_cluster(init_method="file://" + rdv,
                                  num_processes=2, process_id=pid)
assert info.process_count == 2 and cluster.backend_name() == "gloo", info
mesh = data_mesh(devices=["cpu"])
assert mesh.shape["data"] == 2 and mesh.local_positions == 1

def save(name, booster, base):
    np.savez(os.path.join(out, f"{{name}}_{{pid}}.npz"), base=base,
             **booster.to_dict())

for name, (data, params, kw) in FITS.items():
    x, y, valid = _fit_data(*data, with_valid=kw.get("valid", False))
    kw = {{k: v for k, v in kw.items() if k not in ("fixed", "valid")}}
    if FITS[name][2].get("fixed"):
        kw["checkpoint_fn"] = lambda *a, **k: None
    p = BoostParams(**dict(_COMMON, **params))
    b, base, _ = fit_booster_distributed(x, y, p, mesh=mesh, valid=valid,
                                         **kw)
    save(name, b, base)

# the scale-out form: this process's rows only, the leader's mapper
x, y, _ = _fit_data("binary", 1003, 2)
p = BoostParams(**_COMMON)
lo, hi = cluster.process_row_range(len(y))
mapper = cluster.broadcast_from_leader(
    fit_bins(np.pad(x, ((0, 1), (0, 0))), max_bin=p.max_bin, seed=p.seed)
    if pid == 0 else None)
b, base, _ = fit_booster_distributed(
    x[lo:hi], y[lo:hi], p, mesh=mesh, local_rows=True,
    prebinned=(mapper, apply_bins(mapper, x[lo:hi]), y[lo:hi]))
save("scale_out", b, base)

# a plain fit in a rank runs on its own process's rows, as the
# reference's test_multiprocess runs one beside the distributed fit
from mmlspark_tpu_torch.models.gbdt import fit_booster
b, base, _ = fit_booster(x, y, p, device="cpu")
save("plain", b, base)

# lambdarank groups that straddle the processes
try:
    fit_booster_distributed(
        x, y, BoostParams(**dict(_COMMON, objective="lambdarank")),
        mesh=mesh, group=np.arange(len(y)) // 7)
    straddle = "no error"
except ValueError as e:
    straddle = str(e)
with open(os.path.join(out, f"straddle_{{pid}}.txt"), "w") as f:
    f.write(straddle)
cluster.barrier("done")
cluster.shutdown()
"""


def _fit_data(objective, n, seed, with_valid=False):
    """The child's data (`_CHILD` keeps a copy of this and of
    `test_torch_boosting._data`, so that the children import no JAX)."""
    x, y = _data(objective, n=n, f=6, seed=seed)
    valid = None
    if with_valid:
        valid = _data(objective, n=301, f=6, seed=seed + 100)
    return x, y, valid


def _load(path):
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    return Booster.from_dict(d), float(d["base"])


def _same_bits(a, b, what):
    for f in a._fields:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f"{what}: {f}")
        else:
            assert va == vb, (what, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run both children once; {name: [(booster, base) of rank 0, of
    rank 1]} and the straddle errors."""
    tmp = tmp_path_factory.mktemp("gbdt_mp")
    script = tmp / "child.py"
    script.write_text(textwrap.dedent(_CHILD.format(
        repo=_REPO, fits=FITS, common=_COMMON)))
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp / "rdv"), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in (0, 1)]
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=240)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for r, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    fits = {name: [_load(tmp / f"{name}_{r}.npz") for r in (0, 1)]
            for name in list(FITS) + ["scale_out", "plain"]}
    straddle = [(tmp / f"straddle_{r}.txt").read_text() for r in (0, 1)]
    return fits, straddle


def _one_process(name):
    data, params, kw = FITS[name]
    x, y, valid = _fit_data(*data, with_valid=kw.get("valid", False))
    fit_kw = {k: v for k, v in kw.items() if k not in ("fixed", "valid")}
    if kw.get("fixed"):
        fit_kw["checkpoint_fn"] = lambda *a, **k: None
    return fit_booster_distributed(
        x, y, BoostParams(**dict(_COMMON, **params)), valid=valid,
        mesh=parallel.data_mesh(devices=["cpu"] * 2), **fit_kw)


@pytest.mark.parametrize("name", list(FITS) + ["scale_out"])
def test_booster_is_bit_identical_on_both_ranks(ranks, name):
    (b0, base0), (b1, base1) = ranks[0][name]
    assert base0 == base1
    _same_bits(b0, b1, name)


@pytest.mark.parametrize("name", [n for n, f in FITS.items()
                                  if f[2].get("fixed")])
def test_fixed_order_equals_the_one_process_mesh_bit_for_bit(ranks, name):
    got, got_base = ranks[0][name][0]
    want, want_base, _ = _one_process(name)
    assert got_base == want_base
    _same_bits(got, want, name)
    assert got.n_trees >= 1


@pytest.mark.parametrize("name", ["default", "voting_ragged"])
def test_two_process_fit_matches_the_reference(ranks, name):
    """The JAX reference's two-position fit, held as
    tests/test_torch_gbdt_distributed.py holds the one-process mesh
    fit."""
    data, params, kw = FITS[name]
    x, y, _ = _fit_data(*data)
    got, got_base = ranks[0][name][0]
    ref_kw = {k: v for k, v in kw.items() if k in ("parallelism", "top_k")}
    ref, ref_base, _ = ref_fit_dist(x, y, RefParams(**dict(_COMMON,
                                                           **params)),
                                    num_tasks=2, **ref_kw)
    np.testing.assert_allclose(got_base, ref_base, rtol=1e-12)
    bins = apply_bins(fit_bins(x, max_bin=_COMMON["max_bin"], seed=0), x)
    _assert_same_model(got, ref, bins)
    np.testing.assert_allclose(
        got.raw_score(x, got_base, backend="host")[:, 0],
        ref.raw_score(x, ref_base, backend="host")[:, 0], **_TOL)


def test_scale_out_form_matches_the_whole_table_fit(ranks):
    """Queue 3 (e): equal split features, margins within 1e-4 for 99.9%
    of the rows and logloss within 1e-4 of the whole-table fit."""
    got, got_base = ranks[0]["scale_out"][0]
    x, y, _ = _fit_data("binary", 1003, 2)
    want, want_base, _ = fit_booster_distributed(
        x, y, BoostParams(**_COMMON),
        mesh=parallel.data_mesh(devices=["cpu"] * 2))
    np.testing.assert_array_equal(got.split_feature, want.split_feature)
    a = got.raw_score(x, got_base, backend="host")[:, 0]
    b = want.raw_score(x, want_base, backend="host")[:, 0]
    assert np.mean(np.abs(a - b) <= 1e-4) >= 0.999

    def logloss(m):
        pr = np.clip(1 / (1 + np.exp(-m)), 1e-15, 1 - 1e-15)
        return -np.mean(y * np.log(pr) + (1 - y) * np.log(1 - pr))
    assert abs(logloss(a) - logloss(b)) <= 1e-4


def test_plain_fit_in_a_rank_stays_in_its_process(ranks):
    """`fit_booster` without a mesh fits this process's rows alone in a
    multi-process job: each rank's equals the fit in this process."""
    x, y, _ = _fit_data("binary", 1003, 2)
    want, want_base, _ = fit_booster(x, y, BoostParams(**_COMMON),
                                     device="cpu")
    for got, got_base in ranks[0]["plain"]:
        assert got_base == want_base
        _same_bits(got, want, "plain fit")


def test_straddling_lambdarank_groups_raise(ranks):
    for msg in ranks[1]:
        assert "straddles processes" in msg, msg
