"""A GBDT fit over two processes on one card (gloo: NCCL refuses two ranks
on one GPU), each rank one position of a data axis that spans them.

Every test here carries the `gpu` marker and skips without a card. This
file imports neither jax nor the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gbdt_multiprocess_cuda.py

The ranks' boosters must be bit-identical, and under fixed order equal
to the one-process fit over a mesh of the same two positions; each rank
launches the histogram kernel once a level (`hist_tiled`, or
`hist_tiled_fixed` and its leaf sums).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.models.gbdt import (BoostParams, Booster,
                                            fit_booster_distributed)
from mmlspark_tpu_torch.parallel import data_mesh

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PARAMS = dict(objective="binary", num_iterations=4, max_depth=4,
               num_leaves=15, max_bin=63)
_N = 200_001          # ragged: one padding row on rank 1

_CHILD = """
import json, os, sys
import numpy as np
import torch
sys.path.insert(0, {repo!r})
from mmlspark_tpu_torch.models.gbdt import BoostParams, fit_booster_distributed
from mmlspark_tpu_torch.ops import histogram_cuda as hc
from mmlspark_tpu_torch.parallel import cluster, data_mesh

rank, rdv, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
cluster.initialize_cluster(init_method="file://" + rdv, num_processes=2,
                           process_id=rank)
assert cluster.backend_name() == "gloo"
x = np.load(os.path.join(out, "x.npy"))
y = np.load(os.path.join(out, "y.npy"))
mesh = data_mesh()
assert mesh.shape["data"] == 2 and mesh.devices[0].type == "cuda"
p = BoostParams(**{params!r})
res = {{}}
for name, kw in (("default", {{}}),
                 ("fixed", dict(checkpoint_fn=lambda *a, **k: None))):
    hc.reset_launches()
    b, base, _ = fit_booster_distributed(x, y, p, mesh=mesh, **kw)
    torch.cuda.synchronize()
    res[name] = {{k: v for k, v in hc.launches.items() if v}}
    np.savez(os.path.join(out, f"{{name}}_{{rank}}.npz"), base=base,
             **b.to_dict())
with open(os.path.join(out, f"launches_{{rank}}.json"), "w") as f:
    json.dump(res, f)
cluster.barrier("done")
cluster.shutdown()
"""


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _data(n=_N, f=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    z = x @ rng.normal(size=f) + 0.5 * x[:, 0] * x[:, 1]
    return x, (z + 0.3 * rng.normal(size=n) > 0).astype(np.float32)


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


@pytest.mark.gpu
def test_two_ranks_on_one_card_fit_one_booster(cuda_device, tmp_path):
    x, y = _data()
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "y.npy", y)
    script = tmp_path / "child.py"
    script.write_text(textwrap.dedent(_CHILD.format(repo=_REPO,
                                                    params=_PARAMS)))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp_path / "rdv"),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in (0, 1)]
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
    levels = _PARAMS["num_iterations"] * _PARAMS["max_depth"]
    for r in (0, 1):
        with open(tmp_path / f"launches_{r}.json") as f:
            launches = json.load(f)
        assert launches["default"] == {"hist_tiled": levels}, launches
        # fixed order: the levels and one leaf-sum launch a tree
        assert launches["fixed"] == {
            "hist_tiled_fixed": levels + _PARAMS["num_iterations"]}, launches
    for name in ("default", "fixed"):
        (b0, base0), (b1, base1) = [_load(tmp_path / f"{name}_{r}.npz")
                                    for r in (0, 1)]
        assert base0 == base1
        _same_bits(b0, b1, name)
    want, want_base, _ = fit_booster_distributed(
        x, y, BoostParams(**_PARAMS),
        mesh=data_mesh(devices=[cuda_device] * 2),
        checkpoint_fn=lambda *a, **k: None)
    got, got_base = _load(tmp_path / "fixed_0.npz")
    assert got_base == want_base
    _same_bits(got, want, "fixed against the one-process mesh")
