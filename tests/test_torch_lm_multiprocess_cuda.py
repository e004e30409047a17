"""LM training over two processes on one card (gloo: NCCL refuses two
ranks on one GPU), the flash kernels on every rank.

Every test here carries the `gpu` marker and skips without a card. This
file imports neither jax nor the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_lm_multiprocess_cuda.py

At a small width with D = 64 (d_model 256, 4 heads), attention="flash",
bf16, remat="save_attn", Adam: (a) `PipelinedLMTrainer` on (data, pipe,
model, seq) = (1, 2, 2, 1), the pipe axis across the ranks, and (c) on
(1, 1, 1, 2), the ring's seq axis across them. The ranks' losses must be
equal, their replicated masters bit-identical, and their flash launches
of one step add up to the same step's in one process on a mesh of the
same shape.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.models.dnn import PipelinedLMTrainer
from mmlspark_tpu_torch.ops import flash_attention as fa
from mmlspark_tpu_torch.parallel import grid_mesh

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_AXES = ("data", "pipe", "model", "seq")
_MODEL = dict(vocab_size=512, d_model=256, n_heads=4, n_layers=4, d_ff=512,
              max_len=1024)
_TRAIN = dict(attention="flash", compute_dtype="bfloat16",
              remat="save_attn", seed=0)
# name -> (mesh shape, batch, microbatches)
_RUNS = {"a": ((1, 2, 2, 1), 2, 2), "c": ((1, 1, 1, 2), 1, 1)}
_SEQ, _STEPS = 1024, 2

_CHILD = """
import hashlib, json, os, sys
import numpy as np
import torch
sys.path.insert(0, {repo!r})
from mmlspark_tpu_torch.models.dnn import PipelinedLMTrainer
from mmlspark_tpu_torch.models.dnn.pp_training import _paths
from mmlspark_tpu_torch.ops import flash_attention as fa
from mmlspark_tpu_torch.parallel import cluster, grid_mesh

rank, rdv, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
cluster.initialize_cluster(init_method="file://" + rdv, num_processes=2,
                           process_id=rank)
assert cluster.backend_name() == "gloo"
dev = cluster.local_device()
res = {{}}
for name, (shape, batch, m) in {runs!r}.items():
    t = PipelinedLMTrainer(
        mesh=grid_mesh(shape, {axes!r},
                       devices=[dev] * (int(np.prod(shape)) // 2)),
        n_microbatches=m, **{train!r}, **{model!r})
    toks = np.random.default_rng(0).integers(
        0, {model!r}["vocab_size"], size=(batch, {seq})).astype(np.int32)
    torch.cuda.synchronize()
    fa.reset_launches()
    losses = [t.step(toks)]
    launches = dict(fa.launches)
    losses += [t.step(toks) for _ in range({steps} - 1)]
    replicas = {{f"{{key}}/{{path}}": hashlib.blake2b(
        a.detach().cpu().numpy().tobytes()).hexdigest()
        for key, tree in t._blocks.trees.items()
        if len(t._span.replicas[key]) > 1 for path, a in _paths(tree)}}
    res[name] = dict(losses=losses, launches=launches, replicas=replicas)
with open(os.path.join(out, f"res_{{rank}}.json"), "w") as f:
    json.dump(res, f)
cluster.barrier("done")
cluster.shutdown()
"""


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of both runs, from one pair of processes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tmp_path = tmp_path_factory.mktemp("lm_mp_cuda")
    script = tmp_path / "child.py"
    script.write_text(textwrap.dedent(_CHILD.format(
        repo=_REPO, runs=_RUNS, axes=_AXES, train=_TRAIN, model=_MODEL,
        seq=_SEQ, steps=_STEPS)))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp_path / "rdv"),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in (0, 1)]
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=300)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for r, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    res = []
    for r in (0, 1):
        with open(tmp_path / f"res_{r}.json") as f:
            res.append(json.load(f))
    return res


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_RUNS))
def test_two_ranks_on_one_card_train_as_one(cuda_device, ranks, name):
    got = [r[name] for r in ranks]
    assert got[0]["losses"] == got[1]["losses"]
    assert np.isfinite(got[0]["losses"]).all()
    common = got[0]["replicas"].keys() & got[1]["replicas"].keys()
    assert common
    for k in common:
        assert got[0]["replicas"][k] == got[1]["replicas"][k], k
    shape, batch, m = _RUNS[name]
    t = PipelinedLMTrainer(
        mesh=grid_mesh(shape, _AXES,
                       devices=[cuda_device] * int(np.prod(shape))),
        n_microbatches=m, **_TRAIN, **_MODEL)
    toks = np.random.default_rng(0).integers(
        0, _MODEL["vocab_size"], size=(batch, _SEQ)).astype(np.int32)
    torch.cuda.synchronize()
    fa.reset_launches()
    loss = t.step(toks)
    want = dict(fa.launches)
    assert abs(loss - got[0]["losses"][0]) <= 1e-3
    assert {k: got[0]["launches"][k] + got[1]["launches"][k]
            for k in want} == want
    assert all(any(g["launches"].values()) for g in got)
    kernel = "flash_fwd" if shape[3] == 1 else "flash_stats_fwd"
    assert want[kernel] > 0 and want["flash_bwd_dq"] > 0
