"""LM training over two real processes on the CPU: both trainers and
ring attention over a mesh that spans the processes (`parallel.cluster`
on `torch.distributed`, gloo, a `file://` rendezvous in `tmp_path`), two
CPU positions a process.

One pair of child processes trains every configuration of `RUNS` and
writes, per rank, its losses, the full parameters (`params`, a
collective) and its replicated masters; the test process holds them
against each other, against the one-process port trainer on the same
mesh shape, and against the JAX trainer on conftest's virtual CPU
devices, at `tests/test_torch_lm_training_pp.py`'s tolerances:

- (i) `PipelinedLMTrainer` on (data, pipe, model) = (1, 2, 2), the pipe
  axis across the processes: equal losses on both ranks, a falling loss,
  replicated masters (the tied embedding's two replicas) bit-identical;
  Adam losses within 1e-5 of the one-process trainer and of the JAX
  trainer, SGD deltas within 1e-4 of each leaf's max |delta|, bf16
  (flash, remat="save_attn") losses within 1e-3. The model axis across
  the processes, (1, 1, 2, 1) with both remat forms, and the data axis,
  (2, 1, 1, 1), the same way.
- (ii) `ShardedLMTrainer` on (data, model) = (2, 2), data across the
  processes: against mesh=None and the JAX trainer at rtol 2e-4, atol
  2e-5; `run_stream` without a checkpoint directory trains over them.
- (iii) the seq axis across the processes, (1, 1, 1, 2), dense and
  flash: the one-process ring's SGD deltas; the public `ring_attention`
  and `ulysses_attention` across the processes give the one-process
  output bit for bit, and the ring's input gradients, each rank holding
  the rows of its own positions, sum to the one-process gradients bit
  for bit.
- (iv) a checkpoint saved by the 2-process trainer restores into a
  one-process trainer of the same mesh and into a 2-process trainer of
  another seed, each continuing within rtol 1e-6.
- (v) `run_stream(checkpoint_dir=...)` over processes raises
  NotImplementedError; a grid that does not split over the processes
  raises ValueError; the step's messages and sums are counted by
  primitive; a step keeps a received message only inside a checkpointed
  region, until its recompute; a job whose group is NCCL's sends its
  messages over a gloo group of their own; a trainer over processes is
  freed, after a step, as soon as its last reference goes.

A second group of four processes (`RUNS4`) puts the pipe and model axes
both across processes, the ring over four processes, and data x pipe;
the mesh's process-major layout and the message tags are also checked
without processes.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.dnn.lm_training import \
    ShardedLMTrainer as JaxShardedLMTrainer
from mmlspark_tpu.models.dnn.pp_training import \
    PipelinedLMTrainer as JaxPipelinedLMTrainer
from mmlspark_tpu.parallel import grid_mesh as jax_grid_mesh
from mmlspark_tpu_torch.models.dnn import (PipelinedLMTrainer,
                                           ShardedLMTrainer,
                                           params_to_numpy)
from mmlspark_tpu_torch.parallel import Mesh, data_mesh, grid_mesh
from mmlspark_tpu_torch.parallel.cluster import MessageTags
from mmlspark_tpu_torch.parallel.ring_attention import (ring_attention,
                                                        ulysses_attention)

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_AXES = ("data", "pipe", "model", "seq")
_MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
              max_len=32)
_SGD = dict(optimizer="sgd", lr=1.0)

# name -> (trainer, mesh shape over _AXES (data, model for "sharded"),
# keywords, steps, token shape); the reference's shapes: (4, 32) for the
# pipelined trainer, (8, 16) for the sharded one
RUNS = {
    "pipe_adam": ("pipelined", (1, 2, 2, 1), {}, 2, (4, 32)),
    "pipe_sgd": ("pipelined", (1, 2, 2, 1), _SGD, 2, (4, 32)),
    "pipe_bf16": ("pipelined", (1, 2, 2, 1),
                  dict(attention="flash", compute_dtype="bfloat16",
                       remat="save_attn"), 3, (4, 32)),
    "model_sgd": ("pipelined", (1, 1, 2, 1), dict(_SGD, remat="save_attn"),
                  2, (4, 32)),
    "model_full_remat": ("pipelined", (1, 1, 2, 1), dict(_SGD, remat="full"),
                         2, (4, 32)),
    "data_sgd": ("pipelined", (2, 1, 1, 1), _SGD, 2, (4, 32)),
    "seq_dense": ("pipelined", (1, 1, 1, 2), _SGD, 2, (4, 32)),
    "seq_flash": ("pipelined", (1, 1, 1, 2), dict(_SGD, attention="flash"),
                  2, (4, 32)),
    "sharded": ("sharded", (2, 2), {}, 3, (8, 16)),
}

# the runs whose trainer must be freed without the collector: the seq,
# model and pipe axes across the processes, and the sharded trainer
_FREED = ["seq_dense", "model_sgd", "pipe_bf16", "sharded"]

_CHILD = """
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
from mmlspark_tpu_torch.models.dnn import (PipelinedLMTrainer,
                                           ShardedLMTrainer, params_to_numpy)
from mmlspark_tpu_torch.parallel import cluster, data_mesh, grid_mesh
from mmlspark_tpu_torch.parallel.ring_attention import (ring_attention,
                                                        ulysses_attention)

RUNS, MODEL, AXES, PROCS = {runs!r}, {model!r}, {axes!r}, {procs}
FREED = {freed!r}
rank, rdv, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
info = cluster.initialize_cluster(init_method="file://" + rdv,
                                  num_processes=PROCS, process_id=rank)
assert info.process_count == PROCS and cluster.backend_name() == "gloo"


def tokens(shape):
    return np.random.default_rng(0).integers(
        0, MODEL["vocab_size"], size=shape).astype(np.int32)


def trainer(kind, shape, kw, seed=0):
    devices = ["cpu"] * (int(np.prod(shape)) // PROCS)
    if kind == "sharded":
        return ShardedLMTrainer(mesh=grid_mesh(shape, devices=devices),
                                seed=seed, **MODEL)
    return PipelinedLMTrainer(mesh=grid_mesh(shape, AXES, devices=devices),
                              n_microbatches=2, seed=seed, **kw, **MODEL)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], f"{{prefix}}|{{k}}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flat(v, f"{{prefix}}|{{i}}")
    else:
        yield prefix, np.asarray(tree)


def replicas(t):
    # this rank's masters of every key that another process holds too
    span = t._span
    return {{f"{{key}}{{name}}": a for key, tree in t._blocks.trees.items()
             if len(span.replicas[key]) > 1
             for name, a in flat(params_to_numpy(tree))}}


# every step's messages: received, kept for a recompute, and still kept
# at the step's end (no recompute took them)
counts = dict(received=0, kept=0, left=0)
real_keep, real_finish = cluster.Link._keep, cluster.Link.finish


def spy_keep(self, tag, tensor):
    real_keep(self, tag, tensor)
    counts["received"] += 1
    counts["kept"] += tag in self._kept


def spy_finish(self):
    counts["left"] += len(self._kept)
    real_finish(self)


cluster.Link._keep, cluster.Link.finish = spy_keep, spy_finish

res = {{}}
for name, (kind, shape, kw, steps, tshape) in RUNS.items():
    t = trainer(kind, shape, kw)
    toks = tokens(tshape)
    counts.update(received=0, kept=0, left=0)
    losses = [t.step(toks) for _ in range(steps)]
    res[name + "_messages"] = dict(counts)
    np.savez(os.path.join(out, f"{{name}}_params_{{rank}}.npz"),
             **dict(flat(params_to_numpy(t.params))))
    np.savez(os.path.join(out, f"{{name}}_replicas_{{rank}}.npz"),
             **replicas(t))
    res[name] = dict(losses=losses)
    if name == "pipe_adam":
        res["stats"] = t.mesh.exchange.stats()["primitives"]
"""

# the two-process group's other checks
_EXTRAS = """
# (iv) checkpoints: saved after two steps, two more steps; a 2-process
# trainer of another seed restores and takes the same two steps
for name, kind, shape, tshape in (
        ("ckpt_pipe", "pipelined", (1, 2, 2, 1), (4, 32)),
        ("ckpt_sharded", "sharded", (2, 2), (8, 16))):
    toks = tokens(tshape)
    t = trainer(kind, shape, {{}})
    t.step(toks)
    t.step(toks)
    t.save_checkpoint(os.path.join(out, name), step=2)
    nxt = [t.step(toks) for _ in range(2)]
    again = trainer(kind, shape, {{}}, seed=9)
    step = again.restore_checkpoint(os.path.join(out, name))
    res[name] = dict(next=nxt, step=step,
                     restored=[again.step(toks) for _ in range(2)])
res["position_wq"] = list(trainer("pipelined", (1, 2, 2, 1), {{}})
                          .position_params(pipe=1, model=1)["wq"].shape)

# (ii) run_stream over processes: a plain stream trains, a supervised one
# is refused
s = trainer("sharded", (2, 2), {{}})
res["stream"] = s.run_stream([tokens((8, 16))] * 2)
try:
    s.run_stream([tokens((8, 16))], checkpoint_dir=os.path.join(out, "sup"))
    res["stream_refused"] = ""
except NotImplementedError as e:
    res["stream_refused"] = str(e)
try:
    grid_mesh((3, 1), devices=["cpu"] * 2)
    res["split"] = ""
except ValueError as e:
    res["split"] = str(e)
m = grid_mesh((1, 2, 2, 1), AXES, devices=["cpu"] * 2)
res["owners"] = [m.process_of(pipe=p, model=j) for p in (0, 1)
                 for j in (0, 1)]
res["local"] = [m.is_local(pipe=p) for p in (0, 1)]
try:
    m.device_at(pipe=1 - rank)
    res["remote"] = ""
except ValueError as e:
    res["remote"] = str(e)

# messages of a job whose group is NCCL's go over a gloo group of their
# own: the backend reads "nccl" while the Exchange forms (NCCL itself is
# not available here), and every message must name that group
import torch.distributed as dist
real_backend, real_isend, real_recv = dist.get_backend, dist.isend, dist.recv
dist.get_backend = lambda group=None: "nccl"
try:
    ex = cluster.Exchange()
finally:
    dist.get_backend = real_backend
groups = []


def isend(*a, group=None, **k):
    groups.append(group)
    return real_isend(*a, group=group, **k)


def recv(*a, group=None, **k):
    groups.append(group)
    return real_recv(*a, group=group, **k)


dist.isend, dist.recv = isend, recv
x = torch.full((3,), float(rank + 1))
ex.send(x, 1 - rank, 2)
got = ex.recv((3,), torch.float32, "cpu", 1 - rank, 2)
ex.wait_sends()
res["nccl_messages"] = dict(
    got=got.tolist(),
    sum=ex.ordered_sum(x, [0, 1], cluster.MessageTags.SUM_TAGS).tolist(),
    own_group=ex._messages_group is not None,
    on_it=[g is ex._messages_group for g in groups])
dist.isend, dist.recv = real_isend, real_recv

# a trainer over processes is freed when its last reference goes: no
# step leaves a reference cycle through autograd's graph (the collector
# is off while this runs)
import gc
import weakref
gc.disable()
res["freed"] = {{}}
for name in FREED:
    kind, shape, kw, steps, tshape = RUNS[name]
    t = trainer(kind, shape, kw)
    t.step(tokens(tshape))
    master = weakref.ref(t._blocks.masters()[0])
    del t
    res["freed"][name] = master() is None
gc.enable()

# (iii) the public ring and Ulysses across the processes
g = torch.Generator().manual_seed(0)
q, k, v = (torch.randn(64, 4, 8, generator=g) for _ in range(3))
mesh = data_mesh(devices=["cpu"])
for impl in ("dense", "flash"):
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    o = ring_attention(qq, kk, vv, mesh=mesh, causal=True, block_impl=impl)
    (o.float() ** 2).sum().backward()
    np.savez(os.path.join(out, f"ring_{{impl}}_{{rank}}.npz"),
             o=o.detach().numpy(), dq=qq.grad.numpy(),
             dk=kk.grad.numpy(), dv=vv.grad.numpy())
np.save(os.path.join(out, f"ulysses_{{rank}}.npy"),
        ulysses_attention(q, k, v, mesh=mesh, causal=True).numpy())
"""

_TAIL = """
with open(os.path.join(out, f"res_{{rank}}.json"), "w") as f:
    json.dump(res, f)
cluster.barrier("done")
cluster.shutdown()
"""


# the four-process group: the pipe and model axes both across processes
# (one position a process), the ring over four processes, data x pipe
RUNS4 = {
    "pipe_model_4": ("pipelined", (1, 2, 2, 1), _SGD, 2, (4, 32)),
    "seq_ring_4": ("pipelined", (1, 1, 1, 4), dict(_SGD, attention="flash"),
                   2, (4, 32)),
    "data_pipe_4": ("pipelined", (2, 2, 1, 1), _SGD, 2, (4, 32)),
}


def _run_children(tmp, procs, runs, extras):
    """Run `procs` children over `runs` (and the two-process group's
    other checks with `extras`); their result dicts."""
    script = tmp / "child.py"
    text = _CHILD + (_EXTRAS if extras else "") + _TAIL
    script.write_text(textwrap.dedent(text.format(
        repo=_REPO, runs=runs, model=_MODEL, axes=_AXES, procs=procs,
        freed=_FREED)))
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    children = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp / "rdv"), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(procs)]
    outs = []
    try:
        for pr in children:
            outs.append(pr.communicate(timeout=240)[0])
    finally:
        for pr in children:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for r, (pr, out) in enumerate(zip(children, outs)):
        assert pr.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    res = []
    for r in range(procs):
        with open(tmp / f"res_{r}.json") as f:
            res.append(json.load(f))
    return res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run both children once; (their result dicts, the output dir)."""
    tmp = tmp_path_factory.mktemp("lm_mp")
    return _run_children(tmp, 2, RUNS, True), tmp


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    """Run four children over `RUNS4` once."""
    tmp = tmp_path_factory.mktemp("lm_mp4")
    return _run_children(tmp, 4, RUNS4, False), tmp


def _npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _tokens(shape):
    return np.random.default_rng(0).integers(
        0, _MODEL["vocab_size"], size=shape).astype(np.int32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flat(tree[key], f"{prefix}|{key}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}|{i}")
    else:
        yield prefix, np.asarray(tree)


def _port_flat(t):
    return dict(_flat(params_to_numpy(t.params)))


def _one_process(name, seed=0):
    """The run's trainer in this process, on a mesh of the same shape."""
    kind, shape, kw, _, _ = {**RUNS, **RUNS4}[name]
    n = int(np.prod(shape))
    if kind == "sharded":
        return ShardedLMTrainer(mesh=grid_mesh(shape, devices=["cpu"] * n),
                                seed=seed, **_MODEL)
    return PipelinedLMTrainer(mesh=grid_mesh(shape, _AXES,
                                             devices=["cpu"] * n),
                              n_microbatches=2, seed=seed, **kw, **_MODEL)


def _assert_deltas(start, got, want, rel=1e-4):
    """Per leaf, max |delta_got - delta_want| <= rel * max |delta_want|."""
    assert got.keys() == want.keys() == start.keys()
    for name, a in start.items():
        d_got, d_want = got[name] - a, want[name] - a
        err = float(np.abs(d_got - d_want).max())
        assert err <= rel * float(np.abs(d_want).max()), (name, err)


@pytest.mark.parametrize("name", list(RUNS))
def test_ranks_agree_bit_for_bit(ranks, name):
    """Both ranks return the same losses, falling, and hold the same
    parameters; every replicated master is bit-identical on both."""
    res, tmp = ranks
    l0, l1 = res[0][name]["losses"], res[1][name]["losses"]
    assert l0 == l1
    assert np.isfinite(l0).all() and l0[-1] < l0[0]
    p0, p1 = (_npz(tmp / f"{name}_params_{r}.npz") for r in (0, 1))
    assert p0.keys() == p1.keys()
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
    r0, r1 = (_npz(tmp / f"{name}_replicas_{r}.npz") for r in (0, 1))
    shared = r0.keys() & r1.keys()
    kind, shape = RUNS[name][:2]
    # two processes split the first axis longer than 1 (process-major)
    across = next(i for i, n in enumerate(shape) if n > 1)
    if across == 0:
        # the data axis across: every master on both
        assert shared and shared == r0.keys() == r1.keys()
    elif kind == "pipelined" and across == 2:
        assert not shared        # the model axis across: each key on one
    else:
        # pipe or seq across: the tied embedding on both
        assert any(k.startswith("shared") for k in shared), shared
    for k in shared:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


@pytest.mark.parametrize("name", [n for n, r in RUNS.items()
                                  if r[0] == "pipelined"])
def test_matches_the_one_process_trainer(ranks, name):
    """Against the one-process trainer on a mesh of the same shape: SGD
    deltas within 1e-4 of each leaf's max |delta| (and losses within
    1e-5), Adam losses within 1e-5, bf16 losses within 1e-3."""
    res, tmp = ranks
    _, _, kw, steps, tshape = RUNS[name]
    toks = _tokens(tshape)
    one = _one_process(name)
    start = _port_flat(one)
    want = [one.step(toks) for _ in range(steps)]
    got = res[0][name]["losses"]
    tol = 1e-3 if kw.get("compute_dtype") == "bfloat16" else 1e-5
    assert got == pytest.approx(want, abs=tol)
    if kw.get("optimizer") == "sgd":
        _assert_deltas(start, _npz(tmp / f"{name}_params_0.npz"),
                       _port_flat(one))


@pytest.mark.parametrize("name", ["pipe_adam", "pipe_sgd"])
def test_pipelined_matches_jax(ranks, name):
    """Against the JAX trainer on conftest's virtual CPU devices, mesh
    (data, pipe, model) = (1, 2, 2): the losses within 1e-5 and, for
    SGD, the deltas leaf by leaf."""
    res, tmp = ranks
    _, _, kw, steps, tshape = RUNS[name]
    toks = _tokens(tshape)
    jax_t = JaxPipelinedLMTrainer(mesh=jax_grid_mesh((1, 2, 2), _AXES[:3]),
                                  n_microbatches=2, seed=0, **kw, **_MODEL)
    start = _port_flat(_one_process(name))
    want = [jax_t.step(toks) for _ in range(steps)]
    assert res[0][name]["losses"] == pytest.approx(want, abs=1e-5)
    if kw.get("optimizer") == "sgd":
        _assert_deltas(start, _npz(tmp / f"{name}_params_0.npz"),
                       dict(_flat(jax.tree_util.tree_map(np.asarray,
                                                         jax_t.params))))


def test_sharded_matches_mesh_none_and_jax(ranks):
    """(2, 2) with data across the processes: three Adam steps against
    mesh=None and the JAX trainer on the same mesh at the reference's
    rtol 2e-4, atol 2e-5; `run_stream` over the processes trains."""
    res, _ = ranks
    toks = _tokens(RUNS["sharded"][4])
    got = res[0]["sharded"]["losses"]
    alone = ShardedLMTrainer(device="cpu", seed=0, **_MODEL)
    np.testing.assert_allclose(got, [alone.step(toks) for _ in range(3)],
                               rtol=2e-4, atol=2e-5)
    jax_t = JaxShardedLMTrainer(mesh=jax_grid_mesh((2, 2)), seed=0,
                                **_MODEL)
    np.testing.assert_allclose(got, [jax_t.step(toks) for _ in range(3)],
                               rtol=2e-4, atol=2e-5)
    assert res[0]["stream"] == res[1]["stream"] == got[:2]


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_public_ring_across_processes(ranks, impl):
    """ring_attention over a data axis of two processes: the full output
    on each rank equals the one-process ring's bit for bit; each rank's
    input gradients hold its own positions' rows (zero elsewhere), and
    the ranks' sum is the one-process gradient bit for bit."""
    _, tmp = ranks
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(64, 4, 8, generator=g) for _ in range(3))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    o = ring_attention(q, k, v, mesh=data_mesh(devices=["cpu"] * 2),
                       causal=True, block_impl=impl)
    (o.float() ** 2).sum().backward()
    z = [_npz(tmp / f"ring_{impl}_{r}.npz") for r in (0, 1)]
    for r in (0, 1):
        np.testing.assert_array_equal(z[r]["o"], o.detach().numpy())
    for n, x in (("dq", q), ("dk", k), ("dv", v)):
        assert not z[0][n][32:].any() and not z[1][n][:32].any(), n
        np.testing.assert_array_equal(z[0][n] + z[1][n], x.grad.numpy(),
                                      err_msg=n)


def test_public_ulysses_across_processes(ranks):
    _, tmp = ranks
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(64, 4, 8, generator=g) for _ in range(3))
    want = ulysses_attention(q, k, v, mesh=data_mesh(devices=["cpu"] * 2),
                             causal=True).numpy()
    for r in (0, 1):
        np.testing.assert_array_equal(np.load(tmp / f"ulysses_{r}.npy"),
                                      want)


@pytest.mark.parametrize("name", ["ckpt_pipe", "ckpt_sharded"])
def test_two_process_checkpoint_restores(ranks, name):
    """Saved by the 2-process trainer (the leader writes): a 2-process
    trainer of another seed and a one-process trainer of the same mesh
    restore it and continue within rtol 1e-6."""
    res, tmp = ranks
    r = res[0][name]
    assert r["step"] == 2 and res[1][name] == r
    np.testing.assert_allclose(r["restored"], r["next"], rtol=1e-6)
    kind = "sharded" if name == "ckpt_sharded" else "pipe_adam"
    one = _one_process(kind, seed=7)
    assert one.restore_checkpoint(str(tmp / name)) == 2
    toks = _tokens(RUNS[kind][4])
    np.testing.assert_allclose([one.step(toks) for _ in range(2)],
                               r["next"], rtol=1e-6)


def test_refusals_and_counts(ranks):
    """A supervised run_stream over processes is refused as in the
    reference, a grid of 3 positions over 2 processes raises, another
    process's position gathers through `position_params`, and a step
    counts its messages and sums by primitive."""
    res, _ = ranks
    for rank, r in enumerate(res):
        assert "single-process" in r["stream_refused"], r["stream_refused"]
        assert "does not split evenly over 2 processes" in r["split"]
        assert r["position_wq"] == [2, 32, 16]
        # (1, 2, 2, 1) process-major: the pipe axis spans the processes
        assert r["owners"] == [0, 0, 1, 1]
        assert r["local"] == [rank == 0, rank == 1]
        assert f"belongs to process {1 - rank}" in r["remote"], r["remote"]
    for r in res:
        stats = r["stats"]
        for prim in ("send", "recv", "sum"):
            assert stats[prim]["calls"] > 0 and stats[prim]["bytes"] > 0, (
                prim, stats)
            assert stats[prim]["seconds"] >= stats[prim]["copy_seconds"]
        assert stats["gather"]["calls"] == 0


@pytest.mark.parametrize("name,kept", [
    ("model_sgd", "some"), ("model_full_remat", "all"),
    ("pipe_sgd", "none"), ("pipe_bf16", "none")])
def test_link_keeps_only_checkpointed_messages(ranks, name, kept):
    """A step keeps a received message only inside a checkpointed region
    (remat="save_attn": the feed-forward's, not the attention's;
    remat="full": every layer message; no remat or the hop: none), and
    each kept message is taken by its recompute before the step ends."""
    res, _ = ranks
    c = {k: sum(r[name + "_messages"][k] for r in res)
         for k in ("received", "kept", "left")}
    assert c["received"] > 0 and c["left"] == 0, c
    want = {"some": 0 < c["kept"] < c["received"],
            "all": c["kept"] == c["received"],
            "none": c["kept"] == 0}[kept]
    assert want, c


@pytest.mark.parametrize("name", _FREED)
def test_trainer_is_freed_without_the_collector(ranks, name):
    """A trainer over processes, after a step, is freed as soon as its
    last reference goes, with the collector off: the message nodes of a
    step hold no cycle that would keep its graph and masters alive."""
    res, _ = ranks
    for r in res:
        assert r["freed"][name], r["freed"]


def test_messages_under_nccl_go_over_a_gloo_group(ranks):
    """An Exchange of a job whose group is NCCL's forms a gloo group of
    its own and sends and receives every message, the ordered sum's
    too, over it (NCCL would run a pair's sends and receives on one
    stream, and two ranks that both send first would wait on each
    other)."""
    res, _ = ranks
    for rank, r in enumerate(res):
        m = r["nccl_messages"]
        assert m["own_group"] and m["on_it"] and all(m["on_it"]), m
        assert m["got"] == [2.0 - rank] * 3
        assert m["sum"] == [3.0] * 3


def test_message_tags_are_distinct_and_paired():
    """Every coordinate tuple has its own even tag and its backward twin
    the next odd one; out-of-range and unknown coordinates raise, and an
    absent field at 0 is allowed."""
    tags = MessageTags(kind=3, micro=2, shard=4)
    seen = {tags(kind=k, micro=m, shard=c)
            for k in range(3) for m in range(2) for c in range(4)}
    assert len(seen) == 24 and all(t % 2 == 0 for t in seen)
    assert max(seen) + 1 < MessageTags.SUM_TAGS
    assert tags(kind=1, step=0) == tags(kind=1)
    with pytest.raises(ValueError, match="outside"):
        tags(shard=4)
    with pytest.raises(ValueError, match="no tag coordinates"):
        tags(step=1)
    with pytest.raises(ValueError, match="message tags"):
        MessageTags(a=1 << 15, b=1 << 15)


@pytest.mark.parametrize("shape,rank,box", [
    ((1, 2, 2), 1, (1, 1, 2)), ((2, 2), 0, (1, 2)),
    ((1, 1, 4), 1, (1, 1, 2)), ((3, 2), 1, (3,))])
def test_mesh_layout_is_process_major(shape, rank, box):
    """A mesh over two processes built from its global grid: process p
    owns the p-th half of the flattened grid, as a box where the half is
    one (else flat); `process_of`, `is_local`, `device_at` and
    `position_offset` follow; a device at another process's position, or
    a missing one at its own, raises."""
    n = int(np.prod(shape))
    grid = np.empty(n, dtype=object)
    grid[rank * n // 2:(rank + 1) * n // 2] = torch.device("cpu")
    axes = ("data", "pipe", "model") if len(shape) == 3 else ("data",
                                                              "model")
    mesh = Mesh(grid.reshape(shape), axes, process_count=2,
                process_index=rank, exchange=object())
    assert mesh.devices.shape == box and mesh.shape == dict(
        zip(mesh.axis_names, shape))
    owners = [int(q) // (n // 2) for q in range(n)]
    for q, coords in enumerate(np.ndindex(*shape)):
        named = dict(zip(mesh.axis_names, coords))
        assert mesh.process_of(**named) == owners[q]
        assert mesh.is_local(**named) == (owners[q] == rank)
        if owners[q] == rank:
            assert mesh.device_at(**named) == torch.device("cpu")
        else:
            with pytest.raises(ValueError, match="belongs to process"):
                mesh.device_at(**named)
    bad = grid.copy()
    bad[(1 - rank) * n // 2] = torch.device("cpu")
    with pytest.raises(ValueError, match="given a device"):
        Mesh(bad.reshape(shape), mesh.axis_names, process_count=2,
             process_index=rank, exchange=object())
    with pytest.raises(ValueError, match="needs an exchange"):
        Mesh(grid.reshape(shape), mesh.axis_names, process_count=2,
             process_index=rank)


@pytest.mark.parametrize("name", list(RUNS4))
def test_four_processes(ranks4, name):
    """Over four processes, one or two positions each: the four ranks'
    losses and parameters equal bit for bit, falling losses, and SGD
    deltas within 1e-4 of the one-process trainer's (losses within
    1e-5)."""
    res, tmp = ranks4
    losses = [r[name]["losses"] for r in res]
    assert all(x == losses[0] for x in losses)
    assert losses[0][-1] < losses[0][0]
    params = [_npz(tmp / f"{name}_params_{r}.npz") for r in range(4)]
    for p in params[1:]:
        assert p.keys() == params[0].keys()
        for k in p:
            np.testing.assert_array_equal(p[k], params[0][k], err_msg=k)
    _, _, _, steps, tshape = RUNS4[name]
    toks = _tokens(tshape)
    one = _one_process(name)
    start = _port_flat(one)
    want = [one.step(toks) for _ in range(steps)]
    assert losses[0] == pytest.approx(want, abs=1e-5)
    _assert_deltas(start, params[0], _port_flat(one))
