"""Pipeline and tensor parallelism in LM training on the card.

Every test here carries the `gpu` marker and skips without a card. This
file imports neither jax nor the JAX package, so it also runs where only
the port is installed (from the repo root, for `chip_smoke`'s limits):

    python -m pytest --noconftest -m gpu \
        tests/test_torch_lm_training_pp_cuda.py

At a small width with D = 64 (d_model 256, 4 heads, 2 a model position),
one SGD step at lr 1 with attention="flash" (the flash kernels; the stats
form with a seq axis) on a (data, pipe, model, seq) mesh of one card
against the same step with dense attention: the updated weights per leaf
within `chip_smoke._TRAIN_TOL` of the update (`_update_disagreement`),
and the launches exact.
"""
import numpy as np
import pytest
import torch

from chip_smoke import _TRAIN_TOL, _named_leaves, _update_disagreement
from mmlspark_tpu_torch.models.dnn import PipelinedLMTrainer
from mmlspark_tpu_torch.ops import flash_attention as fa
from mmlspark_tpu_torch.parallel import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS,
                                         SEQ_AXIS, grid_mesh)

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_MODEL = dict(vocab_size=512, d_model=256, n_heads=4, n_layers=4, d_ff=512,
              max_len=1024)
_SEQ, _BATCH, _M = 1024, 2, 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 2, 2, 1), (1, 2, 2, 2)])
def test_flash_step_matches_dense(cuda_device, shape, compute_dtype):
    toks = np.random.default_rng(0).integers(
        0, _MODEL["vocab_size"], size=(_BATCH, _SEQ)).astype(np.int32)
    mesh = grid_mesh(shape, (DATA_AXIS, PIPE_AXIS, MODEL_AXIS, SEQ_AXIS),
                     devices=[cuda_device] * int(np.prod(shape)))
    updated, launches = {}, {}
    for attention in ("flash", "dense"):
        t = PipelinedLMTrainer(mesh=mesh, n_microbatches=_M,
                               attention=attention, optimizer="sgd", lr=1.0,
                               seed=0, compute_dtype=compute_dtype,
                               remat="save_attn", **_MODEL)
        if attention == "flash":
            names, start = zip(*((n, a.detach().clone())
                                 for n, a in _named_leaves(t.params)))
        torch.cuda.synchronize()
        fa.reset_launches()
        loss = t.step(toks)
        assert np.isfinite(loss)
        launches[attention] = dict(fa.launches)
        updated[attention] = [a.detach().clone()
                              for _, a in _named_leaves(t.params)]
    worst, leaf, _ = _update_disagreement(names, start, updated["flash"],
                                          updated["dense"])
    assert worst <= _TRAIN_TOL[compute_dtype], (leaf, worst)
    _, _, tp, cp = shape
    per = _MODEL["n_layers"] * tp * _BATCH * cp * cp
    want = ({"flash_fwd": per, "flash_stats_fwd": 0, "flash_bwd_dq": per,
             "flash_bwd_dkv": per} if cp == 1 else
            {"flash_fwd": 0, "flash_stats_fwd": per, "flash_bwd_dq": per,
             "flash_bwd_dkv": per})
    assert launches["flash"] == want
    assert not any(launches["dense"].values())
