"""Hashed-feature online learning on the card.

Port of the reference's `models/vw/learner.py` (role: the VW C++ core the
reference drives over JNI, vw/VowpalWabbitBase.scala:338-424): minibatch
SGD over a 2^b weight vector with plain / adaptive (AdaGrad) / BFGS
modes, several passes, and per-pass weight averaging over a data mesh's
positions (VW's spanning-tree AllReduce, VowpalWabbitBase.scala:434-460).

Training is MINIBATCH SGD, as the reference's: one update per batch of
`batch_size` rows, the weights' gradient a segmented sum over the batch's
hashed indices. The reference fuses passes x batches into one `lax.scan`;
here a Python loop over batches launches a short fixed sequence of
kernels per batch (`_sgd_batch`) with no host read inside the loop: the
per-batch losses stay on the device and are read once per fit.

Deterministic on the card: the segmented sum (`_segment_sum`) groups the
batch's `(idx & (dim-1), g * val)` pairs by a stable sort and sums each
group with `torch.segment_reduce` (no float atomics). The segment lengths
are an integer `index_add_` into `dim` counters (integer adds commute, so
their order does not matter); `torch.bincount` would read the indices'
maximum back to the host on every batch. Every shape is fixed by
(batch_size, k, dim), so two fits on the card with equal inputs give the
same bits, and a retried online refit reaches the weights of a clean run.

The learning-rate schedule mirrors VW and the reference, in float32 on
the device: lr_t = lr * ((1 + t0) / (1 + t0 + t))^power_t with an f32
batch counter t; adaptive mode applies no power_t (AdaGrad supplies its
own decay); the L1 truncation follows the update.

BFGS (`_fit_bfgs`) is the reference's full-batch L-BFGS: the two-loop
recursion over a ring of `bfgs_memory` pairs, a backtracking line search
whose final step is the last one evaluated (one host read per halving,
as the reference's `while_loop` is sequential too), the bias stepping
along -gb, and the history updated only where s.y > 1e-10. Its gradient
is `torch.autograd` through the same objective, clip included.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ...device import resolve_device


@dataclasses.dataclass(frozen=True)
class VWParams:
    num_bits: int = 18
    loss_function: str = "squared"   # squared | logistic
    learning_rate: float = 0.5       # VW default
    power_t: float = 0.5
    initial_t: float = 0.0
    l1: float = 0.0
    l2: float = 0.0
    num_passes: int = 1
    batch_size: int = 256
    mode: str = "adaptive"           # adaptive (VW default) | sgd | bfgs
    bfgs_iters: int = 25
    bfgs_memory: int = 10


def _pad_batches(idx, val, y, w, batch_size):
    """Host arrays padded to whole batches: padded pairs carry val 0 (no
    gradient) and padded rows w 0 (no loss)."""
    n = idx.shape[0]
    nb = max(1, -(-n // batch_size))
    pad = nb * batch_size - n
    if pad:
        idx = np.pad(idx, ((0, pad), (0, 0)))
        val = np.pad(val, ((0, pad), (0, 0)))
        y = np.pad(y, (0, pad))
        w = np.pad(w, (0, pad))
    return (idx.reshape(nb, batch_size, -1), val.reshape(nb, batch_size, -1),
            y.reshape(nb, batch_size), w.reshape(nb, batch_size), nb)


def _predict_margin(weights: torch.Tensor, bias, idx: torch.Tensor,
                    val: torch.Tensor) -> torch.Tensor:
    # a gather from the 2^b table; indices are masked into it as VW masks
    # every hash (the feature space is defined modulo 2^b, so a producer
    # wider than the table wraps instead of clamping)
    idx = idx & (weights.shape[0] - 1)
    return (weights[idx] * val).sum(-1) + bias


def _predict_sparse(weights: torch.Tensor, bias, idx: torch.Tensor,
                    val: torch.Tensor, link: Optional[str] = None
                    ) -> torch.Tensor:
    """Sparse-pair scoring, the serving fast path's computation: the
    margin, and the logistic link where asked."""
    m = _predict_margin(weights, bias, idx, val)
    if link == "logistic":
        m = torch.sigmoid(m)
    return m


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip`. Under autograd (BFGS) it is built as JAX builds it
    (maximum, then minimum), so the gradient splits at a tie as JAX's
    does where `torch.clamp` would pass it whole; the values are the
    same, and without autograd `clamp` makes no host-to-device copy."""
    if not x.requires_grad:
        return torch.clamp(x, lo, hi)
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)),
                         x.new_tensor(hi))


def _loss_grad(margin, y, w, loss_function: str):
    if loss_function == "logistic":
        # y in {0,1}; VW reports the logistic loss
        p = torch.sigmoid(margin)
        grad = (p - y) * w
        loss = -(y * torch.log(_clip(p, 1e-15, 1.0))
                 + (1 - y) * torch.log(_clip(1 - p, 1e-15, 1.0))) * w
    else:
        d = margin - y
        grad = d * w
        loss = 0.5 * d * d * w
    return grad, loss


def _segment_sum(flat_idx: torch.Tensor, flat_g: torch.Tensor,
                 dim: int) -> torch.Tensor:
    """(dim,) float32 sums of `flat_g` grouped by `flat_idx` (each in
    [0, dim)), in a fixed order on every device: a stable sort groups the
    slots and one segmented reduction sums each group (the module
    docstring). No host read."""
    order = torch.sort(flat_idx, stable=True).indices
    lengths = torch.zeros(dim, dtype=torch.int64, device=flat_idx.device)
    lengths.index_add_(0, flat_idx, torch.ones_like(flat_idx,
                                                    dtype=torch.int64))
    return torch.segment_reduce(flat_g[order], "sum", lengths=lengths,
                                unsafe=True)


def _sgd_batch(weights, bias, acc, t, idx, val, y, w, p: VWParams,
               c: torch.Tensor):
    """One minibatch update: (weights, bias, acc, t + 1, the batch's loss
    sum), every value a tensor on the batch's device. `acc` is the
    AdaGrad accumulator (adaptive mode; unused otherwise); `c` is the f32
    constant 1 + initial_t on the device (made once per pass, so the loop
    copies nothing from the host)."""
    dim = weights.shape[0]
    margin = _predict_margin(weights, bias, idx, val)
    gm, loss = _loss_grad(margin, y, w, p.loss_function)
    # per-weight gradients via one segmented sum over the batch's slots
    gw = _segment_sum((idx & (dim - 1)).reshape(-1),
                      (gm[:, None] * val).reshape(-1), dim)
    denom = torch.clamp(w.sum(), min=1.0)
    gw = gw / denom + p.l2 * weights
    gb = gm.sum() / denom
    if p.mode == "adaptive":
        # AdaGrad supplies its own per-weight decay (VW --adaptive);
        # stacking the global power_t schedule on top over-decays
        lr_t = p.learning_rate
        acc = acc + gw * gw
        upd = gw / torch.sqrt(acc + 1e-8)
    else:
        lr_t = p.learning_rate * torch.pow(c / (c + t), p.power_t)
        upd = gw
    weights = weights - lr_t * upd
    if p.l1 > 0:  # truncated-gradient L1 (VW --l1)
        weights = torch.sign(weights) * torch.clamp(
            torch.abs(weights) - lr_t * p.l1, min=0.0)
    bias = bias - lr_t * gb
    return weights, bias, acc, t + 1.0, loss.sum()


def _run_pass(state: list, batches, p: VWParams, losses: torch.Tensor
              ) -> list:
    """Fold every batch of one position's shard into `state` = [weights,
    bias, acc, t]; each batch's loss lands in `losses` on the device."""
    weights, bias, acc, t = state
    b_idx, b_val, b_y, b_w = batches
    c = torch.tensor(1.0 + p.initial_t, dtype=torch.float32,
                     device=weights.device)
    for b in range(b_idx.shape[0]):
        weights, bias, acc, t, loss = _sgd_batch(
            weights, bias, acc, t, b_idx[b], b_val[b], b_y[b], b_w[b], p, c)
        losses[b] = loss
    return [weights, bias, acc, t]


def _init_state(p: VWParams, init_w, init_b, dev: torch.device) -> list:
    dim = 1 << p.num_bits
    weights = (torch.zeros(dim, dtype=torch.float32, device=dev)
               if init_w is None else
               torch.as_tensor(np.asarray(init_w, np.float32)).to(dev))
    bias = torch.tensor(0.0 if init_b is None else init_b,
                        dtype=torch.float32, device=dev)
    acc = torch.zeros(dim if p.mode == "adaptive" else 1,
                      dtype=torch.float32, device=dev)
    return [weights, bias, acc, torch.zeros((), dtype=torch.float32,
                                            device=dev)]


def _to_device(batches, dev: torch.device) -> tuple:
    return tuple(torch.as_tensor(a).to(dev) for a in batches)


def _fit_sgd(idx, val, y, w, p: VWParams, init_w, init_b,
             positions: list) -> tuple:
    """All passes over the rows, sharded over `positions` (devices, one
    per mesh position; one position: no averaging). Returns (weights,
    bias, per-pass loss sums of position 0) as device tensors."""
    n_pos = len(positions)
    if n_pos > 1:
        from ...parallel.mesh import pad_to_multiple
        idx, _ = pad_to_multiple(idx, n_pos)
        val, _ = pad_to_multiple(val, n_pos)
        y, _ = pad_to_multiple(y, n_pos)
        w, _ = pad_to_multiple(w, n_pos)     # pad weight 0 -> no loss
    block = idx.shape[0] // n_pos
    shards = []
    for i, dev in enumerate(positions):
        sl = slice(i * block, (i + 1) * block)
        bi, bv, by, bw, _ = _pad_batches(idx[sl], val[sl], y[sl], w[sl],
                                         p.batch_size)
        shards.append(_to_device((bi, bv, by, bw), dev))
    lead = positions[0]
    state = _init_state(p, init_w, init_b, lead)
    pass_losses = torch.zeros(p.num_passes, dtype=torch.float32, device=lead)
    for k in range(p.num_passes):
        ends = []
        for i, dev in enumerate(positions):
            losses = torch.zeros(shards[i][0].shape[0], dtype=torch.float32,
                                 device=dev)
            start = [s.to(dev) for s in state]
            ends.append(_run_pass(start, shards[i], p, losses))
            if i == 0:
                pass_losses[k] = losses.sum()
        if n_pos == 1:
            state = ends[0]
            continue
        # per-pass model averaging over the positions, summed in position
        # order (the reference's pmean at endPass,
        # VowpalWabbitBase.scala:365-369)
        state = list(ends[0])
        for j in range(3 if p.mode == "adaptive" else 2):
            total = ends[0][j]
            for e in ends[1:]:
                total = total + e[j].to(lead)
            state[j] = total / n_pos
    return state[0], state[1], pass_losses


def _fit_bfgs(idx, val, y, w, p: VWParams, init_w, init_b,
              dev: torch.device) -> tuple:
    """Full-batch L-BFGS (--bfgs); see the module docstring. Returns
    (weights, bias, the objective before each iteration)."""
    dim = 1 << p.num_bits
    m = p.bfgs_memory
    idx, val, y, w = _to_device((idx, val, y, w), dev)
    denom = torch.clamp(w.sum(), min=1.0)

    def objective(weights, bias):
        margin = _predict_margin(weights, bias, idx, val)
        _, loss = _loss_grad(margin, y, w, p.loss_function)
        return loss.sum() / denom + 0.5 * p.l2 * (weights ** 2).sum()

    def grad_fn(weights, bias):
        with torch.enable_grad():
            wv = weights.detach().requires_grad_(True)
            bv = bias.detach().requires_grad_(True)
            gw, gb = torch.autograd.grad(objective(wv, bv), (wv, bv))
        return gw, gb

    def two_loop(g, s_hist, y_hist, rho_hist, k):
        q = g
        alphas = torch.zeros(m, dtype=torch.float32, device=dev)
        valid = min(k, m)
        for i in range(valid):
            j = (k - 1 - i) % m
            alpha = rho_hist[j] * torch.dot(s_hist[j], q)
            q = q - alpha * y_hist[j]
            alphas[j] = alpha
        # initial Hessian scaling
        j_last = (k - 1) % m
        ys = torch.dot(y_hist[j_last], y_hist[j_last])
        gamma = torch.where(
            (ys > 1e-10) & (k > 0),
            torch.dot(s_hist[j_last], y_hist[j_last]) / ys,
            torch.ones((), dtype=torch.float32, device=dev))
        r = gamma * q
        for i in range(valid):
            j = (k - valid + i) % m
            beta = rho_hist[j] * torch.dot(y_hist[j], r)
            r = r + (alphas[j] - beta) * s_hist[j]
        return r

    with torch.no_grad():
        weights, bias = _init_state(
            dataclasses.replace(p, mode="sgd"), init_w, init_b, dev)[:2]
        g, gb = grad_fn(weights, bias)
        s_hist = torch.zeros((m, dim), dtype=torch.float32, device=dev)
        y_hist = torch.zeros((m, dim), dtype=torch.float32, device=dev)
        rho_hist = torch.zeros(m, dtype=torch.float32, device=dev)
        k = 0
        losses = torch.zeros(p.bfgs_iters, dtype=torch.float32, device=dev)
        for it in range(p.bfgs_iters):
            d = -two_loop(g, s_hist, y_hist, rho_hist, k)
            f0 = objective(weights, bias)
            # backtracking line search: the final alpha is the last one
            # evaluated (one host read per comparison)
            alpha = 1.0
            f = objective(weights + alpha * d, bias - alpha * gb)
            while bool(f > f0) and alpha > 1e-4:
                alpha *= 0.5
                f = objective(weights + alpha * d, bias - alpha * gb)
            new_w = weights + alpha * d
            new_b = bias - alpha * gb
            ng, ngb = grad_fn(new_w, new_b)
            s = new_w - weights
            yv = ng - g
            sy = torch.dot(s, yv)
            if bool(sy > 1e-10):
                j = k % m
                s_hist[j] = s
                y_hist[j] = yv
                rho_hist[j] = 1.0 / torch.clamp(sy, min=1e-10)
                k += 1
            losses[it] = f0
            weights, bias, g, gb = new_w, new_b, ng, ngb
    return weights, bias, losses


def vw_positions(num_tasks: int = 0, device=None, mesh=None) -> list:
    """The devices a fit shards its rows over, one per position: `mesh`'s
    data axis when given, else the reference's rule (num_tasks > 1
    positions, or every visible card for num_tasks = 0; the CPU is one
    position unless num_tasks asks for more). A mesh that spans processes
    raises NotImplementedError."""
    from ...parallel.mesh import DATA_AXIS, data_mesh
    if mesh is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            if num_tasks > 1 or (num_tasks == 0
                                 and torch.cuda.device_count() > 1):
                mesh = data_mesh(num_tasks if num_tasks > 1 else None)
            else:
                return [dev]
        else:
            return [dev] * max(int(num_tasks), 1)
    if mesh.process_count > 1:
        raise NotImplementedError(
            "a VW fit over a mesh that spans processes is not ported yet "
            "(ROADMAP Queue 1 item 19): each process fits on its own "
            "positions")
    return list(mesh.axis_devices(DATA_AXIS))


def fit_vw(idx: np.ndarray, val: np.ndarray, y: np.ndarray,
           params: VWParams, weights: Optional[np.ndarray] = None,
           initial_model: Optional[tuple] = None,
           num_tasks: int = 0, device=None, mesh=None):
    """Train over host arrays on `device` (None = the card); returns
    (weights numpy f32, bias, TrainingStats dict).

    Rows shard over the positions `vw_positions(num_tasks, device, mesh)`
    gives, padded with weight-0 rows, each position batching its own
    shard, with per-pass averaging (reference: trainInternalDistributed).
    `initial_model=(w, b)` warm-starts like setInitialModel
    (VowpalWabbitBase.scala:354-355). BFGS runs full-batch on the first
    position."""
    t_start = time.perf_counter_ns()
    positions = vw_positions(num_tasks, device, mesh)
    n = idx.shape[0]
    w_row = (np.ones(n, np.float32) if weights is None
             else np.asarray(weights, np.float32))
    idx = np.asarray(idx, np.int32)
    val = np.asarray(val, np.float32)
    y = np.asarray(y, np.float32)
    init_w = init_b = None
    if initial_model is not None:
        init_w = np.asarray(initial_model[0], np.float32)
        init_b = float(np.float32(initial_model[1]))
    if params.mode == "bfgs":
        w_out, b_out, losses = _fit_bfgs(idx, val, y, w_row, params, init_w,
                                         init_b, positions[0])
    else:
        w_out, b_out, losses = _fit_sgd(idx, val, y, w_row, params, init_w,
                                        init_b, positions)
    # the fit's one read of its results
    w_np = w_out.cpu().numpy()
    b = float(b_out.cpu())
    losses = losses.cpu().numpy()
    elapsed = time.perf_counter_ns() - t_start
    scale = max(float(w_row.sum()), 1.0) if params.mode != "bfgs" else 1.0
    stats = {
        "passes": (params.num_passes if params.mode != "bfgs"
                   else params.bfgs_iters),
        "final_loss": float(losses[-1]) / scale,
        "loss_history": (losses / scale).tolist(),
        "time_total_ns": elapsed,
        "num_features_nonzero": int((w_np != 0).sum()),
    }
    return w_np, b, stats


def predict_vw(weights, bias, idx, val, link: Optional[str] = None,
               device=None) -> np.ndarray:
    """Margins (or, with link="logistic", probabilities) of host rows as a
    host float32 array. `weights` is a host array or a tensor already on
    `device` (None = the card); the link is applied on the host, as the
    reference's."""
    dev = resolve_device(device)
    if not torch.is_tensor(weights):
        weights = torch.as_tensor(np.asarray(weights, np.float32))
    weights = weights.to(dev)
    with torch.no_grad():
        margins = _predict_margin(
            weights, torch.tensor(float(np.float32(bias)),
                                  dtype=torch.float32, device=dev),
            torch.as_tensor(np.asarray(idx, np.int32)).to(dev),
            torch.as_tensor(np.asarray(val, np.float32)).to(dev))
    margins = margins.cpu().numpy()
    if link == "logistic":
        return 1.0 / (1.0 + np.exp(-margins))
    return margins

