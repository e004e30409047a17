"""DNNModel: minibatch deep-net inference over Table columns, in torch.

Port of `mmlspark_tpu/models/dnn/model.py` (role: CNTKModel,
cntk/CNTKModel.scala:87-543):

- the graph is `apply_fn(params, xb)`, a function of torch ops on tensors
  of the stage's device, and a params tree (dicts and lists; numpy arrays
  or tensors). Floating leaves move to the device once; integer leaves are
  shape data and stay numpy arrays on the host;
- every batch is padded to the static `batch_size` and the padded rows
  are cut off afterwards (reference `:122-139`), so one cuDNN plan serves
  every batch; `output_index` picks one output of a tuple, list or dict,
  `input_dtype` casts each batch first;
- every call runs inside `device.exact_f32()`: f32 convolutions are f32,
  never TF32;
- `save` stores the params in the reference's layout (`treedef`,
  `n_leaves`, `leaf_{i}`) and the graph as a `torch.export` program
  (`torch_export`), the counterpart of the reference's StableHLO
  artifact (`:85-99`); a loaded model runs the program, with no Python
  apply_fn. A reference artifact's StableHLO graph cannot run here, and
  loading one raises.
"""
from __future__ import annotations

import io
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ...core import Model, Param, Table
from ...core.params import in_range
from ...device import exact_f32, resolve_device
from .payload import _treedef_from_str, _treedef_to_str
from .transformer import _flatten, _structure, _unflatten


def _leaf_to_device(leaf, device):
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    arr = np.asarray(leaf)
    if np.issubdtype(arr.dtype, np.integer):
        return arr
    return torch.as_tensor(np.array(arr), device=device)


def params_to_device(tree, device):
    """A params tree with every floating leaf a tensor on `device`; integer
    numpy leaves (shapes, axes) stay on the host."""
    if isinstance(tree, dict):
        return {k: params_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_device(v, device) for v in tree]
    return _leaf_to_device(tree, device)


def _host_leaf(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class _Bound(torch.nn.Module):
    """`apply_fn` bound to its params, for `torch.export`: tensor leaves
    become buffers, the rest stays in the tree as constants."""

    def __init__(self, fn, params):
        super().__init__()
        self._fn = fn
        self._structure = _structure(params)
        self._leaves = _flatten(params)
        for i, leaf in enumerate(self._leaves):
            if isinstance(leaf, torch.Tensor):
                self.register_buffer(f"leaf_{i}", leaf)

    def forward(self, xb):
        leaves = [getattr(self, f"leaf_{i}")
                  if isinstance(leaf, torch.Tensor) else leaf
                  for i, leaf in enumerate(self._leaves)]
        return self._fn(_unflatten(self._structure, leaves), xb)


class DNNModel(Model):
    """Transformer scoring Table columns through a network of torch ops."""
    input_col = Param("input_col", "input column (feeds the model)", "features")
    output_col = Param("output_col", "output column", "scores")
    batch_size = Param("batch_size", "minibatch rows per dispatch", 64,
                       validator=in_range(1))
    output_index = Param("output_index",
                         "when apply returns a tuple/list/dict: which output "
                         "to emit", None)
    input_dtype = Param("input_dtype", "cast input batches to this dtype",
                        "float32")
    device = Param("device", "torch device to score on (None = the card)",
                   None)

    def __init__(self, apply_fn: Optional[Callable] = None, params=None, **kw):
        super().__init__(**kw)
        self._apply_fn = apply_fn
        self._params = params
        self._bound = None          # (device, callable)
        self._bound_lock = threading.Lock()
        self._export_bytes: Optional[bytes] = None

    # -- persistence --------------------------------------------------------
    def _get_state(self):
        state = {}
        if self._params is not None:
            leaves = _flatten(self._params)
            state["treedef"] = _treedef_to_str(self._params)
            for i, leaf in enumerate(leaves):
                state[f"leaf_{i}"] = _host_leaf(leaf)
            state["n_leaves"] = len(leaves)
        if self._export_bytes is None and self._apply_fn is not None:
            # an apply_fn may not be exportable (Python state, shapes that
            # depend on the data): the params still save, as in the
            # reference
            try:
                self._export_bytes = self.export_program()
            except Exception:  # noqa: BLE001
                pass
        if self._export_bytes is not None:
            state["torch_export"] = np.frombuffer(self._export_bytes,
                                                  np.uint8)
        return state

    def _set_state(self, s):
        n = int(np.asarray(s.get("n_leaves", 0)))
        if n:
            leaves = [_host_leaf(s[f"leaf_{i}"]) for i in range(n)]
            self._params = _treedef_from_str(str(s["treedef"]), leaves)
        if "torch_export" in s:
            self._export_bytes = _host_leaf(s["torch_export"]).astype(
                np.uint8).tobytes()
            self._apply_fn = None
            self._bound = None
        elif "stablehlo" in s:
            raise ValueError(
                "this DNNModel artifact holds its graph as StableHLO "
                "(jax.export), which the PyTorch port cannot run; build "
                "the model from an apply_fn of torch ops, or save it from "
                "the port, whose artifact holds a torch.export program")

    # -- torch.export round-trip (the StableHLO artifact's counterpart) ----
    def export_program(self) -> bytes:
        """(apply_fn, params, batch shape) as `torch.export` program bytes,
        traced on the stage's device at (batch_size, *row shape)."""
        if self._apply_fn is None:
            raise ValueError("no apply_fn to export")
        shape = self._example_shape
        dev = resolve_device(self.device)
        module = _Bound(self._apply_fn, params_to_device(self._params, dev))
        example = torch.zeros((self.batch_size, *shape),
                              dtype=getattr(torch, self.input_dtype),
                              device=dev)
        with exact_f32():
            program = torch.export.export(module, (example,))
        buf = io.BytesIO()
        torch.export.save(program, buf)
        return buf.getvalue()

    # -- scoring ------------------------------------------------------------
    @property
    def _example_shape(self):
        if not hasattr(self, "_row_shape"):
            raise ValueError("transform once (or set _row_shape) before export")
        return self._row_shape

    def _compiled(self, dev: torch.device):
        """The graph bound to its params on `dev`, built on first use and
        kept. Serving calls it from several worker threads: the build is
        serialized, so two first batches share one copy of the weights."""
        bound = self._bound
        if bound is not None and bound[0] == dev:
            return bound[1]
        with self._bound_lock:
            return self._bind(dev)

    def _bind(self, dev: torch.device):
        if self._bound is not None and self._bound[0] == dev:
            return self._bound[1]
        if self._apply_fn is not None:
            fn, params = self._apply_fn, params_to_device(self._params, dev)
            call = lambda xb: fn(params, xb)  # noqa: E731
        elif self._export_bytes is not None:
            from torch.export.passes import move_to_device_pass
            program = torch.export.load(io.BytesIO(self._export_bytes))
            call = move_to_device_pass(program, dev).module()
        else:
            raise ValueError("DNNModel has neither apply_fn nor a "
                             "deserialized torch.export graph")
        self._bound = (dev, call)
        return call

    def _batch(self, x, lo: int, dev: torch.device) -> torch.Tensor:
        dtype = getattr(torch, self.input_dtype)
        xb = x[lo:lo + self.batch_size]
        if isinstance(xb, torch.Tensor):
            return xb.to(device=dev, dtype=dtype)
        xb = np.ascontiguousarray(xb.astype(self.input_dtype))
        return torch.from_numpy(xb).to(dev)

    def _transform(self, t: Table) -> Table:
        x = t[self.input_col]
        n = x.shape[0]
        self._row_shape = tuple(x.shape[1:])
        b = self.batch_size
        dev = resolve_device(self.device)
        fn = self._compiled(dev)
        outs = []
        with torch.no_grad(), exact_f32():
            for lo in range(0, n, b):
                xb = self._batch(x, lo, dev)
                pad = b - xb.shape[0]
                if pad:  # static batch shape: one plan for every batch
                    xb = torch.cat([xb, xb.new_zeros((pad, *xb.shape[1:]))])
                res = self._select_output(fn(xb))
                outs.append(res[:b - pad])
        scores = (torch.cat(outs).cpu().numpy() if outs
                  else np.zeros((0,)))
        return t.with_column(self.output_col, scores)

    def _select_output(self, res):
        if self.output_index is None:
            return res
        if isinstance(res, dict):
            return res[self.output_index]
        return res[int(self.output_index)]
