"""Minimal ONNX importer in torch: foreign-model scoring without the onnx
package.

Port of `mmlspark_tpu/models/dnn/onnx_import.py` (role: CNTKModel scoring
protobuf model bytes it did not define,
com/microsoft/CNTK/SerializableFunction.scala:25-45). The protobuf wire
reader is the reference's, copied as it is: ONNX is plain protobuf, and
ModelProto decodes into nodes, initializers, inputs and outputs. Each node
evaluates as torch ops on the input's device, NCHW end to end.

Supported opset: Gemm (transA, transB, alpha, beta), MatMul, Add
(broadcasting), Relu, Identity, Flatten, Reshape (0 and -1), Constant
(value, value_float, value_int, value_floats, value_ints), Conv (group,
dilations, asymmetric pads, applied with `F.pad` first),
BatchNormalization, MaxPool (padded with -inf), AveragePool (padding left
out of the count unless count_include_pad) and GlobalAveragePool. The
reference refuses a grouped Conv; the port evaluates it. auto_pad,
ceil_mode, an unsupported op and a consumed secondary output are refused
in the reference's words. f32 convolutions run as f32 (`exact_f32`).

`load_onnx(data, cut)` returns `(apply_fn, params)` with numpy params in
the reference's layout; `model.params_to_device` puts them on a device
(integer initializers, such as Reshape's shapes, stay on the host).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...device import exact_f32

# -- protobuf wire format ----------------------------------------------------
# Every message is a sequence of (key varint = field_no << 3 | wire_type,
# payload). Wire types used by ONNX: 0 = varint, 1 = 64-bit, 2 = length-
# delimited (bytes / strings / sub-messages / packed repeated), 5 = 32-bit.


def _varint(buf: bytes, i: int):
    val = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _signed(v: int) -> int:
    """Protobuf int64 varints are two's complement in 64 bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(buf: bytes):
    """Yield (field_no, wire_type, value) — value is int for wire types
    0/1/5 and a bytes slice for wire type 2."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            v = int.from_bytes(buf[i:i + 8], "little")
            i += 8
        elif wt == 5:
            v = int.from_bytes(buf[i:i + 4], "little")
            i += 4
        elif wt == 2:
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield field, wt, v


def _packed_varints(v, wt):
    """A repeated varint field arrives packed (wt 2) or one-per-entry."""
    if wt == 0:
        return [_signed(v)]
    out = []
    i = 0
    while i < len(v):
        x, i = _varint(v, i)
        out.append(_signed(x))
    return out


# -- ONNX message readers ----------------------------------------------------

_DTYPES = {1: np.float32, 6: np.int32, 7: np.int64, 9: np.bool_,
           10: np.float16, 11: np.float64}


def _read_tensor(buf: bytes) -> tuple:
    """TensorProto -> (name, ndarray)."""
    dims, dtype, name = [], 1, ""
    raw = None
    float_data, int32_data, int64_data = [], [], []
    for field, wt, v in _fields(buf):
        if field == 1:
            dims.extend(_packed_varints(v, wt))
        elif field == 2:
            dtype = v
        elif field == 4:     # packed fixed32 floats
            float_data.append(np.frombuffer(v, np.float32)
                              if wt == 2 else
                              np.frombuffer(np.uint32(v).tobytes(),
                                            np.float32))
        elif field == 5:
            int32_data.extend(_packed_varints(v, wt))
        elif field == 7:
            int64_data.extend(_packed_varints(v, wt))
        elif field == 8:
            name = v.decode()
        elif field == 9:
            raw = v
    np_dtype = _DTYPES.get(dtype)
    if np_dtype is None:
        raise ValueError(f"ONNX tensor '{name}': unsupported data_type "
                         f"{dtype} (supported: {sorted(_DTYPES)})")
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype)
    elif float_data:
        arr = np.concatenate(float_data).astype(np_dtype)
    elif int64_data:
        arr = np.asarray(int64_data, np_dtype)
    elif int32_data:
        arr = np.asarray(int32_data, np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.reshape(dims) if dims else arr.reshape(())


def _read_attribute(buf: bytes) -> tuple:
    """AttributeProto -> (name, python value)."""
    name, val = "", None
    ints, floats = [], []
    for field, wt, v in _fields(buf):
        if field == 1:
            name = v.decode()
        elif field == 2:      # f: float stored as fixed32
            val = np.frombuffer(np.uint32(v).tobytes(), np.float32)[0]
        elif field == 3:      # i
            val = _signed(v)
        elif field == 4:      # s
            val = v.decode(errors="replace")
        elif field == 5:      # t: tensor
            val = _read_tensor(v)[1]
        elif field == 7:      # floats (packed fixed32)
            floats.extend(np.frombuffer(v, np.float32).tolist()
                          if wt == 2 else
                          [np.frombuffer(np.uint32(v).tobytes(),
                                         np.float32)[0]])
        elif field == 8:      # ints
            ints.extend(_packed_varints(v, wt))
    if ints:
        val = ints
    elif floats:
        val = floats
    return name, val


def _read_node(buf: bytes) -> dict:
    node = {"inputs": [], "outputs": [], "op": "", "name": "", "attrs": {}}
    for field, wt, v in _fields(buf):
        if field == 1:
            node["inputs"].append(v.decode())
        elif field == 2:
            node["outputs"].append(v.decode())
        elif field == 3:
            node["name"] = v.decode()
        elif field == 4:
            node["op"] = v.decode()
        elif field == 5:
            k, val = _read_attribute(v)
            node["attrs"][k] = val
    return node


def _read_graph(buf: bytes) -> dict:
    g = {"nodes": [], "initializers": {}, "inputs": [], "outputs": []}
    for field, wt, v in _fields(buf):
        if field == 1:
            g["nodes"].append(_read_node(v))
        elif field == 5:
            name, arr = _read_tensor(v)
            g["initializers"][name] = arr
        elif field == 11:
            g["inputs"].append(_read_value_info_name(v))
        elif field == 12:
            g["outputs"].append(_read_value_info_name(v))
    return g


def _read_value_info_name(buf: bytes) -> str:
    for field, wt, v in _fields(buf):
        if field == 1:
            return v.decode()
    return ""


def parse_onnx(data: bytes) -> dict:
    """ModelProto bytes -> {nodes, initializers, inputs, outputs}."""
    for field, wt, v in _fields(data):
        if field == 7:        # ModelProto.graph
            return _read_graph(v)
    raise ValueError("not an ONNX ModelProto: no graph field")



# -- op evaluation -----------------------------------------------------------

def _pool_dims(attrs, rank, node_name=""):
    """kernel/strides/pads for an NCHW spatial op, ONNX attr conventions.
    auto_pad and ceil_mode are refused loudly — silently defaulting them
    would shift every spatial dim and produce wrong scores with no
    error (the module's contract is raise-with-a-name, never guess)."""
    if attrs.get("auto_pad") not in (None, "NOTSET"):
        raise NotImplementedError(
            f"node '{node_name}': auto_pad={attrs['auto_pad']!r} is not "
            f"supported — export the model with explicit pads")
    if attrs.get("ceil_mode"):
        raise NotImplementedError(
            f"node '{node_name}': ceil_mode=1 is not supported")
    spatial = rank - 2
    kernel = attrs.get("kernel_shape")
    strides = attrs.get("strides") or [1] * spatial
    pads = attrs.get("pads") or [0] * (2 * spatial)
    dil = attrs.get("dilations") or [1] * spatial
    # ONNX pads are [x1_begin, x2_begin, ..., x1_end, x2_end, ...]
    pad_pairs = [(int(pads[i]), int(pads[i + spatial]))
                 for i in range(spatial)]
    return kernel, [int(s) for s in strides], pad_pairs, [int(d) for d in dil]


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _pad(x, pairs, value=0.0):
    """`F.pad` of the spatial axes by ONNX (begin, end) pairs."""
    flat = [p for pair in reversed(pairs) for p in pair]
    return F.pad(x, flat, value=value) if any(flat) else x


def _window_sum(x, kernel, strides):
    """Sum over each pooling window (avg_pool with divisor 1); avg_pool1d
    has no divisor_override, so 1-D windows run as 2-D ones."""
    if x.ndim == 3:
        return _window_sum(x.unsqueeze(-2), [1, *kernel],
                           [1, *strides]).squeeze(-2)
    return _AVG_POOL[x.ndim - 2](x, kernel, strides, divisor_override=1)


def _const(value, device):
    """A Constant's value as a tensor on `device`: float64 arrives as
    float32, as in jax without x64."""
    arr = np.asarray(value)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr, device=device)


def _eval_node(node, env, device=None):
    op = node["op"]
    att = node["attrs"]
    x = [env[i] if i else None for i in node["inputs"]]

    if op == "Gemm":
        a, b = x[0], x[1]
        if att.get("transA", 0):
            a = a.T
        if att.get("transB", 0):
            b = b.T
        y = float(att.get("alpha", 1.0)) * (a @ b)
        if len(x) > 2 and x[2] is not None:
            y = y + float(att.get("beta", 1.0)) * x[2]
        return y
    if op == "MatMul":
        return x[0] @ x[1]
    if op == "Add":
        return x[0] + x[1]
    if op == "Relu":
        return torch.relu(x[0])
    if op == "Identity":
        return x[0]
    if op == "Flatten":
        axis = att.get("axis", 1)
        lead = int(np.prod(x[0].shape[:axis])) if axis else 1
        return x[0].reshape(lead, -1)
    if op == "Reshape":
        spec = x[1]
        spec = spec.tolist() if isinstance(spec, torch.Tensor) \
            else np.asarray(spec).astype(np.int64).tolist()
        shape = [x[0].shape[i] if s == 0 else int(s)
                 for i, s in enumerate(spec)]
        return x[0].reshape(shape)
    if op == "Constant":
        # the tensor form ("value") plus the scalar/list attribute forms
        # torch and other exporters emit for small constants
        for key in ("value", "value_float", "value_int", "value_floats",
                    "value_ints"):
            if key in att:
                return _const(att[key], device)
        raise NotImplementedError(
            f"Constant node '{node['name']}': unsupported attribute form "
            f"{sorted(att)} (supported: value/value_float/value_int/"
            f"value_floats/value_ints)")
    if op == "Conv":
        _, strides, pads, dil = _pool_dims(att, x[0].ndim, node["name"])
        y = _CONV[x[0].ndim - 2](_pad(x[0], pads), x[1], stride=strides,
                                 dilation=dil, groups=int(att.get("group", 1)))
        if len(x) > 2 and x[2] is not None:
            y = y + x[2].reshape(1, -1, *([1] * (x[0].ndim - 2)))
        return y
    if op == "BatchNormalization":
        scale, bias, mean, var = x[1], x[2], x[3], x[4]
        eps = float(att.get("epsilon", 1e-5))
        shp = (1, -1) + (1,) * (x[0].ndim - 2)
        inv = scale.reshape(shp) / torch.sqrt(var.reshape(shp) + eps)
        return (x[0] - mean.reshape(shp)) * inv + bias.reshape(shp)
    if op in ("MaxPool", "AveragePool"):
        kernel, strides, pads, _ = _pool_dims(att, x[0].ndim,
                                              node["name"])
        kernel = [int(k) for k in kernel]
        if op == "MaxPool":
            return _MAX_POOL[x[0].ndim - 2](
                _pad(x[0], pads, -float("inf")), kernel, strides)
        s = _window_sum(_pad(x[0], pads), kernel, strides)
        if att.get("count_include_pad", 0) or not any(
                p != 0 for pair in pads for p in pair):
            return s / float(np.prod(kernel))
        # count_include_pad=0 (the default): border windows divide by the
        # number of VALID cells, not the kernel size
        counts = _window_sum(_pad(torch.ones_like(x[0]), pads), kernel,
                             strides)
        return s / counts
    if op == "GlobalAveragePool":
        return x[0].mean(dim=tuple(range(2, x[0].ndim)), keepdim=True)
    raise NotImplementedError(
        f"ONNX op '{op}' (node '{node['name']}') is not in the supported "
        f"inference opset — see onnx_import.py docstring")


def load_onnx(data, cut: Optional[str] = None) -> tuple:
    """ONNX bytes/path -> (apply_fn, params) for DNNModel.

    apply_fn(params, x) evaluates the graph on the (single) graph input x,
    a tensor, with the initializers as the params tree (tensors on x's
    device, `model.params_to_device`): each node runs as torch ops there.
    params are numpy arrays, keyed by initializer name as in the
    reference.

    cut="features" drops the classifier head: evaluation stops at the
    input of the LAST Gemm/MatMul node (for a ResNet-class graph that is
    the pooled+flattened feature vector) — the transfer-learning layer
    cut ImageFeaturizer performs on foreign models (reference:
    cutOutputLayers, image/ImageFeaturizer.scala:100-108).
    """
    if cut not in (None, "features"):
        raise ValueError(f"cut must be None|'features', got {cut!r}")
    if isinstance(data, str):
        with open(data, "rb") as f:
            data = f.read()
    g = parse_onnx(data)
    params = {k: np.asarray(v) for k, v in g["initializers"].items()}
    feed_inputs = [n for n in g["inputs"] if n not in params]
    if len(feed_inputs) != 1:
        raise ValueError(
            f"expected exactly one non-initializer graph input, got "
            f"{feed_inputs}")
    feed = feed_inputs[0]
    outputs = g["outputs"]
    nodes = g["nodes"]
    if cut == "features":
        head = [i for i, nd in enumerate(nodes)
                if nd["op"] in ("Gemm", "MatMul")]
        if not head:
            raise ValueError(
                "cut='features' needs a Gemm/MatMul classifier head to "
                "drop; this graph has none")
        nodes = nodes[:head[-1]]
        outputs = [g["nodes"][head[-1]]["inputs"][0]]

    # Only a node's FIRST output is produced (e.g. BatchNormalization's
    # training outputs are unused in inference graphs). Refuse at LOAD
    # time, by name, any graph that actually consumes a secondary output.
    secondary = {}
    for node in nodes:
        for out in node["outputs"][1:]:
            if out:
                secondary[out] = (node["op"], node["name"])
    for node in nodes:
        for inp in node["inputs"]:
            if inp in secondary:
                op, name = secondary[inp]
                raise NotImplementedError(
                    f"node '{node['name']}' consumes '{inp}', a secondary "
                    f"output of {op} node '{name}' — only first outputs "
                    f"are evaluated")
    for out in outputs:
        if out in secondary:
            op, name = secondary[out]
            raise NotImplementedError(
                f"graph output '{out}' is a secondary output of {op} node "
                f"'{name}' — only first outputs are evaluated")

    def apply_fn(p, x):
        env = dict(p)
        env[feed] = x
        with exact_f32():
            for node in nodes:
                env[node["outputs"][0]] = _eval_node(node, env, x.device)
        res = [env[o] for o in outputs]
        return res[0] if len(res) == 1 else tuple(res)

    return apply_fn, params
