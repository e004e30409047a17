"""Generic stage persistence: params to JSON, arrays to npz, nested stages
to subdirectories.

Port of `mmlspark_tpu/core/serialize.py`, with its rules and its layout:
a stage is its class by qualified name, its explicitly set params
(kind-tagged codecs, nested stages recursively, named functions by module
and qualified name, no pickle of closures unless opted in) and its
`_get_state()`. Where the reference stores JAX arrays the port stores
torch tensors: host numpy in the npz with the torch dtype recorded
(bfloat16 and the other dtypes numpy lacks as same-width integers),
loaded back as CPU tensors. A loaded stage moves its state to its own
`device` Param when it is used. A `torch.device` param value is stored as
its string.

Layout on disk:
    <path>/metadata.json      {class, uid, params:{name:{kind,value|ref}},
                               state_keys, tensor_state}
    <path>/arrays.npz         array/tensor params + array/tensor state
    <path>/state.json         json-able state
    <path>/stages/<i>_<name>/ nested stage params (recursively)
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

# the package whose modules an artifact may import by name
_PACKAGE = __name__.split(".")[0]

# torch dtypes numpy has no dtype for travel as integers of their width
_INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}


def _tensor_to_host(t: torch.Tensor):
    """(host numpy array, torch dtype name) for a tensor on any device."""
    t = t.detach().cpu()
    try:
        arr = t.numpy()
    except TypeError:
        arr = t.view(_INT_OF_WIDTH[t.element_size()]).numpy()
    return arr.copy(), str(t.dtype).rpartition(".")[2]


def _tensor_from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """The inverse of `_tensor_to_host`: a CPU tensor of `dtype`."""
    want = getattr(torch, dtype, None)
    if not isinstance(want, torch.dtype):
        raise ValueError(f"artifact names an unknown torch dtype {dtype!r}")
    t = torch.from_numpy(np.array(arr))
    return t if t.dtype == want else t.view(want)


def _is_stage(v) -> bool:
    from .pipeline import PipelineStage
    return isinstance(v, PipelineStage)


def _json_roundtrips(value) -> bool:
    """True only if JSON round-trips the value IDENTICALLY — rejects any
    nested dict with non-string keys (json.dumps would stringify them and
    load would silently return different key types)."""
    if isinstance(value, dict):
        return all(isinstance(k, str) for k in value) and all(
            _json_roundtrips(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return all(_json_roundtrips(v) for v in value)
    return isinstance(value, (str, int, float, bool)) or value is None


def _encode_value(value, slot: str, path: str, arrays: dict) -> dict:
    """Recursive kind-tagged encoding of one param value. `slot` uniquely
    names any array refs / stage subdirs this value needs."""
    if value is None:
        return {"kind": "json", "value": None}
    if _is_stage(value):
        sub = os.path.join(path, "stages", slot)
        save_stage(value, sub)
        return {"kind": "stage", "ref": f"stages/{slot}"}
    if isinstance(value, (list, tuple)) and value and all(_is_stage(v) for v in value):
        refs = []
        for i, v in enumerate(value):
            save_stage(v, os.path.join(path, "stages", f"{slot}_{i}"))
            refs.append(f"stages/{slot}_{i}")
        return {"kind": "stage_list", "refs": refs}
    from .params import Params
    if isinstance(value, Params):
        # non-stage Params objects (Evaluators, config bundles): encode the
        # class by qualified name + its explicitly-set params, recursively
        return {"kind": "params_obj",
                "class": f"{type(value).__module__}.{type(value).__name__}",
                "params": {n: _encode_value(v, f"{slot}__{n}", path, arrays)
                           for n, v in value._paramMap.items()
                           if not (value._param_registry.get(n)
                                   and value._param_registry[n].transient)}}
    if isinstance(value, torch.device):
        return {"kind": "device", "value": str(value)}
    if isinstance(value, np.ndarray):
        if value.dtype == object:
            # np.savez would pickle these and load (allow_pickle=False)
            # would then fail — encode as a JSON list instead.
            return {"kind": "object_array", "value": value.tolist()}
        arrays[slot] = value
        return {"kind": "array", "ref": slot}
    if hasattr(value, "_to_json") and hasattr(type(value), "_from_json"):
        # custom codec hook (hyperparam distributions, parsers, ...);
        # validate the payload NOW so a bad _to_json (e.g. np.int64 leaves)
        # fails with the param-level diagnostic before any files are written
        payload = value._to_json()
        json.dumps(payload)
        return {"kind": "custom",
                "class": f"{type(value).__module__}.{type(value).__name__}",
                "value": payload}
    if isinstance(value, dict):
        for k in value:
            # scalar keys only: JSON object keys stringify ints/bools and
            # tuple keys would json-encode to (unhashable) lists — reject at
            # save time rather than corrupting the artifact
            if not isinstance(k, (str, int, float, bool)) and k is not None:
                raise TypeError(f"dict param key {k!r} is not a scalar")
        if _json_roundtrips(value):
            return {"kind": "json", "value": value}
        # keys JSON-encoded separately so int/bool keys keep their type
        return {"kind": "dict",
                "items": [[json.dumps(k),
                           _encode_value(v, f"{slot}__{i}", path, arrays)]
                          for i, (k, v) in enumerate(value.items())]}
    if isinstance(value, (list, tuple)):
        if _json_roundtrips(list(value)):
            return {"kind": "json", "value": list(value)}
        return {"kind": "list",
                "items": [_encode_value(v, f"{slot}__{i}", path, arrays)
                          for i, v in enumerate(value)]}
    if isinstance(value, (np.integer, np.floating, np.bool_)):
        return {"kind": "json", "value": value.item()}
    if callable(value) and not isinstance(value, type):
        # UDF-style callables. Preferred encoding is by qualified name (safe:
        # load resolves an attribute, it never executes embedded bytecode) —
        # works for any module-level function, like Spark referencing a UDF
        # class by name. Closures/lambdas need pickle, which runs arbitrary
        # code at LOAD time, so both directions are gated behind
        # MMLSPARK_TPU_PICKLE_UDFS=1; otherwise mark the param transient.
        named = _named_fn_spec(value)
        if named is not None:
            return named
        if os.environ.get("MMLSPARK_TPU_PICKLE_UDFS") == "1":
            import base64
            import pickle
            try:
                payload = pickle.dumps(value)
            except Exception as e:
                raise TypeError(
                    f"callable param cannot be pickled ({e}); use a "
                    f"module-level function or mark the param transient") from e
            return {"kind": "pickled_fn",
                    "data": base64.b64encode(payload).decode("ascii")}
        hint = ("functions defined in __main__ (a script/notebook) cannot be "
                "resolved by other processes; move the function into an "
                "importable module"
                if getattr(value, "__module__", None) == "__main__" else
                "define it at module scope")
        raise TypeError(
            f"callable param is not an importable module-level function; "
            f"{hint}, mark the param transient, or opt into pickling with "
            f"MMLSPARK_TPU_PICKLE_UDFS=1 (pickle also resolves by module + "
            f"name, so __main__ functions still only load from the same "
            f"script)")
    json.dumps(value)  # raises TypeError for anything we can't persist
    return {"kind": "json", "value": value}


def _named_fn_spec(fn):
    """{"kind": "named_fn"} spec if fn is importable by module + qualname
    (verified by actually resolving it back to the same object)."""
    import importlib
    import types
    if not isinstance(fn, (types.FunctionType, np.ufunc)):
        return None  # load applies the same shape check; stay symmetric
    mod = getattr(fn, "__module__", None)
    qual = getattr(fn, "__qualname__", None) or getattr(fn, "__name__", None)
    if not qual or "<" in qual:  # <lambda>, <locals> closures
        return None
    if mod == "__main__":
        # '__main__' names a DIFFERENT module in every loading process — the
        # save-time identity check below would pass here but resolve to a
        # missing/different function elsewhere. Force the pickle opt-in path.
        return None
    # numpy ufuncs (np.log1p, ...) carry no __module__ but live on numpy
    for candidate in ([mod] if mod else []) + ["numpy"]:
        try:
            obj = importlib.import_module(candidate)
            for part in qual.split("."):
                obj = getattr(obj, part)
        except (ImportError, AttributeError):
            continue
        if obj is fn:
            return {"kind": "named_fn", "module": candidate, "qualname": qual}
    return None


# modules whose attributes are never legitimate UDFs; a tampered artifact
# naming e.g. os.system or subprocess.call must not resolve
_NAMED_FN_DENYLIST = frozenset({
    "os", "subprocess", "shutil", "sys", "pty", "socket", "pickle",
    "ctypes", "importlib", "builtins", "posix", "nt", "shlex", "runpy",
    "code", "codeop", "webbrowser",
})


def _import_artifact_module(mod: str, what: str):
    """Shared guard for every artifact-controlled class/function lookup:
    denylisted top-level packages never resolve, and modules OUTSIDE this
    package must already be imported — an artifact must not be able to run
    arbitrary top-level import side effects. (Legitimate user extensions
    already require their defining module imported before load, exactly
    like STAGE_REGISTRY lookup.)"""
    import importlib
    import sys
    if mod.split(".")[0] in _NAMED_FN_DENYLIST:
        raise ValueError(
            f"artifact names a {what} from module {mod!r}, which cannot "
            f"hold one; refusing to resolve it")
    if mod.split(".")[0] != _PACKAGE and mod not in sys.modules:
        raise ValueError(
            f"artifact names a {what} from module {mod!r}, which is not "
            f"imported; import the defining module before load()")
    return importlib.import_module(mod)


def _resolve_named_fn(spec: dict):
    import types
    mod = spec["module"]
    obj = _import_artifact_module(mod, "callable")
    for part in spec["qualname"].split("."):
        obj = getattr(obj, part)
        if isinstance(obj, types.ModuleType):
            # qualnames never traverse modules — walking through a module
            # attribute (e.g. zipfile.shutil.rmtree) is a denylist bypass
            raise ValueError(
                f"artifact qualname {spec['qualname']!r} traverses module "
                f"{obj.__name__!r}; refusing to resolve it")
    fn_mod = getattr(obj, "__module__", None) or ""
    if fn_mod.split(".")[0] in _NAMED_FN_DENYLIST:
        raise ValueError(
            f"artifact resolves to a callable defined in {fn_mod!r}, which "
            f"cannot hold UDFs; refusing to use it")
    if not isinstance(obj, (types.FunctionType, np.ufunc)):
        # builtins / bound methods / arbitrary callables are not the shapes
        # _named_fn_spec produces — a hand-edited artifact is the only way here
        raise TypeError(
            f"{mod}.{spec['qualname']} is not a plain function/ufunc; "
            f"refusing to use it as a UDF")
    return obj


def _decode_value(spec: dict, path: str, arrays: dict):
    kind = spec["kind"]
    if kind == "json":
        return spec["value"]
    if kind == "object_array":
        return np.asarray(spec["value"], dtype=object)
    if kind == "array":
        return arrays[spec["ref"]]
    if kind == "device":
        return torch.device(spec["value"])
    if kind == "stage":
        return load_stage(os.path.join(path, spec["ref"]))
    if kind == "stage_list":
        return [load_stage(os.path.join(path, r)) for r in spec["refs"]]
    if kind == "custom":
        mod, _, cname = spec["class"].rpartition(".")
        cls = getattr(_import_artifact_module(mod, "codec class"), cname)
        if not (isinstance(cls, type) and callable(
                getattr(cls, "_from_json", None))):
            raise ValueError(
                f"artifact custom class {spec['class']!r} has no _from_json "
                f"codec; refusing to use it")
        return cls._from_json(spec["value"])
    if kind == "params_obj":
        from .params import Params
        mod, _, cname = spec["class"].rpartition(".")
        cls = getattr(_import_artifact_module(mod, "Params class"), cname)
        if not (isinstance(cls, type) and issubclass(cls, Params)):
            # a tampered artifact naming e.g. subprocess.Popen must not get
            # a constructor call with artifact-controlled kwargs
            raise ValueError(
                f"artifact params_obj class {spec['class']!r} is not a "
                f"Params subclass; refusing to instantiate it")
        return cls(**{n: _decode_value(v, path, arrays)
                      for n, v in spec["params"].items()})
    if kind == "named_fn":
        return _resolve_named_fn(spec)
    if kind == "pickled_fn":
        if os.environ.get("MMLSPARK_TPU_PICKLE_UDFS") != "1":
            raise ValueError(
                "artifact contains a pickled callable; refusing to unpickle "
                "without MMLSPARK_TPU_PICKLE_UDFS=1 (pickle executes "
                "arbitrary code at load time)")
        import base64
        import pickle
        return pickle.loads(base64.b64decode(spec["data"]))
    if kind == "dict":
        return {json.loads(k): _decode_value(v, path, arrays)
                for k, v in spec["items"]}
    if kind == "list":
        return [_decode_value(v, path, arrays) for v in spec["items"]]
    raise ValueError(f"unknown param kind {kind!r}")


def save_stage(stage, path: str) -> None:
    stage._prepare_save()
    os.makedirs(path, exist_ok=True)
    meta: dict[str, Any] = {
        "class": f"{type(stage).__module__}.{type(stage).__name__}",
        "uid": stage.uid,
        "params": {},
        "format_version": 1,
    }
    arrays: dict[str, np.ndarray] = {}

    transient = []
    for name, value in stage._paramMap.items():
        p = stage._param_registry.get(name)
        if p is not None and p.transient:
            transient.append(name)  # recorded, not persisted (e.g. fobj)
            continue
        try:
            meta["params"][name] = _encode_value(value, f"param__{name}",
                                                 path, arrays)
        except TypeError as e:
            raise TypeError(
                f"param {name!r} of {type(stage).__name__} is not "
                f"serializable ({e}); mark it transient "
                f"(Param(..., transient=True)) or provide an array/stage "
                f"value") from e
    if transient:
        meta["transient_params"] = transient

    state = stage._get_state()
    json_state, state_keys, tensor_state = {}, [], {}
    for key, value in state.items():
        state_keys.append(key)
        if isinstance(value, np.ndarray):
            if value.dtype == object:
                json_state[key] = value.tolist()
            else:
                arrays[f"state__{key}"] = value
        elif isinstance(value, torch.Tensor):
            arrays[f"state__{key}"], tensor_state[key] = \
                _tensor_to_host(value)
        else:
            json_state[key] = value
    meta["state_keys"] = state_keys
    if tensor_state:
        meta["tensor_state"] = tensor_state

    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=1)
    if arrays:
        np.savez(os.path.join(path, "arrays.npz"), **arrays)
    if json_state:
        with open(os.path.join(path, "state.json"), "w") as f:
            json.dump(json_state, f)


def _stage_class(name: str):
    """The registered stage class saved as `name`. A class of this
    package registers when its module is imported, so such a module is
    imported here; a class defined elsewhere needs its module imported
    before load()."""
    from .pipeline import STAGE_REGISTRY
    mod = name.rpartition(".")[0]
    if name not in STAGE_REGISTRY and mod.split(".")[0] == _PACKAGE:
        try:
            _import_artifact_module(mod, "stage class")
        except ImportError:
            pass
    cls = STAGE_REGISTRY.get(name)
    if cls is None:  # fall back to bare name (older saves / moved modules)
        cls = STAGE_REGISTRY.get(name.rsplit(".", 1)[-1])
    if cls is None:
        raise KeyError(f"unknown stage class {name!r}; import its module "
                       f"first")
    return cls


def load_stage(path: str):
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    cls = _stage_class(meta["class"])

    arrays = {}
    npz_path = os.path.join(path, "arrays.npz")
    if os.path.exists(npz_path):
        with np.load(npz_path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}

    params = {name: _decode_value(spec, path, arrays)
              for name, spec in meta["params"].items()}

    stage = cls.__new__(cls)
    stage._paramMap = {}
    stage.uid = meta["uid"]
    # re-run any non-param init state with defaults, then apply params
    try:
        cls.__init__(stage)
    except TypeError:
        pass
    stage._paramMap = {}
    stage.uid = meta["uid"]
    stage.set(**{k: v for k, v in params.items()})

    state = {}
    json_path = os.path.join(path, "state.json")
    if os.path.exists(json_path):
        with open(json_path) as f:
            state.update(json.load(f))
    tensor_state = meta.get("tensor_state", {})
    for key in meta.get("state_keys", []):
        ref = f"state__{key}"
        if ref in arrays:
            state[key] = (_tensor_from_host(arrays[ref], tensor_state[key])
                          if key in tensor_state else arrays[ref])
    if state:
        stage._set_state(state)
    stage._finish_load()
    return stage
