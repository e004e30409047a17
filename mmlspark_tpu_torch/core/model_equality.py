"""Structural stage/model comparison for tests and save/load verification.

Port of `mmlspark_tpu/core/model_equality.py`: two stages are equal when
they have the same class and the same param values (uids are identity,
not state). Torch tensors compare as arrays: same shape and dtype kind,
values within the tolerance, on whatever device they are.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(v):
    """A tensor as a host numpy array (bfloat16 widened to f32)."""
    v = v.detach().cpu()
    if v.dtype == torch.bfloat16:
        v = v.float()
    return v.numpy()


def stages_equal(a, b, rtol: float = 1e-6, atol: float = 1e-8) -> bool:
    try:
        assert_stages_equal(a, b, rtol=rtol, atol=atol)
        return True
    except AssertionError:
        return False


def assert_stages_equal(a, b, rtol: float = 1e-6, atol: float = 1e-8,
                        _path: str = "") -> None:
    """Recursively assert two stages have the same class and param values
    (uids are identity, not state, and are ignored)."""
    assert type(a) is type(b), f"{_path}: {type(a).__name__} != {type(b).__name__}"
    pa, pb = a.param_map(), b.param_map()
    assert set(pa) == set(pb), f"{_path}: param sets differ"
    for name in pa:
        if a._param_registry[name].transient:
            continue  # skipped by save(); reverts to default on load
        _assert_values_equal(pa[name], pb[name], rtol, atol,
                             f"{_path}.{name}" if _path else name)


def _assert_values_equal(va, vb, rtol, atol, path):
    from .params import Params
    from .pipeline import PipelineStage
    if isinstance(va, PipelineStage):
        assert_stages_equal(va, vb, rtol, atol, path)
    elif isinstance(va, Params):
        # non-stage Params values (Evaluators, config bundles): structural
        # comparison — same class, same explicitly-set params. Transient
        # params are skipped, matching assert_stages_equal and the fact that
        # serialization drops them on save.
        assert type(va) is type(vb), f"{path}: {type(va)} != {type(vb)}"

        def persisted(obj):
            return {k for k in obj._paramMap
                    if not (obj._param_registry.get(k)
                            and obj._param_registry[k].transient)}
        assert persisted(va) == persisted(vb), f"{path}: params set"
        for k in persisted(va):
            _assert_values_equal(va._paramMap[k], vb._paramMap[k], rtol,
                                 atol, f"{path}.{k}")
    elif isinstance(va, torch.Tensor) or isinstance(vb, torch.Tensor):
        assert isinstance(va, torch.Tensor) and isinstance(
            vb, torch.Tensor), f"{path}: a tensor and a non-tensor"
        assert va.dtype == vb.dtype, f"{path}: {va.dtype} != {vb.dtype}"
        _assert_values_equal(_host(va), _host(vb), rtol, atol, path)
    elif isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
        va, vb = np.asarray(va), np.asarray(vb)
        assert va.shape == vb.shape, f"{path}: shape {va.shape} != {vb.shape}"
        if np.issubdtype(va.dtype, np.number) and np.issubdtype(vb.dtype, np.number):
            np.testing.assert_allclose(va, vb, rtol=rtol, atol=atol,
                                       err_msg=path)
        else:
            assert va.tolist() == vb.tolist(), f"{path}: values differ"
    elif isinstance(va, dict):
        assert isinstance(vb, dict) and set(va) == set(vb), f"{path}: dict keys"
        for k in va:
            _assert_values_equal(va[k], vb[k], rtol, atol, f"{path}[{k!r}]")
    elif isinstance(va, (list, tuple)):
        assert isinstance(vb, (list, tuple)) and len(va) == len(vb), (
            f"{path}: length {len(va)} != {len(vb)}")
        for i, (x, y) in enumerate(zip(va, vb)):
            _assert_values_equal(x, y, rtol, atol, f"{path}[{i}]")
    elif callable(va) and not isinstance(va, type):
        # callables round-trip by reference only; compare by qualified name
        assert callable(vb) and getattr(va, "__qualname__", None) == \
            getattr(vb, "__qualname__", None), f"{path}: callables differ"
    else:
        assert va == vb, f"{path}: {va!r} != {vb!r}"
