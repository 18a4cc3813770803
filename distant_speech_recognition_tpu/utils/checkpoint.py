"""Pytree checkpointing for streaming/adaptive processing state.

The reference has no processing-state checkpointing (SURVEY §5.4: persisted
artifacts are only prototype pickles, beamformer weight files and Kaldi arks).
This package's streaming states are explicit pytrees (models/streaming.py),
so checkpoint/resume is a first-class capability: flatten the pytree to named
numpy arrays in one ``.npz`` plus a tiny JSON treedef, reload anywhere.
"""

from __future__ import annotations

import json

import numpy as np

__all__ = ["save_pytree", "load_pytree"]

_SCALARS = (int, float, bool, str)


def _flatten(obj, prefix, arrays, spec):
    if obj is None:
        spec["kind"] = "none"
    elif isinstance(obj, _SCALARS):
        spec["kind"] = "scalar"
        spec["value"] = obj
        spec["pytype"] = type(obj).__name__
    elif isinstance(obj, dict):
        spec["kind"] = "dict"
        spec["children"] = {}
        for k, v in obj.items():
            spec["children"][k] = {}
            _flatten(v, f"{prefix}.{k}", arrays, spec["children"][k])
    elif isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        spec["kind"] = "list" if isinstance(obj, list) else "tuple"
        spec["children"] = []
        for i, v in enumerate(obj):
            child = {}
            _flatten(v, f"{prefix}.{i}", arrays, child)
            spec["children"].append(child)
    elif hasattr(obj, "_fields"):  # NamedTuple
        spec["kind"] = "namedtuple"
        spec["name"] = type(obj).__name__
        spec["fields"] = list(obj._fields)
        spec["children"] = {}
        for k in obj._fields:
            spec["children"][k] = {}
            _flatten(getattr(obj, k), f"{prefix}.{k}", arrays, spec["children"][k])
    else:
        arr = np.asarray(obj)
        spec["kind"] = "array"
        spec["key"] = prefix
        arrays[prefix] = arr


def save_pytree(path: str, tree) -> None:
    """Serialize a pytree of arrays/scalars/None/dicts/(named)tuples to npz."""
    arrays: dict[str, np.ndarray] = {}
    spec: dict = {}
    _flatten(tree, "root", arrays, spec)
    arrays["__spec__"] = np.frombuffer(json.dumps(spec).encode(), np.uint8)
    np.savez(path, **arrays)


def _unflatten(spec, arrays, namedtuple_types):
    kind = spec["kind"]
    if kind == "none":
        return None
    if kind == "scalar":
        py = {"int": int, "float": float, "bool": bool, "str": str}[spec["pytype"]]
        return py(spec["value"])
    if kind == "array":
        return arrays[spec["key"]]
    if kind == "dict":
        return {k: _unflatten(v, arrays, namedtuple_types) for k, v in spec["children"].items()}
    if kind in ("list", "tuple"):
        vals = [_unflatten(c, arrays, namedtuple_types) for c in spec["children"]]
        return vals if kind == "list" else tuple(vals)
    if kind == "namedtuple":
        vals = {k: _unflatten(v, arrays, namedtuple_types) for k, v in spec["children"].items()}
        cls = (namedtuple_types or {}).get(spec["name"])
        if cls is not None:
            return cls(**vals)
        from collections import namedtuple

        cls = namedtuple(spec["name"], spec["fields"])
        return cls(**vals)
    raise ValueError(f"bad spec kind {kind!r}")


def load_pytree(path: str, namedtuple_types: dict | None = None):
    """Inverse of `save_pytree`.  ``namedtuple_types``: optional mapping of
    NamedTuple class names -> classes to reconstruct the original types."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != "__spec__"}
        spec = json.loads(bytes(z["__spec__"].tobytes()).decode())
    return _unflatten(spec, arrays, namedtuple_types)
