"""Scheme registration + (de)serialization — the equivalent of the
reference's ``register.go`` / ``zz_generated.deepcopy.go`` codec layer
(SURVEY.md C5/C9; ``SchemeGroupVersion`` + ``DirectCodecFactory`` in
images/tf6.PNG).

Where the reference registers Go types with a runtime.Scheme and lets
codegen produce deepcopy/codecs, here a single generic encoder/decoder walks
the dataclass field types: enums serialize by value, enum-keyed dicts (the
``replica_specs`` map) serialize by the enum's value, and kinds round-trip
through the ``SCHEME`` registry keyed by the object's ``kind`` field.

Two encodings share one decoder:

- ``to_dict`` — internal snake_case dump (tests, logs, legacy bodies);
- ``to_wire`` — the KUBERNETES wire form served over HTTP
  (client/apiserver.py): camelCase keys from dataclass field names (map
  keys like labels/annotations/replica-type names pass through verbatim),
  an ``apiVersion``/``kind`` envelope on every top-level object,
  ``metadata.resourceVersion`` as an opaque string, and timestamps as
  RFC3339 — the JSON a client-go-shaped tool expects at
  ``/apis/<group>/<version>/...`` (k8s-operator.md:33-34, images/tf5-tf6
  ``APIPath="/apis"``).

``from_dict``/``decode_object`` accept BOTH casings (each dataclass field
is looked up by camelCase first, then snake_case), so k8s-conventional
manifests and the legacy snake form both decode.
"""

from __future__ import annotations

import dataclasses
import datetime
import enum
import typing
from typing import Any, Dict, Type, get_args, get_origin, get_type_hints

from tfk8s_tpu_torch import API_VERSION
from tfk8s_tpu_torch.api import types as t

# kind -> class; the runtime.Scheme equivalent.
SCHEME: Dict[str, type] = dict(t.TOP_LEVEL_KINDS)

def api_version_of(kind: str) -> str:
    """The group/version a kind serves under, from its class default
    (TPUJob -> the CRD group; Pod/Service -> core)."""
    for f in dataclasses.fields(SCHEME[kind]):
        if f.name == "api_version" and isinstance(f.default, str):
            return f.default
    return API_VERSION


def register(kind: str, cls: type) -> None:
    SCHEME[kind] = cls


def to_dict(obj: Any) -> Any:
    """Encode a dataclass (or nested structure) to JSON-safe primitives."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            out[f.name] = to_dict(getattr(obj, f.name))
        return out
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {_key_to_str(k): to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    return obj


def _key_to_str(k: Any) -> str:
    return k.value if isinstance(k, enum.Enum) else str(k)


def _camel(name: str) -> str:
    first, *rest = name.split("_")
    return first + "".join(p[:1].upper() + p[1:] for p in rest)


def _rfc3339(epoch: float) -> str:
    # MicroTime precision: k8s RFC3339 allows fractional seconds, and the
    # store's TTL/ordering logic compares these as floats — keep the
    # round-trip lossless to the microsecond.
    return (
        datetime.datetime.fromtimestamp(epoch, datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%S.%fZ")
    )


def to_wire(obj: Any) -> Any:
    """Encode to the Kubernetes wire form (module docstring). Dataclass
    field names camelCase (the ``api_version`` field becomes the
    ``apiVersion`` envelope key); plain-dict keys (labels, replica-type
    names) are data and pass through verbatim; timestamps RFC3339;
    ``metadata.resourceVersion`` an opaque string."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if f.name == "resource_version":
                out["resourceVersion"] = str(v)
            elif (
                # explicit registry (types.RFC3339 field metadata), not a
                # name heuristic — a numeric duration named *_time passes
                # through untouched (r3 advisor finding)
                f.metadata.get("wire") == "rfc3339"
                and isinstance(v, (int, float))
                and not isinstance(v, bool)
            ):
                out[_camel(f.name)] = _rfc3339(float(v))
            else:
                out[_camel(f.name)] = to_wire(v)
        return out
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {_key_to_str(k): to_wire(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_wire(v) for v in obj]
    return obj


def from_dict(cls: Type, data: Any) -> Any:
    """Decode primitives into an instance of dataclass ``cls``, following the
    declared field types (including Optional/List/Dict and enum keys)."""
    return _decode(cls, data)


def decode_object(data: Dict[str, Any]) -> Any:
    """Decode a top-level object by its ``kind`` via the scheme."""
    kind = data.get("kind", "")
    if kind not in SCHEME:
        raise KeyError(f"kind {kind!r} is not registered in the scheme")
    return _decode(SCHEME[kind], data)


def _decode(tp: Any, data: Any) -> Any:
    if data is None:
        return None
    origin = get_origin(tp)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in get_args(tp) if a is not type(None)]
        return _decode(args[0], data) if args else data
    if origin in (dict,):
        kt, vt = get_args(tp) or (str, Any)
        return {_decode(kt, k): _decode(vt, v) for k, v in data.items()}
    if origin is tuple:
        args = get_args(tp)
        if len(args) == 2 and args[1] is Ellipsis:  # Tuple[X, ...]
            return tuple(_decode(args[0], v) for v in data)
        if args:  # fixed-arity Tuple[X, Y, ...]
            return tuple(_decode(a, v) for a, v in zip(args, data))
        return tuple(data)
    if origin is list:
        (vt,) = get_args(tp) or (Any,)
        return [_decode(vt, v) for v in data]
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return tp(data)
    if dataclasses.is_dataclass(tp):
        hints = get_type_hints(tp)
        kwargs = {}
        for f in dataclasses.fields(tp):
            # wire form (camelCase) first, legacy snake_case second
            camel = _camel(f.name)
            if camel in data:
                kwargs[f.name] = _decode(hints[f.name], data[camel])
            elif f.name in data:
                kwargs[f.name] = _decode(hints[f.name], data[f.name])
        return tp(**kwargs)
    # wire-form scalar coercions: resourceVersion is an opaque string of
    # an int; timestamps are RFC3339 strings of epoch floats
    if tp is int and isinstance(data, str):
        return int(data)
    if tp is float and isinstance(data, str):
        try:
            return float(data)
        except ValueError:
            # RFC3339 in any legal spelling ("Z" or numeric offset)
            dt = datetime.datetime.fromisoformat(data.replace("Z", "+00:00"))
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=datetime.timezone.utc)
            return dt.timestamp()
    return data


def roundtrip(obj: Any) -> Any:
    """Encode then decode via the scheme — used by tests to assert lossless
    round-trip serialization (the ``DirectCodecFactory`` parity check)."""
    return decode_object(to_dict(obj))
