"""Copy-on-write object freezing — the immutability substrate of the
control-plane hot path.

client-go's shared informers hand every consumer the SAME cached object
and make it work by convention: cached objects are treated as immutable,
so a read costs a pointer, not a deep copy. The Python port needs the
convention ENFORCED — a silent mutation of a shared object would
corrupt the store/cache for every other consumer with no trace. This
module provides that enforcement:

- :func:`freeze` walks an object IN PLACE: every plain ``dict``/``list``
  becomes a :class:`FrozenDict`/:class:`FrozenList` (same types for
  ``isinstance``/iteration/json, mutators raise), and every dataclass
  gets a guarded ``__setattr__`` plus a per-instance frozen flag.
  Idempotent; returns its argument.
- Mutating anything frozen raises :class:`FrozenObjectError` (a typed
  ``TypeError``) — the read-isolation contract the store tests pin.
- ``copy.deepcopy`` of a frozen object yields an ordinary MUTABLE deep
  copy (:func:`thaw` is the explicit spelling): the one escape hatch for
  clients that legitimately mutate (the kubelet's read-modify-write
  status loop goes through it at the typed-client boundary).

The store (client/store.py) freezes each object once at the write
barrier; get/list/watch/informer-cache reads then share the frozen
instance by reference. That single property is what turned the
control-plane bench's ~20 deepcopy sites (one per get/list/create/patch
plus one PER WATCHER per event) into one copy per write.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Set

_FROZEN_ATTR = "__tfk8s_frozen__"


class FrozenObjectError(TypeError):
    """Attempted mutation of a frozen (shared, copy-on-write) object.

    Raised by attribute writes on frozen dataclasses and by every
    mutating method of :class:`FrozenDict`/:class:`FrozenList`. Callers
    that need a mutable view take :func:`thaw` (or ``copy.deepcopy``)
    first — mutating in place would corrupt the store and every other
    consumer sharing the instance."""


def _blocked(name: str):
    def method(self, *args, **kwargs):
        raise FrozenObjectError(
            f"{type(self).__name__}.{name}(): object is frozen (shared "
            "copy-on-write state); thaw() it for a mutable copy"
        )

    method.__name__ = name
    return method


class FrozenDict(dict):
    """A dict whose mutators raise. Still a real ``dict`` for
    ``isinstance``, iteration, equality, and ``json.dumps``. Deep copies
    are plain mutable dicts."""

    __slots__ = ()

    __setitem__ = _blocked("__setitem__")
    __delitem__ = _blocked("__delitem__")
    clear = _blocked("clear")
    pop = _blocked("pop")
    popitem = _blocked("popitem")
    setdefault = _blocked("setdefault")
    update = _blocked("update")
    __ior__ = _blocked("__ior__")

    def __deepcopy__(self, memo):
        return {copy.deepcopy(k, memo): copy.deepcopy(v, memo) for k, v in self.items()}

    def __reduce__(self):
        return (FrozenDict, (dict(self),))


class FrozenList(list):
    """A list whose mutators raise; deep copies are plain lists."""

    __slots__ = ()

    __setitem__ = _blocked("__setitem__")
    __delitem__ = _blocked("__delitem__")
    __iadd__ = _blocked("__iadd__")
    __imul__ = _blocked("__imul__")
    append = _blocked("append")
    extend = _blocked("extend")
    insert = _blocked("insert")
    pop = _blocked("pop")
    remove = _blocked("remove")
    clear = _blocked("clear")
    sort = _blocked("sort")
    reverse = _blocked("reverse")

    def __deepcopy__(self, memo):
        return [copy.deepcopy(v, memo) for v in self]

    def __reduce__(self):
        return (FrozenList, (list(self),))


def _guarded_setattr(self, name: str, value: Any) -> None:
    if getattr(self, _FROZEN_ATTR, False):
        raise FrozenObjectError(
            f"cannot set {type(self).__name__}.{name}: object is frozen "
            "(shared copy-on-write state); thaw() it for a mutable copy"
        )
    object.__setattr__(self, name, value)


def _guarded_delattr(self, name: str) -> None:
    if getattr(self, _FROZEN_ATTR, False):
        raise FrozenObjectError(
            f"cannot delete {type(self).__name__}.{name}: object is frozen"
        )
    object.__delattr__(self, name)


def _deepcopy_thawed(self, memo):
    """deepcopy of a (possibly frozen) guarded dataclass: an ordinary
    MUTABLE deep copy — the frozen flag does not propagate, and frozen
    containers deep-copy to plain dict/list via their own hooks."""
    cls = type(self)
    new = object.__new__(cls)
    memo[id(self)] = new
    for k, v in self.__dict__.items():
        if k == _FROZEN_ATTR:
            continue
        object.__setattr__(new, k, copy.deepcopy(v, memo))
    return new


_guarded_classes: Set[type] = set()


def _ensure_guarded(cls: type) -> None:
    """Install the frozen-aware ``__setattr__``/``__deepcopy__`` on a
    dataclass type, once. Unfrozen instances pay one flag check per
    attribute write; frozen instances raise."""
    if cls in _guarded_classes:
        return
    if "__setattr__" not in cls.__dict__:
        cls.__setattr__ = _guarded_setattr  # type: ignore[assignment]
    if "__delattr__" not in cls.__dict__:
        cls.__delattr__ = _guarded_delattr  # type: ignore[assignment]
    if "__deepcopy__" not in cls.__dict__:
        cls.__deepcopy__ = _deepcopy_thawed  # type: ignore[attr-defined]
    _guarded_classes.add(cls)


def is_frozen(obj: Any) -> bool:
    if isinstance(obj, (FrozenDict, FrozenList)):
        return True
    return bool(getattr(obj, _FROZEN_ATTR, False))


def freeze(obj: Any) -> Any:
    """Freeze ``obj`` in place (dataclasses) / by wrapping (containers).
    Scalars, enums, and already-frozen values pass through. Returns the
    frozen value — for containers that is a NEW FrozenDict/FrozenList
    wrapping frozen children; for dataclasses it is ``obj`` itself with
    its fields rewritten to frozen values."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        if getattr(obj, _FROZEN_ATTR, False):
            return obj
        _ensure_guarded(type(obj))
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            fv = freeze(v)
            if fv is not v:
                object.__setattr__(obj, f.name, fv)
        object.__setattr__(obj, _FROZEN_ATTR, True)
        return obj
    if isinstance(obj, FrozenDict) or isinstance(obj, FrozenList):
        return obj
    if isinstance(obj, dict):
        return FrozenDict({k: freeze(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return FrozenList([freeze(v) for v in obj])
    if isinstance(obj, tuple):
        return tuple(freeze(v) for v in obj)
    return obj


def thaw(obj: Any) -> Any:
    """A mutable deep copy of a frozen object; non-frozen objects are
    returned AS IS (no copy) — the typed-client ``get()`` boundary uses
    this so local (frozen) reads copy exactly once and remote (already
    private) reads copy never."""
    if is_frozen(obj):
        return copy.deepcopy(obj)
    return obj
