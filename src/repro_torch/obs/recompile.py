"""Recompile watcher: the port's twin of ``repro/obs/recompile.py``.

A JAX stepper compiles one executable per distinct *abstract signature* of
its arguments (shapes, dtypes, tree structure, static values); a fresh
signature retraces and turns a ~3 ms step into a ~1 s one.  The port's
steppers are eager PyTorch around the CUDA kernels, so nothing recompiles
-- but each distinct signature is still one shape set the step runs at: the
set a CUDA graph of the step would have to capture, one graph per
signature.  ``RecompileWatcher.wrap`` puts a thin shim around a stepper
that:

  * forms the abstract signature of every call -- a tensor leaf is
    ``shape:dtype:device``; a Python scalar is its type, not its value
    (JAX traces scalars as weak scalars, so a new seed or length does not
    recompile); dicts, lists, tuples, NamedTuples, dataclasses and
    :class:`~repro_torch.core.formats.QuantizedTensor` (format and logical
    shape included, as the JAX tree's static data) are walked; anything
    else is its type name;
  * counts the distinct signatures the function has seen
    (``n_compiles``, the twin of the jit cache size), and on a new one
    records *which leaves changed* versus the previous new signature -- the
    leaf-level ``path: (old) -> (new)`` diff of the argument tree;
  * emits a ``recompile`` instant into the trace buffer and bumps the
    ``recompiles_total{fn=...}`` counter.

A steady call pays one walk of its arguments and one set lookup.  The
objects an engine keeps for its lifetime and never reshapes -- its
parameters, the pool's pools -- are declared once (``fixed``) and
described once; every call that passes one reuses that description, so no
step re-walks the parameter tree.  The wrapper forwards attribute access
to the wrapped function.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
import weakref
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.formats import QuantizedTensor

__all__ = ["RecompileEvent", "WatchedFunction", "RecompileWatcher",
           "jit_sites", "site_compile_counts", "clear_jit_sites"]

#: cap on reported changed-leaf entries per event (params trees are huge;
#: the churn is invariably in the handful of data arguments)
MAX_CHANGED = 20

#: module-level registry of every live wrapped site (name -> shim), as in
#: the JAX package: one source of truth for "which steppers does the
#: serving stack actually run".  Later wraps under the same name shadow
#: earlier ones (a rebuilt engine re-wraps its steppers).  Entries are weak
#: and die with their engine: a shim reaches its engine's parameters and
#: pools, which must not outlive it on the card.
_JIT_SITES: "weakref.WeakValueDictionary[str, WatchedFunction]" = \
    weakref.WeakValueDictionary()


def jit_sites() -> Dict[str, "WatchedFunction"]:
    """Snapshot of every wrapped site: name -> WatchedFunction shim."""
    return dict(_JIT_SITES)


def site_compile_counts() -> Dict[str, int]:
    """name -> distinct signatures seen, across every live wrap site."""
    return {name: wfn.n_compiles for name, wfn in _JIT_SITES.items()}


def clear_jit_sites() -> None:
    """Forget all registered sites (test isolation)."""
    _JIT_SITES.clear()


_SCALARS = (bool, int, float, str, type(None))


def _tensor_key(x):
    return (x.shape, x.dtype, x.device)


def _type_key(x):
    return type(x)


def _dict_key(x):
    return (dict, tuple([(k, _key(v)) for k, v in x.items()]))


def _seq_key(x):
    return (type(x), tuple([_key(v) for v in x]))


def _quantized_key(x):
    return (QuantizedTensor, x.fmt, tuple(x.shape),
            tuple([(k, _key(v)) for k, v in x.payload.items()]))


#: exact type -> key function; a steady step walks only these (types met
#: for the first time are classified once by ``_classify``)
_KEYS = {torch.Tensor: _tensor_key, dict: _dict_key, list: _seq_key,
         tuple: _seq_key, QuantizedTensor: _quantized_key}
_KEYS.update((t, _type_key) for t in _SCALARS)


def _classify(t: type):
    """The key function of a type met for the first time: tensors, scalars,
    dicts, sequences and NamedTuples by their base; a dataclass by its
    fields; anything else by its type."""
    for base in (torch.Tensor, dict) + _SCALARS:
        if issubclass(t, base):
            return _KEYS[base]
    if issubclass(t, (list, tuple)):
        return _seq_key
    if dataclasses.is_dataclass(t):
        names = tuple(f.name for f in dataclasses.fields(t))
        return lambda x: (t, tuple([_key(getattr(x, n)) for n in names]))
    return _type_key


def _key(x) -> Any:
    """Hashable abstract signature of one argument (see the module doc)."""
    f = _KEYS.get(type(x))
    if f is None:
        f = _KEYS[type(x)] = _classify(type(x))
    return f(x)


def _leaf_str(x) -> str:
    if isinstance(x, torch.Tensor):
        dtype = str(x.dtype).replace("torch.", "")
        return f"{tuple(x.shape)}:{dtype}:{x.device}"
    return type(x).__name__


def _walk(x, path: str, out: Dict[str, str]) -> None:
    """Leaf path (JAX ``keystr`` style) -> description, into ``out``."""
    if isinstance(x, QuantizedTensor):
        out[path] = f"QuantizedTensor[{x.fmt}]{tuple(x.shape)}"
        for k, v in x.payload.items():
            _walk(v, f"{path}.payload[{k!r}]", out)
    elif isinstance(x, dict):
        for k, v in x.items():
            _walk(v, f"{path}[{k!r}]", out)
    elif isinstance(x, tuple) and hasattr(x, "_fields"):       # NamedTuple
        for name, v in zip(x._fields, x):
            _walk(v, f"{path}.{name}", out)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _walk(v, f"{path}[{i}]", out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _walk(getattr(x, f.name), f"{path}.{f.name}", out)
    else:
        out[path] = _leaf_str(x)


def _describe(args: tuple, kwargs: dict) -> Dict[str, str]:
    """Leaf path -> ``shape:dtype:device`` (or type name) for the whole
    argument tree ``(args, kwargs)``."""
    out: Dict[str, str] = {}
    _walk((args, kwargs), "", out)
    return out


def _diff(old: Optional[Dict[str, str]],
          new: Dict[str, str]) -> List[str]:
    """Human-readable changed-leaf entries between two signatures."""
    if old is None:
        return ["<first compile>"]
    changed: List[str] = []
    for k, v in new.items():
        prev = old.get(k)
        if prev != v:
            changed.append(f"{k}: {prev or '<absent>'} -> {v}")
    for k in old:
        if k not in new:
            changed.append(f"{k}: {old[k]} -> <absent>")
    if len(changed) > MAX_CHANGED:
        changed = changed[:MAX_CHANGED] + [
            f"... {len(changed) - MAX_CHANGED} more leaves changed"]
    return changed or ["<new signature with identical leaves "
                       "(new structure variant)>"]


@dataclasses.dataclass
class RecompileEvent:
    fn: str
    n_compiles: int                 # distinct signatures after this one
    t: float                        # perf_counter stamp
    changed: List[str]              # leaf-level diff vs the prior signature
    signature: Dict[str, str]       # full abstract signature of this call

    @property
    def is_warmup(self) -> bool:
        """The function's very first signature (expected, not a
        regression)."""
        return self.n_compiles == 1


class WatchedFunction:
    """Shim around one stepper; transparent except for watching."""

    def __init__(self, fn, name: str, watcher: "RecompileWatcher"):
        self._fn = fn
        self.name = name
        self._watcher = watcher
        self._seen: set = set()
        self._last_signature: Optional[Dict[str, str]] = None

    @property
    def n_compiles(self) -> int:
        """Distinct signatures this function was called with (the twin of
        the JAX jit cache size)."""
        return len(self._seen)

    def key(self, *args, **kwargs):
        """The hashable abstract signature of one call: what every call
        pays for."""
        fixed = self._watcher._fixed
        ks = []
        for slot, a in itertools.chain(enumerate(args), kwargs.items()):
            hit = fixed.get(id(a))
            ks.append((slot, hit[1] if hit is not None and hit[0] is a
                       else _key(a)))
        return tuple(ks)

    def __call__(self, *args, **kwargs):
        key = self.key(*args, **kwargs)
        new = key not in self._seen
        sig = _describe(args, kwargs) if new else None
        out = self._fn(*args, **kwargs)
        if new:
            self._seen.add(key)
            self._watcher._record(self, len(self._seen), sig)
            self._last_signature = sig
        return out

    def __getattr__(self, item):
        if item == "_fn":               # not yet set (copy / unpickle)
            raise AttributeError(item)
        return getattr(self._fn, item)


class RecompileWatcher:
    """All watched functions of one engine share this event log."""

    def __init__(self, tracer=None, metrics=None):
        self.tracer = tracer
        self.metrics = metrics
        self.events: List[RecompileEvent] = []
        #: id -> (object, key) of the objects declared with ``fixed``
        self._fixed: Dict[int, tuple] = {}

    def fixed(self, *objs) -> None:
        """Declare objects the engine keeps for its lifetime and never
        reshapes in place (its parameters, the pool's pools): each is
        described now, once, and a call that passes it reuses that."""
        for o in objs:
            self._fixed[id(o)] = (o, _key(o))

    def wrap(self, fn, name: str) -> WatchedFunction:
        wfn = WatchedFunction(fn, name, self)
        _JIT_SITES[name] = wfn
        return wfn

    @property
    def n_events(self) -> int:
        return len(self.events)

    @property
    def n_recompiles(self) -> int:
        """Signatures beyond each function's expected first (warmup)
        one."""
        return sum(1 for e in self.events if not e.is_warmup)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.fn] = out.get(e.fn, 0) + 1
        return out

    def _record(self, wfn: WatchedFunction, n_compiles: int,
                signature: Dict[str, str]) -> None:
        ev = RecompileEvent(
            fn=wfn.name, n_compiles=n_compiles, t=time.perf_counter(),
            changed=_diff(wfn._last_signature, signature),
            signature=signature)
        self.events.append(ev)
        if self.metrics is not None:
            self.metrics.counter("recompiles_total", fn=wfn.name).inc()
        if self.tracer is not None:
            self.tracer.instant(
                "recompile", cat="jit", track="jit",
                ts=self.tracer.ts_of(ev.t), fn=wfn.name,
                n_compiles=n_compiles, warmup=ev.is_warmup,
                changed=ev.changed)
