"""Pass 1: AST step-hazard linter (``JH1xx``), the PyTorch port's twin of
``repro/analysis/lint/jit_hazards.py``.

The JAX pass guards compiled executables against retraces.  The port has no
jit: its steppers are eager PyTorch, watched by the recompile watcher
(``obs.wrap_step`` / ``RecompileWatcher.wrap``), and the step they run is the
one a CUDA graph would capture.  The same six codes name what such a step
cannot hold:

  * ``JH101`` a host sync reachable from a watched stepper: ``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()``, ``np.asarray``/``np.array``,
    ``int()``/``float()``/``bool()`` of a tensor, ``torch.nonzero`` /
    ``.nonzero()``, and indexing or index-assignment with a boolean mask (a
    name bound to a comparison, ``keep = slot < cap``);
  * ``JH102`` a Python ``if``/``while`` on a tensor's value;
  * ``JH103`` a shape taken from ``len()``/``max()`` of mutating batch
    state in a module that feeds watched steppers -- a new watcher
    signature, and a new capture under a CUDA graph;
  * ``JH104`` a watched stepper that returns a new pool-sized tensor made
    from its ``pools``/``caches`` argument, where it could write in place;
  * ``JH105`` a dict built from a set-derived iterable inside a watched
    stepper -- the leaf order of the watcher's signature changes;
  * ``JH106`` a watched stepper reading ``self`` attributes that another
    method reassigns -- a captured graph replays a stale tensor.

Reachability: the roots are the functions handed to ``wrap_step(...)`` /
``wrap(...)`` (through ``functools.partial``, a module alias such as
``M.decode_step``, a method, or a ``self`` attribute bound to one of
those); the walk follows calls across the linted modules through their
imports (``from pkg import mod as M`` then ``M.f(...)``, ``from mod import
f``), ``self.method(...)`` and ``self.attr.method(...)`` where the
attribute is bound to a known class, and parameters annotated with one.
Tensors are the parameters annotated ``torch.Tensor`` and every name bound
from a ``torch.*`` call or from a tensor.  The rule set is heuristic --
suppress justified sites with ``# lint: disable=JH1xx`` and let the
committed baseline ratchet the rest.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.lint.findings import Finding, apply_suppressions

#: the recompile watcher's wrap entry points: their first argument is a root
_WRAP_NAMES = {"wrap_step", "wrap"}

#: zero-argument tensor methods that copy to the host or wait for it
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "nonzero"}
#: module-level functions that read a tensor on the host (numpy's, when
#: their argument is a tensor)
_SYNC_FUNCS = {("np", "asarray"), ("np", "array"), ("numpy", "asarray"),
               ("numpy", "array"), ("torch", "nonzero")}
#: builtins that turn a tensor into a Python value
_SCALAR_BUILTINS = {"int", "float", "bool"}

#: attributes and methods that return static metadata, killing taint
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "numel", "dim", "size", "stride", "element_size",
                 "is_contiguous", "data_ptr", "type"}

#: comparison operators whose result on a tensor is a boolean mask
_MASK_OPS = (ast.Lt, ast.Gt, ast.LtE, ast.GtE, ast.Eq, ast.NotEq)

#: array constructors whose first argument is a shape
_SHAPE_CTORS = {"zeros", "ones", "empty", "full"}
#: converters whose argument's *slicing* determines the shape
_CONVERTERS = {"asarray", "array", "as_tensor", "tensor"}

#: buffer parameter names a stepper should update in place
_POOL_PARAMS = {"pools", "pool", "caches", "buffers"}
#: tensor methods / torch functions that return a new tensor
_FRESH_METHODS = {"clone", "to", "contiguous", "index_put", "scatter",
                  "masked_fill", "index_copy", "index_add", "add", "mul",
                  "where", "float", "double", "half", "bfloat16"}
_FRESH_FUNCS = {"cat", "stack", "where", "clone", "zeros_like", "empty_like",
                "ones_like", "full_like", "index_put", "scatter"}


def _dotted(node: ast.AST) -> Optional[Tuple[str, str]]:
    """("np", "zeros") for ``np.zeros`` / ("", "zeros") for bare calls."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        return node.value.id, node.attr
    if isinstance(node, ast.Name):
        return "", node.id
    return None


def _module_name(path: str) -> str:
    """Dotted module name of ``path``, walking up through packages."""
    path = os.path.abspath(path)
    d, base = os.path.split(path)
    parts = [] if base == "__init__.py" else [base[:-3]]
    while os.path.isfile(os.path.join(d, "__init__.py")):
        d, pkg = os.path.split(d)
        parts.insert(0, pkg)
    return ".".join(parts) or base[:-3]


# ---------------------------------------------------------------------------
# the index: functions, classes and imports of every linted module
# ---------------------------------------------------------------------------


class _Fn:
    """One top-level function or method."""

    def __init__(self, node, module: "_Module", cls: Optional[str]):
        self.node = node
        self.module = module
        self.cls = cls
        self.qualname = f"{cls}.{node.name}" if cls else node.name

    @property
    def key(self) -> Tuple[str, str]:
        return self.module.name, self.qualname


class _Class:
    def __init__(self, node: ast.ClassDef):
        self.node = node
        self.methods: Dict[str, ast.AST] = {}
        #: self attribute -> the expressions bound to it
        self.binds: Dict[str, List[ast.AST]] = {}
        #: attributes assigned outside __init__
        self.mutable: Set[str] = set()


class _Module:
    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.name = _module_name(path)
        self.functions: Dict[str, ast.AST] = {}
        self.classes: Dict[str, _Class] = {}
        #: local name -> dotted module
        self.modules: Dict[str, str] = {}
        #: local name -> (dotted module, attribute)
        self.symbols: Dict[str, Tuple[str, str]] = {}
        #: (expression handed to a wrap site, enclosing class)
        self.wrap_args: List[Tuple[ast.AST, Optional[str]]] = []
        self._index()

    def _index(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.modules[a.asname] = a.name
                    else:
                        self.modules[a.name.split(".")[0]] = \
                            a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    up = self.name.split(".")
                    up = up[:len(up) - node.level] if \
                        os.path.basename(self.path) != "__init__.py" else \
                        up[:len(up) - node.level + 1]
                    base = ".".join(up + ([base] if base else []))
                for a in node.names:
                    self.symbols[a.asname or a.name] = (base, a.name)
        for node in self.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                self._index_class(node)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef):
                for sub in ast.walk(node):
                    self._note_wrap(sub, node.name)
        cls_nodes = {id(n) for c in self.classes.values()
                     for n in ast.walk(c.node)}
        for node in ast.walk(self.tree):
            if id(node) not in cls_nodes:
                self._note_wrap(node, None)

    def _note_wrap(self, node: ast.AST, cls: Optional[str]) -> None:
        if isinstance(node, ast.Call) and node.args and _wrap_call(node):
            self.wrap_args.append((node.args[0], cls))

    def _index_class(self, node: ast.ClassDef) -> None:
        c = _Class(node)
        self.classes[node.name] = c
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                c.methods[item.name] = item
                for sub in ast.walk(item):
                    if not isinstance(sub, (ast.Assign, ast.AnnAssign)):
                        continue
                    targets = (sub.targets if isinstance(sub, ast.Assign)
                               else [sub.target])
                    for t in targets:
                        if isinstance(t, ast.Attribute) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id == "self":
                            if sub.value is not None:
                                c.binds.setdefault(t.attr, []).append(
                                    sub.value)
                            if item.name != "__init__":
                                c.mutable.add(t.attr)


def _wrap_call(call: ast.Call) -> bool:
    f = call.func
    name = f.attr if isinstance(f, ast.Attribute) else \
        f.id if isinstance(f, ast.Name) else None
    return name in _WRAP_NAMES


class _Index:
    """Every linted module, with name resolution across them."""

    def __init__(self, modules: Iterable[_Module]):
        self.modules: Dict[str, _Module] = {m.name: m for m in modules}

    # -- name resolution ---------------------------------------------

    def lookup(self, mod: _Module, name: str, depth: int = 0):
        """What ``name`` means in ``mod``: ("fn", module, node), ("cls",
        module, _Class), ("mod", module) or None."""
        if depth > 8:
            return None
        if name in mod.functions:
            return "fn", mod, mod.functions[name]
        if name in mod.classes:
            return "cls", mod, mod.classes[name]
        if name in mod.modules:
            m = self.modules.get(mod.modules[name])
            return ("mod", m) if m else None
        if name in mod.symbols:
            base, attr = mod.symbols[name]
            sub = self.modules.get(f"{base}.{attr}" if base else attr)
            if sub is not None:
                return "mod", sub
            m = self.modules.get(base)
            if m is not None:
                return self.lookup(m, attr, depth + 1)
        return None

    def class_method(self, mod: _Module, cls: _Class, name: str,
                     depth: int = 0):
        """(module, class, method node) of ``cls.name``, bases included."""
        if name in cls.methods:
            return mod, cls, cls.methods[name]
        if depth > 8:
            return None
        for base in cls.node.bases:
            r = self.resolve_class(mod, base)
            if r is not None:
                got = self.class_method(r[0], r[1], name, depth + 1)
                if got is not None:
                    return got
        return None

    def class_binds(self, mod: _Module, cls: _Class, attr: str,
                    depth: int = 0) -> List[Tuple[_Module, _Class, ast.AST]]:
        out = [(mod, cls, e) for e in cls.binds.get(attr, ())]
        if depth <= 8:
            for base in cls.node.bases:
                r = self.resolve_class(mod, base)
                if r is not None:
                    out += self.class_binds(r[0], r[1], attr, depth + 1)
        return out

    def resolve_class(self, mod: _Module, expr: ast.AST):
        """(module, _Class) an expression (a name or ``M.Name``, maybe
        inside ``Optional[...]``) denotes, or None."""
        if isinstance(expr, ast.Subscript):
            return self.resolve_class(mod, expr.slice)
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            try:
                return self.resolve_class(
                    mod, ast.parse(expr.value, mode="eval").body)
            except SyntaxError:
                return None
        if isinstance(expr, ast.Name):
            r = self.lookup(mod, expr.id)
        elif isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name):
            r = self.lookup(mod, expr.value.id)
            if r is None or r[0] != "mod":
                return None
            r = self.lookup(r[1], expr.attr)
        else:
            return None
        if r is not None and r[0] == "cls":
            return r[1], r[2]
        return None

    def attr_class(self, mod: _Module, cls: _Class, attr: str):
        """The class a ``self.attr`` is bound to (``self.attr = C(...)``)."""
        for m, _, e in self.class_binds(mod, cls, attr):
            if isinstance(e, ast.Call):
                r = self.resolve_class(m, e.func)
                if r is not None:
                    return r
        return None

    def callables(self, mod: _Module, cls: Optional[str], expr: ast.AST,
                  local_types: Dict[str, Tuple[_Module, _Class]],
                  seen: Optional[Set[int]] = None) -> List[_Fn]:
        """The functions an expression in ``mod`` (inside class ``cls``)
        may call: a function, ``M.f``, ``self.m``, ``self.attr.m``,
        ``x.m`` for a typed local ``x``, ``partial(f, ...)``, a wrap
        call's argument, or a ``self`` attribute bound to any of these."""
        seen = set() if seen is None else seen
        if id(expr) in seen:
            return []
        seen.add(id(expr))
        klass = mod.classes.get(cls) if cls else None
        if isinstance(expr, ast.Call):
            d = _dotted(expr.func)
            if d and d[1] == "partial" and expr.args:
                return self.callables(mod, cls, expr.args[0], local_types,
                                      seen)
            if _wrap_call(expr) and expr.args:
                return self.callables(mod, cls, expr.args[0], local_types,
                                      seen)
            return []
        if isinstance(expr, ast.Name):
            r = self.lookup(mod, expr.id)
            if r is not None and r[0] == "fn":
                return [_Fn(r[2], r[1], None)]
            return []
        if not isinstance(expr, ast.Attribute):
            return []
        v = expr.value
        if isinstance(v, ast.Name) and v.id == "self" and klass is not None:
            got = self.class_method(mod, klass, expr.attr)
            if got is not None:
                return [_Fn(got[2], got[0], got[1].node.name)]
            out: List[_Fn] = []
            for m, c, e in self.class_binds(mod, klass, expr.attr):
                out += self.callables(m, c.node.name, e, {}, seen)
            return out
        owner = None
        if isinstance(v, ast.Name):
            if v.id in local_types:
                owner = local_types[v.id]
            else:
                r = self.lookup(mod, v.id)
                if r is not None and r[0] == "mod":
                    r2 = self.lookup(r[1], expr.attr)
                    if r2 is not None and r2[0] == "fn":
                        return [_Fn(r2[2], r2[1], None)]
                    return []
                if r is not None and r[0] == "cls":
                    owner = (r[1], r[2])
        elif isinstance(v, ast.Attribute) and isinstance(v.value, ast.Name) \
                and v.value.id == "self" and klass is not None:
            owner = self.attr_class(mod, klass, v.attr)
        if owner is not None:
            got = self.class_method(owner[0], owner[1], expr.attr)
            if got is not None:
                return [_Fn(got[2], got[0], got[1].node.name)]
        return []

    def local_types(self, fn: _Fn) -> Dict[str, Tuple[_Module, _Class]]:
        """Parameters annotated with a known class, and locals bound to
        ``C(...)``."""
        out: Dict[str, Tuple[_Module, _Class]] = {}
        a = fn.node.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if p.annotation is not None:
                r = self.resolve_class(fn.module, p.annotation)
                if r is not None:
                    out[p.arg] = r
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                r = self.resolve_class(fn.module, node.value.func)
                if r is not None:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            out[t.id] = r
        return out

    def callees(self, fn: _Fn) -> List[_Fn]:
        types = self.local_types(fn)
        out: List[_Fn] = []
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call):
                out += self.callables(fn.module, fn.cls, node.func, types)
                # functions handed on as arguments (partial, callbacks)
                for arg in node.args:
                    if isinstance(arg, (ast.Name, ast.Attribute, ast.Call)):
                        out += self.callables(fn.module, fn.cls, arg, types)
        return out

    def roots(self) -> List[_Fn]:
        out: List[_Fn] = []
        for mod in self.modules.values():
            for expr, cls in mod.wrap_args:
                out += self.callables(mod, cls, expr, {})
        return out

    def reachable(self, roots: Sequence[_Fn]) -> Dict[Tuple[str, str], _Fn]:
        seen: Dict[Tuple[str, str], _Fn] = {}
        todo = list(roots)
        while todo:
            fn = todo.pop()
            if fn.key in seen:
                continue
            seen[fn.key] = fn
            todo.extend(c for c in self.callees(fn) if c.key not in seen)
        return seen


# ---------------------------------------------------------------------------
# taint: names that hold tensors
# ---------------------------------------------------------------------------


def _is_tensor_annotation(ann: Optional[ast.AST]) -> bool:
    if ann is None:
        return False
    return any(isinstance(n, ast.Attribute) and n.attr == "Tensor"
               or isinstance(n, ast.Name) and n.id == "Tensor"
               for n in ast.walk(ann))


def _bound_names(target: ast.AST) -> Set[str]:
    """Names an assignment target binds: a name, the names of a tuple, or
    the base of ``x[i] = ...`` / ``x.a = ...`` (not its index)."""
    if isinstance(target, ast.Name):
        return {target.id}
    if isinstance(target, (ast.Tuple, ast.List)):
        return set().union(*(_bound_names(e) for e in target.elts))
    if isinstance(target, ast.Starred):
        return _bound_names(target.value)
    if isinstance(target, (ast.Subscript, ast.Attribute)):
        return _bound_names(target.value)
    return set()


def _mentions(e: ast.AST, names: Set[str]) -> bool:
    """``e`` reads a name of ``names`` other than through static
    metadata (``x.shape``, ``x.device``, ``x.numel()``, ``len(x)`` ...)."""
    if isinstance(e, ast.Attribute) and e.attr in _STATIC_ATTRS:
        return False
    if isinstance(e, ast.Call) and isinstance(e.func, ast.Name) and \
            e.func.id in ("len", "isinstance", "type", "callable"):
        return False
    if isinstance(e, ast.Name):
        return e.id in names
    if isinstance(e, (ast.Lambda, ast.FunctionDef)):
        return False
    return any(_mentions(c, names) for c in ast.iter_child_nodes(e))


def _torch_call(e: ast.AST) -> bool:
    """``e`` contains a call of a ``torch.*`` / ``F.*`` tensor function."""
    for sub in ast.walk(e):
        if isinstance(sub, ast.Call):
            d = _dotted(sub.func)
            if d and d[0] in ("torch", "Fn") and d[1] not in _STATIC_ATTRS \
                    and d[1] not in ("device", "dtype", "Generator",
                                     "Size", "is_tensor"):
                return True
    return False


def _tensor_names(fn) -> Set[str]:
    """Fixed point of 'bound from a tensor': parameters annotated
    ``torch.Tensor`` seed it, ``torch.*`` calls add to it."""
    a = fn.args
    names = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
             if _is_tensor_annotation(p.annotation)}
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, ast.AugAssign):
                value, targets = node.value, [node.target]
            else:
                continue
            if isinstance(value, ast.Tuple) or not (
                    _mentions(value, names) or _torch_call(value)):
                continue
            if isinstance(value, ast.Compare) and any(
                    isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                    for op in value.ops):
                continue
            new = set().union(*(_bound_names(t) for t in targets)) - names
            if new:
                names |= new
                changed = True
    return names


def _mask_names(fn, tensors: Set[str]) -> Set[str]:
    """Names bound to an elementwise comparison of a tensor (or a
    combination of such masks): a boolean mask."""
    masks: Set[str] = set()

    def is_mask(e: ast.AST) -> bool:
        if isinstance(e, ast.Compare):
            return all(isinstance(op, _MASK_OPS) for op in e.ops) and \
                _mentions(e, tensors)
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Invert):
            return is_mask(e.operand) or (
                isinstance(e.operand, ast.Name) and e.operand.id in masks)
        if isinstance(e, ast.BinOp) and \
                isinstance(e.op, (ast.BitAnd, ast.BitOr)):
            return any(is_mask(s) or isinstance(s, ast.Name)
                       and s.id in masks for s in (e.left, e.right))
        return False

    for _ in range(2):
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and is_mask(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        masks.add(t.id)
    return masks


def _mask_index(sl: ast.AST, masks: Set[str]) -> bool:
    elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
    return any(isinstance(e, ast.Name) and e.id in masks for e in elts)


def _static_guard(test: ast.AST) -> bool:
    """Tests that read no tensor value: ``x is None``, ``isinstance``."""
    if isinstance(test, ast.Compare) and any(
            isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
        return True
    if isinstance(test, ast.Call):
        d = _dotted(test.func)
        if d and d[1] in ("isinstance", "hasattr", "callable"):
            return True
    return False


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


def _check_reachable(fn: _Fn, out: List[Finding]) -> None:
    """JH101, JH102 and JH105 in a function a watched stepper reaches."""
    node_fn, path, q = fn.node, fn.module.path, fn.qualname
    tensors = _tensor_names(node_fn)
    masks = _mask_names(node_fn, tensors)
    for node in ast.walk(node_fn):
        if isinstance(node, (ast.If, ast.While)):
            if _mentions(node.test, tensors) and \
                    not _static_guard(node.test):
                out.append(Finding(
                    "JH102", f"`{q}` branches in Python on a tensor's "
                    f"value -- a host sync every step", path, node.lineno))
        elif isinstance(node, ast.Call):
            f = node.func
            d = _dotted(f)
            if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS \
                    and not node.args and d not in _SYNC_FUNCS:
                out.append(Finding(
                    "JH101", f"host sync `.{f.attr}()` in `{q}`, reached "
                    f"from a watched stepper", path, node.lineno))
            elif d in _SYNC_FUNCS and (d[0] == "torch" or node.args and
                                       _mentions(node.args[0], tensors)):
                out.append(Finding(
                    "JH101", f"host sync `{d[0]}.{d[1]}` in `{q}`, reached "
                    f"from a watched stepper", path, node.lineno))
            elif d and d[0] == "" and d[1] in _SCALAR_BUILTINS and \
                    node.args and _mentions(node.args[0], tensors):
                out.append(Finding(
                    "JH101", f"`{d[1]}()` of a tensor in `{q}`, reached "
                    f"from a watched stepper", path, node.lineno))
            elif d == ("", "dict") and _set_derived(node):
                out.append(Finding(
                    "JH105", f"dict built from a set-derived iterable in "
                    f"`{q}`, reached from a watched stepper", path,
                    node.lineno))
        elif isinstance(node, ast.DictComp) and _set_derived(node):
            out.append(Finding(
                "JH105", f"dict comprehension over a set-derived iterable "
                f"in `{q}`, reached from a watched stepper", path,
                node.lineno))
        elif isinstance(node, ast.Subscript) and masks and \
                _mask_index(node.slice, masks):
            what = ("index-assignment" if isinstance(node.ctx, ast.Store)
                    else "indexing")
            out.append(Finding(
                "JH101", f"boolean-mask {what} in `{q}` (a data-dependent "
                f"shape: the host waits for the mask), reached from a "
                f"watched stepper", path, node.lineno))


def _check_stale_attrs(fn: _Fn, out: List[Finding]) -> None:
    """JH106: a watched method reading ``self`` attributes that another
    method reassigns."""
    if fn.cls is None:
        return
    klass = fn.module.classes.get(fn.cls)
    if klass is None:
        return
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Attribute) and \
                isinstance(node.ctx, ast.Load) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self" and node.attr in klass.mutable and \
                node.attr not in klass.methods:
            out.append(Finding(
                "JH106", f"watched `{fn.qualname}` reads `self.{node.attr}`,"
                f" which other methods reassign -- a captured step replays "
                f"a stale value", fn.module.path, node.lineno))


def _set_derived(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Set):
            return True
        if isinstance(sub, ast.Call):
            d = _dotted(sub.func)
            if d in (("", "set"), ("", "frozenset")):
                return True
    return False


def _rooted(e: ast.AST, names: Set[str]) -> bool:
    """``e`` is a name of ``names``, or an attribute / subscript / method
    chain on one."""
    while isinstance(e, (ast.Attribute, ast.Subscript, ast.Call)):
        e = e.func if isinstance(e, ast.Call) else e.value
    return isinstance(e, ast.Name) and e.id in names


def _fresh_from(e: ast.AST, pools: Set[str]) -> bool:
    """``e`` builds a new tensor out of a pool buffer."""
    if isinstance(e, ast.Call):
        f = e.func
        if isinstance(f, ast.Attribute) and f.attr in _FRESH_METHODS and \
                _rooted(f.value, pools):
            return True
        d = _dotted(f)
        if d and d[0] == "torch" and d[1] in _FRESH_FUNCS and any(
                _rooted(a, pools) or isinstance(a, (ast.List, ast.Tuple))
                and any(_rooted(x, pools) for x in a.elts)
                for a in e.args):
            return True
    if isinstance(e, ast.BinOp):
        return _rooted(e.left, pools) or _rooted(e.right, pools)
    if isinstance(e, (ast.DictComp, ast.ListComp, ast.GeneratorExp)):
        inner = set(pools)
        for g in e.generators:
            if _rooted(g.iter, pools):
                inner |= {n.id for n in ast.walk(g.target)
                          if isinstance(n, ast.Name)}
        body = [e.value] if isinstance(e, ast.DictComp) else [e.elt]
        return inner != pools and any(_fresh_from(b, inner) for b in body)
    if isinstance(e, (ast.Tuple, ast.List)):
        return any(_fresh_from(x, pools) for x in e.elts)
    return False


def _check_pool_return(fn: _Fn, out: List[Finding]) -> None:
    """JH104: a watched stepper returning a new tensor made from its pool
    argument."""
    a = fn.node.args
    pools = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
             if p.arg in _POOL_PARAMS}
    if not pools:
        return
    fresh: Set[str] = set()
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Assign) and _fresh_from(node.value, pools):
            for t in node.targets:
                fresh |= _bound_names(t)
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Return) and node.value is not None and (
                _fresh_from(node.value, pools) or _mentions_any(
                    node.value, fresh)):
            out.append(Finding(
                "JH104", f"watched `{fn.qualname}` returns a new tensor "
                f"built from {sorted(pools)} -- the step allocates a "
                f"pool-sized buffer where it could write in place",
                fn.module.path, node.lineno))


def _mentions_any(e: ast.AST, names: Set[str]) -> bool:
    if isinstance(e, ast.Name):
        return e.id in names
    if isinstance(e, (ast.Tuple, ast.List)):
        return any(_mentions_any(x, names) for x in e.elts)
    return False


def _has_dyn_size_call(e: ast.AST) -> bool:
    for sub in ast.walk(e):
        if isinstance(sub, ast.Call):
            d = _dotted(sub.func)
            if d in (("", "len"), ("", "max"), ("", "min")):
                return True
    return False


def _check_dynamic_shapes(fn, qualname: str, path: str,
                          out: List[Finding]) -> None:
    """JH103: tensor shapes / slices sized by len()/max() of batch state."""
    dyn: Set[str] = set()
    for _ in range(2):
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and (
                    _has_dyn_size_call(node.value) or any(
                        isinstance(s, ast.Name) and s.id in dyn
                        for s in ast.walk(node.value))):
                for t in node.targets:
                    dyn |= _bound_names(t)

    def dynamic(e: ast.AST) -> bool:
        return _has_dyn_size_call(e) or any(
            isinstance(s, ast.Name) and s.id in dyn for s in ast.walk(e))

    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        d = _dotted(node.func)
        if not d or d[0] not in ("np", "numpy", "torch"):
            continue
        if d[1] in _SHAPE_CTORS and node.args and dynamic(node.args[0]):
            out.append(Finding(
                "JH103", f"`{d[0]}.{d[1]}` in `{qualname}` sized by "
                f"len()/max() of mutating batch state -- the watched "
                f"step's shapes churn with batch composition", path,
                node.lineno))
        elif d[1] in _CONVERTERS and node.args and any(
                isinstance(s, ast.Subscript)
                and isinstance(s.slice, ast.Slice)
                and any(b is not None and dynamic(b)
                        for b in (s.slice.lower, s.slice.upper))
                for s in ast.walk(node.args[0])):
            out.append(Finding(
                "JH103", f"`{d[0]}.{d[1]}` over a dynamically sliced "
                f"sequence in `{qualname}` -- one watcher signature per "
                f"distinct length", path, node.lineno))


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def _parse(files: Sequence[str]) -> List[_Module]:
    mods = []
    for path in files:
        try:
            with open(path) as fh:
                tree = ast.parse(fh.read(), filename=path)
        except (OSError, SyntaxError):
            continue
        mods.append(_Module(path, tree))
    return mods


def watched_roots(files: Sequence[str]) -> List[str]:
    """``module:qualname`` of every function handed to a wrap site."""
    idx = _Index(_parse(files))
    return sorted({f"{fn.module.name}:{fn.qualname}"
                   for fn in idx.roots()})


def lint_jit_hazards(files: Sequence[str]) -> List[Finding]:
    idx = _Index(_parse(files))
    roots = idx.roots()
    reach = idx.reachable(roots)
    out: List[Finding] = []
    for fn in reach.values():
        _check_reachable(fn, out)
    for fn in {r.key: r for r in roots}.values():
        _check_pool_return(fn, out)
        _check_stale_attrs(fn, out)
    for mod in idx.modules.values():
        if not mod.wrap_args:
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _check_dynamic_shapes(node, node.name, mod.path, out)
    # one finding per (code, site): a line with three masked subscripts
    # is one sync
    unique = {(f.code, f.file, f.line): f for f in out}
    return apply_suppressions(sorted(
        unique.values(), key=lambda f: (f.file, f.line, f.code)))
