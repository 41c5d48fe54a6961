"""Pass 2 (static half): page-ledger protocol checker (``PL20x``), the
PyTorch port's copy of ``repro/analysis/lint/ledger.py``.

Checks the *call-site protocol* around the placement refcount API of
:class:`~repro_torch.serving.memory.placement.BankAwarePlacement` --
``alloc``/``ref``/``unref``/``free`` -- plus the host-pin contract of
:class:`~repro_torch.serving.memory.tiered.TieredStatePool`.  The runtime
half (:mod:`.runtime`, ``PL25x``) catches what static analysis cannot:
actual refcount arithmetic.

Rules (receivers are matched by name -- a call counts as a ledger call
when it goes through something called ``placement``, e.g.
``self.placement.alloc(...)`` or a bare ``placement.ref(...)``):

  * ``PL201`` an ``alloc`` result consumed without a ``None`` guard --
    the allocator returns ``None`` under page pressure, not ``[]``;
  * ``PL202`` a module that acquires references (``alloc``/``ref``) but
    contains no release site (``unref``) at all;
  * ``PL203`` a function that pops a request from ``page_table`` without
    releasing (``unref``) or extracting to a spill -- a structural leak;
  * ``PL204`` any call to ``placement.free`` -- the pre-refcount alias;
    copy-on-write sharers require ``unref``;
  * ``PL205`` a ``spill`` method on a host-tiered class (one that touches
    ``self.host``, as ``TieredStatePool`` does) that never pins the blob
    bytes -- live state must not be droppable from the host cache;
  * ``PL206`` a transient-failure allocation call (``pool.register`` /
    ``grow``/``resume``/``fork`` of ``PagedStatePool``, ``host.pin``)
    outside any bounded retry / degradation wrapper -- these return falsy
    under pressure and the caller must escalate, not assume success.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Set

from repro_torch.analysis.lint.findings import Finding, apply_suppressions

_ACQUIRE = {"alloc", "ref"}
_RELEASE = {"unref"}

#: transient-failure allocation sites: (receiver name, attr names)
_TRANSIENT_SITES = (("pool", {"register", "grow", "resume", "fork"}),
                    ("host", {"pin"}))
#: identifier substrings that mark a retry/escalation context
_ESCALATION_MARKS = ("retry", "degrade", "escalate")


def _is_transient_alloc_call(node: ast.Call) -> bool:
    f = node.func
    if not isinstance(f, ast.Attribute):
        return False
    recv = f.value
    if isinstance(recv, ast.Name):
        recv_name = recv.id
    elif isinstance(recv, ast.Attribute):
        recv_name = recv.attr
    else:
        return False
    return any(recv_name == r and f.attr in ops
               for r, ops in _TRANSIENT_SITES)


def _has_escalation_context(fn, name: Optional[str]) -> bool:
    """The function is itself a retry/escalation wrapper (by name) or
    routes through one (references an identifier carrying a mark)."""
    idents = {(name or "").lower()}
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            idents.add(node.id.lower())
        elif isinstance(node, ast.Attribute):
            idents.add(node.attr.lower())
    return any(m in ident for ident in idents for m in _ESCALATION_MARKS)


def _own_nodes(fn):
    """Walk ``fn`` without descending into nested function definitions
    (those are visited on their own, inheriting the parent's escalation
    context); lambdas stay part of the enclosing function."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(ast.iter_child_nodes(node))


def _is_placement_call(node: ast.Call, ops: Set[str]) -> bool:
    f = node.func
    if not (isinstance(f, ast.Attribute) and f.attr in ops):
        return False
    recv = f.value
    if isinstance(recv, ast.Name):
        return recv.id == "placement"
    if isinstance(recv, ast.Attribute):
        return recv.attr == "placement"
    return False


def _fn_name(node: ast.AST) -> Optional[str]:
    return node.name if isinstance(
        node, (ast.FunctionDef, ast.AsyncFunctionDef)) else None


def _guarded_names(fn: ast.AST) -> Set[str]:
    """Names that appear in any if/while/assert test within ``fn`` --
    the conservative notion of 'checked before use'."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        test = None
        if isinstance(node, (ast.If, ast.While)):
            test = node.test
        elif isinstance(node, ast.Assert):
            test = node.test
        if test is not None:
            out |= {n.id for n in ast.walk(test) if isinstance(n, ast.Name)}
    return out


def _check_function(fn, path: str, host_tier_classes: Set[str],
                    cls: Optional[str], out: List[Finding],
                    escalated: bool = False) -> None:
    name = _fn_name(fn)
    guarded = _guarded_names(fn)
    has_release = False
    mentions_spill = "spill" in (name or "").lower()
    pins = False

    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute):
            # a direct host.pin or delegation to a pin helper
            # (e.g. _pin_with_retry) satisfies the spill contract
            low = f.attr.lower()
            if f.attr == "pin" or ("pin" in low and "unpin" not in low):
                pins = True
            if _is_placement_call(node, _RELEASE):
                has_release = True
            if _is_placement_call(node, {"free"}):
                out.append(Finding(
                    "PL204",
                    f"`placement.free` in `{name}` is the pre-refcount "
                    f"alias; copy-on-write sharers need `unref`",
                    path, node.lineno))
            if not mentions_spill:
                mentions_spill = "spill" in f.attr.lower()

    # PL201: alloc result assigned to a name never seen in a guard
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call) and \
                _is_placement_call(node.value, {"alloc"}):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            for t in targets:
                if t not in guarded:
                    out.append(Finding(
                        "PL201",
                        f"`{t} = placement.alloc(...)` in `{name}` is "
                        f"consumed without a None guard; alloc returns "
                        f"None under page pressure", path, node.lineno))

    # PL203: page_table.pop without a release path in the same function
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "pop" and \
                isinstance(node.func.value, ast.Attribute) and \
                node.func.value.attr == "page_table":
            if not (has_release or mentions_spill):
                out.append(Finding(
                    "PL203",
                    f"`page_table.pop` in `{name}` with no "
                    f"`placement.unref` or spill extraction on any path "
                    f"-- the popped request's pages leak",
                    path, node.lineno))

    # PL206: transient alloc/pin call with no retry/escalation context
    if not (escalated or _has_escalation_context(fn, name)):
        for node in _own_nodes(fn):
            if isinstance(node, ast.Call) and _is_transient_alloc_call(node):
                out.append(Finding(
                    "PL206",
                    f"`{ast.unparse(node.func)}` in `{name}` can fail "
                    f"transiently under pressure; route it through a "
                    f"bounded retry / degradation wrapper",
                    path, node.lineno))

    # PL205: host-tiered spill that never pins
    if cls in host_tier_classes and name and \
            name.lower().startswith("spill") and not pins:
        out.append(Finding(
            "PL205",
            f"`{cls}.{name}` spills on a host-tiered pool without "
            f"pinning the blob bytes (`host.pin`); the host cache may "
            f"drop live state", path, fn.lineno))


def lint_ledger_protocol(files: Sequence[str]) -> List[Finding]:
    out: List[Finding] = []
    for path in files:
        try:
            with open(path) as fh:
                src = fh.read()
            tree = ast.parse(src, filename=path)
        except (OSError, SyntaxError):
            continue

        # classes that touch self.host are host-tiered
        host_tier: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Attribute) and \
                            isinstance(sub.value, ast.Name) and \
                            sub.value.id == "self" and sub.attr == "host":
                        host_tier.add(node.name)
                        break

        acquires = releases = False
        first_acquire_line = 0
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                if _is_placement_call(node, _ACQUIRE):
                    if not acquires:
                        first_acquire_line = node.lineno
                    acquires = True
                elif _is_placement_call(node, _RELEASE):
                    releases = True

        def walk_scope(scope, cls: Optional[str], escalated: bool = False):
            for child in ast.iter_child_nodes(scope):
                if isinstance(child, ast.ClassDef):
                    walk_scope(child, child.name, escalated)
                elif isinstance(child,
                                (ast.FunctionDef, ast.AsyncFunctionDef)):
                    _check_function(child, path, host_tier, cls, out,
                                    escalated)
                    walk_scope(child, cls, escalated or
                               _has_escalation_context(child, child.name))

        walk_scope(tree, None)

        # PL202: module acquires but never releases
        if acquires and not releases:
            out.append(Finding(
                "PL202",
                "module takes page references (placement.alloc/ref) but "
                "contains no release site (placement.unref)",
                path, first_acquire_line))
    return apply_suppressions(out)
