"""Chrome-trace JSON schema validation (hand-rolled: no jsonschema dep).
PyTorch port of ``repro/obs/schema.py``: the same checks, features and CLI,
kept as the port's own copy so that ``repro_torch`` imports nothing of
``repro``.

``validate_chrome_trace`` checks structural validity of a trace emitted by
:class:`repro_torch.obs.trace.TraceBuffer` (and, deliberately, of any
Trace-Event-Format JSON): phase codes, required fields per phase, numeric
timestamps.  ``trace_features`` reports which observability signals the
trace actually contains, so CI can require them:

    PYTHONPATH=src python -m repro_torch.obs.schema out.json \
        --require steps,spans,bank,recompile

exits non-zero if the trace is structurally invalid or any required
feature is missing.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List, Set

__all__ = ["validate_chrome_trace", "trace_features", "main"]

_ALLOWED_PH = {"X", "B", "E", "i", "I", "C", "b", "e", "n", "s", "t", "f",
               "M", "P", "N", "O", "D"}
_NUMERIC = (int, float)

#: feature name -> human description (see ``trace_features``)
FEATURES = {
    "steps": "decode-step X events (cat='step')",
    "spans": "request lifecycle b/e span pairs (cat='request')",
    "bank": "per-bank traffic C counter events",
    "recompile": "recompile instant events (cat='jit')",
    "recompile_signature": "a recompile event carrying a changed-shape "
                           "signature",
    "tiered": "host-tier events: prefetch b/e spans (cat='prefetch') or "
              "tier promote/demote/hit instants (cat='tier')",
    "resilience": "fault-layer instants (cat='fault'): injections, "
                  "quarantines, watchdog trips, degradation rungs",
    "speculation": "per-step 'spec' C counter events (proposed/accepted "
                   "draft tokens from the speculative decode path)",
}


def _check_event(i: int, ev, errors: List[str]) -> None:
    where = f"traceEvents[{i}]"
    if not isinstance(ev, dict):
        errors.append(f"{where}: not an object")
        return
    ph = ev.get("ph")
    if ph not in _ALLOWED_PH:
        errors.append(f"{where}: unknown phase {ph!r}")
        return
    if not isinstance(ev.get("name"), str) or not ev["name"]:
        errors.append(f"{where}: missing/empty name")
    for field in ("pid", "tid"):
        if not isinstance(ev.get(field), int):
            errors.append(f"{where}: {field} must be an int")
    if ph != "M":                    # metadata events carry no timestamp
        if not isinstance(ev.get("ts"), _NUMERIC):
            errors.append(f"{where}: ts must be numeric")
    if ph == "X":
        dur = ev.get("dur")
        if not isinstance(dur, _NUMERIC) or dur < 0:
            errors.append(f"{where}: X event needs dur >= 0")
    if ph in ("b", "e", "n"):
        if "id" not in ev:
            errors.append(f"{where}: async event needs an id")
        if not isinstance(ev.get("cat"), str) or not ev.get("cat"):
            errors.append(f"{where}: async event needs a cat")
    if ph == "C":
        args = ev.get("args")
        if not isinstance(args, dict) or not args:
            errors.append(f"{where}: counter event needs non-empty args")
        elif not all(isinstance(v, _NUMERIC) for v in args.values()):
            errors.append(f"{where}: counter args must be numeric")
    if "args" in ev and not isinstance(ev["args"], dict):
        errors.append(f"{where}: args must be an object")


def validate_chrome_trace(obj) -> List[str]:
    """Structural errors in a Chrome-trace JSON object ([] == valid)."""
    errors: List[str] = []
    if not isinstance(obj, dict):
        return ["top level must be an object"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["missing traceEvents list"]
    if not events:
        errors.append("traceEvents is empty")
    for i, ev in enumerate(events):
        _check_event(i, ev, errors)
    # async b/e pairing per (cat, id, name): every begin needs an end
    open_spans: Dict[tuple, int] = {}
    for ev in events:
        if not isinstance(ev, dict):
            continue
        key = (ev.get("cat"), ev.get("id"), ev.get("name"))
        if ev.get("ph") == "b":
            open_spans[key] = open_spans.get(key, 0) + 1
        elif ev.get("ph") == "e":
            open_spans[key] = open_spans.get(key, 0) - 1
    dangling = {k: n for k, n in open_spans.items() if n > 0}
    for (cat, sid, name), n in sorted(dangling.items(),
                                      key=lambda kv: str(kv[0])):
        errors.append(f"dangling async span: {n} unclosed "
                      f"'{name}' (cat={cat}, id={sid})")
    return errors


def trace_features(obj) -> Set[str]:
    """Which observability signals the trace contains (see ``FEATURES``)."""
    feats: Set[str] = set()
    for ev in obj.get("traceEvents", []):
        if not isinstance(ev, dict):
            continue
        ph, cat = ev.get("ph"), ev.get("cat")
        if ph == "X" and cat == "step":
            feats.add("steps")
        if ph in ("b", "e") and cat == "request":
            feats.add("spans")
        if (ph in ("b", "e") and cat == "prefetch") or \
                (ph in ("i", "I") and cat == "tier"):
            feats.add("tiered")
        if ph in ("i", "I") and cat == "fault":
            feats.add("resilience")
        if ph == "C" and "bank" in str(ev.get("name", "")):
            feats.add("bank")
        if ph == "C" and ev.get("name") == "spec":
            feats.add("speculation")
        if ph in ("i", "I") and cat == "jit":
            feats.add("recompile")
            args = ev.get("args") or {}
            if args.get("changed"):
                feats.add("recompile_signature")
    return feats


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Validate a Chrome-trace JSON emitted by repro_torch.obs")
    ap.add_argument("path")
    ap.add_argument("--require", default="",
                    help="comma-separated features that must be present: "
                         + ", ".join(sorted(FEATURES)))
    args = ap.parse_args(argv)

    with open(args.path) as f:
        obj = json.load(f)
    errors = validate_chrome_trace(obj)
    for e in errors:
        print(f"INVALID: {e}", file=sys.stderr)

    required = [r for r in args.require.split(",") if r]
    unknown = [r for r in required if r not in FEATURES]
    if unknown:
        print(f"unknown --require features: {unknown} "
              f"(known: {sorted(FEATURES)})", file=sys.stderr)
        return 2
    feats = trace_features(obj)
    missing = [r for r in required if r not in feats]
    for r in missing:
        print(f"MISSING: {r} -- {FEATURES[r]}", file=sys.stderr)

    n = len(obj.get("traceEvents", []) if isinstance(obj, dict) else [])
    if not errors and not missing:
        print(f"OK: {n} events, features: "
              f"{','.join(sorted(feats)) or '(none)'}")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
