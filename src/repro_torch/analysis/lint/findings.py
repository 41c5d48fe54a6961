"""Finding vocabulary shared by the port's lint passes: the PyTorch port's
copy of ``repro/analysis/lint/findings.py``.

A :class:`Finding` is one (code, file, line) diagnostic with a fix hint.
Codes come in three families:

  * ``JH1xx`` -- step hazards (pass 1, :mod:`.jit_hazards`): host syncs,
    tensor-valued branches, shape churn and stale state in the functions
    handed to the recompile watcher -- what a CUDA-graph step cannot hold
  * ``PL2xx`` -- page-ledger protocol (pass 2, :mod:`.ledger`; the ``PL25x``
    range is raised at runtime by the shadow-ledger sanitizer)
  * ``RC3xx`` -- op-registry contracts (pass 3, :mod:`.contracts`)

Suppression: a finding is dropped when its line -- or the line directly
above it -- carries ``# lint: disable=<CODE>`` (comma-separated codes, or
``all``), which free text after the codes may justify.  Suppressions are deliberate, reviewable markers: the linter is
heuristic by design and a justified suppression beats a weakened rule.

Baselines: a baseline file maps rule code -> accepted count (``counts``),
and may list the accepted sites (``sites``, ``file:line: CODE``) for the
reader.  A run is clean when no rule exceeds its baselined count; rules
below baseline are reported as available ratchet room (shrink the
committed file).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

#: code -> (title, fix hint).  The single source of truth the CLI, README
#: table, and tests enumerate.
RULES: Dict[str, Tuple[str, str]] = {
    # --- pass 1: step hazards (watched steppers, CUDA-graph capture) ----
    "JH101": ("host-sync-in-step",
              "a .item()/.tolist()/.cpu()/.numpy()/nonzero/boolean-mask "
              "index reachable from a watched stepper stalls the stream and "
              "breaks graph capture; keep the step on the device"),
    "JH102": ("tensor-python-branch",
              "a Python if/while on a tensor's value syncs the host every "
              "step; use torch.where / masked arithmetic, or a static"),
    "JH103": ("dynamic-shape-feeds-step",
              "a shape from len()/max() of mutating batch state gives the "
              "watcher a new signature and a graph a new capture; pad to a "
              "fixed bucket set"),
    "JH104": ("new-pool-tensor-from-step",
              "a watched stepper returns a new pool-sized tensor where it "
              "could write its pools/caches argument in place; copy_ into "
              "the buffer"),
    "JH105": ("dict-order-signature",
              "a dict built from a set-derived iterable in a watched stepper "
              "reorders the watcher's signature leaves; sort the keys"),
    "JH106": ("step-reads-reassigned-attr",
              "a watched stepper reading a self attribute that another "
              "method reassigns replays a stale tensor under a CUDA graph; "
              "pass it as an argument"),
    # --- pass 2: page-ledger protocol (static) -------------------------
    "PL201": ("alloc-result-unchecked",
              "placement.alloc returns None when pages are short; check "
              "before indexing/extending the block table"),
    "PL202": ("acquire-without-release",
              "this module takes page references (alloc/ref) but never "
              "releases any (unref); every acquire path needs a release "
              "path"),
    "PL203": ("table-pop-without-release",
              "popping a request from page_table without unref()/spill "
              "extraction leaks its pages until process exit"),
    "PL204": ("deprecated-unconditional-free",
              "placement.free is the pre-refcount alias of unref; call "
              "unref so copy-on-write sharers are respected"),
    "PL205": ("spill-without-host-pin",
              "a tiered spill must pin the blob's bytes in the host ledger "
              "(live state may never be dropped); call host.pin"),
    "PL206": ("alloc-without-retry-escalation",
              "pool.register/grow/resume/fork and host.pin can fail "
              "transiently under pressure; wrap the call in a bounded "
              "retry / degradation path (retry_transient or an "
              "escalation wrapper), never assume success"),
    # --- pass 2: page-ledger protocol (runtime shadow ledger) ----------
    "PL250": ("ref-on-free-page",
              "taking a reference on a page that is not live "
              "(use-after-free / use-after-evict acquire)"),
    "PL251": ("double-free",
              "unref below zero: the page was already returned to the free "
              "list"),
    "PL252": ("free-with-live-sharers",
              "a page returned to the free list while the shadow ledger "
              "still sees outstanding references"),
    "PL253": ("double-alloc",
              "allocator handed out a page the shadow ledger already "
              "considers live"),
    "PL254": ("use-after-evict",
              "a block table references a page that is not live in the "
              "shadow ledger"),
    "PL255": ("teardown-leak",
              "pages still live at engine teardown with no owning request, "
              "spill blob, staged prefetch, or store node"),
    # --- pass 3: op-registry contracts ---------------------------------
    "RC301": ("op-missing-impl",
              "a registered op must override execute() and traffic(); the "
              "base class raises"),
    "RC302": ("op-traffic-invalid",
              "traffic(plan) returned a negative/NaN stream; byte "
              "descriptors must be non-negative finite floats"),
    "RC303": ("paged-traffic-not-page-aligned",
              "a paged-layout op's state traffic must be page-granular: "
              "constant within a page, stepping only at page boundaries"),
    "RC304": ("cuda-without-torch-reference",
              "every cuda quadruple needs a torch reference twin (parity "
              "tests and the CPU fallback)"),
    "RC305": ("config-not-covered",
              "model_traffic.decode_op_plans must enumerate this config's "
              "decode ops; serving traffic accounting is blind to it"),
    "RC306": ("spec-verify-not-amortized",
              "a spec_verify pass over Kq positions must read at most the "
              "cache of Kq attn_decode steps, and needs an attn_decode "
              "twin to amortize against"),
}

#: ``# lint: disable=JH101, PL204  why``: the codes, then free text
_DISABLE_RE = re.compile(r"#\s*lint:\s*disable=((?:[A-Z]{2}\d{3}|all)"
                         r"(?:\s*,\s*(?:[A-Z]{2}\d{3}|all))*)")


@dataclasses.dataclass(frozen=True)
class Finding:
    code: str
    message: str
    file: str
    line: int

    @property
    def family(self) -> str:
        return self.code[:2]

    @property
    def title(self) -> str:
        return RULES.get(self.code, ("?", ""))[0]

    @property
    def hint(self) -> str:
        return RULES.get(self.code, ("?", ""))[1]

    def render(self) -> str:
        return (f"{self.file}:{self.line}: {self.code} "
                f"[{self.title}] {self.message}\n"
                f"    hint: {self.hint}")

    def as_dict(self) -> dict:
        return {"code": self.code, "title": self.title, "file": self.file,
                "line": self.line, "message": self.message,
                "hint": self.hint}


def iter_python_files(paths: Sequence[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for n in sorted(names):
                    if n.endswith(".py"):
                        yield os.path.join(root, n)


def suppressed_codes(source_lines: Sequence[str], line: int) -> set:
    """Codes disabled at 1-based ``line`` (same line or the line above)."""
    out: set = set()
    for ln in (line, line - 1):
        if 1 <= ln <= len(source_lines):
            m = _DISABLE_RE.search(source_lines[ln - 1])
            if m:
                out |= {c.strip()
                        for c in m.group(1).split(",") if c.strip()}
    return out


def apply_suppressions(findings: Iterable[Finding]) -> List[Finding]:
    """Drop findings whose source line carries a matching disable comment."""
    kept: List[Finding] = []
    cache: Dict[str, List[str]] = {}
    for f in findings:
        if f.file not in cache:
            try:
                with open(f.file) as fh:
                    cache[f.file] = fh.readlines()
            except OSError:
                cache[f.file] = []
        codes = suppressed_codes(cache[f.file], f.line)
        if f.code in codes or "all" in codes:
            continue
        kept.append(f)
    return kept


# ---------------------------------------------------------------------------
# baseline ratchet
# ---------------------------------------------------------------------------


def counts_by_code(findings: Iterable[Finding]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for f in findings:
        out[f.code] = out.get(f.code, 0) + 1
    return out


def load_baseline(path: str) -> Dict[str, int]:
    with open(path) as fh:
        data = json.load(fh)
    return {str(k): int(v) for k, v in data.get("counts", data).items()}


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    """Write the per-rule counts and the sites they stand for."""
    findings = list(findings)
    sites = [f"{f.file}:{f.line}: {f.code}" for f in findings]
    with open(path, "w") as fh:
        json.dump({"counts": counts_by_code(findings), "sites": sites}, fh,
                  indent=2, sort_keys=True)
        fh.write("\n")


def baseline_diff(findings: Iterable[Finding],
                  baseline: Dict[str, int]
                  ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """(regressions, ratchet_room): rule -> count over / under baseline."""
    cur = counts_by_code(findings)
    over = {c: n - baseline.get(c, 0) for c, n in cur.items()
            if n > baseline.get(c, 0)}
    under = {c: b - cur.get(c, 0) for c, b in baseline.items()
             if cur.get(c, 0) < b}
    return over, under
