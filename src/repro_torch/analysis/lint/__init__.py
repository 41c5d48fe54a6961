"""``repro_torch.analysis.lint`` -- static analysis + sanitizers gating the
port's serving stack (the PyTorch twin of ``repro/analysis/lint``).

Three contracts no unit test enforces *structurally*:

  1. **step stability** -- the decode step is only fast while it stays on
     the device and keeps one shape: the recompile watcher counts its
     signatures, and a CUDA graph would capture it once.  Pass 1
     (:mod:`.jit_hazards`, ``JH1xx``) walks every function reachable from
     a function handed to ``obs.wrap_step`` / ``RecompileWatcher.wrap``,
     across modules, and flags host syncs (``.item()``, ``.cpu()``,
     boolean-mask indexing ...), Python branches on tensor values,
     batch-dependent shapes, new pool-sized tensors, set-ordered dicts and
     stale ``self`` state.
  2. **page-ledger protocol** -- every page acquired (``alloc``/``ref``)
     must have a release path (``unref``), spill blobs must pin host bytes,
     and nothing may free a page other owners still share.  Pass 2
     (:mod:`.ledger`, ``PL2xx``) checks the call-site protocol statically;
     its runtime twin (:mod:`.runtime`, ``PL25x``, enabled by
     ``REPRO_SANITIZE=1``) mirrors every refcount transition of the live
     pools in a shadow ledger and raises on double-free, negative refcount,
     use-after-evict, and teardown leaks.
  3. **op-registry contracts** -- pimsim/roofline numbers are only
     trustworthy if every registered (kind x backend x format x layout)
     quadruple implements the plan/execute/traffic protocol coherently.
     Pass 3 (:mod:`.contracts`, ``RC3xx``) verifies it live over the
     port's registry: non-negative page-aligned traffic, a ``torch`` twin
     for every ``cuda`` op, and ``decode_op_plans`` covering every config
     in ``repro_torch.configs``.

CLI::

    python -m repro_torch.analysis.lint src/repro_torch [--format json] \
        [--baseline lint_baseline_torch.json]

Suppress a single finding with a trailing (or preceding-line) comment that
says why::

    # lint: disable=JH103  pages bucketed (bucket_pages)

The committed ``lint_baseline_torch.json`` pins the accepted finding count
per rule and lists its sites; a run fails if any rule's count grows (the
baseline may only shrink).
"""
from __future__ import annotations

from repro_torch.analysis.lint.findings import (Finding, RULES, baseline_diff,
                                                load_baseline, write_baseline)
from repro_torch.analysis.lint.jit_hazards import lint_jit_hazards
from repro_torch.analysis.lint.ledger import lint_ledger_protocol
from repro_torch.analysis.lint.runtime import SanitizerError, ShadowLedger

__all__ = [
    "Finding", "RULES", "run_lint",
    "lint_jit_hazards", "lint_ledger_protocol",
    "SanitizerError", "ShadowLedger",
    "load_baseline", "write_baseline", "baseline_diff",
]


def run_lint(paths, include_contracts: bool = True):
    """All three passes over ``paths`` (files or directories of .py files).

    Returns the suppression-filtered findings, sorted by (file, line, code).
    Pass 3 imports ``repro_torch.ops`` (it introspects the live registry);
    ``include_contracts=False`` keeps the run purely static.
    """
    from repro_torch.analysis.lint.findings import iter_python_files
    files = list(iter_python_files(paths))
    findings = []
    findings += lint_jit_hazards(files)
    findings += lint_ledger_protocol(files)
    if include_contracts:
        from repro_torch.analysis.lint.contracts import \
            lint_registry_contracts
        findings += lint_registry_contracts()
    return sorted(findings, key=lambda f: (f.file, f.line, f.code))
