"""Pass 3: op-registry contract checker (``RC3xx``), the PyTorch port's
copy of ``repro/analysis/lint/contracts.py`` run over the port's registry.

Unlike passes 1-2 this pass is *live*, not AST-based: it imports
``repro_torch.ops``, walks every registered (kind x backend x format x
layout) quadruple, builds a canonical plan, and checks the protocol the
cost models (``core/pimsim.py``, ``analysis/roofline.py``) rely on:

  * ``RC301`` the implementation overrides ``execute`` and ``traffic``
    (the ``SpuOp`` base raises ``NotImplementedError``);
  * ``RC302`` ``traffic(plan)`` returns non-negative, finite byte streams
    and a plan round-trip (``registry.traffic``) agrees with the op's own;
  * ``RC303`` paged-layout state traffic is page-granular: constant within
    a page (``T = PAGE_TOKENS+1`` vs ``T = 2*PAGE_TOKENS`` must read the
    same state bytes) -- pages stream whole or not at all;
  * ``RC304`` every ``cuda`` quadruple has a ``torch`` reference twin (the
    CPU parity tests and the CPU fallback depend on it);
  * ``RC305`` ``model_traffic.decode_op_plans`` covers every config in
    ``repro_torch.configs`` for both layouts, and every plan it emits
    resolves to a registered op;
  * ``RC306`` a ``spec_verify`` quadruple has an ``attn_decode`` twin and
    reads at most the cache of the ``Kq`` decode steps it replaces.

Findings point at the implementing class's source line where possible, so
``file:line`` output stays clickable for live-object checks too.
"""
from __future__ import annotations

import inspect
import math
import os
from typing import Dict, List, Tuple

from repro_torch.analysis.lint.findings import Finding

#: canonical dims covering every kind's traffic() accessors (``Kq`` is the
#: spec_verify query width; extra dims are inert for the other kinds)
_CANON_DIMS = dict(B=2, T=None, KVH=4, dk=64, dv=64, n=1, H=8, Kq=4)


def _loc(obj) -> Tuple[str, int]:
    try:
        path = inspect.getsourcefile(type(obj)) or "<registry>"
        _, line = inspect.getsourcelines(type(obj))
        return os.path.relpath(path), line
    except (OSError, TypeError):
        return "<registry>", 1


def _plan_for(op, fmt: str, T: int):
    from repro_torch.ops.base import StateQuantConfig
    dims = dict(_CANON_DIMS, T=T)
    quant = StateQuantConfig(fmt=fmt, rounding="nearest", backend=op.backend)
    return op.plan(dims, quant)


def _streams(t) -> Dict[str, float]:
    return {"state_read": t.state_read, "state_write": t.state_write,
            "operand_read": t.operand_read, "output_write": t.output_write}


def lint_registry_contracts() -> List[Finding]:
    from repro_torch.core.paged import PAGE_TOKENS
    from repro_torch.ops import registry
    from repro_torch.ops.base import SpuOp
    import repro_torch.ops.attention      # noqa: F401  (populate the registry)
    import repro_torch.ops.paged_ops      # noqa: F401
    import repro_torch.ops.spec_verify    # noqa: F401
    import repro_torch.ops.state_update   # noqa: F401

    out: List[Finding] = []
    quads = registry.registered()

    for kind, backend, fmt, layout in quads:
        op = registry.get_op(kind, backend, fmt, layout)
        path, line = _loc(op)
        label = f"{kind}[{backend}:{fmt}:{layout}]"

        # RC301: protocol overrides
        missing = [m for m in ("execute", "traffic")
                   if getattr(type(op), m) is getattr(SpuOp, m)]
        if missing:
            out.append(Finding(
                "RC301", f"{label} does not override {missing}; the base "
                f"class raises NotImplementedError at dispatch",
                path, line))
            continue

        # RC302: descriptor sanity + registry round-trip agreement
        try:
            plan = _plan_for(op, fmt, T=2 * PAGE_TOKENS)
            t = op.traffic(plan)
        except Exception as e:   # a contract checker must not crash
            out.append(Finding(
                "RC302", f"{label} traffic(plan) raised {type(e).__name__}: "
                f"{e}", path, line))
            continue
        bad = {k: v for k, v in _streams(t).items()
               if not math.isfinite(v) or v < 0}
        if bad:
            out.append(Finding(
                "RC302", f"{label} traffic streams invalid: {bad}",
                path, line))
        rt = registry.traffic(plan)
        if _streams(rt) != _streams(t):
            out.append(Finding(
                "RC302", f"{label} registry.traffic(plan) disagrees with "
                f"the op's own traffic() -- plan round-trip is lossy",
                path, line))

        # RC303: paged traffic is page-granular in the cached length T
        if layout == "paged":
            t_lo = op.traffic(_plan_for(op, fmt, T=PAGE_TOKENS + 1))
            t_hi = op.traffic(_plan_for(op, fmt, T=2 * PAGE_TOKENS))
            if not math.isclose(t_lo.state_read, t_hi.state_read,
                                rel_tol=1e-9, abs_tol=1e-6):
                out.append(Finding(
                    "RC303", f"{label} state_read changes within a page "
                    f"(T={PAGE_TOKENS + 1}: {t_lo.state_read:.1f}B vs "
                    f"T={2 * PAGE_TOKENS}: {t_hi.state_read:.1f}B); paged "
                    f"ops stream whole {PAGE_TOKENS}-token pages",
                    path, line))

    # RC304: cuda quadruples need a torch reference twin
    have = set(quads)
    for kind, backend, fmt, layout in quads:
        if backend != "cuda":
            continue
        if (kind, "torch", fmt, layout) not in have:
            op = registry.get_op(kind, backend, fmt, layout)
            path, line = _loc(op)
            out.append(Finding(
                "RC304", f"{kind}[cuda:{fmt}:{layout}] has no torch "
                f"reference twin; parity tests and the CPU fallback "
                f"cannot cover it", path, line))

    # RC306: spec_verify amortizes the cache stream -- one verify pass over
    # Kq query positions must cost at most what Kq sequential attn_decode
    # steps would read (the speculative path can never be *worse* traffic
    # than the steps it replaces), and every spec_verify quadruple needs an
    # equivalent attn_decode to amortize against
    Kq = _CANON_DIMS["Kq"]
    for kind, backend, fmt, layout in quads:
        if kind != "spec_verify":
            continue
        op = registry.get_op(kind, backend, fmt, layout)
        path, line = _loc(op)
        label = f"{kind}[{backend}:{fmt}:{layout}]"
        if ("attn_decode", backend, fmt, layout) not in have:
            out.append(Finding(
                "RC306", f"{label} has no equivalent attn_decode quadruple; "
                f"the verify pass replaces sequential decode steps and must "
                f"have a baseline to amortize against", path, line))
            continue
        ad = registry.get_op("attn_decode", backend, fmt, layout)
        try:
            sv_t = op.traffic(_plan_for(op, fmt, T=2 * PAGE_TOKENS))
            ad_t = ad.traffic(_plan_for(ad, fmt, T=2 * PAGE_TOKENS))
        except Exception as e:
            out.append(Finding(
                "RC306", f"{label} traffic comparison raised "
                f"{type(e).__name__}: {e}", path, line))
            continue
        if sv_t.state_read > Kq * ad_t.state_read + 1e-6:
            out.append(Finding(
                "RC306", f"{label} reads {sv_t.state_read:.1f}B of cache "
                f"for Kq={Kq} positions, more than the {Kq} sequential "
                f"attn_decode steps it replaces "
                f"({Kq} x {ad_t.state_read:.1f}B); the verify pass must "
                f"stream the cache at most once per step it amortizes",
                path, line))

    # RC305: decode_op_plans covers every config, both layouts
    out += _check_config_coverage()
    return out


def _check_config_coverage() -> List[Finding]:
    from repro_torch import configs
    from repro_torch.ops import model_traffic, registry

    out: List[Finding] = []
    cfg_path = os.path.relpath(inspect.getsourcefile(configs))
    for name in configs.ALL_ARCHS:
        try:
            cfg = configs.get_smoke_config(name)
        except Exception as e:
            out.append(Finding(
                "RC305", f"config {name!r} failed to build: "
                f"{type(e).__name__}: {e}", cfg_path, 1))
            continue
        for layout in ("dense", "paged"):
            try:
                entries = model_traffic.decode_op_plans(
                    cfg, batch=2, seq_len=256, layout=layout)
            except Exception as e:
                out.append(Finding(
                    "RC305", f"decode_op_plans({name!r}, layout={layout!r}) "
                    f"raised {type(e).__name__}: {e}", cfg_path, 1))
                continue
            if not entries:
                out.append(Finding(
                    "RC305", f"decode_op_plans({name!r}, layout={layout!r}) "
                    f"is empty -- serving traffic accounting is blind to "
                    f"this config", cfg_path, 1))
            for e in entries:
                quad = (e.plan.kind, e.plan.backend, e.plan.fmt,
                        e.plan.layout)
                if quad not in set(registry.registered()):
                    out.append(Finding(
                        "RC305", f"decode_op_plans({name!r}) emitted a plan "
                        f"for unregistered quadruple {quad}", cfg_path, 1))
    return out
