"""The port's lint (``repro_torch.analysis.lint``): step-hazard rules,
ledger protocol rules, registry contracts, the baseline and the CLI,
mirroring ``tests/test_lint.py``.

Every JH/PL/RC code gets a positive (fires) and a negative (stays quiet)
case.  Over ``src/repro_torch`` the lint finds the MoE dispatch's
boolean-mask scatter (in ``models/layers.py``, a host sync in every MoE
decode step) and nothing beyond the committed ``lint_baseline_torch.json``.
"""
import json
import os
import re
import textwrap

import pytest

from repro_torch.analysis.lint import (RULES, baseline_diff, load_baseline,
                                       run_lint)
from repro_torch.analysis.lint import __main__ as lint_cli
from repro_torch.analysis.lint.__main__ import main as lint_main
from repro_torch.analysis.lint.findings import (Finding, counts_by_code,
                                                suppressed_codes)
from repro_torch.analysis.lint.jit_hazards import (lint_jit_hazards,
                                                   watched_roots)
from repro_torch.analysis.lint.ledger import lint_ledger_protocol

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT = os.path.join(_ROOT, "src", "repro_torch")
_BASELINE = os.path.join(_ROOT, "lint_baseline_torch.json")


def _codes(findings):
    return {f.code for f in findings}


def _lint_snippet(tmp_path, source, pass_fn):
    tmp_path.mkdir(exist_ok=True)
    p = tmp_path / "snippet.py"
    p.write_text(textwrap.dedent(source))
    return pass_fn([str(p)])


# ---------------------------------------------------------------------------
# pass 1: step hazards -- positive and negative per rule
# ---------------------------------------------------------------------------

_WATCHED = """
class Engine:
    def __init__(self, obs):
        self._decode = obs.wrap_step(decode_step, "engine.decode")
"""


def _w(src):
    """A snippet whose ``decode_step`` an engine hands to the watcher."""
    return textwrap.dedent(src) + _WATCHED


JH_CASES = {
    "JH101": (
        _w("""
        import torch
        def decode_step(x: torch.Tensor):
            return x.sum().item()
        """),
        _w("""
        import torch
        def decode_step(x: torch.Tensor):
            return x.sum()
        """),
    ),
    "JH102": (
        _w("""
        import torch
        def decode_step(x: torch.Tensor):
            if x.max() > 0:
                return x
            return -x
        """),
        _w("""
        import torch
        def decode_step(x: torch.Tensor):
            if x.shape[0] > 0 and x.device.type == "cuda":
                return x
            return -x
        """),
    ),
    "JH103": (
        _w("""
        import torch
        def decode_step(x):
            return x
        def build_table(rids, table):
            npg = max(len(table[r]) for r in rids)
            return torch.zeros((len(rids), npg), dtype=torch.int32)
        """),
        _w("""
        import torch
        def decode_step(x):
            return x
        def build_table(n_rows, n_pages):
            return torch.zeros((n_rows, n_pages), dtype=torch.int32)
        """),
    ),
    "JH104": (
        _w("""
        import torch
        def decode_step(params, pools, tokens):
            return [torch.where(tokens > 0, p, 0) for p in pools]
        """),
        _w("""
        import torch
        def decode_step(params, pools, tokens):
            for p in pools:
                p.add_(1)
            return tokens
        """),
    ),
    "JH105": (
        _w("""
        def decode_step(tree):
            return {k: tree for k in set(("a", "b"))}
        """),
        _w("""
        def decode_step(tree, names):
            return {k: tree for k in sorted(names)}
        """),
    ),
    "JH106": (
        """
        class Eng:
            def __init__(self, obs):
                self.scale = 1.0
                self._step = obs.wrap_step(self.step_fn, "eng.step")
            def rescale(self):
                self.scale = 2.0
            def step_fn(self, x):
                return x * self.scale
        """,
        """
        class Eng:
            def __init__(self, obs):
                self.scale = 1.0
                self._step = obs.wrap_step(self.step_fn, "eng.step")
            def step_fn(self, x):
                return x * self.scale
        """,
    ),
}


@pytest.mark.parametrize("code", sorted(JH_CASES))
def test_step_hazard_rule(code, tmp_path):
    pos, neg = JH_CASES[code]
    hits = _lint_snippet(tmp_path / "pos", pos, lint_jit_hazards)
    assert code in _codes(hits), f"{code} should fire on the positive case"
    quiet = _lint_snippet(tmp_path / "neg", neg, lint_jit_hazards)
    assert code not in _codes(quiet), \
        f"{code} must stay quiet on the negative case: {quiet}"


_PKG = {
    "__init__.py": "",
    "engine.py": """
        from functools import partial
        from pkg import model as M
        class Engine:
            def __init__(self, obs, cfg):
                self._decode = obs.wrap_step(partial(M.decode_step, cfg=cfg),
                                             "engine.decode")
        """,
    "model.py": """
        from pkg import layers as L
        def decode_step(x, cfg):
            return L.moe(x)
        """,
}

_MASK = {
    True: """
        import torch
        def moe(x: torch.Tensor):
            slot = torch.cumsum(x, 0)
            keep = slot < 4
            out = torch.zeros_like(x)
            out[keep] = x[keep]
            return out
        """,
    False: """
        import torch
        def moe(x: torch.Tensor):
            slot = torch.cumsum(x, 0)
            keep = slot < 4
            return torch.where(keep, x, torch.zeros_like(x))
        """,
}


@pytest.mark.parametrize("masked", [True, False])
def test_jh101_boolean_mask_found_across_modules(tmp_path, masked):
    """The walk follows ``partial(M.decode_step)`` into another module and
    on into a third through ``from pkg import layers as L``."""
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    for name, src in dict(_PKG, **{"layers.py": _MASK[masked]}).items():
        (pkg / name).write_text(textwrap.dedent(src))
    files = sorted(str(p) for p in pkg.glob("*.py"))
    assert watched_roots(files) == ["pkg.model:decode_step"]
    hits = [f for f in lint_jit_hazards(files) if f.code == "JH101"]
    if masked:
        assert [os.path.basename(f.file) for f in hits] == ["layers.py"]
        assert hits[0].line == 7            # one finding for the line
    else:
        assert hits == []


# ---------------------------------------------------------------------------
# pass 2 (static): ledger protocol -- positive and negative per rule
# ---------------------------------------------------------------------------

PL_CASES = {
    "PL201": (
        """
        def claim(placement, table, rid, n):
            pages = placement.alloc(n)
            table[rid] = pages
            placement.unref(pages)
        """,
        """
        def claim(placement, table, rid, n):
            pages = placement.alloc(n)
            if pages is None:
                return False
            table[rid] = pages
            placement.unref(pages)
            return True
        """,
    ),
    "PL202": (
        """
        def claim(placement, n):
            pages = placement.alloc(n)
            if pages is None:
                return None
            return pages
        """,
        """
        def claim(placement, n):
            pages = placement.alloc(n)
            if pages is None:
                return None
            return pages
        def drop(placement, pages):
            placement.unref(pages)
        """,
    ),
    "PL203": (
        """
        class PagedStatePool:
            def release(self, rid):
                pages = self.page_table.pop(rid)
                return len(pages)
        """,
        """
        class PagedStatePool:
            def release(self, rid):
                pages = self.page_table.pop(rid)
                self.placement.unref(pages)
                return len(pages)
        """,
    ),
    "PL204": (
        """
        def drop(placement, pages):
            placement.free(pages)
        """,
        """
        def drop(placement, pages):
            placement.unref(pages)
        """,
    ),
    "PL205": (
        """
        class TieredStatePool:
            def spill(self, rid, length):
                blob = self.extract(rid)
                self.host.cache_add(len(blob))
                return blob
        """,
        """
        class TieredStatePool:
            def spill_with_retry(self, rid, length):
                blob = self.extract(rid)
                self.host.pin(rid, len(blob))
                return blob
        """,
    ),
    "PL206": (
        """
        class PagedServingEngine:
            def admit(self, req, pages):
                self.pool.register(req.rid, pages)
                return True
        """,
        """
        class PagedServingEngine:
            def admit(self, req, pages):
                ok = self._retry("alloc",
                                 lambda: self.pool.register(req.rid, pages))
                if not ok:
                    self.degrade(req)
                return bool(ok)
        """,
    ),
}


@pytest.mark.parametrize("code", sorted(PL_CASES))
def test_ledger_rule(code, tmp_path):
    pos, neg = PL_CASES[code]
    hits = _lint_snippet(tmp_path / "pos", pos, lint_ledger_protocol)
    assert code in _codes(hits), f"{code} should fire on the positive case"
    quiet = _lint_snippet(tmp_path / "neg", neg, lint_ledger_protocol)
    assert code not in _codes(quiet), \
        f"{code} must stay quiet on the negative case: {quiet}"


# ---------------------------------------------------------------------------
# suppression + baseline ratchet
# ---------------------------------------------------------------------------

def test_suppression_comment(tmp_path):
    src = """
    def drop(placement, pages):
        placement.free(pages)  # lint: disable=PL204  the alias, on purpose
    """
    assert _lint_snippet(tmp_path / "pos", src, lint_ledger_protocol) == []


def test_suppression_preceding_line():
    lines = ["x = 1\n", "# lint: disable=JH101, PL204  why\n", "y = 2\n"]
    assert suppressed_codes(lines, 3) == {"JH101", "PL204"}
    assert suppressed_codes(lines, 1) == set()


def test_baseline_ratchet():
    f = [Finding("JH101", "m", "a.py", 1), Finding("JH101", "m", "a.py", 9),
         Finding("PL204", "m", "b.py", 2)]
    assert counts_by_code(f) == {"JH101": 2, "PL204": 1}
    over, room = baseline_diff(f, {"JH101": 2, "PL204": 2, "RC301": 1})
    assert over == {}                       # nothing above baseline
    assert room == {"PL204": 1, "RC301": 1}
    over, _ = baseline_diff(f, {"JH101": 1})
    assert over == {"JH101": 1, "PL204": 1}


def test_every_rule_documented():
    for code in RULES:
        title, hint = RULES[code]
        assert title and hint and "\n" not in hint
    covered = set(JH_CASES) | set(PL_CASES) | \
        {"PL250", "PL251", "PL252", "PL253", "PL254", "PL255"} | \
        {"RC301", "RC302", "RC303", "RC304", "RC305", "RC306"}
    assert covered == set(RULES), "every rule needs a test case"


# ---------------------------------------------------------------------------
# the port's own sources: the committed baseline, the CLI's ratchet
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_findings():
    return run_lint([_PORT])


def test_port_lint_finds_the_moe_scatter(port_findings):
    # the MoE dispatch's boolean-mask scatter, found by its content so an
    # edit above it does not move the test
    with open(os.path.join(_PORT, "models", "layers.py")) as fh:
        hits = [(i, text) for i, text in enumerate(fh, 1)
                if "[keep]] = " in text]
    assert len(hits) == 1, hits
    lineno, text = hits[0]
    assert "lint: disable" not in text
    sites = {(os.path.relpath(f.file, _PORT), f.line, f.code)
             for f in port_findings}
    assert (os.path.join("models", "layers.py"), lineno, "JH101") in sites


def _without_line(site):
    """``file:line: CODE`` -> ``file: CODE``."""
    return re.sub(r":\d+: ", ": ", site)


def test_port_lint_matches_committed_baseline(port_findings):
    base = load_baseline(_BASELINE)
    over, room = baseline_diff(port_findings, base)
    assert over == {} and room == {}, (over, room)
    with open(_BASELINE) as fh:
        listed = sorted(_without_line(s) for s in json.load(fh)["sites"])
    assert listed == sorted(f"{os.path.relpath(f.file, _ROOT)}: {f.code}"
                            for f in port_findings)


def test_watched_roots_of_the_port():
    from repro_torch.analysis.lint.findings import iter_python_files
    roots = watched_roots(list(iter_python_files([_PORT])))
    assert {"repro_torch.models.model:decode_step",
            "repro_torch.models.model:prefill",
            "repro_torch.serving.memory.pool:_paged_step",
            "repro_torch.serving.memory.pool:_spec_step",
            "repro_torch.serving.memory.pool:_gather_step",
            "repro_torch.serving.memory.layout:CachePaging.commit_select",
            "repro_torch.serving.memory.layout:CachePaging.extract_pages",
            "repro_torch.serving.memory.layout:CachePaging.insert_slab",
            } <= set(roots)


def test_cli_ratchet_exit_codes(tmp_path, capsys, monkeypatch,
                                port_findings):
    static = [_PORT, "--no-contracts"]
    assert lint_main(static + ["--baseline", _BASELINE]) == 0
    # the ratchet's exit codes over the same findings, without linting again
    monkeypatch.setattr(lint_cli, "run_lint",
                        lambda paths, include_contracts: port_findings)
    assert lint_main(static) == 1                       # no baseline
    tight = tmp_path / "tight.json"
    tight.write_text(json.dumps({"counts": {"JH101": 0}}))
    assert lint_main(static + ["--baseline", str(tight)]) == 1
    assert lint_main(static + ["--baseline", str(tmp_path / "nope")]) == 2
    capsys.readouterr()
    assert lint_main(static + ["--format", "json", "--baseline",
                               _BASELINE]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] and out["counts"] == {"JH101": 1}
    wrote = tmp_path / "wrote.json"
    assert lint_main(static + ["--write-baseline", str(wrote)]) == 0
    assert load_baseline(str(wrote)) == load_baseline(_BASELINE)
    assert lint_main(["--list-rules", _PORT]) == 0
    assert "JH106" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# pass 3: registry contracts (RC3xx), live over the port's registry
# ---------------------------------------------------------------------------

def _broken_registry(monkeypatch, *ops):
    from repro_torch.ops import registry
    patched = dict(registry._REGISTRY)
    for op in ops:
        for fmt in op.formats:
            patched[(op.kind, op.backend, fmt, op.layout)] = op
    monkeypatch.setattr(registry, "_REGISTRY", patched)


def test_contracts_clean_on_real_registry(port_findings):
    assert not [f for f in port_findings if f.code.startswith("RC")]


def test_contract_missing_impl_and_twin(monkeypatch):
    from repro_torch.analysis.lint.contracts import lint_registry_contracts
    from repro_torch.ops.base import SpuOp

    class _Hollow(SpuOp):
        kind = "state_update"
        backend = "cuda"
        formats = ("_lint_fake",)
        layout = "dense"

    _broken_registry(monkeypatch, _Hollow())
    codes = _codes(lint_registry_contracts())
    assert "RC301" in codes                  # no execute/traffic override
    assert "RC304" in codes                  # cuda without a torch twin


def test_contract_invalid_traffic(monkeypatch):
    from repro_torch.analysis.lint.contracts import lint_registry_contracts
    from repro_torch.ops.base import SpuOp, TrafficBytes

    class _Negative(SpuOp):
        kind = "state_update"
        backend = "torch"
        formats = ("_lint_fake",)
        layout = "dense"

        def execute(self, state, inputs, plan):
            return state, None

        def traffic(self, plan):
            return TrafficBytes(state_read=-1.0)

    _broken_registry(monkeypatch, _Negative())
    assert "RC302" in _codes(lint_registry_contracts())


def test_contract_page_alignment(monkeypatch):
    from repro_torch.analysis.lint.contracts import lint_registry_contracts
    from repro_torch.ops.base import SpuOp, TrafficBytes

    class _Unaligned(SpuOp):
        kind = "attn_decode"
        backend = "torch"
        formats = ("_lint_fake",)
        layout = "paged"

        def execute(self, state, inputs, plan):
            return state, None

        def traffic(self, plan):
            # token-granular state reads: illegal for a paged op
            return TrafficBytes(state_read=float(plan.dim("T")))

    _broken_registry(monkeypatch, _Unaligned())
    assert "RC303" in _codes(lint_registry_contracts())


def test_contract_config_coverage(monkeypatch):
    from repro_torch import configs
    from repro_torch.analysis.lint.contracts import lint_registry_contracts
    monkeypatch.setattr(configs, "ALL_ARCHS",
                        tuple(configs.ALL_ARCHS) + ("_lint_bogus_arch",))
    findings = [f for f in lint_registry_contracts() if f.code == "RC305"]
    assert findings and "_lint_bogus_arch" in findings[0].message


def test_contract_spec_verify_amortized(monkeypatch):
    from repro_torch.analysis.lint.contracts import lint_registry_contracts
    from repro_torch.ops.base import SpuOp, TrafficBytes

    class _Orphan(SpuOp):
        """A verify op with no attn_decode twin."""
        kind = "spec_verify"
        backend = "torch"
        formats = ("_lint_fake",)
        layout = "dense"

        def execute(self, state, inputs, plan):
            return state, None

        def traffic(self, plan):
            return TrafficBytes(state_read=1.0)

    class _Decode(SpuOp):
        kind = "attn_decode"
        backend = "torch"
        formats = ("_lint_fake2",)
        layout = "dense"

        def execute(self, state, inputs, plan):
            return state, None

        def traffic(self, plan):
            return TrafficBytes(state_read=10.0)

    class _Greedy(_Orphan):
        """A verify op reading more than Kq decode steps would."""
        formats = ("_lint_fake2",)

        def traffic(self, plan):
            return TrafficBytes(state_read=1e6)

    _broken_registry(monkeypatch, _Orphan(), _Decode(), _Greedy())
    msgs = [f.message for f in lint_registry_contracts()
            if f.code == "RC306"]
    assert any("_lint_fake:" in m and "no equivalent" in m for m in msgs)
    assert any("_lint_fake2:" in m and "more than" in m for m in msgs)
