"""The port's observability (``repro_torch.obs``) against the JAX package's.

* Every test of ``tests/test_obs.py`` mirrored on the port's objects and
  engines, with the same assertions: the metrics registry, the trace ring
  and its Chrome / JSONL export, the schema, the lifecycle spans, the
  recompile watcher (on a plain function: the port's steppers are eager, so
  it counts distinct argument signatures, the twin of the jit cache size),
  and both engines' traces, ``stats()`` and Prometheus text.  Smoke config:
  ``llama3.2-1b``, fp32 state, round to nearest, the ``torch`` backend.
* Cross-package: the watcher's per-site counts equal the JAX watcher's on
  the workloads of the JAX retrace pins (``tests/test_paged_decode.py``'s
  constant-shape paged workload, ``tests/test_paged_pool.py``'s prefill
  buckets); the trace's ``(ph, cat, name, track)`` sequence and every
  event's non-time args equal the JAX engine's on the zamba2 preemption
  workload, plain and with n-gram speculation and a fault plan (``jit``
  events dropped: the count test holds them); a prefetch span holds a
  decode step; each package's schema accepts the other's traces and both
  report the same errors and features.
* The launcher's ``--paged --mixed --stream --turns 2 --trace`` on the CPU,
  checked by the schema CLI, and ``--turns`` without ``--paged``.

The JAX engines run once per module (fixtures) where several tests read
them.
"""
import gc
import json
import subprocess
import sys
import weakref

import jax
import numpy as np
import pytest
import torch

from repro import ops as JOPS
from repro.configs import get_smoke_config as j_smoke
from repro.models import model as JM
from repro.obs import trace_features as j_trace_features
from repro.obs import validate_chrome_trace as j_validate
from repro.serving.api import Engine as JEngine
from repro.serving.api import ServeConfig as JServeConfig
from repro.serving.engine import PagedEngineConfig as JPagedEngineConfig
from repro.serving.engine import PagedServingEngine as JPagedServingEngine
from repro.serving.engine import Request as JRequest
from repro_torch import ops as TOPS
from repro_torch.configs import get_smoke_config
from repro_torch.core import formats as F
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.obs import (PHASES, LifecycleTracker, MetricsRegistry,
                             Observability, TraceBuffer, trace_features,
                             validate_chrome_trace)
from repro_torch.obs.metrics import Histogram
from repro_torch.obs.recompile import site_compile_counts
from repro_torch.serving.api import Engine, ServeConfig
from repro_torch.serving.engine import (PagedEngineConfig,
                                        PagedServingEngine, Request)
from repro_torch.serving.sampler import SamplingConfig
from repro_torch.serving.scheduler import SchedulerConfig

from conftest import subprocess_env

torch.set_num_threads(1)  # test workers share the cores: one thread each

# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def test_counter_gauge_semantics():
    m = MetricsRegistry()
    m.counter("reqs").inc()
    m.counter("reqs").inc(2.5)
    assert m.value("reqs") == 3.5
    with pytest.raises(ValueError):
        m.counter("reqs").inc(-1)
    g = m.gauge("active")
    g.set(4)
    g.dec()
    assert m.value("active") == 3.0
    # untouched metrics read 0.0, never KeyError (schema stability)
    assert m.value("never_written") == 0.0
    assert m.value("reqs", ) == 3.5


def test_labels_partition_families():
    m = MetricsRegistry()
    m.counter("requests_total", status="done").inc(3)
    m.counter("requests_total", status="aborted").inc()
    assert m.value("requests_total", status="done") == 3.0
    assert m.value("requests_total", status="aborted") == 1.0
    assert m.value("requests_total", status="truncated") == 0.0
    # kind / label-set mismatches are bugs, not silent new families
    with pytest.raises(ValueError):
        m.gauge("requests_total", status="done")
    with pytest.raises(ValueError):
        m.counter("requests_total", other="x")


def test_histogram_exact_then_bounded():
    h = Histogram(cap=8)
    xs = [3.0, 1.0, 2.0, 5.0, 4.0]
    for x in xs:
        h.observe(x)
    assert h.count == 5 and h.sum == 15.0 and h.mean == 3.0
    # below the cap the percentile is exact np.percentile of everything
    assert h.percentile(50) == float(np.percentile(xs, 50))
    assert h.percentile(99) == float(np.percentile(xs, 99))
    for x in range(100):
        h.observe(float(x))
    assert h.count == 105            # count/sum stay exact
    assert len(h.samples) < 8        # reservoir stays bounded
    s = h.summary()
    assert set(s) == {"count", "sum", "mean", "p50", "p90", "p99", "max"}


def test_empty_histogram_reads_zero():
    m = MetricsRegistry()
    h = m.histogram("step_s", compile="false")
    assert h.percentile(99) == 0.0 and h.mean == 0.0
    assert m.family_samples("step_s") == []
    assert m.family_count("nope") == 0.0


def test_prometheus_text_renders_all_kinds():
    m = MetricsRegistry()
    m.counter("toks").inc(7)
    m.gauge("live", pool="a").set(2)
    m.histogram("lat_s").observe(0.5)
    text = m.prometheus_text()
    assert "# TYPE toks counter" in text
    assert "toks 7" in text
    assert 'live{pool="a"} 2' in text
    assert "# TYPE lat_s summary" in text
    assert 'lat_s{quantile="0.99"} 0.5' in text
    assert "lat_s_count 1" in text


# ---------------------------------------------------------------------------
# trace buffer
# ---------------------------------------------------------------------------

def test_trace_ring_keeps_metadata_and_counts_drops():
    tr = TraceBuffer(capacity=4)
    for i in range(10):
        tr.instant(f"e{i}", cat="x")
    assert tr.dropped == 6
    evs = tr.events()
    # thread_name metadata survives ring eviction
    assert any(e["ph"] == "M" for e in evs)
    obj = tr.to_chrome()
    assert validate_chrome_trace(obj) == []
    assert obj["otherData"]["dropped_events"] == 6


def test_trace_export_chrome_and_jsonl(tmp_path):
    tr = TraceBuffer()
    tr.complete("step", cat="step", ts=tr.now_us(), dur=100.0, batch=2)
    tr.counter("bank_traffic", {"pch00_bursts": 3.0})
    tr.async_span("decode", 7, "request", 0.0, 50.0, rid=7)
    p_json, p_jsonl = tmp_path / "t.json", tmp_path / "t.jsonl"
    tr.save(str(p_json))
    tr.save(str(p_jsonl))
    obj = json.loads(p_json.read_text())
    assert validate_chrome_trace(obj) == []
    feats = trace_features(obj)
    assert {"steps", "spans", "bank"} <= feats
    lines = [json.loads(L) for L in p_jsonl.read_text().splitlines()]
    assert len(lines) == len(tr.events())


#: the broken traces of ``test_schema_catches_invalid_traces``
_BAD = {"traceEvents": [
    {"ph": "X", "name": "no_dur", "pid": 1, "tid": 0, "ts": 0.0},
    {"ph": "b", "name": "open", "cat": "request", "id": "1",
     "pid": 1, "tid": 0, "ts": 0.0},            # never closed
    {"ph": "?", "name": "junk", "pid": 1, "tid": 0, "ts": 0.0},
]}


def test_schema_catches_invalid_traces():
    assert validate_chrome_trace([]) == ["top level must be an object"]
    assert validate_chrome_trace({}) == ["missing traceEvents list"]
    errs = validate_chrome_trace(_BAD)
    assert any("dur" in e for e in errs)
    assert any("dangling" in e for e in errs)
    assert any("unknown phase" in e for e in errs)


# ---------------------------------------------------------------------------
# lifecycle spans
# ---------------------------------------------------------------------------

def test_span_chain_complete_and_derived_metrics():
    tr = TraceBuffer()
    m = MetricsRegistry()
    lc = LifecycleTracker(tr, m)
    lc.enqueued(1, t=10.0)
    lc.phase(1, "prefill", t=12.0)
    lc.phase(1, "decode", t=13.0)
    lc.phase(1, "spilled", t=14.0)
    lc.phase(1, "decode", t=16.5)
    lc.first_token(1, t=13.5)
    lc.finish(1, "done", n_tokens=5, t=20.0)
    rec = lc.record(1)
    assert rec.complete_chain()
    assert rec.phase_sequence() == ["queued", "prefill", "decode",
                                    "spilled", "decode"]
    assert rec.queue_delay_s == 2.0
    assert rec.ttft_s == 3.5
    assert rec.preemption_cost_s == 2.5
    assert rec.tpot_s == pytest.approx((20.0 - 13.5) / 4)
    # duplicate phase transition is a no-op, not a new span
    lc2 = LifecycleTracker()
    lc2.enqueued(2, t=0.0)
    lc2.phase(2, "decode", t=1.0)
    lc2.phase(2, "decode", t=2.0)
    assert len(lc2.record(2).spans) == 2


def test_interrupt_closes_span_without_terminal_status():
    lc = LifecycleTracker(TraceBuffer(), MetricsRegistry())
    lc.enqueued(3, t=0.0)
    lc.phase(3, "decode", t=1.0)
    lc.interrupt(3, t=2.0)
    rec = lc.record(3)
    assert not rec.terminal and rec.interrupted
    assert rec.spans[-1].closed and rec.spans[-1].interrupted
    assert lc.open_spans() == []
    # work resumes: a fresh span opens, and finishing completes the chain
    lc.phase(3, "decode", t=3.0)
    lc.finish(3, "done", n_tokens=2, t=4.0)
    assert lc.record(3).complete_chain()


def test_phases_vocabulary_enforced():
    lc = LifecycleTracker()
    lc.enqueued(1)
    with pytest.raises(AssertionError):
        lc.phase(1, "warp_drive")
    assert set(PHASES) == {"queued", "prefill", "decode", "spilled"}


# ---------------------------------------------------------------------------
# recompile watcher
# ---------------------------------------------------------------------------

def test_recompile_watcher_detects_shape_change():
    obs = Observability()
    fn = obs.wrap_step(lambda x: x * 2, "f")
    fn(torch.ones((4,), dtype=torch.float32))
    assert fn.n_compiles == 1
    assert obs.recompiles.n_events == 1
    assert obs.recompiles.events[0].is_warmup
    fn(torch.ones((4,), dtype=torch.float32))    # seen signature: no event
    assert obs.recompiles.n_events == 1
    fn(torch.ones((8,), dtype=torch.float32))    # fresh abstract shape
    assert fn.n_compiles == 2
    ev = obs.recompiles.events[-1]
    assert not ev.is_warmup
    assert any("(4,)" in c and "(8,)" in c for c in ev.changed)
    assert obs.recompiles.n_recompiles == 1
    assert obs.recompiles.counts() == {"f": 2}
    # the trace carries the signature (the CI --require recompile_signature)
    obj = obs.tracer.to_chrome()
    assert "recompile_signature" in trace_features(obj)
    # metrics mirror
    assert obs.metrics.value("recompiles_total", fn="f") == 2.0


def test_watched_function_is_transparent():
    obs = Observability()

    def plus_one(x):
        return x + 1
    plus_one.marker = "kept"
    fn = obs.wrap_step(plus_one, "g")
    ones = torch.ones((2,), dtype=torch.float32)
    out = fn(ones)
    np.testing.assert_allclose(out.numpy(), ones.numpy() + 1)
    # attribute passthrough, and one signature seen
    assert fn.marker == "kept" and fn.__name__ == "plus_one"
    assert fn.n_compiles == 1


def test_signature_rules_scalars_quantized_and_fixed_objects():
    """A Python scalar is its type (a new seed is the same signature, as a
    JAX weak scalar); a QuantizedTensor's format and logical shape are part
    of it; a declared ``fixed`` object keeps the description it had when
    declared, and any other object is walked on every call."""
    obs = Observability()
    fn = obs.wrap_step(lambda params, x, seed: x, "h")
    params = {"w": torch.zeros(3, 2), "b": [torch.zeros(2)]}
    obs.recompiles.fixed(params)
    for seed in (1, 2, 3):
        fn(params, torch.ones(4), seed=seed)
    assert fn.n_compiles == 1
    assert fn.key(params, torch.ones(4), seed=9) == \
        fn.key(dict(params), torch.ones(4), seed=9)
    fn(params, torch.ones(4, dtype=torch.float64), seed=4)
    fn({"w": torch.zeros(5, 2), "b": [torch.zeros(2)]}, torch.ones(4),
       seed=5)
    assert fn.n_compiles == 3
    ev = obs.recompiles.events[-1]
    assert any("['w']" in c and "(3, 2)" in c and "(5, 2)" in c
               for c in ev.changed), ev.changed
    q4 = F.mx8_quantize(torch.randn(2, 64))
    q8 = F.mx8_quantize(torch.randn(4, 64))
    fn(params, q4, seed=1)
    fn(params, F.mx8_quantize(torch.randn(2, 64)), seed=2)
    fn(params, q8, seed=3)
    assert fn.n_compiles == 5
    assert any("QuantizedTensor[mx8](2, 64)" in v
               for v in obs.recompiles.events[-2].signature.values())
    # the site registry is weak: it forgets a shim whose engine is gone
    assert site_compile_counts()["h"] == 5
    del fn
    gc.collect()
    assert "h" not in site_compile_counts()


# ---------------------------------------------------------------------------
# engine integration (both backends)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_fp32():
    cfg = get_smoke_config("llama3.2-1b").with_(
        state_quant=TOPS.StateQuantConfig(fmt="fp32", rounding="nearest",
                                          backend="torch"))
    params = M.init_model(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    return params, cfg


def _mk(params, cfg, backend):
    return Engine(params, cfg, ServeConfig(backend=backend, batch=2,
                                           cache_capacity=128, n_pages=9,
                                           n_slabs=5))


@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_engine_trace_valid_and_chains_complete(tiny_fp32, backend):
    params, cfg = tiny_fp32
    eng = _mk(params, cfg, backend)
    rng = np.random.default_rng(0)
    hs = [eng.submit(rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
                     max_new_tokens=3) for _ in range(3)]
    eng.run()
    obj = eng.obs.tracer.to_chrome()
    assert validate_chrome_trace(obj) == []
    feats = trace_features(obj)
    assert {"steps", "spans", "recompile"} <= feats
    if backend == "paged":
        assert "bank" in feats
    # every terminal request has a complete queued->terminal chain
    recs = eng.obs.lifecycle.terminal_records()
    assert len(recs) == 3
    for r in recs:
        assert r.complete_chain()
        assert r.phase_sequence()[0] == "queued"
    assert eng.obs.lifecycle.open_spans() == []
    # per-request record is reachable through the facade
    rec = eng.lifecycle(hs[0])
    assert rec is not None and rec.ttft_s > 0


def test_stats_is_registry_view(tiny_fp32):
    params, cfg = tiny_fp32
    eng = _mk(params, cfg, "slots")
    rng = np.random.default_rng(1)
    eng.submit(rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
               max_new_tokens=4)
    eng.run()
    st = eng.stats()
    m = eng.obs.metrics
    assert st["tokens"] == m.value("tokens_total")
    assert st["requests_done"] == m.value("requests_total", status="done")
    assert st["prefill_tokens"] == m.value("prefill_tokens_total")
    assert st["compile_steps"] + \
        m.histogram("step_s", compile="false").count \
        == m.family_count("step_s")
    assert st["recompiles"] >= 1.0
    # compile-tagged steps are excluded from the nocompile percentile
    assert st["p99_step_nocompile_s"] <= st["p99_step_s"]


def test_run_max_steps_interrupts_spans(tiny_fp32):
    """Surfaced still-active requests get their open span closed with an
    explicit interrupted marker -- the exported trace has no dangling
    async spans."""
    params, cfg = tiny_fp32
    eng = _mk(params, cfg, "paged")
    rng = np.random.default_rng(2)
    hs = [eng.submit(rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
                     max_new_tokens=64) for _ in range(2)]
    out = eng.run(max_steps=2)
    live = [r for r in out if r.status not in ("done", "aborted",
                                               "truncated")]
    assert live, "workload must still be active at max_steps"
    assert eng.obs.lifecycle.open_spans() == []
    for r in live:
        rec = eng.obs.lifecycle.record(r.rid)
        assert rec.interrupted and rec.spans[-1].interrupted
    assert validate_chrome_trace(eng.obs.tracer.to_chrome()) == []
    # resuming reopens a span in the interrupted phase; chains complete
    eng.run()
    for h in hs:
        rec = eng.obs.lifecycle.record(h.rid)
        assert rec.complete_chain()
    for r in live:
        seq = eng.obs.lifecycle.record(r.rid).phase_sequence()
        assert seq.count("decode") >= 2


def test_prometheus_endpoint_smoke(tiny_fp32):
    params, cfg = tiny_fp32
    eng = _mk(params, cfg, "paged")
    rng = np.random.default_rng(3)
    eng.submit(rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
               max_new_tokens=2)
    eng.run()
    text = eng.prometheus_text()
    assert "# TYPE requests_total counter" in text
    assert "# TYPE step_s summary" in text
    assert "pages_alloc_total" in text


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    items = (tree.values() if isinstance(tree, dict) else tree
             if isinstance(tree, (list, tuple)) else vars(tree).values())
    for v in items:
        if isinstance(v, (torch.Tensor, dict, list, tuple)) or \
                hasattr(v, "__dict__"):
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


@pytest.mark.parametrize("kw", [{}, {"spec": "ngram"},
                                {"backend": "slots"}],
                         ids=["paged", "verify", "slots"])
def test_dropped_engine_frees_its_memory_at_once(tiny_fp32, kw):
    """The tracer and the watcher add no reference cycle through an engine:
    dropped by its caller, it frees its pools or caches at once, not when
    the cycle collector runs (a pool holding its own wrapped bound methods
    kept its pools -- 0.3 GB at zamba2-2.7b -- alive into the next phase's
    peak on the card)."""
    params, cfg = tiny_fp32
    eng = Engine(params, cfg, ServeConfig(batch=2, n_pages=9, n_slabs=5,
                                          cache_capacity=128, **kw))
    rng = np.random.default_rng(4)
    for n in (9, 140, 17):
        eng.submit(rng.integers(0, cfg.vocab_size, n), max_new_tokens=3)
    eng.run()
    e = eng.engine
    held = weakref.ref(_first_tensor(e.pool.pools if kw.get("backend")
                                     != "slots" else e.caches))
    gc.disable()
    try:
        del eng, e
        assert held() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# watcher counts against the JAX watcher (the JAX retrace pins' workloads)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama_pair():
    """llama3.2-1b smoke, fp32 state, round to nearest: the JAX pins'
    config, and the port's on the same weights."""
    jcfg = j_smoke("llama3.2-1b").with_(state_quant=JOPS.StateQuantConfig(
        "fp32", "nearest", "jnp"))
    tcfg = get_smoke_config("llama3.2-1b").with_(
        state_quant=TOPS.StateQuantConfig("fp32", "nearest", "torch"))
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _serve_both(pair, pcfg_kw, prompts, max_new):
    jcfg, tcfg, jparams, tparams = pair
    jeng = JPagedServingEngine(jparams, jcfg, JPagedEngineConfig(**pcfg_kw))
    teng = PagedServingEngine(tparams, tcfg, PagedEngineConfig(**pcfg_kw))
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=max_new))
        teng.submit(Request(rid=i, prompt=p, max_new_tokens=max_new))
    jdone, tdone = jeng.run(), teng.run()
    assert sorted((r.rid, r.output) for r in tdone) == \
        sorted((r.rid, r.output) for r in jdone)
    return jeng, teng


def _same_counts(jeng, teng):
    """Every site both packages register has the JAX count, and the
    stats' ``recompiles`` is the JAX engine's."""
    jc, tc = jeng.obs.recompiles.counts(), teng.obs.recompiles.counts()
    assert set(tc) == set(jc), (tc, jc)
    assert tc == jc
    assert teng.stats()["recompiles"] == jeng.stats()["recompiles"]
    return tc


def test_watcher_counts_match_jax_constant_shapes(llama_pair):
    """``tests/test_paged_decode.py::test_paged_engine_decode_no_retrace``:
    equal-length prompts in one page bucket at the full decode batch are
    served at one ``pool.decode`` signature, warmup only."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, 12).astype(np.int32) for _ in range(4)]
    jeng, teng = _serve_both(llama_pair, dict(
        max_decode_batch=4, n_pages=9, n_slabs=9, prefill_chunk=128),
        prompts, 4)
    counts = _same_counts(jeng, teng)
    assert counts["pool.decode"] == teng.pool._decode.n_compiles == 1
    assert teng.obs.recompiles.n_recompiles == 0, \
        [e.changed for e in teng.obs.recompiles.events if not e.is_warmup]
    assert site_compile_counts()["pool.decode"] == 1
    stats = teng.stats()
    assert stats["recompiles"] == float(len(teng.obs.recompiles.events))


def test_watcher_counts_match_jax_prefill_buckets(llama_pair):
    """``tests/test_paged_pool.py::test_paged_engine_prefill_buckets``: six
    prompt lengths, two prefill buckets, so ``engine.prefill`` sees at most
    two signatures -- in both packages, site for site."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (9, 11, 13, 42, 44, 46)]
    jeng, teng = _serve_both(llama_pair, dict(
        max_decode_batch=3, n_pages=9, n_slabs=7, prefill_chunk=128,
        prefill_buckets=(8, 32, 128)), prompts, 4)
    counts = _same_counts(jeng, teng)
    assert counts.get("engine.prefill", 0) <= 2


# ---------------------------------------------------------------------------
# the trace sequence against the JAX engine's
# ---------------------------------------------------------------------------

#: a fault plan over the engine's and the pool's sites (no watchdog: its
#: trips follow each engine's wall clock)
_PLAN = "alloc:nth=2;blob_corrupt:nth=1;nan:rid=2;slow_step:step=3,ms=1"
_TIME_ARGS = ("dt_s",)


@pytest.fixture(scope="module")
def zamba_traces():
    """The workload of ``test_greedy_streams_match_jax_with_preemption``
    (4 usable pages, FCFS preempts through the headroom check) through
    both packages' paged engines: plain, and with n-gram speculation and
    ``_PLAN``.  Returns {variant: (jax trace, port trace, statuses)}."""
    from test_torch_paged_serving import _pair
    jcfg, tcfg, jparams, tparams = _pair("zamba2-2.7b")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, n) for n in (120, 118, 121, 100)]
    out = {}
    for variant, extra in (("plain", {}),
                           ("spec_faults", dict(spec="ngram",
                                                fault_plan=_PLAN))):
        kw = dict(batch=3, n_pages=5, prefill_chunk=128, **extra)
        runs = []
        for eng in (JEngine(jparams, jcfg, JServeConfig(**kw)),
                    Engine(tparams, tcfg, ServeConfig(**kw))):
            hs = [eng.submit(p, max_new_tokens=12) for p in prompts]
            eng.run()
            runs.append((eng.obs.tracer.to_chrome(),
                         [(h.status, h.output) for h in hs],
                         eng.stats()["preemptions"]))
        (jt, js, jp), (tt, ts, tp) = runs
        assert ts == js and tp == jp >= 1
        out[variant] = (jt, tt, [s for s, _ in ts])
    return out


def _sequence(obj):
    """(ph, cat, name, track, args without time) per event, ``jit`` and
    metadata events dropped; ``compiled`` is dropped from a step's args
    (JAX: the step paid an XLA compile; the port: a kernel build)."""
    evs = obj["traceEvents"]
    tracks = {e["tid"]: e["args"]["name"] for e in evs if e["ph"] == "M"}
    out = []
    for e in evs:
        if e["ph"] == "M" or e.get("cat") == "jit":
            continue
        args = {k: v for k, v in e.get("args", {}).items()
                if k not in _TIME_ARGS
                and not (e["ph"] == "X" and k == "compiled")}
        out.append(((e["ph"], e.get("cat"), e["name"], tracks[e["tid"]]),
                    args))
    return out


@pytest.mark.parametrize("variant", ["plain", "spec_faults"])
def test_trace_sequence_matches_jax(zamba_traces, variant):
    jt, tt, statuses = zamba_traces[variant]
    js, ts = _sequence(jt), _sequence(tt)
    assert [k for k, _ in ts] == [k for k, _ in js]
    for (key, a), (_, b) in zip(ts, js):
        if key[0] == "C":                       # counters: numeric values
            assert a == pytest.approx(b, rel=1e-12), key
        else:
            assert a == b, key
    names = {k[2] for k, _ in ts}
    assert {"decode_step", "prefill", "bank_traffic", "pool",
            "pool.spill", "sched.enqueue", "sched.dispatch",
            "tier.demote"} <= names
    if variant == "spec_faults":
        assert {"spec", "fault.alloc", "fault.blob_corrupt",
                "fault.blob_corrupt_detected", "fault.nan",
                "fault.quarantine", "fault.slow_step"} <= names
        assert statuses.count("failed") == 1
        feats = trace_features(tt)
        assert {"steps", "spans", "bank", "recompile", "speculation",
                "resilience", "tiered"} <= feats


def test_schema_agrees_both_ways(zamba_traces, tmp_path):
    """The JAX schema accepts the port's traces and the port's accepts the
    JAX ones; the same errors on the broken traces, the same features."""
    for jt, tt, _ in zamba_traces.values():
        for obj in (jt, tt):
            assert validate_chrome_trace(obj) == [] == j_validate(obj)
            assert trace_features(obj) == j_trace_features(obj)
        assert trace_features(tt) == trace_features(jt)
    for bad in ([], {}, _BAD):
        assert validate_chrome_trace(bad) == j_validate(bad)
    tr = TraceBuffer()
    tr.counter("bank_traffic", {"pch00_bursts": 1.0})
    assert trace_features(tr.to_chrome()) == \
        j_trace_features(tr.to_chrome()) == {"bank"}


def test_prefetch_span_holds_a_decode_step(llama_pair):
    """As ``tests/test_tiered.py`` holds it: a long request preempted by an
    urgent one at batch 1 comes back through a staged prefetch, and at
    least one ``decode_step`` X event lies inside a ``prefetch`` b/e span
    of the port's trace."""
    _, tcfg, _, tparams = llama_pair
    eng = Engine(tparams, tcfg, ServeConfig(
        backend="paged", batch=1, n_pages=9, n_slabs=5,
        sampling=SamplingConfig(temperature=0.0),
        scheduler=SchedulerConfig(policy="priority")))
    rng = np.random.default_rng(2)
    hb = eng.submit(rng.integers(0, 512, 140), max_new_tokens=8, priority=5)
    prompt_a = rng.integers(0, 512, 8)
    while hb.status == "queued" and eng.step():
        pass
    ha = eng.submit(prompt_a, max_new_tokens=6, priority=0)
    eng.engine._preempt(hb.rid)
    eng.run()
    assert ha.status == hb.status == "done"
    assert eng.stats()["prefetch_commits"] >= 1
    evs = eng.obs.tracer.events()
    begins = [e for e in evs
              if e.get("cat") == "prefetch" and e["ph"] == "b"]
    ends = {e["id"]: e["ts"] for e in evs
            if e.get("cat") == "prefetch" and e["ph"] == "e"}
    steps = [e for e in evs if e.get("cat") == "step" and e["ph"] == "X"]
    assert begins, "no prefetch span in the trace"
    assert any(s["ts"] >= b["ts"] and s["ts"] + s["dur"] <= ends[b["id"]]
               for b in begins for s in steps), \
        "no decode step ran inside a prefetch span"
    assert "tiered" in trace_features(eng.obs.tracer.to_chrome())


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_trace_stream_turns_mixed(tmp_path, capsys):
    from repro_torch.launch import serve
    out_json = tmp_path / "serve.json"
    assert serve.main(["--arch", "zamba2-2.7b", "--smoke-size", "--device",
                       "cpu", "--paged", "--mixed", "--stream", "--turns",
                       "2", "--requests", "4", "--max-new", "3",
                       "--state-format", "fp32", "--trace",
                       str(out_json)]) == 0
    out = capsys.readouterr().out
    assert "] += [" in out                    # streamed tokens
    assert "turn 1: sent 9 tokens" in out
    assert "session ingested" in out
    assert "pool.decode=" in out and f"-> {out_json}" in out
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.schema", str(out_json),
         "--require", "steps,spans,bank,recompile"],
        capture_output=True, text=True, timeout=120, env=subprocess_env())
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK: ")


def test_launcher_turns_needs_paged():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="--turns needs --paged"):
        serve.main(["--arch", "zamba2-2.7b", "--smoke-size", "--device",
                    "cpu", "--turns", "2"])
