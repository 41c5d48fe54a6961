"""The port's resilience layer against the JAX package's (mirrors
``tests/test_resilience.py``): deterministic fault injection
(``repro_torch.serving.faults``) and graceful degradation
(``repro_torch.serving.resilience``) -- every injected fault maps to its
documented recovery, non-faulted requests stay bit-exact, the engine always
drains to terminal statuses, and the port's engine ends each faulted run
with the JAX engine's statuses, streams and fault counters.

* ``FaultPlan``: the spec grammar, and the same fires as the JAX plan over
  1,000 checks for each trigger kind (``step``, ``nth``, ``p``, ``rid``,
  ``n``, combinations);
* checksums (``corrupt_blob`` on every dtype and on read-only / overlapping
  views), bounded retry, the watchdog, the ladder's rungs;
* engine level at fp32, greedy, ``llama3.2-1b``: nan quarantine, transient
  alloc, slow step, corrupt spill blob, host pin, prefetch commit,
  admission control, and the chaos seeds 11 and 23, each against the JAX
  engine run on the same plan (an abort racing a staged prefetch is in
  ``test_torch_tiered.py``).

The whole module runs under the shadow-ledger sanitizer (conftest):
any fault path that leaks pages or staged prefetches raises.
"""
import numpy as np
import pytest
import torch

from repro.serving.api import Engine as JEngine
from repro.serving.api import ServeConfig as JServeConfig
from repro.serving.faults import FaultPlan as JFaultPlan
from repro_torch.serving.api import Engine, ServeConfig
from repro_torch.serving.engine import TERMINAL_STATUSES
from repro_torch.serving.faults import SITES, FaultPlan, FaultSpecError
from repro_torch.serving.resilience import (LADDER, BlobCorruption,
                                            StepWatchdog, corrupt_blob,
                                            crc_blob, retry_transient,
                                            verify_blob)
from repro_torch.serving.sampler import SamplingConfig
from repro_torch.serving.scheduler import SchedulerConfig

from test_torch_paged_serving import _pair

torch.set_num_threads(1)  # test workers share the cores: one thread each

_GREEDY = SamplingConfig(temperature=0.0)


# ---------------------------------------------------------------------------
# FaultPlan: spec grammar, deterministic triggers, parity with JAX
# ---------------------------------------------------------------------------

def test_fault_spec_parses_every_site():
    plan = FaultPlan(";".join(SITES))
    assert set(plan.rules) == set(SITES)
    assert plan.total_injected == 0


@pytest.mark.parametrize("bad", [
    "", "   ", "frobnicate:nth=1", "alloc:nth", "alloc:nth=",
    "alloc:wat=3", "nan:p=1.5", "alloc:nth=1;alloc:nth=2",
])
def test_fault_spec_rejects_malformed(bad):
    with pytest.raises(FaultSpecError):
        FaultPlan(bad)


def test_nth_step_rid_triggers_and_caps():
    plan = FaultPlan("alloc:nth=3")
    assert [plan.should_fire("alloc") for _ in range(6)] == \
        [False, False, True, False, False, False]
    plan = FaultPlan("alloc:step=2")
    plan.set_step(1)
    assert not plan.should_fire("alloc")
    plan.set_step(2)
    assert plan.should_fire("alloc")
    assert not plan.should_fire("alloc")      # one-shot by default
    plan = FaultPlan("nan:rid=3,n=2")
    assert not plan.should_fire("nan", rid=1)
    assert plan.should_fire("nan", rid=3) and plan.should_fire("nan", rid=3)
    assert not plan.should_fire("nan", rid=3)  # n=2 cap reached
    assert plan.injected["nan"] == 2
    assert not FaultPlan("alloc:nth=1").should_fire("host_pin")


def test_plan_from_env_and_maybe_precedence():
    assert FaultPlan.from_env(env={}) is None
    plan = FaultPlan.from_env(env={"REPRO_FAULTS": "nan:rid=1"}, seed=3)
    assert plan is not None and plan.seed == 3
    assert FaultPlan.maybe(None, use_env=False) is None
    explicit = FaultPlan.maybe("alloc:nth=1", seed=2)
    assert explicit is not None and "alloc" in explicit.rules
    assert plan.param("slow_step", "ms", default=9.0) == 9.0
    assert FaultPlan("slow_step:ms=250").param("slow_step", "ms") == 250.0


@pytest.mark.parametrize("spec", [
    "alloc:step=17", "alloc:step=17,n=3", "host_pin:nth=300",
    "blob_corrupt:p=0.3", "prefetch_commit:p=0.05,n=7", "nan:rid=3",
    "nan:rid=3,n=40", "slow_step:p=0.5,ms=2",
    "alloc:p=0.4,rid=2;nan:p=0.1;host_pin:step=5,nth=40",
])
@pytest.mark.parametrize("seed", [0, 11])
def test_plan_fires_on_the_checks_the_jax_plan_fires_on(spec, seed):
    """1,000 checks, their sites and rids drawn from a seeded generator and
    the step counter sweeping 0 to 39, through both plans: the same fires,
    check for check."""
    rng = np.random.default_rng(seed + 1)
    t, j = FaultPlan(spec, seed=seed), JFaultPlan(spec, seed=seed)
    sites = list(t.rules) + ["alloc", "nan"]
    fired = []
    for i in range(1000):
        if i % 25 == 0:                      # the step counter sweeps 0..39
            t.set_step(i // 25)
            j.set_step(i // 25)
        site = sites[int(rng.integers(0, len(sites)))]
        rid = None if rng.random() < 0.2 else int(rng.integers(0, 6))
        a, b = t.should_fire(site, rid=rid), j.should_fire(site, rid=rid)
        assert a == b, (i, site, rid)
        fired.append(a)
    assert t.injected == j.injected
    assert any(fired)


# ---------------------------------------------------------------------------
# resilience primitives: checksums, bounded retry, watchdog, ladder
# ---------------------------------------------------------------------------

def test_blob_crc_roundtrip_detects_single_byte_flip():
    blob = [torch.arange(12, dtype=torch.float32).reshape(3, 4),
            torch.zeros(5, dtype=torch.int32),
            torch.ones(3, dtype=torch.bfloat16),
            torch.zeros(4, dtype=torch.uint8)]
    crc = crc_blob(blob)
    verify_blob(blob, crc, "spill blob")           # clean: no raise
    verify_blob(blob, None, "legacy blob")         # unchecked: no raise
    corrupt_blob(blob)
    with pytest.raises(BlobCorruption) as ei:
        verify_blob(blob, crc, "spill blob", rid=7)
    assert ei.value.rid == 7 and "spill blob" in str(ei.value)
    assert crc_blob([torch.zeros(0), blob[1]]) != 0


def test_crc_is_shape_sensitive():
    a = [torch.arange(12, dtype=torch.float32).reshape(3, 4)]
    b = [torch.arange(12, dtype=torch.float32).reshape(4, 3)]
    assert crc_blob(a) != crc_blob(b)


def test_corrupt_blob_handles_readonly_and_overlapping_views():
    """An overlapping view cannot be written in place (the stride-0 rows
    share memory) and a view of read-only numpy memory must not be: the
    poisoned copy replaces the entry, the source stays as it was."""
    base = torch.arange(4, dtype=torch.float32)
    ro = np.arange(6, dtype=np.float16)
    ro.setflags(write=False)
    with pytest.warns(UserWarning):
        ro_t = torch.from_numpy(ro)
    for view in (base.expand(3, 4), ro_t, torch.zeros(0)):
        blob = [torch.zeros(0), view]
        crc = crc_blob(blob)
        src = view.clone()
        corrupt_blob(blob)
        if view.numel():
            assert crc_blob(blob) != crc
            assert torch.equal(view, src)         # not mutated
            assert blob[1].shape == view.shape
        else:
            assert crc_blob(blob) == crc          # nothing to flip


def test_retry_transient_bounded():
    calls = []

    def flaky():
        calls.append(1)
        return len(calls) >= 3

    retries = []
    assert retry_transient(flaky, attempts=4,
                           on_retry=retries.append) is True
    assert len(calls) == 3 and retries == [1, 2]
    assert retry_transient(lambda: False, attempts=3) is False

    def boom():
        raise RuntimeError("real fault")
    with pytest.raises(RuntimeError):       # exceptions are not transient
        retry_transient(boom)


def test_watchdog_flags_only_over_budget_and_ladder():
    wd = StepWatchdog(None)
    assert not wd.enabled and not wd.observe(0, 1e9)
    wd = StepWatchdog(0.1)
    assert not wd.observe(0, 0.05)
    assert wd.observe(1, 0.25) and wd.trips == 1
    assert wd.slowest_s == 0.25
    assert tuple(LADDER) == ("drop_prefix", "demote_store", "preempt",
                             "shed")


# ---------------------------------------------------------------------------
# engine level: fault -> recovery, against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama():
    return _pair("llama3.2-1b")


def _engines(llama, **kw):
    jcfg, tcfg, jparams, tparams = llama
    return (JEngine(jparams, jcfg, JServeConfig(sampling=_GREEDY, **kw)),
            Engine(tparams, tcfg, ServeConfig(sampling=_GREEDY, **kw)))


def _run_batch(eng, max_new=5):
    rng = np.random.default_rng(0)
    hs = [eng.submit(rng.integers(0, 512, n), max_new_tokens=max_new)
          for n in (10, 14, 18)]
    eng.run()
    return hs


_BATCH = dict(batch=2, n_pages=17, n_slabs=5)
#: the fault counters a run leaves behind (not the watchdog's trips: they
#: follow each engine's wall clock, and a JAX step that compiles trips too)
_COUNTERS = ("faults_injected_total", "faults_recovered_total",
             "fault_retries_total", "degradations_total", "quarantines_total",
             "blob_corruptions_total", "request_timeouts_total")


def _same_outcome(jeng, jh, teng, th):
    """Statuses, streams, details' presence, fault counters, injected
    faults and the tier keys: the port's run is the JAX run."""
    assert [(h.status, h.output) for h in th] == \
        [(h.status, h.output) for h in jh]
    jm, tm = jeng.obs.metrics, teng.obs.metrics
    for name in _COUNTERS:
        assert tm.family_total(name) == jm.family_total(name), name
    if jeng.engine.faults is not None:
        assert teng.engine.faults.injected == jeng.engine.faults.injected
    js, ts = jeng.stats(), teng.stats()
    for k in ("requests_done", "requests_failed", "requests_rejected",
              "preemptions", "prefetch_commits", "tier_misses",
              "promote_bytes", "demote_bytes", "host_bytes"):
        assert ts[k] == js[k], k


@pytest.fixture(scope="module")
def baseline(llama):
    """Fault-free outputs of the 3-request batch workload (port)."""
    _, tcfg, _, tparams = llama
    eng = Engine(tparams, tcfg, ServeConfig(sampling=_GREEDY, **_BATCH))
    hs = _run_batch(eng)
    assert [h.status for h in hs] == ["done"] * 3
    assert eng.engine.faults is None          # no plan installed
    assert not eng.engine._nan_guard          # no per-step finite scan
    assert not eng.engine.watchdog.enabled    # no wall-clock checks
    return [h.output for h in hs]


@pytest.mark.parametrize("plan, kw", [
    ("nan:rid=1", {}),
    ("alloc:nth=1", {}),
    ("slow_step:step=1,ms=80", {"step_budget_s": 0.05}),
])
def test_batch_faults_recover_like_jax(llama, baseline, plan, kw):
    jeng, teng = _engines(llama, fault_plan=plan, **_BATCH, **kw)
    jh, th = _run_batch(jeng), _run_batch(teng)
    _same_outcome(jeng, jh, teng, th)
    m = teng.obs.metrics
    if plan.startswith("nan"):
        assert th[1].status == "failed"
        assert "non-finite" in th[1].request.detail
        # the other rows of the same decode batch are untouched
        assert [th[0].output, th[2].output] == [baseline[0], baseline[2]]
        assert m.value("quarantines_total") == 1
        assert teng.stats()["requests_failed"] == 1
    else:
        assert [h.output for h in th] == baseline
    if plan.startswith("alloc"):
        assert m.value("fault_retries_total", site="alloc") >= 1
        assert m.value("faults_recovered_total", site="alloc") >= 1
    if plan.startswith("slow"):
        assert teng.engine.watchdog.trips >= 1
        assert m.value("watchdog_trips_total") >= 1


def _run_preempted(eng):
    """Long request B preempted by urgent A at batch 1: spill -> host pin
    -> (staged prefetch ->) resume under the engine's plan."""
    rng = np.random.default_rng(2)
    prompt_b = rng.integers(0, 512, 140)
    prompt_a = rng.integers(0, 512, 8)
    hb = eng.submit(prompt_b, max_new_tokens=8, priority=5)
    while hb.status == "queued" and eng.step():
        pass
    ha = eng.submit(prompt_a, max_new_tokens=6, priority=0)
    eng.engine._preempt(hb.rid)
    eng.run()
    return [ha, hb]


_PREEMPT = dict(batch=1, n_pages=9, n_slabs=5,
                scheduler=SchedulerConfig(policy="priority"))


@pytest.fixture(scope="module")
def preempt_ref(llama):
    """B served alone, never preempted, never faulted (port)."""
    _, tcfg, _, tparams = llama
    eng = Engine(tparams, tcfg, ServeConfig(sampling=_GREEDY, **_PREEMPT))
    prompt_b = np.random.default_rng(2).integers(0, 512, 140)
    return eng.submit(prompt_b, max_new_tokens=8, priority=5
                      ).result().output


@pytest.mark.parametrize("plan, site", [
    ("blob_corrupt:nth=1", "blob_corrupt"),
    ("host_pin:nth=1", None),
    ("prefetch_commit:nth=1", "prefetch_commit"),
])
def test_tier_faults_recover_like_jax(llama, preempt_ref, plan, site):
    """A corrupt spill blob re-prefills from the retained tokens; a failed
    host pin retries (live state is never dropped); a failed prefetch
    commit falls back to the synchronous resume.  B's stream stays the
    never-preempted one and the host tier drains."""
    jeng, teng = _engines(llama, fault_plan=plan, **_PREEMPT)
    jh, th = _run_preempted(jeng), _run_preempted(teng)
    _same_outcome(jeng, jh, teng, th)
    ha, hb = th
    assert ha.status == hb.status == "done"
    assert hb.output == preempt_ref
    assert teng.engine.faults.total_injected == 1
    m = teng.obs.metrics
    if site is not None:
        assert m.value("faults_recovered_total", site=site) == 1
    if site == "blob_corrupt":
        assert m.value("blob_corruptions_total") == 1
    assert teng.engine.pool.host.pinned_bytes == 0


def test_never_admittable_head_is_rejected_not_spun(llama):
    _, tcfg, _, tparams = llama
    # the whole prompt in one prefill (the JAX test streams 768 of 896
    # tokens through decode steps, 768 eager steps here)
    eng = Engine(tparams, tcfg, ServeConfig(
        batch=1, n_pages=9, n_slabs=5, sampling=_GREEDY,
        prefill_chunk=1024))
    rng = np.random.default_rng(4)
    # a retained request holds every usable page past completion
    big = eng.submit(rng.integers(0, 512, 1024), max_new_tokens=1,
                     retain=True)
    big.result()
    assert big.status == "done" and eng.engine.pool.free_pages == 0
    h = eng.submit(rng.integers(0, 512, 12), max_new_tokens=4)
    eng.run()                                # must terminate, not spin
    assert h.status == "rejected"
    assert "page budget" in h.request.detail
    assert eng.stats()["requests_rejected"] == 1
    eng.release(big)


def test_max_queued_sheds_at_the_door(llama, baseline):
    jeng, teng = _engines(llama, max_queued=1, **_BATCH)
    jh, th = _run_batch(jeng), _run_batch(teng)
    _same_outcome(jeng, jh, teng, th)
    assert th[0].status == "done" and th[0].output == baseline[0]
    assert [h.status for h in th[1:]] == ["rejected"] * 2
    assert all("max_queued" in h.request.detail for h in th[1:])
    assert teng.stats()["requests_rejected"] == 2


def test_request_timeout_expires_stale_queue_entries(llama):
    _, tcfg, _, tparams = llama
    eng = Engine(tparams, tcfg, ServeConfig(
        batch=1, n_pages=17, n_slabs=5, sampling=_GREEDY,
        request_timeout_s=50.0))
    rng = np.random.default_rng(5)
    ha = eng.submit(rng.integers(0, 512, 10), max_new_tokens=5)
    while ha.status == "queued" and eng.step():
        pass
    hb = eng.submit(rng.integers(0, 512, 14), max_new_tokens=5)
    hb.request.t_submit -= 100.0    # as if 100 s were already spent queued
    eng.run()
    assert ha.status == "done"
    assert hb.status == "rejected"
    assert "request_timeout_s" in hb.request.detail
    assert eng.obs.metrics.value("request_timeouts_total") >= 1


def test_slots_backend_rejects_what_the_jax_slots_backend_rejects():
    for kw in ({"fault_plan": "nan:rid=0"}, {"nan_guard": True},
               {"max_queued": 4}, {"request_timeout_s": 1.0},
               {"step_budget_s": 0.5}, {"prefix_cache": True},
               {"spec": "ngram"}):
        with pytest.raises(ValueError, match="paged"):
            JServeConfig(backend="slots", **kw)
        with pytest.raises(ValueError, match="paged"):
            ServeConfig(backend="slots", **kw)
    # and nothing else: the tier's sizes have defaults both accept
    for kw in ({"prefix_store_pages": 8}, {"host_tier_bytes": 1 << 20},
               {"prefetch_window": 0}):
        JServeConfig(backend="slots", **kw)
        ServeConfig(backend="slots", **kw)
    fields = ("prefix_cache", "prefix_store_pages", "host_tier_bytes",
              "prefetch_window", "fault_plan", "nan_guard", "max_queued",
              "request_timeout_s", "step_budget_s")
    assert [getattr(ServeConfig(), f) for f in fields] == \
        [getattr(JServeConfig(), f) for f in fields]


# ---------------------------------------------------------------------------
# seeded chaos: random plans under open-loop traffic always drain
# ---------------------------------------------------------------------------

def _random_plan(rng) -> str:
    clauses = []
    if rng.random() < 0.7:
        clauses.append(f"alloc:p={rng.uniform(0.05, 0.4):.2f}")
    if rng.random() < 0.5:
        clauses.append(f"nan:p={rng.uniform(0.02, 0.15):.2f}")
    if rng.random() < 0.5:
        clauses.append(f"slow_step:p={rng.uniform(0.1, 0.5):.2f},ms=1")
    if rng.random() < 0.5:
        clauses.append("host_pin:p=0.5")
    if rng.random() < 0.5:
        clauses.append("blob_corrupt:p=0.5")
    if rng.random() < 0.5:
        clauses.append("prefetch_commit:p=0.5")
    return ";".join(clauses) or "alloc:p=0.25"


def _chaos(eng, rng, vocab=512):
    hs = []
    for _ in range(6):
        n = int(rng.integers(6, 24))
        hs.append(eng.submit(rng.integers(0, vocab, n).astype(np.int32),
                             max_new_tokens=int(rng.integers(2, 6))))
        eng.step()                           # open loop: arrivals mid-run
    eng.run()
    return hs


@pytest.mark.parametrize("seed", [11, 23])
def test_chaos_ends_like_jax_and_drains(llama, seed):
    """The JAX test's chaos plans (same generator, same draws): every
    request terminal, the engine drained, the sanitizer silent -- and the
    statuses, streams and fault counters those of the JAX engine."""
    plan = _random_plan(np.random.default_rng(seed))
    jeng, teng = _engines(llama, fault_plan=plan, **_BATCH)
    jh, th = [], []
    for eng, hs in ((jeng, jh), (teng, th)):
        rng = np.random.default_rng(seed)
        _random_plan(rng)                    # the draws the plan took
        hs.extend(_chaos(eng, rng))
    _same_outcome(jeng, jh, teng, th)
    statuses = [h.status for h in th]
    assert all(s in TERMINAL_STATUSES for s in statuses), (plan, statuses)
    assert not teng.engine.has_work()
    assert teng.engine.pool.host.pinned_bytes == 0
    assert any(s == "done" for s in statuses), plan
