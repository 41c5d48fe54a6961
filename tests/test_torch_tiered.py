"""The port's tiered pool and radix prefix store against the JAX package's
(mirrors ``tests/test_tiered.py`` and ``tests/test_prefix_store.py``).

* scheduler lookahead, the host-tier ledger and the radix tree's invariants
  (deterministic cases, the hypothesis properties run on the port's own
  store, and a random operation sequence driven through both stores);
* the tier moves (``extract_pages`` / ``insert_pages`` / ``extract_slab`` /
  ``insert_slab``) round-trip bitwise, with the JAX layout's dtypes and
  bytes;
* engine level at fp32, greedy: the ten tier keys of ``stats()`` equal the
  JAX paged engine's under preemption, through an async prefetch resume,
  and for warm and cold prefix-store hits of ``llama3.2-1b``,
  ``zamba2-2.7b`` and ``gla-2.7b``, with the same token streams (and the
  streams equal the same requests served without the cache);
* the staged-prefetch ledger: cancel, abort and the sanitizer's PL255.

The JAX engines are built once per module (fixtures), so the file stays
near a minute serial.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as JOPS
from repro.configs import get_smoke_config as j_smoke
from repro.serving.api import Engine as JEngine
from repro.serving.api import ServeConfig as JServeConfig
from repro.serving.memory import PagedStatePool as JPool
from repro.serving.memory.prefix_store import PrefixStore as JPrefixStore
from repro_torch import ops as TOPS
from repro_torch.analysis.lint.runtime import SanitizerError
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.paged import PAGE_TOKENS
from repro_torch.serving.api import Engine, ServeConfig
from repro_torch.serving.engine import Request
from repro_torch.serving.memory import (HostTier, PrefixStore,
                                        TieredStatePool)
from repro_torch.serving.sampler import SamplingConfig
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig

from test_torch_paged_serving import _pair

torch.set_num_threads(1)  # test workers share the cores: one thread each

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

#: the tier keys of the paged engine's stats()
TIER_KEYS = ("prefix_hits", "prefix_hit_pages", "prefix_hit_tokens",
             "prefix_store_pages", "prefetch_commits", "tier_hits",
             "tier_misses", "promote_bytes", "demote_bytes", "host_bytes")
_GREEDY = SamplingConfig(temperature=0.0)


def _tier_equal(jeng, teng):
    js, ts = jeng.stats(), teng.stats()
    for k in TIER_KEYS:
        assert ts[k] == js[k], (k, ts[k], js[k])
    return ts


# ---------------------------------------------------------------------------
# scheduler lookahead, host tier ledger
# ---------------------------------------------------------------------------

def _req(rid, priority=0, t=0.0):
    r = Request(rid=rid, prompt=np.zeros(4, np.int32), priority=priority)
    r.t_submit = t
    return r


def test_lookahead_dispatch_order_without_popping():
    s = Scheduler(SchedulerConfig(policy="priority"))
    for rid, pri in ((0, 5), (1, 0), (2, 3)):
        s.push(_req(rid, pri, t=rid))
    assert [r.rid for r in s.lookahead(2)] == [1, 2]
    assert [r.rid for r in s.lookahead(10)] == [1, 2, 0]
    assert len(s) == 3                       # nothing popped
    s.remove(1)
    assert [r.rid for r in s.lookahead(2)] == [2, 0]   # tombstone skipped


def test_lookahead_respects_resume_boost():
    s = Scheduler(SchedulerConfig(policy="priority"))
    s.push(_req(0, priority=1, t=0.0))
    s.push(_req(1, priority=1, t=1.0), resumed=True)   # boost beats t_submit
    assert [r.rid for r in s.lookahead(2)] == [1, 0]


def test_host_tier_pins_overshoot_cache_respects_budget():
    h = HostTier(byte_budget=100)
    h.pin(1, 80.0)
    assert h.room_for(20) and not h.room_for(21)
    h.pin(2, 50.0)                 # pins may overshoot: live state survives
    assert h.bytes_used == 130.0 and not h.room_for(1)
    assert h.unpin(1) == 80.0 and h.unpin(1) == 0.0
    h.cache_add(40.0)
    assert h.bytes_used == 90.0
    h.cache_drop(60.0)             # clamped at zero
    assert h.cached_bytes == 0.0
    assert HostTier(None).room_for(1e18)     # unmetered


# ---------------------------------------------------------------------------
# radix tree invariants (the port's own store)
# ---------------------------------------------------------------------------

def _tok(page_vals, page_tokens=4):
    """Token list whose i-th page chunk is page_vals[i] repeated."""
    out = []
    for v in page_vals:
        out.extend([v] * page_tokens)
    return out


def test_chunks_drops_partial_tail():
    s = PrefixStore(8, page_tokens=4)
    assert s.chunks([1, 2, 3]) == []
    assert s.chunks([1, 2, 3, 4, 5]) == [(1, 2, 3, 4)]
    assert s.chunks([1, 2, 3, 4, 5, 6, 7, 8], max_pages=1) == [(1, 2, 3, 4)]
    with pytest.raises(ValueError):
        PrefixStore(0)


def test_extend_then_match_longest_prefix():
    s = PrefixStore(8, page_tokens=4)
    path, created = s.extend(s.chunks(_tok([1, 2, 3])))
    assert len(path) == len(created) == 3
    assert [n.depth for n in path] == [1, 2, 3]
    assert s.match(s.chunks(_tok([1, 2, 3]))) == path
    assert s.match(s.chunks(_tok([1, 2, 9]))) == path[:2]
    assert s.match(s.chunks(_tok([9, 2, 3]))) == []
    path2, created2 = s.extend(s.chunks(_tok([1, 2, 3, 4])))
    assert path2[:3] == path and len(created2) == 1


def test_eviction_leaf_only_lru_order():
    s = PrefixStore(8, page_tokens=4)
    s.extend(s.chunks(_tok([1, 2, 3])))
    cands = s.evict_candidates()
    assert [n.depth for n in cands] == [3]      # only the leaf
    s.remove(cands[0])
    assert s.n_pages == 2
    assert [n.depth for n in s.evict_candidates()] == [2]


def test_locked_nodes_never_evicted():
    s = PrefixStore(2, page_tokens=4)
    path, _ = s.extend(s.chunks(_tok([1, 2])))
    locked = {path[-1].node_id}
    cands = s.evict_candidates(locked=lambda n: n.node_id in locked)
    assert cands == []                          # leaf locked, parent interior
    assert s.over_capacity() == 0
    s.extend(s.chunks(_tok([1, 9])))            # now over capacity
    assert s.over_capacity() == 1
    cands = s.evict_candidates(locked=lambda n: n.node_id in locked)
    assert [n.chunk for n in cands] == [(9, 9, 9, 9)]


def test_lru_touch_on_match():
    s = PrefixStore(8, page_tokens=4)
    pa, _ = s.extend(s.chunks(_tok([1, 2])))
    pb, _ = s.extend(s.chunks(_tok([3, 4])))
    s.match(s.chunks(_tok([1, 2])))             # touch path A
    assert s.evict_candidates()[0] is pb[-1]    # B's leaf is now LRU


def test_store_ops_match_jax_store():
    """A seeded sequence of extend / match / capacity eviction driven
    through both stores: the same paths, node ids, LRU order and counters."""
    rng = np.random.default_rng(0)
    ts, js = PrefixStore(6, page_tokens=4), JPrefixStore(6, page_tokens=4)
    desc = lambda path: [(n.node_id, n.depth, n.chunk) for n in path]
    for _ in range(300):
        vals = list(rng.integers(0, 4, int(rng.integers(1, 5))))
        toks = _tok(vals)
        op = rng.integers(0, 3)
        if op == 0:
            (tp, tc), (jp, jc) = ts.extend(ts.chunks(toks)), \
                js.extend(js.chunks(toks))
            assert desc(tp) == desc(jp) and desc(tc) == desc(jc)
        elif op == 1:
            assert desc(ts.match(ts.chunks(toks))) == \
                desc(js.match(js.chunks(toks)))
        else:
            lock = int(rng.integers(0, 8))
            while ts.over_capacity() > 0:
                tcand = ts.evict_candidates(lambda n: n.node_id % 8 == lock)
                jcand = js.evict_candidates(lambda n: n.node_id % 8 == lock)
                assert desc(tcand) == desc(jcand)
                if not tcand:
                    break
                ts.remove(tcand[0])
                js.remove(jcand[0])
        assert desc(ts.lru_nodes()) == desc(js.lru_nodes())
    assert (ts.inserts, ts.evictions) == (js.inserts, js.evictions)


if HAVE_HYPOTHESIS:
    _page_vals = st.lists(st.integers(0, 3), min_size=1, max_size=5)

    @settings(max_examples=60, deadline=None)
    @given(st.lists(_page_vals, min_size=1, max_size=12))
    def test_prop_match_is_longest_stored_prefix(seqs):
        s = PrefixStore(capacity_pages=1000, page_tokens=4)
        inserted = set()
        for vals in seqs:
            s.extend(s.chunks(_tok(vals)))
            for i in range(1, len(vals) + 1):
                inserted.add(tuple(vals[:i]))
        for vals in seqs:
            probe = vals + [7]                  # diverge past the stored path
            path = s.match(s.chunks(_tok(probe)))
            expect = 0
            for i in range(1, len(probe) + 1):
                if tuple(probe[:i]) not in inserted:
                    break
                expect += 1
            assert len(path) == expect
            assert [n.depth for n in path] == list(range(1, expect + 1))

    @settings(max_examples=60, deadline=None)
    @given(st.lists(_page_vals, min_size=1, max_size=12),
           st.integers(1, 6))
    def test_prop_eviction_respects_capacity_locks_and_leaves(seqs, cap):
        s = PrefixStore(capacity_pages=cap, page_tokens=4)
        for vals in seqs:
            s.extend(s.chunks(_tok(vals)))
        locked_ids = {n.node_id for n in s.nodes()[::3]}   # every 3rd locked
        locked = lambda n: n.node_id in locked_ids
        while s.over_capacity() > 0:
            cands = s.evict_candidates(locked=locked)
            if not cands:
                break
            s.remove(cands[0])
        live = {n.node_id for n in s.nodes()}
        assert locked_ids <= live
        if s.over_capacity() > 0:
            assert all(locked(n) for n in s.evict_candidates())
        for n in s.nodes():
            if n.parent is not None:
                assert n.parent.node_id in live
                assert n.parent.children[n.chunk] is n
else:
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_prop_match_is_longest_stored_prefix():
        pass

    @pytest.mark.skip(reason="hypothesis not installed")
    def test_prop_eviction_respects_capacity_locks_and_leaves():
        pass


# ---------------------------------------------------------------------------
# tier moves: bitwise round trips with the JAX layout's units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["fp32", "mx8"])
def test_tier_moves_round_trip_bitwise(fmt):
    """Random pool contents (every dtype, MX8 payloads included): pages and
    a slab row out to the host and back into other ids, byte for byte; the
    units have the JAX layout's dtypes and bytes."""
    jcfg = j_smoke("zamba2-2.7b").with_(state_quant=JOPS.StateQuantConfig(
        fmt, "stochastic", "jnp"))
    tcfg = t_smoke("zamba2-2.7b").with_(state_quant=TOPS.StateQuantConfig(
        fmt, "stochastic", "torch"))
    pool = TieredStatePool(tcfg, n_pages=6, n_slabs=4, device="cpu")
    g = torch.Generator().manual_seed(0)
    for p in pool.pools:                     # random bytes, every dtype
        b = p.view(torch.uint8)
        b.copy_(torch.randint(0, 256, b.shape, generator=g,
                              dtype=torch.uint8))
    before = [p.clone() for p in pool.pools]
    ids = torch.tensor([2, 4])
    pages = pool.paging.extract_pages(pool.pools, ids)
    slab = pool.paging.extract_slab(pool.pools, 1)
    jpool = JPool(jcfg, n_pages=6, n_slabs=4)
    jpages = jpool.paging.extract_pages(jpool.pools, jnp.asarray([2, 4]))
    jslab = jpool.paging.extract_slab(jpool.pools, jnp.int32(1))
    # the same units: the JAX extract puts a page's 128 tokens ahead of
    # its layer axis, the port keeps the pool's (G, 128, ...) order
    for t, j in zip(pages + slab, jpages + jslab):
        assert sorted(t.shape) == sorted(j.shape)
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        assert t.numel() * t.element_size() == j.nbytes
    assert sum(t.numel() * t.element_size() for t in pages) == \
        2 * pool.page_nbytes
    assert sum(t.numel() * t.element_size() for t in slab) == pool.slab_nbytes
    pool.paging.insert_pages(pool.pools, pages, torch.tensor([3, 5]))
    pool.paging.insert_slab(pool.pools, slab, 3)
    for p, b, spec in zip(pool.pools, before, pool.paging.specs):
        p, b = p.view(torch.uint8), b.view(torch.uint8)
        if spec.kind == "page":
            assert torch.equal(p[[3, 5]], b[[2, 4]])
            assert torch.equal(p[[0, 1, 2, 4]], b[[0, 1, 2, 4]])
        else:
            assert torch.equal(p[3], b[1])
            assert torch.equal(p[[0, 1, 2]], b[[0, 1, 2]])


# ---------------------------------------------------------------------------
# engine level against the JAX paged engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zamba():
    return _pair("zamba2-2.7b")


@pytest.fixture(scope="module")
def llama():
    return _pair("llama3.2-1b")


@pytest.fixture(scope="module")
def gla():
    return _pair("gla-2.7b")


def _both(pair, **kw):
    jcfg, tcfg, jparams, tparams = pair
    return (JEngine(jparams, jcfg, JServeConfig(**kw)),
            Engine(tparams, tcfg, ServeConfig(**kw)))


def test_tier_stats_match_jax_with_preemption(zamba):
    """The workload of ``test_greedy_streams_match_jax_with_preemption``
    at both engines' default ``prefetch_window``: FCFS preempts through
    the headroom check; the spill's demote bytes, the resume's promote
    bytes and tier miss, and the drained host tier equal the JAX engine's
    (the port reported zeros for all ten keys before its tiered pool)."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, n) for n in (120, 118, 121, 100)]
    jeng, teng = _both(zamba, batch=3, n_pages=5, prefill_chunk=128)
    jh = [jeng.submit(p, max_new_tokens=12) for p in prompts]
    th = [teng.submit(p, max_new_tokens=12) for p in prompts]
    jeng.run()
    teng.run()
    assert [(h.status, h.output) for h in th] == \
        [(h.status, h.output) for h in jh]
    st = _tier_equal(jeng, teng)
    assert teng.stats()["preemptions"] == jeng.stats()["preemptions"] >= 1
    assert st["demote_bytes"] > 0 and st["promote_bytes"] > 0
    assert st["tier_misses"] >= 1 and st["host_bytes"] == 0.0


def _preempt_run(eng, prompt_b, prompt_a):
    """Long request B preempted by urgent A at batch 1: B spills to the
    host tier, is staged back by a prefetch while A decodes, commits."""
    hb = eng.submit(prompt_b, max_new_tokens=8, priority=5)
    while hb.status == "queued" and eng.step():
        pass
    assert hb.status == "running"
    ha = eng.submit(prompt_a, max_new_tokens=6, priority=0)
    eng.engine._preempt(hb.rid)
    eng.run()
    return ha, hb


def test_prefetch_resume_bit_exact_and_stats_match_jax(llama):
    rng = np.random.default_rng(2)
    prompt_b = rng.integers(0, 512, 140).astype(np.int32)
    prompt_a = rng.integers(0, 512, 8).astype(np.int32)
    kw = dict(batch=1, n_pages=9, n_slabs=5, sampling=_GREEDY,
              scheduler=SchedulerConfig(policy="priority"))
    _, tcfg, _, tparams = llama
    ref = Engine(tparams, tcfg, ServeConfig(**kw)).submit(
        prompt_b, max_new_tokens=8, priority=5).result().output
    jeng, teng = _both(llama, **kw)
    jres = _preempt_run(jeng, prompt_b, prompt_a)
    ha, hb = _preempt_run(teng, prompt_b, prompt_a)
    assert ha.status == hb.status == "done"
    assert hb.output == ref                  # bit-exact through the stage
    assert [h.output for h in (ha, hb)] == [h.output for h in jres]
    st = _tier_equal(jeng, teng)
    assert st["prefetch_commits"] >= 1 and st["tier_hits"] >= 1
    assert st["demote_bytes"] > 0 and st["promote_bytes"] > 0
    pool = teng.engine.pool
    assert pool.host.pinned_bytes == 0
    assert pool.prefetch_begun == pool.prefetch_commits + \
        pool.prefetch_cancels


def test_prefetch_cancel_on_abort_returns_staging_pages(llama):
    """An abort racing a staged prefetch cancels it: the staging pages and
    slab return, the host pin drops, and the teardown check is clean (with
    the stage in flight it raises PL255)."""
    _, tcfg, _, tparams = llama
    rng = np.random.default_rng(3)
    eng = Engine(tparams, tcfg, ServeConfig(
        batch=1, n_pages=9, n_slabs=5, sampling=_GREEDY,
        scheduler=SchedulerConfig(policy="priority")))
    hb = eng.submit(rng.integers(0, 512, 20), max_new_tokens=8, priority=5)
    while hb.status == "queued" and eng.step():
        pass
    ha = eng.submit(rng.integers(0, 512, 8), max_new_tokens=4, priority=0)
    eng.engine._preempt(hb.rid)
    pool = eng.engine.pool
    free0 = pool.free_pages
    eng.step()                               # stages B's prefetch
    assert pool.prefetch_ready(hb.rid) and pool.host.pinned_bytes > 0
    with pytest.raises(SanitizerError, match="^PL255"):
        pool.sanitizer_check_leaks("mid-flight check")
    hb.abort()
    assert hb.status == "aborted"
    assert not pool.prefetch_ready(hb.rid) and pool.prefetch_cancels == 1
    ha.result()
    assert ha.status == "done"
    assert pool.host.pinned_bytes == 0
    assert pool.free_pages >= free0
    pool.sanitizer_check_leaks("post-abort")


def test_store_demote_falls_back_to_evict_when_budget_full(llama):
    _, tcfg, _, tparams = llama
    prompt = np.random.default_rng(0).integers(0, 512, 140)
    eng = Engine(tparams, tcfg, ServeConfig(
        batch=2, n_pages=17, n_slabs=5, sampling=_GREEDY,
        prefix_cache=True, prefix_store_pages=4, host_tier_bytes=0))
    eng.submit(prompt, max_new_tokens=3)
    eng.run()
    pool = eng.engine.pool
    before = pool.store.n_pages
    assert before >= 1
    # budget 0: demote has no host room -> leaf nodes evict instead
    assert pool.demote_all() == 0
    assert pool.store.n_pages < before
    assert pool.host.cached_bytes == 0.0      # eviction drained the ledger


def _serve(eng, prompts, max_new=5):
    hs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run()
    return [(h.status, h.output) for h in hs]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b", "gla-2.7b"])
def test_store_hits_warm_and_cold_match_jax(arch, llama, zamba, gla):
    """Two requests behind one 128-token system prompt (the second a warm
    hit), then every stored page demoted to the host tier and a third
    request on the prefix (a cold hit: promoted, checksum-verified): the
    greedy streams equal the JAX engine's and the same requests served
    without the cache, and the tier keys equal the JAX engine's after
    each half.  gla-2.7b holds no KV: its hit is the state snapshot."""
    pair = {"llama3.2-1b": llama, "zamba2-2.7b": zamba, "gla-2.7b": gla}[arch]
    rng = np.random.default_rng(0)
    sysp = rng.integers(0, 512, PAGE_TOKENS)
    prompts = [np.concatenate([sysp, rng.integers(0, 512, 10)])
               for _ in range(3)]
    kw = dict(batch=2, n_pages=17, n_slabs=5, sampling=_GREEDY,
              prefix_store_pages=8)
    _, tcfg, _, tparams = pair
    plain = Engine(tparams, tcfg, ServeConfig(**kw))
    refs = _serve(plain, prompts)
    jeng, teng = _both(pair, prefix_cache=True, **kw)
    assert _serve(teng, prompts[:2]) == _serve(jeng, prompts[:2]) == refs[:2]
    st = _tier_equal(jeng, teng)
    assert st["prefix_hits"] == 1 and st["prefix_hit_tokens"] == PAGE_TOKENS
    assert teng.stats()["prefill_tokens"] < plain.stats()["prefill_tokens"]
    pool = teng.engine.pool
    assert pool.demote_all() == jeng.engine.pool.demote_all() >= 1
    assert all(not n.resident for n in pool.store.nodes())
    assert _serve(teng, prompts[2:]) == _serve(jeng, prompts[2:]) == refs[2:]
    st = _tier_equal(jeng, teng)
    assert st["prefix_hits"] == 2
    assert (st["promote_bytes"] > 0) == (pool.page_nbytes > 0)
    assert pool.page_nbytes > 0 or arch == "gla-2.7b"


def test_store_hit_prefill_token_accounting(llama):
    _, tcfg, _, tparams = llama
    prompt = np.random.default_rng(1).integers(0, 512, 150)
    eng = Engine(tparams, tcfg, ServeConfig(
        batch=2, n_pages=17, n_slabs=5, sampling=_GREEDY,
        prefix_cache=True, prefix_store_pages=8))
    (s0, o0), (s1, o1) = _serve(eng, [prompt, prompt.copy()])
    st = eng.stats()
    assert o0 == o1
    # request 0 ingests all 150; request 1 only the 22-token un-cached tail
    assert st["prefill_tokens"] == 150 + (150 - PAGE_TOKENS)
    assert st["prefix_hit_tokens"] == PAGE_TOKENS
