"""The port's paged serving against the JAX package's, and against itself.

* ``decode_mode="paged"`` logits bit-identical to the port's dense-gather
  reference path over the same pool, across the page boundary (lengths 127,
  128, 129), for the three archs of the port (mirrors
  ``tests/test_paged_decode.py``);
* the fp32 pools after a prefill and two decode steps equal the JAX
  ``PagedStatePool``'s array for array: same spec order, shapes and dtypes,
  values to the model-level tolerance (rtol 1e-4, atol 1e-4 * max|pool|:
  both sides compute in fp32 but accumulate in other orders);
* greedy fp32 token streams identical to the JAX paged ``Engine`` (with
  ``prefetch_window=0``, so both make the same admission decisions) over
  mixed prompts longer than ``prefill_chunk``, a pool small enough to
  preempt, and a ``fork`` / ``Session`` turn; ``stats()`` has the JAX
  paged engine's key set;
* placement and scheduler units with the shadow ledger on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as JOPS
from repro.configs import get_smoke_config as j_smoke
from repro.models import model as JM
from repro.serving.api import Engine as JEngine
from repro.serving.api import ServeConfig as JServeConfig
from repro.serving.memory import PagedStatePool as JPool
from repro_torch import ops as TOPS
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.paged import PAGE_TOKENS, pages_for
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.api import Engine, ServeConfig
from repro_torch.serving.memory import (BankAwarePlacement, BankTopology,
                                        PagedStatePool)
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig

ARCHS = ("llama3.2-1b", "mamba2-2.7b", "zamba2-2.7b", "deepseek-v2-236b",
         "gla-2.7b", "retnet-2.7b", "hgrn2-2.7b")


def _pair(arch, fmt="fp32"):
    jb, tb = ("jnp", "torch") if fmt != "mx8" else ("jnp", "cuda")
    jcfg = j_smoke(arch).with_(state_quant=JOPS.StateQuantConfig(
        fmt, "stochastic", jb))
    tcfg = t_smoke(arch).with_(state_quant=TOPS.StateQuantConfig(
        fmt, "stochastic", tb))
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def zamba_fp32():
    return _pair("zamba2-2.7b")


# ---------------------------------------------------------------------------
# paged decode == dense-gather decode, bitwise
# ---------------------------------------------------------------------------

def _prefill_pool(params, cfg, prompt_len, n_pages=8, n_slabs=5):
    pool = PagedStatePool(cfg, n_pages=n_pages, n_slabs=n_slabs,
                          device="cpu")
    prompt = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab_size, prompt_len)
    logits, row = TM.prefill(params, cfg,
                             {"tokens": torch.as_tensor(prompt)[None]})
    assert pool.register(1, pages_for(prompt_len))
    pool.insert_prefill(1, row)
    return pool, int(logits[0].argmax())


def _decode_steps(pool, params, tok, length, n_steps):
    """Greedy steps over a two-row batch (row 1 idle), growing the block
    table over page boundaries as the engine's headroom check does."""
    outs, L, t = [], np.array([length, 0], np.int32), tok
    for step in range(n_steps):
        while L[0] // PAGE_TOKENS + 1 > len(pool.page_table[1]):
            assert pool.grow(1, 1)
        lg = pool.decode(params, [1, None], np.array([t, 0], np.int32), L,
                         seed=step + 1)
        outs.append(lg.clone())
        t = int(lg[0].argmax())
        L[0] += 1
    return outs


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("length", [127, 128, 129])
def test_paged_decode_bit_identical_to_dense_gather(arch, length):
    """MX8 with the ``cuda`` backend requested: on CPU tensors every kernel
    wrapper takes its plain version, on both paths."""
    cfg = t_smoke(arch)
    assert cfg.state_quant.fmt == "mx8"
    params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    pool, tok = _prefill_pool(params, cfg, length)
    snapshot = [p.clone() for p in pool.pools]
    pages0 = list(pool.page_table[1])

    pool.decode_mode = "gather"
    ref = _decode_steps(pool, params, tok, length, n_steps=2)
    after_gather = [p.clone() for p in pool.pools]

    for p, s in zip(pool.pools, snapshot):
        p.copy_(s)
    grown = [p for p in pool.page_table[1] if p not in pages0]
    if grown:
        pool.placement.unref(grown)
    pool.page_table[1] = list(pages0)
    pool.decode_mode = "paged"
    got = _decode_steps(pool, params, tok, length, n_steps=2)

    for step, (a, b) in enumerate(zip(ref, got)):
        assert torch.equal(a, b), f"{arch} L={length} step {step}"
    if not grown:     # same pages both runs: the pools must agree too
        for a, b in zip(after_gather, pool.pools):
            assert torch.equal(a[1:], b[1:])      # scratch page/slab aside


# ---------------------------------------------------------------------------
# pools array for array against the JAX PagedStatePool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["zamba2-2.7b", "llama3.2-1b"])
def test_fp32_pools_match_jax_pool_after_prefill_and_decode(arch):
    jcfg, tcfg, jparams, tparams = _pair(arch)
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size, 131)
    jpool = JPool(jcfg, n_pages=6, n_slabs=3)
    tpool = PagedStatePool(tcfg, n_pages=6, n_slabs=3, device="cpu")
    assert [tuple(p.shape) for p in tpool.pools] == \
        [tuple(p.shape) for p in jpool.pools]
    assert [str(p.dtype).split(".")[-1] for p in tpool.pools] == \
        [str(p.dtype) for p in jpool.pools]
    pr = jnp.asarray(prompt, jnp.int32)[None]
    jl, jrow = jax.jit(lambda p, b: JM.prefill(p, jcfg, b))(
        jparams, {"tokens": pr, "targets": pr})
    tl, trow = TM.prefill(tparams, tcfg,
                          {"tokens": torch.as_tensor(prompt)[None]})
    for pool, row in ((jpool, jrow), (tpool, trow)):
        assert pool.register(1, pages_for(131))
        pool.insert_prefill(1, row)
        assert pool.grow(1, 1)
    assert jpool.page_table == tpool.page_table
    assert jpool.slab_of == tpool.slab_of
    jt, tt = int(jnp.argmax(jl[0])), int(tl[0].argmax())
    assert jt == tt
    for step in range(2):
        L = np.array([131 + step, 0], np.int32)
        jl = jpool.decode(jparams, [1, None], np.array([jt, 0], np.int32),
                          L, seed=step + 1)
        tl = tpool.decode(tparams, [1, None], np.array([tt, 0], np.int32),
                          L, seed=step + 1)
        jt, tt = int(jnp.argmax(jl[0])), int(tl[0].argmax())
        assert jt == tt
    for i, (a, b) in enumerate(zip(jpool.pools, tpool.pools)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(a).max(), 1e-30),
                                   err_msg=f"pool {i}")


# ---------------------------------------------------------------------------
# greedy streams against the JAX paged Engine
# ---------------------------------------------------------------------------

def _engines(pair, **kw):
    jcfg, tcfg, jparams, tparams = pair
    jeng = JEngine(jparams, jcfg, JServeConfig(prefetch_window=0, **kw))
    teng = Engine(tparams, tcfg, ServeConfig(**kw))
    assert teng.backend == jeng.backend == "paged"
    return jeng, teng


def _same_streams(jeng, teng, prompts, max_new):
    jh = [jeng.submit(p, max_new_tokens=max_new) for p in prompts]
    th = [teng.submit(p, max_new_tokens=max_new) for p in prompts]
    jeng.run()
    teng.run()
    for a, b in zip(jh, th):
        assert (a.status, a.output) == (b.status, b.output), a.rid
    return jh, th


def test_greedy_streams_match_jax_mixed_prompts_chunked(zamba_fp32):
    """Prompts past ``prefill_chunk`` stream their tails through decode."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, n) for n in (150, 9, 70, 133, 20)]
    jeng, teng = _engines(zamba_fp32, batch=3, n_pages=12,
                          prefill_chunk=64)
    _same_streams(jeng, teng, prompts, max_new=5)
    js, ts = jeng.stats(), teng.stats()
    assert set(js) == set(ts)
    for k in ("tokens", "prefill_tokens", "requests_done", "preemptions",
              "pages_allocated", "gather_bytes"):
        assert ts[k] == js[k], k
    for k in js:
        if k.startswith("op_traffic_bytes/"):
            assert ts[k] == pytest.approx(js[k], rel=1e-12), k


@pytest.mark.parametrize("arch", ["gla-2.7b", "retnet-2.7b", "hgrn2-2.7b"])
def test_pure_ssm_greedy_streams_match_jax(arch):
    """The GLA family holds no KV: the paged engine admits it with state
    slabs only (0 page bytes) and streams prompts past ``prefill_chunk``
    through decode as the JAX engine does."""
    pair = _pair(arch)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, n) for n in (150, 9, 70, 20)]
    jeng, teng = _engines(pair, batch=3, n_pages=4, prefill_chunk=64)
    _same_streams(jeng, teng, prompts, max_new=5)
    js, ts = jeng.stats(), teng.stats()
    for k in ("tokens", "prefill_tokens", "requests_done", "preemptions",
              "pages_allocated", "gather_bytes"):
        assert ts[k] == js[k], k
    pool = teng.engine.pool
    assert pool.page_nbytes == 0 and pool.slab_nbytes > 0


def test_greedy_streams_match_jax_with_preemption(zamba_fp32):
    """A pool of 4 usable pages under four 120-token requests that each
    grow a second page: FCFS preempts through the headroom check, spills
    and resumes bit-exactly."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, n) for n in (120, 118, 121, 100)]
    jeng, teng = _engines(zamba_fp32, batch=3, n_pages=5, prefill_chunk=128)
    _same_streams(jeng, teng, prompts, max_new=12)
    assert teng.stats()["preemptions"] == jeng.stats()["preemptions"] >= 1
    assert teng.engine.pool.free_pages == teng.engine.pool.usable_pages


def test_greedy_streams_match_jax_fork_and_session(zamba_fp32):
    jeng, teng = _engines(zamba_fp32, batch=2, n_pages=8, prefill_chunk=128)
    rng = np.random.default_rng(9)
    first = rng.integers(0, 512, 140)
    turn2 = rng.integers(0, 512, 6)
    outs = []
    for eng in (jeng, teng):
        chat = eng.session()
        a = chat.send(first, max_new_tokens=4).result()
        b = chat.send(turn2, max_new_tokens=5)
        # a parallel sampled continuation of the second turn's parent
        c = list(chat.send(turn2[:2], max_new_tokens=3))
        chat.close()
        outs.append((a.output, b.output, c))
        st = eng.stats()
        assert st["shared_page_hits"] >= 1
    assert outs[0] == outs[1]
    assert teng.engine.pool.free_pages == teng.engine.pool.usable_pages


def test_stats_schema_matches_jax_paged_engine(zamba_fp32):
    jeng, teng = _engines(zamba_fp32, batch=2)
    js, ts = jeng.stats(), teng.stats()
    assert set(js) == set(ts)
    assert all(v == 0.0 for v in ts.values())


# ---------------------------------------------------------------------------
# the facade: defaults, errors, lifecycle
# ---------------------------------------------------------------------------

def test_serve_config_defaults_to_paged_and_rejects_unknown_backends(
        zamba_fp32):
    assert ServeConfig().backend == JServeConfig().backend == "paged"
    for f in ("batch", "cache_capacity", "n_pages", "n_slabs", "byte_budget",
              "prefill_chunk", "prefill_buckets", "seed"):
        assert getattr(ServeConfig(), f) == getattr(JServeConfig(), f), f
    with pytest.raises(ValueError):
        ServeConfig(backend="gpu")
    _, tcfg, _, tparams = zamba_fp32
    eng = Engine(tparams, tcfg)
    assert eng.backend == "paged" and eng.engine.pool.device.type == "cpu"
    slots = Engine(tparams, tcfg, ServeConfig(backend="slots"))
    with pytest.raises(ValueError, match="paged backend"):
        slots.session()


def test_abort_queued_running_and_spilled(zamba_fp32):
    _, tcfg, _, tparams = zamba_fp32
    eng = Engine(tparams, tcfg, ServeConfig(batch=2, n_pages=3))
    rng = np.random.default_rng(1)
    a = eng.submit(rng.integers(0, 512, 120), max_new_tokens=30)
    b = eng.submit(rng.integers(0, 512, 120), max_new_tokens=30)
    c = eng.submit(rng.integers(0, 512, 8), max_new_tokens=3)
    spilled = None
    for _ in range(40):
        eng.step()
        if eng.engine.spilled:
            spilled = next(iter(eng.engine.spilled))
            break
    assert spilled is not None, "the 2-page pool should have preempted"
    assert eng.abort(spilled)
    assert c.abort() and c.status == "aborted"
    for h in (a, b):
        if not h.finished:
            assert h.abort()
    assert not eng.has_work()
    pool = eng.engine.pool
    assert pool.free_pages == pool.usable_pages
    assert pool.free_slabs == pool.n_slabs - 1


def test_prefill_buckets_and_rejected_oversize(zamba_fp32):
    _, tcfg, _, tparams = zamba_fp32
    eng = Engine(tparams, tcfg, ServeConfig(batch=2, n_pages=3,
                                            prefill_buckets=(16, 64)))
    rng = np.random.default_rng(3)
    ok = eng.submit(rng.integers(0, 512, 40), max_new_tokens=3)
    big = eng.submit(rng.integers(0, 512, 600), max_new_tokens=2)
    eng.run()
    assert ok.status == "done" and len(ok.output) == 3
    assert big.status == "truncated"
    assert eng.stats()["prefill_tokens"] == 640.0


# ---------------------------------------------------------------------------
# placement / scheduler units (shadow ledger on: tests/conftest.py)
# ---------------------------------------------------------------------------

def test_placement_spreads_and_refcounts_with_shadow_ledger():
    from repro_torch.analysis.lint.runtime import SanitizerError
    pl = BankAwarePlacement(17, BankTopology(4, 2))
    assert pl._shadow is not None
    pages = pl.alloc(8)
    coords = {pl.topo.coord(p) for p in pages}
    assert len(coords) == 8 and 0 not in pages
    assert pl.imbalance() == 1.0
    pl.ref(pages[:3])
    assert pl.n_shared_extra == 3
    assert pl.unref(pages) == pages[3:]
    assert pl.unref(pages[:3]) == pages[:3]
    assert pl.n_free == 16 and pl.shared_extra_peak == 3
    with pytest.raises(SanitizerError, match="^PL251"):
        pl.unref(pages[:1])
    assert pl.alloc(17) is None
    m = pl.traffic_map([pl.alloc(2)], bursts_per_page=5.0)
    assert m.sum() == 10.0


def test_scheduler_policies_and_lazy_removal():
    from repro_torch.serving.engine import Request

    def req(rid, **kw):
        return Request(rid=rid, prompt=np.zeros(1, np.int32),
                       t_submit=float(rid), **kw)

    s = Scheduler(SchedulerConfig("priority"))
    for r in (req(0, priority=2), req(1, priority=0), req(2, priority=1)):
        s.push(r)
    assert s.peek().rid == 1 and len(s) == 3
    assert s.remove(1).rid == 1 and s.remove(1) is None
    assert [s.pop().rid, s.pop().rid] == [2, 0] and not s
    running = [req(3, priority=5), req(4, priority=0)]
    assert s.choose_victim(running).rid == 3
    assert s.should_preempt(req(5, priority=1), running[0])
    fcfs = Scheduler(SchedulerConfig("fcfs"))
    assert not fcfs.should_preempt(req(6), running[0])
    edf = Scheduler(SchedulerConfig("deadline"))
    edf.push(req(7, deadline=9.0))
    edf.push(req(8, deadline=3.0))
    edf.push(req(9), resumed=True)
    assert [edf.pop().rid for _ in range(3)] == [8, 7, 9]


def test_launcher_serves_paged_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "zamba2-2.7b", "--smoke-size", "--device",
                       "cpu", "--paged", "--pages", "4", "--requests", "3",
                       "--max-new", "3", "--state-format", "fp32",
                       "--prefill-chunk", "64", "--policy", "priority"]) == 0
    out = capsys.readouterr().out
    assert "pool=paged" in out and "preemptions=" in out
