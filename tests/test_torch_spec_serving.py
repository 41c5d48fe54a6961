"""Speculative serving in the port: greedy exactness, bit-exact rollback,
draft sources, acceptance accounting and mid-speculation teardown -- the
port's twin of ``tests/test_spec.py``, plus parity with the JAX package.

* pool level: ``decode_spec`` position i's logits equal the i-th sequential
  paged decode step's, and ``commit_spec`` restores the slab rows of
  exactly the selected position (all-accept = n sequential steps, sel = 0
  = one step), bitwise;
* engine level: with speculation on (``ngram`` and ``model:llama3.2-1b``)
  the greedy stream equals the non-speculative paged stream, for
  llama3.2-1b, mamba2-2.7b and zamba2-2.7b smoke at fp32 and MX8
  (nearest rounding, so the SR seeds of the two runs do not enter);
* across packages: the port's greedy speculative stream equals the JAX
  package's at fp32 with the same weights, and ``NGramDraft`` /
  ``KController`` decide as JAX's do.
"""
import jax
import numpy as np
import pytest
import torch

from repro import ops as JOPS
from repro.configs import get_smoke_config as j_smoke
from repro.models import model as JM
from repro.serving.api import Engine as JEngine
from repro.serving.api import ServeConfig as JServeConfig
from repro.serving.spec import KController as JKController
from repro.serving.spec import NGramDraft as JNGramDraft
from repro_torch import ops as TOPS
from repro_torch.configs import get_smoke_config
from repro_torch.core.paged import PAGE_TOKENS, pages_for
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import per_position
from repro_torch.serving.api import Engine, ServeConfig
from repro_torch.serving.engine import (PagedEngineConfig,
                                        PagedServingEngine, Request)
from repro_torch.serving.memory import PagedStatePool
from repro_torch.serving.sampler import SamplingConfig
from repro_torch.serving.spec import KController, ModelDraft, NGramDraft

torch.set_num_threads(1)  # test workers share the cores: one thread each

_CACHE = {}


def _build(arch, fmt="fp32", backend="torch", ffn_kind=None):
    key = (arch, fmt, backend, ffn_kind)
    if key not in _CACHE:
        cfg = get_smoke_config(arch).with_(state_quant=TOPS.StateQuantConfig(
            fmt, "nearest", backend))
        if ffn_kind is not None:
            cfg = cfg.with_(ffn_kind=ffn_kind)
        _CACHE[key] = (M.init_model(cfg, torch.Generator().manual_seed(0),
                                    device="cpu"), cfg)
    return _CACHE[key]


def _serve(params, cfg, prompts, spec, max_new=5, spec_k=3, **kw):
    eng = PagedServingEngine(params, cfg, PagedEngineConfig(
        max_decode_batch=2, n_pages=17, n_slabs=5, prefill_chunk=128,
        spec=spec, spec_k=spec_k, **kw))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=max_new))
    done = eng.run()
    return eng, {r.rid: list(r.output) for r in done}


def _prompts(cfg, seed=3):
    """A repeating prompt, a short random one, and a random one past
    ``prefill_chunk`` whose tail streams through the verify step's
    garbage-padded rows (its 140 tokens give the n-gram source earlier
    occurrences of most tokens the model emits)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, cfg.vocab_size, 5)
    return [np.tile(base, 3).astype(np.int32),
            rng.integers(0, cfg.vocab_size, 9).astype(np.int32),
            rng.integers(0, cfg.vocab_size, 140).astype(np.int32)]


# ---------------------------------------------------------------------------
# pool level: verify positions and bit-exact rollback
# ---------------------------------------------------------------------------

def _verify_case(arch, length, fmt, batch=2, n=3, ffn_kind=None):
    """One case of the test below; the first four keep their old ids."""
    tag = f"{arch}-{length}-{fmt}"
    if (batch, n) != (2, 3):
        tag += f"-b{batch}-n{n}"
    if ffn_kind is not None:
        tag += f"-{ffn_kind}"
    return pytest.param(arch, length, fmt, batch, n, ffn_kind, id=tag)


@pytest.mark.parametrize("arch,length,fmt,batch,n,ffn_kind", [
    _verify_case("mamba2-2.7b", 127, "fp32"),
    _verify_case("zamba2-2.7b", 128, "fp32"),
    _verify_case("zamba2-2.7b", 126, "mx8"),
    _verify_case("gla-2.7b", 129, "mx8"),
    # xLSTM: the sLSTM's four carries and the mLSTM's conv tail are plain
    # slab leaves, snapshotted and rolled back with the state
    _verify_case("xlstm-1.3b", 9, "mx8"),
    # spec_k = 3 (n = 4): batch 4 is the card's served shape (cuBLAS rounds
    # rows of 16 unlike rows of 4); MKL's fp32 GEMM can keep rows of 16
    # like rows of 4 and yet round rows of 12 unlike rows of 3, so the
    # attention-only and MLA cases run at batch 3
    _verify_case("zamba2-2.7b", 127, "fp32", 4, 4),
    _verify_case("llama3.2-1b", 130, "fp32", 3, 4),
    # MLA with dense FFNs only: deepseek's MoE layers given its prelude's
    # SwiGLU (MoE's expert products run at the verify step's capacity, so
    # they are not held bitwise)
    _verify_case("deepseek-v2-236b", 125, "fp32", 3, 4, ffn_kind="swiglu"),
])
def test_spec_verify_positions_and_rollback_bit_exact(arch, length, fmt,
                                                      batch, n, ffn_kind):
    """decode_spec position i's logits == the i-th sequential decode step,
    and commit_spec restores the state slab of exactly the selected
    position: all-accept equals n sequential steps, sel=0 equals one.  MX8
    runs stochastic rounding with the kernels' plain versions: the
    per-position seeds seed + i are the sequential steps' seeds.  Row 0
    holds the request, the other ``batch - 1`` rows are idle, so every
    dense product of the verify pass runs at ``batch * n`` rows."""
    params, cfg = _build(arch, fmt, "cuda" if fmt == "mx8" else "torch",
                         ffn_kind)
    if fmt == "mx8":
        cfg = cfg.with_(state_quant=TOPS.StateQuantConfig(
            "mx8", "stochastic", "cuda"))
    pool = PagedStatePool(cfg, n_pages=10, n_slabs=5, device="cpu")
    rng = np.random.default_rng(length)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, length))[None]
    logits, row = M.prefill(params, cfg, {"tokens": prompt})
    assert pool.register(1, pages_for(length))
    pool.insert_prefill(1, row)
    tok = int(logits[0].argmax())
    snapshot = [p.clone() for p in pool.pools]
    pages0 = list(pool.page_table[1])
    rows = [1] + [None] * (batch - 1)
    idle = [0] * (batch - 1)

    def slab_rows():
        s = pool.slab_of[1]
        return [p[s].clone() for p, spec in zip(pool.pools, pool.paging.specs)
                if spec.kind == "slab"]

    def rewind(span):
        grown = [p for p in pool.page_table[1] if p not in pages0]
        if grown:
            pool.placement.unref(grown)
        pool.page_table[1] = list(pages0)
        for p, s in zip(pool.pools, snapshot):
            p.copy_(s)
        while pages_for(length + span) > len(pool.page_table[1]):
            assert pool.grow(1, 1)

    # sequential reference: n steps, seeds 1..n
    seq_logits, toks = [], [tok]
    L = np.array([length] + idle, np.int32)
    for step in range(n):
        while L[0] // PAGE_TOKENS + 1 > len(pool.page_table[1]):
            assert pool.grow(1, 1)
        lg = pool.decode(params, rows, np.array([toks[-1]] + idle), L,
                         seed=step + 1)
        seq_logits.append(lg.clone())
        toks.append(int(lg[0].argmax()))
        L[0] += 1
    seq_slabs = slab_rows()

    # one verify pass over the same n tokens at seed 1
    rewind(n)
    tokens = np.array([toks[:n]] + [[0] * n] * (batch - 1))
    lengths = np.array([length] + idle, np.int32)
    lg, snaps = pool.decode_spec(params, rows, tokens, lengths, seed=1,
                                 min_pages=pages_for(length + n))
    assert lg.shape == (batch, n, cfg.vocab_size)
    for i in range(n):
        assert torch.equal(lg[:1, i], seq_logits[i][:1]), f"position {i}"
    pool.commit_spec(rows, snaps, np.array([n - 1] + idle))
    for a, b in zip(slab_rows(), seq_slabs):
        assert torch.equal(a, b)

    # rollback to position 0: slab rows == exactly one sequential step
    rewind(n)
    _, snaps2 = pool.decode_spec(params, rows, tokens, lengths, seed=1,
                                 min_pages=pages_for(length + n))
    pool.commit_spec(rows, snaps2, np.array([0] + idle))
    rolled = slab_rows()
    rewind(1)
    pool.decode(params, rows, np.array([toks[0]] + idle),
                np.array([length] + idle, np.int32), seed=1)
    for a, b in zip(rolled, slab_rows()):
        assert torch.equal(a, b)


def test_per_position_is_the_plain_steps_product():
    """Position i of a per-position (4, 4, d) product is bitwise the
    contiguous (4, 1, d) product a plain decode step makes; several inputs
    are sliced alike and tuple results concatenate field by field."""
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal((4, 4, 96), np.float32))
    w = torch.as_tensor(rng.standard_normal((96, 160), np.float32))
    pos = torch.as_tensor(rng.integers(0, 500, (4, 4)))
    out = per_position(lambda t: t @ w, x)
    assert out.shape == (4, 4, 160)
    for i in range(4):
        step = x[:, i].clone()[:, None]              # a fresh (4, 1, d) input
        assert step.is_contiguous()
        assert torch.equal(out[:, i:i + 1], step @ w), f"position {i}"
    prod, shifted = per_position(lambda t, p: (t @ w, p + 1), x, pos)
    assert torch.equal(prod, out) and torch.equal(shifted, pos + 1)


def test_block_table_min_pages_spans_the_verify_positions():
    params, cfg = _build("llama3.2-1b")
    pool = PagedStatePool(cfg, n_pages=9, n_slabs=3, device="cpu")
    assert pool.register(1, 1)
    assert pool.block_table([1, None]).shape == (2, 1)
    bt = pool.block_table([1, None], min_pages=pages_for(127 + 4))
    assert bt.shape == (2, 2) and bt[0, 1] == 0 and bt[1].tolist() == [0, 0]


# ---------------------------------------------------------------------------
# engine level: greedy exactness for both draft sources
# ---------------------------------------------------------------------------

PARITY_MATRIX = [
    ("llama3.2-1b", "fp32", "torch"),
    ("llama3.2-1b", "mx8", "torch"),
    ("mamba2-2.7b", "fp32", "torch"),
    ("mamba2-2.7b", "mx8", "torch"),
    ("zamba2-2.7b", "fp32", "torch"),
    ("zamba2-2.7b", "mx8", "torch"),
    ("gla-2.7b", "mx8", "cuda"),           # cuda on CPU: the plain versions
]


@pytest.mark.parametrize("arch,fmt,backend", PARITY_MATRIX)
def test_spec_ngram_greedy_equals_plain(arch, fmt, backend):
    params, cfg = _build(arch, fmt, backend)
    prompts = _prompts(cfg)
    _, ref = _serve(params, cfg, prompts, spec=None, max_new=8)
    eng, out = _serve(params, cfg, prompts, spec="ngram", max_new=8)
    assert out == ref, (arch, fmt, backend)
    st = eng.stats()
    assert 0 < st["proposed_tokens"] and \
        st["accepted_tokens"] <= st["proposed_tokens"]


# the model-draft source drives the same verify/rollback machinery
MODEL_DRAFT_MATRIX = [
    ("llama3.2-1b", "fp32", "torch"),
    ("llama3.2-1b", "mx8", "cuda"),        # cuda on CPU: the plain versions
    ("mamba2-2.7b", "fp32", "torch"),
    ("zamba2-2.7b", "fp32", "torch"),
]


@pytest.mark.parametrize("arch,fmt,backend", MODEL_DRAFT_MATRIX)
def test_spec_model_draft_greedy_equals_plain(arch, fmt, backend):
    params, cfg = _build(arch, fmt, backend)
    prompts = _prompts(cfg)[:2]
    _, ref = _serve(params, cfg, prompts, spec=None, max_new=4)
    eng, out = _serve(params, cfg, prompts, spec="model:llama3.2-1b",
                      max_new=4)
    assert out == ref, (arch, fmt, backend)
    assert isinstance(eng.draft, ModelDraft)
    assert eng.stats()["proposed_tokens"] > 0


# ---------------------------------------------------------------------------
# across the packages: greedy streams and the host-side deciders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b",
                                  "zamba2-2.7b", "deepseek-v2-236b",
                                  "gla-2.7b"])
def test_greedy_spec_stream_matches_jax(arch):
    jcfg = j_smoke(arch).with_(state_quant=JOPS.StateQuantConfig(
        "fp32", "nearest", "jnp"))
    tcfg = get_smoke_config(arch).with_(state_quant=TOPS.StateQuantConfig(
        "fp32", "nearest", "torch"))
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    prompts = _prompts(tcfg)[:2]
    kw = dict(batch=2, n_pages=17, n_slabs=5, spec="ngram", spec_k=3)
    jeng = JEngine(jparams, jcfg, JServeConfig(prefetch_window=0, **kw))
    teng = Engine(tparams, tcfg, ServeConfig(**kw))
    jh = [jeng.submit(p, max_new_tokens=6) for p in prompts]
    th = [teng.submit(p, max_new_tokens=6) for p in prompts]
    jeng.run()
    teng.run()
    for a, b in zip(jh, th):
        assert (a.status, a.output) == (b.status, b.output), a.rid
    js, ts = jeng.stats(), teng.stats()
    for k in ("proposed_tokens", "accepted_tokens", "acceptance_rate",
              "accepted_tokens_per_step", "tokens"):
        assert ts[k] == js[k], k


def test_ngram_and_kcontroller_decide_as_jax():
    rng = np.random.default_rng(11)
    jd, td = JNGramDraft(), NGramDraft()
    for rid in range(2):
        jd.admit(rid, [])
        td.admit(rid, [])
    for _ in range(200):
        ctx = list(map(int, rng.integers(0, 6, int(rng.integers(1, 30)))))
        k = int(rng.integers(0, 5))
        rid = int(rng.integers(0, 3))             # rid 2 was never admitted
        assert td.propose(rid, ctx, k) == jd.propose(rid, ctx, k), (ctx, k)
    d = NGramDraft()
    d.admit(0, [])
    assert d.propose(0, [1, 2, 3, 9, 1, 2, 3], 2) == [9, 1]
    assert d.propose(0, [5, 6, 7], 3) == []
    d.release(0)
    assert d.propose(0, [1, 2, 3, 9, 1, 2, 3], 2) == []

    jk, tk = JKController(4, window=3), KController(4, window=3)
    for _ in range(300):
        rid = int(rng.integers(0, 3))
        if rng.random() < 0.05:
            jk.forget(rid)
            tk.forget(rid)
            continue
        proposed = int(rng.integers(0, 5))
        accepted = int(rng.integers(0, proposed + 1))
        jk.observe(rid, proposed, accepted)
        tk.observe(rid, proposed, accepted)
        assert tk.k_for(rid) == jk.k_for(rid)
        assert 1 <= tk.k_for(rid) <= 4


def test_model_draft_catchup_and_rollback_counter():
    params, cfg = _build("llama3.2-1b")
    d = ModelDraft(cfg, params, max_requests=2, max_len=512)
    prompt = list(map(int, _prompts(cfg)[1]))
    assert d.admit(1, prompt)
    out1 = d.propose(1, prompt, 3)
    assert len(out1) == 3 and d.consumed[1] == len(prompt)
    # rejected drafts are behind the counter: the next call re-proposes
    # from the verified context and the first draft is reproducible
    assert d.propose(1, prompt, 3) == out1
    assert len(d.propose(1, prompt + out1[:2], 2)) == 2
    d.release(1)
    assert 1 not in d.consumed
    d.sanitizer_check_leaks()
    with pytest.raises(ValueError, match="attention-only"):
        ModelDraft(_build("zamba2-2.7b")[1], device="cpu")


# ---------------------------------------------------------------------------
# accounting, schema, stream order, teardown
# ---------------------------------------------------------------------------

def test_spec_acceptance_accounting_and_stream_order():
    """The acceptance counters' invariants, and an append-only stream:
    tokens surface in emit order and an earlier read is always a prefix of
    a later one (sampled mode too -- rejection sampling with numpy draws
    seeded per step and row)."""
    params, cfg = _build("llama3.2-1b")
    base = np.random.default_rng(7).integers(0, cfg.vocab_size, 8)
    prompt = np.concatenate([base, base, base]).astype(np.int32)
    for temp in (0.0, 0.8):
        eng = Engine(params, cfg, ServeConfig(
            batch=2, n_pages=17, n_slabs=5,
            sampling=SamplingConfig(temperature=temp, top_p=0.9),
            spec="ngram", spec_k=3))
        h = eng.submit(prompt, max_new_tokens=16)
        seen = []
        while eng.step():
            out = h.output
            assert out[:len(seen)] == seen, "token stream reordered"
            seen = out
        assert h.status == "done" and len(h.output) == 16
        st = eng.stats()
        assert 0 <= st["accepted_tokens"] <= st["proposed_tokens"]
        assert 0.0 <= st["acceptance_rate"] <= 1.0
        if st["proposed_tokens"]:
            assert st["accepted_tokens_per_step"] >= 1.0


def test_spec_stats_schema_matches_jax_and_is_zero_when_off():
    params, cfg = _build("llama3.2-1b")
    eng = Engine(params, cfg, ServeConfig(batch=2, n_pages=9))
    eng.submit(_prompts(cfg)[1], max_new_tokens=2)
    eng.run()
    st = eng.stats()
    for key in ("proposed_tokens", "accepted_tokens", "acceptance_rate",
                "accepted_tokens_per_step"):
        assert st[key] == 0.0, key
    jcfg = j_smoke("llama3.2-1b").with_(state_quant=JOPS.StateQuantConfig(
        "fp32", "nearest", "jnp"))
    jeng = JEngine(JM.init_model(jax.random.PRNGKey(0), jcfg), jcfg,
                   JServeConfig(batch=2, spec="ngram"))
    teng = Engine(params, cfg, ServeConfig(batch=2, spec="ngram"))
    assert set(teng.stats()) == set(jeng.stats())


def test_spec_needs_the_paged_backend_and_a_known_source():
    params, cfg = _build("llama3.2-1b")
    with pytest.raises(ValueError, match="paged backend"):
        ServeConfig(backend="slots", spec="ngram")
    with pytest.raises(ValueError, match="unknown spec draft source"):
        Engine(params, cfg, ServeConfig(spec="oracle"))
    with pytest.raises(ValueError, match="spec_k"):
        Engine(params, cfg, ServeConfig(spec="ngram", spec_k=0))


def test_spec_abort_mid_speculation_unwinds_cleanly():
    """Aborting a request mid-speculation frees its target pages and its
    draft-model state; the drained engine passes the shadow-ledger
    teardown for both pools, and the survivor's stream is the plain one."""
    params, cfg = _build("llama3.2-1b")
    prompts = _prompts(cfg)[:2]
    eng = PagedServingEngine(params, cfg, PagedEngineConfig(
        max_decode_batch=2, n_pages=40, n_slabs=5, prefill_chunk=128,
        spec="model:llama3.2-1b", spec_k=3))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=12))
    while not (len(eng.active) == 2
               and all(len(a.req.output) >= 2
                       for a in eng.active.values())):
        assert eng.step()
    assert 0 in eng.draft.consumed
    assert eng.abort(0)
    assert 0 not in eng.draft.consumed
    eng.run()
    done = {r.rid: r for r in eng.done}
    assert done[0].status == "aborted" and done[1].status == "done"
    _, ref = _serve(params, cfg, prompts, spec=None, max_new=12)
    assert list(done[1].output) == ref[1]
    eng.draft.sanitizer_check_leaks()
    assert eng.pool.free_pages == eng.pool.usable_pages


def test_spec_preempt_mid_speculation_stays_bit_exact():
    """Preempting a speculating request spills, resumes and still emits
    the exact greedy stream; no page leaks."""
    params, cfg = _build("zamba2-2.7b")
    prompts = _prompts(cfg)[:2]
    _, ref = _serve(params, cfg, prompts, spec=None, max_new=8)
    eng = PagedServingEngine(params, cfg, PagedEngineConfig(
        max_decode_batch=2, n_pages=17, n_slabs=5, prefill_chunk=128,
        spec="ngram", spec_k=3))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=8))
    while not any(len(a.req.output) >= 2 for a in eng.active.values()):
        assert eng.step()
    rid = next(r for r, a in eng.active.items() if len(a.req.output) >= 2)
    eng._preempt(rid)
    done = {r.rid: list(r.output) for r in eng.run()}
    assert done == ref
    assert eng.preemptions >= 1
    assert eng.pool.free_pages == eng.pool.usable_pages


@pytest.mark.parametrize("sampling", [
    SamplingConfig(temperature=0.8, top_k=5, top_p=0.9),
    SamplingConfig(temperature=1.3, top_p=0.5),
    SamplingConfig()])
def test_filtered_probs_match_jax(sampling):
    """The distribution the sampled verify path accepts against: the
    temperature / top-k / top-p chain of JAX's ``filtered_probs`` (greedy:
    a point mass on the argmax)."""
    import jax.numpy as jnp
    from repro.serving.sampler import SamplingConfig as JSampling
    from repro.serving.sampler import filtered_probs as j_filtered
    from repro_torch.serving.sampler import filtered_probs
    logits = np.random.default_rng(5).standard_normal(
        (3, 4, 64)).astype(np.float32) * 3
    pj = np.asarray(j_filtered(jnp.asarray(logits), JSampling(
        sampling.temperature, sampling.top_k, sampling.top_p)))
    pt = filtered_probs(torch.from_numpy(logits), sampling).numpy()
    np.testing.assert_array_equal(pt > 0, pj > 0)
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-7)
