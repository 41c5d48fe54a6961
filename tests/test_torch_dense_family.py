"""The dense-transformer family of the port -- opt-6.7b (LayerNorm with a
bias, an ungated ReLU FFN, a learned position table) and yi-9b (GQA,
SwiGLU, RoPE, RMSNorm) -- against the JAX package, on the CPU.

Contracts:

* layers: ``apply_norm`` (both kinds) and ``apply_ffn`` (all four kinds,
  GELU in its tanh form) to rtol 1e-5, atol 1e-5 * max|out| (fp32 on both
  sides, reductions and products in other orders); ``sincos_pos_emb``
  bitwise (both build it in numpy);
* models at fp32 (the smoke configs, JAX weights through
  ``params_from_jax``): prefill and 8 greedy decode steps' logits to rtol
  1e-4, atol 1e-4 * max|logits|, identical greedy tokens; the learned
  table at prefill, decode, paged decode and verify the same way; paged
  decode bitwise the dense-gather path; the greedy speculative stream
  equal to the JAX package's at batch 2; at MX8 the first decode step to
  rtol 1e-3 and the greedy token agreement over 8 steps reported;
* what ``check_supported`` and the engines still refuse.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as JOPS
from repro.configs import get_smoke_config as j_smoke
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.api import Engine as JEngine
from repro.serving.api import ServeConfig as JServeConfig
from repro.serving.memory import PagedStatePool as JPool
from repro_torch import ops as TOPS
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.paged import PAGE_TOKENS, pages_for
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.api import Engine, ServeConfig
from repro_torch.serving.memory import PagedStatePool

ARCHS = ("opt-6.7b", "yi-9b")
N_STEPS = 8
_PAIRS = {}


def _pair(arch, fmt="fp32", rounding="stochastic", **over):
    """(JAX cfg, port cfg, JAX params, port params): the same weights."""
    key = (arch, fmt, rounding, tuple(sorted(over.items())))
    if key not in _PAIRS:
        jb, tb = ("jnp", "torch") if fmt != "mx8" else ("jnp", "cuda")
        jcfg = j_smoke(arch).with_(state_quant=JOPS.StateQuantConfig(
            fmt, rounding, jb), **over)
        tcfg = t_smoke(arch).with_(state_quant=TOPS.StateQuantConfig(
            fmt, rounding, tb), **over)
        jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  device="cpu")
        _PAIRS[key] = (jcfg, tcfg, jparams, tparams)
    return _PAIRS[key]


def _close(a, b, rtol):
    a, b = np.asarray(a), b.numpy()
    np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * np.abs(a).max())


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_jax(kind):
    r = np.random.default_rng(1)
    x = (r.standard_normal((3, 5, 96)) * 3 + 1.5).astype(np.float32)
    p = {"scale": r.standard_normal(96).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = r.standard_normal(96).astype(np.float32)
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), kind, 1e-5)
    got = TL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), kind, 1e-5)
    _close(want, got, 1e-5)
    assert set(TL.init_norm(96, kind, torch.float32, "cpu")) == \
        set(JL.init_norm(96, kind, jnp.float32))


def test_layernorm_is_the_population_variance():
    """``jnp.var`` divides by n, not n - 1: the port's LayerNorm equals the
    numpy form with ``ddof=0`` and not the unbiased one."""
    x = np.random.default_rng(2).standard_normal((4, 8)).astype(np.float32)
    p = {"scale": torch.ones(8), "bias": torch.zeros(8)}
    got = TL.apply_norm(p, torch.from_numpy(x), "layernorm", 1e-5).numpy()
    xd = x.astype(np.float64)
    mu = xd.mean(-1, keepdims=True)
    for ddof, close in ((0, True), (1, False)):
        want = (xd - mu) / np.sqrt(xd.var(-1, ddof=ddof, keepdims=True)
                                   + 1e-5)
        assert np.allclose(got, want, rtol=1e-5, atol=1e-6) == close, ddof


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu"])
def test_apply_ffn_matches_jax(kind):
    """The ungated kinds have no ``wg`` on either side; parameters from
    the JAX package's ``init_ffn``."""
    jcfg = j_smoke("yi-9b").with_(ffn_kind=kind)
    tcfg = t_smoke("yi-9b").with_(ffn_kind=kind)
    jp = JL.init_ffn(jax.random.PRNGKey(3), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    own = TL.init_ffn(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert set(own) == set(tp) == ({"wi", "wg", "wo"}
                                   if kind in ("swiglu", "geglu")
                                   else {"wi", "wo"})
    x = np.random.default_rng(4).standard_normal((2, 3, 128)).astype(
        np.float32)
    want = JL.apply_ffn(jp, jnp.asarray(x), kind)
    _close(want, TL.apply_ffn(tp, torch.from_numpy(x), kind), 1e-5)


def test_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation; the erf form
    differs from it by more than the layers' tolerance."""
    x = np.linspace(-4, 4, 801, dtype=np.float32)[None, :]
    eye = np.eye(801, dtype=np.float32)
    p = {"wi": torch.from_numpy(eye), "wo": torch.from_numpy(eye)}
    got = TL.apply_ffn(p, torch.from_numpy(x), "gelu")
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    _close(want, got, 1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


@pytest.mark.parametrize("S,d", [(1, 16), (37, 128), (300, 96)])
def test_sincos_pos_emb_matches_jax(S, d):
    want = np.asarray(JL.sincos_pos_emb(S, d, jnp.float32))
    got = TL.sincos_pos_emb(S, d, torch.float32, "cpu")
    assert got.shape == (S, d) and np.array_equal(got.numpy(), want)


def test_sincos_positions_at_prefill_only_as_in_jax():
    """A config with sinusoidal positions (none of the served ones has
    them): prefill adds them, the decode step does not, on both sides."""
    jcfg, tcfg, jparams, tparams = _pair("yi-9b", pos_emb="sincos")
    steps = _run(jcfg, tcfg, jparams, tparams, n_steps=2)
    for jl, tl in steps:
        _close(jl, tl, 1e-4)
    _, rope, _, rparams = _pair("yi-9b")
    plain = TM.prefill(rparams, rope,
                       {"tokens": torch.zeros((1, 5), dtype=torch.long)})[0]
    moved = TM.prefill(tparams, tcfg,
                       {"tokens": torch.zeros((1, 5), dtype=torch.long)})[0]
    assert not torch.equal(plain, moved)


# ---------------------------------------------------------------------------
# models: prefill, decode, paged, verify against the JAX package
# ---------------------------------------------------------------------------

def _run(jcfg, tcfg, jparams, tparams, n_steps=N_STEPS):
    """Prefill a (2, 24) prompt and decode ``n_steps`` greedy steps on
    both sides; the (JAX, port) logits of every step."""
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 24))
    jl, jc = jax.jit(lambda p, b: JM.prefill(p, jcfg, b))(
        jparams, {"tokens": jnp.asarray(prompt, jnp.int32)})
    tl, tc = TM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(prompt)})
    jc = JM.set_cache_lengths(jc, jnp.full((2,), 24, jnp.int32))
    tc = TM.set_cache_lengths(tc, torch.full((2,), 24))
    jdec = jax.jit(lambda p, t, c, L, s: JM.decode_step(p, jcfg, t, c, L, s))
    out = [(jl, tl)]
    jt = jnp.argmax(jl, -1).astype(jnp.int32)
    tt = torch.argmax(tl, -1)
    for i in range(n_steps):
        lens = np.full((2,), 24 + i, np.int32)
        jl, jc = jdec(jparams, jt, jc, jnp.asarray(lens), jnp.int32(i))
        tl, tc = TM.decode_step(tparams, tcfg, tt, tc,
                                torch.from_numpy(lens), seed=i)
        out.append((jl, tl))
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_prefill_and_greedy_decode_match_jax(arch):
    for i, (jl, tl) in enumerate(_run(*_pair(arch))):
        _close(jl, tl, 1e-4)
        np.testing.assert_array_equal(np.asarray(jnp.argmax(jl, -1)),
                                      torch.argmax(tl, -1).numpy(),
                                      err_msg=f"{arch} step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_mx8_first_step_and_token_agreement(arch):
    """The kernels' plain versions (``cuda`` backend, CPU tensors) against
    the JAX ops: prefill to rtol 1e-4, the first decode step to rtol 1e-3
    (a few stochastic-rounding decisions may flip), token agreement
    reported, not asserted."""
    steps = _run(*_pair(arch, "mx8"))
    _close(steps[0][0], steps[0][1], 1e-4)
    _close(steps[1][0], steps[1][1], 1e-3)
    agree = np.mean([np.array_equal(np.asarray(jnp.argmax(jl, -1)),
                                    torch.argmax(tl, -1).numpy())
                     for jl, tl in steps])
    print(f"{arch} mx8 greedy token agreement over {len(steps)} steps: "
          f"{agree:.2f}")
    assert all(np.isfinite(tl.numpy()).all() for _, tl in steps)


def _pools_after_prefill(pair, length):
    """The JAX and the port's paged pools, one request of ``length``
    prompt tokens prefilled into each, its table grown by one page."""
    jcfg, tcfg, jparams, tparams = pair
    prompt = np.random.default_rng(length).integers(0, jcfg.vocab_size,
                                                    length)
    jpool = JPool(jcfg, n_pages=8, n_slabs=3)
    tpool = PagedStatePool(tcfg, n_pages=8, n_slabs=3, device="cpu")
    pr = jnp.asarray(prompt, jnp.int32)[None]
    jl, jrow = jax.jit(lambda p, b: JM.prefill(p, jcfg, b))(
        jparams, {"tokens": pr})
    tl, trow = TM.prefill(tparams, tcfg,
                          {"tokens": torch.as_tensor(prompt)[None]})
    for pool, row in ((jpool, jrow), (tpool, trow)):
        assert pool.register(1, pages_for(length))
        pool.insert_prefill(1, row)
        assert pool.grow(1, 1)
    _close(jl, tl, 1e-4)
    return jpool, tpool, int(jnp.argmax(jl[0]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("stage", ["paged_decode", "verify"])
def test_paged_decode_and_verify_match_jax(arch, stage):
    """The JAX ``PagedStatePool`` and the port's over the same prefill:
    two paged decode steps, or one verify pass of 4 positions, across the
    page boundary (lengths 126 + 4 > 128); logits to rtol 1e-4 and equal
    greedy tokens."""
    pair = _pair(arch)
    jparams, tparams = pair[2], pair[3]
    jpool, tpool, tok = _pools_after_prefill(pair, 126)
    rows = [1, None]
    if stage == "paged_decode":
        for step in range(2):
            L = np.array([126 + step, 0], np.int32)
            t = np.array([tok, 0], np.int32)
            jl = jpool.decode(jparams, rows, t, L, seed=step + 1)
            tl = tpool.decode(tparams, rows, t, L, seed=step + 1)
            _close(np.asarray(jl)[:1], tl[:1], 1e-4)
            tok = int(jnp.argmax(jl[0]))
            assert tok == int(tl[0].argmax())
        return
    toks = np.array([[tok, 7, 8, 9], [0, 0, 0, 0]], np.int32)
    L = np.array([126, 0], np.int32)
    jl, _ = jpool.decode_spec(jparams, rows, toks, L, seed=1,
                              min_pages=pages_for(130))
    tl, _ = tpool.decode_spec(tparams, rows, toks, L, seed=1,
                              min_pages=pages_for(130))
    _close(np.asarray(jl)[:1], tl[:1], 1e-4)
    np.testing.assert_array_equal(np.asarray(jnp.argmax(jl[0], -1)),
                                  tl[0].argmax(-1).numpy())


@pytest.mark.parametrize("stage", ["prefill", "decode", "paged_decode",
                                   "verify"])
def test_learned_table_enters_every_entry_point(stage):
    """opt-6.7b's position rows change each entry point's logits: with the
    table's rows rolled by one, the port's logits move, and they still
    equal the JAX package's given the same rolled table."""
    jcfg, tcfg, jparams, tparams = _pair("opt-6.7b")
    rolled_j = dict(jparams, pos=jnp.roll(jparams["pos"], 1, axis=0))
    rolled_t = dict(tparams, pos=torch.roll(tparams["pos"], 1, dims=0))
    outs = {}
    for name, jp, tp in (("base", jparams, tparams),
                         ("rolled", rolled_j, rolled_t)):
        pair = (jcfg, tcfg, jp, tp)
        if stage in ("prefill", "decode"):
            jl, tl = _run(*pair, n_steps=1)[0 if stage == "prefill" else 1]
        else:
            jpool, tpool, tok = _pools_after_prefill(pair, 40)
            rows, L = [1, None], np.array([40, 0], np.int32)
            if stage == "paged_decode":
                t = np.array([tok, 0], np.int32)
                jl = jpool.decode(jp, rows, t, L, seed=1)
                tl = tpool.decode(tp, rows, t, L, seed=1)
            else:
                toks = np.array([[tok, 3, 4], [0, 0, 0]], np.int32)
                jl, _ = jpool.decode_spec(jp, rows, toks, L, seed=1)
                tl, _ = tpool.decode_spec(tp, rows, toks, L, seed=1)
            jl, tl = np.asarray(jl)[:1], tl[:1]
        _close(jl, tl, 1e-4)
        outs[name] = tl
    assert not torch.equal(outs["base"], outs["rolled"])


def _prefill_pool(params, cfg, length):
    pool = PagedStatePool(cfg, n_pages=8, n_slabs=3, device="cpu")
    prompt = np.random.default_rng(length).integers(0, cfg.vocab_size,
                                                    length)
    logits, row = TM.prefill(params, cfg,
                             {"tokens": torch.as_tensor(prompt)[None]})
    assert pool.register(1, pages_for(length))
    pool.insert_prefill(1, row)
    return pool, int(logits[0].argmax())


def _decode_steps(pool, params, tok, length, n_steps=2):
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
    ref = _decode_steps(pool, params, tok, length)
    for p, s in zip(pool.pools, snapshot):
        p.copy_(s)
    grown = [p for p in pool.page_table[1] if p not in pages0]
    if grown:
        pool.placement.unref(grown)
    pool.page_table[1] = list(pages0)
    pool.decode_mode = "paged"
    got = _decode_steps(pool, params, tok, length)
    for step, (a, b) in enumerate(zip(ref, got)):
        assert torch.equal(a, b), f"{arch} L={length} step {step}"


def _spec_prompts(vocab, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, 5)
    return [np.tile(base, 3).astype(np.int32),
            rng.integers(0, vocab, 140).astype(np.int32)]


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_spec_stream_matches_jax(arch):
    """The paged engine with n-gram speculation at batch 2, fp32: the same
    streams and the same speculation accounting as the JAX package's."""
    jcfg, tcfg, jparams, tparams = _pair(arch, "fp32", "nearest")
    prompts = _spec_prompts(tcfg.vocab_size)
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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_greedy_streams_match_jax(arch, backend):
    """Greedy fp32 streams of the slot and the paged engines equal the JAX
    package's over prompts past ``prefill_chunk`` (paged)."""
    jcfg, tcfg, jparams, tparams = _pair(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, n) for n in (150, 9, 70)]
    kw = (dict(backend="slots", batch=2, cache_capacity=256)
          if backend == "slots" else dict(batch=2, n_pages=6,
                                          prefill_chunk=64))
    jeng = JEngine(jparams, jcfg, JServeConfig(
        **kw, **({} if backend == "slots" else dict(prefetch_window=0))))
    teng = Engine(tparams, tcfg, ServeConfig(**kw))
    jh = [jeng.submit(p, max_new_tokens=5) for p in prompts]
    th = [teng.submit(p, max_new_tokens=5) for p in prompts]
    jeng.run()
    teng.run()
    for a, b in zip(jh, th):
        assert (a.status, a.output) == (b.status, b.output), a.rid


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_greedy_equals_plain_mx8(arch):
    """MX8 at round to nearest, the ``cuda`` backend's plain versions on
    the CPU: speculation changes no greedy token (the verify step's
    LayerNorm or RMSNorm over four positions included)."""
    cfg = t_smoke(arch).with_(state_quant=TOPS.StateQuantConfig(
        "mx8", "nearest", "cuda"))
    params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    outs = {}
    for spec in (None, "ngram"):
        eng = Engine(params, cfg, ServeConfig(batch=2, n_pages=17,
                                              spec=spec, spec_k=3))
        hs = [eng.submit(p, max_new_tokens=8)
              for p in _spec_prompts(cfg.vocab_size)]
        eng.run()
        outs[spec] = [h.output for h in hs]
    assert outs["ngram"] == outs[None]
    assert eng.stats()["proposed_tokens"] > 0


# ---------------------------------------------------------------------------
# conversion, configs, refusals
# ---------------------------------------------------------------------------

def test_params_from_jax_carries_pos():
    jcfg, tcfg, jparams, tparams = _pair("opt-6.7b")
    assert tparams["pos"].shape == (TM.POS_ROWS, tcfg.d_model)
    assert np.array_equal(tparams["pos"].numpy(), np.asarray(jparams["pos"]))
    own = TM.init_model(tcfg, torch.Generator().manual_seed(0), device="cpu")
    conv, mine = (jax.tree_util.tree_leaves(t) for t in (tparams, own))
    assert [tuple(a.shape) for a in conv] == [tuple(a.shape) for a in mine]
    assert "pos" not in _pair("yi-9b")[3]
    for layer in tparams["groups"]:
        assert set(layer[0]["norm"]) == {"scale", "bias"}
        assert set(layer[0]["ffn"]) == {"wi", "wo"}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax_field_for_field(arch):
    from repro.configs import get_config as j_full
    assert arch in ALL_ARCHS
    for mine, theirs in ((get_config(arch), j_full(arch)),
                         (t_smoke(arch), j_smoke(arch))):
        for field in ("name", "n_layers", "d_model", "n_heads",
                      "n_kv_heads", "head_dim", "d_ff", "vocab_size",
                      "pattern", "ffn_kind", "norm_kind", "pos_emb",
                      "rope_theta", "tie_embeddings", "norm_eps"):
            assert getattr(mine, field) == getattr(theirs, field), field


@pytest.mark.parametrize("over,match", [
    pytest.param(dict(frontend="video", frontend_dim=64), "frontends",
                 id="over0-frontends"),
    pytest.param(dict(ffn_kind="squared_relu"), "unknown",
                 id="over4-unknown"),
    pytest.param(dict(norm_kind="batchnorm"), "unknown", id="over5-unknown"),
    pytest.param(dict(pos_emb="alibi"), "unknown", id="over6-unknown"),
])
def test_check_supported_still_refuses(over, match):
    """Frontends (patch, audio frames), prefixes, encoders and non-causal
    attention are ported (``tests/test_torch_frontends.py``); an unknown
    frontend, FFN, norm or position kind is still refused."""
    with pytest.raises(NotImplementedError, match=match):
        TM.check_supported(t_smoke("opt-6.7b").with_(**over))


def test_engines_refuse_positions_past_the_learned_table():
    """opt's table has 32,768 rows: a slot capacity past it, or a paged
    request whose prompt, new tokens and drafts could reach past it, is
    refused instead of reading a row the JAX package would clamp."""
    _, tcfg, _, tparams = _pair("opt-6.7b")
    with pytest.raises(ValueError, match="position table"):
        Engine(tparams, tcfg, ServeConfig(backend="slots", batch=1,
                                          cache_capacity=32768 + 128))
    Engine(tparams, tcfg, ServeConfig(backend="slots", batch=1,
                                      cache_capacity=32768))
    eng = Engine(tparams, tcfg, ServeConfig(batch=1, n_pages=4,
                                            spec="ngram", spec_k=3))
    with pytest.raises(ValueError, match="position table"):
        eng.submit(np.zeros(100, np.int32), max_new_tokens=32768 - 100 - 2)
    eng.submit(np.zeros(100, np.int32), max_new_tokens=32768 - 100 - 3)
