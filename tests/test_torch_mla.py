"""The port's MLA + MoE path (deepseek-v2-236b) against the JAX package's,
on the same seeded numpy inputs.

Contracts (ROADMAP.md, "Parity contracts"):

* the MLA mode (latent stream, values = its first ``v_width`` lanes) of
  the four attention kernels' plain versions -- dense decode, paged decode,
  dense and paged verify -- against the Pallas kernels in interpret mode at
  the JAX kernel test's shapes: rtol 2e-4, atol 2e-5;
* ``apply_moe`` (softmax, top-k, renormalised weights, capacity
  ``max(ceil(N k / E cf), 4)`` with drops in token order, shared experts)
  at decode and prefill sizes and with dropped entries: allclose 1e-5;
* the MLA mixer's decode and verify steps and their ops (dense and paged,
  fp32 and MX8 at nearest rounding): outputs to 1e-5, cache payloads equal;
* ``decode_op_plans``: kinds ``{"mla_decode", "kv_append"}`` and
  ``traffic(plan)`` equal to the JAX package's;
* ``params_from_jax``: prelude, MLA and MoE leaves carried exactly;
* serving: every backend serves deepseek (slots == paged streams), and
  greedy n-gram speculation equals plain decoding at batch 1.

The model-level parity (fp32 logits and 8 greedy steps, MX8 agreement),
paged == dense-gather logits bitwise at L = 127 / 128 / 129, and the
greedy speculative stream against the JAX engine at batch 2 are cases of
the parametrised tests in ``test_torch_model.py``,
``test_torch_paged_serving.py`` and ``test_torch_spec_serving.py``.

MoE capacity couples the tokens of one call, in the JAX package as here:
a verify step routes ``B * Kq`` tokens where a plain step routes ``B``, so
an expert can overflow in one and not the other.  With one request per
step (``N <= cap``) no expert ever overflows, and greedy speculation is
exactly plain decoding; at batch 2 the port's speculative stream is held to
the JAX package's instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as JOPS
from repro.configs import get_smoke_config as j_smoke
from repro.core import attention_cache as JAC
from repro.core import formats as JF
from repro.core import paged as JPG
from repro.kernels.mx_attention import mx_attention_decode as j_attn
from repro.kernels.mx_paged_attention import (
    mx_paged_attention_decode as j_pattn)
from repro.kernels.mx_spec_attention import (
    mx_paged_spec_attention_decode as j_pspec,
    mx_spec_attention_decode as j_spec)
from repro.models import attention as JATT
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import ops as TOPS
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import attention_cache as TAC
from repro_torch.core import formats as TF
from repro_torch.core import paged as TPG
from repro_torch.kernels import mx_attention as KA
from repro_torch.kernels import mx_paged_attention as KP
from repro_torch.kernels import mx_spec_attention as KV
from repro_torch.models import attention as TATT
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.api import Engine, ServeConfig

ARCH = "deepseek-v2-236b"
# tests/test_kernels.py::test_attention_kernel_mla_mode's shapes
B, H, DK, VW, T = 2, 16, 192, 128, 256
LENGTHS = (200, 64)
KQ = 3


def _qt(qt):
    return TF.QuantizedTensor(qt.fmt, tuple(qt.shape), {
        f: torch.from_numpy(np.array(a)) for f, a in qt.payload.items()})


def _tree(x):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                        jax.tree.map(np.asarray, x))


# ---------------------------------------------------------------------------
# (a) MLA mode of the four kernels' plain versions vs Pallas interpret mode
# ---------------------------------------------------------------------------

def _latent_pool(r, n_pages=6, n_stack=2):
    """A latent page pool and a shuffled block table over its pages."""
    pool = JF.mx8_quantize(jnp.asarray(r.standard_normal(
        (n_pages, n_stack, 128, 1, DK)).astype(np.float32)))
    bt = np.asarray([[4, 2], [5, 0]], np.int32)         # row 1: one page
    return pool, bt


@pytest.mark.parametrize("kernel", ["decode", "paged", "verify",
                                    "paged_verify"])
def test_plain_mla_kernels_vs_pallas_interpret(kernel):
    r = np.random.default_rng(11)
    lens = np.asarray(LENGTHS, np.int32)
    scale = 0.1
    verify = kernel.endswith("verify")
    q = r.standard_normal((B, KQ, H, DK) if verify else (B, H, DK)
                          ).astype(np.float32)
    kw = dict(scale=scale, v_width=VW)
    if kernel in ("decode", "verify"):
        C = JF.mx8_quantize(jnp.asarray(
            r.standard_normal((B, T, 1, DK)).astype(np.float32)))
        jfn, tfn = (j_spec, KV.mx_spec_attention_decode) if verify else \
            (j_attn, KA.mx_attention_decode)
        yj = jfn(jnp.asarray(q), C, None, jnp.asarray(lens), interpret=True,
                 **kw)
        yt = tfn(torch.from_numpy(q), _qt(C), None, torch.from_numpy(lens),
                 **kw)
    else:
        pool, bt = _latent_pool(r)
        jfn, tfn = (j_pspec, KV.mx_paged_spec_attention_decode) if verify \
            else (j_pattn, KP.mx_paged_attention_decode)
        yj = jfn(jnp.asarray(q), pool, None, jnp.asarray(bt), 1,
                 jnp.asarray(lens), interpret=True, **kw)
        yt = tfn(torch.from_numpy(q), _qt(pool), None, torch.from_numpy(bt),
                 1, torch.from_numpy(lens), **kw)
    assert yt.shape[-1] == VW
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-4,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# (b) apply_moe
# ---------------------------------------------------------------------------

def _moe_cfgs(capacity_factor=None):
    jc, tc = j_smoke(ARCH), t_smoke(ARCH)
    if capacity_factor is not None:
        jc = jc.with_(moe=jc.moe.__class__(**{
            **jc.moe.__dict__, "capacity_factor": capacity_factor}))
        tc = tc.with_(moe=tc.moe.__class__(**{
            **tc.moe.__dict__, "capacity_factor": capacity_factor}))
    return jc, tc


@pytest.mark.parametrize("shape,capacity_factor,drops", [
    ((4, 1, 128), None, False),      # a decode step at batch 4
    ((1, 37, 128), None, None),      # a prefill
    ((2, 64, 128), 0.3, True),       # capacity 4 of 128 entries: drops
])
def test_apply_moe_matches_jax(shape, capacity_factor, drops):
    jc, tc = _moe_cfgs(capacity_factor)
    p = JL.init_moe(jax.random.PRNGKey(0), jc)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    yj = np.asarray(JL.apply_moe(p, jnp.asarray(x), jc))
    yt = TL.apply_moe(_tree(p), torch.from_numpy(x), tc).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)
    if drops is not None:
        # routed entries per expert vs capacity: whether any was dropped
        N = shape[0] * shape[1]
        logits = x.reshape(N, -1) @ np.asarray(p["router"])
        sel = np.argsort(-logits, axis=-1)[:, :tc.moe.top_k]
        per_expert = np.bincount(sel.ravel(), minlength=tc.moe.n_experts)
        assert (per_expert.max() > TL.moe_capacity(N, tc)) == drops


# ---------------------------------------------------------------------------
# (c) the MLA mixer's decode / verify steps and their ops
# ---------------------------------------------------------------------------

def _mla_cfgs(fmt):
    jb, tb = ("jnp", "torch")
    jc = j_smoke(ARCH).with_(state_quant=JOPS.StateQuantConfig(
        fmt, "nearest", jb))
    tc = t_smoke(ARCH).with_(state_quant=TOPS.StateQuantConfig(
        fmt, "nearest", tb))
    return jc, tc


def _warm_caches(jc, tc, r, layout, n_ctx=130):
    """A latent cache holding ``n_ctx`` random rows: dense (B=2, T=256) or
    paged (shuffled pages, group 1 of 2), the same numbers in both."""
    cw, vw = jc.mla.cache_width, jc.mla.kv_lora
    lens = np.asarray([n_ctx, n_ctx - 57], np.int32)
    if layout == "dense":
        jcache = JAC.init_kv_cache(2, 256, 1, cw, jc.state_quant,
                                   mla_v_width=vw)
        tcache = TAC.init_kv_cache(2, 256, 1, cw, tc.state_quant,
                                   mla_v_width=vw)
        ckv = r.standard_normal((2, n_ctx, 1, cw)).astype(np.float32)
        jcache = JOPS.kv_append(jcache, jnp.asarray(ckv), None,
                                jc.state_quant, seed=3)
        tcache = TOPS.kv_append(tcache, torch.from_numpy(ckv), None,
                                tc.state_quant, seed=3)
        return (JM.set_cache_lengths(jcache, jnp.asarray(lens)),
                TM.set_cache_lengths([[tcache]], torch.from_numpy(lens))[0][0],
                lens)
    raw = r.standard_normal((7, 2, 128, 1, cw)).astype(np.float32)
    if jc.state_quant.fmt == "mx8":
        jk = JF.mx8_quantize(jnp.asarray(raw))
        tk = _qt(jk)
    else:
        jk, tk = jnp.asarray(raw), torch.from_numpy(raw)
    bt = np.asarray([[6, 1, 3, 0], [2, 5, 0, 0]], np.int32)
    jcache = JPG.PagedKVCache(jk, None, jnp.asarray(bt), jnp.asarray(lens),
                              jnp.int32(1), jc.state_quant.fmt, vw)
    tcache = TPG.PagedKVCache(tk, None, torch.from_numpy(bt),
                              torch.from_numpy(lens), 1, tc.state_quant.fmt,
                              vw)
    return jcache, tcache, lens


def _payloads(cache):
    k = cache.k
    if hasattr(k, "payload"):
        return {f: np.asarray(a) for f, a in sorted(k.payload.items())}
    return {"values": np.asarray(k)}


@pytest.mark.parametrize("fmt", ["fp32", "mx8"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("step", ["decode", "verify"])
def test_mla_mixer_steps_and_ops_match_jax(fmt, layout, step):
    jc, tc = _mla_cfgs(fmt)
    r = np.random.default_rng(5)
    p = JATT.init_mla(jax.random.PRNGKey(2), jc)
    jcache, tcache, lens = _warm_caches(jc, tc, r, layout)
    n = 1 if step == "decode" else KQ + 1
    x = r.standard_normal((2, n, jc.d_model)).astype(np.float32)
    pos = lens[:, None] + np.arange(n)[None]
    if step == "decode":
        yj, jcache = JATT.mla_decode(p, jnp.asarray(x), jcache, jc,
                                     jnp.asarray(pos), 7)
        yt, tcache = TATT.mla_decode(_tree(p), torch.from_numpy(x), tcache,
                                     tc, torch.from_numpy(pos), 7)
    else:
        yj, jcache = JATT.mla_spec_decode(p, jnp.asarray(x), jcache, jc,
                                          jnp.asarray(pos), 7)
        yt, tcache = TATT.mla_spec_decode(_tree(p), torch.from_numpy(x),
                                          tcache, tc, torch.from_numpy(pos),
                                          7)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tcache.lengths.numpy(),
                                  np.asarray(jcache.lengths))
    assert tcache.v is None and tcache.v_width == jc.mla.kv_lora
    pj, pt = _payloads(jcache), _payloads(tcache)
    assert sorted(pj) == sorted(pt)
    for f in pj:
        if f == "values":
            np.testing.assert_allclose(pt[f], pj[f], rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(pt[f], pj[f], err_msg=f)


def test_attn_kind_and_latent_only_append_pools():
    """A latent cache selects ``mla_decode``; its paged append writes the
    stream's three payload pools (the kernel's latent-only case)."""
    tc = t_smoke(ARCH).with_(state_quant=TOPS.StateQuantConfig(
        "mx8", "nearest", "cuda"))
    cache = TAC.init_kv_cache(2, 128, 1, 80, tc.state_quant, mla_v_width=64)
    assert TOPS.attn_kind_of(cache) == "mla_decode"
    assert cache.v is None
    _, tcache, lens = _warm_caches(*_mla_cfgs("mx8"),
                                   np.random.default_rng(0), "paged")
    before = {f: a.clone() for f, a in tcache.k.payload.items()}
    ckv = torch.randn((2, 1, 1, 80), generator=torch.Generator().manual_seed(1))
    out = TOPS.kv_append(tcache, ckv, None, tc.state_quant, seed=4)
    assert [tuple(a.shape[-1:]) for _, a in sorted(out.k.payload.items())] \
        == [(5,), (80,), (5,)]
    changed = [f for f, a in out.k.payload.items()
               if not torch.equal(a, before[f])]
    assert sorted(changed) == ["exponent", "mantissa", "micro"]
    np.testing.assert_array_equal(out.lengths.numpy(), lens + 1)


# ---------------------------------------------------------------------------
# (d) decode-op plans and traffic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("spec_k", [0, 3])
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_decode_op_plans_match_jax(layout, spec_k, size):
    from repro.configs import get_config as j_full
    from repro_torch.configs import get_config as t_full
    jc, tc = (j_smoke(ARCH), t_smoke(ARCH)) if size == "smoke" else \
        (j_full(ARCH), t_full(ARCH))
    je = JOPS.decode_op_plans(jc, 2, 300, layout=layout, spec_k=spec_k)
    te = TOPS.decode_op_plans(tc, 2, 300, layout=layout, spec_k=spec_k)
    kinds = {"spec_verify" if spec_k else "mla_decode", "kv_append"}
    assert {e.kind for e in te} == kinds
    assert [(e.kind, e.count) for e in te] == [(e.kind, e.count) for e in je]
    for a, b in zip(je, te):
        assert b.traffic.__dict__ == a.traffic.__dict__, a.kind


# ---------------------------------------------------------------------------
# (e) params_from_jax
# ---------------------------------------------------------------------------

def test_params_from_jax_carries_prelude_mla_and_moe():
    jc, tc = _mla_cfgs("fp32")
    jp = JM.init_model(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    pre_j, pre_t = jp["prelude"][0], tp["prelude"][0]
    for name in ("wq_a", "wq_b", "wkv_a", "w_uk", "w_uv", "wo"):
        np.testing.assert_array_equal(pre_t["mixer"][name].numpy(),
                                      np.asarray(pre_j["mixer"][name]))
    assert tuple(pre_t["ffn"]["wi"].shape) == (128, 128)   # first_dense_ff
    for g in range(tc.n_groups):
        moe_j, moe_t = jp["groups"][0]["ffn"], tp["groups"][g][0]["ffn"]
        assert tuple(moe_t["wi"].shape) == (8, 128, 64)
        for name in ("router", "wi", "wg", "wo"):
            np.testing.assert_array_equal(moe_t[name].numpy(),
                                          np.asarray(moe_j[name][g]))
        np.testing.assert_array_equal(moe_t["shared"]["wo"].numpy(),
                                      np.asarray(moe_j["shared"]["wo"][g]))
    own = TM.init_model(tc, torch.Generator().manual_seed(0), device="cpu")
    conv, mine = (jax.tree_util.tree_leaves(t) for t in (tp, own))
    assert [tuple(a.shape) for a in conv] == [tuple(a.shape) for a in mine]
    assert [a.dtype for a in conv] == [a.dtype for a in mine]


# ---------------------------------------------------------------------------
# serving: every backend, and greedy speculation == plain
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deepseek_mx8():
    cfg = t_smoke(ARCH).with_(state_quant=TOPS.StateQuantConfig(
        "mx8", "nearest", "cuda"))       # cuda on CPU: the plain versions
    return TM.init_model(cfg, torch.Generator().manual_seed(0),
                         device="cpu"), cfg


def _prompts(cfg, lens=(24, 9, 124, 122)):
    rng = np.random.default_rng(3)
    base = rng.integers(0, cfg.vocab_size, 6)
    return [np.tile(base, -(-n // 6))[:n] if i % 2 == 0
            else rng.integers(0, cfg.vocab_size, n)
            for i, n in enumerate(lens)]


def _streams(params, cfg, sc, prompts, max_new=8):
    eng = Engine(params, cfg, sc)
    hs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run()
    assert all(h.status == "done" and len(h.output) == max_new for h in hs)
    return eng, [h.output for h in hs]


def test_every_backend_serves_deepseek(deepseek_mx8):
    """Slot pool, paged pool (a pool small enough to preempt) and paged
    with n-gram speculation all finish; slots and paged emit the same
    greedy streams (prompts within ``prefill_chunk``, so both prefill
    each prompt in one call and route the same tokens together)."""
    params, cfg = deepseek_mx8
    prompts = _prompts(cfg)
    _, slots = _streams(params, cfg, ServeConfig(
        backend="slots", batch=2, cache_capacity=256), prompts)
    eng, paged = _streams(params, cfg, ServeConfig(batch=2, n_pages=3),
                          prompts)
    assert eng.stats()["preemptions"] >= 1
    assert paged == slots
    eng, _ = _streams(params, cfg, ServeConfig(batch=2, n_pages=6,
                                               spec="ngram", spec_k=3),
                      prompts)
    assert eng.stats()["proposed_tokens"] > 0
    assert eng.engine.pool.free_pages == eng.engine.pool.usable_pages


@pytest.mark.parametrize("fmt", ["fp32", "mx8"])
def test_spec_ngram_greedy_equals_plain_at_batch_1(deepseek_mx8, fmt):
    params, cfg = deepseek_mx8
    cfg = cfg.with_(state_quant=TOPS.StateQuantConfig(fmt, "nearest",
                                                      "torch"))
    prompts = _prompts(cfg)
    _, ref = _streams(params, cfg, ServeConfig(batch=1, n_pages=6),
                      prompts, max_new=10)
    eng, out = _streams(params, cfg, ServeConfig(batch=1, n_pages=6,
                                                 spec="ngram", spec_k=3),
                        prompts, max_new=10)
    assert out == ref
    st = eng.stats()
    assert 0 < st["accepted_tokens"] <= st["proposed_tokens"]


def test_fork_session_and_preemption_streams_match_jax():
    """The prelude's latent stream and the group stream page, spill,
    resume and fork like any other: a two-turn session (the second turn
    forks a copy-on-write child) and a preempting pool give the JAX
    engine's greedy streams, fp32, same weights."""
    from repro.serving.api import Engine as JEngine
    from repro.serving.api import ServeConfig as JServeConfig
    jc, tc = _mla_cfgs("fp32")
    jp = JM.init_model(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    rng = np.random.default_rng(9)
    first, turn2 = rng.integers(0, 512, 140), rng.integers(0, 512, 6)
    prompts = [rng.integers(0, 512, n) for n in (120, 118, 121)]
    outs = []
    for E, S, params, cfg in ((JEngine, JServeConfig, jp, jc),
                              (Engine, ServeConfig, tp, tc)):
        extra = dict(prefetch_window=0) if S is JServeConfig else {}
        eng = E(params, cfg, S(batch=2, n_pages=8, prefill_chunk=128,
                               **extra))
        chat = eng.session()
        a = chat.send(first, max_new_tokens=4).result()
        b = chat.send(turn2, max_new_tokens=5)
        c = list(chat.send(turn2[:2], max_new_tokens=3))
        chat.close()
        assert eng.stats()["shared_page_hits"] >= 1
        eng2 = E(params, cfg, S(batch=3, n_pages=5, prefill_chunk=128,
                                **extra))
        hs = [eng2.submit(p, max_new_tokens=12) for p in prompts]
        eng2.run()
        outs.append((a.output, b.output, c, [h.output for h in hs],
                     eng2.stats()["preemptions"]))
    assert outs[0] == outs[1]
    assert outs[1][-1] >= 1


@pytest.mark.parametrize("paged", [True, False])
def test_launcher_serves_deepseek_on_cpu(capsys, paged):
    from repro_torch.launch import serve
    args = ["--arch", ARCH, "--smoke-size", "--device", "cpu",
            "--requests", "3", "--max-new", "3"]
    assert serve.main(args + (["--paged", "--pages", "6"] if paged
                              else [])) == 0
    out = capsys.readouterr().out
    assert f"pool={'paged' if paged else 'slots'}" in out
    assert "mla_decode=" in out
