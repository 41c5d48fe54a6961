"""The port's xLSTM (mLSTM + sLSTM, ``xlstm-1.3b``) against the JAX
package's, on the same seeded numpy inputs, at ``SMOKE`` size (8 layers,
d_model 64; the mLSTM's dk = dv = 64, dv_aug = 80).

Contracts (ROADMAP.md, "Parity contracts"):

* the mixers -- ``mlstm_forward`` / ``mlstm_decode`` (output, stored state,
  conv tail) and ``slstm_forward`` / ``slstm_decode`` (output, the four
  carries): fp32 state to rtol 1e-5, atol 1e-5 * max|.|; MX8 state: the
  output to the same tolerance, exponent and micro bytes bitwise, mantissas
  at a mismatch rate <= 1e-5, one step apart where they differ;
* ``chunked_la_scalar`` at the normalizer-augmented dv_aug, and kernel 1's
  plain version against the JAX Pallas kernel (interpret mode) at the JAX
  suite's mLSTM-like case (1, 1, 128, 1040): ``tests/test_torch_ops.py``'s
  state-update contract;
* the model, fp32 state: prefill and 6 greedy decode steps' logits to rtol
  1e-4 (as ``test_torch_model.py``) and identical tokens; MX8 state: the
  prefill logits to rtol 1e-4 and every prefilled mLSTM state held as the
  mixers' are, except that a mantissa may sit one step apart at a higher
  rate (the layers' fp32 inputs differ in the last bits, and a value near
  a rounding boundary rounds apart: up to 8 of 20,480 a layer); the first
  decode step's difference and the greedy token agreement are reported,
  not asserted (seven mLSTM layers amplify each flipped mantissa);
* serving: the paged pool's logits bitwise its dense-gather path's; fp32
  greedy streams equal to the JAX slot engine's, paged engine's and paged
  engine's with n-gram speculation (batch 2); a spill and resume through
  ``extract_request`` / ``insert_blob`` gives back every slab leaf
  bitwise and the stream goes on as if uninterrupted;
* ``params_from_jax`` leaf for leaf, ``decode_op_plans`` equal to JAX's;
* 1- and 2-token prompts, which the JAX package cannot prefill (its conv
  tail ``u[:, -3:]`` is shorter than 3 rows): the port pads the tail with
  zero rows, and prefill + decode equals the prompt fed through
  ``decode_step`` from ``init_decode_caches``;
* every mixer dispatch names its kinds and raises on an unknown one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as JOPS
from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.core import formats as JF
from repro.kernels.mx_state_update import mx_state_update as j_su
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro.serving.api import Engine as JEngine
from repro.serving.api import ServeConfig as JServeConfig
from repro_torch import ops as TOPS
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import formats as TF
from repro_torch.core.paged import pages_for
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import ssm as TSSM
from repro_torch.models.convert import params_from_jax
from repro_torch.ops import model_traffic as TMT
from repro_torch.serving.api import Engine, ServeConfig
from repro_torch.serving.memory import PagedStatePool

ARCH = "xlstm-1.3b"
N_STEPS = 6
_PAIRS = {}


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(want, got, rtol):
    want, got = _np(want), _np(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _cfgs(fmt="fp32", rounding="nearest"):
    jb, tb = ("jnp", "torch") if fmt != "mx8" else ("jnp", "cuda")
    return (j_smoke(ARCH).with_(state_quant=JOPS.StateQuantConfig(
                fmt, rounding, jb)),
            t_smoke(ARCH).with_(state_quant=TOPS.StateQuantConfig(
                fmt, rounding, tb)))


def _pair(fmt="fp32", rounding="stochastic"):
    """Both packages' configs and the same weights (JAX's, through numpy)."""
    key = (fmt, rounding)
    if key not in _PAIRS:
        jc, tc = _cfgs(fmt, rounding)
        jp = JM.init_model(jax.random.PRNGKey(0), jc)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
        _PAIRS[key] = (jc, tc, jp, tp)
    return _PAIRS[key]


def _hold_mx8(jq, tq, ctx):
    """Exponent and micro bitwise; mantissas one step apart at most, at a
    mismatch rate <= 1e-5."""
    for f in ("exponent", "micro"):
        np.testing.assert_array_equal(tq.payload[f].numpy(),
                                      np.asarray(jq.payload[f]),
                                      err_msg=f"{ctx} {f}")
    mj = np.asarray(jq.payload["mantissa"]).astype(np.int32)
    mt = tq.payload["mantissa"].numpy().astype(np.int32)
    assert np.abs(mj - mt).max() <= 1, ctx
    assert (mj != mt).mean() <= 1e-5, ctx
    return mj != mt


# ---------------------------------------------------------------------------
# (a) the mixers
# ---------------------------------------------------------------------------

def _mixer(kind, fmt="fp32"):
    jc, tc = _cfgs(fmt, "stochastic")
    init = JSSM.init_mlstm if kind == "mlstm" else JSSM.init_slstm
    jp = init(jax.random.PRNGKey(3), jc)
    tp = {n: torch.from_numpy(np.array(a)) for n, a in jp.items()}
    return jc, tc, jp, tp


@pytest.mark.parametrize("fmt", ["fp32", "mx8"])
def test_mlstm_forward_matches_jax(fmt):
    """S = 37 over chunk 16: the last chunk is padded."""
    jc, tc, jp, tp = _mixer("mlstm", fmt)
    x = np.random.default_rng(2).standard_normal(
        (2, 37, jc.d_model)).astype(np.float32)
    jy, js = JSSM.mlstm_forward(jp, jnp.asarray(x), jc)
    ty, ts = TSSM.mlstm_forward(tp, torch.from_numpy(x), tc)
    d_up, H, dk, dv, dv_aug = TSSM._mlstm_dims(tc)
    assert TSSM._mlstm_dims(tc) == JSSM._mlstm_dims(jc)
    assert (dk, dv_aug) == (64, 80)
    assert tuple(ts["S"].shape) == (2, H, dv_aug, dk)       # stored Sᵀ
    _close(jy, ty, 1e-5)
    np.testing.assert_array_equal(ts["conv"].numpy(), np.asarray(js["conv"]))
    if fmt == "fp32":
        _close(js["S"], ts["S"], 1e-5)
    else:
        _hold_mx8(js["S"], ts["S"], "mlstm_forward")


@pytest.mark.parametrize("fmt", ["fp32", "mx8"])
def test_mlstm_decode_matches_jax(fmt):
    jc, tc, jp, tp = _mixer("mlstm", fmt)
    d_up, H, dk, dv, dv_aug = TSSM._mlstm_dims(tc)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
    S0 = (rng.standard_normal((2, H, dv_aug, dk)) * 0.5).astype(np.float32)
    conv = rng.standard_normal((2, 3, d_up)).astype(np.float32)
    if fmt == "fp32":
        jS, tS = jnp.asarray(S0), torch.from_numpy(S0)
    else:
        jS, tS = (JF.quantize(jnp.asarray(S0), "mx8"),
                  TF.quantize(torch.from_numpy(S0), "mx8"))
    jy, jst = JSSM.mlstm_decode(jp, jnp.asarray(x), {
        "S": jS, "conv": jnp.asarray(conv)}, jc, jnp.uint32(5))
    ty, tst = TSSM.mlstm_decode(tp, torch.from_numpy(x), {
        "S": tS, "conv": torch.from_numpy(conv)}, tc, 5)
    assert tuple(ty.shape) == (2, 1, jc.d_model)
    _close(jy, ty, 1e-5)
    np.testing.assert_array_equal(tst["conv"].numpy(),
                                  np.asarray(jst["conv"]))
    if fmt == "fp32":
        _close(jst["S"], tst["S"], 1e-5)
    else:
        _hold_mx8(jst["S"], tst["S"], "mlstm_decode")


@pytest.mark.parametrize("step", ["forward", "decode"])
def test_slstm_matches_jax(step):
    """The forward's loop over 37 positions from the ``m = -1e30`` carry,
    then one decode step from the forward's carries."""
    jc, tc, jp, tp = _mixer("slstm")
    x = np.random.default_rng(2).standard_normal(
        (2, 37, jc.d_model)).astype(np.float32)
    jy, js = JSSM.slstm_forward(jp, jnp.asarray(x), jc)
    ty, ts = TSSM.slstm_forward(tp, torch.from_numpy(x), tc)
    if step == "decode":
        xd = x[:, :1]
        jy, js = JSSM.slstm_decode(jp, jnp.asarray(xd), js, jc, 0)
        ty, ts = TSSM.slstm_decode(tp, torch.from_numpy(xd), ts, tc, 0)
    assert tuple(ty.shape) == tuple(jy.shape)
    _close(jy, ty, 1e-5)
    assert set(ts) == set(js) == set("cnmh")
    for k in "cnmh":
        assert ts[k].dtype == torch.float32
        _close(js[k], ts[k], 1e-5)
    H, dh = TSSM._slstm_dims(tc)
    init = TSSM.slstm_init_state(3, tc, "cpu")
    assert all(tuple(v.shape) == (3, H, dh) for v in init.values())
    assert bool((init["m"] == -1e30).all())


def test_chunked_la_scalar_at_dv_aug():
    """The mLSTM's scan: v widened by ``[1, 0 x 15]``, so state row dv
    carries the normalizer; against JAX and the fp64 recurrence."""
    rng = np.random.default_rng(5)
    B, H, S, dk, dv = 1, 2, 37, 16, 16
    q, k = (rng.standard_normal((B, H, S, dk)) for _ in "qk")
    k = k * np.exp(rng.uniform(-12.0, 4.0, (B, H, S, 1)))     # k * exp(i)
    v = np.concatenate([rng.standard_normal((B, H, S, dv)),
                        np.ones((B, H, S, 1)), np.zeros((B, H, S, 15))], -1)
    log_a = np.log(1 / (1 + np.exp(-rng.standard_normal((B, H, S)) - 3.0)))
    f32 = [a.astype(np.float32) for a in (q, k, v, log_a)]
    jy, jS = JSSM.chunked_la_scalar(*map(jnp.asarray, f32), 16)
    ty, tS = TSSM.chunked_la_scalar(*map(torch.from_numpy, f32), 16)
    assert tuple(tS.shape) == (B, H, dk, dv + 16)
    _close(jy, ty, 1e-5)
    _close(jS, tS, 1e-5)
    St, ys = np.zeros((B, H, dk, dv + 16)), []
    for t in range(S):
        St = np.exp(log_a[:, :, t])[..., None, None] * St + \
            k[:, :, t, :, None] * v[:, :, t, None, :]
        ys.append(np.einsum("bhkv,bhk->bhv", St, q[:, :, t]))
    _close(np.stack(ys, 2), ty, 1e-4)
    _close(St, tS, 1e-4)
    assert not tS[..., dv + 1:].any()                  # the padding rows


@pytest.mark.parametrize("norm_mag", [1.0, 300.0])
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_state_update_plain_vs_pallas_at_mlstm_like_dv(rounding, norm_mag):
    """Kernel 1's plain version against the JAX Pallas kernel in interpret
    mode at (1, 1, 128, 1040): v is [v, 1, 0 x 15], scalar decay, the
    normalizer row (1024) at ``norm_mag`` and rows 1025-1039 zero."""
    B, H, dk, dv = 1, 1, 128, 1040
    r = np.random.default_rng(int(norm_mag) + len(rounding))
    S0 = r.standard_normal((B, H, dv, dk)).astype(np.float32)
    S0[:, :, 1024] = np.abs(S0[:, :, 1024]) * norm_mag
    S0[:, :, 1025:] = 0.0
    d = (1 / (1 + np.exp(-r.standard_normal((B, H, 1)) - 3.0))
         ).astype(np.float32)
    k = (r.standard_normal((B, H, dk)) * np.exp(4.0)).astype(np.float32)
    q = r.standard_normal((B, H, dk)).astype(np.float32)
    v = np.zeros((B, H, dv), np.float32)
    v[..., :1024] = r.standard_normal((B, H, 1024))
    v[..., 1024] = 1.0
    qS = JF.mx8_quantize(jnp.asarray(S0))
    qj, yj = j_su(qS, *map(jnp.asarray, (d, k, v, q)), jnp.int32(11),
                  rounding=rounding, interpret=True)
    tq = TF.QuantizedTensor(qS.fmt, tuple(qS.shape), {
        f: torch.from_numpy(np.array(a)) for f, a in qS.payload.items()})
    qt, yt = TOPS.state_update_step(
        tq, *map(torch.from_numpy, (d, k, v, q)),
        TOPS.StateQuantConfig("mx8", rounding, "cuda"), seed=11)
    diff = _hold_mx8(qj, qt, f"{rounding} {norm_mag}")
    rows_ok = ~diff.any(axis=-1)
    yj, yt = np.asarray(yj), yt.numpy()
    np.testing.assert_allclose(yt[rows_ok], yj[rows_ok], rtol=1e-5,
                               atol=1e-5 * np.abs(yj).max())
    assert not qt.payload["mantissa"][:, :, 1025:].any()
    assert not qt.payload["micro"][:, :, 1025:].any()


def test_mlstm_decay_hook_is_scalar():
    _, tc, _, tp = _mixer("mlstm")
    u = torch.randn((2, 1, 128), generator=torch.Generator().manual_seed(0))
    _, _, _, log_f = TSSM._mlstm_gates_qkv(tp, u, u, tc)
    d = TSSM._DECAY_HOOKS["mlstm"](log_f)
    assert tuple(d.shape) == (2, TSSM._mlstm_dims(tc)[1], 1)
    assert bool(((d > 0) & (d <= 1)).all())


# ---------------------------------------------------------------------------
# (b) the model, its weights and its traffic
# ---------------------------------------------------------------------------

def _run_model(fmt):
    jcfg, tcfg, jp, tp = _pair(fmt)
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 24))
    jl, jc = jax.jit(lambda p, b: JM.prefill(p, jcfg, b))(
        jp, {"tokens": jnp.asarray(prompt, jnp.int32)})
    tl, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(prompt)})
    prefilled = (jc, tc)
    jdec = jax.jit(lambda p, t, c, L, s: JM.decode_step(p, jcfg, t, c, L, s))
    out = [(jl, tl)]
    jt, tt = jnp.argmax(jl, -1).astype(jnp.int32), torch.argmax(tl, -1)
    for i in range(N_STEPS):
        lens = np.full((2,), 24 + i, np.int32)
        jl, jc = jdec(jp, jt, jc, jnp.asarray(lens), jnp.int32(i))
        tl, tc = TM.decode_step(tp, tcfg, tt, tc, torch.from_numpy(lens),
                                seed=i)
        out.append((jl, tl))
        jt, tt = jnp.argmax(jl, -1).astype(jnp.int32), torch.argmax(tl, -1)
    return out, prefilled


def test_fp32_state_prefill_and_greedy_decode_match_jax():
    for i, (jl, tl) in enumerate(_run_model("fp32")[0]):
        _close(jl, tl, 1e-4)
        np.testing.assert_array_equal(np.asarray(jnp.argmax(jl, -1)),
                                      torch.argmax(tl, -1).numpy(),
                                      err_msg=f"step {i}")


def test_mx8_state_first_step_and_token_agreement():
    steps, (jc, tc) = _run_model("mx8")
    _close(steps[0][0], steps[0][1], 1e-4)   # the stored states not read yet
    for pos, kind in enumerate(t_smoke(ARCH).pattern):
        if kind != "mlstm":
            continue
        jq, tq = jc[pos]["S"], tc[0][pos]["S"]
        for f in ("exponent", "micro"):
            np.testing.assert_array_equal(tq.payload[f].numpy(),
                                          np.asarray(jq.payload[f])[0])
        mj = np.asarray(jq.payload["mantissa"])[0].astype(np.int32)
        mt = tq.payload["mantissa"].numpy().astype(np.int32)
        assert np.abs(mj - mt).max() <= 1 and (mj != mt).sum() <= 8, pos
    first = float(np.abs(np.asarray(steps[1][0]) - steps[1][1].numpy()).max())
    agree = np.mean([np.array_equal(np.asarray(jnp.argmax(jl, -1)),
                                    torch.argmax(tl, -1).numpy())
                     for jl, tl in steps])
    print(f"{ARCH} mx8 first decode step max |dlogit| {first:.3g}; greedy "
          f"token agreement over {len(steps)} steps: {agree:.2f}")
    assert all(np.isfinite(tl.numpy()).all() for _, tl in steps)


def test_params_from_jax_carries_xlstm_leaf_for_leaf():
    jc, tc, jp, tp = _pair()
    names = {"mlstm": {"wu", "wz", "conv_w", "conv_b", "wq", "wk", "wv",
                       "wi", "wf", "fb", "hnorm", "down"},
             "slstm": {"wx", "r", "b", "out"}}
    for pos, kind in enumerate(tc.pattern):
        mj = jp["groups"][pos]["mixer"]
        for g in range(tc.n_groups):
            mt = tp["groups"][g][pos]["mixer"]
            assert set(mt) == names[kind]
            for n in mt:
                a = np.asarray(mj[n][g])
                assert mt[n].numpy().dtype == a.dtype, (kind, n)
                np.testing.assert_array_equal(mt[n].numpy(), a)
    H, dh = TSSM._slstm_dims(tc)
    assert tuple(tp["groups"][0][7]["mixer"]["r"].shape) == (H, dh, 4 * dh)
    own = TM.init_model(tc, torch.Generator().manual_seed(0), device="cpu")
    conv, mine = (jax.tree_util.tree_leaves(t) for t in (tp, own))
    assert [tuple(a.shape) for a in conv] == [tuple(a.shape) for a in mine]
    assert [a.dtype for a in conv] == [a.dtype for a in mine]
    assert set(tp) == set(own) == {"embed", "groups", "final_norm",
                                   "lm_head"}


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("spec_k", [0, 3])
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_decode_op_plans_match_jax(size, spec_k, layout):
    jc, tc = ((j_smoke(ARCH), t_smoke(ARCH)) if size == "smoke"
              else (j_full(ARCH), t_full(ARCH)))
    je = JOPS.decode_op_plans(jc, 4, 300, layout=layout, spec_k=spec_k)
    te = TOPS.decode_op_plans(tc, 4, 300, layout=layout, spec_k=spec_k)
    n_mlstm = tc.pattern.count("mlstm") * tc.n_groups
    assert [(e.kind, e.count) for e in te] == [("state_update",
                                                n_mlstm * (spec_k + 1))]
    assert [(e.kind, e.count) for e in te] == [(e.kind, e.count) for e in je]
    for a, b in zip(je, te):
        assert b.plan.dims == a.plan.dims
        assert b.traffic.__dict__ == a.traffic.__dict__
    if size == "full":
        assert dict(te[0].plan.dims) == dict(B=4, H=4, dk=1024, dv=1040)


def test_config_matches_jax_field_for_field():
    for mine, theirs in ((t_full(ARCH), j_full(ARCH)),
                         (t_smoke(ARCH), j_smoke(ARCH))):
        for field in ("name", "n_layers", "d_model", "n_heads",
                      "n_kv_heads", "head_dim", "d_ff", "vocab_size",
                      "pattern", "ffn_kind", "norm_kind", "pos_emb",
                      "tie_embeddings", "norm_eps"):
            assert getattr(mine, field) == getattr(theirs, field), field
        for field in ("expand", "n_heads", "d_conv", "chunk"):
            assert getattr(mine.ssm, field) == getattr(theirs.ssm, field)


# ---------------------------------------------------------------------------
# (c) serving: paged == gather, the streams, spill and resume
# ---------------------------------------------------------------------------

def _pool_with(params, cfg, prompt_lens, n_slabs=5):
    pool = PagedStatePool(cfg, n_pages=4, n_slabs=n_slabs, device="cpu")
    rng = np.random.default_rng(sum(prompt_lens))
    toks = []
    for rid, n in enumerate(prompt_lens, start=1):
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, n))[None]
        logits, row = TM.prefill(params, cfg, {"tokens": prompt})
        assert pool.register(rid, pages_for(n))
        pool.insert_prefill(rid, row)
        toks.append(int(logits[0].argmax()))
    return pool, toks


def _steps(pool, params, rids, toks, lens, n_steps, seed0=1):
    out, t, L = [], np.array(toks), np.array(lens, np.int32)
    for step in range(n_steps):
        lg = pool.decode(params, rids, t, L, seed=seed0 + step)
        out.append(lg.clone())
        t = lg.argmax(-1).numpy()
        L = L + 1
    return out, t, L


def test_paged_decode_bit_identical_to_dense_gather():
    """MX8 with the ``cuda`` backend: kernels' plain versions on the CPU,
    slab mode on the paged path, dense mode over the gathered rows."""
    cfg = t_smoke(ARCH)
    assert cfg.state_quant.fmt == "mx8"
    params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    pool, toks = _pool_with(params, cfg, (9, 40))
    assert pool.page_nbytes == 0 and pool.slab_nbytes > 0
    snapshot = [p.clone() for p in pool.pools]
    runs = []
    for mode in ("gather", "paged"):
        for p, s in zip(pool.pools, snapshot):
            p.copy_(s)
        pool.decode_mode = mode
        runs.append(_steps(pool, params, [1, 2], toks, (9, 40), 3)[0]
                    + [p.clone() for p in pool.pools])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _engines(backend, **kw):
    jc, tc, jp, tp = _pair()
    base = dict(batch=2)
    if backend == "slots":
        base.update(backend="slots", cache_capacity=128)
    else:
        base.update(n_pages=4, n_slabs=5)
    base.update(kw)
    jkw = {} if backend == "slots" else dict(prefetch_window=0)
    return (JEngine(jp, jc, JServeConfig(**base, **jkw)),
            Engine(tp, tc, ServeConfig(**base)))


@pytest.mark.parametrize("backend,spec", [("slots", None), ("paged", None),
                                          ("paged", "ngram")])
def test_greedy_streams_match_jax(backend, spec):
    """fp32 state, greedy: the JAX engine's streams (prompts of 3 tokens
    or more: the JAX package cannot prefill shorter ones)."""
    kw = {} if spec is None else dict(spec=spec, spec_k=3)
    jeng, teng = _engines(backend, **kw)
    rng = np.random.default_rng(6)
    base = rng.integers(0, 512, 4)
    prompts = [np.tile(base, 3).astype(np.int32),
               rng.integers(0, 512, 12).astype(np.int32),
               rng.integers(0, 512, 3).astype(np.int32)]
    jh = [jeng.submit(p, max_new_tokens=5) for p in prompts]
    th = [teng.submit(p, max_new_tokens=5) for p in prompts]
    jeng.run()
    teng.run()
    for a, b in zip(jh, th):
        assert (a.status, a.output) == (b.status, b.output), a.rid
    js, ts = jeng.stats(), teng.stats()
    keys = ["tokens", "prefill_tokens"]
    if spec is not None:
        keys += ["proposed_tokens", "accepted_tokens", "acceptance_rate"]
        assert ts["proposed_tokens"] > 0
    for k in keys:
        assert ts[k] == js[k], k


def test_spill_and_resume_give_back_every_leaf():
    """A live request spilled (``extract_request``) and re-pinned on
    another slab (``insert_blob``): the mLSTM slab, its conv tail and the
    sLSTM's four carries come back bitwise, and the greedy stream goes on
    as the uninterrupted one does."""
    _, cfg, _, params = _pair()
    pool, toks = _pool_with(params, cfg, (7,), n_slabs=4)
    leaves = {sp.path for sp in pool.paging.specs}
    assert {("S",), ("conv",), ("c",), ("n",), ("m",), ("h",)} <= leaves
    _, t, L = _steps(pool, params, [1], toks, (7,), 2)
    snapshot = [p.clone() for p in pool.pools]
    want, _, _ = _steps(pool, params, [1], t, L, 3, seed0=3)
    for p, s in zip(pool.pools, snapshot):
        p.copy_(s)
    slab = pool.slab_of[1]
    before = [p[slab].clone() for p in pool.pools]
    sp = pool.spill(1, int(L[0]))
    for p in pool.pools:                  # the freed slab is overwritten
        p[slab] = 7
    assert pool.register(99, 1)           # another request takes a slab
    assert pool.resume(1, sp)
    new = pool.slab_of[1]
    assert new != slab
    for p, b in zip(pool.pools, before):
        assert torch.equal(p[new], b)
    got, _, _ = _steps(pool, params, [1], t, L, 3, seed0=3)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (d) 1- and 2-token prompts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2])
def test_short_prompts_pad_the_conv_tail(n):
    _, cfg, _, params = _pair("fp32", "nearest")
    tok = torch.as_tensor(np.random.default_rng(n).integers(0, 512, (2, n)))
    logits, caches = TM.prefill(params, cfg, {"tokens": tok})
    tail = cfg.ssm.d_conv - 1
    h = TL.apply_norm(params["groups"][0][0]["norm"],
                      params["embed"][tok], cfg.norm_kind, cfg.norm_eps)
    u = h @ params["groups"][0][0]["mixer"]["wu"]
    conv = caches[0][0]["conv"]
    assert tuple(conv.shape) == (2, tail, u.shape[-1])
    assert not conv[:, :tail - n].any()
    assert torch.equal(conv[:, tail - n:], u)
    # the prompt through decode_step from zeroed caches
    c = TM.init_decode_caches(cfg, 2, 128, device="cpu")
    for i in range(n):
        lg, c = TM.decode_step(params, cfg, tok[:, i], c,
                               torch.full((2,), i), seed=0)
    _close(logits, lg, 1e-5)
    t = logits.argmax(-1)
    a, _ = TM.decode_step(params, cfg, t, caches, torch.full((2,), n),
                          seed=1)
    b, _ = TM.decode_step(params, cfg, t, c, torch.full((2,), n), seed=1)
    _close(a, b, 1e-5)


# ---------------------------------------------------------------------------
# (e) the dispatch sites name their kinds; the launcher
# ---------------------------------------------------------------------------

def _bogus_site(site, cfg, params):
    gen = torch.Generator().manual_seed(0)
    x = torch.zeros((1, 1, cfg.d_model))
    layer = params["groups"][0][0]
    return {
        "init": lambda: TM._init_element(gen, cfg, "bogus", "cpu", 0),
        "forward": lambda: TM._element_forward(layer, x, cfg, "bogus",
                                               torch.zeros((1, 1))),
        "caches": lambda: TM.init_decode_caches(
            cfg.with_(pattern=("mlstm", "bogus")), 1, 128, device="cpu"),
        "decode": lambda: TM._recurrent_decode(layer["mixer"], x, {}, cfg,
                                               "bogus", 0),
        "traffic": lambda: TMT._state_dims(cfg, "bogus"),
        "traffic_slstm": lambda: TMT._state_dims(cfg, "slstm"),
    }[site]


@pytest.mark.parametrize("site", ["init", "forward", "caches", "decode",
                                  "traffic", "traffic_slstm"])
def test_unknown_mixer_kind_raises_at_every_site(site, monkeypatch):
    """``check_supported`` is opened to the unknown kind, so each site's own
    dispatch is what refuses it: no kind falls through to Mamba-2."""
    _, cfg, _, params = _pair()
    monkeypatch.setattr(TM, "_PORTED", TM._PORTED + ("bogus",))
    with pytest.raises(ValueError, match="bogus|slstm"):
        _bogus_site(site, cfg, params)()


def test_launcher_serves_xlstm_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", ARCH, "--smoke-size", "--device", "cpu",
                       "--paged", "--requests", "3", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "3 requests" in out and "pool=paged" in out
