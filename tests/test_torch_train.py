"""The port's training path against the JAX package, on the CPU, at SMOKE
size: the data pipeline, the chunked cross-entropy, the flash backward,
``train_loss`` and its gradient, remat, AdamW and the train step.

Contracts:

* ``batch(step)`` bitwise the JAX pipeline's (lm, vlm, audio; host slices);
* ``train_loss`` to rtol 1e-5 and every gradient leaf allclose at rtol 1e-4,
  atol 1e-5 * max|g| of that leaf, against ``jax.value_and_grad(
  repro.models.model.train_loss)`` on the same weights (JAX -> numpy ->
  ``params_from_jax``) and the same ``make_batch_fn(cfg, 32, 2)(0)``:
  gradients at smollm-360m (attention, tied embeddings), zamba2-2.7b
  (Mamba-2 + the shared block), gla-2.7b and deepseek-v2-236b (MLA + MoE
  + a prelude); the loss alone at opt-6.7b (LayerNorm, learned
  positions), hgrn2-2.7b, retnet-2.7b, paligemma-3b (the patch prefix),
  hubert-xlarge (audio frames, the masked objective) and xlstm-1.3b.
  xlstm-1.3b's model gradient sits below fp32's conditioning at this
  size -- a 1e-7 relative perturbation of the port's own weights moves
  its gradient up to 6.4x that tolerance (measured) -- so the mLSTM's
  and the sLSTM's gradients are held to it one mixer at a time;
* the flash ``Function``'s dq, dk, dv equal to ``jax.grad`` through the JAX
  package's custom VJP (causal, causal with a prefix, non-causal) and to
  autograd through the plain loop; MLA's shared ``kv`` gets both paths;
  under ``no_grad`` the forward is bitwise the plain loop (prefill
  unchanged);
* remat on and off give bitwise the same gradients; a training forward
  stores no state, builds no KV cache and calls no quantizer;
* AdamW leaf for leaf to rtol 2e-6 (``global_norm`` sums its leaves in
  another order: the port's groups are unstacked), the decay rule leaf for
  leaf on all fifteen configs, the schedule, two train steps (the losses
  to rtol 1e-5; the weights as ``test_two_train_steps_match_jax`` says:
  Adam moves a weight whose gradient is ~0 by up to lr on fp32 noise),
  and ``grad_accum=2`` against one batch (JAX's own 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as J_ARCHS
from repro.configs import get_smoke_config as j_smoke
from repro.data import pipeline as JD
from repro.models import attention as JATT
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro.train import optimizer as JO
from repro.train.train_loop import make_train_step as j_make_train_step
from repro_torch.configs import ALL_ARCHS
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import tree as T
from repro_torch.data import pipeline as TD
from repro_torch.models import attention as TATT
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import ssm as TSSM
from repro_torch.models.convert import params_from_jax
from repro_torch.train import optimizer as TO
from repro_torch.train.train_loop import batch_to_device, make_train_step

torch.set_num_threads(1)  # test workers share the cores: one thread each

GRAD_ARCHS = ("smollm-360m", "zamba2-2.7b", "gla-2.7b", "deepseek-v2-236b")
LOSS_ARCHS = ("opt-6.7b", "hgrn2-2.7b", "retnet-2.7b", "paligemma-3b",
              "hubert-xlarge", "xlstm-1.3b")
SEQ, BATCH = 32, 2
_CACHE = {}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_layout(tparams, arch):
    """The port's parameters in the JAX package's layout, as numpy: each
    pattern position's leaves stacked over the groups, the prelude and
    the groups as tuples.  Its tree structure is checked against
    ``eval_shape`` of the JAX init, and ``params_from_jax`` takes it back
    to the port's tree bitwise."""
    cfg = t_smoke(arch)
    np_tree = lambda t: T.tree_map(lambda a: a.detach().numpy(), t)
    out = {k: np_tree(v) for k, v in tparams.items()
           if k not in ("groups", "prelude")}
    out["groups"] = tuple(
        jax.tree.map(lambda *xs: np.stack(xs),
                     *[np_tree(tparams["groups"][g][pos])
                       for g in range(cfg.n_groups)])
        for pos in range(len(cfg.pattern)))
    if cfg.prelude:
        out["prelude"] = tuple(np_tree(p) for p in tparams["prelude"])
    shapes = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0),
                                                  j_smoke(arch)))
    assert jax.tree.structure(shapes) == jax.tree.structure(out)
    assert all(a.shape == b.shape for a, b in zip(jax.tree.leaves(shapes),
                                                  jax.tree.leaves(out)))
    back = params_from_jax(out, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(back),
                                                 T.leaves(tparams)))
    return out


def _jax_case(arch, grads=True):
    """(the weights in the JAX layout, the batch, JAX loss, JAX grads as
    numpy or None), one jit per arch and kind, shared by the tests.  The
    weights are the port's seeded init carried into the JAX layout: the
    JAX package's eager init costs 1-4.6 s an arch on this CPU, more than
    this file's budget allows (the same numbers reach both packages
    either way)."""
    key = (arch, grads)
    if key not in _CACHE:
        cfg = j_smoke(arch)
        params = _jax_layout(TM.init_model(
            t_smoke(arch), torch.Generator().manual_seed(0), device="cpu"),
            arch)
        batch = JD.make_batch_fn(cfg, SEQ, BATCH)(0)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        if grads:
            loss, g = jax.jit(jax.value_and_grad(JM.train_loss),
                              static_argnums=1)(params, cfg, jb)
            g = _np_tree(g)
        else:
            loss, g = jax.jit(JM.train_loss, static_argnums=1)(params, cfg,
                                                               jb), None
        _CACHE[key] = (params, batch, float(loss), g)
    return _CACHE[key]


def _port_loss_and_grads(params, cfg, batch):
    leaves = [p.detach().requires_grad_(True) for p in T.leaves(params)]
    loss = TM.train_loss(T.unflatten(params, leaves), cfg,
                         batch_to_device(batch, "cpu"))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    paths = [p for p, _ in T.leaves_with_paths(params)]
    return float(loss.detach()), dict(zip(paths, grads))


def _grad_ratios(got, want):
    """Worst |got - want| / (1e-4 |want| + 1e-5 max|want|) per leaf path
    (at most 1 where the contract holds)."""
    out = {}
    for path, w in T.leaves_with_paths(want):
        g = got[path]
        bound = 1e-4 * w.abs() + 1e-5 * float(w.abs().max())
        out[path] = float(((g - w).abs() / bound.clamp(min=1e-30)).max())
    return out


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-360m", "paligemma-3b",
                                  "hubert-xlarge"])
def test_batches_are_bitwise_jax(arch):
    """lm, vlm (patches before the text) and audio (frames, the 8 % mask)."""
    want_fn = JD.make_batch_fn(j_smoke(arch), 96, 4, seed=3)
    got_fn = TD.make_batch_fn(t_smoke(arch), 96, 4, seed=3)
    for step in (0, 7):
        want, got = want_fn(step), got_fn(step)
        assert sorted(want) == sorted(got)
        for k in want:
            assert want[k].dtype == got[k].dtype
            np.testing.assert_array_equal(want[k], got[k])


def test_host_slices_are_bitwise_jax():
    jcfg = JD.DataConfig(seq_len=130, global_batch=8, vocab_size=100)
    tcfg = TD.DataConfig(seq_len=130, global_batch=8, vocab_size=100)
    want, got = JD.SyntheticLM(jcfg), TD.SyntheticLM(tcfg)
    for host in range(4):
        a, b = want.batch(5, host, 4), got.batch(5, host, 4)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="does not split"):
        got.batch(0, 0, 3)


# ---------------------------------------------------------------------------
# train_loss and its gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_grads_match_jax(arch):
    jparams, batch, jloss, jgrads = _jax_case(arch)
    cfg = t_smoke(arch)
    loss, grads = _port_loss_and_grads(
        params_from_jax(jparams, cfg, device="cpu"), cfg, batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    want = params_from_jax(jgrads, cfg, device="cpu")
    ratios = _grad_ratios(grads, want)
    worst = max(ratios, key=ratios.get)
    print(f"{arch}: worst gradient ratio {ratios[worst]:.3f} at {worst}")
    assert ratios[worst] <= 1.0, (worst, ratios[worst])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_mixer_grads_match_jax(kind):
    """The mLSTM and the sLSTM alone (xlstm-1.3b's smoke widths, 32
    positions): the output's and every parameter's and input's gradient
    under the contract above."""
    jcfg, cfg = j_smoke("xlstm-1.3b"), t_smoke("xlstm-1.3b")
    jfwd = JSSM.mlstm_forward if kind == "mlstm" else JSSM.slstm_forward
    tfwd = TSSM.mlstm_forward if kind == "mlstm" else TSSM.slstm_forward
    p = {k: v.numpy() for k, v in TSSM.mixer(kind).init(
        torch.Generator().manual_seed(1), cfg, "cpu").items()}
    r = np.random.default_rng(len(kind))
    x = r.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    w = r.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    want = jax.jit(jax.grad(lambda p, x: jnp.sum(jfwd(p, x, jcfg)[0] * w),
                            argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, state = tfwd(tp, tx, cfg, want_cache=False)
    assert state is None
    names = sorted(tp)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(),
                              [tp[k] for k in names] + [tx])
    wants = [want[0][k] for k in names] + [want[1]]
    ratios = _grad_ratios({(k,): g for k, g in zip(names + ["x"], got)},
                          {k: torch.from_numpy(np.array(a))
                           for k, a in zip(names + ["x"], wants)})
    print(f"{kind}: worst gradient ratio {max(ratios.values()):.3f}")
    assert max(ratios.values()) <= 1.0, ratios


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_matches_jax(arch):
    jparams, batch, jloss, _ = _jax_case(arch, grads=False)
    cfg = t_smoke(arch)
    with torch.no_grad():
        loss = TM.train_loss(params_from_jax(jparams, cfg, device="cpu"),
                             cfg, batch_to_device(batch, "cpu"))
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)


def _masked_sum_xent(x, lm_head, labels, mask, chunk):
    """The JAX package's gold logit, a masked sum over the vocabulary."""
    tot = cnt = 0.0
    for s in range(0, x.shape[1], chunk):
        logits = (x[:, s:s + chunk] @ lm_head).float()
        ids = torch.arange(logits.shape[-1])
        gold = torch.where(ids == labels[:, s:s + chunk, None], logits,
                           0.0).sum(-1)
        nll = (torch.logsumexp(logits, -1) - gold) * mask[:, s:s + chunk]
        tot, cnt = tot + nll.sum(), cnt + mask[:, s:s + chunk].sum()
    return tot / max(cnt, 1.0)


def test_chunked_xent_gather_is_the_masked_sum_bitwise():
    """37 positions in chunks of 16 (padded to 48): the gather's loss and
    gradients bitwise the masked sum's, and the loss to rtol 1e-6 of the
    JAX function's."""
    r = np.random.default_rng(2)
    x = r.standard_normal((2, 37, 24)).astype(np.float32)
    w = (r.standard_normal((24, 300)) * 0.3).astype(np.float32)
    labels = r.integers(0, 300, (2, 37))
    mask = (r.random((2, 37)) < 0.7).astype(np.float32)
    outs = []
    for fn in (TL.chunked_softmax_xent, None):
        xt = torch.from_numpy(x).requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        lt, mt = torch.from_numpy(labels), torch.from_numpy(mask)
        if fn is None:
            pad = lambda a: torch.nn.functional.pad(
                a, (0, 0, 0, 11) if a.dim() == 3 else (0, 11))
            loss = _masked_sum_xent(pad(xt), wt, pad(lt), pad(mt), 16)
        else:
            loss = fn(xt, wt, lt, mt, chunk=16)
        outs.append((loss,) + torch.autograd.grad(loss, (xt, wt)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    want = JL.chunked_softmax_xent(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(labels), jnp.asarray(mask), 16)
    np.testing.assert_allclose(float(outs[0][0].detach()), float(want),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# the flash backward
# ---------------------------------------------------------------------------

def _plain_blockwise(q, k, v, causal, prefix_len, q_chunk, kv_chunk):
    """The blockwise forward loop as it stood before the flash backward,
    differentiated by autograd through every chunk."""
    B, S, H, dh = q.shape
    KVH, dv = k.shape[2], v.shape[-1]
    G = H // KVH
    nq, nk = S // q_chunk, S // kv_chunk
    qb = (q * dh ** -0.5).reshape(B, nq, q_chunk, KVH, G, dh)
    qb = qb.permute(1, 0, 3, 4, 2, 5)
    kb = k.reshape(B, nk, kv_chunk, KVH, dh).permute(1, 0, 3, 2, 4)
    vb = v.reshape(B, nk, kv_chunk, KVH, dv).permute(1, 0, 3, 2, 4)
    outs = []
    for qi in range(nq):
        m = torch.full((B, KVH, G, q_chunk, 1), TATT.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KVH, G, q_chunk, dv))
        for kj in range(nk):
            s = torch.einsum("bngqd,bnkd->bngqk", qb[qi], kb[kj])
            if causal:
                s = TATT._mask_chunk(s, qi, kj, q_chunk, kv_chunk, prefix_len)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bngqk,bnkv->bngqv", p, vb[kj])
            m = m_new
        outs.append(acc / l.clamp(min=1e-30))
    return torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, S, H, dv)


MODES = {"causal": (True, 0), "prefix": (True, 11), "noncausal": (False, 0)}


def _qkv(seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((2, 32, 4, 16)).astype(np.float32)
    k = r.standard_normal((2, 32, 2, 16)).astype(np.float32)
    v = r.standard_normal((2, 32, 2, 24)).astype(np.float32)
    dout = r.standard_normal((2, 32, 4, 24)).astype(np.float32)
    return q, k, v, dout


@pytest.mark.parametrize("mode", sorted(MODES))
def test_flash_function_grads_match_jax_and_the_plain_loop(mode):
    """G = 2, 32 positions in chunks of 8 (q_chunk = kv_chunk < S)."""
    causal, prefix_len = MODES[mode]
    kw = dict(causal=causal, prefix_len=prefix_len, q_chunk=8, kv_chunk=8)
    q, k, v, dout = _qkv(len(mode))
    want = jax.grad(lambda a, b, c: jnp.sum(JATT.blockwise_attention(
        a, b, c, **kw) * dout), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = torch.autograd.grad(
        (TATT.blockwise_attention(*ts, **kw) * torch.from_numpy(dout)).sum(),
        ts)
    plain = torch.autograd.grad(
        (_plain_blockwise(*ts, causal, prefix_len, 8, 8)
         * torch.from_numpy(dout)).sum(), ts)
    for w, g, p in zip(want, got, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(p.abs().max()))


def test_flash_mla_shared_kv_gets_both_gradients():
    """MLA passes one latent ``kv`` as K and its first lanes as V: its
    gradient is the sum of both paths, as through the JAX custom VJP."""
    r = np.random.default_rng(5)
    q = r.standard_normal((1, 16, 4, 20)).astype(np.float32)
    kv = r.standard_normal((1, 16, 1, 20)).astype(np.float32)
    dout = r.standard_normal((1, 16, 4, 12)).astype(np.float32)
    kw = dict(causal=True, q_chunk=4, kv_chunk=4, scale=0.3)
    want = jax.grad(lambda a, c: jnp.sum(JATT.blockwise_attention(
        a, c, c[..., :12], **kw) * dout), argnums=1)(jnp.asarray(q),
                                                     jnp.asarray(kv))
    qt = torch.from_numpy(q)
    kvt = torch.from_numpy(kv).requires_grad_(True)
    dt = torch.from_numpy(dout)
    (got,) = torch.autograd.grad(
        (TATT.blockwise_attention(qt, kvt, kvt[..., :12], **kw) * dt).sum(),
        kvt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    k2, v2 = (kvt.detach().clone().requires_grad_(True) for _ in range(2))
    gk, gv = torch.autograd.grad(
        (TATT.blockwise_attention(qt, k2, v2[..., :12], **kw) * dt).sum(),
        (k2, v2))
    torch.testing.assert_close(got, gk + gv, rtol=0, atol=0)
    assert float(gv[..., 12:].abs().max()) == 0.0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_blockwise_attention_no_grad_is_bitwise_the_plain_loop(mode):
    """The prefill's attention did not change: under ``no_grad`` the
    Function's forward is bitwise the plain loop, at several chunks."""
    causal, prefix_len = MODES[mode]
    q, k, v, _ = _qkv(7)
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    with torch.no_grad():
        for c in (8, 16, 32):
            got = TATT.blockwise_attention(*ts, causal=causal,
                                           prefix_len=prefix_len,
                                           q_chunk=c, kv_chunk=c)
            assert torch.equal(got, _plain_blockwise(*ts, causal, prefix_len,
                                                     c, c))


# ---------------------------------------------------------------------------
# remat and the cache-free forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["zamba2-2.7b", "deepseek-v2-236b"])
def test_remat_on_and_off_give_bitwise_the_same_grads(arch):
    """Nested checkpoints (each group, each element, the shared block)
    recompute exactly what they dropped."""
    jparams, batch, _, _ = _jax_case(arch)
    cfg = t_smoke(arch)
    assert cfg.remat
    params = params_from_jax(jparams, cfg, device="cpu")
    on = _port_loss_and_grads(params, cfg, batch)
    off = _port_loss_and_grads(params, cfg.with_(remat=False), batch)
    assert on[0] == off[0]
    assert all(torch.equal(on[1][p], off[1][p]) for p in on[1])


def test_scalar_scan_backward_stays_finite_under_strong_decay():
    """Log decays of up to -100 a step overflow exp() above a chunk's
    diagonal; those entries are masked, and their backward must stay
    finite (it was NaN): the chunked gradient equals the one-position
    chunks' (no upper triangle) to rtol 1e-5 of the largest."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 32, 8), generator=g).requires_grad_(True)
               for _ in range(3))
    log_a = (-100 * torch.rand((1, 2, 32), generator=g)).requires_grad_(True)

    def grads(chunk):
        y, state = TSSM.chunked_la_scalar(q, k, v, log_a, chunk)
        return torch.autograd.grad(y.sum() + state.sum(), (q, k, v, log_a))
    for a, b in zip(grads(16), grads(1)):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


def test_training_forward_builds_no_cache(monkeypatch):
    """``want_cache=False``: no ``_store_state``, no ``_build_kv_cache``,
    no quantizer (so no stochastic-rounding seed); prefill, the control,
    calls each."""
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_quant as K7
    calls = dict.fromkeys(("store", "kv", "quantize", "store_quantized",
                           "streams"), 0)

    def counted(name, fn):
        def inner(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return inner
    monkeypatch.setattr(TSSM, "_store_state",
                        counted("store", TSSM._store_state))
    monkeypatch.setattr(TM, "_build_kv_cache",
                        counted("kv", TM._build_kv_cache))
    monkeypatch.setattr(F, "quantize", counted("quantize", F.quantize))
    monkeypatch.setattr(TSSM, "store_quantized",
                        counted("store_quantized", K7.store_quantized))
    monkeypatch.setattr(TM, "mx_quantize_streams",
                        counted("streams", K7.mx_quantize_streams))
    for arch in ("zamba2-2.7b", "deepseek-v2-236b", "xlstm-1.3b",
                 "gla-2.7b"):
        cfg = t_smoke(arch)
        params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        batch = batch_to_device(TD.make_batch_fn(cfg, 16, 1)(0), "cpu")
        _port_loss_and_grads(params, cfg, TD.make_batch_fn(cfg, 16, 1)(0))
        assert calls == dict.fromkeys(calls, 0), (arch, calls)
        TM.prefill(params, cfg, {"tokens": batch["tokens"]})
        assert calls["store"] + calls["kv"] > 0, arch
        assert calls["store_quantized"] + calls["streams"] > 0, arch
        calls.update(dict.fromkeys(calls, 0))


# ---------------------------------------------------------------------------
# AdamW, the schedule, the train step
# ---------------------------------------------------------------------------

def test_adamw_update_matches_jax():
    """smollm's JAX gradients, from a fresh state and again from the
    state one step later (moments nonzero)."""
    jparams, _, _, jgrads = _jax_case("smollm-360m")
    cfg = t_smoke("smollm-360m")
    opt = JO.OptimizerConfig(lr=1e-2, warmup_steps=1, weight_decay=0.1,
                             clip_norm=0.5)
    topt = TO.OptimizerConfig(**vars(opt))
    jp = jax.tree.map(jnp.asarray, jparams)
    jg = jax.tree.map(jnp.asarray, jgrads)
    js = JO.init_opt_state(jp, opt)
    conv = lambda tree: params_from_jax(_np_tree(tree), cfg, device="cpu")
    tp, tg = conv(jp), conv(jg)
    ts = TO.init_opt_state(tp, topt)
    jstep = jax.jit(JO.adamw_update, static_argnums=3)
    for _ in range(2):
        jp, js, jm = jstep(jp, jg, js, opt)
        tp, ts, tm = TO.adamw_update(tp, tg, ts, topt)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert int(ts["step"]) == int(js["step"])
        assert ts["step"].dtype == torch.int32
        for name, want, got in (("params", jp, tp), ("m", js["m"], ts["m"]),
                                ("v", js["v"], ts["v"])):
            for (path, w), g in zip(T.leaves_with_paths(conv(want)),
                                    T.leaves(got)):
                np.testing.assert_allclose(
                    g.numpy(), w.numpy(), rtol=2e-6,
                    atol=2e-6 * float(w.abs().max()), err_msg=f"{name} {path}")


def _jax_leaf_name(path):
    """A JAX parameter path with the stacked group axis gone, as the port
    names its leaves (``groups/<pos>/...``)."""
    out = []
    for k in path:
        out.append(k.key if hasattr(k, "key") else k.idx)
    return tuple(out)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decay_mask_picks_the_jax_leaves(arch):
    """On every config: the port's rule on its (meta) tree, every group,
    against the JAX rule on ``eval_shape``'s paths."""
    assert set(ALL_ARCHS) == set(J_ARCHS)
    shapes = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0),
                                                  j_smoke(arch)))
    want = {_jax_leaf_name(p): JO._decay_mask(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    meta = TM.init_model(t_smoke(arch), torch.Generator().manual_seed(0),
                         device="meta")
    got = {}
    for path, _ in T.leaves_with_paths(meta):
        name = path[:1] + path[2:] if path[0] == "groups" else path
        got.setdefault(name, set()).add(TO._decay_mask(path))
    assert sorted(got) == sorted(want)
    assert {k: {v} for k, v in want.items()} == got
    assert any(want.values()) and not all(want.values())


def test_schedule_matches_jax():
    opt = JO.OptimizerConfig(lr=3e-4, warmup_steps=10, total_steps=200)
    topt = TO.OptimizerConfig(**vars(opt))
    for step in (0, 5, 10, 77, 200, 250):
        want = float(JO.schedule(opt, jnp.asarray(step, jnp.int32)))
        got = float(TO.schedule(topt, torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=0), step
    assert float(TO.schedule(topt, torch.tensor(0))) == 0.0


def test_two_train_steps_match_jax():
    """smollm-360m: two ``make_train_step`` steps (loss, AdamW) from the
    same weights on the pipeline's steps 0 and 1."""
    jparams, _, _, _ = _jax_case("smollm-360m")
    jcfg, cfg = j_smoke("smollm-360m"), t_smoke("smollm-360m")
    opt = JO.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch_fn = JD.make_batch_fn(jcfg, SEQ, BATCH)
    jstep = jax.jit(j_make_train_step(jcfg, opt))
    jp = jax.tree.map(jnp.asarray, jparams)
    js = JO.init_opt_state(jp, opt)
    tstep = make_train_step(cfg, TO.OptimizerConfig(**vars(opt)))
    tp = params_from_jax(jparams, cfg, device="cpu")
    ts = TO.init_opt_state(tp, TO.OptimizerConfig(**vars(opt)))
    for step in range(2):
        jp, js, jm = jstep(jp, js, batch_fn(step))
        tp, ts, tm = tstep(tp, ts, batch_fn(step))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    # Adam steps a weight whose gradient is near 0 by about g / |g| of a
    # gradient known to fp32 rounding, up to lr a step: every weight within
    # that of JAX's, all but 1e-3 of each leaf's to rtol / atol 1e-5
    want = params_from_jax(_np_tree(jp), cfg, device="cpu")
    for (path, w), g in zip(T.leaves_with_paths(want), T.leaves(tp)):
        diff = (g - w).abs()
        assert float(diff.max()) <= 2 * opt.lr * 1.01, path
        off = diff > 1e-5 * w.abs() + 1e-5 * float(w.abs().max())
        assert int(off.sum()) <= 1e-3 * w.numel(), (path, int(off.sum()))


def test_grad_accum_two_equals_one_batch():
    """The JAX package's own contract (``test_substrates.py``): loss and
    parameters within 1e-5."""
    cfg = t_smoke("smollm-360m")
    opt = TO.OptimizerConfig(lr=1e-3, warmup_steps=0)
    params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    st = TO.init_opt_state(params, opt)
    b = TD.make_batch_fn(cfg, seq_len=32, global_batch=4)(0)
    p1, _, m1 = make_train_step(cfg, opt)(params, st, b)
    p2, _, m2 = make_train_step(cfg, opt, grad_accum=2)(params, st, b)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
    d = max(float((a - c).abs().max())
            for a, c in zip(T.leaves(p1), T.leaves(p2)))
    assert d < 1e-5
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, opt, grad_accum=3)(params, st, b)
