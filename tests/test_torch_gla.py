"""The port's GLA family (GLA, RetNet, HGRN2) against the JAX package's, on
the same seeded numpy inputs.

Contracts (ROADMAP.md, "Parity contracts"):

* the chunked scans (``chunked_la_vector`` for GLA / HGRN2,
  ``chunked_la_scalar`` for RetNet) at S = 37 with chunk 16, so the last
  chunk is padded: y and the final state to rtol 1e-4, atol 1e-4 * max|.|
  (both sides in fp32, the chunk products accumulated in other orders);
* ``gla_family_forward`` (output and stored fp32 state) and
  ``gla_family_decode`` (fp32 state: output and new state) per kind, the
  same tolerance; with MX8 state the decode output to rtol 1e-3, atol
  1e-3 * max|.| (a state mantissa may sit one step apart, ROADMAP.md);
* HGRN2's forget-gate lower bound ``beta = layer_idx / n_layers`` per layer;
* ``params_from_jax`` carries every GLA-family leaf exactly, in the shapes
  and dtypes the port's own ``init_model`` makes;
* ``decode_op_plans`` and ``traffic(plan)`` equal the JAX package's for the
  three ``CONFIG``s and ``SMOKE``s, dense and paged, at spec_k 0 and 3.

Model-level parity (fp32 logits and 8 greedy steps, MX8 agreement), paged
== dense-gather bitwise and the paged stream against JAX's, and greedy
speculation are cases of the parametrised tests in ``test_torch_model.py``,
``test_torch_paged_serving.py`` and ``test_torch_spec_serving.py``.
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
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro_torch import ops as TOPS
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import formats as TF
from repro_torch.models import model as TM
from repro_torch.models import ssm as TSSM
from repro_torch.models.convert import params_from_jax

KINDS = ("gla", "retnet", "hgrn2")
ARCH = {"gla": "gla-2.7b", "retnet": "retnet-2.7b", "hgrn2": "hgrn2-2.7b"}


def _close(want, got, rtol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _cfgs(kind, fmt="fp32", rounding="nearest"):
    jb, tb = ("jnp", "torch") if fmt != "mx8" else ("jnp", "cuda")
    return (j_smoke(ARCH[kind]).with_(state_quant=JOPS.StateQuantConfig(
                fmt, rounding, jb)),
            t_smoke(ARCH[kind]).with_(state_quant=TOPS.StateQuantConfig(
                fmt, rounding, tb)))


# ---------------------------------------------------------------------------
# (a) the chunked scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan", ["vector", "scalar"])
def test_chunked_scans_match_jax_on_a_padded_chunk(scan):
    rng = np.random.default_rng(0)
    B, H, S, dk, dv = 2, 3, 37, 16, 24
    q, k = (rng.standard_normal((B, H, S, dk)).astype(np.float32)
            for _ in "qk")
    v = rng.standard_normal((B, H, S, dv)).astype(np.float32)
    shape = (B, H, S, dk) if scan == "vector" else (B, H, S)
    # per-step log decays in [-1, 0): the clamp's range (log_decay_min)
    log_f = -rng.uniform(0.0, 1.0, shape).astype(np.float32)
    jfn = JSSM.chunked_la_vector if scan == "vector" else \
        JSSM.chunked_la_scalar
    tfn = TSSM.chunked_la_vector if scan == "vector" else \
        TSSM.chunked_la_scalar
    jy, jS = jfn(*(jnp.asarray(a) for a in (q, k, v, log_f)), 16)
    ty, tS = tfn(*(torch.from_numpy(a) for a in (q, k, v, log_f)), 16)
    assert tuple(ty.shape) == (B, H, S, dv) and tuple(tS.shape) == (B, H, dk,
                                                                    dv)
    _close(jy, ty, 1e-4)
    _close(jS, tS, 1e-4)


def test_chunked_vector_scan_is_the_sequential_recurrence():
    """Per-channel decay, S_t = diag(f_t) S_{t-1} + k_t v_tᵀ and
    y_t = S_tᵀ q_t, in fp64 step by step, against the chunked form."""
    rng = np.random.default_rng(1)
    B, H, S, dk, dv = 1, 2, 21, 8, 8
    q, k = (rng.standard_normal((B, H, S, dk)) for _ in "qk")
    v = rng.standard_normal((B, H, S, dv))
    log_f = -rng.uniform(0.0, 1.0, (B, H, S, dk))
    St = np.zeros((B, H, dk, dv))
    ys = []
    for t in range(S):
        St = np.exp(log_f[:, :, t])[..., None] * St + \
            k[:, :, t, :, None] * v[:, :, t, None, :]
        ys.append(np.einsum("bhkv,bhk->bhv", St, q[:, :, t]))
    y, Sf = TSSM.chunked_la_vector(*(torch.from_numpy(a.astype(np.float32))
                                     for a in (q, k, v, log_f)), 8)
    _close(np.stack(ys, 2), y, 1e-4)
    _close(St, Sf, 1e-4)


# ---------------------------------------------------------------------------
# (b) the mixer's forward and decode
# ---------------------------------------------------------------------------

def _mixer(kind, fmt="fp32"):
    jc, tc = _cfgs(kind, fmt)
    jp = JSSM.init_gla_family(jax.random.PRNGKey(3), jc, kind)
    if kind == "hgrn2":
        jp["beta"] = jnp.array([0.25], jnp.float32)
    tp = {n: torch.from_numpy(np.array(a)) for n, a in jp.items()}
    return jc, tc, jp, tp


@pytest.mark.parametrize("kind", KINDS)
def test_gla_family_forward_matches_jax(kind):
    jc, tc, jp, tp = _mixer(kind)
    x = np.random.default_rng(2).standard_normal(
        (2, 37, jc.d_model)).astype(np.float32)
    jy, js = JSSM.gla_family_forward(jp, jnp.asarray(x), jc, kind)
    ty, ts = TSSM.gla_family_forward(tp, torch.from_numpy(x), tc, kind)
    H, dk, dv = TSSM._gla_dims(tc)
    assert TSSM._gla_dims(tc) == JSSM._gla_dims(jc)
    assert tuple(ts["S"].shape) == (2, H, dv, dk)          # stored Sᵀ
    _close(jy, ty, 1e-4)
    _close(js["S"], ts["S"], 1e-4)


@pytest.mark.parametrize("fmt", ["fp32", "mx8"])
@pytest.mark.parametrize("kind", KINDS)
def test_gla_family_decode_matches_jax(kind, fmt):
    jc, tc, jp, tp = _mixer(kind, fmt)
    H, dk, dv = TSSM._gla_dims(tc)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
    S0 = (rng.standard_normal((2, H, dv, dk)) * 0.5).astype(np.float32)
    if fmt == "fp32":
        jS, tS = jnp.asarray(S0), torch.from_numpy(S0)
    else:
        jS, tS = JF.quantize(jnp.asarray(S0), "mx8"), TF.quantize(
            torch.from_numpy(S0), "mx8")
    jy, jst = JSSM.gla_family_decode(jp, jnp.asarray(x), {"S": jS}, jc, kind,
                                     jnp.uint32(5))
    ty, tst = TSSM.gla_family_decode(tp, torch.from_numpy(x), {"S": tS}, tc,
                                     kind, 5)
    assert tuple(ty.shape) == (2, 1, jc.d_model)
    if fmt == "fp32":
        _close(jy, ty, 1e-4)
        _close(jst["S"], tst["S"], 1e-4)
    else:
        _close(jy, ty, 1e-3)
        for f in ("exponent", "micro"):
            np.testing.assert_array_equal(tst["S"].payload[f].numpy(),
                                          np.asarray(jst["S"].payload[f]))


def test_vector_decay_hooks_feed_per_channel_and_retnet_scalar():
    for kind, width in (("gla", 32), ("hgrn2", 32), ("retnet", 1)):
        jc, tc, jp, tp = _mixer(kind)
        x = torch.randn((2, 1, tc.d_model),
                        generator=torch.Generator().manual_seed(0))
        _, _, _, log_f = TSSM._gla_family_qkv(tp, x, tc, kind)
        d = TSSM._DECAY_HOOKS[kind](log_f)
        assert tuple(d.shape) == (2, TSSM._gla_dims(tc)[0], width), kind
        assert bool(((d > 0) & (d <= 1)).all()), kind


# ---------------------------------------------------------------------------
# (c) HGRN2 beta, params_from_jax
# ---------------------------------------------------------------------------

def test_hgrn2_beta_grows_with_depth():
    jc, tc = _cfgs("hgrn2")
    want = [i / tc.n_layers for i in range(tc.n_layers)]
    own = TM.init_model(tc, torch.Generator().manual_seed(0), device="cpu")
    got = [float(own["groups"][g][0]["mixer"]["beta"][0])
           for g in range(tc.n_groups)]
    jp = JM.init_model(jax.random.PRNGKey(0), jc)
    jbeta = np.asarray(jp["groups"][0]["mixer"]["beta"])[:, 0].tolist()
    assert got == want == jbeta


@pytest.mark.parametrize("kind", KINDS)
def test_params_from_jax_carries_the_gla_family(kind):
    jc, tc = _cfgs(kind)
    jp = JM.init_model(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    names = {"gla": ("wga", "wgb", "gb"), "hgrn2": ("wf", "fb", "beta"),
             "retnet": ()}[kind]
    for g in range(tc.n_groups):
        mj, mt = jp["groups"][0]["mixer"], tp["groups"][g][0]["mixer"]
        assert set(mt) == {"wq", "wk", "wv", "wg_out", "wo", *names}
        for n in mt:
            np.testing.assert_array_equal(mt[n].numpy(), np.asarray(mj[n][g]))
    own = TM.init_model(tc, torch.Generator().manual_seed(0), device="cpu")
    conv, mine = (jax.tree_util.tree_leaves(t) for t in (tp, own))
    assert [tuple(a.shape) for a in conv] == [tuple(a.shape) for a in mine]
    assert [a.dtype for a in conv] == [a.dtype for a in mine]


# ---------------------------------------------------------------------------
# (d) decode-op plans and traffic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("spec_k", [0, 3])
@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("kind", KINDS)
def test_decode_op_plans_match_jax(kind, size, spec_k, layout):
    jc, tc = (j_smoke(ARCH[kind]), t_smoke(ARCH[kind])) if size == "smoke" \
        else (j_full(ARCH[kind]), t_full(ARCH[kind]))
    je = JOPS.decode_op_plans(jc, 4, 300, layout=layout, spec_k=spec_k)
    te = TOPS.decode_op_plans(tc, 4, 300, layout=layout, spec_k=spec_k)
    assert [(e.kind, e.count) for e in te] == [("state_update",
                                                tc.n_layers * (spec_k + 1))]
    assert [(e.kind, e.count) for e in te] == [(e.kind, e.count) for e in je]
    for a, b in zip(je, te):
        assert b.plan.dims == a.plan.dims
        assert b.traffic.__dict__ == a.traffic.__dict__, a.kind
