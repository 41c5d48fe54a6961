"""The port's SPU ops against the JAX package's, on the same inputs.

Contracts (ROADMAP.md, "Parity contracts"):

* state update, plain version vs the jitted JAX op (Pallas kernel in
  interpret mode at small shapes, the jnp op at full zamba2 head shapes):
  exponent and micro bytes bitwise, mantissa mismatch rate <= 1e-5 (the
  port's scales are exact powers of two, XLA:CPU's ``exp2`` is not), and
  ``y`` to rtol 1e-5 with atol 1e-5 * max|y| on every dv row whose stored
  state matches -- a row with a differing mantissa differs in ``y`` by
  that one quantization step, and only such rows may;
* decode attention vs ``mx_attention_decode`` in interpret mode: rtol 2e-4,
  atol 2e-5, the JAX suite's own kernel tolerance;
* ``traffic(plan)``: equal for the paired backends torch<->jnp and
  cuda<->pallas.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as JOPS
from repro.core import attention_cache as JAC
from repro.core import formats as JF
from repro.kernels.mx_attention import mx_attention_decode as j_attn
from repro.kernels.mx_state_update import mx_state_update as j_su
from repro_torch import ops as TOPS
from repro_torch.core import attention_cache as TAC
from repro_torch.core import formats as TF
from repro_torch.kernels.mx_attention import mx_attention_decode

torch.set_num_threads(1)  # test workers share the cores: one thread each

BACKEND_PAIRS = {"torch": "jnp", "cuda": "pallas"}
#: kernel ops of the port whose JAX twin is no Pallas kernel: the dense MX8
#: append, which the JAX package leaves to XLA (its jnp op)
JAX_TWIN = {("kv_append", "cuda", "mx8", "dense"): "jnp"}


_FP8 = {"fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}


def _to_torch(a, fmt):
    a = np.array(a)
    if fmt in _FP8:
        return torch.from_numpy(a.view(np.uint8)).view(_FP8[fmt])
    return torch.from_numpy(a)


def _to_torch_qt(qt):
    return TF.QuantizedTensor(qt.fmt, tuple(qt.shape), {
        f: _to_torch(a, qt.fmt) for f, a in qt.payload.items()})


def _su_inputs(B, H, dk, dv, seed, mag=1.0, scalar_decay=False):
    r = np.random.default_rng(seed)
    S0 = (r.standard_normal((B, H, dv, dk)) * mag).astype(np.float32)
    d = 1 / (1 + np.exp(-r.standard_normal((B, H, 1 if scalar_decay else dk))))
    k, v, q = (r.standard_normal(s).astype(np.float32)
               for s in ((B, H, dk), (B, H, dv), (B, H, dk)))
    return S0, d.astype(np.float32), k, v, q


def _compare_state_update(qj, yj, qt, yt, ctx):
    for f in ("exponent", "micro"):
        np.testing.assert_array_equal(np.asarray(qj.payload[f]),
                                      qt.payload[f].numpy(), err_msg=f"{ctx} {f}")
    mj = np.asarray(qj.payload["mantissa"]).astype(np.int32)
    mt = qt.payload["mantissa"].numpy().astype(np.int32)
    diff = mj != mt
    assert np.abs(mj - mt).max() <= 1, ctx
    rate = diff.mean()
    assert rate <= 1e-5, f"{ctx}: mantissa mismatch rate {rate:.2e}"
    yj, yt = np.asarray(yj), yt.numpy()
    rows_ok = ~diff.any(axis=-1)                     # (B, H, dv)
    np.testing.assert_allclose(yt[rows_ok], yj[rows_ok], rtol=1e-5,
                               atol=1e-5 * np.abs(yj).max(), err_msg=ctx)
    return int(diff.sum())


@pytest.mark.parametrize("B,H,dk,dv", [(1, 2, 16, 16), (2, 3, 64, 32),
                                       (1, 2, 128, 64), (2, 8, 16, 16)])
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_state_update_plain_vs_pallas_interpret(B, H, dk, dv, rounding):
    S0, d, k, v, q = _su_inputs(B, H, dk, dv, seed=dk + dv)
    qS = JF.mx8_quantize(jnp.asarray(S0))
    qj, yj = j_su(qS, *map(jnp.asarray, (d, k, v, q)), jnp.int32(11),
                  rounding=rounding, interpret=True)
    qt, yt = TOPS.state_update_step(
        _to_torch_qt(qS), *map(torch.from_numpy, (d, k, v, q)),
        TOPS.StateQuantConfig("mx8", rounding, "torch"), seed=11)
    _compare_state_update(qj, yj, qt, yt, f"{(B, H, dk, dv)} {rounding}")


@pytest.mark.parametrize("mag", [1e-3, 1.0])
@pytest.mark.parametrize("scalar_decay", [True, False])
def test_state_update_plain_vs_jnp_full_zamba2_heads(mag, scalar_decay):
    """One step at the full zamba2-2.7b state shape (B=4, H=80, N=P=64)."""
    S0, d, k, v, q = _su_inputs(4, 80, 64, 64, seed=1, mag=mag,
                                scalar_decay=scalar_decay)
    jcfg = JOPS.StateQuantConfig("mx8", "stochastic", "jnp")
    qS = JF.mx8_quantize(jnp.asarray(S0))
    step = jax.jit(lambda s, d, k, v, q: JOPS.state_update_step(
        s, d, k, v, q, jcfg, seed=jnp.uint32(123456789)))
    qj, yj = step(qS, *map(jnp.asarray, (d, k, v, q)))
    qt, yt = TOPS.state_update_step(
        _to_torch_qt(qS), *map(torch.from_numpy, (d, k, v, q)),
        TOPS.StateQuantConfig("mx8", "stochastic", "torch"), seed=123456789)
    _compare_state_update(qj, yj, qt, yt, f"mag={mag}")


def test_state_update_chained_steps_stay_in_contract():
    """Five chained steps, each side carrying its own state forward."""
    S0, d, k, v, q = _su_inputs(2, 4, 64, 32, seed=5)
    qj = JF.mx8_quantize(jnp.asarray(S0))
    qt = _to_torch_qt(qj)
    cfg = TOPS.StateQuantConfig("mx8", "stochastic", "torch")
    for step in range(5):
        qj, yj = j_su(qj, *map(jnp.asarray, (d, k, v, q)), jnp.int32(step),
                      interpret=True)
        qt, yt = TOPS.state_update_step(qt, *map(torch.from_numpy,
                                                 (d, k, v, q)), cfg, seed=step)
        _compare_state_update(qj, yj, qt, yt, f"step {step}")


@pytest.mark.parametrize("dk", [16, 64, 320])
def test_group_ordered_dot_sums_in_kernel_order(dk):
    """The plain ``y`` of kernel 1, bitwise a float32 numpy sum in the
    kernel's order (products rounded, each 16-value group in order from 0,
    then the groups in order from 0), on values over 12 decades where the
    order shows."""
    from repro_torch.kernels.ref import group_ordered_dot
    r = np.random.default_rng(dk)
    S = (r.standard_normal((2, 3, 5, dk))
         * 10.0 ** r.integers(-6, 6, (2, 3, 5, dk))).astype(np.float32)
    q = r.standard_normal((2, 3, dk)).astype(np.float32)
    p = (S * q[:, :, None, :]).reshape(2, 3, 5, dk // 16, 16)
    part = np.zeros((2, 3, 5, dk // 16), np.float32)
    for j in range(16):
        part = part + p[..., j]
    want = np.zeros((2, 3, 5), np.float32)
    for g in range(dk // 16):
        want = want + part[..., g]
    got = group_ordered_dot(torch.from_numpy(S), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)
    exact = np.einsum("bhvk,bhk->bhv", S.astype(np.float64), q)
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-4,
                               atol=1e-6 * np.abs(S * q[:, :, None]).max())


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3", "bf16", "fp32"])
def test_state_update_other_formats_vs_jnp(fmt):
    S0, d, k, v, q = _su_inputs(2, 3, 64, 32, seed=9)
    jcfg = JOPS.StateQuantConfig(fmt, "stochastic", "jnp")
    tcfg = TOPS.StateQuantConfig(fmt, "stochastic", "torch")
    if jcfg.quantized:
        sj = JF.quantize(jnp.asarray(S0), fmt)
        st = _to_torch_qt(sj)
    else:
        sj = jnp.asarray(S0).astype(JF.jnp.bfloat16 if fmt == "bf16"
                                    else jnp.float32)
        st = torch.from_numpy(np.array(sj.astype(jnp.float32))).to(
            TF.FLOAT_DTYPES[fmt])
    step = jax.jit(lambda s, d, k, v, q: JOPS.state_update_step(
        s, d, k, v, q, jcfg, seed=jnp.uint32(7)))
    Sj, yj = step(sj, *map(jnp.asarray, (d, k, v, q)))
    St, yt = TOPS.state_update_step(st, *map(torch.from_numpy, (d, k, v, q)),
                                    tcfg, seed=7)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5 * float(jnp.abs(yj).max()))
    dj = np.asarray(JF.dequantize(Sj) if jcfg.quantized
                    else Sj.astype(jnp.float32))
    dt = (TF.dequantize(St) if tcfg.quantized else St.float()).numpy()
    # a stored value may land one quantization step apart on a rounding
    # boundary; everything else is equal
    assert (dj != dt).mean() <= 1e-3, fmt


@pytest.mark.parametrize("B,H,KVH,dh,lens", [
    (2, 4, 2, 32, (5, 200)),       # llama3.2-1b smoke: G = 2
    (2, 4, 4, 80, (129, 250)),     # zamba2 head width dk = 80
    (1, 32, 32, 80, (300,)),       # zamba2-2.7b heads
])
def test_attention_decode_plain_vs_pallas_interpret(B, H, KVH, dh, lens):
    T = 384
    r = np.random.default_rng(dh)
    q = r.standard_normal((B, H, dh)).astype(np.float32)
    K = r.standard_normal((B, T, KVH, dh)).astype(np.float32)
    V = r.standard_normal((B, T, KVH, dh)).astype(np.float32)
    lengths = np.asarray(lens, np.int32)
    qK, qV = JF.mx8_quantize(jnp.asarray(K)), JF.mx8_quantize(jnp.asarray(V))
    yj = j_attn(jnp.asarray(q), qK, qV, jnp.asarray(lengths), interpret=True)
    cache = TAC.KVCache(_to_torch_qt(qK), _to_torch_qt(qV),
                        torch.from_numpy(lengths))
    yt = TOPS.attn_decode(cache, torch.from_numpy(q),
                          TOPS.StateQuantConfig("mx8", "stochastic", "torch"))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-4,
                               atol=2e-5)


def test_plain_attention_mla_mode_vs_pallas_interpret():
    """MLA mode (values = the first ``v_width`` lanes of the key stream)
    exists in the plain version only; it matches the TPU kernel's MLA mode.
    """
    B, H, dkc, vw, T = 2, 8, 64, 32, 256
    r = np.random.default_rng(11)
    q = r.standard_normal((B, H, dkc)).astype(np.float32)
    C = JF.mx8_quantize(jnp.asarray(
        r.standard_normal((B, T, 1, dkc)).astype(np.float32)))
    lengths = np.asarray([200, 64], np.int32)
    yj = j_attn(jnp.asarray(q), C, None, jnp.asarray(lengths), v_width=vw,
                interpret=True)
    yt = mx_attention_decode(torch.from_numpy(q), _to_torch_qt(C), None,
                             torch.from_numpy(lengths), v_width=vw)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-4,
                               atol=2e-5)


def test_kv_append_payloads_match():
    """Three appended tokens, SR seeds ``seed`` and ``seed + 1``: exponent
    and micro bytes bitwise, mantissas to the MX8 contract."""
    B, T, KVH, dh = 2, 128, 2, 32
    jcfg = JOPS.StateQuantConfig("mx8", "stochastic", "jnp")
    tcfg = TOPS.StateQuantConfig("mx8", "stochastic", "torch")
    jc = JAC.init_kv_cache(B, T, KVH, dh, jcfg)
    tc = TAC.init_kv_cache(B, T, KVH, dh, tcfg)
    r = np.random.default_rng(3)
    append = jax.jit(lambda c, k, v, s: JOPS.kv_append(c, k, v, jcfg, seed=s))
    for step in range(3):
        k = r.standard_normal((B, 1, KVH, dh)).astype(np.float32)
        v = r.standard_normal((B, 1, KVH, dh)).astype(np.float32)
        seed = 0xFFFFFFFF - step          # exercises the uint32 wrap of seed+1
        jc = append(jc, jnp.asarray(k), jnp.asarray(v), jnp.uint32(seed))
        tc = TOPS.kv_append(tc, torch.from_numpy(k), torch.from_numpy(v),
                            tcfg, seed=seed)
    np.testing.assert_array_equal(np.asarray(jc.lengths), tc.lengths.numpy())
    for js, ts in ((jc.k, tc.k), (jc.v, tc.v)):
        for f in ("exponent", "micro"):
            np.testing.assert_array_equal(np.asarray(js.payload[f]),
                                          ts.payload[f].numpy())
        mj = np.asarray(js.payload["mantissa"]).astype(np.int32)
        mt = ts.payload["mantissa"].numpy().astype(np.int32)
        assert np.abs(mj - mt).max() <= 1 and (mj != mt).mean() <= 1e-5


def _paired_quadruples():
    return [q for q in TOPS.registered() if q[2] in ("mx8", "fp32", "int8")]


@pytest.mark.parametrize("kind,backend,fmt,layout", _paired_quadruples())
def test_traffic_equals_jax_registry(kind, backend, fmt, layout):
    jb = JAX_TWIN.get((kind, backend, fmt, layout), BACKEND_PAIRS[backend])
    assert (kind, jb, fmt, layout) in JOPS.registered()
    dims = dict(B=3, T=256, KVH=2, dk=64, dv=64, n=1, H=8)
    if kind == "state_update":
        dims = dict(B=3, H=80, dk=64, dv=64)
    if kind == "spec_verify":
        dims["Kq"] = 4
    jp = JOPS.get_op(kind, jb, fmt, layout).plan(
        dims, JOPS.StateQuantConfig(fmt, "stochastic", jb))
    tp = TOPS.get_op(kind, backend, fmt, layout).plan(
        dims, TOPS.StateQuantConfig(fmt, "stochastic", backend))
    assert TOPS.traffic(tp) .__dict__ == JOPS.traffic(jp).__dict__


def test_decode_op_plans_match_jax_for_zamba2():
    from repro.configs import get_config
    from repro_torch.configs import get_config as t_get_config
    jcfg, tcfg = get_config("zamba2-2.7b"), t_get_config("zamba2-2.7b")
    jt = JOPS.decode_traffic_by_kind(jcfg, 4, 1024)
    tt = TOPS.decode_traffic_by_kind(tcfg, 4, 1024)
    assert set(jt) == set(tt)
    for kind in jt:
        assert jt[kind].__dict__ == tt[kind].__dict__, kind
    counts = {e.kind: e.count for e in TOPS.decode_op_plans(tcfg, 4, 1024)}
    assert counts == {"state_update": 54, "attn_decode": 9, "kv_append": 9}


def test_cuda_backend_is_preferred_for_mx8_only():
    assert TOPS.resolve_backend("state_update", "mx8") == "cuda"
    assert TOPS.resolve_backend("attn_decode", "mx8") == "cuda"
    assert TOPS.resolve_backend("state_update", "fp32", "cuda") == "torch"
    with pytest.raises(ValueError, match="capable"):
        TOPS.resolve_backend("state_update", "fp32", "cuda", strict=True)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the kernel wrappers run their plain versions and
    launch nothing."""
    from repro_torch.kernels.mx_state_update import mx_state_update
    n0, m0 = mx_state_update.launches, mx_attention_decode.launches
    S0, d, k, v, q = _su_inputs(1, 2, 32, 16, seed=2)
    qS = TF.mx8_quantize(torch.from_numpy(S0))
    args = [torch.from_numpy(a) for a in (d, k, v, q)]
    qa, ya = mx_state_update(qS.clone(), *args, seed=4)
    qb, yb = TOPS.state_update_step(
        qS.clone(), *args, TOPS.StateQuantConfig("mx8", "stochastic", "cuda"),
        seed=4)
    assert torch.equal(qa.payload["mantissa"], qb.payload["mantissa"])
    assert torch.equal(ya, yb)
    assert (mx_state_update.launches, mx_attention_decode.launches) == (n0, m0)
