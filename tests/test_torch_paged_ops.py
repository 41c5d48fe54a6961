"""The port's ``layout="paged"`` SPU ops against the JAX package's, on the
same inputs (Pallas kernels in interpret mode, and the ``jnp`` ops).

Contracts (ROADMAP.md, "Parity contracts"):

* paged decode attention: rtol 2e-4, atol 2e-5 (``tests/test_kernels.py``);
* paged KV append: exponent and micro bytes bitwise, mantissas off by at
  most one step at a mismatch rate <= 1e-5, every byte outside the
  appended slots untouched; fp32 pools exactly equal;
* paged state update: the dense op's contract on the slab rows (exponent
  and micro bitwise, mantissa mismatch <= 1e-5, ``y`` to rtol 1e-5 with
  atol 1e-5 * max|y| on rows whose state matches), other slabs untouched;
* the port's kernel wrappers take their plain versions on CPU tensors and
  launch nothing; slab mode equals the dense call on the gathered rows
  bitwise, and paged attention equals dense attention over the gathered
  pages bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as JOPS
from repro.core import formats as JF
from repro.core import paged as JPG
from repro.kernels.mx_paged_attention import \
    mx_paged_attention_decode as j_pattn
from repro_torch import ops as TOPS
from repro_torch.core import formats as TF
from repro_torch.core import paged as TPG
from repro_torch.kernels import mx_attention as KA
from repro_torch.kernels import mx_paged_attention as KP
from repro_torch.kernels import mx_state_update as KS
from repro_torch.kernels import ref as R

P, G, KVH, D, H = 9, 3, 2, 32, 4
LENGTHS = (1, 127, 128, 129)
BT = np.array([[5, 7, 0, 0], [2, 4, 0, 0], [6, 1, 0, 0], [3, 8, 0, 0]],
              np.int32)                   # shuffled pages, bucketed tail 0


def _to_torch_qt(qt):
    return TF.QuantizedTensor(qt.fmt, tuple(qt.shape), {
        f: torch.from_numpy(np.array(a)) for f, a in qt.payload.items()})


def _pools(seed, fmt="mx8"):
    r = np.random.default_rng(seed)
    k, v = (r.standard_normal((P, G, 128, KVH, D)).astype(np.float32)
            for _ in "kv")
    if fmt == "fp32":
        return ((jnp.asarray(k), jnp.asarray(v)),
                (torch.from_numpy(k), torch.from_numpy(v)))
    jk, jv = JF.mx8_quantize(jnp.asarray(k)), JF.mx8_quantize(jnp.asarray(v))
    return (jk, jv), (_to_torch_qt(jk), _to_torch_qt(jv))


def _torch_cfg(fmt, backend):
    return TOPS.StateQuantConfig(fmt, "stochastic", backend)


@pytest.mark.parametrize("jax_backend", ["pallas", "jnp"])
@pytest.mark.parametrize("group", [0, 2])
def test_paged_attention_plain_vs_jax(jax_backend, group):
    (jk, jv), (tk, tv) = _pools(seed=group)
    q = np.random.default_rng(9).standard_normal((4, H, D)).astype(np.float32)
    lens = np.asarray(LENGTHS, np.int32)
    if jax_backend == "pallas":
        yj = j_pattn(jnp.asarray(q), jk, jv, jnp.asarray(BT), group,
                     jnp.asarray(lens), interpret=True)
    else:
        jc = JPG.PagedKVCache(jk, jv, jnp.asarray(BT), jnp.asarray(lens),
                              jnp.int32(group), "mx8")
        yj = JOPS.attn_decode(jc, jnp.asarray(q), JOPS.StateQuantConfig(
            "mx8", "stochastic", "jnp"))
    tc = TPG.PagedKVCache(tk, tv, torch.from_numpy(BT),
                          torch.from_numpy(lens), group, "mx8")
    for backend in ("torch", "cuda"):      # cuda on CPU: the plain version
        yt = TOPS.attn_decode(tc, torch.from_numpy(q),
                              _torch_cfg("mx8", backend))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-4,
                                   atol=2e-5, err_msg=backend)


def test_paged_attention_fp32_vs_jnp_and_equals_dense_on_gathered_pages():
    (jk, jv), (tk, tv) = _pools(seed=4, fmt="fp32")
    q = np.random.default_rng(1).standard_normal((4, H, D)).astype(np.float32)
    lens = np.asarray(LENGTHS, np.int32)
    jc = JPG.PagedKVCache(jk, jv, jnp.asarray(BT), jnp.asarray(lens),
                          jnp.int32(1), "fp32")
    yj = JOPS.attn_decode(jc, jnp.asarray(q),
                          JOPS.StateQuantConfig("fp32", "nearest", "jnp"))
    tc = TPG.PagedKVCache(tk, tv, torch.from_numpy(BT),
                          torch.from_numpy(lens), 1, "fp32")
    yt = TOPS.attn_decode(tc, torch.from_numpy(q),
                          _torch_cfg("fp32", "torch"))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-4,
                               atol=2e-5)
    # mx8: the kernel's plain version is the dense plain version over the
    # gathered pages, bit for bit
    _, (qk, qv) = _pools(seed=5)
    bt, lt = torch.from_numpy(BT), torch.from_numpy(lens)
    yp = KP.mx_paged_attention_decode(torch.from_numpy(q), qk, qv, bt, 2, lt)
    yd = KA.mx_attention_decode(torch.from_numpy(q),
                                R.gather_pages(qk, bt, 2),
                                R.gather_pages(qv, bt, 2), lt)
    assert torch.equal(yp, yd)


def _append_pools(fmt):
    if fmt == "fp32":
        z = np.zeros((P, G, 128, KVH, D), np.float32)
        return (jnp.asarray(z), jnp.asarray(z)), (torch.zeros(z.shape),
                                                  torch.zeros(z.shape))
    return _pools(seed=11)


@pytest.mark.parametrize("jax_backend,fmt", [("pallas", "mx8"),
                                             ("jnp", "mx8"),
                                             ("jnp", "fp32")])
def test_paged_kv_append_vs_jax(jax_backend, fmt):
    (jk, jv), (tk, tv) = _append_pools(fmt)
    t0 = [a.clone() for a in (tk.payload.values() if fmt == "mx8"
                              else (tk, tv))]
    t0 += [a.clone() for a in tv.payload.values()] if fmt == "mx8" else []
    r = np.random.default_rng(3)
    lens = np.array([0, 127, 128, 129], np.int32)
    jcfg = JOPS.StateQuantConfig(fmt, "stochastic", jax_backend)
    jc = JPG.PagedKVCache(jk, jv, jnp.asarray(BT), jnp.asarray(lens),
                          jnp.int32(1), fmt)
    tc = TPG.PagedKVCache(tk, tv, torch.from_numpy(BT),
                          torch.from_numpy(lens), 1, fmt)
    for step in range(2):                  # (128, 129) -> (129, 130) stays
        k = r.standard_normal((4, 1, KVH, D)).astype(np.float32)   # in bt
        v = r.standard_normal((4, 1, KVH, D)).astype(np.float32)
        seed = 0xFFFFFFFF - step           # exercises the uint32 wrap
        jc = JOPS.kv_append(jc, jnp.asarray(k), jnp.asarray(v), jcfg,
                            seed=jnp.uint32(seed))
        for backend in (("cuda", "torch") if fmt == "mx8" else ("torch",)):
            tc2 = TOPS.kv_append(tc, torch.from_numpy(k), torch.from_numpy(v),
                                 _torch_cfg(fmt, backend), seed=seed)
        tc = tc2
    np.testing.assert_array_equal(np.asarray(jc.lengths), tc.lengths.numpy())
    if fmt == "fp32":
        np.testing.assert_array_equal(np.asarray(jc.k), tc.k.numpy())
        np.testing.assert_array_equal(np.asarray(jc.v), tc.v.numpy())
        return
    for js, ts in ((jc.k, tc.k), (jc.v, tc.v)):
        for f in ("exponent", "micro"):
            np.testing.assert_array_equal(np.asarray(js.payload[f]),
                                          ts.payload[f].numpy())
        mj = np.asarray(js.payload["mantissa"]).astype(np.int32)
        mt = ts.payload["mantissa"].numpy().astype(np.int32)
        assert np.abs(mj - mt).max() <= 1 and (mj != mt).mean() <= 1e-5
    # outside the written slots (layer 1 of the rows' pages at the appended
    # offsets) every byte is as it was
    after = list(tc.k.payload.values()) + list(tc.v.payload.values())
    keep = torch.ones((P, G, 128), dtype=torch.bool)
    for b, L in enumerate(lens):
        for s in (L, L + 1):
            keep[BT[b, s // 128], 1, s % 128] = False
    for a0, a1 in zip(t0, after):
        assert torch.equal(a0[keep], a1[keep])


def _slab_inputs(rounding_seed):
    r = np.random.default_rng(rounding_seed)
    S, Hs, dv, dk = 5, 3, 16, 32
    pool = r.standard_normal((S, 2, Hs, dv, dk)).astype(np.float32)
    d = 1 / (1 + np.exp(-r.standard_normal((3, Hs, dk))))
    k, v, q = (r.standard_normal(s).astype(np.float32)
               for s in ((3, Hs, dk), (3, Hs, dv), (3, Hs, dk)))
    return pool, d.astype(np.float32), k, v, q


@pytest.mark.parametrize("jax_backend", ["pallas", "jnp"])
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_paged_state_update_vs_jax(jax_backend, rounding):
    pool, d, k, v, q = _slab_inputs(7)
    slabs = np.array([3, 1, 4], np.int32)
    jq = JF.mx8_quantize(jnp.asarray(pool))
    tq = _to_torch_qt(jq)
    t0 = tq.clone()
    js = JPG.PagedState(jq, jnp.asarray(slabs), jnp.int32(1), "mx8")
    jst, yj = JOPS.state_update_step(
        js, *map(jnp.asarray, (d, k, v, q)),
        JOPS.StateQuantConfig("mx8", rounding, jax_backend),
        seed=jnp.uint32(21))
    ts = TPG.PagedState(tq, torch.from_numpy(slabs), 1, "mx8")
    _, yt = TOPS.state_update_step(ts, *map(torch.from_numpy, (d, k, v, q)),
                                   TOPS.StateQuantConfig("mx8", rounding,
                                                         "torch"), seed=21)
    jpool = jst.pool
    for f in ("exponent", "micro"):
        np.testing.assert_array_equal(np.asarray(jpool.payload[f]),
                                      tq.payload[f].numpy(), err_msg=f)
    mj = np.asarray(jpool.payload["mantissa"]).astype(np.int32)
    mt = tq.payload["mantissa"].numpy().astype(np.int32)
    diff = mj != mt
    assert np.abs(mj - mt).max() <= 1 and diff.mean() <= 1e-5
    rows_ok = ~diff[slabs, 1].any(axis=-1)               # (B, H, dv)
    yj = np.asarray(yj)
    np.testing.assert_allclose(yt.numpy()[rows_ok], yj[rows_ok], rtol=1e-5,
                               atol=1e-5 * np.abs(yj).max())
    untouched = np.ones(mt.shape[:2], bool)
    untouched[slabs, 1] = False
    for f, a in tq.payload.items():
        assert torch.equal(a[torch.from_numpy(untouched)],
                           t0.payload[f][torch.from_numpy(untouched)])


def test_slab_mode_equals_dense_on_gathered_rows():
    pool, d, k, v, q = _slab_inputs(8)
    slabs = torch.tensor([4, 2, 3], dtype=torch.int32)
    qp = TF.mx8_quantize(torch.from_numpy(pool))
    args = [torch.from_numpy(a) for a in (d, k, v, q)]
    n0 = (KS.mx_state_update.launches, KS.mx_state_update.slab_launches)
    rows = TF.QuantizedTensor("mx8", (3, 3, 16, 32), {
        f: a[slabs.long(), 0].clone() for f, a in qp.payload.items()})
    dense, yd = KS.mx_state_update(rows, *args, seed=5)
    _, ys = KS.mx_state_update(qp, *args, seed=5, slabs=slabs, group=0)
    assert torch.equal(ys, yd)
    for f, a in qp.payload.items():
        assert torch.equal(a[slabs.long(), 0], dense.payload[f])
    assert (KS.mx_state_update.launches,
            KS.mx_state_update.slab_launches) == n0


def test_paged_fp32_state_update_vs_jnp():
    pool, d, k, v, q = _slab_inputs(9)
    slabs = np.array([2, 4, 1], np.int32)
    js = JPG.PagedState(jnp.asarray(pool), jnp.asarray(slabs), jnp.int32(0),
                        "fp32")
    jst, yj = JOPS.state_update_step(
        js, *map(jnp.asarray, (d, k, v, q)),
        JOPS.StateQuantConfig("fp32", "nearest", "jnp"))
    tp = torch.from_numpy(pool.copy())
    ts = TPG.PagedState(tp, torch.from_numpy(slabs), 0, "fp32")
    _, yt = TOPS.state_update_step(ts, *map(torch.from_numpy, (d, k, v, q)),
                                   _torch_cfg("fp32", "torch"))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5 * float(jnp.abs(yj).max()))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jst.pool), rtol=1e-6,
                               atol=1e-6)


def test_paged_plans_and_traffic_match_jax_for_zamba2():
    from repro.configs import get_config
    from repro_torch.configs import get_config as t_get_config
    jcfg, tcfg = get_config("zamba2-2.7b"), t_get_config("zamba2-2.7b")
    for T in (1, 128, 129, 1000):
        jt = JOPS.decode_traffic_by_kind(jcfg, 4, T, "paged")
        tt = TOPS.decode_traffic_by_kind(tcfg, 4, T, "paged")
        assert set(jt) == set(tt)
        for kind in jt:
            assert jt[kind].__dict__ == tt[kind].__dict__, (kind, T)
    plans = TOPS.decode_op_plans(tcfg, 4, 1000, "paged")
    assert {e.plan.layout for e in plans} == {"paged"}
    assert {(e.kind, e.plan.backend, e.count) for e in plans} == {
        ("state_update", "cuda", 54), ("attn_decode", "cuda", 9),
        ("kv_append", "cuda", 9)}


def test_paged_backend_negotiation():
    assert TOPS.resolve_backend("attn_decode", "mx8", layout="paged") == "cuda"
    assert TOPS.resolve_backend("kv_append", "fp32", "cuda",
                                layout="paged") == "torch"
    with pytest.raises(ValueError, match="layout 'paged'"):
        TOPS.resolve_backend("state_update", "bf16", "cuda", layout="paged",
                             strict=True)
    with pytest.raises(KeyError, match="layout 'paged'"):
        TOPS.get_op("attn_decode", "cuda", "fp32", "paged")


def test_paged_wrappers_take_plain_on_cpu_and_launch_nothing():
    _, (tk, tv) = _pools(seed=2)
    n0 = (KP.mx_paged_attention_decode.launches,
          KP.mx_paged_kv_append.launches)
    pools = [tk.payload[f].clone() for f in sorted(tk.payload)]
    rows = [torch.ones((4, KVH, p.shape[-1]), dtype=p.dtype) for p in pools]
    lens = torch.tensor([5, 3, 130, 0], dtype=torch.int32)
    bt = torch.from_numpy(BT)
    KP.mx_paged_kv_append(pools, rows, bt, 2, lens)
    for p in pools:
        assert bool((p[bt.long()[torch.arange(4), lens.long() // 128], 2,
                       lens.long() % 128] == 1).all())
    KP.mx_paged_attention_decode(torch.zeros((4, H, D)), tk, tv, bt, 0, lens)
    assert (KP.mx_paged_attention_decode.launches,
            KP.mx_paged_kv_append.launches) == n0
