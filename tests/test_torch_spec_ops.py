"""The port's speculative-verify ops against the JAX package's, on the same
inputs, and against the port's own single-query ops.

Contracts (ROADMAP.md, "Parity contracts"):

* ``spec_attend`` (MX8, dense and paged) against the JAX ``spec_attend``
  with the Pallas kernels in interpret mode and with the ``jnp`` op: rtol
  2e-4, atol 2e-5 (``tests/test_kernels.py``'s kernel tolerance);
* within the port, bitwise: verify row ``j`` is ``attn_decode`` at
  ``lengths - (Kq - 1 - j)``, ``Kq = 1`` is ``attn_decode``, the paged
  verify is the dense verify over the gathered pages;
* ``attention_spec_step``'s n appends are bitwise n sequential
  ``kv_append`` calls with seeds ``seed + i``, and match the JAX payloads
  to the MX8 append contract (exponent and micro bitwise, mantissa
  mismatch <= 1e-5);
* ``traffic(plan)`` of the four ``spec_verify`` entries and
  ``decode_op_plans(..., spec_k=3)`` equal the JAX package's;
* a Mamba-2 position of ``_element_spec_decode`` is bitwise
  ``_element_decode`` on the same (contiguous) input.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as JOPS
from repro.core import attention_cache as JAC
from repro.core import formats as JF
from repro.core import paged as JPG
from repro_torch import ops as TOPS
from repro_torch.core import attention_cache as TAC
from repro_torch.core import formats as TF
from repro_torch.core import paged as TPG
from repro_torch.kernels import mx_spec_attention as KV
from repro_torch.kernels import ref as R

P, NS, KVH, D = 9, 3, 2, 32
BT = np.array([[5, 7, 0, 0], [2, 4, 0, 0], [6, 1, 0, 0], [3, 8, 0, 0]],
              np.int32)                   # shuffled pages, bucketed tail 0
LENGTHS = (4, 127, 128, 131)              # count the Kq appended rows


def _to_torch_qt(qt):
    return TF.QuantizedTensor(qt.fmt, tuple(qt.shape), {
        f: torch.from_numpy(np.array(a)) for f, a in qt.payload.items()})


def _pools(seed):
    r = np.random.default_rng(seed)
    k, v = (r.standard_normal((P, NS, 128, KVH, D)).astype(np.float32)
            for _ in "kv")
    jk, jv = JF.mx8_quantize(jnp.asarray(k)), JF.mx8_quantize(jnp.asarray(v))
    return (jk, jv), (_to_torch_qt(jk), _to_torch_qt(jv))


def _q(Kq, G, seed=9):
    return np.random.default_rng(seed).standard_normal(
        (len(LENGTHS), Kq, KVH * G, D)).astype(np.float32)


def _tcfg(backend, fmt="mx8"):
    return TOPS.StateQuantConfig(fmt, "stochastic", backend)


def _jcfg(backend, fmt="mx8"):
    return JOPS.StateQuantConfig(fmt, "stochastic", backend)


def _caches(group, seed=0):
    (jk, jv), (tk, tv) = _pools(seed)
    lens = np.asarray(LENGTHS, np.int32)
    jp = JPG.PagedKVCache(jk, jv, jnp.asarray(BT), jnp.asarray(lens),
                          jnp.int32(group), "mx8")
    tp = TPG.PagedKVCache(tk, tv, torch.from_numpy(BT),
                          torch.from_numpy(lens), group, "mx8")
    # the dense twins: the block table's pages gathered (T = 512)
    td = TAC.KVCache(R.gather_pages(tk, tp.bt, group),
                     R.gather_pages(tv, tp.bt, group), tp.lengths, "mx8")
    jd = JAC.KVCache(_to_jax_qt(td.k), _to_jax_qt(td.v), jnp.asarray(lens),
                     "mx8")
    return jp, tp, jd, td


def _to_jax_qt(qt):
    return JF.QuantizedTensor(qt.fmt, tuple(qt.shape), {
        f: jnp.asarray(a.numpy()) for f, a in qt.payload.items()})


@pytest.mark.parametrize("jax_backend", ["pallas", "jnp"])
@pytest.mark.parametrize("Kq,G", [(1, 1), (2, 2), (4, 1), (4, 2)])
def test_spec_attend_matches_jax_dense_and_paged(jax_backend, Kq, G):
    jp, tp, jd, td = _caches(group=2, seed=Kq + G)
    q = _q(Kq, G)
    for jc, tc in ((jp, tp), (jd, td)):
        yj = JOPS.spec_attend(jc, jnp.asarray(q), _jcfg(jax_backend))
        for backend in ("torch", "cuda"):   # cuda on CPU: the plain version
            yt = TOPS.spec_attend(tc, torch.from_numpy(q), _tcfg(backend))
            assert yt.shape == (len(LENGTHS), Kq, KVH * G, D)
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-4,
                                       atol=2e-5, err_msg=backend)


@pytest.mark.parametrize("Kq", [1, 2, 4])
@pytest.mark.parametrize("G", [1, 2])
def test_spec_verify_rows_are_attn_decode_at_shifted_lengths(Kq, G):
    """Bitwise, within the port: row j is the single-query op at length
    ``len - (Kq - 1 - j)``; the paged verify is the dense verify over the
    gathered pages; the kernel wrappers' plain versions agree with the
    ops."""
    _, tp, _, td = _caches(group=1, seed=G)
    q = torch.from_numpy(_q(Kq, G, seed=Kq))
    for backend in ("torch", "cuda"):
        cfg = _tcfg(backend)
        yd = TOPS.spec_attend(td, q, cfg)
        yp = TOPS.spec_attend(tp, q, cfg)
        assert torch.equal(yd, yp)
        for j in range(Kq):
            shifted = TAC.KVCache(td.k, td.v, td.lengths - (Kq - 1 - j),
                                  "mx8")
            assert torch.equal(
                yd[:, j], TOPS.attn_decode(shifted, q[:, j].contiguous(),
                                           cfg)), (backend, j)
    assert torch.equal(yd, KV.mx_spec_attention_decode(q, td.k, td.v,
                                                       td.lengths))
    assert torch.equal(yp, KV.mx_paged_spec_attention_decode(
        q, tp.k, tp.v, tp.bt, 1, tp.lengths))


def test_spec_verify_fp32_matches_jnp():
    r = np.random.default_rng(4)
    k, v = (r.standard_normal((2, 256, KVH, D)).astype(np.float32)
            for _ in "kv")
    lens = np.asarray([200, 9], np.int32)
    q = r.standard_normal((2, 3, 2 * KVH, D)).astype(np.float32)
    jc = JAC.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
                     "fp32")
    tc = TAC.KVCache(torch.from_numpy(k), torch.from_numpy(v),
                     torch.from_numpy(lens), "fp32")
    yj = JOPS.spec_attend(jc, jnp.asarray(q), _jcfg("jnp", "fp32"))
    yt = TOPS.spec_attend(tc, torch.from_numpy(q), _tcfg("torch", "fp32"))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_attention_spec_step_appends_equal_sequential_kv_append(layout):
    """n appends with seeds seed + i (uint32 wrap included), bitwise the n
    sequential ``kv_append`` calls; then the verify.  The payloads match
    the JAX package's ``attention_spec_step`` to the append contract."""
    n, G, seed = 3, 2, 0xFFFFFFFE
    r = np.random.default_rng(7)
    k = r.standard_normal((4, n, KVH, D)).astype(np.float32)
    v = r.standard_normal((4, n, KVH, D)).astype(np.float32)
    q = r.standard_normal((4, n, KVH * G, D)).astype(np.float32)
    base = np.asarray([1, 124, 125, 128], np.int32)    # straddles a page
    cfg = _tcfg("torch")

    def fresh():
        _, (tk, tv) = _pools(seed=5)
        jk, jv = _to_jax_qt(tk), _to_jax_qt(tv)
        if layout == "paged":
            return (TPG.PagedKVCache(tk, tv, torch.from_numpy(BT),
                                     torch.from_numpy(base), 0, "mx8"),
                    JPG.PagedKVCache(jk, jv, jnp.asarray(BT),
                                     jnp.asarray(base), jnp.int32(0), "mx8"))
        td = TAC.KVCache(R.gather_pages(tk, torch.from_numpy(BT), 0),
                         R.gather_pages(tv, torch.from_numpy(BT), 0),
                         torch.from_numpy(base), "mx8")
        return td, JAC.KVCache(_to_jax_qt(td.k), _to_jax_qt(td.v),
                               jnp.asarray(base), "mx8")

    tc, jc = fresh()
    y, tc = TOPS.attention_spec_step(tc, torch.from_numpy(k),
                                     torch.from_numpy(v), torch.from_numpy(q),
                                     cfg, seed=seed)
    seq, _ = fresh()
    for i in range(n):
        seq = TOPS.kv_append(seq, torch.from_numpy(k[:, i:i + 1].copy()),
                             torch.from_numpy(v[:, i:i + 1].copy()), cfg,
                             seed=(seed + i) & 0xFFFFFFFF)
    assert torch.equal(tc.lengths, seq.lengths)
    for a, b in ((tc.k, seq.k), (tc.v, seq.v)):
        for f in a.payload:
            assert torch.equal(a.payload[f], b.payload[f]), f
    assert torch.equal(y, TOPS.spec_attend(seq, torch.from_numpy(q), cfg))

    yj, jc = JOPS.attention_spec_step(jc, jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(q), _jcfg("jnp"),
                                      seed=jnp.uint32(seed))
    np.testing.assert_array_equal(np.asarray(jc.lengths), tc.lengths.numpy())
    for js, ts in ((jc.k, tc.k), (jc.v, tc.v)):
        for f in ("exponent", "micro"):
            np.testing.assert_array_equal(np.asarray(js.payload[f]),
                                          ts.payload[f].numpy())
        mj = np.asarray(js.payload["mantissa"]).astype(np.int32)
        mt = ts.payload["mantissa"].numpy().astype(np.int32)
        assert np.abs(mj - mt).max() <= 1 and (mj != mt).mean() <= 1e-5
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("backend,fmt", [("cuda", "mx8"), ("torch", "mx8"),
                                         ("torch", "fp32")])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_spec_verify_traffic_equals_jax(backend, layout, fmt):
    jb = {"cuda": "pallas", "torch": "jnp"}[backend]
    dims = dict(B=4, T=300, KVH=8, dk=64, dv=64, n=1, H=32, Kq=4)
    jp = JOPS.get_op("spec_verify", jb, fmt, layout).plan(dims, _jcfg(jb, fmt))
    tp = TOPS.get_op("spec_verify", backend, fmt, layout).plan(
        dims, _tcfg(backend, fmt))
    assert TOPS.traffic(tp).__dict__ == JOPS.traffic(jp).__dict__


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "llama3.2-1b",
                                  "mamba2-2.7b"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_op_plans_with_spec_k_match_jax(arch, layout):
    from repro.configs import get_config
    from repro_torch.configs import get_config as t_get_config
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    je = JOPS.decode_op_plans(jcfg, 4, 1024, layout, spec_k=3)
    te = TOPS.decode_op_plans(tcfg, 4, 1024, layout, spec_k=3)
    assert [(e.kind, e.count) for e in je] == [(e.kind, e.count) for e in te]
    for a, b in zip(je, te):
        assert a.traffic.__dict__ == b.traffic.__dict__, a.kind
    counts = {e.kind: e.count for e in te}
    if arch == "zamba2-2.7b":
        assert counts == {"state_update": 54 * 4, "spec_verify": 9,
                          "kv_append": 9 * 4}


def test_mamba2_spec_position_is_bitwise_the_plain_element_step():
    """Trouble spot of the port: a strided ``h[:, i:i+1]`` slice rounds the
    projections differently from the plain step's contiguous (B, 1, d)
    input, so each position is made contiguous; position i of the
    multi-position element is then bitwise the plain element step with seed
    ``seed + i``, state snapshots included."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.models import ssm as SSM
    cfg = get_smoke_config("zamba2-2.7b")
    params = M.init_model(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    p = params["groups"][0][1]
    B, n, seed = 2, 3, 41
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, n, cfg.d_model)).astype(np.float32))
    state = SSM.mamba2_init_state(B, cfg, "cpu")
    positions = torch.tensor([[7, 8, 9], [30, 31, 32]])
    out, _, snaps = M._element_spec_decode(
        p, x, {k: v.clone() for k, v in state.items()}, cfg, "mamba2",
        positions, seed)
    c = {k: v.clone() for k, v in state.items()}
    for i in range(n):
        yi, c = M._element_decode(p, x[:, i:i + 1].contiguous(), c, cfg,
                                  "mamba2", positions[:, i], seed + i)
        assert torch.equal(out[:, i:i + 1], yi), i
        for f, a in c["S"].payload.items():
            assert torch.equal(snaps[i][("S",)].payload[f], a), (i, f)
        for key in ("conv_bc", "conv_x"):
            assert torch.equal(snaps[i][(key,)], c[key]), (i, key)
