"""The slot pool's MX8 append and kernel 7's multi-stream launch on the CPU:
their plain versions against the JAX package (``repro.ops.kv_append`` on a
dense cache, ``repro.kernels.mx_quant.mx_quantize`` in interpret mode) and
against the eager compositions they replace, the ``cuda`` ops on CPU
tensors against the ``torch`` ops, the traffic descriptors, the wrappers'
checks, and ``_build_kv_cache``.

Contracts (ROADMAP.md, "Parity contracts"): against the JAX package,
exponent and micro bytes bitwise, mantissas off by at most one step at a
mismatch rate <= 1e-5 (the port's scales are exact powers of two,
XLA:CPU's ``exp2`` is not); against the eager compositions (``F.quantize``
then ``_update_at``; ``F.pad`` then ``mx_quantize_ref``) and the ``torch``
ops, every cache byte equal.  Widths: zamba2-2.7b's smoke attention (KVH 2
here, head width 32) for K and V, deepseek-v2-236b's smoke latent (one
stream of 80 lanes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as JOPS
from repro.core import attention_cache as JAC
from repro.kernels.mx_quant import mx_quantize as j_quant
from repro_torch import ops as TOPS
from repro_torch.core import attention_cache as TAC
from repro_torch.core import formats as TF
from repro_torch.kernels import mx_quant as KQ
from repro_torch.kernels import ref as R
from repro_torch.models import model as M
from repro_torch.ops.attention import KVAppendCuda, KVAppendTorch

B, T = 4, 128
#: (KVH, width, streams): GQA K and V, the MLA latent alone
KINDS = {"gqa": (2, 32, 2), "mla": (1, 80, 1)}
#: slot 3's length runs past T - n (an idle slot); slot 2's reaches T - 1
LENGTHS = (0, 5, T - 1, T + 7)
MAGS = (1.0, 1e-3, 1e-37, 1e35)


def _rows(kind, n, seed=0, mag=1.0):
    KVH, w, k = KINDS[kind]
    r = np.random.default_rng(seed)
    rows = [(r.standard_normal((B, n, KVH, w)) * mag).astype(np.float32)
            for _ in range(k)]
    rows[0].reshape(-1, 16)[::5] = 0.0          # zero groups
    return rows


def _t_cache(kind, backend="torch", rounding="stochastic"):
    KVH, w, k = KINDS[kind]
    cfg = TOPS.StateQuantConfig("mx8", rounding, backend)
    c = TAC.init_kv_cache(B, T, KVH, w, cfg,
                          mla_v_width=None if k == 2 else w - 16)
    c.lengths[:] = torch.tensor(LENGTHS, dtype=torch.int32)
    return c, cfg


def _bytes(cache):
    streams = [cache.k] + ([] if cache.v is None else [cache.v])
    return [s.payload[f] for s in streams
            for f in ("mantissa", "exponent", "micro")]


def _streams(cache):
    return [cache.k] + ([] if cache.v is None else [cache.v])


# ---------------------------------------------------------------------------
# the dense append
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_plain_append_matches_jax_kv_append(kind, n, rounding):
    """The JAX dense ``kv_append`` (jnp) and ``kv_append_quant_ref`` on the
    same zeroed cache and rows, lengths 0, 5, T - 1 and T + 7 (clamped to
    T - n), seed 0xFFFFFFFF (V's wraps to 0)."""
    KVH, w, k = KINDS[kind]
    jcfg = JOPS.StateQuantConfig("mx8", rounding, "jnp")
    jc = JAC.init_kv_cache(B, T, KVH, w, jcfg,
                           mla_v_width=None if k == 2 else w - 16)
    jc = JAC.KVCache(jc.k, jc.v, jnp.asarray(LENGTHS, jnp.int32), jc.fmt,
                     jc.v_width, jc.time_axis)
    tc, _ = _t_cache(kind, rounding=rounding)
    rows = _rows(kind, n, seed=n)
    seed = 0xFFFFFFFF
    jc = JOPS.kv_append(jc, *(jnp.asarray(x) for x in rows),
                        *([None] if k == 1 else []), jcfg,
                        seed=jnp.uint32(seed))
    R.kv_append_quant_ref([torch.from_numpy(x) for x in rows], _streams(tc),
                          tc.lengths, seed, rounding)
    for js, ts in zip((jc.k, jc.v)[:k], _streams(tc)):
        for f in ("exponent", "micro"):
            np.testing.assert_array_equal(np.asarray(js.payload[f]),
                                          ts.payload[f].numpy(), err_msg=f)
        mj = np.asarray(js.payload["mantissa"]).astype(np.int32)
        mt = ts.payload["mantissa"].numpy().astype(np.int32)
        assert np.abs(mj - mt).max() <= 1
        assert (mj != mt).mean() <= 1e-5
        assert np.any(mt != 0)


@pytest.mark.parametrize("mag", MAGS)
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_plain_append_is_the_eager_quantize_then_update_at(kind, rounding,
                                                           mag):
    """Byte for byte the ``torch`` op (``F.sr_bits`` + ``F.quantize`` per
    stream, then ``_update_at`` per field) at n = 2, at magnitudes down to
    subnormal scales and up to the top exponents."""
    rows = [torch.from_numpy(x) for x in _rows(kind, 2, seed=7, mag=mag)]
    fused, _ = _t_cache(kind, rounding=rounding)
    eager, cfg = _t_cache(kind, rounding=rounding)
    seed = 0xFFFFFFFF
    R.kv_append_quant_ref(rows, _streams(fused), fused.lengths, seed,
                          rounding)
    TOPS.kv_append(eager, rows[0], rows[1] if len(rows) == 2 else None, cfg,
                   seed=seed)
    for a, b in zip(_bytes(fused), _bytes(eager)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_cuda_op_on_cpu_tensors_equals_torch_op(kind, rounding):
    """The ``cuda`` backend's dense ``kv_append`` (the fused wrapper, on CPU
    tensors its plain version) against the ``torch`` backend's: n = 1, 3
    and 1 from lengths 0 / 5 / T - 1 / T + 7, seeds wrapping past 2^32;
    every cache byte and the lengths equal."""
    caches = {b: _t_cache(kind, b, rounding) for b in ("cuda", "torch")}
    for b, (c, cfg) in caches.items():
        p = TOPS.registry.plan("kv_append", TOPS.attention._cache_dims(c),
                               cfg, b)
        assert p.backend == b
    for step, n in enumerate((1, 3, 1)):
        rows = [torch.from_numpy(x) for x in _rows(kind, n, seed=20 + step)]
        for b, (c, cfg) in caches.items():
            caches[b] = (TOPS.kv_append(
                c, rows[0], rows[1] if len(rows) == 2 else None, cfg,
                seed=0xFFFFFFFF - 1 + step), cfg)
    got, want = caches["cuda"][0], caches["torch"][0]
    assert torch.equal(got.lengths, want.lengths)
    assert torch.equal(got.lengths, torch.tensor(LENGTHS) + 5)
    for a, b in zip(_bytes(got), _bytes(want)):
        assert torch.equal(a, b)


def test_kv_append_cuda_is_the_dense_mx8_append():
    assert TOPS.resolve_backend("kv_append", "mx8") == "cuda"
    assert TOPS.resolve_backend("kv_append", "int8", "cuda") == "torch"
    op = TOPS.get_op("kv_append", "cuda", "mx8", "dense")
    assert isinstance(op, KVAppendCuda) and op.formats == ("mx8",)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "llama3.2-1b",
                                  "deepseek-v2-236b", "opt-6.7b", "yi-9b"])
def test_kv_append_cuda_traffic_equals_torch_and_jax(arch):
    """Each served config's decode-step append plan (T = 1024, and a
    verify step's at Kq = 4): ``KVAppendCuda.traffic`` equals
    ``KVAppendTorch``'s on the same plan and the JAX registry's
    ``KVAppendJnp`` on its own."""
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config as t_get_config
    jcfg, tcfg = j_get_config(arch), t_get_config(arch)
    for spec_k in (0, 3):
        tp = [e for e in TOPS.decode_op_plans(tcfg, 4, 1024, spec_k=spec_k)
              if e.kind == "kv_append"]
        jp = [e for e in JOPS.decode_op_plans(jcfg, 4, 1024, spec_k=spec_k)
              if e.kind == "kv_append"]
        assert len(tp) == len(jp) == 1 and tp[0].count == jp[0].count
        plan = tp[0].plan
        assert plan.backend == "cuda" and plan.layout == "dense"
        got = TOPS.traffic(plan).__dict__
        assert got == KVAppendTorch().traffic(plan).__dict__
        assert got == JOPS.traffic(jp[0].plan).__dict__


# ---------------------------------------------------------------------------
# kernel 7's multi-stream launch
# ---------------------------------------------------------------------------

def _kv(shape, seed, mag=1.0):
    r = np.random.default_rng(seed)
    x = [(r.standard_normal(shape) * mag).astype(np.float32)
         for _ in range(2)]
    x[0].reshape(-1, 16)[::7] = 0.0
    return [torch.from_numpy(a) for a in x]


@pytest.mark.parametrize("pad_to", [None, 128])
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_multi_stream_plain_is_per_stream_quantize(rounding, pad_to):
    """Bitwise ``mx_quantize_ref`` per stream (each with its own seed), on
    the ``F.pad`` copy where ``pad_to`` is set, at magnitudes 1 to 1e35."""
    for mag in MAGS:
        xs = _kv((2, 37, 2, 32), seed=int(np.log10(mag)) + 40, mag=mag)
        got = R.mx_quantize_streams_ref(xs, [5, 0xFFFFFFFF], rounding,
                                        pad_to)
        for x, q, s in zip(xs, got, (5, 0xFFFFFFFF)):
            if pad_to:
                x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad_to - 37))
            want = R.mx_quantize_ref(x, rounding, s)
            assert tuple(q.shape) == tuple(x.shape)
            for f in want.payload:
                assert torch.equal(q.payload[f], want.payload[f]), (f, mag)


@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_multi_stream_plain_matches_jax_mx_quantize(rounding):
    """Against the Pallas kernel in interpret mode on the padded copy
    (``row_block=64``, so the JAX side splits rows): the JAX package's own
    contract."""
    xs = _kv((2, 37, 2, 32), seed=3)
    got = R.mx_quantize_streams_ref(xs, [11, 12], rounding, pad_to=128)
    for x, q, s in zip(xs, got, (11, 12)):
        xp = np.pad(x.numpy(), ((0, 0), (0, 91), (0, 0), (0, 0)))
        want = j_quant(jnp.asarray(xp), s, rounding=rounding, row_block=64,
                       interpret=True)
        for f in ("exponent", "micro"):
            np.testing.assert_array_equal(q.payload[f].numpy(),
                                          np.asarray(want.payload[f]), f)
        dm = np.abs(q.payload["mantissa"].numpy().astype(np.int32)
                    - np.asarray(want.payload["mantissa"]).astype(np.int32))
        assert dm.max() <= 1
        assert (dm > 0).mean() <= 1e-5


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def test_wrappers_on_cpu_take_the_plain_version_and_launch_nothing():
    xs = _kv((2, 37, 2, 32), seed=8)
    counts = (KQ.mx_quantize.launches, KQ.mx_kv_append_quant.launches,
              KQ.mx_kv_append_quant.mla_launches)
    got = KQ.mx_quantize_streams(xs, [2**32 + 3, 4], rounding="stochastic",
                                 pad_to=128)
    want = R.mx_quantize_streams_ref(xs, [3, 4], "stochastic", 128)
    for q, p in zip(got, want):
        for f in p.payload:
            assert torch.equal(q.payload[f], p.payload[f]), f
    one = KQ.mx_quantize_streams(xs[:1])[0]
    ref = R.mx_quantize_ref(xs[0])
    for f in ref.payload:
        assert torch.equal(one.payload[f], ref.payload[f]), f
    c, _ = _t_cache("gqa")
    e, _ = _t_cache("gqa")
    rows = [torch.from_numpy(x) for x in _rows("gqa", 2, seed=9)]
    out = KQ.mx_kv_append_quant(rows, _streams(c), c.lengths, 2**32 + 6)
    R.kv_append_quant_ref(rows, _streams(e), e.lengths, 6)
    assert out == _streams(c)
    for a, b in zip(_bytes(c), _bytes(e)):
        assert torch.equal(a, b)
    assert (KQ.mx_quantize.launches, KQ.mx_kv_append_quant.launches,
            KQ.mx_kv_append_quant.mla_launches) == counts


def _quant_call(label):
    """A call of ``mx_quantize_streams`` that must be refused."""
    xs = [torch.zeros((2, 5, 2, 32)), torch.zeros((2, 5, 2, 32))]
    call = {
        "bf16 stream": lambda: KQ.mx_quantize_streams(
            [xs[0].to(torch.bfloat16)]),
        "no streams": lambda: KQ.mx_quantize_streams([]),
        "three streams": lambda: KQ.mx_quantize_streams(xs + xs[:1]),
        "streams of two shapes": lambda: KQ.mx_quantize_streams(
            [xs[0], torch.zeros((2, 6, 2, 32))]),
        "width not a multiple of 16": lambda: KQ.mx_quantize_streams(
            [torch.zeros((2, 5, 2, 24))]),
        "seeds unpaired": lambda: KQ.mx_quantize_streams(xs, [1]),
        "pad below the rows": lambda: KQ.mx_quantize_streams(xs, pad_to=4),
        "pad without a row axis": lambda: KQ.mx_quantize_streams(
            [torch.zeros((2, 32))], pad_to=128),
        "unknown rounding": lambda: KQ.mx_quantize_streams(
            xs, rounding="up"),
    }
    return call[label]


def _append_call(label):
    """A call of ``mx_kv_append_quant`` that must be refused."""
    c, _ = _t_cache("gqa")
    m, _ = _t_cache("mla")
    rows = [torch.zeros((B, 1, 2, 32)), torch.zeros((B, 1, 2, 32))]
    ks = _streams(c)
    call = {
        "bf16 stream": lambda: KQ.mx_kv_append_quant(
            [rows[0].to(torch.bfloat16)], ks[:1], c.lengths),
        "no streams": lambda: KQ.mx_kv_append_quant([], [], c.lengths),
        "three streams": lambda: KQ.mx_kv_append_quant(
            rows + rows[:1], ks + ks[:1], c.lengths),
        "unpaired": lambda: KQ.mx_kv_append_quant(rows, ks[:1], c.lengths),
        "stream on the wrong cache": lambda: KQ.mx_kv_append_quant(
            rows[:1], _streams(m), c.lengths),
        "streams of two lengths": lambda: KQ.mx_kv_append_quant(
            [rows[0], torch.zeros((B, 2, 2, 32))], ks, c.lengths),
        "more rows than the cache": lambda: KQ.mx_kv_append_quant(
            [torch.zeros((B, T + 1, 2, 32))] * 2, ks, c.lengths),
        "lengths mismatch": lambda: KQ.mx_kv_append_quant(
            rows, ks, c.lengths[:3]),
        "fp32 cache": lambda: KQ.mx_kv_append_quant(
            rows[:1], [torch.zeros((B, T, 2, 32))], c.lengths),
        "int8 cache": lambda: KQ.mx_kv_append_quant(
            rows[:1], [TF.quantize(torch.zeros((B, T, 2, 32)), "int8")],
            c.lengths),
        "unknown rounding": lambda: KQ.mx_kv_append_quant(
            rows, ks, c.lengths, rounding="up"),
    }
    return call[label]


QUANT_BAD = {"bf16 stream": TypeError, "no streams": ValueError,
             "three streams": ValueError, "streams of two shapes": ValueError,
             "width not a multiple of 16": ValueError,
             "seeds unpaired": ValueError, "pad below the rows": ValueError,
             "pad without a row axis": ValueError,
             "unknown rounding": ValueError}
APPEND_BAD = {"bf16 stream": TypeError, "no streams": ValueError,
              "three streams": ValueError, "unpaired": ValueError,
              "stream on the wrong cache": ValueError,
              "streams of two lengths": ValueError,
              "more rows than the cache": ValueError,
              "lengths mismatch": ValueError, "fp32 cache": ValueError,
              "int8 cache": ValueError, "unknown rounding": ValueError}


@pytest.mark.parametrize("label", sorted(QUANT_BAD))
def test_multi_stream_wrapper_refuses(label):
    with pytest.raises(QUANT_BAD[label]):
        _quant_call(label)()


@pytest.mark.parametrize("label", sorted(APPEND_BAD))
def test_append_wrapper_refuses(label):
    with pytest.raises(APPEND_BAD[label]):
        _append_call(label)()


# ---------------------------------------------------------------------------
# _build_kv_cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_build_kv_cache_on_cpu_is_the_per_stream_store(kind):
    """MX8 with the ``cuda`` backend (one kernel-7 call for all streams,
    padded to the tile in the call) against what it replaced: each stream
    padded with ``F.pad`` to the 128-token tile, then ``store_quantized``;
    every byte, the lengths, the tile-aligned capacity."""
    from repro_torch.configs import get_smoke_config
    KVH, w, k = KINDS[kind]
    cfg = get_smoke_config("zamba2-2.7b")
    assert (cfg.state_quant.fmt, cfg.state_quant.backend) == ("mx8", "cuda")
    xs = _kv((3, 130, KVH, w), seed=13, mag=1e-3)[:k]
    got = M._build_kv_cache(xs[0], xs[1] if k == 2 else None, cfg,
                            v_width=None if k == 2 else w - 16)
    assert got.max_len == 256 and torch.equal(got.lengths,
                                              torch.full((3,), 130))
    assert (got.v is None) == (k == 1) and got.v_width == (
        None if k == 2 else w - 16)
    for x, q in zip(xs, _streams(got)):
        want = KQ.store_quantized(
            torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 126)),
            cfg.state_quant)
        for f in want.payload:
            assert torch.equal(q.payload[f], want.payload[f]), f
