"""The fused MX8 quantize-and-append (kernel 4 as the card runs it) on the
CPU: its plain version against the JAX package's paged ``kv_append`` and
against the eager quantize followed by the copy it replaces, the ``cuda``
op on CPU tensors against the ``torch`` op, and the wrapper's checks.

Contracts (ROADMAP.md, "Parity contracts"): against the JAX package,
exponent and micro bytes bitwise, mantissas off by at most one step at a
mismatch rate <= 1e-5, every byte outside the appended slots untouched;
against the eager composition and the ``torch`` op, every pool byte equal.
Widths: zamba2-2.7b's smoke attention (KVH 4, head width 16) for K and V,
deepseek-v2-236b's smoke latent (one stream of 80 lanes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as JOPS
from repro.core import formats as JF
from repro.core import paged as JPG
from repro_torch import ops as TOPS
from repro_torch.core import formats as TF
from repro_torch.core import paged as TPG
from repro_torch.kernels import mx_paged_attention as KP
from repro_torch.kernels import ref as R
from repro_torch.ops.paged_ops import PagedKVAppendTorch

torch.set_num_threads(1)  # test workers share the cores: one thread each

P, N_STACK, GROUP = 9, 3, 1
LENGTHS = (0, 127, 128, 129)
BT = np.array([[5, 7, 0, 0], [2, 4, 0, 0], [6, 1, 0, 0], [3, 8, 0, 0]],
              np.int32)                   # shuffled pages, bucketed tail 0
#: (KVH, width, streams): GQA K and V at the zamba2 smoke attention, the
#: deepseek smoke latent alone
KINDS = {"gqa": (4, 16, 2), "mla": (1, 80, 1)}
SEEDS = (0, 7, 0xFFFFFFFF)                # V's seed wraps to 0 at the last


def _to_torch_qt(qt):
    return TF.QuantizedTensor(qt.fmt, tuple(qt.shape), {
        f: torch.from_numpy(np.array(a)) for f, a in qt.payload.items()})


def _case(kind, seed=0, mag=1.0):
    """MX8 page pools of random values, one per stream (JAX and torch
    copies of the same bytes), and the new token's rows ``(4, 1, KVH, w)``
    at magnitude ``mag``."""
    KVH, w, n = KINDS[kind]
    r = np.random.default_rng(seed)
    jpools = [JF.mx8_quantize(jnp.asarray(
        r.standard_normal((P, N_STACK, 128, KVH, w)).astype(np.float32)))
        for _ in range(n)]
    rows = [(r.standard_normal((4, 1, KVH, w)) * mag).astype(np.float32)
            for _ in range(n)]
    return jpools, [_to_torch_qt(p) for p in jpools], rows


def _bt_lens():
    return torch.from_numpy(BT), torch.tensor(LENGTHS, dtype=torch.int32)


def _bytes(pools):
    return [a.clone() for p in pools for _, a in sorted(p.payload.items())]


def _untouched(before, after):
    keep = torch.ones((P, N_STACK, 128), dtype=torch.bool)
    for b, n in enumerate(LENGTHS):
        keep[BT[b, n // 128], GROUP, n % 128] = False
    for a0, a1 in zip(before, after):
        assert torch.equal(a0[keep], a1[keep])


@pytest.mark.parametrize("jax_backend", ["jnp", "pallas"])
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_plain_version_matches_jax_paged_kv_append(kind, rounding,
                                                   jax_backend):
    """Seeds 0, 7 and 0xFFFFFFFF (V's wraps to 0) over lengths 0, 127,
    128 and 129: the JAX op (Pallas in interpret mode, or jnp) and
    ``paged_kv_append_quant_ref`` on the same pools and rows."""
    KVH, w, n = KINDS[kind]
    jcfg = JOPS.StateQuantConfig("mx8", rounding, jax_backend)
    bt, lens = _bt_lens()
    for seed in SEEDS:
        jpools, tpools, rows = _case(kind, seed=seed % 97)
        before = _bytes(tpools)
        jc = JPG.PagedKVCache(jpools[0], jpools[1] if n == 2 else None,
                              jnp.asarray(BT),
                              jnp.asarray(LENGTHS, jnp.int32),
                              jnp.int32(GROUP), "mx8",
                              None if n == 2 else w - 16)
        jc = JOPS.kv_append(jc, *(jnp.asarray(x) for x in rows),
                            *([None] if n == 1 else []), jcfg,
                            seed=jnp.uint32(seed))
        R.paged_kv_append_quant_ref([torch.from_numpy(x) for x in rows],
                                    tpools, bt, GROUP, lens, seed, rounding)
        for js, ts in zip((jc.k, jc.v)[:n], tpools):
            for f in ("exponent", "micro"):
                np.testing.assert_array_equal(np.asarray(js.payload[f]),
                                              ts.payload[f].numpy(),
                                              err_msg=f"{f} seed {seed}")
            mj = np.asarray(js.payload["mantissa"]).astype(np.int32)
            mt = ts.payload["mantissa"].numpy().astype(np.int32)
            assert np.abs(mj - mt).max() <= 1
            assert (mj != mt).mean() <= 1e-5
        _untouched(before, _bytes(tpools))


@pytest.mark.parametrize("mag", [1.0, 1e-3, 1e-37, 1e35])
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_plain_version_is_the_eager_quantize_then_copy(kind, rounding, mag):
    """Byte for byte what ``_quant_rows`` (stream i with seed + i) followed
    by ``paged_kv_append_ref`` writes, at magnitudes down to subnormal
    scales and up to the top exponents."""
    _, fused, rows = _case(kind, seed=3, mag=mag)
    eager = [p.clone() for p in fused]
    bt, lens = _bt_lens()
    plan = TOPS.registry.plan(
        "kv_append", dict(B=4, T=1, KVH=KINDS[kind][0], dk=KINDS[kind][1],
                          dv=KINDS[kind][1], n=1),
        TOPS.StateQuantConfig("mx8", rounding, "torch"), "torch",
        layout="paged")
    seed = 0xFFFFFFFF
    R.paged_kv_append_quant_ref([torch.from_numpy(x) for x in rows], fused,
                                bt, GROUP, lens, seed, rounding)
    payload_rows, dst = (), ()
    for i, (x, pool) in enumerate(zip(rows, eager)):
        cache = TPG.PagedKVCache(pool, None, bt, lens, GROUP, "mx8")
        payload_rows += PagedKVAppendTorch._quant_rows(
            cache, torch.from_numpy(x), plan, (seed + i) & 0xFFFFFFFF)
        dst += PagedKVAppendTorch._pools_of(pool)
    R.paged_kv_append_ref(dst, payload_rows, bt, GROUP, lens)
    for a, b in zip(_bytes(fused), _bytes(eager)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_cuda_op_on_cpu_tensors_equals_torch_op(kind, rounding):
    """The ``cuda`` backend's paged ``kv_append`` (the fused wrapper, on CPU
    tensors its plain version) against the ``torch`` backend's, two steps
    from lengths 0 / 127 / 128 / 129, seeds wrapping past 2^32: every pool
    byte and the lengths equal."""
    _, pools, _ = _case(kind, seed=11)
    KVH, w, n = KINDS[kind]
    bt, lens = _bt_lens()
    caches = {}
    for backend in ("cuda", "torch"):
        ps = [p.clone() for p in pools]
        caches[backend] = TPG.PagedKVCache(ps[0], ps[1] if n == 2 else None,
                                           bt, lens, GROUP, "mx8",
                                           None if n == 2 else w - 16)
    r = np.random.default_rng(12)
    for step in range(2):
        rows = [torch.from_numpy(r.standard_normal((4, 1, KVH, w))
                                 .astype(np.float32)) for _ in range(n)]
        for backend, c in caches.items():
            cfg = TOPS.StateQuantConfig("mx8", rounding, backend)
            caches[backend] = TOPS.kv_append(
                c, rows[0], rows[1] if n == 2 else None, cfg,
                seed=0xFFFFFFFF - 1 + step)
    got, want = caches["cuda"], caches["torch"]
    assert torch.equal(got.lengths, want.lengths)
    assert torch.equal(got.lengths, lens + 2)
    for a, b in zip(_bytes([got.k] + ([got.v] if n == 2 else [])),
                    _bytes([want.k] + ([want.v] if n == 2 else []))):
        assert torch.equal(a, b)


def test_cuda_op_takes_one_token_per_step():
    _, pools, _ = _case("gqa")
    bt, lens = _bt_lens()
    cache = TPG.PagedKVCache(pools[0], pools[1], bt, lens, GROUP, "mx8")
    two = torch.zeros((4, 2, 4, 16))
    with pytest.raises(ValueError, match="one token per step"):
        TOPS.kv_append(cache, two, two, TOPS.StateQuantConfig())


def test_wrapper_on_cpu_launches_nothing_and_returns_the_pools():
    _, pools, rows = _case("gqa", seed=5)
    bt, lens = _bt_lens()
    n0 = (KP.mx_paged_kv_append_quant.launches,
          KP.mx_paged_kv_append_quant.mla_launches)
    out = KP.mx_paged_kv_append_quant([torch.from_numpy(x) for x in rows],
                                      pools, bt, GROUP, lens, seed=9)
    assert out == pools
    assert (KP.mx_paged_kv_append_quant.launches,
            KP.mx_paged_kv_append_quant.mla_launches) == n0


#: the wrapper's refusals: label -> expected exception
BAD = {"bf16 stream": TypeError, "no streams": ValueError,
       "unpaired": ValueError, "three streams": ValueError,
       "width mismatch": ValueError, "two tokens": ValueError,
       "batch mismatch": ValueError, "stream on the wrong pool": ValueError,
       "pools of two shapes": ValueError, "group past the stack": ValueError,
       "negative group": ValueError, "lengths mismatch": ValueError,
       "unknown rounding": ValueError, "fp32 pool": ValueError,
       "int8 pool": ValueError, "raw tensor pool": ValueError}


def _bad_call(label):
    """The wrapper's arguments (positional, keyword) for one refusal."""
    _, pools, rows = _case("gqa", seed=6)
    _, lat, lat_rows = _case("mla", seed=6)
    xs = [torch.from_numpy(x) for x in rows]
    bt, lens = _bt_lens()
    fp32_pool = TF.quantize(torch.zeros((P, N_STACK, 128, 4, 16)), "fp32")
    int8_pool = TF.quantize(torch.zeros((P, N_STACK, 128, 4, 32)), "int8")
    calls = {
        "bf16 stream": ([xs[0].bfloat16(), xs[1]], pools, bt, 0, lens),
        "no streams": ([], [], bt, 0, lens),
        "unpaired": (xs, pools[:1], bt, 0, lens),
        "three streams": (xs + xs[:1], pools + pools[:1], bt, 0, lens),
        "width mismatch": ([xs[0], xs[1][..., :8].contiguous()], pools, bt,
                           0, lens),
        "two tokens": ([torch.cat([x, x], 1) for x in xs], pools, bt, 0,
                       lens),
        "batch mismatch": ([x[:3] for x in xs], pools, bt, 0, lens),
        "stream on the wrong pool": ([torch.from_numpy(lat_rows[0]), xs[1]],
                                     pools, bt, 0, lens),
        "pools of two shapes": (xs, [pools[0], lat[0]], bt, 0, lens),
        "group past the stack": (xs, pools, bt, N_STACK, lens),
        "negative group": (xs, pools, bt, -1, lens),
        "lengths mismatch": (xs, pools, bt, 0, lens[:3]),
        "unknown rounding": (xs, pools, bt, 0, lens),
        "fp32 pool": (xs[:1], [fp32_pool], bt, 0, lens),
        "int8 pool": (xs[:1], [int8_pool], bt, 0, lens),
        "raw tensor pool": (xs[:1], [pools[0].payload["mantissa"]], bt, 0,
                            lens),
    }
    kw = dict(rounding="up") if label == "unknown rounding" else {}
    return calls[label], kw


@pytest.mark.parametrize("label", sorted(BAD))
def test_wrapper_refuses_bad_arguments_before_dispatch(label):
    """Every check runs on the CPU too, and leaves the pools as they
    were."""
    args, kw = _bad_call(label)
    pools = [p for p in args[1] if isinstance(p, TF.QuantizedTensor)]
    before = _bytes(pools)
    with pytest.raises(BAD[label]):
        KP.mx_paged_kv_append_quant(*args, **kw)
    for a, b in zip(before, _bytes(pools)):
        assert torch.equal(a, b)
