"""The MLA kernels' split loop (``csrc/mx_mla_tile.cuh``), on the CPU,
through its plain model :func:`repro_torch.kernels.ref.split_mla_attention_ref`.

The MLA mode of kernels 2, 3, 5 and 6 splits each row's time axis into
fixed 64-position splits and computes each split's flash partial with both
products on the tensor cores: the fp32 operand (the pre-scaled queries, the
probabilities) as three bf16 terms that sum back to it exactly, against
the latent rows, which are exact in bf16; the partials fold in order.  The
model does the same at any split size.  Contracts:

* it matches the port's plain MLA versions (dense and paged) and the JAX
  package's Pallas MLA kernels (interpret mode) to rtol 2e-4, atol 2e-5 --
  the kernel tolerance -- at split sizes 64 and 128, Kq 1, 2 and 4, at
  ``tests/test_torch_mla.py``'s kernel shapes, and at deepseek-v2-236b's
  full widths (one batch row);
* a partial that is fully masked for a row leaves the running
  ``(m, l, acc)`` bitwise; verify row ``j`` is bitwise the ``Kq = 1`` call
  at length ``len - (Kq - 1 - j)``; the paged model is bitwise the dense
  one over the gathered pages;
* the term split is exact: MX8 latent values at magnitudes 1, 1e-3 and
  1e-37 (subnormal scales) convert to bf16 exactly, and a query's three
  terms sum back to it exactly.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.kernels.mx_spec_attention import (
    mx_paged_spec_attention_decode as j_pspec,
    mx_spec_attention_decode as j_spec)
from repro_torch.core import formats as TF
from repro_torch.kernels import mx_spec_attention as KV
from repro_torch.kernels import ref as R

torch.set_num_threads(1)  # test workers share the cores: one thread each

# tests/test_torch_mla.py's kernel shapes: 16 heads, dk 192, values 128
B, H, DK, VW, T = 2, 16, 192, 128, 256
#: lengths count the Kq appended rows; at Kq = 4 row 0 ends a split before
#: row 3 at split 64 (131: 128 | 129..131; 66: 63, 64 | 65, 66) and 128
#: (131: 128 | 129..131)
LENGTHS = (131, 66)
SCALE = 0.1
BT = np.asarray([[4, 2], [5, 0]], np.int32)      # row 1: one page + scratch


def _qt(qt):
    return TF.QuantizedTensor(qt.fmt, tuple(qt.shape), {
        f: torch.from_numpy(np.array(a)) for f, a in qt.payload.items()})


@functools.lru_cache(maxsize=None)
def _inputs(Kq):
    """q (B, Kq, H, DK), a dense latent (B, T, 1, DK) and a latent page pool
    (6, 2, 128, 1, DK), JAX and torch, from one seed."""
    r = np.random.default_rng(17)
    dense = JF.mx8_quantize(jnp.asarray(
        r.standard_normal((B, T, 1, DK)).astype(np.float32)))
    pool = JF.mx8_quantize(jnp.asarray(
        r.standard_normal((6, 2, 128, 1, DK)).astype(np.float32)))
    q = r.standard_normal((B, Kq, H, DK)).astype(np.float32)
    return q, (dense, _qt(dense)), (pool, _qt(pool))


@functools.lru_cache(maxsize=None)
def _jax(Kq, paged):
    q, (dense, _), (pool, _) = _inputs(Kq)
    lens = jnp.asarray(LENGTHS, jnp.int32)
    kw = dict(scale=SCALE, v_width=VW, interpret=True)
    if paged:
        return np.asarray(j_pspec(jnp.asarray(q), pool, None,
                                  jnp.asarray(BT), 1, lens, **kw))
    return np.asarray(j_spec(jnp.asarray(q), dense, None, lens, **kw))


def _model(q, latent, lens, split, paged):
    kw = dict(bt=torch.from_numpy(BT), group=1) if paged else {}
    return R.split_mla_attention_ref(q, latent, lens, VW, SCALE, split, **kw)


@pytest.mark.parametrize("split", [64, 128])
@pytest.mark.parametrize("Kq", [1, 2, 4])
def test_mla_split_model_matches_plain_and_jax(split, Kq):
    q, (_, dense), (_, pool) = _inputs(Kq)
    qt = torch.from_numpy(q)
    lens = torch.tensor(LENGTHS, dtype=torch.int32)
    got = _model(qt, dense, lens, split, paged=False)
    torch.testing.assert_close(got, KV.plain(qt, dense, None, lens, SCALE, VW),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), _jax(Kq, False), rtol=2e-4,
                               atol=2e-5)
    got_p = _model(qt, pool, lens, split, paged=True)
    torch.testing.assert_close(
        got_p, KV.plain_paged(qt, pool, None, torch.from_numpy(BT), 1, lens,
                              SCALE, VW), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_p.numpy(), _jax(Kq, True), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("split", [64, 128])
def test_fully_masked_mla_partial_leaves_the_state_bitwise(split):
    """A split past every row's length gives ``(-1e30, 0, 0)`` per row, and
    folding it into a running state of several splits changes no bit."""
    q, (_, dense), _ = _inputs(1)
    kf = TF.dequantize(dense)[0, :, 0]
    q_terms = R.bf16_terms(torch.from_numpy(q[0, 0]) * SCALE)
    row_len = torch.tensor([3, 40, 70, 100] * (H // 4))
    state = R.mla_split_partial(q_terms, kf[:split], row_len, 0, VW)
    for s in range(1, -(-100 // split)):
        state = R.combine_split(state, R.mla_split_partial(
            q_terms, kf[s * split:(s + 1) * split], row_len, s * split, VW))
    start = -(-100 // split) * split
    masked = R.mla_split_partial(q_terms, kf[start:start + split], row_len,
                                 start, VW)
    m, l, acc = masked
    assert bool((m == R.NEG_INF).all()) and not l.any() and not acc.any()
    after = R.combine_split(state, masked)
    for a, b in zip(after, state):
        assert torch.equal(a, b)
        assert torch.equal(torch.signbit(a), torch.signbit(b))


@pytest.mark.parametrize("split", [64, 128])
@pytest.mark.parametrize("paged", [False, True])
def test_mla_verify_row_j_is_the_single_query_call_at_its_length(split,
                                                                 paged):
    q, (_, dense), (_, pool) = _inputs(4)
    latent = pool if paged else dense
    qt = torch.from_numpy(q)
    lens = torch.tensor(LENGTHS, dtype=torch.int32)
    y = _model(qt, latent, lens, split, paged)
    for j in range(4):
        yj = _model(qt[:, j:j + 1].contiguous(), latent, lens - (3 - j),
                    split, paged)
        assert torch.equal(y[:, j], yj[:, 0]), j


@pytest.mark.parametrize("split", [64, 128])
def test_mla_paged_model_is_dense_over_gathered_pages(split):
    q, _, (_, pool) = _inputs(2)
    qt = torch.from_numpy(q)
    lens = torch.tensor(LENGTHS, dtype=torch.int32)
    gathered = R.gather_pages(pool, torch.from_numpy(BT), 1)
    assert torch.equal(_model(qt, pool, lens, split, paged=True),
                       _model(qt, gathered, lens, split, paged=False))


@pytest.mark.parametrize("mag", [1.0, 1e-3, 1e-37])
def test_mx8_latent_values_are_exact_in_bf16(mag):
    """An MX8 value is an int8 times a power of two no smaller than 2^-132
    (micro is 0 at the exponent floor): 8 significant bits, which bf16
    holds down to its 2^-133 subnormal.  At 1e-37 the scales are subnormal
    and some values too."""
    r = np.random.default_rng(5)
    x = r.standard_normal((64, 576)).astype(np.float32) * mag
    if mag < 1e-30:
        x[::4, 16:32] *= 1e-2          # whole groups at the exponent floor
    v = TF.dequantize(TF.mx8_quantize(torch.from_numpy(x)))
    assert torch.equal(v.to(torch.bfloat16).to(torch.float32), v)
    hi, mid, lo = R.bf16_terms(v)
    assert torch.equal(hi, v) and not mid.any() and not lo.any()
    if mag < 1e-30:
        tiny = (v != 0) & (v.abs() < 2.0 ** -126)
        assert int(tiny.sum()) > 100            # bf16 subnormals present


def test_query_terms_sum_back_exactly():
    r = np.random.default_rng(9)
    x = (r.standard_normal(1 << 16) *
         10.0 ** r.uniform(-30, 30, 1 << 16)).astype(np.float32)
    x[:4] = (0.0, -0.0, 1.0, -3.0)
    xt = torch.from_numpy(x)
    hi, mid, lo = R.bf16_terms(xt)
    for t in (hi, mid, lo):
        assert torch.equal(t.to(torch.bfloat16).to(torch.float32), t)
    assert torch.equal((hi + mid) + lo, xt)
    assert torch.equal(hi.double() + mid.double() + lo.double(), xt.double())
    # one bf16 term alone is ~3 decimal digits: why the kernel takes three
    assert float(((hi - xt).abs() / xt.abs().clamp_min(1e-38)).max()) > 1e-3


@pytest.mark.parametrize("Kq", [1, 4])
def test_term_split_model_at_deepseek_full_widths(Kq):
    """128 heads, dk 576, values 512, one batch row of 258 positions (five
    64-position splits; at Kq = 4 the last is fully masked for verify rows 0
    and 1), against the plain version."""
    r = np.random.default_rng(23)
    latent = TF.mx8_quantize(torch.from_numpy(
        r.standard_normal((1, 384, 1, 576)).astype(np.float32)))
    q = torch.from_numpy(r.standard_normal((1, Kq, 128, 576)
                                           ).astype(np.float32))
    lens = torch.tensor([258], dtype=torch.int32)
    scale = 192 ** -0.5
    got = R.split_mla_attention_ref(q, latent, lens, 512, scale)
    torch.testing.assert_close(got, KV.plain(q, latent, None, lens, scale,
                                             512), rtol=2e-4, atol=2e-5)
