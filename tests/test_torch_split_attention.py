"""The combine rule of the GQA kernels' split loop
(``csrc/mx_attention_split.cuh``), on the CPU, through its plain model
:func:`repro_torch.kernels.ref.split_spec_attention_ref`.

The kernels split each row's time axis into fixed splits of 128 positions,
compute each split's flash partial ``(m, l, acc)`` and fold the partials in
order.  The plain model does the same at any split size.  Contracts:

* it matches the port's plain verify attention and the JAX package's
  Pallas kernel (interpret mode) to rtol 2e-4, atol 2e-5 (the kernel
  tolerance) at split sizes 32, 64 and 128;
* a partial that is fully masked for a row, ``(-1e30, 0, 0)``, leaves the
  running ``(m, l, acc)`` bitwise;
* verify row ``j`` is bitwise the ``Kq = 1`` call at length
  ``len - (Kq - 1 - j)``, though the verify pass folds splits past that
  length that are fully masked for the row.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.kernels.mx_spec_attention import \
    mx_spec_attention_decode as jax_spec_attention
from repro_torch.core import formats as TF
from repro_torch.kernels import ref as R

B, T, KVH, D = 4, 640, 2, 32
#: lengths count the Kq appended rows; at Kq = 4 each ends row 0 in an
#: earlier split than row 3 at split 32 (131, 517), 64 and 128 (131)
LENGTHS = (5, 131, 517, 640)


def _caches(seed):
    r = np.random.default_rng(seed)
    k, v = (r.standard_normal((B, T, KVH, D)).astype(np.float32)
            for _ in "kv")
    jk, jv = JF.mx8_quantize(jnp.asarray(k)), JF.mx8_quantize(jnp.asarray(v))

    def torch_qt(qt):
        return TF.QuantizedTensor(qt.fmt, tuple(qt.shape), {
            f: torch.from_numpy(np.array(a)) for f, a in qt.payload.items()})
    return (jk, jv), (torch_qt(jk), torch_qt(jv))


def _q(Kq, G, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (B, Kq, KVH * G, D)).astype(np.float32)


@pytest.mark.parametrize("split", [32, 64, 128])
@pytest.mark.parametrize("Kq,G", [(1, 2), (4, 1), (4, 2)])
def test_split_combine_matches_plain_and_jax(split, Kq, G):
    (jk, jv), (tk, tv) = _caches(seed=split + Kq)
    q = _q(Kq, G)
    lens = torch.tensor(LENGTHS, dtype=torch.int32)
    got = R.split_spec_attention_ref(torch.from_numpy(q), TF.dequantize(tk),
                                     TF.dequantize(tv), lens, split=split)
    plain = R.mx_spec_attention_decode_ref(torch.from_numpy(q), tk, tv, lens)
    torch.testing.assert_close(got, plain, rtol=2e-4, atol=2e-5)
    want = jax_spec_attention(jnp.asarray(q), jk, jv,
                              jnp.asarray(LENGTHS, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("split", [32, 64, 128])
def test_fully_masked_partial_leaves_the_state_bitwise(split):
    """A split past every row's length gives ``(-1e30, 0, 0)`` per row, and
    folding it into a running state (itself of several splits) changes no
    bit of ``(m, l, acc)``."""
    _, (tk, tv) = _caches(seed=3)
    kf, vf = TF.dequantize(tk), TF.dequantize(tv)
    qg = torch.from_numpy(_q(1, 2)[:, 0]).reshape(B, KVH, 2, D) * D ** -0.5
    row_len = torch.tensor((3, 100, 200, 250))
    state = R.split_partial(qg, kf, vf, row_len, 0, split)
    for s in range(1, -(-250 // split)):
        state = R.combine_split(state, R.split_partial(
            qg, kf, vf, row_len, s * split, (s + 1) * split))
    masked = R.split_partial(qg, kf, vf, row_len, 256, 256 + split)
    m, l, acc = masked
    assert bool((m == R.NEG_INF).all()) and not l.any() and not acc.any()
    after = R.combine_split(state, masked)
    for a, b in zip(after, state):
        assert torch.equal(a, b)
        assert torch.equal(torch.signbit(a), torch.signbit(b))


@pytest.mark.parametrize("split", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 2])
def test_verify_row_j_is_the_single_query_call_at_its_length(split, G):
    _, (tk, tv) = _caches(seed=5)
    kf, vf = TF.dequantize(tk), TF.dequantize(tv)
    Kq = 4
    q = torch.from_numpy(_q(Kq, G, seed=G))
    lens = torch.tensor(LENGTHS, dtype=torch.int32)
    y = R.split_spec_attention_ref(q, kf, vf, lens, split=split)
    for j in range(Kq):
        yj = R.split_spec_attention_ref(q[:, j:j + 1].contiguous(), kf, vf,
                                        lens - (Kq - 1 - j), split=split)
        assert torch.equal(y[:, j], yj[:, 0]), j
