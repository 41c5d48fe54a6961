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


# ---------------------------------------------------------------------------
# row blocks: Kq * G past the 16 rows of one block
# ---------------------------------------------------------------------------

RB_B, RB_T, RB_KVH, RB_D = 3, 384, 2, 128
RB_LENGTHS = (5, 131, 300)
#: (Kq, G): R = Kq * G query rows a kv head -- yi-9b (32), yi-34b (28),
#: dbrx-132b (24), each two row blocks of whole verify positions
ROW_CASES = [(4, 8), (4, 7), (4, 6)]


def _rb_pools(seed):
    """MX8 page pools (P, 2, 128, KVH, d) of both packages and a block
    table of shuffled pages; the dense caches are the gathered pages."""
    r = np.random.default_rng(seed)
    npg = RB_T // 128
    P = 1 + RB_B * npg
    k, v = (r.standard_normal((P, 2, 128, RB_KVH, RB_D)).astype(np.float32)
            for _ in "kv")
    bt = (1 + r.permutation(P - 1)).reshape(RB_B, npg).astype(np.int32)
    jk, jv = JF.mx8_quantize(jnp.asarray(k)), JF.mx8_quantize(jnp.asarray(v))

    def torch_qt(qt):
        return TF.QuantizedTensor(qt.fmt, tuple(qt.shape), {
            f: torch.from_numpy(np.array(a)) for f, a in qt.payload.items()})
    return (jk, jv), (torch_qt(jk), torch_qt(jv)), bt


def _rb_q(Kq, G, seed):
    return np.random.default_rng(seed).standard_normal(
        (RB_B, Kq, RB_KVH * G, RB_D)).astype(np.float32)


@pytest.mark.parametrize("Kq,G", ROW_CASES)
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_row_blocks_match_the_jax_verify_kernels(Kq, G, layout):
    """The row-blocked plain model at R = Kq * G > 16 against the JAX
    package's Pallas verify kernels (interpret mode), which take all R rows
    in one block, and the port's plain verify versions: rtol 2e-4, atol
    2e-5."""
    from repro.kernels.mx_spec_attention import \
        mx_paged_spec_attention_decode as jax_paged
    from repro_torch.kernels import mx_attention as KA
    R_ = Kq * G
    assert KA.split_row_blocks(R_, G, RB_D) == 2
    (jk, jv), (tk, tv), bt = _rb_pools(seed=R_)
    q = _rb_q(Kq, G, seed=R_ + 1)
    lens = torch.tensor(RB_LENGTHS, dtype=torch.int32)
    group = 1
    tbt = torch.from_numpy(bt)
    kd, vd = R.gather_pages(tk, tbt, group), R.gather_pages(tv, tbt, group)
    got = R.split_spec_attention_ref(torch.from_numpy(q), TF.dequantize(kd),
                                     TF.dequantize(vd), lens)
    if layout == "dense":
        jkd = JF.QuantizedTensor(jk.fmt, tuple(kd.shape), {
            f: jnp.asarray(a.numpy()) for f, a in kd.payload.items()})
        jvd = JF.QuantizedTensor(jv.fmt, tuple(vd.shape), {
            f: jnp.asarray(a.numpy()) for f, a in vd.payload.items()})
        want = jax_spec_attention(jnp.asarray(q), jkd, jvd,
                                  jnp.asarray(RB_LENGTHS, jnp.int32))
        plain = R.mx_spec_attention_decode_ref(torch.from_numpy(q), kd, vd,
                                               lens)
    else:
        want = jax_paged(jnp.asarray(q), jk, jv, jnp.asarray(bt),
                         jnp.int32(group), jnp.asarray(RB_LENGTHS, jnp.int32))
        plain = R.mx_paged_spec_attention_decode_ref(
            torch.from_numpy(q), tk, tv, tbt, group, lens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)
    torch.testing.assert_close(got, plain, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("Kq,G", ROW_CASES + [(4, 4), (2, 8), (1, 8)])
def test_a_rows_numbers_do_not_depend_on_its_row_block(Kq, G):
    """The kernels' row blocks (two at R > 16, one at R <= 16) give every
    row bitwise what one block of all R rows and blocks of one row give
    it; at R <= 16 the default is that one block."""
    from repro_torch.kernels import mx_attention as KA
    _, (tk, tv), bt = _rb_pools(seed=3)
    tbt = torch.from_numpy(bt)
    kf = TF.dequantize(R.gather_pages(tk, tbt, 0))
    vf = TF.dequantize(R.gather_pages(tv, tbt, 0))
    q = torch.from_numpy(_rb_q(Kq, G, seed=Kq * G))
    lens = torch.tensor(RB_LENGTHS, dtype=torch.int32)
    R_ = Kq * G
    assert KA.split_block_rows(R_, G, RB_D) == (R_ if R_ <= 16 else
                                                16 // G * G)
    blocked = R.split_spec_attention_ref(q, kf, vf, lens)
    for rows in (R_, 1):
        assert torch.equal(blocked, R.split_spec_attention_ref(
            q, kf, vf, lens, block_rows=rows)), rows


@pytest.mark.parametrize("R_,G,dk,dv,rows,blocks,kb,per_sm", [
    (1, 1, 80, 80, 1, 1, 61.3125, 3),      # zamba2 decode
    (4, 1, 80, 80, 4, 1, 71.25, 3),        # zamba2 verify
    (1, 1, 128, 128, 1, 1, 89.0, 2),       # opt-6.7b decode
    (4, 1, 128, 128, 4, 1, 104.0, 2),      # opt-6.7b verify
    (8, 8, 128, 128, 8, 1, 124.0, 1),      # yi-9b decode
    (32, 8, 128, 128, 16, 2, 164.0, 1),    # yi-9b verify
    (28, 7, 128, 128, 14, 2, 154.0, 1),    # yi-34b verify
    (32, 8, 256, 256, 8, 4, 224.0, 1),     # paligemma-3b verify
    (40, 40, 64, 64, 16, 3, 96.0, 2),      # one position past 16 rows
])
def test_row_block_shapes_and_shared_memory(R_, G, dk, dv, rows, blocks,
                                            kb, per_sm):
    """The launch arithmetic the wrappers share with
    ``csrc/mx_attention_split.cuh``: rows a block, row blocks, a block's
    dynamic shared memory and the blocks one SM's shared memory holds;
    none of these shapes is refused."""
    from repro_torch.kernels import mx_attention as KA
    assert KA.split_block_rows(R_, G, dv) == rows
    assert KA.split_row_blocks(R_, G, dv) == blocks
    assert KA.split_smem_bytes(rows, dk, dv) == kb * 1024
    assert KA.split_blocks_per_sm(R_, G, dk, dv) == per_sm
    KA.split_checked(R_, G, dk, dv, "test")


@pytest.mark.parametrize("dk,dv,match", [
    (512, 256, "shared memory"),           # 8 rows at dk 512: 268 KB
    (64, 4096, "accumulators"),
    (72, 64, "multiples of 16"),
])
def test_split_checked_refuses_only_what_a_block_cannot_hold(dk, dv, match):
    from repro_torch.kernels import mx_attention as KA
    with pytest.raises(ValueError, match=match):
        KA.split_checked(32, 8, dk, dv, "test")
