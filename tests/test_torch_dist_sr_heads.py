"""Stochastic rounding under tensor parallelism, on the CPU: a rank that
holds heads ``h0 ..`` of a layer counts its SR draws from head ``h0`` of
the layer's (``ops.sr_heads_from``, set per layer by the tensor-parallel
step), so its heads come out bitwise as the whole layer's step gives them
-- as under GSPMD, whose counters run over the global array -- and
unequal without the head base.  The twin of ``test_torch_dist_sr_rows.py``.

Held here, at the ops (``torch`` backend and the ``cuda`` backend's plain
versions on CPU tensors) and at the wrappers' ``head_base`` /
``heads_total``: the state update (kernel 1's plain version, dense and
slab mode, and the ``torch`` op in MX8, int8 and fp8), the dense append
(K/V) and the paged append (K/V), a head shard and a row shard at once,
and the counter itself (``F.sr_bits_at``).  The kernels are held on the
card in ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 70.
"""
import numpy as np
import pytest
import torch

from repro_torch import ops as OPS
from repro_torch.core import attention_cache as AC
from repro_torch.core import formats as F
from repro_torch.core import paged as PG
from repro_torch.core import tree as T
from repro_torch.kernels import mx_paged_attention as KP
from repro_torch.kernels import mx_quant as KQ
from repro_torch.kernels import mx_state_update as KS

torch.set_num_threads(1)  # test workers share the cores: one thread each

B, H, KVH = 4, 6, 4
#: (first head, heads) of a shard: the second of three, the last of two
SHARDS = [(2, 2), (3, 3)]


def _t(r, *s):
    return torch.from_numpy(r.standard_normal(s).astype(np.float32))


def _heads(tree, h0, n, dim=1):
    """Heads ``h0 .. h0 + n - 1`` (along ``dim``) of every leaf."""
    return T.tree_map(lambda t: t.narrow(dim, h0, n).clone(), tree)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(T.leaves(a), T.leaves(b)))


def _su_inputs(fmt, dk=32, dv=16):
    r = np.random.default_rng(7)
    S = F.quantize(_t(r, B, H, dv, dk), fmt)
    d = torch.sigmoid(_t(r, B, H, dk))
    return S, d, _t(r, B, H, dk), _t(r, B, H, dv), _t(r, B, H, dk)


def test_sr_bits_at_is_the_whole_arrays_slice():
    shape = (3, 2, 5, 48)                       # (B, n, KVH, w)
    whole = F.sr_bits(shape, 99)
    for row0, h0, n in ((0, 0, 5), (1, 2, 2), (2, 4, 1)):
        got = F.sr_bits_at((3 - row0, 2, n, 48), 99, row0, 2, h0, 5)
        assert torch.equal(got, whole[row0:, :, h0:h0 + n])
    # every head: the row-offset counter of the data-parallel step
    assert torch.equal(F.sr_bits_at(shape, 5, 2, 2),
                       F.sr_bits(shape, 5, 2 * 2 * 5 * 48))
    with pytest.raises(ValueError, match="outside"):
        F.sr_bits_at((1, 3, 8), 0, 0, 1, 2, 4)


@pytest.mark.parametrize("h0,n", SHARDS)
@pytest.mark.parametrize("fmt,backend", [("mx8", "cuda"), ("mx8", "torch"),
                                         ("int8", "torch"),
                                         ("fp8_e5m2", "torch")])
def test_state_update_heads_draw_as_the_whole_layer(fmt, backend, h0, n):
    cfg = OPS.StateQuantConfig(fmt, "stochastic", backend)
    S, d, k, v, q = _su_inputs(fmt)
    Sw, yw = OPS.state_update_step(S.clone(), d, k, v, q, cfg, seed=11)
    part = _heads((S, d, k, v, q), h0, n)
    with OPS.sr_heads_from(h0, H):
        Sh, yh = OPS.state_update_step(*part, cfg, seed=11)
    assert _equal(Sh, _heads(Sw, h0, n)) and torch.equal(yh, yw[:, h0:h0 + n])
    # outside the block the heads draw as a layer of their own
    assert OPS.sr_heads() == (0, None)
    Sn, _ = OPS.state_update_step(*_heads((S, d, k, v, q), h0, n), cfg,
                                  seed=11)
    assert not _equal(Sn, _heads(Sw, h0, n))


def test_state_update_rows_and_heads_at_once():
    """A rank of a (data, model) mesh: rows from 2, heads from 3."""
    cfg = OPS.StateQuantConfig("mx8", "stochastic", "cuda")
    S, d, k, v, q = _su_inputs("mx8")
    Sw, yw = OPS.state_update_step(S.clone(), d, k, v, q, cfg, seed=4)
    part = T.tree_map(lambda t: t[2:].clone(), _heads((S, d, k, v, q), 3, 3))
    with OPS.sr_rows_from(2), OPS.sr_heads_from(3, H):
        Sp, yp = OPS.state_update_step(*part, cfg, seed=4)
    want = T.tree_map(lambda t: t[2:], _heads(Sw, 3, 3))
    assert _equal(Sp, want) and torch.equal(yp, yw[2:, 3:])


@pytest.mark.parametrize("h0,n", SHARDS)
def test_state_update_wrapper_slab_mode_head_base(h0, n):
    """Kernel 1's wrapper in slab mode (its plain version here): a pool of
    the rank's heads, updated in place, against the whole pool's."""
    r = np.random.default_rng(3)
    pool = F.mx8_quantize(_t(r, 6, 2, H, 16, 32))
    slabs = torch.tensor([4, 1, 5, 2], dtype=torch.int32)
    d = torch.sigmoid(_t(r, B, H, 1))
    k, v, q = _t(r, B, H, 32), _t(r, B, H, 16), _t(r, B, H, 32)
    part = _heads(pool, h0, n, dim=2)
    whole = pool.clone()
    _, yw = KS.mx_state_update(whole, d, k, v, q, seed=8, slabs=slabs,
                               group=1)
    _, yh = KS.mx_state_update(part, *_heads((d, k, v, q), h0, n), seed=8,
                               slabs=slabs, group=1, head_base=h0,
                               heads_total=H)
    assert _equal(part, _heads(whole, h0, n, dim=2))
    assert torch.equal(yh, yw[:, h0:h0 + n])
    # and the same through the paged op (layout "paged")
    for backend in ("cuda", "torch"):
        cfg = OPS.StateQuantConfig("mx8", "stochastic", backend)
        again = _heads(pool, h0, n, dim=2)
        with OPS.sr_heads_from(h0, H):
            OPS.state_update_step(PG.PagedState(again, slabs, 1),
                                  *_heads((d, k, v, q), h0, n), cfg, seed=8)
        assert _equal(again, _heads(whole, h0, n, dim=2))


def test_state_update_wrapper_dense_head_base():
    S, d, k, v, q = _su_inputs("mx8")
    Sw, yw = KS.mx_state_update(S.clone(), d, k, v, q, seed=3)
    Sh, yh = KS.mx_state_update(*_heads((S, d, k, v, q), 2, 2), seed=3,
                                head_base=2, heads_total=H)
    assert _equal(Sh, _heads(Sw, 2, 2)) and torch.equal(yh, yw[:, 2:4])
    with pytest.raises(ValueError, match="outside"):
        KS.mx_state_update(*_heads((S, d, k, v, q), 2, 2), head_base=5,
                           heads_total=H)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_kv_append_heads_draw_as_the_whole_layer(backend):
    cfg = OPS.StateQuantConfig("mx8", "stochastic", backend)
    w, n = 32, 2
    cache = AC.init_kv_cache(B, 128, KVH, w, cfg)
    cache.lengths[:] = torch.tensor([0, 5, 9, 127 - n], dtype=torch.int32)
    r = np.random.default_rng(3)
    kn, vn = _t(r, B, n, KVH, w), _t(r, B, n, KVH, w)
    part = T.tree_map(lambda t: t.clone(), cache)
    part = AC.KVCache(_heads(part.k, 2, 2, 2), _heads(part.v, 2, 2, 2),
                      part.lengths, part.fmt)
    whole = OPS.kv_append(cache, kn, vn, cfg, seed=21)
    with OPS.sr_heads_from(2, KVH):
        got = OPS.kv_append(part, kn[:, :, 2:].contiguous(),
                            vn[:, :, 2:].contiguous(), cfg, seed=21)
    for s, sw in ((got.k, whole.k), (got.v, whole.v)):
        assert _equal(s, _heads(sw, 2, 2, 2))
    alone = OPS.kv_append(AC.KVCache(_heads(cache.k, 2, 2, 2),
                                     _heads(cache.v, 2, 2, 2),
                                     cache.lengths, cache.fmt),
                          kn[:, :, 2:].contiguous(),
                          vn[:, :, 2:].contiguous(), cfg, seed=21)
    assert not _equal(alone.k, _heads(whole.k, 2, 2, 2))


def test_dense_append_wrapper_head_base_equals_the_whole_layer():
    caches = [F.mx8_quantize(torch.zeros((B, 128, KVH, 32))) for _ in "kv"]
    lengths = torch.tensor([0, 3, 64, 100], dtype=torch.int32)
    r = np.random.default_rng(5)
    new = [_t(r, B, 1, KVH, 32) for _ in "kv"]
    part = [_heads(c, 1, 3, 2) for c in caches]
    KQ.mx_kv_append_quant(new, caches, lengths, 9)
    KQ.mx_kv_append_quant([x[:, :, 1:].contiguous() for x in new], part,
                          lengths, 9, head_base=1, heads_total=KVH)
    for c, p in zip(caches, part):
        assert _equal(p, _heads(c, 1, 3, 2))


def _pages(qt, ids):
    return {f: a[ids] for f, a in qt.payload.items()}


def _paged(r, kvh, w=16):
    pools = [F.mx8_quantize(_t(r, 9, 2, 128, kvh, w)) for _ in "kv"]
    bt = torch.tensor([[5, 7], [2, 4], [6, 1], [3, 8]], dtype=torch.int32)
    lengths = torch.tensor([0, 127, 128, 129], dtype=torch.int32)
    return pools, bt, lengths


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_paged_append_heads_draw_as_the_whole_layer(backend):
    """The paged append takes a kv-head base, and a row base beside it:
    the rank's pools of its kv heads against the whole pools'."""
    cfg = OPS.StateQuantConfig("mx8", "stochastic", backend)
    r = np.random.default_rng(11)
    pools, bt, lengths = _paged(r, KVH)
    new = [_t(r, B, 1, KVH, 16) for _ in "kv"]
    part = [_heads(p, 2, 2, 3) for p in pools]
    whole = PG.PagedKVCache(pools[0], pools[1], bt, lengths, 1)
    OPS.kv_append(whole, *new, cfg, seed=0xFFFFFFFF)
    with OPS.sr_heads_from(2, KVH):
        OPS.kv_append(PG.PagedKVCache(part[0], part[1], bt, lengths, 1),
                      *(x[:, :, 2:].contiguous() for x in new), cfg,
                      seed=0xFFFFFFFF)
    for p, w in zip(part, pools):
        assert _equal(p, _heads(w, 2, 2, 3))
    # rows 2.. of the batch on the same kv heads: their pages (1 and 8)
    # as the whole batch's step wrote them
    rows = [_heads(p, 2, 2, 3) for p in _paged(np.random.default_rng(11),
                                               KVH)[0]]
    with OPS.sr_rows_from(2), OPS.sr_heads_from(2, KVH):
        OPS.kv_append(PG.PagedKVCache(rows[0], rows[1], bt[2:], lengths[2:],
                                      1),
                      *(x[2:, :, 2:].contiguous() for x in new), cfg,
                      seed=0xFFFFFFFF)
    for p, w in zip(rows, part):
        assert _equal(_pages(p, [1, 8]), _pages(w, [1, 8]))


def test_paged_append_wrapper_head_base_equals_the_whole_layer():
    r = np.random.default_rng(13)
    pools, bt, lengths = _paged(r, KVH)
    new = [_t(r, B, 1, KVH, 16) for _ in "kv"]
    part = [_heads(p, 3, 1, 3) for p in pools]
    KP.mx_paged_kv_append_quant(new, pools, bt, 1, lengths, 77)
    KP.mx_paged_kv_append_quant([x[:, :, 3:].contiguous() for x in new],
                                part, bt, 1, lengths, 77, head_base=3,
                                heads_total=KVH)
    for p, w in zip(part, pools):
        assert _equal(p, _heads(w, 3, 1, 3))
    other = [_heads(p, 3, 1, 3) for p in _paged(np.random.default_rng(13),
                                                KVH)[0]]
    KP.mx_paged_kv_append_quant([x[:, :, 3:].contiguous() for x in new],
                                other, bt, 1, lengths, 77)
    assert not _equal(other[0], part[0])
