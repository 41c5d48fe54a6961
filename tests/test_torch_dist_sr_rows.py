"""Stochastic rounding under data parallelism, on the CPU: a rank that
decodes rows ``b0 ..`` of a batch counts its SR draws from row ``b0`` of
the whole batch (``ops.sr_rows_from``, set by
``dist.sharding.sharded_decode_step``), so its rows come out bitwise as
the whole batch's step gives them -- as under GSPMD, whose counters run
over the global array.

Held here: the state update (kernel 1's plain version and the ``torch``
op, in MX8, int8 and fp8), the dense append (the append kernel's plain
version and the ``torch`` op, K/V and an MLA latent), the paged append
(the fused kernel's plain version and the ``torch`` op, with a kv-head
base too), a whole zamba2 decode step, and the wrappers' ``row_base``
against the whole batch's call.  The kernels themselves are held on the card in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import ops as OPS
from repro_torch.configs import get_smoke_config
from repro_torch.core import attention_cache as AC
from repro_torch.core import formats as F
from repro_torch.core import tree as T
from repro_torch.core import paged as PG
from repro_torch.kernels import mx_paged_attention as KP
from repro_torch.kernels import mx_quant as KQ
from repro_torch.kernels import mx_state_update as KS
from repro_torch.models import model as M

torch.set_num_threads(1)  # test workers share the cores: one thread each

B, B0 = 4, 2                    # the whole batch; the second rank's first row


def _rows(tree, lo=B0):
    return T.tree_map(lambda t: t[lo:].clone(), tree)


def _su_inputs(fmt, H=3, dk=32, dv=16):
    r = np.random.default_rng(7)
    t = lambda *s: torch.from_numpy(r.standard_normal(s).astype(np.float32))
    S = F.quantize(t(B, H, dv, dk), fmt)
    d = torch.sigmoid(t(B, H, dk))
    return S, d, t(B, H, dk), t(B, H, dv), t(B, H, dk)


def _payload_equal(a, b):
    if isinstance(a, F.QuantizedTensor):
        return all(torch.equal(a.payload[f], b.payload[f]) for f in a.payload)
    return torch.equal(a, b)


@pytest.mark.parametrize("fmt,backend", [("mx8", "cuda"), ("mx8", "torch"),
                                         ("int8", "torch"),
                                         ("fp8_e5m2", "torch")])
def test_state_update_rows_draw_as_the_whole_batch(fmt, backend):
    cfg = OPS.StateQuantConfig(fmt, "stochastic", backend)
    S, d, k, v, q = _su_inputs(fmt)
    Sw, yw = OPS.state_update_step(S.clone(), d, k, v, q, cfg, seed=11)
    rows = _rows((S, d, k, v, q))
    with OPS.sr_rows_from(B0):
        Sr, yr = OPS.state_update_step(*rows, cfg, seed=11)
    assert _payload_equal(Sr, _rows(Sw)) and torch.equal(yr, yw[B0:])
    # outside the block the rows draw as a batch of their own
    assert OPS.sr_row_base() == 0
    Sn, _ = OPS.state_update_step(*_rows((S, d, k, v, q)), cfg, seed=11)
    assert not _payload_equal(Sn, _rows(Sw))


def test_state_update_wrapper_row_base_equals_the_whole_batch():
    S, d, k, v, q = _su_inputs("mx8")
    Sw, yw = KS.mx_state_update(S.clone(), d, k, v, q, seed=3)
    Sr, yr = KS.mx_state_update(*_rows((S, d, k, v, q)), seed=3,
                                row_base=B0)
    assert _payload_equal(Sr, _rows(Sw)) and torch.equal(yr, yw[B0:])


@pytest.mark.parametrize("latent", [False, True], ids=["kv", "mla"])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_kv_append_rows_draw_as_the_whole_batch(backend, latent):
    cfg = OPS.StateQuantConfig("mx8", "stochastic", backend)
    KVH, w, n = (1, 80, 1) if latent else (2, 32, 2)
    cache = AC.init_kv_cache(B, 128, KVH, w, cfg,
                             mla_v_width=w - 16 if latent else None)
    cache.lengths[:] = torch.tensor([0, 5, 9, 127 - n], dtype=torch.int32)
    r = np.random.default_rng(3)
    kn, vn = (torch.from_numpy(r.standard_normal((B, n, KVH, w)).astype(
        np.float32)) for _ in "kv")
    vn = None if latent else vn
    part = _rows(cache)
    whole = OPS.kv_append(cache, kn, vn, cfg, seed=21)
    with OPS.sr_rows_from(B0):
        got = OPS.kv_append(part, kn[B0:], None if latent else vn[B0:], cfg,
                            seed=21)
    assert T.leaves(got) and all(torch.equal(a, b) for a, b in zip(
        T.leaves(got), T.leaves(_rows(whole))))


def test_dense_append_wrapper_row_base_equals_the_whole_batch():
    caches = [F.mx8_quantize(torch.zeros((B, 128, 2, 32))) for _ in "kv"]
    lengths = torch.tensor([0, 3, 64, 100], dtype=torch.int32)
    r = np.random.default_rng(5)
    new = [torch.from_numpy(r.standard_normal((B, 1, 2, 32)).astype(
        np.float32)) for _ in "kv"]
    part = [_rows(c) for c in caches]
    KQ.mx_kv_append_quant(new, caches, lengths, 9)
    KQ.mx_kv_append_quant([x[B0:] for x in new], part, lengths[B0:], 9,
                          row_base=B0)
    for c, p in zip(caches, part):
        assert _payload_equal(p, _rows(c))


def test_zamba2_decode_step_rows_equal_the_whole_batch():
    """A rank's rows of a zamba2 decode step (its Mamba-2 state updates
    and its shared attention's appends, at the config's stochastic
    rounding) under ``sr_rows_from`` equal the whole batch's rows."""
    cfg = get_smoke_config("zamba2-2.7b")
    assert cfg.state_quant.rounding == "stochastic"
    params = M.init_model(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, 12)))
    lengths = torch.full((B,), 12, dtype=torch.int32)
    logits, caches = M.prefill(params, cfg, {"tokens": tok})
    _, part = M.prefill(params, cfg, {"tokens": tok[B0:]})
    nxt = logits.argmax(-1)
    whole, _ = M.decode_step(params, cfg, nxt, caches, lengths, seed=4)
    with OPS.sr_rows_from(B0):
        rows, _ = M.decode_step(params, cfg, nxt[B0:], T.tree_map(
            torch.clone, part), lengths[B0:], seed=4)
    assert torch.equal(rows, whole[B0:])
    alone, _ = M.decode_step(params, cfg, nxt[B0:], part, lengths[B0:],
                             seed=4)
    assert not torch.equal(alone, whole[B0:])


def _paged(r, kvh=4, w=16):
    pools = [F.mx8_quantize(torch.from_numpy(r.standard_normal(
        (9, 2, 128, kvh, w)).astype(np.float32))) for _ in "kv"]
    bt = torch.tensor([[5, 7], [2, 4], [6, 1], [3, 8]], dtype=torch.int32)
    lengths = torch.tensor([0, 127, 128, 129], dtype=torch.int32)
    new = [torch.from_numpy(r.standard_normal((B, 1, kvh, w)).astype(
        np.float32)) for _ in "kv"]
    return pools, bt, lengths, new


def _pages(qt, ids, h0=0, n=None):
    n = qt.payload["mantissa"].shape[3] - h0 if n is None else n
    return {f: a[ids].narrow(3, h0, n) for f, a in qt.payload.items()}


#: the pages rows B0.. of ``_paged``'s batch write (rows 0 and 1 write 5, 2)
ROW_PAGES = [1, 8]


@pytest.mark.parametrize("heads", [None, (1, 2)], ids=["all", "h1of4"])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_paged_append_rows_draw_as_the_whole_batch(backend, heads):
    """The paged append (the fused kernel's plain version, and the
    ``torch`` op) on rows ``B0 ..`` under ``sr_rows_from(B0)`` -- and on
    kv heads ``h0 ..`` of them under ``sr_heads_from`` too -- writes the
    slots the whole batch's append writes, byte for byte; without the row
    base it does not."""
    cfg = OPS.StateQuantConfig("mx8", "stochastic", backend)
    pools, bt, lengths, new = _paged(np.random.default_rng(17))
    h0, nh = heads or (0, 4)
    part = [F.QuantizedTensor(p.fmt, p.shape, {
        f: a.narrow(3, h0, nh).clone() for f, a in p.payload.items()})
        for p in pools]
    alone = [F.QuantizedTensor(p.fmt, p.shape, {
        f: a.clone() for f, a in p.payload.items()}) for p in part]
    OPS.kv_append(PG.PagedKVCache(pools[0], pools[1], bt, lengths, 1), *new,
                  cfg, seed=0xFFFFFFFE)
    rows = [x[B0:, :, h0:h0 + nh].contiguous() for x in new]
    with OPS.sr_rows_from(B0), OPS.sr_heads_from(h0, 4):
        OPS.kv_append(PG.PagedKVCache(part[0], part[1], bt[B0:],
                                      lengths[B0:], 1), *rows, cfg,
                      seed=0xFFFFFFFE)
    with OPS.sr_heads_from(h0, 4):
        OPS.kv_append(PG.PagedKVCache(alone[0], alone[1], bt[B0:],
                                      lengths[B0:], 1), *rows, cfg,
                      seed=0xFFFFFFFE)
    for p, a, w in zip(part, alone, pools):
        assert _payload_equal_d(_pages(p, ROW_PAGES),
                                _pages(w, ROW_PAGES, h0, nh))
        assert not _payload_equal_d(_pages(a, ROW_PAGES),
                                    _pages(w, ROW_PAGES, h0, nh))


def _payload_equal_d(a, b):
    return all(torch.equal(a[f], b[f]) for f in a)


@pytest.mark.parametrize("rounding", ["stochastic", "nearest"])
def test_paged_append_wrapper_row_base_equals_the_whole_batch(rounding):
    """``mx_paged_kv_append_quant(..., row_base=B0)`` on the last half
    batch (its plain version on CPU tensors) writes what the whole batch's
    call writes into those rows' slots, in all three MX8 fields; at
    ``row_base = 0`` it is the call without the argument."""
    pools, bt, lengths, new = _paged(np.random.default_rng(19))
    half = [F.QuantizedTensor(p.fmt, p.shape, {
        f: a.clone() for f, a in p.payload.items()}) for p in pools]
    zero = [F.QuantizedTensor(p.fmt, p.shape, {
        f: a.clone() for f, a in p.payload.items()}) for p in pools]
    KP.mx_paged_kv_append_quant(new, pools, bt, 1, lengths, 0xFFFFFFFF,
                                rounding=rounding)
    KP.mx_paged_kv_append_quant([x[B0:] for x in new], half, bt[B0:], 1,
                                lengths[B0:], 0xFFFFFFFF, rounding=rounding,
                                row_base=B0)
    KP.mx_paged_kv_append_quant(new, zero, bt, 1, lengths, 0xFFFFFFFF,
                                rounding=rounding, row_base=0)
    for h, z, w in zip(half, zero, pools):
        assert _payload_equal_d(_pages(h, ROW_PAGES), _pages(w, ROW_PAGES))
        assert _payload_equal(z, w)
    with pytest.raises(ValueError, match="uint32"):
        KP.mx_paged_kv_append_quant(new, zero, bt, 1, lengths, row_base=-1)
