"""Stochastic rounding under data parallelism, on the CPU: a rank that
decodes rows ``b0 ..`` of a batch counts its SR draws from row ``b0`` of
the whole batch (``ops.sr_rows_from``, set by
``dist.sharding.sharded_decode_step``), so its rows come out bitwise as
the whole batch's step gives them -- as under GSPMD, whose counters run
over the global array.

Held here: the state update (kernel 1's plain version and the ``torch``
op, in MX8, int8 and fp8), the dense append (the append kernel's plain
version and the ``torch`` op, K/V and an MLA latent), a whole zamba2
decode step, and the wrappers' ``row_base`` against the whole batch's
call.  The kernels themselves are held on the card in
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
from repro_torch.kernels import mx_quant as KQ
from repro_torch.kernels import mx_state_update as KS
from repro_torch.models import model as M

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


def test_the_paged_append_takes_no_row_base():
    from repro_torch.ops.paged_ops import _PagedKVAppendBase
    x = torch.zeros((1, 1, 2, 32))
    with pytest.raises(ValueError, match="row base"):
        _PagedKVAppendBase._new_rows({"k": x, "v": x, "row_base": 1})
