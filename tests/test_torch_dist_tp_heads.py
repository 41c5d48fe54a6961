"""The tensor-parallel cuts of the GLA family, mLSTM and MLA in one process:
a rank's heads, computed from its shard of the weights
(``ssm.gla_family_tp_shard``, ``ssm.mlstm_tp_shard``,
``attention.mla_tp_shard``), are bitwise the whole layer's heads up to
the row-parallel product that the model axis sums.

A rank is a stand-in ``par`` (``tp`` and ``model_index``, all that
``dist/tp.py`` reads of it) with the one collective, ``tp_sum``, made the
identity: each rank's output is then its partial product, and the ranks'
partials add up to the whole layer's output (fp32, rtol 1e-5).  What the
ranks compute before that sum is held bitwise, on the inputs and outputs
of the scan (prefill) and of the state-update op (decode), which spies
record: q, k (HGRN2's ``k = 1 - f``), v, the decay, ``y``, the state and
the mLSTM's normalizer row, at fp32 state and at MX8 with stochastic
rounding (the rank's draws counted from its first head:
``ops.sr_heads_from``), and RetNet's decays at a nonzero head base (at
fp32 state the decode's ``y`` is a batched BLAS product and agrees to
rtol 1e-6: :func:`_y_same`).  The
mLSTM's gates read every channel of ``u``, so they are a row-parallel
product of their own: a rank's partial gate pre-activations add up to the
whole layer's, and its heads are held bitwise given the whole layer's
(the sum's result, replayed).  MLA: a rank's queries and prefill
contexts bitwise the whole's, and its latent cache -- whole on every rank
-- bitwise the whole layer's after each append.  The processes and the
collective are held in ``tests/test_torch_dist_gloo.py``.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import ops as OPS
from repro_torch.configs import get_smoke_config
from repro_torch.core import attention_cache as AC
from repro_torch.core import tree as T
from repro_torch.dist import sharding as SH
from repro_torch.dist import tp as TP
from repro_torch.models import attention as ATT
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM

torch.set_num_threads(1)  # test workers share the cores: one thread each

B, S = 2, 11
QUANT = {"fp32": OPS.StateQuantConfig("fp32", "stochastic", "torch"),
         "sr": OPS.StateQuantConfig("mx8", "stochastic", "cuda")}


def _rank(tp, r):
    return types.SimpleNamespace(tp=tp, model_index=r)


def _cfg(arch, tag, heads=None):
    cfg = get_smoke_config(arch).with_(state_quant=QUANT[tag])
    if heads is not None:
        cfg = cfg.with_(ssm=dataclasses.replace(cfg.ssm, n_heads=heads))
    return cfg


def _inputs(d, seed=0, steps=2):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((B, S, d)).astype(np.float32))
    xs = [torch.from_numpy(r.standard_normal((B, 1, d)).astype(np.float32))
          for _ in range(steps)]
    return x, xs


def _leaves(x):
    return [t for t in T.leaves(x) if isinstance(t, torch.Tensor)]


def _same(a, b, what):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0, what
    for i, (u, v) in enumerate(zip(la, lb)):
        assert torch.equal(u, v), f"{what}: leaf {i} differs"


def _y_same(got, want, cfg, what):
    """The state update's ``y``: bitwise at MX8, whose plain version sums
    in kernel 1's order with elementwise ops; at fp32 state the ``torch``
    op's ``y`` is a batched BLAS product, whose rounding follows the
    batch (B * H) it is given, so a rank's heads agree to rtol 1e-6."""
    if cfg.state_quant.fmt == "mx8":
        assert torch.equal(got, want), f"{what}: y"
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()))


def _heads(tree, h0, n, dim=1):
    return T.tree_map(lambda t: t.narrow(dim, h0, n), tree)


class _Spy:
    """Records each call of ``fn`` (its tensor arguments and results),
    patched into ``module`` under ``name``."""

    def __init__(self, monkeypatch, module, name):
        self.calls = []
        fn = getattr(module, name)

        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            self.calls.append((args, out))
            return out
        monkeypatch.setattr(module, name, wrapped)

    def take(self):
        out, self.calls = self.calls, []
        return out


@pytest.fixture
def no_sum(monkeypatch):
    """The collective as the identity: a rank's output is its partial."""
    monkeypatch.setattr(TP, "tp_sum", lambda x, par: x)


def _run_recurrent(kind, p, cfg, x, xs, par):
    mix = SSM.mixer(kind)
    kw = {} if par is None else {"par": par}
    ys = []
    y, st = mix.forward(p, x, cfg, **kw)
    ys.append(y)
    for i, xi in enumerate(xs):
        y, st = mix.decode(p, xi, st, cfg, 40 + i, **kw)
        ys.append(y)
    return torch.cat(ys, 1), st


def _hold_recurrent(kind, cfg, tp, monkeypatch, gate_replay=False):
    """Every rank of ``tp`` against the whole layer: the scan's and the
    state update's operands and results on its heads bitwise, its state
    bitwise, and the ranks' partial outputs summing to the whole's."""
    H_all = (cfg.ssm.n_heads or cfg.n_heads)
    p = SSM.mixer(kind).init(torch.Generator().manual_seed(3), cfg, "cpu")
    if kind == "hgrn2":
        p["beta"].fill_(0.25)
    x, xs = _inputs(cfg.d_model)
    scan = _Spy(monkeypatch, SSM, "chunked_la_vector"
                if kind in ("gla", "hgrn2") else "chunked_la_scalar")
    su = _Spy(monkeypatch, SSM, "_spu_state_update")
    gates = _Spy(monkeypatch, SSM, "_mlstm_gate_pre")
    y_whole, st_whole = _run_recurrent(kind, p, cfg, x, xs, None)
    w_scan, w_su, w_gates = scan.take(), su.take(), gates.take()
    total = torch.zeros_like(y_whole)
    n = H_all // tp
    for r in range(tp):
        par, h0 = _rank(tp, r), r * n
        shard = SSM.TP_SHARDS[kind](p, cfg, par)
        partial_gates = []
        if gate_replay:             # the sum's result is the whole's gates
            replay = iter(out for _, out in w_gates)

            def gate_pre(p_, u, lp):
                partial_gates.append(torch.cat([u @ p_["wi"], u @ p_["wf"]],
                                               -1))
                return next(replay)
            monkeypatch.setattr(SSM, "_mlstm_gate_pre", gate_pre)
        y, st = _run_recurrent(kind, shard, cfg, x, xs, par)
        total += y
        for (a_w, o_w), (a_r, o_r) in zip(w_scan, scan.take()):
            _same(a_r[:4], _heads(a_w[:4], h0, n), f"{kind} scan operands")
            _same(o_r, _heads(o_w, h0, n), f"{kind} scan y and state")
        r_su = su.take()
        assert len(r_su) == len(w_su) == len(xs)
        for (a_w, o_w), (a_r, o_r) in zip(w_su, r_su):
            _same(a_r[:5], _heads(a_w[:5], h0, n), f"{kind} state update in")
            _same(o_r[0], _heads(o_w[0], h0, n), f"{kind} updated state")
            _y_same(o_r[1], o_w[1][:, h0:h0 + n], cfg, kind)
        _same(st["S"], _heads(st_whole["S"], h0, n), f"{kind} state")
        if "conv" in st:          # the mLSTM's conv tail: its channels
            ch = st["conv"].shape[-1]
            _same(st["conv"], st_whole["conv"][..., r * ch:(r + 1) * ch],
                  f"{kind} conv tail")
        if gate_replay:
            gates_sum = partial_gates if r == 0 else [
                a + b for a, b in zip(gates_sum, partial_gates)]
    want = y_whole.numpy()
    np.testing.assert_allclose(total.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    if gate_replay:
        for got, (_, w) in zip(gates_sum, w_gates):
            w = torch.cat(w, -1)
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-5 * float(w.abs().max()))
    return w_su


@pytest.mark.parametrize("tag", ["fp32", "sr"])
@pytest.mark.parametrize("kind,arch", [("gla", "gla-2.7b"),
                                       ("retnet", "retnet-2.7b"),
                                       ("hgrn2", "hgrn2-2.7b")])
def test_gla_family_heads_equal_the_whole_layer(kind, arch, tag, no_sum,
                                                monkeypatch):
    """Four heads at tp = 2 (heads 0-1 and 2-3) and tp = 4 (one each):
    every rank's heads bitwise, its RetNet decays those of its global
    heads, its HGRN2 ``k = 1 - f`` its heads' (both among the state
    update's operands held)."""
    cfg = _cfg(arch, tag, heads=4)
    for tp in (2, 4):
        _hold_recurrent(kind, cfg, tp, monkeypatch)


@pytest.mark.parametrize("tag", ["fp32", "sr"])
def test_mlstm_heads_equal_the_whole_layer(tag, no_sum, monkeypatch):
    """xLSTM's mLSTM at tp = 2 (its 2 heads, 64 channels of ``d_up`` a
    rank): the ranks' gate pre-activations sum to the whole layer's, and
    given them each rank's heads -- the state with its normalizer row
    (state row 64 of dv_aug 80), ``y``, the normalizer ``n . q`` -- and
    its conv tail are bitwise the whole layer's."""
    cfg = _cfg("xlstm-1.3b", tag)
    calls = _hold_recurrent("mlstm", cfg, 2, monkeypatch, gate_replay=True)
    dv = SSM._mlstm_dims(cfg)[3]
    for _, (_, y_aug) in calls:           # the normalizer is carried
        assert y_aug.shape[-1] == dv + 16 and bool(
            (y_aug[..., dv] != 0).any())


def test_retnet_decays_at_a_head_base():
    whole = SSM._retnet_log_gamma(10, "cpu")
    for h0, n in ((0, 5), (5, 5), (2, 2), (9, 1)):
        assert torch.equal(SSM._retnet_log_gamma(n, "cpu", h0),
                           whole[h0:h0 + n])
    # numbered from 0, the second rank's heads would decay as the first's
    assert not torch.equal(SSM._retnet_log_gamma(5, "cpu"), whole[5:])


def test_cuts_and_their_fallback():
    """The cut shapes, and a layer whose heads tp does not divide (the
    smoke GLA's 2 heads at tp = 4, retnet-2.7b's 10 at tp = 4) is the
    whole layer on every rank: ``layer_par``'s fallback, also through
    ``tp_params``, which still splits what tp divides (the FFN)."""
    cfg = _cfg("gla-2.7b", "fp32", heads=4)
    p = SSM.init_gla_family(torch.Generator().manual_seed(0), cfg, "gla",
                            "cpu")
    s = SSM.gla_family_tp_shard(p, cfg, _rank(2, 1))
    assert s["wq"].shape == (64, 64) and s["wgb"].shape == (16, 64)
    assert s["gb"].shape == (64,) and s["wo"].shape == (64, 64)
    assert s["wga"] is p["wga"]
    two = _cfg("gla-2.7b", "fp32")
    p2 = SSM.init_gla_family(torch.Generator().manual_seed(0), two, "gla",
                             "cpu")
    assert SSM.gla_family_tp_shard(p2, two, _rank(4, 3)) is p2
    assert TP.layer_par(10, _rank(4, 0)) is None
    # through tp_params: the mixer whole, the FFN's 128 columns split
    par = SH.Parallel(SH.AbstractMesh((4,), ("model",)), data_axes=())
    mp = M.init_model(two, torch.Generator().manual_seed(0), device="meta")
    cut = SH.tp_params(mp, two, par)
    for whole, part in zip(mp["groups"], cut["groups"]):
        assert part[0]["mixer"] is whole[0]["mixer"]
        assert part[0]["ffn"]["wi"].shape[1] * 4 == \
            whole[0]["ffn"]["wi"].shape[1]
    xc = _cfg("xlstm-1.3b", "fp32")
    m = SSM.init_mlstm(torch.Generator().manual_seed(0), xc, "cpu")
    ms = SSM.mlstm_tp_shard(m, xc, _rank(2, 1))
    assert ms["wi"].shape == (64, 2) and ms["wq"].shape == (1, 64, 64)
    assert ms["conv_w"].shape == (4, 64) and ms["fb"] is m["fb"]
    st = SSM.mlstm_init_state(3, xc, "cpu", par=_rank(2, 0))
    assert st["S"].shape == (3, 1, 80, 64) and st["conv"].shape == (3, 3, 64)
    dc = _cfg("deepseek-v2-236b", "fp32")
    a = ATT.init_mla(torch.Generator().manual_seed(0), dc, "cpu")
    sa = ATT.mla_tp_shard(a, dc, _rank(4, 2))
    assert sa["wq_b"].shape == (64, 48) and sa["w_uk"].shape == (1, 32, 64)
    assert sa["wo"].shape == (32, 128) and sa["wkv_a"] is a["wkv_a"]
    # the sLSTM is whole on every rank: no cut, no par
    assert "slstm" not in SSM.TP_SHARDS


@pytest.mark.parametrize("tag", ["fp32", "sr"])
def test_mla_heads_equal_the_whole_layer(tag, no_sum, monkeypatch):
    """deepseek-v2-236b's MLA (4 query heads) at tp = 2 and 4: a rank's
    queries and prefill contexts of its heads (``blockwise_attention``'s
    operand and output) bitwise the whole layer's, its latent cache
    bitwise the whole layer's after each append (one stream for every
    head: no head base), the ranks' partial outputs summing to the
    whole's.  The decode op's contexts on the CPU are its plain version's
    batched BLAS products over the query rows, whose rounding follows the
    row count: a rank's agree to rtol 1e-6 (the kernels, whose 16-row
    blocks make them bitwise, are held on the card: ``chip_smoke.py``
    phase 70)."""
    cfg = _cfg("deepseek-v2-236b", tag)
    p = ATT.init_mla(torch.Generator().manual_seed(5), cfg, "cpu")
    x, xs = _inputs(cfg.d_model, seed=2)
    pos = torch.arange(S)[None].expand(B, S)
    flash = _Spy(monkeypatch, ATT, "blockwise_attention")
    out = _Spy(monkeypatch, ATT, "_mla_out")

    def run(pp, par):
        ys = [ATT.mla_forward(pp, x, cfg, pos, par)]
        ckv = ATT.mla_cache_stream(pp, x, cfg, pos)
        cache = M._build_kv_cache(ckv[:, :, None, :], None, cfg,
                                  v_width=cfg.mla.kv_lora)
        caches = []
        for i, xi in enumerate(xs):
            y, cache = ATT.mla_decode(pp, xi, cache, cfg,
                                      torch.full((B, 1), S + i), 60 + i, par)
            ys.append(y)
            caches.append(T.tree_map(torch.clone, cache))
        return torch.cat(ys, 1), caches

    y_whole, c_whole = run(p, None)
    w_flash, w_out = flash.take(), out.take()
    for tp in (2, 4):
        n = cfg.n_heads // tp
        total = torch.zeros_like(y_whole)
        for r in range(tp):
            y, caches = run(ATT.mla_tp_shard(p, cfg, _rank(tp, r)),
                            _rank(tp, r))
            total += y
            for (a_w, o_w), (a_r, o_r) in zip(w_flash, flash.take()):
                _same(a_r[0], _heads(a_w[0], r * n, n, 2), "MLA queries")
                _same(o_r, _heads(o_w, r * n, n, 2), "MLA prefill context")
            for (a_w, _), (a_r, _) in zip(w_out, out.take()):
                want = a_w[1][:, r * n:(r + 1) * n]
                np.testing.assert_allclose(
                    a_r[1].numpy(), want.numpy(), rtol=1e-6,
                    atol=1e-6 * float(want.abs().max()))
            for cw, cr in zip(c_whole, caches):
                assert isinstance(cr, AC.KVCache) and cr.v is None
                _same(cr.k, cw.k, "the latent cache")
        want = y_whole.numpy()
        np.testing.assert_allclose(total.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
