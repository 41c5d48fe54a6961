"""State-update mixers -- PyTorch port of ``repro/models/ssm.py``: Mamba-2,
the GLA family (GLA, RetNet, HGRN2) and xLSTM's mLSTM and sLSTM.

Prefill runs the chunked linear-attention form (quadratic within chunks,
recurrent across chunks), with scalar per-step decay (Mamba-2, RetNet,
mLSTM) or per-channel decay (GLA, HGRN2); decode routes through ONE
registered SPU op invocation per layer (``state_update_step``), whose MX8
backend on the card is the fused CUDA kernel.  What differs per family is
the decay hook that makes Eq. 2's d_t (``_DECAY_HOOKS``) and the
projections around the op.  The sLSTM is a vector recurrence with fp32
carries and no SPU op: plain PyTorch, prefill a loop over positions.

Under tensor parallelism the model axis of a ``par`` that divides a
mixer's heads splits them (``TP_SHARDS``, Megatron's column / row cuts); a
layer whose heads it does not divide stays whole (``dist/tp.py::
layer_par``).  A rank projects, scans and stores its heads, each stochastic
rounding counted from its first head of the layer's
(``ops.sr_heads_from``), and one sum over the model axis adds the ranks'
output products:

* Mamba-2 (:func:`mamba2_tp_shard`): its heads' channels, convolved; the
  gated norm sums its squares over the model axis.
* The GLA family (:func:`gla_family_tp_shard`): its heads' columns of the
  q / k / v / output-gate projections and of GLA's and HGRN2's gates;
  RetNet's fixed decays are those of its global heads.
* mLSTM (:func:`mlstm_tp_shard`): its heads' channels of ``d_up``, the
  conv tail of those channels, its block-diagonal heads.  The input and
  forget gates read every channel of ``u``: as in the JAX package's
  layout (``wi`` / ``wf`` sharded on their ``d_up`` rows), a rank takes
  the rows of its channels and a second sum over the model axis adds the
  ranks' (B, S, 2H) gate pre-activations, after which each rank adds the
  bias and keeps its heads' gates.

The sLSTM stays whole on every rank, as the JAX package's ``shard_map``
keeps it (batch-split only).

In training each mixer's normed input enters its split projections
through ``dist.tp.tp_enter`` (Megatron's f) and leaves through
``tp_sum`` (g); what a rank computes whole and its split heads read --
Mamba-2's B / C stream, GLA's gate bottleneck, HGRN2's ``beta``, the
mLSTM's forget bias -- enters them through ``tp_copy``, so every
weight's gradient is whole on each rank (for its shard where it is cut).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from repro_torch import ops as OPS
from repro_torch.core import formats as F
from repro_torch.dist import tp as TP
from repro_torch.kernels.mx_quant import store_quantized
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = dict
MixerState = Dict[str, object]


def _spu_state_update(state, decay, k, v, q, cfg: ModelConfig, seed: int):
    """The one decode-time Eq. 2 invocation (registry-dispatched)."""
    return OPS.state_update_step(state, decay, k, v, q, cfg.state_quant,
                                 seed=seed)


#: per-family decode decay hooks: log-decay -> Eq. 2 d_t.  Scalar families
#: feed (B,H,1); vector-gated families the per-channel (B,H,dk) gate.
_DECAY_HOOKS = {
    "gla": lambda log_f: torch.exp(log_f[:, :, 0]),        # (B,H,dk)
    "hgrn2": lambda log_f: torch.exp(log_f[:, :, 0]),      # (B,H,dk)
    "retnet": lambda log_f: torch.exp(log_f[..., :1]),     # (B,H,1)
    "mamba2": lambda log_f: torch.exp(log_f),              # (B,H,1)
    "mlstm": lambda log_f: torch.exp(log_f),               # (B,H,1)
}

#: the mixers that share the GLA-family projections
GLA_FAMILY = ("gla", "retnet", "hgrn2")


def chunked_la_scalar(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_a: torch.Tensor, chunk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scalar-decay chunked scan.

    q, k: (B,H,S,dk); v: (B,H,S,dv); log_a: (B,H,S) per-step log decay.
    Returns y (B,H,S,dv) and the final state (B,H,dk,dv) in f32.
    """
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, S)
    S0_len = S
    pad = (-S) % c
    if pad:  # zero tokens with decay 1 leave the state untouched
        def zpad(a):
            return Fn.pad(a, (0, 0) * (a.dim() - 3) + (0, pad))
        q, k, v, log_a = zpad(q), zpad(k), zpad(v), zpad(log_a)
        S += pad
    nc = S // c
    qc = q.reshape(B, H, nc, c, dk)
    kc = k.reshape(B, H, nc, c, dk)
    vc = v.reshape(B, H, nc, c, dv)
    cum = torch.cumsum(log_a.to(torch.float32).reshape(B, H, nc, c), dim=-1)
    total = cum[..., -1:]
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    S_prev = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
    ys = []
    for i in range(nc):
        qi, ki, vi = qc[:, :, i], kc[:, :, i], vc[:, :, i]
        cumi, toti = cum[:, :, i], total[:, :, i]
        # decays above the diagonal grow without bound (they are masked
        # below); exp(-inf) there keeps their backward finite
        dmat = torch.exp(torch.where(
            tril, cumi[..., :, None] - cumi[..., None, :], -torch.inf))
        A = torch.einsum("bhcd,bhed->bhce", qi.float(), ki.float()) * dmat
        A = torch.where(tril, A, torch.zeros_like(A))
        y = torch.einsum("bhce,bhev->bhcv", A.to(vi.dtype), vi).float()
        q_in = (qi.float() * torch.exp(cumi)[..., None]).to(qi.dtype)
        y = y + torch.einsum("bhcd,bhdv->bhcv", q_in,
                             S_prev.to(qi.dtype)).float()
        k_end = (ki.float() * torch.exp(toti - cumi)[..., None]).to(ki.dtype)
        S_prev = torch.exp(toti)[..., None] * S_prev + torch.einsum(
            "bhcd,bhcv->bhdv", k_end, vi).float()
        ys.append(y)
    y = torch.stack(ys, dim=2).reshape(B, H, S, dv)[:, :, :S0_len]
    return y, S_prev


def chunked_la_vector(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_f: torch.Tensor, chunk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vector-decay chunked scan (GLA / HGRN2).

    log_f: (B,H,S,dk) per-channel log decay, clamped >= cfg.log_decay_min by
    the caller so exp(-cum) stays finite within a chunk (e^64 at most for a
    64-token chunk: fp32 holds it).  Returns y (B,H,S,dv) and the final
    state (B,H,dk,dv) in f32.
    """
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, S)
    S0_len = S
    pad = (-S) % c
    if pad:  # zero tokens with log-decay 0 leave the state untouched
        def zpad(a):
            return Fn.pad(a, (0, 0, 0, pad))
        q, k, v, log_f = zpad(q), zpad(k), zpad(v), zpad(log_f)
        S += pad
    nc = S // c
    qc = q.reshape(B, H, nc, c, dk)
    kc = k.reshape(B, H, nc, c, dk)
    vc = v.reshape(B, H, nc, c, dv)
    cum = torch.cumsum(log_f.to(torch.float32).reshape(B, H, nc, c, dk),
                       dim=-2)
    total = cum[..., -1:, :]
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    S_prev = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
    ys = []
    for i in range(nc):
        qi, ki, vi = qc[:, :, i], kc[:, :, i], vc[:, :, i]
        cumi, toti = cum[:, :, i], total[:, :, i]
        q_in = qi.float() * torch.exp(cumi)
        k_de = ki.float() * torch.exp(-cumi)
        A = torch.einsum("bhcd,bhed->bhce", q_in, k_de)
        A = torch.where(tril, A, torch.zeros_like(A))
        y = torch.einsum("bhce,bhev->bhcv", A.to(vi.dtype), vi).float()
        y = y + torch.einsum("bhcd,bhdv->bhcv", q_in, S_prev)
        k_end = ki.float() * torch.exp(toti - cumi)
        S_prev = torch.exp(toti[..., 0, :, None]) * S_prev + torch.einsum(
            "bhcd,bhcv->bhdv", k_end, vi.float())
        ys.append(y)
    y = torch.stack(ys, dim=2).reshape(B, H, S, dv)[:, :, :S0_len]
    return y, S_prev


def _store_state(S_logical: torch.Tensor, cfg: ModelConfig) -> OPS.StateLike:
    """(B,H,dk,dv) f32 -> stored container (B,H,dv,dk)."""
    St = S_logical.transpose(-1, -2).contiguous()
    sq = cfg.state_quant
    if not sq.quantized:
        return St.to(F.FLOAT_DTYPES[sq.fmt])
    return store_quantized(St, sq)


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x: (B,S,C), w: (d_conv, C): y_t = sum_i w_i * x_{t-d_conv+1+i} + b."""
    d_conv = w.shape[0]
    out = torch.zeros_like(x)
    for i in range(d_conv):
        shift = d_conv - 1 - i
        xi = Fn.pad(x, (0, 0, shift, 0))[:, :x.shape[1]]
        out = out + xi * w[i]
    return out + b


def causal_conv_step(x_new: torch.Tensor, conv_state: torch.Tensor,
                     w: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token conv step.  x_new: (B,C); conv_state: (B,d_conv-1,C)."""
    win = torch.cat([conv_state, x_new[:, None]], dim=1)      # (B,d_conv,C)
    y = torch.einsum("bdc,dc->bc", win, w) + b
    return y, win[:, 1:]


def _m2_dims(cfg: ModelConfig):
    sc = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    return d_inner, d_inner // sc.head_dim, sc.d_state, sc.head_dim


def _m2_shard(cfg: ModelConfig, par=None):
    """``(d_inner, H, h0, lp)``: the rank's channels, heads and first head
    of a Mamba-2 layer, and ``par`` where its model axis splits the heads
    (None: the whole layer)."""
    _, H_all, _, P = _m2_dims(cfg)
    H, h0, lp = TP.local_share(H_all, par)
    return H * P, H, h0, lp


def mamba2_tp_shard(p: Params, cfg: ModelConfig, par) -> Params:
    """A rank's Mamba-2 weights under ``par`` (``p`` itself where its
    model axis does not split the heads): ``wz`` / ``wx`` / ``conv_x_*``
    and the gated norm's scale keep its heads' channels, ``wdt`` /
    ``A_log`` / ``D`` / ``dt_bias`` its heads, ``out_proj`` the rows of
    its channels; ``wbc`` and ``conv_bc_*`` stay whole (every head reads
    B and C)."""
    d_inner, H, h0, lp = _m2_shard(cfg, par)
    if lp is None:
        return p
    P = cfg.ssm.head_dim
    ch, hd = (h0 * P, d_inner), (h0, H)
    out = dict(p)
    for name in ("wz", "wx", "conv_x_w"):
        out[name] = TP.narrow(p[name], -1, *ch)
    out["wdt"] = TP.narrow(p["wdt"], -1, *hd)
    for name in ("A_log", "D", "dt_bias"):
        out[name] = TP.narrow(p[name], 0, *hd)
    for name in ("conv_x_b", "out_proj"):
        out[name] = TP.narrow(p[name], 0, *ch)
    out["norm"] = {**p["norm"], "scale": TP.narrow(p["norm"]["scale"], 0,
                                                   *ch)}
    return out


def _conv_tail(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The last ``d_conv - 1`` rows of ``x`` (B, S, C), a conv cache's
    contents after a prompt; zero rows stand in for positions before a
    prompt shorter than that."""
    tail = cfg.ssm.d_conv - 1
    xt = x[:, -tail:]
    if xt.shape[1] < tail:
        xt = Fn.pad(xt, (0, 0, tail - xt.shape[1], 0))
    return xt


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d = cfg.d_model
    d_inner, H, N, P = _m2_dims(cfg)
    dt = getattr(torch, cfg.param_dtype)
    dc = cfg.ssm.d_conv

    def conv_w(width):
        return (torch.randn((dc, width), generator=gen, device=device)
                * (1.0 / np.sqrt(dc))).to(dt)

    return {
        "wz": L.dense_init(gen, d, d_inner, dt, device),
        "wx": L.dense_init(gen, d, d_inner, dt, device),
        "wbc": L.dense_init(gen, d, 2 * N, dt, device),
        "wdt": L.dense_init(gen, d, H, dt, device),
        "conv_x_w": conv_w(d_inner),
        "conv_x_b": torch.zeros((d_inner,), dtype=dt, device=device),
        "conv_bc_w": conv_w(2 * N),
        "conv_bc_b": torch.zeros((2 * N,), dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)),
        "D": torch.ones((H,), device=device),
        "dt_bias": torch.full((H,), float(np.log(np.expm1(0.01))),
                              device=device),
        "norm": L.init_norm(d_inner, "rmsnorm", dt, device),
        "out_proj": L.dense_init(gen, d_inner, d, dt, device,
                                 1.0 / np.sqrt(2 * cfg.n_layers)),
    }


def _m2_project(p, x, cfg, x_whole=None):
    """z, x, B, C and dt of ``x``; B and C (whole on every rank: every
    head reads them) of ``x_whole`` where one is given."""
    N = cfg.ssm.d_state
    bc = (x if x_whole is None else x_whole) @ p["wbc"]
    return x @ p["wz"], x @ p["wx"], bc[..., :N], bc[..., N:], x @ p["wdt"]


def mamba2_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                   want_cache: bool = True, par=None
                   ) -> Tuple[torch.Tensor, MixerState]:
    """Full-sequence Mamba-2; the decode state (``None`` unless
    ``want_cache``: a training forward stores and quantizes nothing).
    ``par``: the rank's heads (the prefill's stored state rounds to
    nearest, so it needs no head base)."""
    B, S, _ = x.shape
    _, _, N, P = _m2_dims(cfg)
    d_inner, H, _, lp = _m2_shard(cfg, par)
    x_split, x_whole = TP.tp_enter(x, lp)
    z, xin, Bv, Cv, dt_ = _m2_project(p, x_split, cfg, x_whole)
    xin = Fn.silu(causal_conv(xin, p["conv_x_w"], p["conv_x_b"]))
    bc = TP.tp_copy(Fn.silu(causal_conv(torch.cat([Bv, Cv], -1),
                                        p["conv_bc_w"], p["conv_bc_b"])), lp)
    Bv, Cv = bc[..., :N], bc[..., N:]

    dt_f = Fn.softplus(dt_.to(torch.float32) + p["dt_bias"])    # (B,S,H)
    a = -torch.exp(p["A_log"])
    log_decay = (dt_f * a).transpose(1, 2)                      # (B,H,S)
    k = Bv[:, :, None, :].expand(B, S, H, N).transpose(1, 2)
    q = Cv[:, :, None, :].expand(B, S, H, N).transpose(1, 2)
    xh = xin.reshape(B, S, H, P)
    v = (xh * dt_f[..., None].to(xh.dtype)).transpose(1, 2)     # (B,H,S,P)

    y, S_fin = chunked_la_scalar(q, k, v, log_decay, cfg.ssm.chunk)
    y = y + p["D"][None, :, None, None] * xh.transpose(1, 2)
    y = y.transpose(1, 2).reshape(B, S, d_inner).to(x.dtype)
    y = L.rmsnorm_gated(y, p["norm"]["scale"], z, cfg.norm_eps, lp)
    out = TP.tp_sum(y @ p["out_proj"], lp)
    if not want_cache:
        return out, None

    # conv caches hold the pre-activation inputs of the last d_conv-1 steps
    _, xin2, Bv2, Cv2, _ = _m2_project(p, _conv_tail(x, cfg), cfg)
    state = {"S": _store_state(S_fin, cfg), "conv_x": xin2,
             "conv_bc": torch.cat([Bv2, Cv2], -1)}
    return out, state


def mamba2_init_state(B: int, cfg: ModelConfig, device,
                      par=None) -> MixerState:
    """Zero state of the rank's heads under ``par``."""
    _, _, N, P = _m2_dims(cfg)
    d_inner, H, _, _ = _m2_shard(cfg, par)
    dt = getattr(torch, cfg.param_dtype)
    tail = cfg.ssm.d_conv - 1
    return {"S": OPS.init_state(B, H, N, P, cfg.state_quant, device=device),
            "conv_x": torch.zeros((B, tail, d_inner), dtype=dt, device=device),
            "conv_bc": torch.zeros((B, tail, 2 * N), dtype=dt, device=device)}


def mamba2_decode(p: Params, x: torch.Tensor, state: MixerState,
                  cfg: ModelConfig, seed: int, par=None
                  ) -> Tuple[torch.Tensor, MixerState]:
    """x: (B, 1, d) one token.  ``par``: the rank's heads, the state
    update's stochastic rounding counted from its first head of the
    layer's."""
    B = x.shape[0]
    _, H_all, N, P = _m2_dims(cfg)
    d_inner, H, h0, lp = _m2_shard(cfg, par)
    z, xin, Bv, Cv, dt_ = _m2_project(p, x[:, 0], cfg)
    xin, conv_x_state = causal_conv_step(xin, state["conv_x"],
                                         p["conv_x_w"], p["conv_x_b"])
    xin = Fn.silu(xin)
    bc, conv_bc_state = causal_conv_step(torch.cat([Bv, Cv], -1),
                                         state["conv_bc"], p["conv_bc_w"],
                                         p["conv_bc_b"])
    bc = Fn.silu(bc)
    Bv, Cv = bc[..., :N], bc[..., N:]

    dt_f = Fn.softplus(dt_.to(torch.float32) + p["dt_bias"])    # (B,H)
    a = -torch.exp(p["A_log"])
    decay = _DECAY_HOOKS["mamba2"]((dt_f * a)[..., None])       # (B,H,1)
    k = Bv[:, None, :].expand(B, H, N)
    q = Cv[:, None, :].expand(B, H, N)
    xh = xin.reshape(B, H, P)
    v = xh * dt_f[..., None]

    with OPS.sr_heads_from(h0, H_all):
        Sn, y = _spu_state_update(state["S"], decay, k, v, q, cfg, seed)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(B, d_inner).to(x.dtype)
    y = L.rmsnorm_gated(y, p["norm"]["scale"], z, cfg.norm_eps, lp)
    out = TP.tp_sum(y @ p["out_proj"], lp)[:, None]
    return out, {"S": Sn, "conv_x": conv_x_state, "conv_bc": conv_bc_state}


# ---------------------------------------------------------------------------
# GLA family (GLA / RetNet / HGRN2): shared projections
# ---------------------------------------------------------------------------

def _gla_dims(cfg: ModelConfig):
    sc = cfg.ssm
    return (sc.n_heads or cfg.n_heads, sc.dk_head or cfg.head_dim,
            sc.dv_head or cfg.head_dim)


def gla_family_tp_shard(p: Params, cfg: ModelConfig, par) -> Params:
    """A rank's GLA / RetNet / HGRN2 weights under ``par`` (``p`` itself
    where its model axis does not split the heads): the columns of its
    heads of ``wq`` / ``wk`` (and GLA's ``wgb`` / ``gb``, HGRN2's ``wf`` /
    ``fb``: H * dk wide) and of ``wv`` / ``wg_out`` (H * dv), and the rows
    of ``wo`` for them.  GLA's ``wga`` (d x 16) and HGRN2's ``beta`` stay
    whole."""
    H_all, dk, dv = _gla_dims(cfg)
    H, h0, lp = TP.local_share(H_all, par)
    if lp is None:
        return p
    k_cols, v_cols = (h0 * dk, H * dk), (h0 * dv, H * dv)
    out = dict(p)
    for name in ("wq", "wk", "wgb", "wf"):
        if name in p:
            out[name] = TP.narrow(p[name], -1, *k_cols)
    for name in ("gb", "fb"):
        if name in p:
            out[name] = TP.narrow(p[name], 0, *k_cols)
    for name in ("wv", "wg_out"):
        out[name] = TP.narrow(p[name], -1, *v_cols)
    out["wo"] = TP.narrow(p["wo"], 0, *v_cols)
    return out


def init_gla_family(gen: torch.Generator, cfg: ModelConfig, kind: str,
                    device) -> Params:
    """HGRN2's ``beta`` (the depth-dependent forget-gate lower bound) is
    set by the model assembler."""
    d = cfg.d_model
    H, dk, dv = _gla_dims(cfg)
    dt = getattr(torch, cfg.param_dtype)
    p = {
        "wq": L.dense_init(gen, d, H * dk, dt, device),
        "wk": L.dense_init(gen, d, H * dk, dt, device),
        "wv": L.dense_init(gen, d, H * dv, dt, device),
        "wg_out": L.dense_init(gen, d, H * dv, dt, device),
        "wo": L.dense_init(gen, H * dv, d, dt, device,
                           1.0 / np.sqrt(2 * cfg.n_layers)),
    }
    if kind == "gla":
        p["wga"] = L.dense_init(gen, d, 16, dt, device)
        p["wgb"] = L.dense_init(gen, 16, H * dk, dt, device)
        p["gb"] = torch.full((H * dk,), 4.0, device=device)  # gates near 1
    elif kind == "hgrn2":
        p["wf"] = L.dense_init(gen, d, H * dk, dt, device)
        p["fb"] = torch.zeros((H * dk,), device=device)
        p["beta"] = torch.zeros((1,), device=device)
    elif kind != "retnet":                  # RetNet: fixed per-head decay
        raise ValueError(kind)
    return p


def _retnet_log_gamma(H: int, device, h0: int = 0) -> torch.Tensor:
    """The log decays of heads ``h0 .. h0 + H - 1`` of a RetNet layer (head
    h decays by ``1 - 2^(-5 - h)``, numbered in the whole layer)."""
    h = torch.arange(h0, h0 + H, dtype=torch.float32, device=device)
    return torch.log1p(-torch.exp2(-5.0 - h))


def _gla_family_qkv(p, x, cfg: ModelConfig, kind: str, par=None,
                    x_whole=None):
    """q, k (B,H,S,dk), v (B,H,S,dv) and the log decay: (B,H,S,dk) for GLA
    (``log_sigmoid(g) / 16``) and HGRN2 (the forget gate over its lower
    bound, with ``k = 1 - f``), both clamped to ``ssm.log_decay_min``;
    (B,H,S) for RetNet (the fixed per-head gamma).  The rank's H heads
    under ``par``; GLA's whole gate bottleneck ``wga`` reads ``x_whole``
    where one is given."""
    B, S, _ = x.shape
    H_all, dk, dv = _gla_dims(cfg)
    H, h0, _ = TP.local_share(H_all, par)
    q = (x @ p["wq"]).reshape(B, S, H, dk).transpose(1, 2)
    k = (x @ p["wk"]).reshape(B, S, H, dk).transpose(1, 2)
    v = (x @ p["wv"]).reshape(B, S, H, dv).transpose(1, 2)
    if kind == "gla":
        g16 = (x if x_whole is None else x_whole) @ p["wga"]
        g = TP.tp_copy(g16, par) @ p["wgb"] + p["gb"]
        log_f = Fn.logsigmoid(g.to(torch.float32)) / 16.0
        log_f = torch.clamp(log_f, min=cfg.ssm.log_decay_min)
        log_f = log_f.reshape(B, S, H, dk).transpose(1, 2)
    elif kind == "hgrn2":
        f_pre = (x @ p["wf"]) + p["fb"]
        beta = TP.tp_copy(p["beta"], par)[0]
        fgate = beta + (1.0 - beta) * torch.sigmoid(f_pre.to(torch.float32))
        log_f = torch.clamp(torch.log(fgate + 1e-9),
                            min=cfg.ssm.log_decay_min)
        log_f = log_f.reshape(B, S, H, dk).transpose(1, 2)
        k = (1.0 - torch.exp(log_f)).to(k.dtype)    # input gate = 1 - f
    else:
        log_f = _retnet_log_gamma(H, x.device, h0)[None, :, None].expand(
            B, H, S)
    return q * (dk ** -0.5), k, v, log_f


def _gla_family_out(p, y, x, cfg: ModelConfig, lp=None):
    """Per-head RMSNorm of y (B,H,S,dv), output gate, out projection (the
    ranks' products summed over the model axis of ``lp``)."""
    B, S, _ = x.shape
    y = L.head_rmsnorm(y, cfg.norm_eps).transpose(1, 2).reshape(B, S, -1)
    gate = Fn.silu(x @ p["wg_out"])
    return TP.tp_sum((y.to(x.dtype) * gate) @ p["wo"], lp)


def gla_family_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                       kind: str, want_cache: bool = True, par=None
                       ) -> Tuple[torch.Tensor, MixerState]:
    """Full-sequence GLA / RetNet / HGRN2; ``par``: the rank's heads (the
    stored state rounds to nearest: no head base)."""
    _, _, lp = TP.local_share(_gla_dims(cfg)[0], par)
    x, x_whole = TP.tp_enter(x, lp)
    q, k, v, log_f = _gla_family_qkv(p, x, cfg, kind, lp, x_whole)
    scan = chunked_la_scalar if kind == "retnet" else chunked_la_vector
    y, S_fin = scan(q, k, v, log_f, cfg.ssm.chunk)
    out = _gla_family_out(p, y, x, cfg, lp)
    return out, ({"S": _store_state(S_fin, cfg)} if want_cache else None)


def gla_family_init_state(B: int, cfg: ModelConfig, device,
                          par=None) -> MixerState:
    """Zero state of the rank's heads under ``par``."""
    H_all, dk, dv = _gla_dims(cfg)
    H, _, _ = TP.local_share(H_all, par)
    return {"S": OPS.init_state(B, H, dk, dv, cfg.state_quant,
                                device=device)}


def gla_family_decode(p: Params, x: torch.Tensor, state: MixerState,
                      cfg: ModelConfig, kind: str, seed: int, par=None
                      ) -> Tuple[torch.Tensor, MixerState]:
    """x: (B, 1, d) one token.  ``par``: the rank's heads, the state
    update's stochastic rounding counted from its first head of the
    layer's."""
    H_all = _gla_dims(cfg)[0]
    _, h0, lp = TP.local_share(H_all, par)
    q, k, v, log_f = _gla_family_qkv(p, x, cfg, kind, lp)   # (B,H,1,*)
    decay = _DECAY_HOOKS[kind](log_f)
    with OPS.sr_heads_from(h0, H_all):
        Sn, y = _spu_state_update(state["S"], decay, k[:, :, 0], v[:, :, 0],
                                  q[:, :, 0], cfg, seed)
    return _gla_family_out(p, y[:, :, None], x, cfg, lp), {"S": Sn}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory block)
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg: ModelConfig):
    sc = cfg.ssm
    d_up = sc.expand * cfg.d_model
    H = sc.n_heads or cfg.n_heads
    dk = d_up // H
    dv = d_up // H
    dv_aug = dv + 16            # [v, 1, 0...] -- normalizer folded in
    return d_up, H, dk, dv, dv_aug


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d = cfg.d_model
    d_up, H, dk, dv, _ = _mlstm_dims(cfg)
    dt = getattr(torch, cfg.param_dtype)
    dc = cfg.ssm.d_conv

    def heads(n):               # block-diagonal per-head (H, n, n)
        return (torch.randn((H, n, n), generator=gen, device=device)
                / np.sqrt(n)).to(dt)

    return {
        "wu": L.dense_init(gen, d, d_up, dt, device),
        "wz": L.dense_init(gen, d, d_up, dt, device),
        "conv_w": (torch.randn((dc, d_up), generator=gen, device=device)
                   * (1.0 / np.sqrt(dc))).to(dt),
        "conv_b": torch.zeros((d_up,), dtype=dt, device=device),
        "wq": heads(dk), "wk": heads(dk), "wv": heads(dv),
        "wi": L.dense_init(gen, d_up, H, torch.float32, device),
        "wf": L.dense_init(gen, d_up, H, torch.float32, device),
        "fb": torch.full((H,), 3.0, device=device),  # forget gates open
        "hnorm": torch.ones((H, dv), dtype=dt, device=device),
        "down": L.dense_init(gen, d_up, d, dt, device,
                             1.0 / np.sqrt(2 * cfg.n_layers)),
    }


def _mlstm_shard(cfg: ModelConfig, par=None):
    """``(channels, H, h0, lp)``: the rank's channels of ``d_up``, its heads
    and first head of an mLSTM layer, and ``par`` where its model axis
    splits the heads (None: the whole layer)."""
    _, H_all, dk, _, _ = _mlstm_dims(cfg)
    H, h0, lp = TP.local_share(H_all, par)
    return H * dk, H, h0, lp


def mlstm_tp_shard(p: Params, cfg: ModelConfig, par) -> Params:
    """A rank's mLSTM weights under ``par`` (``p`` itself where its model
    axis does not split the heads): the columns of its heads' channels of
    ``wu`` / ``wz`` / ``conv_w`` / ``conv_b``, its heads of the
    block-diagonal ``wq`` / ``wk`` / ``wv`` and of ``hnorm``, and the rows
    of its channels of ``down`` and of the gates ``wi`` / ``wf`` (whose
    pre-activations the step sums over the model axis); ``fb`` stays
    whole."""
    ch, H, h0, lp = _mlstm_shard(cfg, par)
    if lp is None:
        return p
    c0 = h0 * (ch // H)
    out = dict(p)
    for name in ("wu", "wz", "conv_w"):
        out[name] = TP.narrow(p[name], -1, c0, ch)
    for name in ("conv_b", "down", "wi", "wf"):
        out[name] = TP.narrow(p[name], 0, c0, ch)
    for name in ("wq", "wk", "wv", "hnorm"):
        out[name] = TP.narrow(p[name], 0, h0, H)
    return out


def _mlstm_gate_pre(p, u, lp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The input and forget gates' pre-activations (B, S, H) of every head
    of the layer: ``u`` (B, S, channels) times the rows of ``wi`` / ``wf``
    for those channels, summed over the model axis of ``lp`` in one
    collective (both gates at once; its gradient all-reduced too, as each
    rank reads its own heads' gates)."""
    H = p["wi"].shape[-1]
    g = TP.tp_sum_split(torch.cat([u @ p["wi"], u @ p["wf"]], -1), lp)
    return g[..., :H], g[..., H:]


def _mlstm_gates_qkv(p, u, uc, cfg: ModelConfig, par=None):
    """q (B,H,S,dk), k_eff = k * exp(i) (B,H,S,dk), v_aug = [v, 1, 0 x 15]
    (B,H,S,dv_aug) and the forget gate's log (B,H,S) of u / uc (B,S,d_up):
    the exp input gate rides in k, the normalizer n as state row dv.  The
    rank's heads and channels under ``par``."""
    B, S, _ = u.shape
    _, _, dk, dv, dv_aug = _mlstm_dims(cfg)
    _, H, h0, lp = _mlstm_shard(cfg, par)
    uh = uc.reshape(B, S, H, dk)
    q = torch.einsum("bshd,hde->bhse", uh, p["wq"])
    k = torch.einsum("bshd,hde->bhse", uh, p["wk"]) * dk ** -0.5
    v = torch.einsum("bshd,hde->bhse", u.reshape(B, S, H, dv), p["wv"])
    i_pre, f_pre = _mlstm_gate_pre(p, u, lp)
    i_log = torch.clamp(i_pre.to(torch.float32), -12.0, 4.0)
    fb = TP.tp_copy(p["fb"], lp)
    log_f = Fn.logsigmoid(f_pre.to(torch.float32) + fb)
    i_log = i_log[..., h0:h0 + H].transpose(1, 2)  # (B,H,S)
    log_f = log_f[..., h0:h0 + H].transpose(1, 2)
    k_eff = (k.to(torch.float32) * torch.exp(i_log)[..., None]).to(k.dtype)
    ones = torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)
    zeros = torch.zeros(v.shape[:-1] + (dv_aug - dv - 1,), dtype=v.dtype,
                        device=v.device)
    v_aug = torch.cat([v, ones, zeros], dim=-1)
    return q, k_eff, v_aug, log_f


def _mlstm_out(p, y_aug, z, cfg: ModelConfig, lp=None):
    """h = y / max(|n.q|, 1), per-head RMSNorm times ``hnorm``, output gate
    silu(z), down projection (the ranks' products summed over the model
    axis of ``lp``); y_aug (..., H, dv_aug) with heads before the last
    axis, z (..., channels): the rank's heads and their channels."""
    dv = _mlstm_dims(cfg)[3]
    y, n_dot = y_aug[..., :dv], y_aug[..., dv]
    h = y / torch.clamp(torch.abs(n_dot), min=1.0)[..., None]
    h = L.head_rmsnorm(h, cfg.norm_eps) * p["hnorm"]
    h = h.reshape(z.shape).to(z.dtype)
    return TP.tp_sum((h * Fn.silu(z)) @ p["down"], lp)


def mlstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  want_cache: bool = True, par=None
                  ) -> Tuple[torch.Tensor, MixerState]:
    """Full-sequence mLSTM; ``par``: the rank's heads and channels (the
    stored state rounds to nearest: no head base)."""
    lp = _mlstm_shard(cfg, par)[3]
    x = TP.tp_enter(x, lp)[0]
    u, z = x @ p["wu"], x @ p["wz"]
    uc = Fn.silu(causal_conv(u, p["conv_w"], p["conv_b"]))
    q, k_eff, v_aug, log_f = _mlstm_gates_qkv(p, u, uc, cfg, lp)
    y_aug, S_fin = chunked_la_scalar(q, k_eff, v_aug, log_f, cfg.ssm.chunk)
    out = _mlstm_out(p, y_aug.transpose(1, 2), z, cfg, lp)
    if not want_cache:
        return out, None
    # the conv tail holds u of the last d_conv-1 steps
    return out, {"S": _store_state(S_fin, cfg),
                 "conv": _conv_tail(u, cfg).contiguous()}


def mlstm_init_state(B: int, cfg: ModelConfig, device,
                     par=None) -> MixerState:
    """Zero state and conv tail of the rank's heads under ``par``."""
    _, _, dk, _, dv_aug = _mlstm_dims(cfg)
    ch, H, _, _ = _mlstm_shard(cfg, par)
    dt = getattr(torch, cfg.param_dtype)
    return {"S": OPS.init_state(B, H, dk, dv_aug, cfg.state_quant,
                                device=device),
            "conv": torch.zeros((B, cfg.ssm.d_conv - 1, ch), dtype=dt,
                                device=device)}


def mlstm_decode(p: Params, x: torch.Tensor, state: MixerState,
                 cfg: ModelConfig, seed: int, par=None
                 ) -> Tuple[torch.Tensor, MixerState]:
    """x: (B, 1, d) one token.  ``par``: the rank's heads, the state
    update's stochastic rounding counted from its first head of the
    layer's."""
    H_all = _mlstm_dims(cfg)[1]
    _, _, h0, lp = _mlstm_shard(cfg, par)
    u, z = x[:, 0] @ p["wu"], x[:, 0] @ p["wz"]
    conv_out, conv_state = causal_conv_step(u, state["conv"], p["conv_w"],
                                            p["conv_b"])
    uc = Fn.silu(conv_out)
    q, k_eff, v_aug, log_f = _mlstm_gates_qkv(p, u[:, None], uc[:, None],
                                              cfg, lp)
    decay = _DECAY_HOOKS["mlstm"](log_f)                       # (B,H,1)
    with OPS.sr_heads_from(h0, H_all):
        Sn, y_aug = _spu_state_update(state["S"], decay, k_eff[:, :, 0],
                                      v_aug[:, :, 0], q[:, :, 0], cfg, seed)
    out = _mlstm_out(p, y_aug, z, cfg, lp)[:, None]
    return out, {"S": Sn, "conv": conv_state}


# ---------------------------------------------------------------------------
# sLSTM (vector recurrence; inherently sequential)
# ---------------------------------------------------------------------------

def _slstm_dims(cfg: ModelConfig):
    H = cfg.ssm.n_heads or cfg.n_heads
    return H, cfg.d_model // H


def init_slstm(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d = cfg.d_model
    H, dh = _slstm_dims(cfg)
    dt = getattr(torch, cfg.param_dtype)
    return {
        "wx": L.dense_init(gen, d, 4 * d, dt, device),           # z,i,f,o
        "r": (torch.randn((H, dh, 4 * dh), generator=gen, device=device)
              / np.sqrt(dh)).to(dt),
        "b": torch.zeros((4 * d,), device=device),
        "out": L.dense_init(gen, d, d, dt, device,
                            1.0 / np.sqrt(2 * cfg.n_layers)),
    }


def _slstm_gx(p, x, cfg: ModelConfig):
    """Gate pre-activations from the input, (..., H, 4*dh)."""
    H, dh = _slstm_dims(cfg)
    gx = (x @ p["wx"]) + p["b"].to(x.dtype)
    return gx.reshape(gx.shape[:-1] + (H, 4 * dh))


def _slstm_cell(p, gx, carry):
    """gx: (B,H,4*dh) pre-activations from x; carry: (c, n, m, h)."""
    c_prev, n_prev, m_prev, h_prev = carry
    rec = torch.einsum("bhd,hde->bhe", h_prev.to(gx.dtype), p["r"])
    g = (gx + rec).to(torch.float32)
    zt, it, ft, ot = torch.chunk(g, 4, dim=-1)
    zt = torch.tanh(zt)
    log_f = Fn.logsigmoid(ft)
    m_t = torch.maximum(log_f + m_prev, it)
    i_p = torch.exp(it - m_t)
    f_p = torch.exp(log_f + m_prev - m_t)
    c_t = f_p * c_prev + i_p * zt
    n_t = f_p * n_prev + i_p
    h_t = torch.sigmoid(ot) * c_t / torch.clamp(n_t, min=1e-6)
    return c_t, n_t, m_t, h_t


def slstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  want_cache: bool = True
                  ) -> Tuple[torch.Tensor, MixerState]:
    """The prompt's positions one after another (the JAX package's
    ``lax.scan``), from the zero carry with ``m = -1e30``."""
    B, S, d = x.shape
    gx = _slstm_gx(p, x, cfg)                                 # (B,S,H,4dh)
    st = slstm_init_state(B, cfg, x.device)
    carry = (st["c"], st["n"], st["m"], st["h"])
    hs = []
    for t in range(S):
        carry = _slstm_cell(p, gx[:, t], carry)
        hs.append(carry[3])
    h = torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype)
    return h @ p["out"], dict(zip("cnmh", carry)) if want_cache else None


def slstm_init_state(B: int, cfg: ModelConfig, device) -> MixerState:
    H, dh = _slstm_dims(cfg)
    z0 = torch.zeros((B, H, dh), device=device)
    return {"c": z0, "n": z0.clone(), "m": torch.full_like(z0, -1e30),
            "h": z0.clone()}


def slstm_decode(p: Params, x: torch.Tensor, state: MixerState,
                 cfg: ModelConfig, seed: int
                 ) -> Tuple[torch.Tensor, MixerState]:
    """x: (B, 1, d) one token; ``seed`` is unused (no SPU op, fp32)."""
    B = x.shape[0]
    gx = _slstm_gx(p, x[:, 0], cfg)
    c, n, m, h = _slstm_cell(p, gx, (state["c"], state["n"], state["m"],
                                     state["h"]))
    out = (h.reshape(B, cfg.d_model).to(x.dtype) @ p["out"])[:, None]
    return out, {"c": c, "n": n, "m": m, "h": h}


# ---------------------------------------------------------------------------
# the recurrent mixers by kind (the model's one dispatch)
# ---------------------------------------------------------------------------

class Mixer(NamedTuple):
    """A recurrent mixer's functions: ``init(gen, cfg, device)``,
    ``forward(p, x, cfg, want_cache=True)`` (the state ``None`` without
    ``want_cache``), ``init_state(B, cfg, device)`` and
    ``decode(p, x, state, cfg, seed)``; those of a mixer in
    :data:`TP_SHARDS` also take a ``par``."""
    init: Callable
    forward: Callable
    init_state: Callable
    decode: Callable


def _gla_mixer(kind: str) -> Mixer:
    return Mixer(
        lambda gen, cfg, device: init_gla_family(gen, cfg, kind, device),
        lambda p, x, cfg, want_cache=True, par=None: gla_family_forward(
            p, x, cfg, kind, want_cache, par),
        gla_family_init_state,
        lambda p, x, state, cfg, seed, par=None: gla_family_decode(
            p, x, state, cfg, kind, seed, par))


MIXERS: Dict[str, Mixer] = {
    "mamba2": Mixer(init_mamba2, mamba2_forward, mamba2_init_state,
                    mamba2_decode),
    "mlstm": Mixer(init_mlstm, mlstm_forward, mlstm_init_state, mlstm_decode),
    "slstm": Mixer(init_slstm, slstm_forward, slstm_init_state, slstm_decode),
    **{kind: _gla_mixer(kind) for kind in GLA_FAMILY},
}


#: the mixers whose heads the model axis splits, and their cuts
#: (``forward``, ``decode`` and ``init_state`` then take a ``par``); the
#: sLSTM is whole on every rank
TP_SHARDS = {"mamba2": mamba2_tp_shard, "mlstm": mlstm_tp_shard,
             **{kind: gla_family_tp_shard for kind in GLA_FAMILY}}


def tp_heads(kind: str, cfg: ModelConfig) -> int:
    """The heads of a mixer of ``kind`` in :data:`TP_SHARDS` that the
    model axis splits (``dist.tp.layer_par``'s count)."""
    if kind == "mamba2":
        return _m2_dims(cfg)[1]
    if kind == "mlstm":
        return _mlstm_dims(cfg)[1]
    return _gla_dims(cfg)[0]


def mixer(kind: str) -> Mixer:
    """The recurrent mixer of ``kind``; ``ValueError`` for any other."""
    if kind not in MIXERS:
        raise ValueError(f"unknown mixer kind {kind!r}")
    return MIXERS[kind]
