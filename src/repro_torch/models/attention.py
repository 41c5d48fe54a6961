"""Attention mixers: GQA and MLA (DeepSeek-V2), PyTorch port of
``repro/models/attention.py``.

Prefill uses a blockwise ("flash") formulation in plain PyTorch -- q chunks
outer, kv chunks inner, streaming max / sum -- so the (S, S) score matrix
never materializes.  Decode goes through the registered SPU ops
(``kv_append`` + ``attn_decode`` / ``mla_decode``) in one step, the
speculative verify step through ``kv_append`` x n + ``spec_verify``.

MLA runs in absorbed form everywhere, as in the JAX package: queries are
projected into the latent space, so the cache is one (kv_lora + rope)
stream whose first kv_lora lanes are the values -- the kernels' MLA mode.

Under tensor parallelism (a ``par`` whose model axis divides the kv
heads) a rank holds the columns of its kv heads and of their query heads
and the rows of ``wo`` for them (:func:`tp_shard`): it
projects, caches and attends its heads only, and one sum over the model
axis adds the ranks' ``wo`` products.  The layers carry no bias, so none
is added after the sum.

In training (:func:`attention_forward`, :func:`mla_forward`) the normed
input enters the split heads through ``dist.tp.tp_enter`` (Megatron's f)
and the ``wo`` sum leaves through ``tp_sum`` (g), so each rank's weight
gradients are whole for its shard.

MLA splits its query heads the same way where the model axis divides them
(:func:`mla_tp_shard`): a rank holds its heads' columns of ``wq_b``, its
heads of the absorbed ``w_uk`` / ``w_uv`` and the rows of ``wo`` for them.
The latent cache is one stream that every head reads, so it stays whole
on every rank: each rank projects and appends the same latent (its
stochastic rounding counted over the whole stream, with no head base) and
the ranks' latent caches stay bitwise equal.  The JAX package's cache
layout shards the latent's time axis instead, which needs a softmax
combine across ranks; the port does not take it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import ops as OPS
from repro_torch.core import attention_cache as AC
from repro_torch.dist import tp as TP
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


def _mask_chunk(s, q_idx, k_idx, q_chunk, kv_chunk, prefix_len=0):
    """Additive causal mask for one (q chunk, kv chunk) pair; the first
    ``prefix_len`` kv positions are open to every query (prefix-LM)."""
    qp = q_idx * q_chunk + torch.arange(q_chunk, device=s.device)
    kp = k_idx * kv_chunk + torch.arange(kv_chunk, device=s.device)
    ok = qp[:, None] >= kp[None, :]
    if prefix_len:
        ok = ok | (kp[None, :] < prefix_len)
    return s + torch.where(ok, 0.0, NEG_INF).to(s.dtype)


def _scores(qi, kj, q_idx, k_idx, causal, prefix_len, q_chunk, kv_chunk):
    """One (q chunk, kv chunk) pair's masked scores (B, KVH, G, qc, kc)."""
    s = torch.einsum("bngqd,bnkd->bngqk", qi, kj)
    if causal:
        s = _mask_chunk(s, q_idx, k_idx, q_chunk, kv_chunk, prefix_len)
    return s


def _flash_fwd(qb, kb, vb, causal, prefix_len, q_chunk, kv_chunk):
    """qb: (nq,B,KVH,G,qc,dh) pre-scaled f32; kb / vb: (nk,B,KVH,kc,d*).
    q chunks outer, kv chunks inner, streaming max / sum.  Returns (out
    (nq,B,KVH,G,qc,dv), lse (nq,B,KVH,G,qc,1))."""
    nq, B, KVH, G, qc, _ = qb.shape
    outs, lses = [], []
    for qi in range(nq):
        m = torch.full((B, KVH, G, qc, 1), NEG_INF, device=qb.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KVH, G, qc, vb.shape[-1]), device=qb.device)
        for kj in range(kb.shape[0]):
            s = _scores(qb[qi], kb[kj], qi, kj, causal, prefix_len, q_chunk,
                        kv_chunk)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bngqk,bnkv->bngqv", p, vb[kj])
            m = m_new
        l = l.clamp(min=1e-30)
        outs.append(acc / l)
        lses.append(m + torch.log(l))
    return torch.stack(outs), torch.stack(lses)


class _Flash(torch.autograd.Function):
    """The blockwise attention with the flash backward (the JAX package's
    ``_flash`` custom VJP): the forward saves its inputs, output and
    log-sum-exp, and the backward recomputes each chunk pair's scores, so
    no (S, S) score matrix exists forward or backward."""

    @staticmethod
    def forward(ctx, qb, kb, vb, causal, prefix_len, q_chunk, kv_chunk):
        out, lse = _flash_fwd(qb, kb, vb, causal, prefix_len, q_chunk,
                              kv_chunk)
        ctx.save_for_backward(qb, kb, vb, out, lse)
        ctx.mask = (causal, prefix_len, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        qb, kb, vb, out, lse = ctx.saved_tensors
        causal, prefix_len, q_chunk, kv_chunk = ctx.mask
        Dr = (dout * out).sum(-1, keepdim=True)         # rowsum(dO * O)
        dq = torch.zeros_like(qb)
        dk = torch.zeros_like(kb)
        dv = torch.zeros_like(vb)
        for qi in range(qb.shape[0]):
            doi = dout[qi]
            for kj in range(kb.shape[0]):
                s = _scores(qb[qi], kb[kj], qi, kj, causal, prefix_len,
                            q_chunk, kv_chunk)
                p = torch.exp(s - lse[qi])              # (B,KVH,G,qc,kc)
                dv[kj] += torch.einsum("bngqk,bngqv->bnkv", p, doi)
                dp = torch.einsum("bngqv,bnkv->bngqk", doi, vb[kj])
                ds = p * (dp - Dr[qi])
                dq[qi] += torch.einsum("bngqk,bnkd->bngqd", ds, kb[kj])
                dk[kj] += torch.einsum("bngqk,bngqd->bnkd", ds, qb[qi])
        return dq, dk, dv, None, None, None, None


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, prefix_len: int = 0,
                        scale: Optional[float] = None, q_chunk: int = 512,
                        kv_chunk: int = 512) -> torch.Tensor:
    """q: (B,S,H,dh), k/v: (B,S,KVH,dh|dv) -> (B,S,H,dv).  Causal unless
    ``causal`` is false (an encoder: no mask at all); ``prefix_len > 0``
    opens the first ``prefix_len`` positions to every query, and only
    where attention is causal (as in the JAX package).  Differentiable
    through the flash backward (:class:`_Flash`); ``k`` and ``v`` may be
    views of one tensor (MLA), whose gradient then sums both."""
    B, S, H, dh = q.shape
    KVH, dv = k.shape[2], v.shape[-1]
    G = H // KVH
    scale = scale if scale is not None else dh ** -0.5
    q_chunk, kv_chunk = min(q_chunk, S), min(kv_chunk, S)
    if S % q_chunk or S % kv_chunk:
        raise ValueError(f"sequence length {S} must be a multiple of the "
                         f"chunks ({q_chunk}, {kv_chunk})")
    nq, nk = S // q_chunk, S // kv_chunk
    qb = (q.to(torch.float32) * scale).reshape(B, nq, q_chunk, KVH, G, dh)
    qb = qb.permute(1, 0, 3, 4, 2, 5)                  # (nq,B,KVH,G,qc,dh)
    kb = k.to(torch.float32).reshape(B, nk, kv_chunk, KVH, dh)
    kb = kb.permute(1, 0, 3, 2, 4)                     # (nk,B,KVH,kc,dh)
    vb = v.to(torch.float32).reshape(B, nk, kv_chunk, KVH, dv)
    vb = vb.permute(1, 0, 3, 2, 4)
    out = _Flash.apply(qb, kb, vb, causal, prefix_len, q_chunk, kv_chunk)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(B, S, H, dv)
    return out.to(q.dtype)


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   device) -> L.Params:
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    d, dh = cfg.d_model, cfg.head_dim
    dt = getattr(torch, cfg.param_dtype)
    return {
        "wq": L.dense_init(gen, d, H * dh, dt, device),
        "wk": L.dense_init(gen, d, KVH * dh, dt, device),
        "wv": L.dense_init(gen, d, KVH * dh, dt, device),
        "wo": L.dense_init(gen, H * dh, d, dt, device,
                           1.0 / np.sqrt(2 * cfg.n_layers)),
    }


def local_heads(cfg: ModelConfig, par=None) -> Tuple[int, int, int]:
    """``(H, KVH, first kv head)`` of this rank's shard of a GQA layer: the
    model axis of ``par`` splits the kv heads, each with its G query heads,
    where it divides them (:func:`dist.tp.layer_par`); else every
    head, from 0."""
    k0, kn = TP.tp_range(cfg.n_kv_heads, par)
    return cfg.n_heads // cfg.n_kv_heads * kn, kn, k0


def tp_shard(p: L.Params, cfg: ModelConfig, par) -> L.Params:
    """A rank's GQA weights under ``par`` (``p`` itself where its model
    axis does not split the kv heads): the columns of ``wq`` for its query
    heads (the G of each of its kv heads), of ``wk`` / ``wv`` for its kv
    heads, and the rows of ``wo`` for its query heads."""
    H, KVH, k0 = local_heads(cfg, par)
    if KVH == cfg.n_kv_heads:
        return p
    dh = cfg.head_dim
    q = (k0 * cfg.n_heads // cfg.n_kv_heads * dh, H * dh)
    kv = (k0 * dh, KVH * dh)
    return {**p, "wq": TP.narrow(p["wq"], -1, *q),
            "wk": TP.narrow(p["wk"], -1, *kv),
            "wv": TP.narrow(p["wv"], -1, *kv),
            "wo": TP.narrow(p["wo"], 0, *q)}


def _project_qkv(p: L.Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, par=None):
    """q (B, S, H, dh) and k, v (B, S, KVH, dh) of x (B, S, d) -- the
    rank's heads under ``par`` -- RoPE applied at positions (B, S)."""
    B, S, _ = x.shape
    H, KVH, _ = local_heads(cfg, par)
    dh = cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, KVH, dh)
    v = (x @ p["wv"]).reshape(B, S, KVH, dh)
    if cfg.pos_emb == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_forward(p: L.Params, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor,
                      prefix_len: int = 0, par=None) -> torch.Tensor:
    """Full-sequence attention (prefill math): causal but for an encoder,
    the first ``prefix_len`` positions bidirectional.  ``par``: the rank's
    heads, their ``wo`` products summed over the model axis."""
    B, S, _ = x.shape
    lp = TP.layer_par(cfg.n_kv_heads, par)
    H, _, _ = local_heads(cfg, lp)
    dh = cfg.head_dim
    q, k, v = _project_qkv(p, TP.tp_enter(x, lp)[0], cfg, positions, lp)
    o = blockwise_attention(q, k, v,
                            causal=cfg.causal and not cfg.encoder_only,
                            prefix_len=prefix_len, q_chunk=cfg.attn_q_chunk,
                            kv_chunk=cfg.attn_kv_chunk)
    return TP.tp_sum(o.reshape(B, S, H * dh) @ p["wo"], lp)


def attention_prefill_kv(p: L.Params, x: torch.Tensor, cfg: ModelConfig,
                         positions: torch.Tensor, par=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V streams (post-RoPE) for cache construction during prefill: the
    rank's kv heads under ``par``."""
    B, S, _ = x.shape
    _, KVH, _ = local_heads(cfg, par)
    dh = cfg.head_dim
    k = (x @ p["wk"]).reshape(B, S, KVH, dh)
    v = (x @ p["wv"]).reshape(B, S, KVH, dh)
    if cfg.pos_emb == "rope":
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return k, v


def attention_decode(p: L.Params, x: torch.Tensor, cache: AC.KVCache,
                     cfg: ModelConfig, positions: torch.Tensor, seed: int,
                     par=None) -> Tuple[torch.Tensor, AC.KVCache]:
    """One-token decode: x (B, 1, d) -> (out (B,1,d), updated cache).
    ``par``: the rank's heads and their cache, the append's stochastic
    rounding counted from its first kv head of the layer's."""
    B = x.shape[0]
    lp = TP.layer_par(cfg.n_kv_heads, par)
    H, _, k0 = local_heads(cfg, lp)
    dh = cfg.head_dim
    q, k, v = _project_qkv(p, x, cfg, positions, lp)
    with OPS.sr_heads_from(k0, cfg.n_kv_heads):
        o, cache = OPS.attention_decode_step(cache, k, v,
                                             q.reshape(B, H, dh),
                                             cfg.state_quant, seed=seed)
    return TP.tp_sum(o.reshape(B, 1, H * dh).to(x.dtype) @ p["wo"],
                     lp), cache


def attention_spec_decode(p: L.Params, x: torch.Tensor, cache,
                          cfg: ModelConfig, positions: torch.Tensor,
                          seed: int, par=None) -> Tuple[torch.Tensor, object]:
    """Speculative decode: x (B, n, d) at positions (B, n) -> (out (B, n, d),
    updated cache).  Appends all n K/V rows (per-position seeds
    ``seed + i``), then verifies the n queries in one ``spec_verify`` pass:
    position j's attention row is bitwise the j-th sequential
    :func:`attention_decode` call's, and so are its projections, which run
    position by position on the decode step's (B, 1, d) input
    (:func:`layers.per_position`).  ``par``: as in
    :func:`attention_decode`, the positions' ``wo`` products summed in
    one collective."""
    B, n, _ = x.shape
    lp = TP.layer_par(cfg.n_kv_heads, par)
    H, _, k0 = local_heads(cfg, lp)
    dh = cfg.head_dim
    q, k, v = L.per_position(
        lambda xi, pi: _project_qkv(p, xi, cfg, pi, lp), x, positions)
    with OPS.sr_heads_from(k0, cfg.n_kv_heads):
        o, cache = OPS.attention_spec_step(cache, k, v, q, cfg.state_quant,
                                           seed=seed)
    return TP.tp_sum(L.per_position(lambda oi: oi @ p["wo"],
                                    o.reshape(B, n, H * dh).to(x.dtype)),
                     lp), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2), absorbed form
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig, device) -> L.Params:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    dt = getattr(torch, cfg.param_dtype)

    def heads(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device)
        return w.mul_(1.0 / np.sqrt(fan_in)).to(dt)

    return {
        "wq_a": L.dense_init(gen, d, m.q_lora, dt, device),
        "q_norm": L.init_norm(m.q_lora, "rmsnorm", dt, device),
        # per-head query heads: nope part + rope part
        "wq_b": L.dense_init(gen, m.q_lora, H * (m.nope_dim + m.rope_dim),
                             dt, device),
        "wkv_a": L.dense_init(gen, d, m.kv_lora + m.rope_dim, dt, device),
        "kv_norm": L.init_norm(m.kv_lora, "rmsnorm", dt, device),
        # absorbed projections: W_UK (H, nope, kv_lora), W_UV (H, kv_lora, v)
        "w_uk": heads((H, m.nope_dim, m.kv_lora), m.nope_dim),
        "w_uv": heads((H, m.kv_lora, m.v_dim), m.kv_lora),
        "wo": L.dense_init(gen, H * m.v_dim, d, dt, device,
                           1.0 / np.sqrt(2 * cfg.n_layers)),
    }


def mla_tp_shard(p: L.Params, cfg: ModelConfig, par) -> L.Params:
    """A rank's MLA weights under ``par`` (``p`` itself where its model
    axis does not split the query heads): its heads' columns of ``wq_b``
    (nope + rope each), its heads of ``w_uk`` / ``w_uv`` and the rows of
    ``wo`` for them; ``wq_a``, ``q_norm``, ``wkv_a`` and ``kv_norm`` (the
    query and latent down-projections) stay whole."""
    H, h0, lp = TP.local_share(cfg.n_heads, par)
    if lp is None:
        return p
    m = cfg.mla
    qw, vw = m.nope_dim + m.rope_dim, m.v_dim
    return {**p, "wq_b": TP.narrow(p["wq_b"], -1, h0 * qw, H * qw),
            "w_uk": TP.narrow(p["w_uk"], 0, h0, H),
            "w_uv": TP.narrow(p["w_uv"], 0, h0, H),
            "wo": TP.narrow(p["wo"], 0, h0 * vw, H * vw)}


def _mla_queries(p, x, cfg: ModelConfig, positions,
                 lp=None) -> torch.Tensor:
    """Absorbed queries (B, S, H, kv_lora + rope) of the heads ``p`` holds
    (a rank's under :func:`mla_tp_shard`); the query latent, whole on
    every rank, enters the split heads through Megatron's f under
    ``lp``."""
    m = cfg.mla
    B, S, _ = x.shape
    ql = TP.tp_copy(L.apply_norm(p["q_norm"], x @ p["wq_a"], "rmsnorm",
                                 cfg.norm_eps), lp)
    qh = (ql @ p["wq_b"]).reshape(B, S, p["w_uk"].shape[0],
                                  m.nope_dim + m.rope_dim)
    q_nope, q_rope = qh[..., :m.nope_dim], qh[..., m.nope_dim:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    # absorb W_UK: q_eff = q_nope @ W_UK -> (B, S, H, kv_lora)
    q_eff = torch.einsum("bshn,hnc->bshc", q_nope, p["w_uk"])
    return torch.cat([q_eff, q_rope], dim=-1)


def mla_cache_stream(p, x, cfg: ModelConfig, positions) -> torch.Tensor:
    """Latent cache stream (B, S, kv_lora + rope): values are the first
    kv_lora lanes."""
    m = cfg.mla
    kv = x @ p["wkv_a"]
    c = L.apply_norm(p["kv_norm"], kv[..., :m.kv_lora], "rmsnorm",
                     cfg.norm_eps)
    k_rope = L.apply_rope(kv[..., m.kv_lora:], positions, cfg.rope_theta)
    return torch.cat([c, k_rope], dim=-1)


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.mla.nope_dim + cfg.mla.rope_dim) ** -0.5


def mla_forward(p: L.Params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, par=None) -> torch.Tensor:
    """Full-sequence MLA in absorbed form (one latent KV stream).
    ``par``: the rank's query heads over the whole latent, their ``wo``
    products summed over the model axis; the query and KV latents (whole
    on every rank) enter the split heads through Megatron's f."""
    m = cfg.mla
    B, S, _ = x.shape
    H, _, lp = TP.local_share(cfg.n_heads, par)
    x = TP.tp_enter(x, lp)[1]              # only whole weights read x
    q = _mla_queries(p, x, cfg, positions, lp)          # (B, S, H, cw)
    kv = TP.tp_copy(mla_cache_stream(p, x, cfg, positions),
                    lp)[:, :, None, :]                  # KVH = 1
    ctx = blockwise_attention(q, kv, kv[..., :m.kv_lora],
                              scale=_mla_scale(cfg),
                              q_chunk=cfg.attn_q_chunk,
                              kv_chunk=cfg.attn_kv_chunk)  # (B,S,H,kv_lora)
    o = torch.einsum("bshc,hcv->bshv", ctx, p["w_uv"])
    return TP.tp_sum(o.reshape(B, S, H * m.v_dim) @ p["wo"], lp)


def mla_decode(p: L.Params, x: torch.Tensor, cache, cfg: ModelConfig,
               positions: torch.Tensor, seed: int, par=None
               ) -> Tuple[torch.Tensor, object]:
    """One-token MLA decode: x (B, 1, d) -> (out (B, 1, d), cache).  The
    same op step as GQA; the cache's ``v_width`` selects ``mla_decode``.
    ``par``: the rank's query heads; the latent append is the whole
    stream's on every rank (no head base)."""
    B = x.shape[0]
    H, _, lp = TP.local_share(cfg.n_heads, par)
    q = _mla_queries(p, x, cfg, positions).reshape(B, H, -1)
    ckv = mla_cache_stream(p, x, cfg, positions)[:, :, None, :]  # (B,1,1,cw)
    ctx, cache = OPS.attention_decode_step(cache, ckv, None, q,
                                           cfg.state_quant,
                                           scale=_mla_scale(cfg), seed=seed)
    return TP.tp_sum(_mla_out(p, ctx.to(x.dtype), cfg), lp), cache


def _mla_out(p: L.Params, ctx: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One position's output (B, 1, d) of its latent context (B, H,
    kv_lora): W_UV absorbed back, then ``wo`` (a rank's partial product
    under :func:`mla_tp_shard`)."""
    o = torch.einsum("bhc,hcv->bhv", ctx, p["w_uv"])
    return o.reshape(ctx.shape[0], 1, -1) @ p["wo"]


def mla_spec_decode(p: L.Params, x: torch.Tensor, cache, cfg: ModelConfig,
                    positions: torch.Tensor, seed: int, par=None
                    ) -> Tuple[torch.Tensor, object]:
    """Speculative MLA decode over n positions (see
    :func:`attention_spec_decode`): the projections and both absorb
    einsums run position by position, as :func:`mla_decode` runs them.
    ``par``: as in :func:`mla_decode`, the positions' ``wo`` products
    summed in one collective."""
    lp = TP.local_share(cfg.n_heads, par)[2]
    q, ckv = L.per_position(
        lambda xi, pi: (_mla_queries(p, xi, cfg, pi),
                        mla_cache_stream(p, xi, cfg, pi)), x, positions)
    ctx, cache = OPS.attention_spec_step(cache, ckv[:, :, None, :], None, q,
                                         cfg.state_quant,
                                         scale=_mla_scale(cfg), seed=seed)
    return TP.tp_sum(L.per_position(lambda c: _mla_out(p, c[:, 0], cfg),
                                    ctx.to(x.dtype)), lp), cache
