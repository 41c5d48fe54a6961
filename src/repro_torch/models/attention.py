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
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import ops as OPS
from repro_torch.core import attention_cache as AC
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


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, prefix_len: int = 0,
                        scale: Optional[float] = None, q_chunk: int = 512,
                        kv_chunk: int = 512) -> torch.Tensor:
    """q: (B,S,H,dh), k/v: (B,S,KVH,dh|dv) -> (B,S,H,dv).  Causal unless
    ``causal`` is false (an encoder: no mask at all); ``prefix_len > 0``
    opens the first ``prefix_len`` positions to every query, and only
    where attention is causal (as in the JAX package)."""
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
    outs = []
    for qi in range(nq):
        m = torch.full((B, KVH, G, q_chunk, 1), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KVH, G, q_chunk, dv), device=q.device)
        for kj in range(nk):
            s = torch.einsum("bngqd,bnkd->bngqk", qb[qi], kb[kj])
            if causal:
                s = _mask_chunk(s, qi, kj, q_chunk, kv_chunk, prefix_len)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bngqk,bnkv->bngqv", p, vb[kj])
            m = m_new
        outs.append(acc / l.clamp(min=1e-30))
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, S, H, dv)
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


def _project_qkv(p: L.Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    """q (B, S, H, dh) and k, v (B, S, KVH, dh) of x (B, S, d), RoPE
    applied at positions (B, S)."""
    B, S, _ = x.shape
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, KVH, dh)
    v = (x @ p["wv"]).reshape(B, S, KVH, dh)
    if cfg.pos_emb == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_forward(p: L.Params, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor,
                      prefix_len: int = 0) -> torch.Tensor:
    """Full-sequence attention (prefill math): causal but for an encoder,
    the first ``prefix_len`` positions bidirectional."""
    B, S, _ = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = blockwise_attention(q, k, v,
                            causal=cfg.causal and not cfg.encoder_only,
                            prefix_len=prefix_len, q_chunk=cfg.attn_q_chunk,
                            kv_chunk=cfg.attn_kv_chunk)
    return o.reshape(B, S, H * dh) @ p["wo"]


def attention_prefill_kv(p: L.Params, x: torch.Tensor, cfg: ModelConfig,
                         positions: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V streams (post-RoPE) for cache construction during prefill."""
    B, S, _ = x.shape
    KVH, dh = cfg.n_kv_heads, cfg.head_dim
    k = (x @ p["wk"]).reshape(B, S, KVH, dh)
    v = (x @ p["wv"]).reshape(B, S, KVH, dh)
    if cfg.pos_emb == "rope":
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return k, v


def attention_decode(p: L.Params, x: torch.Tensor, cache: AC.KVCache,
                     cfg: ModelConfig, positions: torch.Tensor, seed: int
                     ) -> Tuple[torch.Tensor, AC.KVCache]:
    """One-token decode: x (B, 1, d) -> (out (B,1,d), updated cache)."""
    B = x.shape[0]
    H, dh = cfg.n_heads, cfg.head_dim
    q, k, v = _project_qkv(p, x, cfg, positions)
    o, cache = OPS.attention_decode_step(cache, k, v, q.reshape(B, H, dh),
                                         cfg.state_quant, seed=seed)
    return (o.reshape(B, 1, H * dh).to(x.dtype) @ p["wo"]), cache


def attention_spec_decode(p: L.Params, x: torch.Tensor, cache,
                          cfg: ModelConfig, positions: torch.Tensor,
                          seed: int) -> Tuple[torch.Tensor, object]:
    """Speculative decode: x (B, n, d) at positions (B, n) -> (out (B, n, d),
    updated cache).  Appends all n K/V rows (per-position seeds
    ``seed + i``), then verifies the n queries in one ``spec_verify`` pass:
    position j's attention row is bitwise the j-th sequential
    :func:`attention_decode` call's, and so are its projections, which run
    position by position on the decode step's (B, 1, d) input
    (:func:`layers.per_position`)."""
    B, n, _ = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    q, k, v = L.per_position(
        lambda xi, pi: _project_qkv(p, xi, cfg, pi), x, positions)
    o, cache = OPS.attention_spec_step(cache, k, v, q, cfg.state_quant,
                                       seed=seed)
    return L.per_position(lambda oi: oi @ p["wo"],
                          o.reshape(B, n, H * dh).to(x.dtype)), cache


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


def _mla_queries(p, x, cfg: ModelConfig, positions) -> torch.Tensor:
    """Absorbed queries (B, S, H, kv_lora + rope)."""
    m = cfg.mla
    B, S, _ = x.shape
    ql = L.apply_norm(p["q_norm"], x @ p["wq_a"], "rmsnorm", cfg.norm_eps)
    qh = (ql @ p["wq_b"]).reshape(B, S, cfg.n_heads, m.nope_dim + m.rope_dim)
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
                positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence MLA in absorbed form (one latent KV stream)."""
    m = cfg.mla
    B, S, _ = x.shape
    q = _mla_queries(p, x, cfg, positions)              # (B, S, H, cw)
    kv = mla_cache_stream(p, x, cfg, positions)[:, :, None, :]   # KVH = 1
    ctx = blockwise_attention(q, kv, kv[..., :m.kv_lora],
                              scale=_mla_scale(cfg),
                              q_chunk=cfg.attn_q_chunk,
                              kv_chunk=cfg.attn_kv_chunk)  # (B,S,H,kv_lora)
    o = torch.einsum("bshc,hcv->bshv", ctx, p["w_uv"])
    return o.reshape(B, S, cfg.n_heads * m.v_dim) @ p["wo"]


def mla_decode(p: L.Params, x: torch.Tensor, cache, cfg: ModelConfig,
               positions: torch.Tensor, seed: int) -> Tuple[torch.Tensor,
                                                            object]:
    """One-token MLA decode: x (B, 1, d) -> (out (B, 1, d), cache).  The
    same op step as GQA; the cache's ``v_width`` selects ``mla_decode``."""
    B = x.shape[0]
    q = _mla_queries(p, x, cfg, positions).reshape(B, cfg.n_heads, -1)
    ckv = mla_cache_stream(p, x, cfg, positions)[:, :, None, :]  # (B,1,1,cw)
    ctx, cache = OPS.attention_decode_step(cache, ckv, None, q,
                                           cfg.state_quant,
                                           scale=_mla_scale(cfg), seed=seed)
    return _mla_out(p, ctx.to(x.dtype), cfg), cache


def _mla_out(p: L.Params, ctx: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One position's output (B, 1, d) of its latent context (B, H,
    kv_lora): W_UV absorbed back, then ``wo``."""
    o = torch.einsum("bhc,hcv->bhv", ctx, p["w_uv"])
    return o.reshape(ctx.shape[0], 1, cfg.n_heads * cfg.mla.v_dim) @ p["wo"]


def mla_spec_decode(p: L.Params, x: torch.Tensor, cache, cfg: ModelConfig,
                    positions: torch.Tensor, seed: int
                    ) -> Tuple[torch.Tensor, object]:
    """Speculative MLA decode over n positions (see
    :func:`attention_spec_decode`): the projections and both absorb
    einsums run position by position, as :func:`mla_decode` runs them."""
    q, ckv = L.per_position(
        lambda xi, pi: (_mla_queries(p, xi, cfg, pi),
                        mla_cache_stream(p, xi, cfg, pi)), x, positions)
    ctx, cache = OPS.attention_spec_step(cache, ckv[:, :, None, :], None, q,
                                         cfg.state_quant,
                                         scale=_mla_scale(cfg), seed=seed)
    return L.per_position(lambda c: _mla_out(p, c[:, 0], cfg),
                          ctx.to(x.dtype)), cache
