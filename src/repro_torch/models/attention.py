"""GQA attention mixer (PyTorch port of ``repro/models/attention.py``).

Prefill uses a blockwise ("flash") formulation in plain PyTorch -- q chunks
outer, kv chunks inner, streaming max / sum -- so the (S, S) score matrix
never materializes.  Decode goes through the registered SPU ops
(``kv_append`` + ``attn_decode``) in one step, the speculative verify step
through ``kv_append`` x n + ``spec_verify``.  MLA is not ported yet.
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


def _mask_chunk(s, q_idx, k_idx, q_chunk, kv_chunk):
    """Additive causal mask for one (q chunk, kv chunk) pair."""
    qp = q_idx * q_chunk + torch.arange(q_chunk, device=s.device)
    kp = k_idx * kv_chunk + torch.arange(kv_chunk, device=s.device)
    ok = qp[:, None] >= kp[None, :]
    return s + torch.where(ok, 0.0, NEG_INF).to(s.dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: Optional[float] = None, q_chunk: int = 512,
                        kv_chunk: int = 512) -> torch.Tensor:
    """Causal attention, q: (B,S,H,dh), k/v: (B,S,KVH,dh|dv) -> (B,S,H,dv)."""
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
            s = _mask_chunk(torch.einsum("bngqd,bnkd->bngqk", qb[qi], kb[kj]),
                            qi, kj, q_chunk, kv_chunk)
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


def attention_forward(p: L.Params, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention (prefill math)."""
    B, S, _ = x.shape
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, KVH, dh)
    v = (x @ p["wv"]).reshape(B, S, KVH, dh)
    if cfg.pos_emb == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    o = blockwise_attention(q, k, v, q_chunk=cfg.attn_q_chunk,
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
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, 1, H, dh)
    k = (x @ p["wk"]).reshape(B, 1, KVH, dh)
    v = (x @ p["wv"]).reshape(B, 1, KVH, dh)
    if cfg.pos_emb == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
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
    :func:`attention_decode` call's."""
    B, n, _ = x.shape
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, n, H, dh)
    k = (x @ p["wk"]).reshape(B, n, KVH, dh)
    v = (x @ p["wv"]).reshape(B, n, KVH, dh)
    if cfg.pos_emb == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    o, cache = OPS.attention_spec_step(cache, k, v, q, cfg.state_quant,
                                       seed=seed)
    return (o.reshape(B, n, H * dh).to(x.dtype) @ p["wo"]), cache
