"""Core NN layers (functional, dict-of-tensor params) -- PyTorch port of
``repro/models/layers.py`` for the served architectures: RMSNorm and
LayerNorm, the gated RMSNorm of Mamba-2, the per-head RMSNorm of the GLA
family, RoPE and sinusoidal positions, the four feed-forward kinds (SwiGLU,
GeGLU, GELU, ReLU) and the DeepSeek-style mixture of experts."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as Fn

from repro_torch.models.config import ModelConfig

Params = dict


# ---------------------------------------------------------------------------
# init helpers (explicit generator and device)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: float = 1.0) -> torch.Tensor:
    std = scale / np.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=device) * std
    return w.to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, device=device) * 0.02
            ).to(dtype)


# ---------------------------------------------------------------------------
# position by position (the speculative verify step)
# ---------------------------------------------------------------------------

def per_position(fn, *xs: torch.Tensor):
    """``fn`` over each position of the ``(B, n, ...)`` inputs ``xs`` on its
    own -- a contiguous ``(B, 1, ...)`` slice of each -- with the results
    (a tensor or a tuple of them) concatenated along dim 1.

    The verify step runs its dense products so: position i then makes the
    call the i-th sequential decode step makes, on the same ``(B, 1, d)``
    input, and rounds as it does on any BLAS.  A GEMM's row i need not be
    the same at ``M = B * n`` rows as at ``M = B`` (neither MKL's fp32 GEMM
    nor cuBLAS's is)."""
    outs = [fn(*(x[:, i:i + 1].contiguous() for x in xs))
            for i in range(xs[0].shape[1])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(d: int, kind: str, dtype, device) -> Params:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, kind: str,
               eps: float) -> torch.Tensor:
    """LayerNorm (population variance, as ``jnp.var``) or RMSNorm, in f32."""
    xf = x.to(torch.float32)
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = (out * p["scale"].to(torch.float32)
               + p["bias"].to(torch.float32))
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"].to(torch.float32)
    return out.to(x.dtype)


def rmsnorm_gated(x: torch.Tensor, scale: torch.Tensor, gate: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Mamba-2 style RMSNorm(x * silu(gate))."""
    xf = (x * Fn.silu(gate.to(torch.float32))).to(torch.float32)
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)).to(x.dtype)


def head_rmsnorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-head RMSNorm without scale (GLA / RetNet / HGRN2 output norm)."""
    xf = x.to(torch.float32)
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# positional embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, dh) or (B, S, dh); positions: (B, S)."""
    dh = x.shape[-1]
    freqs = torch.from_numpy(np.asarray(rope_freqs(dh, theta), np.float32)
                             ).to(x.device)
    ang = positions.to(torch.float32)[..., None] * freqs
    if x.dim() == ang.dim() + 1:                       # head axis present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sincos_pos_emb(S: int, d: int, dtype, device) -> torch.Tensor:
    """(S, d) sinusoidal positions, built in numpy as the JAX package
    builds them."""
    pos = np.arange(S)[:, None]
    div = np.exp(np.arange(0, d, 2) * (-np.log(10000.0) / d))
    pe = np.zeros((S, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# feed-forward variants
# ---------------------------------------------------------------------------

def init_ffn(gen: torch.Generator, cfg: ModelConfig, device,
             d_ff: Optional[int] = None) -> Params:
    """A dense FFN of kind ``cfg.ffn_kind_inner``: the gated kinds (swiglu,
    geglu) have ``wg``, the ungated (gelu, relu) do not."""
    d, dff = cfg.d_model, (d_ff or cfg.d_ff)
    dt = getattr(torch, cfg.param_dtype)
    p = {"wi": dense_init(gen, d, dff, dt, device)}
    if cfg.ffn_kind_inner in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, d, dff, dt, device)
    p["wo"] = dense_init(gen, dff, d, dt, device,
                         1.0 / np.sqrt(2 * cfg.n_layers))
    return p


def apply_ffn(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    """GELU is the tanh form, ``jax.nn.gelu``'s default."""
    if kind == "swiglu":
        h = Fn.silu(x @ p["wi"]) * (x @ p["wg"])
    elif kind == "geglu":
        h = Fn.gelu(x @ p["wi"], approximate="tanh") * (x @ p["wg"])
    elif kind == "gelu":
        h = Fn.gelu(x @ p["wi"], approximate="tanh")
    elif kind == "relu":
        h = Fn.relu(x @ p["wi"])
    else:
        raise ValueError(kind)
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# mixture of experts (the JAX package's single-shard path)
# ---------------------------------------------------------------------------
#
# Routing as in the JAX package: softmax over the router logits, top-k,
# weights renormalised; each expert takes at most
# ``cap = max(ceil(N * k / E * capacity_factor), 4)`` entries, claimed in
# token order (entry ``n * k + i``), the rest dropped.  A (E, cap) table of
# source tokens turns dispatch into one gather, the experts run as batched
# matmuls over every expert (as the JAX package's einsums do), and shared
# experts are added after.  The combine sums each token's kept entries in
# ascending expert order -- the order of the JAX package's scatter-add --
# with no atomics, so it is deterministic on the card.

def _stack_init(gen: torch.Generator, n: int, d_in: int, d_out: int, dtype,
                device, scale: float = 1.0) -> torch.Tensor:
    w = torch.randn((n, d_in, d_out), generator=gen, device=device)
    return w.mul_(scale / np.sqrt(d_in)).to(dtype)


def init_moe(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    mc = cfg.moe
    d, de = cfg.d_model, mc.d_expert
    dt = getattr(torch, cfg.param_dtype)
    scale_out = 1.0 / np.sqrt(2 * cfg.n_layers)
    p = {
        "router": dense_init(gen, d, mc.n_experts, torch.float32, device),
        "wi": _stack_init(gen, mc.n_experts, d, de, dt, device),
        "wg": _stack_init(gen, mc.n_experts, d, de, dt, device),
        "wo": _stack_init(gen, mc.n_experts, de, d, dt, device, scale_out),
    }
    if mc.n_shared:
        p["shared"] = init_ffn(gen, cfg, device, d_ff=de * mc.n_shared)
    return p


def moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Entries one expert takes per call (the JAX package's formula)."""
    mc = cfg.moe
    cap = int(np.ceil(n_tokens * mc.top_k / mc.n_experts
                      * mc.capacity_factor))
    return max(cap, 4)


def _moe_dispatch_compute(x_flat: torch.Tensor, sel: torch.Tensor,
                          w: torch.Tensor, wi, wg, wo,
                          cap: int) -> torch.Tensor:
    """Every expert's contribution for all tokens.  x_flat (N, d); sel
    (N, k) expert ids; w (N, k) combine weights; wi/wg/wo (E, ...)."""
    N, d = x_flat.shape
    k = sel.shape[-1]
    E = wi.shape[0]
    dev = x_flat.device
    sel_f = sel.reshape(-1).long()                               # (N*k,)
    entry_tok = torch.arange(N, device=dev).repeat_interleave(k)
    # slot within expert: rank among earlier entries of the same expert
    oh = Fn.one_hot(sel_f, E)                                    # (N*k, E)
    slot = (oh.cumsum(0) - oh).gather(1, sel_f[:, None])[:, 0]
    keep = slot < cap
    e_idx = torch.where(keep, sel_f, E)
    s_idx = torch.where(keep, slot, cap)
    # destination -> source token index (N = the zero padding row)
    src = torch.full((E + 1, cap + 1), N, dtype=torch.long, device=dev)
    src[e_idx[keep], s_idx[keep]] = entry_tok[keep]
    src = src[:E, :cap]
    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, d))])
    buf = x_pad[src]                                             # (E, cap, d)
    h = Fn.silu(torch.bmm(buf, wi)) * torch.bmm(buf, wg)
    y_e = torch.bmm(h, wo)                                       # (E, cap, d)
    # combine: each entry's weighted output, summed per token in ascending
    # expert order (dropped entries contribute nothing)
    got = y_e[e_idx.clamp(max=E - 1), s_idx.clamp(max=cap - 1)]
    contrib = torch.where(keep[:, None], got * w.reshape(-1, 1).to(got.dtype),
                          torch.zeros_like(got)).reshape(N, k, d)
    order = sel.argsort(dim=-1)
    contrib = contrib.gather(1, order[..., None].expand(N, k, d))
    out = contrib[:, 0]
    for i in range(1, k):
        out = out + contrib[:, i]
    return out


def _moe_local(x: torch.Tensor, router, wi, wg, wo,
               cfg: ModelConfig) -> torch.Tensor:
    """Route + dispatch + expert FFNs for all tokens of ``x`` (B, S, d)."""
    mc = cfg.moe
    B, S, d = x.shape
    x_flat = x.reshape(-1, d)
    logits = (x_flat.to(torch.float32) @ router).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    w, sel = torch.topk(probs, mc.top_k, dim=-1)                 # (N, k)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    out = _moe_dispatch_compute(x_flat, sel, w, wi, wg, wo,
                                moe_capacity(x_flat.shape[0], cfg))
    return out.reshape(B, S, d).to(x.dtype)


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """MoE FFN.  x: (B, S, d).  The JAX package's expert-parallel branch
    (``shard_map`` over a mesh) has no counterpart in the one-card port."""
    out = _moe_local(x, p["router"], p["wi"], p["wg"], p["wo"], cfg)
    if cfg.moe.n_shared:
        out = out + apply_ffn(p["shared"], x, cfg.ffn_kind_inner)
    return out
