"""Core NN layers (functional, dict-of-tensor params) -- PyTorch port of
``repro/models/layers.py`` for the served architectures: RMSNorm, the gated
RMSNorm of Mamba-2, RoPE and the SwiGLU feed-forward.  LayerNorm, the other
FFN kinds and MoE follow with the architectures that use them."""
from __future__ import annotations

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
# norms
# ---------------------------------------------------------------------------

def init_norm(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def apply_norm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32."""
    xf = x.to(torch.float32)
    ms = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(ms + eps) * p["scale"].to(torch.float32)
    return out.to(x.dtype)


def rmsnorm_gated(x: torch.Tensor, scale: torch.Tensor, gate: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Mamba-2 style RMSNorm(x * silu(gate))."""
    xf = (x * Fn.silu(gate.to(torch.float32))).to(torch.float32)
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# positional embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S)."""
    dh = x.shape[-1]
    freqs = torch.from_numpy(np.asarray(rope_freqs(dh, theta), np.float32)
                             ).to(x.device)
    ang = (positions.to(torch.float32)[..., None] * freqs)[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# feed-forward (SwiGLU)
# ---------------------------------------------------------------------------

def init_ffn(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d, dff = cfg.d_model, cfg.d_ff
    dt = getattr(torch, cfg.param_dtype)
    return {"wi": dense_init(gen, d, dff, dt, device),
            "wg": dense_init(gen, d, dff, dt, device),
            "wo": dense_init(gen, dff, d, dt, device,
                             1.0 / np.sqrt(2 * cfg.n_layers))}


def apply_ffn(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (Fn.silu(x @ p["wi"]) * (x @ p["wg"])) @ p["wo"]
