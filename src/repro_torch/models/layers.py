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
import torch.utils.checkpoint

from repro_torch.dist import tp as TP
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
                  eps: float = 1e-5, par=None) -> torch.Tensor:
    """Mamba-2 style RMSNorm(x * silu(gate)).  With ``par`` the last axis
    is a rank's channel shard of it: the mean square is over every
    channel, the ranks' sums of squares summed over the model axis (one
    (B, S, 1) all-reduce, and one for its gradient: each rank reads the
    sum for its own channels), never per rank."""
    xf = (x * Fn.silu(gate.to(torch.float32))).to(torch.float32)
    if par is None:
        ms = xf.square().mean(-1, keepdim=True)
    else:
        ms = TP.tp_sum_split(xf.square().sum(-1, keepdim=True), par) / (
            xf.shape[-1] * par.tp)
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


def apply_ffn(p: Params, x: torch.Tensor, kind: str,
              par=None) -> torch.Tensor:
    """GELU is the tanh form, ``jax.nn.gelu``'s default.  With ``par``
    (tensor parallelism: ``dist.tp.layer_par`` of the FFN's width)
    ``p`` holds the rank's d_ff/tp columns of ``wi`` / ``wg`` and the
    matching rows of ``wo``, and the ranks' products are summed over the
    model axis (Megatron's f before the columns, g after the rows:
    ``dist.tp.tp_enter`` / ``tp_sum``).  The FFNs carry no bias, so none
    is added after the sum."""
    x = TP.tp_enter(x, par)[0]
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
    return TP.tp_sum(h @ p["wo"], par)


def ffn_tp_shard(p: Params, cfg: ModelConfig, par) -> Params:
    """A rank's FFN weights under ``par`` (``p`` itself where its model
    axis splits nothing): a dense FFN, where tp divides ``d_ff``, keeps
    d_ff/tp columns of ``wi`` / ``wg`` and the matching rows of ``wo``;
    an MoE keeps its experts' banks under expert parallelism, its router
    and shared experts whole."""
    if "router" in p:
        if not TP.expert_parallel(cfg, par):
            return p
        n = cfg.moe.n_experts // par.tp
        return {**p, **{k: TP.narrow(p[k], 0, par.model_index * n, n)
                        for k in ("wi", "wg", "wo")}}
    f0, fn = TP.tp_range(p["wi"].shape[1], par)
    if fn == p["wi"].shape[1]:
        return p
    out = {k: TP.narrow(p[k], -1, f0, fn) for k in ("wi", "wg") if k in p}
    out["wo"] = TP.narrow(p["wo"], 0, f0, fn)
    return out


# ---------------------------------------------------------------------------
# mixture of experts (expert-parallel over the model axis of a mesh)
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
#
# Under expert parallelism (``apply_moe`` with a ``Parallel`` whose model
# axis divides the expert count) tokens are replicated over the model axis,
# each rank holds E/tp experts and computes its local tokens x its local
# experts at the capacity of its local tokens, and one sum over the model
# axis combines -- the JAX package's ``shard_map``.  Every model rank then
# holds the same output and so the same loss: the backward of that sum is
# the identity, and the gradients of ``x`` and of the (replicated) router,
# which each rank holds only for its own experts, are summed over the model
# axis instead (Megatron's f / g pair, ``dist.tp.tp_copy`` / ``tp_sum``).
# Where the model axis splits no experts and the data axes split the batch
# (``rows``), every data rank routes the whole batch, as GSPMD computes
# JAX's ``apply_moe`` on the global batch, and keeps its rows.

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
                          w: torch.Tensor, wi, wg, wo, cap: int,
                          e_offset: int = 0) -> torch.Tensor:
    """The local experts' contribution for all tokens.  x_flat (N, d); sel
    (N, k) global expert ids; w (N, k) combine weights; wi/wg/wo (E_local,
    ...), holding experts ``e_offset .. e_offset + E_local - 1``."""
    N, d = x_flat.shape
    k = sel.shape[-1]
    E = wi.shape[0]
    dev = x_flat.device
    local_e = sel.reshape(-1).long() - e_offset                  # (N*k,)
    is_local = (local_e >= 0) & (local_e < E)
    cls = torch.where(is_local, local_e, E)
    entry_tok = torch.arange(N, device=dev).repeat_interleave(k)
    # slot within expert: rank among earlier entries of the same expert
    oh = Fn.one_hot(cls, E + 1)                                  # (N*k, E+1)
    slot = (oh.cumsum(0) - oh).gather(1, cls[:, None])[:, 0]
    keep = is_local & (slot < cap)
    e_idx = torch.where(keep, local_e, E)
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


def _moe_local(x: torch.Tensor, router, wi, wg, wo, cfg: ModelConfig,
               par=None) -> torch.Tensor:
    """Route + dispatch + expert FFNs for the tokens of ``x`` (B, S, d).

    With ``par`` (expert parallelism): ``wi`` / ``wg`` / ``wo`` are this
    rank's E/tp experts, routing is computed locally (the router is
    replicated), capacity is per shard, and one sum over the model axis
    combines."""
    mc = cfg.moe
    B, S, d = x.shape
    if par is not None:
        n_local = mc.n_experts // par.tp
        if wi.shape[0] != n_local:
            raise ValueError(f"expert parallelism over {par.tp} ranks needs "
                             f"the local {n_local} experts a rank, got "
                             f"{wi.shape[0]}")
        x, router = TP.tp_copy(x, par), TP.tp_copy(router, par)
    x_flat = x.reshape(-1, d)
    logits = (x_flat.to(torch.float32) @ router).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    w, sel = torch.topk(probs, mc.top_k, dim=-1)                 # (N, k)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = moe_capacity(x_flat.shape[0], cfg)
    if par is None:
        out = _moe_dispatch_compute(x_flat, sel, w, wi, wg, wo, cap)
    else:
        out = TP.tp_sum(_moe_dispatch_compute(
            x_flat, sel, w, wi, wg, wo, cap,
            e_offset=par.model_index * wi.shape[0]), par)
    return out.reshape(B, S, d).to(x.dtype)


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig,
              par=None, rows=None) -> torch.Tensor:
    """MoE FFN.  x: (B, S, d).  ``par``: a ``repro_torch.dist.sharding.
    Parallel`` or None; expert-parallel when its model axis divides the
    expert count, and then ``p``'s expert banks are this rank's shard.
    ``rows``: a ``Parallel`` whose data axes split the batch in equal
    blocks, ``x`` this rank's; where the MoE is not expert-parallel it
    routes the whole batch (gathered over the data axes) with the whole
    batch's capacity and returns this rank's rows."""
    ep = par if TP.expert_parallel(cfg, par) else None
    whole = ep is None and rows is not None and rows.batch_size_divisor > 1
    out = _moe_local(TP.rows_whole(x, rows) if whole else x, p["router"],
                     p["wi"], p["wg"], p["wo"], cfg, ep)
    if whole:
        out = TP.rows_local(out, rows)
    if cfg.moe.n_shared:
        out = out + apply_ffn(p["shared"], x, cfg.ffn_kind_inner)
    return out


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _xent_chunk(xb: torch.Tensor, lm_head: torch.Tensor, lb: torch.Tensor,
                mb: torch.Tensor):
    """One chunk's summed masked NLL and mask count.  The gold logit is a
    gather: bitwise the JAX package's masked sum over the vocabulary (one
    term, the rest zeros), without its (B, chunk, V) mask."""
    logits = (xb @ lm_head).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lb[..., None])[..., 0]
    return ((logz - gold) * mb).sum(), mb.sum()


def chunked_softmax_xent(x: torch.Tensor, lm_head: torch.Tensor,
                         labels: torch.Tensor, mask: torch.Tensor,
                         chunk: int = 1024) -> torch.Tensor:
    """Cross-entropy over large vocabularies without a (B, S, V) logits
    buffer.  x: (B, S, d) final hidden states; lm_head: (d, V);
    labels / mask: (B, S).  The sequence is padded to whole chunks; each
    chunk runs under a (non-reentrant) checkpoint, so the backward
    recomputes its (B, chunk, V) logits instead of keeping them."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        x = Fn.pad(x, (0, 0, 0, pad))
        labels = Fn.pad(labels, (0, pad))
        mask = Fn.pad(mask, (0, pad))
    labels = labels.long()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[1], chunk):
        t, c = torch.utils.checkpoint.checkpoint(
            _xent_chunk, x[:, s:s + chunk], lm_head, labels[:, s:s + chunk],
            mask[:, s:s + chunk], use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    return tot / cnt.clamp(min=1.0)
