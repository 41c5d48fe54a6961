"""Model assembly: block patterns, prefill and decode (PyTorch port of
``repro/models/model.py``).

A model is an optional ``prelude`` of leading layers (DeepSeek-V2's
dense-FFN first layer) and a repeating ``pattern`` of mixer blocks,
optionally followed by a weight-shared attention block per group (Zamba2).
Where the JAX package stacks group parameters and caches along a leading
axis and scans, the port keeps per-layer lists and loops:
``params["groups"][g][pos]`` and ``caches[g][pos]`` (the shared block's
cache last in each group).  A model with a prelude keeps the JAX package's
split, ``params["prelude"][i]`` and caches ``{"prelude": [...], "groups":
caches[g][pos]}`` (:func:`split_caches` / :func:`join_caches`).

  * prefill -- full-sequence forward that also builds the decode caches;
    the inputs are tokens, or a frontend's embeddings (:func:`embed_inputs`:
    a patch prefix before the tokens, or audio frames alone), and an
    encoder's prefill returns per-position logits and no caches
  * decode  -- one token through the quantized caches (the Pimba fast path):
    ``decode_step`` over dense caches, ``paged_decode_step`` over the paged
    pool's views (one view per pattern position, re-bound per layer)
  * speculative verify -- ``paged_spec_decode_step``: n positions per row
    in one pass over the paged views, with per-position state snapshots so
    the serving pool can roll rejected positions back bit-exactly

Decode seeds are the JAX package's exactly: ``uint32(seed) + 7919 * (i +
1)`` for prelude layer ``i``; per group ``uint32(seed) + g * 1000003``,
then ``+ pos + 1`` per element and ``+ 99`` for the shared block, all
wrapping in uint32.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core import attention_cache as AC
from repro_torch.core import formats as F
from repro_torch.core import paged as PG
from repro_torch.kernels.mx_quant import mx_quantize_streams
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig

Params = dict
_NO_FFN = ("mamba2", "mlstm", "slstm")
_SEED_STRIDE = 1000003
_PRELUDE_SEED = 7919
_U32 = 0xFFFFFFFF
_PORTED = ("attn", "mla") + tuple(SSM.MIXERS)
_FFN_KINDS = ("swiglu", "geglu", "gelu", "relu", "moe", "none")
#: the modality frontends (stubs: the caller supplies the embeddings)
FRONTENDS = ("patch", "audio_frames")
#: rows of a learned position table (the JAX package's): positions 0 ..
#: POS_ROWS - 1; the serving engines refuse what could reach past them
POS_ROWS = 32768


def _has_ffn(cfg: ModelConfig, kind: str) -> bool:
    return cfg.ffn_kind != "none" and kind not in _NO_FFN


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configuration features the port does not carry yet."""
    missing = sorted(set(cfg.pattern + cfg.prelude) - set(_PORTED))
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: mixers {missing} are not ported yet (ROADMAP.md: "
            "the other mixers and configs)")
    if cfg.ffn_kind not in _FFN_KINDS \
            or cfg.norm_kind not in ("rmsnorm", "layernorm") \
            or cfg.pos_emb not in ("rope", "learned", "sincos", "none"):
        raise NotImplementedError(
            f"{cfg.name}: ffn {cfg.ffn_kind!r}, norm {cfg.norm_kind!r} or "
            f"positions {cfg.pos_emb!r} unknown to the port")
    if cfg.frontend is not None and cfg.frontend not in FRONTENDS:
        raise NotImplementedError(
            f"{cfg.name}: frontend {cfg.frontend!r} unknown to the port (its "
            f"frontends: {', '.join(FRONTENDS)})")


def check_decoder(cfg: ModelConfig) -> None:
    """Raise for an encoder: it has no decode step (its prefill returns
    per-position logits and no caches)."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU (or for ``meta``: shapes without storage).  Finding no card
    without being asked for the CPU is an error, not a fallback."""
    if device is not None and torch.device(device).type in ("cpu", "meta"):
        return torch.device(torch.device(device).type)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "(or --device cpu) to run on the CPU")
    return torch.device(device if device is not None else "cuda")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_element(gen, cfg: ModelConfig, kind: str, device, layer_idx: int,
                  dense_ffn: bool = False) -> Params:
    """One layer; ``dense_ffn`` (prelude layers) gives an MoE model's layer
    a dense FFN ``moe.first_dense_ff`` wide.  ``layer_idx`` (``g *
    len(pattern) + pos``, as in the JAX package) sets HGRN2's forget-gate
    lower bound ``beta = layer_idx / n_layers``."""
    dt = getattr(torch, cfg.param_dtype)
    p: Params = {"norm": L.init_norm(cfg.d_model, cfg.norm_kind, dt, device)}
    if kind == "attn":
        p["mixer"] = ATT.init_attention(gen, cfg, device)
    elif kind == "mla":
        p["mixer"] = ATT.init_mla(gen, cfg, device)
    else:
        p["mixer"] = SSM.mixer(kind).init(gen, cfg, device)
        if kind == "hgrn2":
            p["mixer"]["beta"].fill_(layer_idx / max(cfg.n_layers, 1))
    if _has_ffn(cfg, kind):
        p["ffn_norm"] = L.init_norm(cfg.d_model, cfg.norm_kind, dt, device)
        if cfg.ffn_kind != "moe":
            p["ffn"] = L.init_ffn(gen, cfg, device)
        elif dense_ffn:
            p["ffn"] = L.init_ffn(
                gen, cfg, device,
                d_ff=cfg.moe.first_dense_ff or cfg.moe.d_expert)
        else:
            p["ffn"] = L.init_moe(gen, cfg, device)
    return p


def _ffn(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The element's FFN: MoE where its params route, else the dense FFN of
    kind ``cfg.ffn_kind_inner`` (an MoE model's dense layers: SwiGLU)."""
    if cfg.ffn_kind == "moe" and "router" in p:
        return L.apply_moe(p, h, cfg)
    return L.apply_ffn(p, h, cfg.ffn_kind_inner)


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device=None) -> Params:
    """Random weights from ``generator``, allocated on ``device`` (the card
    unless ``device="cpu"``).  Shapes and scales are the JAX package's;
    the numbers are not (use :func:`repro_torch.models.convert` for that)."""
    check_supported(cfg)
    device = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    params: Params = {}
    if cfg.frontend in (None, "patch"):        # a VLM embeds text tokens too
        params["embed"] = L.embed_init(generator, cfg.vocab_size,
                                       cfg.d_model, dt, device)
    if cfg.frontend is not None:
        params["frontend_proj"] = L.dense_init(generator, cfg.frontend_dim,
                                               cfg.d_model, dt, device)
    if cfg.pos_emb == "learned":
        params["pos"] = L.embed_init(generator, POS_ROWS, cfg.d_model, dt,
                                     device)
    if cfg.prelude:
        params["prelude"] = [_init_element(generator, cfg, kind, device, i,
                                           dense_ffn=True)
                             for i, kind in enumerate(cfg.prelude)]
    params["groups"] = [[_init_element(generator, cfg, kind, device,
                                       g * len(cfg.pattern) + pos)
                         for pos, kind in enumerate(cfg.pattern)]
                        for g in range(cfg.n_groups)]
    if cfg.shared_attn:
        params["shared"] = {
            "norm": L.init_norm(cfg.d_model, cfg.norm_kind, dt, device),
            "attn": ATT.init_attention(generator, cfg, device),
            "ffn_norm": L.init_norm(cfg.d_model, cfg.norm_kind, dt, device),
            "ffn": L.init_ffn(generator, cfg, device),
        }
    params["final_norm"] = L.init_norm(cfg.d_model, cfg.norm_kind, dt,
                                       device)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, cfg.d_model,
                                         cfg.vocab_size, dt, device)
    return params


def _lm_head(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def params_device(params: Params) -> torch.device:
    return params["final_norm"]["scale"].device


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    """Token embeddings ``(B, n, d)`` of ``tokens (B, n)`` at ``positions
    (B, n)``, plus the learned position rows.  A position past the table
    raises (the JAX gather clamps it): the engines refuse requests that
    could reach one."""
    x = params["embed"][tokens]
    if cfg.pos_emb == "learned":
        x = x + params["pos"][positions.long()]
    return x


def embed_inputs(params: Params, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``(x (B, S, d), positions (B, S), prefix_len)`` of a prefill batch,
    the twin of the JAX package's: the ``patch`` frontend puts the
    projected ``batch["patches"]`` (B, P, frontend_dim) before the token
    embeddings and opens those P positions to every query; the
    ``audio_frames`` frontend projects ``batch["frames"]`` and embeds no
    token; a token model embeds ``batch["tokens"]`` with the config's
    ``prefix_len``.  Learned or sinusoidal positions 0 .. S - 1 are added
    (sinusoidal ones at prefill only, as in the JAX package)."""
    if cfg.frontend == "patch":
        patches = batch["patches"] @ params["frontend_proj"]
        x = torch.cat([patches, params["embed"][batch["tokens"]]], dim=1)
        prefix_len = patches.shape[1]
    elif cfg.frontend == "audio_frames":
        x = batch["frames"] @ params["frontend_proj"]
        prefix_len = 0
    else:
        x = params["embed"][batch["tokens"]]
        prefix_len = cfg.prefix_len
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if cfg.pos_emb == "learned":
        x = x + params["pos"][positions]
    elif cfg.pos_emb == "sincos":
        x = x + L.sincos_pos_emb(S, cfg.d_model, x.dtype, x.device)[None]
    return x, positions, prefix_len


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _build_kv_cache(k: torch.Tensor, v, cfg: ModelConfig,
                    v_width=None) -> AC.KVCache:
    """Quantize full-sequence K/V (``v`` None: an MLA latent stream) into a
    cache with tile-aligned capacity: MX8 with the ``cuda`` backend in one
    kernel-7 launch for both streams, which pads to the tile itself
    (bitwise the padded copy quantized per stream)."""
    B, S = k.shape[:2]
    T = -(-S // AC.PAGE_TOKENS) * AC.PAGE_TOKENS
    sq = cfg.state_quant
    lengths = torch.full((B,), S, dtype=torch.int32, device=k.device)
    streams = [k] if v is None else [k, v]
    if sq.fmt == "mx8" and sq.backend == "cuda":
        stored = mx_quantize_streams([a.to(torch.float32) for a in streams],
                                     pad_to=T)
    else:
        padded = [torch.nn.functional.pad(a, (0, 0, 0, 0, 0, T - S))
                  for a in streams]
        stored = [F.quantize(a, sq.fmt) if sq.quantized
                  else a.to(F.FLOAT_DTYPES[sq.fmt]) for a in padded]
    return AC.KVCache(stored[0], stored[1] if v is not None else None,
                      lengths, sq.fmt, v_width)


def _attn_block_forward(p: Params, x, cfg: ModelConfig, positions,
                        prefix_len: int = 0):
    """Attention + cache build shared by pattern and shared blocks (an
    encoder builds no cache)."""
    y = ATT.attention_forward(p, x, cfg, positions, prefix_len)
    if cfg.encoder_only:
        return y, None
    k, v = ATT.attention_prefill_kv(p, x, cfg, positions)
    return y, _build_kv_cache(k, v, cfg)


def _element_forward(p: Params, x, cfg: ModelConfig, kind: str,
                     positions, prefix_len: int = 0
                     ) -> Tuple[torch.Tensor, Any]:
    h = L.apply_norm(p["norm"], x, cfg.norm_kind, cfg.norm_eps)
    if kind == "attn":
        y, cache = _attn_block_forward(p["mixer"], h, cfg, positions,
                                       prefix_len)
    elif kind == "mla":
        y = ATT.mla_forward(p["mixer"], h, cfg, positions)
        ckv = ATT.mla_cache_stream(p["mixer"], h, cfg, positions)
        cache = _build_kv_cache(ckv[:, :, None, :], None, cfg,
                                v_width=cfg.mla.kv_lora)
    else:
        y, cache = SSM.mixer(kind).forward(p["mixer"], h, cfg)
    x = x + y
    if _has_ffn(cfg, kind):
        h = L.apply_norm(p["ffn_norm"], x, cfg.norm_kind, cfg.norm_eps)
        x = x + _ffn(p["ffn"], h, cfg)
    return x, cache


def _shared_block_forward(p: Params, x, cfg: ModelConfig, positions,
                          prefix_len: int = 0):
    h = L.apply_norm(p["norm"], x, cfg.norm_kind, cfg.norm_eps)
    y, cache = _attn_block_forward(p["attn"], h, cfg, positions, prefix_len)
    x = x + y
    h = L.apply_norm(p["ffn_norm"], x, cfg.norm_kind, cfg.norm_eps)
    return x + L.apply_ffn(p["ffn"], h, cfg.ffn_kind), cache


@torch.no_grad()
def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, List[List[Any]]]:
    """Full-sequence forward over ``batch`` (:func:`embed_inputs`); returns
    (last-position logits (B, V), caches), or for an encoder (per-position
    logits (B, S, V), None)."""
    x, positions, prefix_len = embed_inputs(params, cfg, batch)
    shared = params.get("shared")
    prelude = []
    for i, kind in enumerate(cfg.prelude):
        x, c = _element_forward(params["prelude"][i], x, cfg, kind,
                                positions, prefix_len)
        prelude.append(c)
    caches = []
    for g in range(cfg.n_groups):
        group = []
        for pos, kind in enumerate(cfg.pattern):
            x, c = _element_forward(params["groups"][g][pos], x, cfg, kind,
                                    positions, prefix_len)
            group.append(c)
        if shared is not None:
            x, c = _shared_block_forward(shared, x, cfg, positions,
                                         prefix_len)
            group.append(c)
        caches.append(group)
    x = L.apply_norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    if cfg.encoder_only:
        return x @ _lm_head(params, cfg), None
    return x[:, -1] @ _lm_head(params, cfg), join_caches(prelude, caches)


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------

def split_caches(caches) -> Tuple[List[Any], List[List[Any]]]:
    """(prelude caches, group caches ``[g][pos]``) of a cache tree."""
    if isinstance(caches, dict):
        return caches["prelude"], caches["groups"]
    return [], caches


def join_caches(prelude: List[Any], groups: List[List[Any]]):
    """Inverse of :func:`split_caches`: a model without a prelude keeps the
    bare ``[g][pos]`` list."""
    return {"prelude": prelude, "groups": groups} if prelude else groups


def _kv_cache(cfg: ModelConfig, B: int, cap: int, device) -> AC.KVCache:
    return AC.init_kv_cache(B, cap, cfg.n_kv_heads, cfg.head_dim,
                            cfg.state_quant, device=device)


def init_decode_caches(cfg: ModelConfig, B: int, cache_capacity: int,
                       device=None):
    """Zeroed caches, ``caches[g][pos]`` (shared block's cache last), with
    the prelude's split off as :func:`join_caches` builds it."""
    check_supported(cfg)
    device = resolve_device(device)

    def one_element(kind):
        if kind == "attn":
            return _kv_cache(cfg, B, cache_capacity, device)
        if kind == "mla":
            return AC.init_kv_cache(B, cache_capacity, 1,
                                    cfg.mla.cache_width, cfg.state_quant,
                                    device=device,
                                    mla_v_width=cfg.mla.kv_lora)
        return SSM.mixer(kind).init_state(B, cfg, device)

    caches = []
    for _ in range(cfg.n_groups):
        group = [one_element(k) for k in cfg.pattern]
        if cfg.shared_attn:
            group.append(_kv_cache(cfg, B, cache_capacity, device))
        caches.append(group)
    return join_caches([one_element(k) for k in cfg.prelude], caches)


def _layers(caches) -> List[Any]:
    """Every layer's cache, prelude first."""
    prelude, groups = split_caches(caches)
    return list(prelude) + [c for group in groups for c in group]


def iter_kv_caches(caches):
    for c in _layers(caches):
        if isinstance(c, AC.KVCache):
            yield c


def set_cache_lengths(caches, lengths: torch.Tensor):
    """Overwrite every KVCache.lengths (e.g. decode over a warm cache)."""
    def fix(c):
        if isinstance(c, AC.KVCache):
            return AC.KVCache(c.k, c.v, lengths.to(torch.int32).clone(),
                              c.fmt, c.v_width)
        return c
    prelude, groups = split_caches(caches)
    return join_caches([fix(c) for c in prelude],
                       [[fix(c) for c in group] for group in groups])


def _copy_stream(dst, src, slot: int, n_time: int):
    if dst is None:                      # an MLA cache has no value stream
        return
    if isinstance(dst, F.QuantizedTensor):
        for f, a in dst.payload.items():
            a[slot, :n_time] = src.payload[f][0, :n_time]
    else:
        dst[slot, :n_time] = src[0, :n_time]


@torch.no_grad()
def write_row(caches, row_caches, slot: int, length: int) -> None:
    """Write a batch-1 prefill's caches into row ``slot`` of the pool caches,
    in place, and set that row's KV length to ``length``.

    Structure-aware: KV streams copy their first ``min(T_row, T_pool)``
    positions (later positions of the row are masked by the length);
    recurrent state and conv tails copy whole.
    """
    for c, r in zip(_layers(caches), _layers(row_caches)):
        if isinstance(c, AC.KVCache):
            n = min(r.max_len, c.max_len)
            _copy_stream(c.k, r.k, slot, n)
            _copy_stream(c.v, r.v, slot, n)
            c.lengths[slot] = length
            continue
        for name, leaf in c.items():
            src = r[name]
            if isinstance(leaf, F.QuantizedTensor):
                for f, a in leaf.payload.items():
                    a[slot] = src.payload[f][0]
            else:
                leaf[slot] = src[0]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _element_decode(p: Params, x, cache, cfg: ModelConfig, kind: str,
                    positions, seed: int) -> Tuple[torch.Tensor, Any]:
    h = L.apply_norm(p["norm"], x, cfg.norm_kind, cfg.norm_eps)
    if kind == "attn":
        y, cache = ATT.attention_decode(p["mixer"], h, cache, cfg,
                                        positions[:, None], seed)
    elif kind == "mla":
        y, cache = ATT.mla_decode(p["mixer"], h, cache, cfg,
                                  positions[:, None], seed)
    else:
        y, cache = _recurrent_decode(p["mixer"], h, cache, cfg, kind, seed)
    x = x + y
    if _has_ffn(cfg, kind):
        h = L.apply_norm(p["ffn_norm"], x, cfg.norm_kind, cfg.norm_eps)
        x = x + _ffn(p["ffn"], h, cfg)
    return x, cache


def _recurrent_decode(p: Params, h, cache, cfg: ModelConfig, kind: str,
                      seed: int):
    """One token (B, 1, d) through a recurrent mixer."""
    return SSM.mixer(kind).decode(p, h, cache, cfg, seed)


def _prelude_seed(seed: int, i: int) -> int:
    return (int(seed) + _PRELUDE_SEED * (i + 1)) & _U32


@torch.no_grad()
def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                caches, lengths: torch.Tensor, seed: int = 0
                ) -> Tuple[torch.Tensor, List[List[Any]]]:
    """One decode step.  tokens: (B,) int; lengths: (B,) positions so far.

    Returns (logits (B, V), new caches).  On the card the MX8 state and KV
    buffers are updated in place; always continue from the returned caches.
    """
    check_decoder(cfg)
    positions = lengths
    x = _embed(params, cfg, tokens[:, None], positions[:, None])  # (B,1,d)
    shared = params.get("shared")
    prelude, caches = split_caches(caches)
    new_prelude = []
    for i, kind in enumerate(cfg.prelude):
        x, c = _element_decode(params["prelude"][i], x, prelude[i], cfg,
                               kind, positions, _prelude_seed(seed, i))
        new_prelude.append(c)
    new_caches = []
    for g in range(cfg.n_groups):
        seed_g = (int(seed) + g * _SEED_STRIDE) & _U32
        gcaches = caches[g]
        group = []
        for pos, kind in enumerate(cfg.pattern):
            x, c = _element_decode(params["groups"][g][pos], x, gcaches[pos],
                                   cfg, kind, positions,
                                   (seed_g + pos + 1) & _U32)
            group.append(c)
        if shared is not None:
            h = L.apply_norm(shared["norm"], x, cfg.norm_kind, cfg.norm_eps)
            y, c = ATT.attention_decode(shared["attn"], h, gcaches[-1], cfg,
                                        positions[:, None],
                                        (seed_g + 99) & _U32)
            x = x + y
            h = L.apply_norm(shared["ffn_norm"], x, cfg.norm_kind,
                             cfg.norm_eps)
            x = x + L.apply_ffn(shared["ffn"], h, cfg.ffn_kind)
            group.append(c)
        new_caches.append(group)
    x = L.apply_norm(params["final_norm"], x[:, 0], cfg.norm_kind,
                     cfg.norm_eps)
    return x @ _lm_head(params, cfg), join_caches(new_prelude, new_caches)


def _stack_position(view, layers: List[Any]):
    """One pattern position's view after a step: paged containers stay (the
    ops updated their pools in place); residual leaves re-stack their
    per-layer rows to ``(G, B, ...)``."""
    if PG.is_paged(view):
        return view
    return {k: v if PG.is_paged(v) else torch.stack([c[k] for c in layers])
            for k, v in view.items()}


@torch.no_grad()
def paged_decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                      caches, lengths: torch.Tensor, seed: int = 0
                      ) -> Tuple[torch.Tensor, List[Any]]:
    """One decode step over block-table-native paged cache views.

    ``caches[pos]`` is one view per pattern position (the shared block's
    last; a prelude's views split off as :func:`join_caches` does, one per
    prelude layer), serving all ``G`` layers of it: a
    :class:`~repro_torch.core.paged.PagedKVCache` for attention, and for a
    mixer a dict whose ``"S"`` is a
    :class:`~repro_torch.core.paged.PagedState` and whose other leaves (the
    conv tails) are gathered rows stacked ``(G, B, ...)``.  Each layer
    re-binds ``group`` and the step's base ``lengths`` on the views; the
    paged ops update the pools in place.  Element math and seeds are
    :func:`decode_step`'s, so logits equal the dense path's over gathered
    pages.  Returns (logits (B, V), the views with re-stacked residuals).
    """
    check_decoder(cfg)
    positions = lengths
    x = _embed(params, cfg, tokens[:, None], positions[:, None])  # (B,1,d)
    shared = params.get("shared")
    prelude, caches = split_caches(caches)
    new_prelude = []
    for i, kind in enumerate(cfg.prelude):
        x, c = _element_decode(params["prelude"][i], x,
                               PG.with_group(prelude[i], 0, lengths), cfg,
                               kind, positions, _prelude_seed(seed, i))
        new_prelude.append(_stack_position(prelude[i], [c]))
    per_layer = [[] for _ in caches]
    for g in range(cfg.n_groups):
        seed_g = (int(seed) + g * _SEED_STRIDE) & _U32
        for pos, kind in enumerate(cfg.pattern):
            x, c = _element_decode(params["groups"][g][pos], x,
                                   PG.with_group(caches[pos], g, lengths),
                                   cfg, kind, positions,
                                   (seed_g + pos + 1) & _U32)
            per_layer[pos].append(c)
        if shared is not None:
            h = L.apply_norm(shared["norm"], x, cfg.norm_kind, cfg.norm_eps)
            y, _ = ATT.attention_decode(
                shared["attn"], h, caches[-1].with_step(g, lengths), cfg,
                positions[:, None], (seed_g + 99) & _U32)
            x = x + y
            h = L.apply_norm(shared["ffn_norm"], x, cfg.norm_kind,
                             cfg.norm_eps)
            x = x + L.apply_ffn(shared["ffn"], h, cfg.ffn_kind)
    new_caches = [_stack_position(v, layers)
                  for v, layers in zip(caches, per_layer)]
    x = L.apply_norm(params["final_norm"], x[:, 0], cfg.norm_kind,
                     cfg.norm_eps)
    return x @ _lm_head(params, cfg), join_caches(new_prelude, new_caches)


# ---------------------------------------------------------------------------
# speculative decode: multi-position step with per-position state snapshots
# ---------------------------------------------------------------------------

def _state_snapshot(cache) -> Dict[tuple, torch.Tensor]:
    """Copies of the per-request rows of every recurrent-state leaf of one
    layer-bound mixer view, keyed by the leaf's path in the pool layout
    (``("S", field)`` for a quantized state, ``("conv_x",)``, ...), each
    ``(B, ...)``.  The state kernel overwrites ``pool[slabs, group]`` in
    place at every position, so the slab rows are copied out by advanced
    indexing; the conv tails are copied too.  KV caches need no snapshot:
    rejected positions are masked by the host lengths and overwritten."""
    out: Dict[tuple, torch.Tensor] = {}
    for key in sorted(cache):
        leaf = cache[key]
        if isinstance(leaf, PG.PagedState):
            idx = (leaf.slabs.long(), int(leaf.group))
            pool = leaf.pool
            if isinstance(pool, F.QuantizedTensor):
                for f in sorted(pool.payload):
                    out[(key, f)] = pool.payload[f][idx]
            else:
                out[(key,)] = pool[idx]
        else:
            out[(key,)] = leaf.clone()
    return out


def _element_spec_decode(p: Params, x, cache, cfg: ModelConfig, kind: str,
                         positions, seed: int):
    """Multi-position twin of :func:`_element_decode`.

    ``x`` is (B, n, d) -- the current token plus the drafted ones -- and
    ``positions`` the (B, n) absolute positions.  Attention scores all n
    positions in one ``spec_verify`` pass over a single cache stream; a
    recurrent mixer (Mamba-2, the GLA family, xLSTM) advances through the n
    positions one at a time (the state update is serial) with the
    per-position seed ``seed + i`` of n sequential steps, each position's
    input made contiguous first (a strided slice would round the
    projections differently from the plain step's (B, 1, d) input), and a
    state snapshot after each position.

    Returns ``(x, cache, snaps)``, ``snaps`` a list of n snapshots (None
    for attention).
    """
    n = x.shape[1]
    h = L.apply_norm(p["norm"], x, cfg.norm_kind, cfg.norm_eps)
    if kind == "attn":
        y, cache = ATT.attention_spec_decode(p["mixer"], h, cache, cfg,
                                             positions, seed)
        snaps = None
    elif kind == "mla":
        y, cache = ATT.mla_spec_decode(p["mixer"], h, cache, cfg, positions,
                                       seed)
        snaps = None
    else:
        ys, snaps = [], []
        for i in range(n):
            yi, cache = _recurrent_decode(p["mixer"],
                                          h[:, i:i + 1].contiguous(), cache,
                                          cfg, kind, (int(seed) + i) & _U32)
            ys.append(yi)
            snaps.append(_state_snapshot(cache))
        y = torch.cat(ys, dim=1)
    x = x + y
    if _has_ffn(cfg, kind):
        h = L.apply_norm(p["ffn_norm"], x, cfg.norm_kind, cfg.norm_eps)
        x = x + _verify_ffn(p["ffn"], h, cfg)
    return x, cache, snaps


def _verify_ffn(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """:func:`_ffn` over a verify step's n positions: a dense FFN position by
    position (:func:`layers.per_position`), MoE over all ``B * n`` tokens at
    once, as the JAX package routes them (capacity couples the tokens)."""
    if cfg.ffn_kind == "moe" and "router" in p:
        return L.apply_moe(p, h, cfg)
    return L.per_position(lambda t: L.apply_ffn(p, t, cfg.ffn_kind_inner),
                          h)


def _stack_snaps(per_layer: List[List[Dict[tuple, torch.Tensor]]]
                 ) -> Dict[tuple, torch.Tensor]:
    """``per_layer[g][i][path]`` (B, ...) -> ``{path: (n, B, G, ...)}``,
    position-major, as the pool's ``commit_select`` reads it."""
    return {path: torch.stack([torch.stack([layer[i][path]
                                            for layer in per_layer], dim=1)
                               for i in range(len(per_layer[0]))])
            for path in per_layer[0][0]}


@torch.no_grad()
def paged_spec_decode_step(params: Params, cfg: ModelConfig,
                           tokens: torch.Tensor, caches,
                           lengths: torch.Tensor, seed: int = 0):
    """Speculative verify step: n positions per row through the paged views.

    ``tokens`` (B, n) holds each row's current token followed by its drafted
    (or garbage padding) tokens; ``lengths`` (B,) count positions *before*
    this step.  Structure and every element seed mirror
    :func:`paged_decode_step` -- position i of a row runs with the seeds of
    the sequential decode step ``seed + i`` -- and every dense product but
    MoE's runs position by position on the plain step's ``(B, 1, d)``
    input (:func:`layers.per_position`), so no BLAS's blocking by row count
    sets position i apart from the i-th sequential step (the norms, RMSNorm
    or LayerNorm, still reduce all n positions at once).  The attention
    appends land on the block table's pages in place (rows past a request's
    pages on scratch page 0: the table must span ``lengths + n``).

    Returns ``(logits (B, n, V), views, snaps)``: ``snaps[pos]`` is None for
    attention positions and, for a mixer position, ``{path: (n, B, G,
    ...)}`` -- the state rows after each position, which the pool's
    ``commit_select`` restores per row.  A prelude's views and snapshots
    split off as :func:`join_caches` does (``G = 1`` each).
    """
    check_decoder(cfg)
    B, n = tokens.shape
    positions = lengths[:, None] + torch.arange(
        n, dtype=lengths.dtype, device=lengths.device)[None]
    x = _embed(params, cfg, tokens, positions)                 # (B,n,d)
    shared = params.get("shared")
    prelude, caches = split_caches(caches)
    new_prelude, prelude_snaps = [], []
    for i, kind in enumerate(cfg.prelude):
        x, c, sn = _element_spec_decode(
            params["prelude"][i], x, PG.with_group(prelude[i], 0, lengths),
            cfg, kind, positions, _prelude_seed(seed, i))
        new_prelude.append(_stack_position(prelude[i], [c]))
        prelude_snaps.append(None if sn is None else _stack_snaps([sn]))
    per_layer = [[] for _ in caches]
    layer_snaps = [[] for _ in caches]
    for g in range(cfg.n_groups):
        seed_g = (int(seed) + g * _SEED_STRIDE) & _U32
        for pos, kind in enumerate(cfg.pattern):
            x, c, sn = _element_spec_decode(
                params["groups"][g][pos], x,
                PG.with_group(caches[pos], g, lengths), cfg, kind, positions,
                (seed_g + pos + 1) & _U32)
            per_layer[pos].append(c)
            if sn is not None:
                layer_snaps[pos].append(sn)
        if shared is not None:
            h = L.apply_norm(shared["norm"], x, cfg.norm_kind, cfg.norm_eps)
            y, _ = ATT.attention_spec_decode(
                shared["attn"], h, caches[-1].with_step(g, lengths), cfg,
                positions, (seed_g + 99) & _U32)
            x = x + y
            h = L.apply_norm(shared["ffn_norm"], x, cfg.norm_kind,
                             cfg.norm_eps)
            x = x + _verify_ffn(shared["ffn"], h, cfg)
    new_caches = [_stack_position(v, layers)
                  for v, layers in zip(caches, per_layer)]
    snaps = [_stack_snaps(s) if s else None for s in layer_snaps]
    x = L.apply_norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    head = _lm_head(params, cfg)
    return (L.per_position(lambda t: t @ head, x),
            join_caches(new_prelude, new_caches),
            join_caches(prelude_snaps, snaps))
