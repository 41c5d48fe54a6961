"""Plain PyTorch versions of the port's kernels (the oracles).

The CPU tests hold these to the JAX package, and ``chip_smoke.py`` holds
each CUDA kernel to its plain version on the card.  They also serve every
storage format the kernels do not (the ``torch`` op backend).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import formats as F
from repro_torch.core.paged import PAGE_TOKENS


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 ``a * b + c`` with one rounding, as a fused multiply-add.

    The product of two fp32 values is exact in fp64; the fp64 sum then
    rounds once more before the final rounding to fp32, which differs from
    a true FMA only where the fp64 sum lands exactly on an fp32 rounding
    midpoint (rare; ``chip_smoke.py`` reports the measured rate).  The JAX
    reference gets this contraction from XLA:CPU under ``jax.jit``.
    """
    return (a.double() * b.double() + c.double()).float()


def quantized_state_update_stored_ref(
    qS: F.QuantizedTensor, d: torch.Tensor, k: torch.Tensor,
    v: torch.Tensor, q: torch.Tensor, *, rounding: str = "stochastic",
    seed: int = 0,
) -> Tuple[F.QuantizedTensor, torch.Tensor]:
    """One Eq. 2 step over a quantized state stored as Sᵀ, (B, H, dv, dk).

    Dequantize -> ``Sn = fma(S, d, v*k)`` -> requantize (SR bits from the
    counter hash over the flat index) -> ``y = dequant(Sn_q) · q``, for MX8
    summed in kernel 1's order (:func:`group_ordered_dot`).  Any quantized
    format; returns a new container.
    """
    B, H, dv, dk = qS.shape
    St = F.dequantize(qS)
    d_ = d.to(torch.float32).expand(B, H, dk)[:, :, None, :]
    vk = v.to(torch.float32)[..., :, None] * k.to(torch.float32)[..., None, :]
    Sn = fma_f32(St, d_, vk)
    bits = (F.sr_bits(Sn.shape, seed, device=Sn.device)
            if rounding == "stochastic" else None)
    qSn = F.quantize(Sn, qS.fmt, rounding, bits)
    if qS.fmt == "mx8":
        y = group_ordered_dot(F.dequantize(qSn), q.to(torch.float32))
    else:
        y = torch.einsum("bhvk,bhk->bhv", F.dequantize(qSn),
                         q.to(torch.float32))
    return qSn, y


def group_ordered_dot(S: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``y = S · q`` over the last axis, (..., dv, dk) by (..., dk), summed
    in kernel 1's order, so that its ``y`` is bitwise this one: each
    product rounded to fp32, each 16-value group's products added in order
    from 0, then the group sums in group order from 0."""
    p = (S * q[..., None, :]).unflatten(-1, (-1, F.MX8_GROUP))
    part = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for j in range(F.MX8_GROUP):
        part = part + p[..., j]
    y = torch.zeros(p.shape[:-2], dtype=p.dtype, device=p.device)
    for g in range(p.shape[-2]):
        y = y + part[..., g]
    return y


def state_update_float(S: torch.Tensor, d, k, v, q,
                       dtype=torch.bfloat16) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Unquantized Eq. 2 step, state layout (B, H, dv, dk)."""
    St = S.to(torch.float32)
    B, H, dv, dk = St.shape
    d_ = d.to(torch.float32).expand(B, H, dk)[:, :, None, :]
    vk = v.to(torch.float32)[..., :, None] * k.to(torch.float32)[..., None, :]
    Sn = fma_f32(St, d_, vk)
    y = torch.einsum("bhvk,bhk->bhv", Sn, q.to(torch.float32))
    return Sn.to(dtype), y


def attention_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Single-token GQA attention softmax(q·Kᵀ)·V; q (B,H,dh), caches
    (B,T,KVH,d) already dequantized; returns (B, H, dv) f32."""
    B, H, dh = q.shape
    _, T, KVH, dk = k_cache.shape
    if dh != dk:
        raise ValueError(f"query width {dh} != key width {dk}")
    G = H // KVH
    scale = scale if scale is not None else dh ** -0.5
    qg = q.reshape(B, KVH, G, dh).to(torch.float32)
    scores = torch.einsum("bngd,btnd->bngt", qg,
                          k_cache.to(torch.float32)) * scale
    mask = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngt,btnv->bngv", p, v_cache.to(torch.float32))
    return out.reshape(B, H, -1)


def mx_attention_decode_ref(q: torch.Tensor, qK: F.QuantizedTensor,
                            qV: Optional[F.QuantizedTensor],
                            lengths: torch.Tensor,
                            scale: Optional[float] = None,
                            v_width: Optional[int] = None) -> torch.Tensor:
    """Decode attention over a packed cache; ``qV=None`` is MLA mode (values
    are the first ``v_width`` lanes of the key stream)."""
    kf = F.dequantize(qK)
    vf = kf[..., :v_width] if qV is None else F.dequantize(qV)
    return attention_decode_ref(q, kf, vf, lengths, scale)


# ---------------------------------------------------------------------------
# paged layout: page pools (P, G, 128, KVH, w), slab pools (S, G, H, dv, dk)
# ---------------------------------------------------------------------------

def gather_pages(stream, bt: torch.Tensor, group: int):
    """Pool stream (P, G, 128, KVH, w) -> dense (B, npg*128, KVH, w): the
    block table's pages of layer ``group``, in table order."""
    def one(a):
        g = a[bt.long(), int(group)]                 # (B, npg, 128, KVH, w)
        B, npg = g.shape[:2]
        return g.reshape((B, npg * g.shape[2]) + tuple(g.shape[3:]))
    if isinstance(stream, F.QuantizedTensor):
        payload = {f: one(a) for f, a in stream.payload.items()}
        return F.QuantizedTensor(stream.fmt,
                                 tuple(payload["mantissa"].shape), payload)
    return one(stream)


def mx_paged_attention_decode_ref(q: torch.Tensor, k_pool: F.QuantizedTensor,
                                  v_pool: Optional[F.QuantizedTensor],
                                  bt: torch.Tensor, group: int,
                                  lengths: torch.Tensor,
                                  scale: Optional[float] = None,
                                  v_width: Optional[int] = None
                                  ) -> torch.Tensor:
    """Paged decode attention: the block table's pages gathered into the
    dense layout, then :func:`mx_attention_decode_ref`."""
    qK = gather_pages(k_pool, bt, group)
    qV = None if v_pool is None else gather_pages(v_pool, bt, group)
    return mx_attention_decode_ref(q, qK, qV, lengths, scale, v_width)


def spec_attention_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, lengths: torch.Tensor,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Speculative-verify attention: q ``(B, Kq, H, dk)`` against caches
    ``(B, T, KVH, d)`` (already dequantized) whose ``lengths`` count the
    ``Kq`` appended rows; query position ``j`` is
    :func:`attention_decode_ref` at ``lengths - (Kq - 1 - j)`` (on a
    contiguous copy of its queries).  Returns ``(B, Kq, H, dv)`` f32."""
    Kq = q.shape[1]
    return torch.stack([attention_decode_ref(q[:, j].contiguous(), k_cache,
                                             v_cache, lengths - (Kq - 1 - j),
                                             scale)
                        for j in range(Kq)], dim=1)


def mx_spec_attention_decode_ref(q: torch.Tensor, qK: F.QuantizedTensor,
                                 qV: Optional[F.QuantizedTensor],
                                 lengths: torch.Tensor,
                                 scale: Optional[float] = None,
                                 v_width: Optional[int] = None
                                 ) -> torch.Tensor:
    """Verify attention over a packed cache (``qV=None``: MLA mode), the
    dense twin of kernel 5's plain version."""
    kf = F.dequantize(qK)
    vf = kf[..., :v_width] if qV is None else F.dequantize(qV)
    return spec_attention_decode_ref(q, kf, vf, lengths, scale)


def mx_paged_spec_attention_decode_ref(q: torch.Tensor,
                                       k_pool: F.QuantizedTensor,
                                       v_pool: Optional[F.QuantizedTensor],
                                       bt: torch.Tensor, group: int,
                                       lengths: torch.Tensor,
                                       scale: Optional[float] = None,
                                       v_width: Optional[int] = None
                                       ) -> torch.Tensor:
    """Paged speculative-verify attention: the block table's pages gathered
    into the dense layout, then :func:`mx_spec_attention_decode_ref`."""
    qK = gather_pages(k_pool, bt, group)
    qV = None if v_pool is None else gather_pages(v_pool, bt, group)
    return mx_spec_attention_decode_ref(q, qK, qV, lengths, scale, v_width)


# ---------------------------------------------------------------------------
# the combine rule of the GQA kernels' split loop (csrc/mx_attention_split.cuh)
# ---------------------------------------------------------------------------

NEG_INF = -1e30         # the kernels' finite "minus infinity"


def split_partial(qg: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
                  row_len: torch.Tensor, start: int, stop: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One split's flash partial ``(m, l, acc)`` over positions
    ``[start, stop)``: pre-scaled queries ``qg (B, KVH, R, dk)``, dequantized
    caches ``(B, T, KVH, d)``, each row masked to ``pos < row_len`` --
    ``(B,)``, one length a batch row, or ``(B, R)``, one a query row.
    A masked position has ``p = 0`` exactly; a row with no valid position
    in the split gets ``(-1e30, 0, 0)``.  Sums run over ``d`` and the
    positions in ascending order, one elementwise step each, so a row's
    numbers do not depend on the other rows or on the batch shape."""
    kt = kf[:, start:stop].to(torch.float32).permute(0, 2, 1, 3)
    vt = vf[:, start:stop].to(torch.float32).permute(0, 2, 1, 3)
    s = torch.zeros(qg.shape[:3] + (stop - start,), dtype=torch.float32)
    for d in range(qg.shape[-1]):
        s = s + qg[..., d, None] * kt[:, :, None, :, d]
    pos = torch.arange(start, stop)
    if row_len.dim() == 1:
        valid = (pos[None, :] < row_len[:, None])[:, None, None, :]
    else:
        valid = (pos < row_len[..., None])[:, None]
    m = torch.where(valid, s, torch.full_like(s, NEG_INF)).amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = torch.zeros_like(m)
    acc = torch.zeros(qg.shape[:3] + (vt.shape[-1],), dtype=torch.float32)
    for t in range(stop - start):
        l = l + p[..., t]
        acc = acc + p[..., t, None] * vt[:, :, None, t]
    return m, l, acc


def combine_split(state: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                  part: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold the next split's partial into the running ``(M, L, A)``: the
    larger max, each side rescaled by ``exp(its max - the new max)``.  A
    partial that is fully masked for a row, ``(-1e30, 0, 0)``, leaves that
    row's running state bitwise: its weight is ``exp(0) = 1`` on the state
    and 0 on the partial."""
    M, L, A = state
    m, l, acc = part
    m_new = torch.maximum(M, m)
    alpha, beta = torch.exp(M - m_new), torch.exp(m - m_new)
    return (m_new, L * alpha + l * beta,
            A * alpha[..., None] + acc * beta[..., None])


def split_spec_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, lengths: torch.Tensor,
                             split: int = 128,
                             scale: Optional[float] = None,
                             block_rows: Optional[int] = None
                             ) -> torch.Tensor:
    """Verify attention computed the way the GQA kernels split it: q
    ``(B, Kq, H, dk)`` against dequantized caches ``(B, T, KVH, d)``, query
    position ``j`` masked to ``lengths - (Kq - 1 - j)``.  The ``R = Kq * G``
    query-major rows (``r = j * G + g``) of a kv head go to row blocks of
    ``block_rows`` rows (default: the kernels' own,
    :func:`repro_torch.kernels.mx_attention.split_block_rows`); each row
    block walks fixed splits of ``split`` positions up to the longest row,
    each split's partial combined in order (:func:`combine_split`).  A row's
    numbers are the same whatever its block.  Kq = 1 is decode.  Used by
    the tests only; returns ``(B, Kq, H, dv)`` f32."""
    from repro_torch.kernels.mx_attention import split_block_rows
    B, Kq, H, dk = q.shape
    _, T, KVH, _ = k_cache.shape
    dv = v_cache.shape[-1]
    G, R = H // KVH, Kq * (H // KVH)
    rows = block_rows or split_block_rows(R, G, dv)
    scale = scale if scale is not None else dk ** -0.5
    qg = (q.to(torch.float32) * scale).reshape(B, Kq, KVH, G, dk)
    qr = qg.permute(0, 2, 1, 3, 4).reshape(B, KVH, R, dk)   # query-major
    shift = (torch.arange(R) // G) - (Kq - 1)
    row_len = (lengths.to(torch.int64)[:, None] + shift).clamp(0, T)
    lens = lengths.to(torch.int64).clamp(0, T)
    n_split = max(1, -(-int(lens.max()) // split))
    out = []
    for r0 in range(0, R, rows):
        r1 = min(R, r0 + rows)
        state = None
        for s in range(n_split):
            part = split_partial(qr[:, :, r0:r1], k_cache, v_cache,
                                 row_len[:, r0:r1], s * split,
                                 min(T, (s + 1) * split))
            state = part if state is None else combine_split(state, part)
        _, L, A = state
        out.append(A / L.clamp_min(1e-30)[..., None])
    y = torch.cat(out, 2).reshape(B, KVH, Kq, G, dv)
    return y.permute(0, 2, 1, 3, 4).reshape(B, Kq, H, dv)


# ---------------------------------------------------------------------------
# the MLA kernels' split loop (csrc/mx_mla_tile.cuh): its order, for the tests
# ---------------------------------------------------------------------------

MLA_WARPS = 8           # the score k-steps are dealt to 8 warps


def bf16_terms(x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 ``x`` as three bf16 values ``(hi, mid, lo)`` held in fp32, by
    truncation: ``hi`` keeps x's top 8 significant bits, ``mid`` the next 8
    of the (exact) remainder, ``lo`` the rest -- at most 8 bits, so
    ``hi + mid + lo == x`` exactly wherever ``|x| >= 2^-110`` (the MLA
    kernels' split of the queries and the probabilities)."""
    def trunc(v):
        return (v.contiguous().view(torch.int32) & -65536).view(torch.float32)
    x = x.to(torch.float32)
    hi = trunc(x)
    r = x - hi
    mid = trunc(r)
    return hi, mid, trunc(r - mid)


def _mma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor
         ) -> torch.Tensor:
    """``acc + a @ b`` as one tensor-core MMA is modelled here: the bf16
    products and their 16-term sums exact (fp64), rounded once into the fp32
    accumulator."""
    return (acc.double() + a.double() @ b.double()).float()


def mla_split_partial(q_terms, k: torch.Tensor, row_len: torch.Tensor,
                      start: int, v_width: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One split's flash partial ``(m, l, acc)`` in the MLA kernels' order:
    query rows as ``bf16_terms`` of the pre-scaled queries ``(R, dk)``, the
    split's dequantized latent rows ``k (n, dk)`` at positions ``[start,
    start + n)`` (bf16-exact, zero past the batch row's length), each row
    masked to ``pos < row_len (R,)``, values the first ``v_width`` lanes.
    Scores: "warp" ``w`` accumulates the 16-lane k-steps ``w, w + 8, ...``,
    each as three MMAs (terms lo, mid, hi); the eight partials add as
    ``((0 + 1) + (2 + 3)) + ((4 + 5) + (6 + 7))``.  P V: the probabilities'
    terms against 16 positions at a time, lo, mid, hi.  A row with no valid
    position gets ``(-1e30, 0, 0)``."""
    n, dk = k.shape
    R = q_terms[0].shape[0]
    parts = []
    for w in range(MLA_WARPS):
        acc = torch.zeros((R, n), dtype=torch.float32)
        for ks in range(w, dk // 16, MLA_WARPS):
            lanes = slice(16 * ks, 16 * ks + 16)
            for t in (2, 1, 0):
                acc = _mma(acc, q_terms[t][:, lanes], k[:, lanes].T)
        parts.append(acc)
    p0, p1, p2, p3, p4, p5, p6, p7 = parts
    s = ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7))
    valid = (start + torch.arange(n))[None, :] < row_len[:, None]
    m = torch.where(valid, s, torch.full_like(s, NEG_INF)).amax(-1)
    p = torch.where(valid, torch.exp(s - m[:, None]), torch.zeros_like(s))
    p_terms = bf16_terms(p)
    acc = torch.zeros((R, v_width), dtype=torch.float32)
    for kk in range(n // 16):
        pos = slice(16 * kk, 16 * kk + 16)
        for t in (2, 1, 0):
            acc = _mma(acc, p_terms[t][:, pos], k[pos, :v_width])
    return m, p.sum(-1), acc


def split_mla_attention_ref(q: torch.Tensor, latent: F.QuantizedTensor,
                            lengths: torch.Tensor, v_width: int,
                            scale: Optional[float] = None, split: int = 64,
                            bt: Optional[torch.Tensor] = None,
                            group: int = 0) -> torch.Tensor:
    """MLA verify attention computed the way the MLA kernels split it: q
    ``(B, Kq, H, dk)`` against an MX8 latent stream -- dense ``(B, T, KVH,
    dk)``, or a page pool ``(P, n_stack, 128, KVH, dk)`` read at layer
    ``group`` through the block table ``bt (B, npg)`` -- whose first
    ``v_width`` lanes are the values; query position ``j`` masked to
    ``lengths - (Kq - 1 - j)``; fixed splits of ``split`` positions up to the
    batch row's length, each split's :func:`mla_split_partial` combined in
    order (:func:`combine_split`).  Kq = 1 is decode.  Used by the tests
    only; returns ``(B, Kq, H, v_width)`` f32."""
    B, Kq, H, dk = q.shape
    kf = F.dequantize(latent)
    paged = bt is not None
    T = bt.shape[1] * PAGE_TOKENS if paged else kf.shape[1]
    KVH = kf.shape[-2]
    G = H // KVH
    scale = scale if scale is not None else dk ** -0.5
    qg = (q.to(torch.float32) * scale).reshape(B, Kq, KVH, G, dk)
    out = torch.empty((B, Kq, KVH, G, v_width), dtype=torch.float32)
    shift = torch.arange(Kq) - (Kq - 1)
    for b in range(B):
        n = int(lengths[b].clamp(0, T))
        row_len = (int(lengths[b]) + shift).clamp(0, T).repeat_interleave(G)
        for h in range(KVH):
            q_terms = bf16_terms(qg[b, :, h].reshape(Kq * G, dk))
            state = None
            for s in range(max(1, -(-n // split))):
                start = s * split
                if paged:
                    page, off = int(bt[b, start // PAGE_TOKENS]), \
                        start % PAGE_TOKENS
                    k = kf[page, int(group), off:off + split, h]
                else:
                    k = kf[b, start:start + split, h]
                k = torch.where((start + torch.arange(split) < n)[:, None], k,
                                torch.zeros_like(k))
                part = mla_split_partial(q_terms, k, row_len, start, v_width)
                state = part if state is None else combine_split(state, part)
            _, L, A = state
            out[b, :, h] = (A / L.clamp_min(1e-30)[:, None]).reshape(
                Kq, G, v_width)
    return out.reshape(B, Kq, H, v_width)


def paged_kv_append_ref(pools, rows, bt: torch.Tensor, group: int,
                        lengths: torch.Tensor):
    """Write each row's payload ``rows[i] (B, KVH, w)`` into the page slot
    ``pools[i][bt[b, len//128], group, len%128]``, in place."""
    B = bt.shape[0]
    lens = lengths.long()
    page = bt.long()[torch.arange(B, device=bt.device), lens // PAGE_TOKENS]
    off = lens % PAGE_TOKENS
    for pool, row in zip(pools, rows):
        pool[page, int(group), off] = row.to(pool.dtype)
    return pools


def paged_kv_append_quant_ref(streams, pools, bt: torch.Tensor, group: int,
                              lengths: torch.Tensor, seed: int = 0,
                              rounding: str = "stochastic"):
    """Quantize each new token's fp32 row ``streams[i] (B, 1, KVH, w)`` to
    MX8 with SR bits ``sr_bits((B, 1, KVH, w), seed + i)`` and write its
    payload into its page slot of ``pools[i]`` (an MX8 page pool), in
    place: K is stream 0 and V stream 1, an MLA latent the one stream.
    Returns the pools."""
    rows, dst = [], []
    for i, (x, pool) in enumerate(zip(streams, pools)):
        bits = (F.sr_bits(x.shape, (int(seed) + i) & 0xFFFFFFFF,
                          device=x.device)
                if rounding == "stochastic" else None)
        q = F.mx8_quantize(x, rounding, bits)
        rows += [q.payload[f][:, 0] for f in sorted(q.payload)]
        dst += [pool.payload[f] for f in sorted(pool.payload)]
    paged_kv_append_ref(dst, rows, bt, group, lengths)
    return pools


def state_update_slab_ref(pool, slabs: torch.Tensor, group: int, d, k, v, q,
                          *, rounding: str = "stochastic", seed: int = 0):
    """The state update on slab rows ``pool[slabs, group]``, written back in
    place: the rows are gathered into a dense ``(B, H, dv, dk)`` state, so
    SR counters and operands index the batch row, exactly as the dense op
    on gathered rows.  Returns ``(pool, y)``."""
    idx = (slabs.long(), int(group))
    if isinstance(pool, F.QuantizedTensor):
        payload = {f: a[idx] for f, a in pool.payload.items()}
        rows = F.QuantizedTensor(pool.fmt,
                                 tuple(payload["mantissa"].shape), payload)
        new, y = quantized_state_update_stored_ref(
            rows, d, k, v, q, rounding=rounding, seed=seed)
        for f, a in pool.payload.items():
            a[idx] = new.payload[f]
        return pool, y
    new, y = state_update_float(pool[idx], d, k, v, q, dtype=pool.dtype)
    pool[idx] = new
    return pool, y


# ---------------------------------------------------------------------------
# MX8 quantization (the host "Quantization Unit" of the REG_WRITE path)
# ---------------------------------------------------------------------------

def mx_quantize_ref(x: torch.Tensor, rounding: str = "nearest",
                    seed: int = 0) -> F.QuantizedTensor:
    """MX8 quantize along the last axis; SR bits from the counter hash over
    the flat index (what kernel 7 computes)."""
    bits = (F.sr_bits(x.shape, seed, device=x.device)
            if rounding == "stochastic" else None)
    return F.mx8_quantize(x, rounding, bits)


def mx_quantize_streams_ref(xs, seeds, rounding: str = "nearest",
                            pad_to: Optional[int] = None):
    """Kernel 7 over several streams: each stream (axis 1 padded with
    zeros to ``pad_to`` first, when given) through :func:`mx_quantize_ref`
    with its own seed."""
    out = []
    for x, seed in zip(xs, seeds):
        if pad_to is not None and pad_to > x.shape[1]:
            pad = [0, 0] * (x.dim() - 2) + [0, int(pad_to) - x.shape[1]]
            x = torch.nn.functional.pad(x, pad)
        out.append(mx_quantize_ref(x, rounding, seed))
    return out


def kv_append_quant_ref(streams, caches, lengths: torch.Tensor,
                        seed: int = 0, rounding: str = "stochastic"):
    """The dense append: each new fp32 row block ``streams[i] (B, n, KVH,
    w)`` quantized to MX8 with SR bits ``sr_bits((B, n, KVH, w), seed +
    i)``, each payload field written into the dense MX8 cache
    ``caches[i]`` at ``lengths`` by ``_update_at`` (its clamp included), in
    place.  Returns the caches."""
    from repro_torch.core import attention_cache as AC
    for i, (x, cache) in enumerate(zip(streams, caches)):
        bits = (F.sr_bits(x.shape, (int(seed) + i) & 0xFFFFFFFF,
                          device=x.device)
                if rounding == "stochastic" else None)
        q = F.quantize(x, "mx8", rounding, bits)
        for f, a in cache.payload.items():
            AC._update_at(a, q.payload[f], lengths)
    return caches
