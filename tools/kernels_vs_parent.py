#!/usr/bin/env python3
"""The CUDA kernels of this checkout against another checkout's, bitwise,
on the card, by families of cases.

Usage, from the repository root, on a machine with one CUDA card:

    python3 tools/kernels_vs_parent.py OTHER_CHECKOUT [--cases mla,k1,k7]
    python3 tools/kernels_vs_parent.py OTHER_CHECKOUT --cases k1,k7 --time

It compiles the other checkout's ``src/repro_torch/csrc`` sources that the
chosen families need, with this checkout's nvcc flags, into a temporary
directory, launches them and this checkout's kernels through the same C
entry points on the same inputs, and exits non-zero unless every output is
bitwise equal (the ``mla`` family against an older loop: within
tolerance).  Prints one line per case.  Families (``--cases``, comma
separated; default ``mla,k1,k7``):

* ``mla``: kernels 2, 3, 5 and 6 in MLA mode (``csrc/mx_mla_tile.cuh``) at
  deepseek-v2-236b's widths and its smoke widths, decode and Kq = 4
  verify, lengths across tile boundaries, shuffled pages.  Each checkout's
  entry points are called with their own argument lists: against a
  checkout that has the split MLA loop (its ``mla_split``), bitwise;
  against an older one (the loop before, with other entry points and
  fp32 products), within the kernels' rtol 2e-4, atol 2e-5;
* ``k1``: kernel 1, dense and slab mode, at the zamba2 / mamba2 heads, the
  GLA family's, xlstm-1.3b's mLSTM heads and three odd shapes (a partial last block of rows, dk = 16
  and 4096), scalar and per-channel decay, both roundings, state
  magnitudes 1, 1e-3, 1e-37 (subnormal scales) and 1e35;
* ``k7``: kernel 7, the MX8 quantizer, at the served prefill shapes and
  the JAX kernel test's, both roundings, values over 45 decades and at
  magnitudes 1, 1e-3, 1e-37 and 1e35; and this checkout's two-stream
  launch (K and V of a 400-token prefill at opt-6.7b's and yi-9b's widths,
  padded to the 512-token tile in the launch) against the other
  checkout's one launch a stream on the ``F.pad`` copies;
* ``dense_append``: the slot pool's fused dense append (this checkout's
  ``mx_kv_append_quant``) against the path it replaced, the eager quantize
  (``F.sr_bits`` + ``F.quantize``, seeds seed / seed + 1) and
  ``_update_at`` per field -- plain PyTorch, the same in both checkouts,
  so no other build is needed -- at zamba2-2.7b's, opt-6.7b's and yi-9b's
  K and V and deepseek-v2-236b's latent, n = 1 and 4, lengths past T - n,
  magnitudes 1, 1e-3, 1e-37 and 1e35, both roundings: every cache byte;
* ``k4``: kernel 4, this checkout's fused quantize-and-append against the
  other checkout's append path (the eager quantize, ``F.sr_bits`` +
  ``F.quantize`` with seeds seed / seed + 1, then its copy kernel
  ``mx_paged_kv_append_launch``) at zamba2-2.7b's K and V and
  deepseek-v2-236b's latent, magnitudes 1, 1e-3, 1e-37 and 1e35, both
  roundings, slots straddling page ends: every pool byte;
* ``gqa``: kernels 2, 3, 5 and 6 in GQA mode (``csrc/mx_attention_split.cuh``)
  at zamba2-2.7b's, llama3.2-1b's smoke, opt-6.7b's and yi-9b's widths,
  lengths across split boundaries, decode and verify (Kq = 4; yi-9b at Kq
  = 2, its 16 rows the most one block took before the loop had row
  blocks).  Their entry points take the split loop's workspace and
  counters, so the other checkout must date from the split loop on; the
  GQA kernels before it had other entry points and other arithmetic, and
  ``chip_smoke.py`` holds them by their contracts instead.

``--time`` then times kernels 1 and 7 of both checkouts at the shapes of
``PERF.md``'s kernel table (kernel 1 at zamba2's and the GLA family's
heads, dense and slab mode, stochastic rounding; kernel 7 at gla's
prefill state, at one (1, 512, KVH, 128) stream of opt-6.7b and yi-9b,
and at their prefill's K and V: this checkout's one padded launch, the
other's ``F.pad`` and one launch a stream), the dense append against its
eager path at the slot pools' widths, the four MLA modes at
deepseek-v2-236b's widths and the table's lengths (decode 72, 408, 141,
259; Kq = 4 verify), and kernel 4's append (this checkout's fused launch, the other's eager
quantize + copy) at zamba2's K and V and deepseek's latent, and kernels
3 and 5 in GQA mode at zamba2's, opt-6.7b's and yi-9b's widths, by
CUDA-graph replay with inputs rotated so that every launch finds them
cold in the 50 MB L2, in the turns other, this, this, other, and prints
the card's name and power limit.
"""
import argparse
import ctypes
import itertools
import math
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))                 # chip_smoke's timing helpers

FAMILIES = ("mla", "k1", "k7", "gqa", "k4", "dense_append")
_SOURCES = {"mla": ("mx_attention", "mx_paged_attention",
                    "mx_spec_attention"),
            "k4": ("mx_paged_attention",),
            "gqa": ("mx_attention", "mx_paged_attention",
                    "mx_spec_attention"),
            "k1": ("mx_state_update",), "k7": ("mx_quant",),
            "dense_append": ()}


def _other_lib(csrc: Path, name: str, out: Path, flags) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = out / f"{name}.so"
    subprocess.run([_build.nvcc(), *flags, "-o", str(lib),
                    str(csrc / f"{name}.cu")], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def _entry(lib, name, argtypes):
    f = getattr(lib, name)
    f.restype, f.argtypes = ctypes.c_int, list(argtypes)
    return f


def _pool(lens, KVH, d, n_stack, seed, Kq, H, value_pool=True):
    """Pools of random MX8 K (and V) with a block table of shuffled pages
    spanning each row's length, and queries (B, Kq, H, d)."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.core.paged import pages_for
    g = torch.Generator(device="cuda").manual_seed(seed)
    need = [pages_for(n) for n in lens]
    P = 1 + sum(need)
    ids = (torch.randperm(P - 1, generator=g, device="cuda") + 1).tolist()
    npg = 1 << max(0, (max(need) - 1).bit_length())
    bt = torch.zeros((len(lens), npg), dtype=torch.int32)
    for b, n in enumerate(need):
        bt[b, :n] = torch.tensor(ids[:n])
        ids = ids[n:]
    shp = (P, n_stack, 128, KVH, d)
    K = F.mx8_quantize(torch.randn(shp, generator=g, device="cuda"))
    V = (F.mx8_quantize(torch.randn(shp, generator=g, device="cuda"))
         if value_pool else None)
    q = torch.randn((len(lens), Kq, H, d), generator=g, device="cuda")
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, K, V, bt.cuda(), lengths


def _report(label, pairs, errs) -> bool:
    import torch
    same = [torch.equal(a, b) for a, b in pairs]
    ok = all(same) and not any(errs)
    print(f"{label}: " + ", ".join(
        "bitwise equal" if s else "DIFFERS" for s in same)
        + f" (launch errors {list(errs)})", flush=True)
    return ok


def _mla_split_loop(csrc: Path) -> bool:
    """Whether a checkout's MLA kernels run the split loop (workspace and
    counters in their entry points)."""
    return "mla_split(" in (csrc / "mx_mla_tile.cuh").read_text()


def _mla_entries(other, split_loop: bool):
    """The other checkout's four MLA entry points (kernels 2, 3, 6, 5), as
    functions of (q, latent payload, bt, lengths, out, B, npg, H, n_q, dk,
    dv) that pass the arguments its own entry points take."""
    import torch
    from repro_torch.kernels import mx_attention as KA
    old2 = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    old3 = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    old6 = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    old5 = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_spec_attention as KV
    f2 = _entry(other["mx_attention"], "mx_attention_decode_mla_launch",
                KA._MLA_ARGTYPES if split_loop else old2)
    f3 = _entry(other["mx_paged_attention"],
                "mx_paged_attention_decode_mla_launch",
                KP._MLA_ARGTYPES if split_loop else old3)
    f6 = _entry(other["mx_spec_attention"],
                "mx_spec_attention_decode_mla_launch",
                KV._MLA_DENSE_ARGTYPES if split_loop else old6)
    f5 = _entry(other["mx_spec_attention"],
                "mx_paged_spec_attention_decode_mla_launch",
                KV._MLA_PAGED_ARGTYPES if split_loop else old5)

    def call(fn, paged, verify):
        def run(q, p, bt, lengths, out, B, npg, H, n_q, dk, dv, scratch,
                n_stack=3, group=2):
            stream = torch.cuda.current_stream().cuda_stream
            ptrs = [q.data_ptr(), p["mantissa"].data_ptr(),
                    p["exponent"].data_ptr(), p["micro"].data_ptr()]
            if paged:
                ptrs.append(bt.data_ptr())
            ptrs += [lengths.data_ptr(), out.data_ptr()]
            dims = ([B, npg, n_stack, group, 1, H] if paged
                    else [B, npg * 128, 1, H])
            if verify:
                dims.append(n_q)
            if not split_loop:
                return fn(*ptrs, *dims, dk, dv, stream)
            ws, counters = scratch
            return fn(*ptrs, ws.data_ptr(), counters.data_ptr(), *dims, dk,
                      dv, ws.numel(), counters.numel(), stream)
        return run
    return (call(f2, False, False), call(f3, True, False),
            call(f6, False, True), call(f5, True, True))


def _mla_cases(other, split_loop: bool) -> bool:
    """MLA mode of kernels 2, 3 (decode) and 5, 6 (Kq = 4 verify)."""
    import torch
    from repro_torch.kernels import mx_attention as KA
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_spec_attention as KV
    from repro_torch.kernels import ref as R
    f2, f3, f6, f5 = _mla_entries(other, split_loop)
    ok = True
    for H, dk, dv in ((8, 64, 32), (128, 576, 512)):
        for lens in ((4, 127, 128, 129), (1000, 131, 129, 5),
                     (1100, 65, 193, 4)):
            q, K, _, bt, lengths = _pool(lens, 1, dk, 3, dk + lens[0], 4, H,
                                         value_pool=False)
            group, scale, B, npg = 2, dk ** -0.5, len(lens), bt.shape[1]
            kw = dict(scale=scale, v_width=dv)
            Kd = R.gather_pages(K, bt, group)
            q1 = q[:, 0].contiguous()
            q1s = (q1 * scale).contiguous()
            qf = KV._fold(q, 1, scale)
            y2 = KA.mx_attention_decode(q1, Kd, None, lengths, **kw)
            y3 = KP.mx_paged_attention_decode(q1, K, None, bt, group,
                                              lengths, **kw)
            y6 = KV.mx_spec_attention_decode(q, Kd, None, lengths, **kw)
            y5 = KV.mx_paged_spec_attention_decode(q, K, None, bt, group,
                                                   lengths, **kw)
            o2, o3 = torch.empty_like(y2), torch.empty_like(y3)
            o5 = torch.empty((B, 1, 4, H, dv), device="cuda")
            o6 = torch.empty_like(o5)
            s1 = KA.mla_scratch(B, 1, npg * 128, H, dv, q.device)
            s4 = KA.mla_scratch(B, 1, npg * 128, 4 * H, dv, q.device)
            common = (B, npg, H)
            errs = (
                f2(q1s, Kd.payload, None, lengths, o2, *common, 1, dk, dv,
                   s1),
                f3(q1s, K.payload, bt, lengths, o3, *common, 1, dk, dv, s1),
                f6(qf, Kd.payload, None, lengths, o6, *common, 4, dk, dv,
                   s4),
                f5(qf, K.payload, bt, lengths, o5, *common, 4, dk, dv, s4))
            torch.cuda.synchronize()
            pairs = [(y2, o2), (y3, o3), (y6, KV._unfold(o6)),
                     (y5, KV._unfold(o5))]
            label = (f"MLA H={H} dk={dk} dv={dv} lengths={lens}: kernels 2, "
                     f"3, 6, 5")
            if split_loop:
                ok &= _report(label, pairs, errs)
            else:
                ok &= _report_close(label, pairs, errs)
    return ok


def _report_close(label, pairs, errs) -> bool:
    """Within the kernels' tolerance (rtol 2e-4, atol 2e-5): a checkout
    whose arithmetic differs."""
    close = [bool(((a - b).abs() <= 2e-5 + 2e-4 * b.abs()).all())
             for a, b in pairs]
    worst = max(float((a - b).abs().max()) for a, b in pairs)
    ok = all(close) and not any(errs)
    print(f"{label}: " + ", ".join(
        "within rtol 2e-4 atol 2e-5" if c else "BEYOND TOLERANCE"
        for c in close) + f" (max abs diff {worst:.3g}; launch errors "
        f"{list(errs)})", flush=True)
    return ok


#: the gqa family's cases: (H, KVH, d, lengths, Kq of the verify kernels)
GQA_CASES = ((32, 32, 80, (4, 127, 128, 129), 4),       # zamba2-2.7b
             (32, 32, 80, (1025, 131, 129, 5), 4),
             (4, 2, 32, (5, 200, 131, 64), 4),          # llama3.2-1b smoke
             (32, 32, 128, (4, 127, 128, 129), 4),      # opt-6.7b
             (32, 4, 128, (1025, 131, 129, 5), 2))      # yi-9b: 8 and 16 rows


def _gqa_entries(libs):
    """Kernels 2, 3, 6, 5 (GQA) of one checkout's libraries: C entries."""
    from repro_torch.kernels import mx_attention as KA
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_spec_attention as KV
    return (_entry(libs["mx_attention"], "mx_attention_decode_launch",
                   KA._ARGTYPES),
            _entry(libs["mx_paged_attention"],
                   "mx_paged_attention_decode_launch", KP._ATTN_ARGTYPES),
            _entry(libs["mx_spec_attention"],
                   "mx_spec_attention_decode_launch", KV._DENSE_ARGTYPES),
            _entry(libs["mx_spec_attention"],
                   "mx_paged_spec_attention_decode_launch",
                   KV._PAGED_ARGTYPES))


def _gqa_launch(fn, i, q, K, V, bt, lengths, out, group, n_stack, Kq):
    """A call launching GQA kernel ``i`` (0: 2, 1: 3, 2: 6, 3: 5) through
    the C entry ``fn`` -- paged over pools (``n_stack`` layers, layer
    ``group``), dense over gathered caches -- with its own workspace and
    the device's counters; the call returns the CUDA error code."""
    import torch
    from repro_torch.kernels import mx_attention as KA
    B, npg = bt.shape
    KVH, d = K.payload["mantissa"].shape[-2:]
    G = q.shape[-2] // KVH
    paged, verify = i in (1, 3), i >= 2
    qq = q if verify else q[:, 0].contiguous()
    ws, counters = KA.split_scratch(B, KVH, npg, (Kq if verify else 1) * G,
                                    G, d, q.device)
    kp, vp = K.payload, V.payload
    ptrs = [qq.data_ptr(), kp["mantissa"].data_ptr(),
            kp["exponent"].data_ptr(), kp["micro"].data_ptr(),
            vp["mantissa"].data_ptr(), vp["exponent"].data_ptr(),
            vp["micro"].data_ptr()] + ([bt.data_ptr()] if paged else [])
    ptrs += [lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
             counters.data_ptr()]
    dims = ([B, npg, n_stack, group, KVH, G] if paged
            else [B, npg * 128, KVH, G]) + ([Kq] if verify else [])
    # the stream at launch time: a CUDA graph captures on its own
    return lambda: fn(*ptrs, *dims, d, d, d ** -0.5, ws.numel(),
                      counters.numel(),
                      torch.cuda.current_stream().cuda_stream)


def _gqa_cases(other) -> bool:
    """GQA mode of kernels 2, 3 (decode) and 5, 6 (verify): the split
    loop's entry points."""
    import torch
    from repro_torch.kernels import mx_attention as KA
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_spec_attention as KV
    from repro_torch.kernels import ref as R
    fns = _gqa_entries(other)
    ok = True
    for H, KVH, d, lens, Kq in GQA_CASES:
        q, K, V, bt, lengths = _pool(lens, KVH, d, 9, d + lens[0], Kq, H)
        group = 4
        Kd, Vd = R.gather_pages(K, bt, group), R.gather_pages(V, bt, group)
        q1 = q[:, 0].contiguous()
        ys = (KA.mx_attention_decode(q1, Kd, Vd, lengths),
              KP.mx_paged_attention_decode(q1, K, V, bt, group, lengths),
              KV.mx_spec_attention_decode(q, Kd, Vd, lengths),
              KV.mx_paged_spec_attention_decode(q, K, V, bt, group, lengths))
        outs = [torch.empty_like(y) for y in ys]
        errs = [_gqa_launch(fns[i], i, q, *((K, V) if i in (1, 3)
                                            else (Kd, Vd)), bt, lengths,
                            outs[i], group, 9, Kq)()
                for i in range(4)]
        torch.cuda.synchronize()
        ok &= _report(
            f"GQA H={H} KVH={KVH} d={d} lengths={lens} Kq={Kq}: kernels 2, "
            "3, 6, 5",
            list(zip(ys, outs)), errs)
    return ok


def _time_gqa(other) -> None:
    """Kernels 3 and 5 (GQA, paged: what the served paths launch) of both
    checkouts at zamba2-2.7b's, opt-6.7b's and yi-9b's widths (yi-9b's
    verify at Kq = 2, the most rows the loop took before row blocks), batch
    4 at the decode lengths of PERF.md's kernel table, 64 layers of pages
    rotating cold in L2."""
    import torch
    from repro_torch.kernels import _build
    mine = _gqa_entries({n: _build.load(n) for n in _SOURCES["gqa"]})
    theirs = _gqa_entries(other)
    base = (72, 408, 141, 259)
    n_rot = 64
    for label, H, KVH, d, Kq in (("zamba2", 32, 32, 80, 4),
                                 ("opt-6.7b", 32, 32, 128, 4),
                                 ("yi-9b", 32, 4, 128, 2)):
        lengths = [n + Kq - 1 for n in base]
        q, K, V, bt, lens = _pool(lengths, KVH, d, n_rot, 140 + d + KVH, Kq,
                                  H)
        for name, i in (("kernel 3 decode", 1), ("kernel 5 verify", 3)):
            out = torch.empty((len(lengths), Kq if i == 3 else 1, H, d),
                              device="cuda")
            _turns(f"GQA {label} {name} Kq={Kq if i == 3 else 1} "
                   f"lengths={lengths}",
                   {w: [_gqa_launch(fns[i], i, q, K, V, bt, lens, out, g,
                                    n_rot, Kq) for g in range(n_rot)]
                    for w, fns in (("other", theirs), ("this", mine))}, 20)
        del q, K, V


#: kernel 4's cases: (label, KVH, width, streams)
K4_CASES = (("zamba2 K and V", 32, 80, 2), ("deepseek latent", 1, 576, 1))
K4_MAGS = (1.0, 1e-3, 1e-37, 1e35)


def _other_append(fn, pools, rows, bt, group, lengths, seed, rounding):
    """The other checkout's append path: the eager quantize of each stream
    (seed + i), then its copy kernel over the payload pools."""
    import torch
    from repro_torch.core import formats as F
    payload, dst = [], []
    for i, (x, pool) in enumerate(zip(rows, pools)):
        bits = (F.sr_bits(x.shape, (seed + i) & 0xFFFFFFFF, device="cuda")
                if rounding == "stochastic" else None)
        q = F.quantize(x, "mx8", rounding, bits)
        payload += [q.payload[f][:, 0] for f in sorted(q.payload)]
        dst += [pool.payload[f] for f in sorted(pool.payload)]
    n = len(dst)
    B, _, KVH, _ = rows[0].shape
    P, n_stack = dst[0].shape[:2]
    return fn((ctypes.c_ulonglong * n)(*[p.data_ptr() for p in dst]),
              (ctypes.c_ulonglong * n)(*[r.data_ptr() for r in payload]),
              (ctypes.c_int * n)(*[int(p.shape[-1]) for p in dst]), n,
              bt.data_ptr(), lengths.data_ptr(), B, bt.shape[1], P, n_stack,
              group, KVH, torch.cuda.current_stream().cuda_stream)


def _append_cases(lib) -> bool:
    """Kernel 4: this checkout's fused launch against the other checkout's
    eager quantize + copy kernel, every pool byte."""
    import torch
    from repro_torch.kernels import mx_paged_attention as KP
    fn = _entry(lib, "mx_paged_kv_append_launch", KP._APPEND_ARGTYPES)
    ok = True
    lens = (0, 127, 128, 1000)
    for (label, KVH, d, n), mag in itertools.product(K4_CASES, K4_MAGS):
        _, K, V, bt, lengths = _pool([x + 1 for x in lens], KVH, d, 3,
                                     d + n, 1, KVH)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(d)
        for rounding in ("nearest", "stochastic"):
            rows = [torch.randn((4, 1, KVH, d), generator=g, device="cuda")
                    * mag for _ in range(n)]
            mine = [p.clone() for p in (K, V)[:n]]
            theirs = [p.clone() for p in (K, V)[:n]]
            KP.mx_paged_kv_append_quant(rows, mine, bt, 2, lengths,
                                        0xFFFFFFFF, rounding=rounding)
            err = _other_append(fn, theirs, rows, bt, 2, lengths,
                                0xFFFFFFFF, rounding)
            torch.cuda.synchronize()
            ok &= _report(f"append {label} (KVH={KVH}, d={d}) magnitude "
                          f"{mag:g} {rounding}: fused vs eager + copy, "
                          f"mantissa, exponent, micro per stream",
                          [(a.payload[f], b.payload[f])
                           for a, b in zip(mine, theirs)
                           for f in ("mantissa", "exponent", "micro")],
                          [err])
    return ok


def _time_append(other) -> None:
    """Kernel 4's append of both checkouts by CUDA-graph replay over 9
    layers of pools: this checkout's fused launch, the other's eager
    quantize + copy kernel."""
    import torch
    from repro_torch.kernels import mx_paged_attention as KP
    fn = _entry(other["mx_paged_attention"], "mx_paged_kv_append_launch",
                KP._APPEND_ARGTYPES)
    lens = (76, 412, 145, 263)
    for label, KVH, d, n in K4_CASES:
        _, K, V, bt, _ = _pool([x + 1 for x in lens], KVH, d, 9, 5, 1, KVH)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(6)
        rows = [torch.randn((4, 1, KVH, d), generator=g, device="cuda")
                for _ in range(n)]
        pools = [K, V][:n]
        calls = {"this": [lambda l=l: KP.mx_paged_kv_append_quant(
                     rows, pools, bt, l, lengths, l) for l in range(9)],
                 "other": [lambda l=l: _other_append(
                     fn, pools, rows, bt, l, lengths, l, "stochastic")
                     for l in range(9)]}
        _turns(f"kernel 4 append {label} (KVH={KVH}, d={d}) lengths={lens}",
               calls, 20)


#: (B, H, dv, dk): zamba2, mamba2, gla, retnet, hgrn2, xlstm's mLSTM (dv
#: 1024 + 16: the normalizer row and 15 zero rows; 64 groups a row), then a
#: head of dv 300 at dk 16 (its last block of rows partial), one of dv 45
#: at dk 48 and one of dk 4096
SU_SHAPES = ((4, 80, 64, 64), (4, 80, 64, 128), (4, 4, 640, 320),
             (4, 10, 512, 256), (4, 20, 128, 128), (4, 4, 1040, 1024),
             (1, 2, 300, 16), (2, 3, 45, 48), (1, 1, 13, 4096))
#: state magnitudes; at 1e-37 and 1e35 v is scaled alike, so that the new
#: state's scales are subnormal, or past kMagic * scale's range
SU_MAGS = (1.0, 1e-3, 1e-37, 1e35)


def _state_update_cases(lib) -> bool:
    """Kernel 1, dense and slab mode, this checkout's wrapper against the
    other checkout's entry point on clones of the same state."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_state_update as KS
    fn = _entry(lib, "mx_state_update_launch", KS._ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    for (B, H, dv, dk), mag in itertools.product(SU_SHAPES, SU_MAGS):
        for per_channel in (False, True):
            for rounding in ("nearest", "stochastic"):
                g = torch.Generator(device="cuda").manual_seed(dk + dv)
                n_slabs, n_stack, group = 6, 3, 1
                pool = F.mx8_quantize(torch.randn(
                    (n_slabs, n_stack, H, dv, dk), generator=g,
                    device="cuda") * mag)
                slabs = torch.tensor([4, 1, 5, 2][:B], dtype=torch.int32,
                                     device="cuda")
                d = torch.sigmoid(torch.randn(
                    (B, H, dk if per_channel else 1), generator=g,
                    device="cuda"))
                k, q = (torch.randn((B, H, dk), generator=g, device="cuda")
                        for _ in "kq")
                v = torch.randn((B, H, dv), generator=g, device="cuda")
                if mag < 1e-30 or mag > 1e30:
                    v *= mag
                idx = (slabs.long(), group)
                dense = F.QuantizedTensor("mx8", (B, H, dv, dk), {
                    f: a[idx].clone() for f, a in pool.payload.items()})
                res = []
                for mode in ("dense", "slab"):
                    st = dense if mode == "dense" else pool
                    a, b = st.clone(), st.clone()
                    kw = ({} if mode == "dense"
                          else dict(slabs=slabs, group=group))
                    _, y = KS.mx_state_update(a, d, k, v, q, seed=11,
                                              rounding=rounding, **kw)
                    yo = torch.empty_like(y)
                    p = b.payload
                    err = fn(p["mantissa"].data_ptr(),
                             p["exponent"].data_ptr(), p["micro"].data_ptr(),
                             d.data_ptr(), k.data_ptr(), v.data_ptr(),
                             q.data_ptr(), yo.data_ptr(),
                             None if mode == "dense" else slabs.data_ptr(),
                             B * H, H, 1 if mode == "dense" else n_stack,
                             0 if mode == "dense" else group, dv, dk,
                             int(per_channel), 11,
                             int(rounding == "stochastic"), stream)
                    torch.cuda.synchronize()
                    res.append((err == 0 and all(
                        torch.equal(a.payload[f], p[f]) for f in p),
                        torch.equal(y, yo), float((y - yo).abs().max())))
                ok &= all(s and e for s, e, _ in res)
                print(f"state update (B,H,dv,dk)={(B, H, dv, dk)} "
                      f"magnitude {mag:g} "
                      f"{'per-channel' if per_channel else 'scalar'} "
                      f"{rounding}: " + ", ".join(
                          f"{mode} state "
                          f"{'bitwise equal' if s else 'DIFFERS'}, y "
                          f"{'bitwise equal' if e else f'DIFFERS (max {dy:.3g})'}"
                          for mode, (s, e, dy) in zip(("dense", "slab"), res)),
                      flush=True)
    return ok


#: kernel 7: the GLA family's prefill states, zamba2's K, deepseek's
#: latent, the JAX kernel test's shapes
QUANT_SHAPES = ((4, 4, 640, 320), (4, 10, 512, 256), (4, 20, 128, 128),
                (4, 1024, 32, 80), (4, 512, 1, 576), (16, 64), (300, 128),
                (5, 7, 32))


#: kernel 7's values: over 45 decades (None), then at one magnitude each
K7_MAGS = (None, 1.0, 1e-3, 1e-37, 1e35)
#: a 400-token prefill's K and V, padded to the 512-token tile: opt-6.7b's
#: and yi-9b's kv heads
K7_PREFILL = (("opt-6.7b", 32), ("yi-9b", 4))


def _k7_values(shape, g, mag):
    import torch
    x = torch.randn(shape, generator=g, device="cuda")
    if mag is None:
        x = x * torch.pow(10.0, torch.randint(-40, 6, shape[:-1] + (1,),
                                              generator=g,
                                              device="cuda").float())
    else:
        x = x * mag
    x.view(-1, 16)[::7] = 0.0
    return x


def _other_quant(fn, x, seed, rounding):
    """The other checkout's one-stream launch on ``x``: its three outputs
    and the launch's return code."""
    import torch
    n = x.numel()
    out = (torch.empty(x.shape, dtype=torch.int8, device="cuda"),
           torch.empty(n // 16, dtype=torch.uint8, device="cuda"),
           torch.empty(n // 16, dtype=torch.uint8, device="cuda"))
    err = fn(x.data_ptr(), *(o.data_ptr() for o in out), n // 16, seed,
             int(rounding == "stochastic"),
             torch.cuda.current_stream().cuda_stream)
    return out, err


def _quant_cases(lib) -> bool:
    """Kernel 7, this checkout's wrapper against the other checkout's entry
    point: values over many decades and at four magnitudes, zero groups;
    then this checkout's two-stream padded launch against the other's one
    launch a stream on the padded copies."""
    import torch
    from repro_torch.kernels import mx_quant as KQ
    fn = _entry(lib, "mx_quant_launch", KQ._ARGTYPES)
    ok = True
    for shape, mag in itertools.product(QUANT_SHAPES, K7_MAGS):
        g = torch.Generator(device="cuda").manual_seed(shape[-1] + len(shape))
        x = _k7_values(shape, g, mag)
        for rounding in ("nearest", "stochastic"):
            got = KQ.mx_quantize(x, 77, rounding=rounding)
            want, err = _other_quant(fn, x, 77, rounding)
            torch.cuda.synchronize()
            ok &= _report(f"quantize {shape} magnitude {mag} {rounding}: "
                          "mantissa, exponent, micro",
                          [(got.payload[f].reshape(-1), w.reshape(-1))
                           for f, w in zip(("mantissa", "exponent", "micro"),
                                           want)], [err])
    for (label, KVH), mag in itertools.product(K7_PREFILL, K7_MAGS):
        g = torch.Generator(device="cuda").manual_seed(KVH)
        xs = [_k7_values((1, 400, KVH, 128), g, mag) for _ in "kv"]
        for rounding in ("nearest", "stochastic"):
            got = KQ.mx_quantize_streams(xs, [5, 0xFFFFFFFF],
                                         rounding=rounding, pad_to=512)
            pairs, errs = [], []
            for x, q, s in zip(xs, got, (5, 0xFFFFFFFF)):
                xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 112))
                want, err = _other_quant(fn, xp, s, rounding)
                errs.append(err)
                pairs += [(q.payload[f].reshape(-1), w.reshape(-1))
                          for f, w in zip(("mantissa", "exponent", "micro"),
                                          want)]
            torch.cuda.synchronize()
            ok &= _report(f"quantize {label} K and V (1, 400, {KVH}, 128) "
                          f"padded to 512, one launch, magnitude {mag} "
                          f"{rounding}: vs F.pad + one launch a stream",
                          pairs, errs)
    return ok


#: the slot pools' appended streams: (label, KVH, width, streams, layers
#: a decode step walks)
DA_CASES = (("zamba2 K and V", 32, 80, 2, 9),
            ("opt-6.7b K and V", 32, 128, 2, 32),
            ("yi-9b K and V", 4, 128, 2, 48),
            ("deepseek latent", 1, 576, 1, 4))


def _eager_append(caches, rows, lens, seed, rounding):
    """The slot pool's append before the fused launch: each stream
    quantized eagerly (seed + i), each field written by ``_update_at``."""
    from repro_torch.core import attention_cache as AC
    from repro_torch.core import formats as F
    for i, (x, c) in enumerate(zip(rows, caches)):
        bits = (F.sr_bits(x.shape, (seed + i) & 0xFFFFFFFF, device="cuda")
                if rounding == "stochastic" else None)
        q = F.quantize(x, "mx8", rounding, bits)
        for f, a in c.payload.items():
            AC._update_at(a, q.payload[f], lens)


def _dense_append_cases() -> bool:
    """The fused dense append against the eager path, every cache byte."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_quant as KQ
    ok = True
    lens = torch.tensor((0, 400, 1022, 1033), dtype=torch.int32,
                        device="cuda")
    for (label, KVH, d, k, _), mag, n in itertools.product(
            DA_CASES, K4_MAGS, (1, 4)):
        g = torch.Generator(device="cuda").manual_seed(d + n)
        base = [F.mx8_quantize(torch.randn((4, 1024, KVH, d), generator=g,
                                           device="cuda")) for _ in range(k)]
        for rounding in ("nearest", "stochastic"):
            rows = [torch.randn((4, n, KVH, d), generator=g, device="cuda")
                    * mag for _ in range(k)]
            mine, theirs = [c.clone() for c in base], [c.clone() for c in base]
            KQ.mx_kv_append_quant(rows, mine, lens, 0xFFFFFFFF,
                                  rounding=rounding)
            _eager_append(theirs, rows, lens, 0xFFFFFFFF, rounding)
            torch.cuda.synchronize()
            ok &= _report(f"dense append {label} (KVH={KVH}, d={d}) n={n} "
                          f"magnitude {mag:g} {rounding}: fused vs eager "
                          "quantize + _update_at, every cache byte",
                          [(a.payload[f], b.payload[f])
                           for a, b in zip(mine, theirs)
                           for f in ("mantissa", "exponent", "micro")], [])
    return ok


def _time_dense_append() -> None:
    """The fused dense append against the eager path it replaced, B = 4,
    n = 1, over the caches of the layers a decode step walks."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_quant as KQ
    lens = torch.tensor((72, 105, 141, 128), dtype=torch.int32,
                        device="cuda")
    for label, KVH, d, k, L in DA_CASES:
        g = torch.Generator(device="cuda").manual_seed(d)
        caches = [[F.mx8_quantize(torch.randn((4, 1024, KVH, d), generator=g,
                                              device="cuda"))
                   for _ in range(k)] for _ in range(L)]
        rows = [torch.randn((4, 1, KVH, d), generator=g, device="cuda")
                for _ in range(k)]
        calls = {"this": [lambda c=c, i=i: KQ.mx_kv_append_quant(
                     rows, c, lens, i) for i, c in enumerate(caches)],
                 "other": [lambda c=c, i=i: _eager_append(
                     c, rows, lens, i, "stochastic")
                     for i, c in enumerate(caches)]}
        _turns(f"dense append {label} (KVH={KVH}, d={d}) over {L} layers "
               "(other: the eager quantize + _update_at)", calls, 10)
        del caches


def _time_k7_prefill(other) -> None:
    """Kernel 7 at opt-6.7b's and yi-9b's prefill: one (1, 512, KVH, 128)
    stream through both checkouts' one-stream entry points, then K and V of
    a 400-token prefill, this checkout's one padded launch against the
    other's ``F.pad`` and one launch a stream."""
    import torch
    from chip_smoke import _rotation
    from repro_torch.kernels import _build
    from repro_torch.kernels import mx_quant as KQ
    f7 = {"this": _build.entry(KQ.SOURCE, "mx_quant_launch", KQ._ARGTYPES),
          "other": _entry(other["mx_quant"], "mx_quant_launch",
                          KQ._ARGTYPES)}
    for label, KVH in K7_PREFILL:
        one = (1, 512, KVH, 128)
        n = math.prod(one)
        g = torch.Generator(device="cuda").manual_seed(KVH)
        xs = [torch.randn(one, generator=g, device="cuda")
              for _ in range(_rotation(4 * n))]
        out = (torch.empty(n, dtype=torch.int8, device="cuda"),
               torch.empty(n // 16, dtype=torch.uint8, device="cuda"),
               torch.empty(n // 16, dtype=torch.uint8, device="cuda"))
        _turns(f"kernel 7 {label} one stream {one} nearest",
               {w: [lambda x=x, fn=fn: fn(
                   x.data_ptr(), *(o.data_ptr() for o in out), n // 16, 0,
                   0, torch.cuda.current_stream().cuda_stream) for x in xs]
                for w, fn in f7.items()}, 10)
        kv = [[torch.randn((1, 400, KVH, 128), generator=g, device="cuda")
               for _ in "kv"] for _ in range(_rotation(8 * 400 * KVH * 128))]

        def padded_calls(x, fn=f7["other"]):
            for a in x:
                _other_quant(fn, torch.nn.functional.pad(
                    a, (0, 0, 0, 0, 0, 112)), 0, "nearest")
        _turns(f"kernel 7 {label} prefill K and V (1, 400, {KVH}, 128) "
               "nearest (this: one launch padding to 512; other: F.pad + "
               "one launch a stream)",
               {"this": [lambda x=x: KQ.mx_quantize_streams(x, pad_to=512)
                         for x in kv],
                "other": [lambda x=x: padded_calls(x) for x in kv]}, 10)
        del xs, kv


#: kernel 1 as PERF.md's table times it: (label, (B, H, dv, dk), slab
#: mode, per-channel decay)
K1_TIMED = (("zamba2 dense", (4, 80, 64, 64), False, False),
            ("zamba2 slab", (4, 80, 64, 64), True, False),
            ("gla dense", (4, 4, 640, 320), False, True),
            ("gla slab", (4, 4, 640, 320), True, True),
            ("retnet slab", (4, 10, 512, 256), True, False),
            ("hgrn2 slab", (4, 20, 128, 128), True, True),
            ("xlstm dense", (4, 4, 1040, 1024), False, False),
            ("xlstm slab", (4, 4, 1040, 1024), True, False))


def _turns(label, calls, replays):
    """Time both checkouts' calls in the turns other, this, this, other;
    print and return the two means."""
    from chip_smoke import graph_ms
    ms = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        ms[who].append(graph_ms(calls[who], replays))
    this, other = (sum(ms[w]) / 2 for w in ("this", "other"))
    print(f"time {label}: this {this:.5f} ms ({ms['this'][0]:.5f}, "
          f"{ms['this'][1]:.5f}), other {other:.5f} ms ({ms['other'][0]:.5f},"
          f" {ms['other'][1]:.5f}), this/other {this / other:.3f}",
          flush=True)
    return this, other


def _time_mla(other, split_loop: bool) -> None:
    """The four MLA modes of both checkouts at deepseek-v2-236b's widths
    and PERF.md's lengths, 96 layers' latent pages (and their gathered
    dense copies) rotating cold in L2."""
    import torch
    from chip_smoke import DS_MAX_NEW, DS_PROMPT_LENS, MLA, _mla_pool
    from repro_torch.kernels import _build
    from repro_torch.kernels import mx_attention as KA
    from repro_torch.kernels import mx_spec_attention as KV
    from repro_torch.kernels import ref as R
    mine = _mla_entries({n: _build.load(n) for n in _SOURCES["mla"]}, True)
    theirs = _mla_entries(other, split_loop)
    m = MLA
    H, dk, dv, n_rot = m["H"], m["dk"], m["dv"], 96
    base = [n + DS_MAX_NEW // 2 for n in DS_PROMPT_LENS[:m["B"]]]
    scale = (128 + 64) ** -0.5
    for n_q in (1, 4):
        lengths = [n + n_q - 1 for n in base]
        q_all, C, bt, lens = _mla_pool(lengths, seed=130 + n_q,
                                       n_stack=n_rot, spare=0)
        B, npg = len(lengths), bt.shape[1]
        qg = ((q_all[:, 0] * scale).contiguous() if n_q == 1
              else KV._fold(q_all[:, :n_q].contiguous(), 1, scale))
        out = torch.empty((B, n_q * H, dv), device="cuda")
        scratch = KA.mla_scratch(B, 1, npg * 128, n_q * H, dv, qg.device)
        dense = [R.gather_pages(C, bt, g) for g in range(n_rot)]
        modes = ((("kernel 2 decode", 0, False), ("kernel 3 decode", 1, True))
                 if n_q == 1 else
                 (("kernel 6 verify", 2, False), ("kernel 5 verify", 3, True)))
        for label, i, paged in modes:
            def calls(fns):
                if paged:
                    return [lambda g=g: fns[i](
                        qg, C.payload, bt, lens, out, B, npg, H, n_q, dk, dv,
                        scratch, n_stack=n_rot, group=g)
                        for g in range(n_rot)]
                return [lambda c=c: fns[i](qg, c.payload, None, lens, out, B,
                                           npg, H, n_q, dk, dv, scratch)
                        for c in dense]
            _turns(f"MLA {label} lengths={lengths}",
                   {"other": calls(theirs), "this": calls(mine)}, 5)
        del dense, C


def _time_cases(other, split_loop: bool) -> None:
    """Kernels 1 and 7, the MLA modes and kernel 4's append, of both
    checkouts, timed on the same inputs (through their C entry points;
    the append through this checkout's wrapper and the other's eager
    quantize + copy)."""
    import torch
    from chip_smoke import _rotation
    from repro_torch.core import formats as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import mx_quant as KQ
    from repro_torch.kernels import mx_state_update as KS
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    f1 = {"this": _build.entry(KS.SOURCE, "mx_state_update_launch",
                               KS._ARGTYPES),
          "other": _entry(other["mx_state_update"], "mx_state_update_launch",
                          KS._ARGTYPES)}
    for label, (B, H, dv, dk), slab, per_channel in K1_TIMED:
        g = torch.Generator(device="cuda").manual_seed(dk + dv)
        payload = B * H * dv * dk * (1 + 2 / 16)
        n_rot = _rotation(payload)
        d = torch.sigmoid(torch.randn((B, H, dk if per_channel else 1),
                                      generator=g, device="cuda"))
        k, q = (torch.randn((B, H, dk), generator=g, device="cuda")
                for _ in "kq")
        v = torch.randn((B, H, dv), generator=g, device="cuda")
        y = torch.empty((B, H, dv), device="cuda")
        if slab:
            pool = F.mx8_quantize(torch.randn((B + 1, n_rot, H, dv, dk),
                                              generator=g, device="cuda"))
            slabs = torch.arange(1, B + 1, dtype=torch.int32, device="cuda")
            states = [(pool.payload, slabs.data_ptr(), n_rot, i)
                      for i in range(n_rot)]
        else:
            states = [(F.mx8_quantize(torch.randn(
                (B, H, dv, dk), generator=g, device="cuda")).payload, None,
                1, 0) for _ in range(n_rot)]

        def call(fn, i):
            p, sl, n_stack, group = states[i]
            return lambda: fn(
                p["mantissa"].data_ptr(), p["exponent"].data_ptr(),
                p["micro"].data_ptr(), d.data_ptr(), k.data_ptr(),
                v.data_ptr(), q.data_ptr(), y.data_ptr(), sl, B * H, H,
                n_stack, group, dv, dk, int(per_channel), i, 1,
                torch.cuda.current_stream().cuda_stream)
        _turns(f"kernel 1 {label} {(B, H, dv, dk)}",
               {w: [call(f1[w], i) for i in range(n_rot)] for w in f1}, 10)
        del states
    f7 = {"this": _build.entry(KQ.SOURCE, "mx_quant_launch", KQ._ARGTYPES),
          "other": _entry(other["mx_quant"], "mx_quant_launch",
                          KQ._ARGTYPES)}
    shape = (4, 4, 640, 320)
    n = math.prod(shape)
    n_rot = _rotation(4 * n)
    g = torch.Generator(device="cuda").manual_seed(22)
    xs = [torch.randn(shape, generator=g, device="cuda")
          for _ in range(n_rot)]
    outs = [(torch.empty(n, dtype=torch.int8, device="cuda"),
             torch.empty(n // 16, dtype=torch.uint8, device="cuda"),
             torch.empty(n // 16, dtype=torch.uint8, device="cuda"))
            for _ in range(n_rot)]

    def qcall(fn, i):
        return lambda: fn(xs[i].data_ptr(), *(o.data_ptr() for o in outs[i]),
                          n // 16, 77, 0,
                          torch.cuda.current_stream().cuda_stream)
    _turns(f"kernel 7 gla prefill state {shape} nearest",
           {w: [qcall(f7[w], i) for i in range(n_rot)] for w in f7}, 10)
    del xs, outs
    _time_k7_prefill(other)
    _time_dense_append()
    _time_mla(other, split_loop)
    _time_append(other)
    _time_gqa(other)
    torch.cuda.synchronize()


def main() -> int:
    import torch
    from repro_torch.kernels import _build
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("other", help="the other checkout's root")
    ap.add_argument("--cases", default="mla,k1,k7",
                    help=f"comma-separated families of {FAMILIES}")
    ap.add_argument("--time", action="store_true",
                    help="then time kernels 1, 7, 4, the dense append, the "
                    "MLA modes and GQA kernels 3 and 5 of both checkouts")
    args = ap.parse_args()
    cases = [c for c in args.cases.split(",") if c]
    bad = [c for c in cases if c not in FAMILIES]
    if bad or not cases:
        ap.error(f"unknown case families {bad}; choose from {FAMILIES}")
    if not torch.cuda.is_available():
        print("kernels_vs_parent: no CUDA device", file=sys.stderr)
        return 2
    csrc = Path(args.other) / "src" / "repro_torch" / "csrc"
    names = sorted({n for c in cases for n in _SOURCES[c]}
                   | ({"mx_state_update", "mx_quant", *_SOURCES["mla"]}
                      if args.time else set()))
    split_loop = _mla_split_loop(csrc)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        other = {n: _other_lib(csrc, n, Path(tmp), _build.NVCC_FLAGS)
                 for n in names}
        run = {"mla": lambda: _mla_cases(other, split_loop),
               "gqa": lambda: _gqa_cases(other),
               "k1": lambda: _state_update_cases(other["mx_state_update"]),
               "k7": lambda: _quant_cases(other["mx_quant"]),
               "k4": lambda: _append_cases(other["mx_paged_attention"]),
               "dense_append": _dense_append_cases}
        for c in cases:
            ok &= run[c]()
        if args.time:
            _time_cases(other, split_loop)
    print(f"kernels_vs_parent ({','.join(cases)}):",
          "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
