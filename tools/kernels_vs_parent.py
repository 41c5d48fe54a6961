#!/usr/bin/env python3
"""Decode-attention kernels (2 and 3) and the state-update kernel (1) of
this checkout against another checkout's, bitwise, on the card.

Usage, from the repository root, on a machine with one CUDA card:

    python3 tools/kernels_vs_parent.py OTHER_CHECKOUT

It compiles ``OTHER_CHECKOUT/src/repro_torch/csrc/mx_attention.cu``,
``mx_paged_attention.cu`` and ``mx_state_update.cu`` with this checkout's
nvcc flags into a temporary directory, launches them and this checkout's
kernels through the same C entry points on the same inputs (attention:
zamba2-2.7b and llama3.2-1b smoke widths, lengths across tile boundaries,
shuffled pages; state update: the zamba2 / mamba2 heads and the GLA
family's, dense and slab mode, scalar and per-channel decay, both
roundings), and exits non-zero unless every output is bitwise equal.
Prints one line per case.
"""
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _other_lib(csrc: Path, name: str, out: Path, flags) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = out / f"{name}.so"
    subprocess.run([_build.nvcc(), *flags, "-o", str(lib),
                    str(csrc / f"{name}.cu")], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    import torch
    from repro_torch.core import formats as F
    from repro_torch.core.paged import pages_for
    from repro_torch.kernels import _build
    from repro_torch.kernels import mx_attention as KA
    from repro_torch.kernels import mx_paged_attention as KP
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    csrc = Path(sys.argv[1]) / "src" / "repro_torch" / "csrc"
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        other = {n: _other_lib(csrc, n, Path(tmp), _build.NVCC_FLAGS)
                 for n in ("mx_attention", "mx_paged_attention",
                           "mx_state_update")}
        for fn_name, lib_name, argtypes in (
                ("mx_attention_decode_launch", "mx_attention",
                 KA._ARGTYPES),
                ("mx_paged_attention_decode_launch", "mx_paged_attention",
                 KP._ATTN_ARGTYPES)):
            f = getattr(other[lib_name], fn_name)
            f.restype, f.argtypes = ctypes.c_int, list(argtypes)
        for H, KVH, d, lens in ((32, 32, 80, (1, 127, 128, 129)),
                                (32, 32, 80, (1000, 128, 129, 1)),
                                (4, 2, 32, (5, 200, 131, 64))):
            g = torch.Generator(device="cuda").manual_seed(d + lens[0])
            need = [pages_for(n) for n in lens]
            P = 1 + sum(need)
            ids = (torch.randperm(P - 1, generator=g, device="cuda")
                   + 1).tolist()
            npg = 1 << max(0, (max(need) - 1).bit_length())
            bt = torch.zeros((len(lens), npg), dtype=torch.int32)
            for b, n in enumerate(need):
                bt[b, :n] = torch.tensor(ids[:n])
                ids = ids[n:]
            bt = bt.cuda()
            K = F.mx8_quantize(torch.randn((P, 9, 128, KVH, d), generator=g,
                                           device="cuda"))
            V = F.mx8_quantize(torch.randn((P, 9, 128, KVH, d), generator=g,
                                           device="cuda"))
            q = torch.randn((len(lens), H, d), generator=g, device="cuda")
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            qg = (q * d ** -0.5).contiguous()
            stream = torch.cuda.current_stream().cuda_stream
            # kernel 3, this checkout (through its wrapper) and the other
            y3 = KP.mx_paged_attention_decode(q, K, V, bt, 4, lengths)
            o3 = torch.empty_like(y3)
            kp, vp = K.payload, V.payload
            err = other["mx_paged_attention"].mx_paged_attention_decode_launch(
                qg.data_ptr(), kp["mantissa"].data_ptr(),
                kp["exponent"].data_ptr(), kp["micro"].data_ptr(),
                vp["mantissa"].data_ptr(), vp["exponent"].data_ptr(),
                vp["micro"].data_ptr(), bt.data_ptr(), lengths.data_ptr(),
                o3.data_ptr(), len(lens), npg, 9, 4, KVH, H // KVH, d, d,
                stream)
            # kernel 2 over the gathered pages
            from repro_torch.kernels import ref as R
            Kd, Vd = R.gather_pages(K, bt, 4), R.gather_pages(V, bt, 4)
            y2 = KA.mx_attention_decode(q, Kd, Vd, lengths)
            o2 = torch.empty_like(y2)
            kd, vd = Kd.payload, Vd.payload
            err2 = other["mx_attention"].mx_attention_decode_launch(
                qg.data_ptr(), kd["mantissa"].data_ptr(),
                kd["exponent"].data_ptr(), kd["micro"].data_ptr(),
                vd["mantissa"].data_ptr(), vd["exponent"].data_ptr(),
                vd["micro"].data_ptr(), lengths.data_ptr(), o2.data_ptr(),
                len(lens), npg * 128, KVH, H // KVH, d, d, stream)
            torch.cuda.synchronize()
            same = (err == err2 == 0 and torch.equal(y3, o3)
                    and torch.equal(y2, o2))
            ok &= same
            print(f"H={H} KVH={KVH} d={d} lengths={lens}: kernel 3 "
                  f"{'bitwise equal' if torch.equal(y3, o3) else 'DIFFERS'}"
                  f", kernel 2 "
                  f"{'bitwise equal' if torch.equal(y2, o2) else 'DIFFERS'}"
                  f" (launch errors {err}, {err2})", flush=True)
        ok &= _state_update_cases(other["mx_state_update"])
    print("kernels_vs_parent:", "ok" if ok else "FAILED")
    return 0 if ok else 1


#: (B, H, dv, dk): zamba2, mamba2, gla, retnet, hgrn2
SU_SHAPES = ((4, 80, 64, 64), (4, 80, 64, 128), (4, 4, 640, 320),
             (4, 10, 512, 256), (4, 20, 128, 128))


def _state_update_cases(lib) -> bool:
    """Kernel 1, dense and slab mode, this checkout's wrapper against the
    other checkout's entry point on clones of the same state."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_state_update as KS
    fn = lib.mx_state_update_launch
    fn.restype, fn.argtypes = ctypes.c_int, list(KS._ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    for B, H, dv, dk in SU_SHAPES:
        for per_channel in (False, True):
            for rounding in ("nearest", "stochastic"):
                g = torch.Generator(device="cuda").manual_seed(dk + dv)
                n_slabs, n_stack, group = 6, 3, 1
                pool = F.mx8_quantize(torch.randn(
                    (n_slabs, n_stack, H, dv, dk), generator=g,
                    device="cuda"))
                slabs = torch.tensor([4, 1, 5, 2][:B], dtype=torch.int32,
                                     device="cuda")
                d = torch.sigmoid(torch.randn(
                    (B, H, dk if per_channel else 1), generator=g,
                    device="cuda"))
                k, q = (torch.randn((B, H, dk), generator=g, device="cuda")
                        for _ in "kq")
                v = torch.randn((B, H, dv), generator=g, device="cuda")
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
                    res.append(err == 0 and torch.equal(y, yo) and all(
                        torch.equal(a.payload[f], p[f]) for f in p))
                ok &= all(res)
                print(f"state update (B,H,dv,dk)={(B, H, dv, dk)} "
                      f"{'per-channel' if per_channel else 'scalar'} "
                      f"{rounding}: dense "
                      f"{'bitwise equal' if res[0] else 'DIFFERS'}, slab "
                      f"{'bitwise equal' if res[1] else 'DIFFERS'}",
                      flush=True)
    return ok


if __name__ == "__main__":
    sys.exit(main())
