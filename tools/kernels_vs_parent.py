#!/usr/bin/env python3
"""Decode-attention kernels (2 and 3) of this checkout against another
checkout's, bitwise, on the card.

Usage, from the repository root, on a machine with one CUDA card:

    python3 tools/kernels_vs_parent.py OTHER_CHECKOUT

It compiles ``OTHER_CHECKOUT/src/repro_torch/csrc/mx_attention.cu`` and
``mx_paged_attention.cu`` with this checkout's nvcc flags into a temporary
directory, launches them and this checkout's kernels through the same C
entry points on the same inputs (zamba2-2.7b and llama3.2-1b smoke widths,
lengths across tile boundaries, shuffled pages), and exits non-zero unless
every output is bitwise equal.  Prints one line per case.
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
                 for n in ("mx_attention", "mx_paged_attention")}
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
    print("kernels_vs_parent:", "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
