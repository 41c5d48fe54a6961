"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA device every test skips (decided in the
fixture, never at import).  Run on the card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.

Contracts: the state update's exponent and micro bytes bitwise, mantissa
mismatch rate <= 1e-5 (the plain version emulates the kernel's FMA in
fp64, which differs only in rare double-rounding cases), ``y`` to rtol 1e-5
with atol 1e-5 * max|y| on rows whose state matches; decode attention to
rtol 2e-4, atol 2e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import formats as F
from repro_torch.kernels import mx_attention as KA
from repro_torch.kernels import mx_state_update as KS

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _su_inputs(B, H, dk, dv, dev, scalar_decay, mag=1.0):
    g = torch.Generator(device=dev).manual_seed(dk + dv)
    S0 = torch.randn((B, H, dv, dk), generator=g, device=dev) * mag
    d = torch.sigmoid(torch.randn((B, H, 1 if scalar_decay else dk),
                                  generator=g, device=dev))
    k, q = (torch.randn((B, H, dk), generator=g, device=dev) for _ in "kq")
    v = torch.randn((B, H, dv), generator=g, device=dev)
    return F.mx8_quantize(S0), d, k, v, q


#: zamba2 / mamba2, a small odd shape, and the GLA family's heads: gla
#: (dk 320: 20 groups a row, blocks of 12 rows, dv 640 ends in a partial
#: block), retnet, hgrn2
GLA_SU = [(4, 4, 320, 640), (4, 10, 256, 512), (4, 20, 128, 128)]


@pytest.mark.parametrize("B,H,dk,dv", [(4, 80, 64, 64), (4, 80, 128, 64),
                                       (1, 3, 16, 48)] + GLA_SU)
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("scalar_decay", [True, False])
def test_state_update_kernel_vs_plain(cuda, B, H, dk, dv, rounding,
                                      scalar_decay):
    qS, d, k, v, q = _su_inputs(B, H, dk, dv, cuda, scalar_decay)
    qp, yp = KS.plain(qS.clone(), d, k, v, q, rounding=rounding, seed=77)
    n0 = KS.mx_state_update.launches
    qk, yk = KS.mx_state_update(qS.clone(), d, k, v, q, seed=77,
                                rounding=rounding)
    torch.cuda.synchronize()
    assert KS.mx_state_update.launches == n0 + 1
    _assert_state_update_contract(qp.payload, yp, qk.payload, yk)


def _assert_state_update_contract(plain, yp, kern, yk):
    """Exponent and micro bitwise, mantissa within one step at a mismatch
    rate <= 1e-5, ``y`` bitwise on the rows whose state matches (kernel 1
    and its plain version sum it in one order)."""
    for f in ("exponent", "micro"):
        assert torch.equal(plain[f], kern[f]), f
    diff = plain["mantissa"] != kern["mantissa"]
    assert (plain["mantissa"].int() - kern["mantissa"].int()
            ).abs().max() <= 1
    assert diff.float().mean().item() <= 1e-5
    ok = ~diff.any(-1)
    assert torch.equal(yk[ok], yp[ok])


@pytest.mark.parametrize("B,T,H,KVH,d,lens", [
    (4, 1024, 32, 32, 80, (1, 129, 700, 1024)),
    (2, 256, 4, 2, 32, (5, 200)),
    (1, 384, 16, 2, 128, (300,)),
    # split boundaries (128 positions a block) and rows of 8-10 splits
    (4, 1280, 32, 32, 80, (1025, 1280, 255, 256)),
    (2, 1152, 32, 8, 80, (1151, 1024)),
    # opt-6.7b (G = 1) and yi-9b (G = 8) at head width 128; 32 heads over
    # one kv head: one position's rows in two row blocks of 16
    (4, 1024, 32, 32, 128, (1, 129, 700, 1024)),
    (4, 1024, 32, 4, 128, (64, 333, 128, 1000)),
    (2, 640, 32, 1, 128, (5, 600)),
])
def test_attention_kernel_vs_plain(cuda, B, T, H, KVH, d, lens):
    g = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn((B, H, d), generator=g, device=cuda)
    K = F.mx8_quantize(torch.randn((B, T, KVH, d), generator=g, device=cuda))
    V = F.mx8_quantize(torch.randn((B, T, KVH, d), generator=g, device=cuda))
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    n0 = KA.mx_attention_decode.launches
    yk = KA.mx_attention_decode(q, K, V, lengths)
    torch.cuda.synchronize()
    assert KA.mx_attention_decode.launches == n0 + 1
    torch.testing.assert_close(yk, KA.plain(q, K, V, lengths), rtol=2e-4,
                               atol=2e-5)


def _paged_kv(cuda, lengths, n_stack, KVH, d, H, seed):
    """Pools of random MX8 K/V and a block table of shuffled pages covering
    ``len + 1`` positions per row (bucketed, scratch page 0 in the tail)."""
    from repro_torch.core.paged import pages_for
    from repro_torch.serving.memory import bucket_pages
    need = [pages_for(n + 1) for n in lengths]
    P = 2 + sum(need)
    g = torch.Generator(device=cuda).manual_seed(seed)
    ids = (torch.randperm(P - 1, generator=g, device=cuda) + 1).tolist()
    bt = torch.zeros((len(lengths), bucket_pages(max(need))),
                     dtype=torch.int32)
    for b, n in enumerate(need):
        bt[b, :n] = torch.tensor(ids[:n])
        ids = ids[n:]
    shp = (P, n_stack, 128, KVH, d)
    K = F.mx8_quantize(torch.randn(shp, generator=g, device=cuda))
    V = F.mx8_quantize(torch.randn(shp, generator=g, device=cuda))
    q = torch.randn((len(lengths), H, d), generator=g, device=cuda)
    return q, K, V, bt.to(cuda), torch.tensor(lengths, dtype=torch.int32,
                                              device=cuda)


@pytest.mark.parametrize("lens,H,KVH,d", [
    ((1, 127, 128, 129), 32, 32, 80),       # zamba2-2.7b shared attention
    ((1000, 128, 129, 1), 32, 32, 80),
    ((5, 200), 4, 2, 32),                   # llama3.2-1b smoke: G = 2
    ((1100, 1023, 257, 384), 32, 32, 80),   # 3 to 9 splits a row
    ((1, 127, 128, 129), 32, 32, 128),      # opt-6.7b
    ((1000, 131, 129, 5), 32, 4, 128),      # yi-9b: G = 8
])
def test_paged_attention_kernel_vs_plain_and_dense(cuda, lens, H, KVH, d):
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import ref as R
    q, K, V, bt, lengths = _paged_kv(cuda, lens, 9, KVH, d, H, seed=d)
    n0 = KP.mx_paged_attention_decode.launches
    y3 = KP.mx_paged_attention_decode(q, K, V, bt, 5, lengths)
    y2 = KA.mx_attention_decode(q, R.gather_pages(K, bt, 5),
                                R.gather_pages(V, bt, 5), lengths)
    torch.cuda.synchronize()
    assert KP.mx_paged_attention_decode.launches == n0 + 1
    torch.testing.assert_close(y3, KP.plain(q, K, V, bt, 5, lengths),
                               rtol=2e-4, atol=2e-5)
    assert torch.equal(y3, y2)              # bitwise: same tiles, same order


@pytest.mark.parametrize("KVH,d,streams", [
    (32, 80, ("K", "V")),       # zamba2-2.7b: six pools
    (1, 576, ("K",)),           # deepseek-v2-236b latent only: three pools
])
def test_paged_kv_append_kernel_bitwise(cuda, KVH, d, streams):
    from repro_torch.kernels import mx_paged_attention as KP
    lens = (0, 127, 128, 1000)
    _, K, V, bt, lengths = _paged_kv(cuda, lens, 9, KVH, d, KVH, seed=3)
    pools = [s.payload[f] for s in (K, V)[:len(streams)]
             for f in sorted(s.payload)]
    g = torch.Generator(device=cuda).manual_seed(4)
    rows = [torch.randint(-63, 64, (4, KVH, p.shape[-1]), generator=g,
                          device=cuda).to(p.dtype) for p in pools]
    before = [p.clone() for p in pools]
    plain = [p.clone() for p in pools]
    n0 = KP.mx_paged_kv_append.launches
    KP.mx_paged_kv_append(pools, rows, bt, 7, lengths)
    KP.plain_append(plain, rows, bt, 7, lengths)
    torch.cuda.synchronize()
    assert KP.mx_paged_kv_append.launches == n0 + 1
    keep = torch.ones(pools[0].shape[:3], dtype=torch.bool, device=cuda)
    for b, n in enumerate(lens):
        keep[bt[b, n // 128], 7, n % 128] = False
    for a, p, b0 in zip(pools, plain, before):
        assert torch.equal(a, p)
        assert torch.equal(a[keep], b0[keep])


_APPEND_OUTSIDE_TABLE = """
import torch
from repro_torch.kernels import mx_paged_attention as KP
pools = [torch.zeros((3, 1, 128, 2, 16), dtype=torch.int8, device="cuda")]
rows = [torch.ones((1, 2, 16), dtype=torch.int8, device="cuda")]
bt = torch.tensor([[1]], dtype=torch.int32, device="cuda")
lengths = torch.tensor([128], dtype=torch.int32, device="cuda")
try:
    KP.plain_append([p.cpu() for p in pools], [r.cpu() for r in rows],
                    bt.cpu(), 0, lengths.cpu())
except IndexError:
    print("plain: IndexError", flush=True)
KP.mx_paged_kv_append(pools, rows, bt, 0, lengths)
torch.cuda.synchronize()
print("kernel: no error", flush=True)
"""


def test_paged_kv_append_outside_the_table_raises(cuda):
    """A slot past the block table (len // 128 >= npg): the plain version
    raises IndexError, the kernel fails a device-side assert that the next
    synchronize raises.  In a child process: the assert leaves the CUDA
    context unusable."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", _APPEND_OUTSIDE_TABLE],
                         capture_output=True, text=True, env=env, timeout=300)
    assert "plain: IndexError" in out.stdout
    assert out.returncode != 0 and "kernel: no error" not in out.stdout
    assert "device-side assert" in out.stderr, out.stderr[-2000:]


#: the fused append's value magnitudes: at 1e-37 the groups' scales are
#: subnormal (the quantizer's two-multiply path), at 1e35 near the top
APPEND_MAGS = (1.0, 1e-3, 1e-37, 1e35)


def _append_quant_case(cuda, KVH, d, n, mag, lens=(0, 127, 128, 1000)):
    """MX8 page pools (one per stream), shuffled pages whose slots straddle
    page ends, and the new token's fp32 rows (4, 1, KVH, d) at ``mag``."""
    _, K, V, bt, lengths = _paged_kv(cuda, lens, 9, KVH, d, KVH, seed=d + n)
    g = torch.Generator(device=cuda).manual_seed(d)
    rows = [torch.randn((len(lens), 1, KVH, d), generator=g, device=cuda)
            * mag for _ in range(n)]
    rows[0].view(-1, 16)[::5] = 0.0               # zero groups: micro 0
    return [K, V][:n], rows, bt, lengths


def _eager_append(pools, rows, bt, group, lengths, seed, rounding):
    """The path the fused launch replaced: each stream quantized eagerly
    (``sr_bits`` + ``F.quantize``, seed + i), then the copy kernel."""
    from repro_torch.kernels import mx_paged_attention as KP
    payload, dst = [], []
    for i, (x, pool) in enumerate(zip(rows, pools)):
        bits = (F.sr_bits(x.shape, (seed + i) & 0xFFFFFFFF, device=x.device)
                if rounding == "stochastic" else None)
        q = F.quantize(x, "mx8", rounding, bits)
        payload += [q.payload[f][:, 0] for f in sorted(q.payload)]
        dst += [pool.payload[f] for f in sorted(pool.payload)]
    KP.mx_paged_kv_append(dst, payload, bt, group, lengths)


@pytest.mark.parametrize("mag", APPEND_MAGS)
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("KVH,d,n", [(32, 80, 2), (1, 576, 1)])
def test_paged_kv_append_quant_kernel_bitwise(cuda, KVH, d, n, rounding,
                                              mag):
    """The fused quantize-and-append at zamba2-2.7b's K and V (six pools)
    and deepseek-v2-236b's latent (three): mantissa, exponent and micro
    bitwise its plain version and the eager quantize + copy it replaced,
    every byte outside the appended slots unchanged, one launch."""
    from repro_torch.kernels import mx_paged_attention as KP
    pools, rows, bt, lengths = _append_quant_case(cuda, KVH, d, n, mag)
    before = [p.clone() for p in pools]
    plain = [p.clone() for p in pools]
    eager = [p.clone() for p in pools]
    seed = 0xFFFFFFFF
    counts = (KP.mx_paged_kv_append_quant.launches,
              KP.mx_paged_kv_append_quant.mla_launches)
    KP.mx_paged_kv_append_quant(rows, pools, bt, 7, lengths, seed,
                                rounding=rounding)
    KP.plain_append_quant(rows, plain, bt, 7, lengths, seed, rounding)
    _eager_append(eager, rows, bt, 7, lengths, seed, rounding)
    torch.cuda.synchronize()
    assert (KP.mx_paged_kv_append_quant.launches,
            KP.mx_paged_kv_append_quant.mla_launches) == (
        counts[0] + (n == 2), counts[1] + (n == 1))
    keep = torch.ones(pools[0].payload["mantissa"].shape[:3],
                      dtype=torch.bool, device=cuda)
    for b, n_b in enumerate(lengths.tolist()):
        keep[bt[b, n_b // 128], 7, n_b % 128] = False
    for a, p, e, b0 in zip(pools, plain, eager, before):
        for f in ("mantissa", "exponent", "micro"):
            assert torch.equal(a.payload[f], p.payload[f]), f
            assert torch.equal(a.payload[f], e.payload[f]), f
            assert torch.equal(a.payload[f][keep], b0.payload[f][keep]), f


def test_paged_kv_append_quant_takes_unaligned_rows(cuda):
    """A stream that does not start on 16 bytes (a strided view's offset)
    is copied before the float4 loads: the same bytes as aligned rows."""
    from repro_torch.kernels import mx_paged_attention as KP
    pools, rows, bt, lengths = _append_quant_case(cuda, 32, 80, 2, 1.0)
    other = [p.clone() for p in pools]
    base = torch.empty(rows[0].numel() + 1, device=cuda)
    shifted = base[1:].view(rows[0].shape)
    shifted.copy_(rows[0])
    assert shifted.data_ptr() % 16
    KP.mx_paged_kv_append_quant([shifted, rows[1]], pools, bt, 3, lengths, 5)
    KP.mx_paged_kv_append_quant(rows, other, bt, 3, lengths, 5)
    torch.cuda.synchronize()
    for a, b in zip(pools, other):
        for f in a.payload:
            assert torch.equal(a.payload[f], b.payload[f]), f


@pytest.mark.parametrize("KVH,d,n", [(32, 80, 2), (1, 576, 1)])
def test_paged_kv_append_quant_replays_in_a_cuda_graph_bitwise(cuda, KVH, d,
                                                               n):
    """20 CUDA-graph replays of the fused append, each from the same pools,
    give the eager launch's bytes."""
    from repro_torch.kernels import mx_paged_attention as KP
    start, rows, bt, lengths = _append_quant_case(cuda, KVH, d, n, 1.0)
    eager = [p.clone() for p in start]
    KP.mx_paged_kv_append_quant(rows, eager, bt, 2, lengths, 41)
    pools = [p.clone() for p in start]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        KP.mx_paged_kv_append_quant(rows, pools, bt, 2, lengths, 41)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        KP.mx_paged_kv_append_quant(rows, pools, bt, 2, lengths, 41)
    for i in range(20):
        for p, s0 in zip(pools, start):
            for f, a in p.payload.items():
                a.copy_(s0.payload[f])
        graph.replay()
        torch.cuda.synchronize()
        for p, e in zip(pools, eager):
            for f, a in p.payload.items():
                assert torch.equal(a, e.payload[f]), (f, i)


_APPEND_QUANT_OUTSIDE_TABLE = """
import torch
from repro_torch.core import formats as F
from repro_torch.kernels import mx_paged_attention as KP
pool = F.mx8_quantize(torch.zeros((3, 1, 128, 2, 16), device="cuda"))
rows = [torch.ones((1, 1, 2, 16), device="cuda")]
bt = torch.tensor([[1]], dtype=torch.int32, device="cuda")
lengths = torch.tensor([128], dtype=torch.int32, device="cuda")
try:
    KP.plain_append_quant([r.cpu() for r in rows],
                          [F.mx8_quantize(torch.zeros((3, 1, 128, 2, 16)))],
                          bt.cpu(), 0, lengths.cpu())
except IndexError:
    print("plain: IndexError", flush=True)
KP.mx_paged_kv_append_quant(rows, [pool], bt, 0, lengths)
torch.cuda.synchronize()
print("kernel: no error", flush=True)
"""


def test_paged_kv_append_quant_outside_the_table_raises(cuda):
    """A slot past the block table: the plain version raises IndexError,
    the fused kernel fails its device-side assert (in a child process, as
    for the copy kernel)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", _APPEND_QUANT_OUTSIDE_TABLE],
                         capture_output=True, text=True, env=env, timeout=300)
    assert "plain: IndexError" in out.stdout
    assert out.returncode != 0 and "kernel: no error" not in out.stdout
    assert "device-side assert" in out.stderr, out.stderr[-2000:]


@pytest.mark.parametrize("B,H,dk,dv", [(4, 80, 64, 64), (4, 80, 128, 64)]
                         + GLA_SU)
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_state_update_slab_mode_bitwise_vs_dense(cuda, B, H, dk, dv,
                                                 rounding):
    g = torch.Generator(device=cuda).manual_seed(dk)
    pool = F.mx8_quantize(torch.randn((9, 6, H, dv, dk), generator=g,
                                      device=cuda))
    slabs = torch.tensor([7, 2, 5, 3], dtype=torch.int32, device=cuda)
    _, d, k, v, q = _su_inputs(B, H, dk, dv, cuda, scalar_decay=False)
    idx = (slabs.long(), 4)
    rows = F.QuantizedTensor("mx8", (B, H, dv, dk), {
        f: a[idx].clone() for f, a in pool.payload.items()})
    plain, yp = KS.plain_slab(pool.clone(), slabs, 4, d, k, v, q,
                              rounding=rounding, seed=3)
    n0 = (KS.mx_state_update.launches, KS.mx_state_update.slab_launches)
    dense, yd = KS.mx_state_update(rows, d, k, v, q, seed=3,
                                   rounding=rounding)
    _, ys = KS.mx_state_update(pool, d, k, v, q, seed=3, rounding=rounding,
                               slabs=slabs, group=4)
    torch.cuda.synchronize()
    assert (KS.mx_state_update.launches,
            KS.mx_state_update.slab_launches) == (n0[0] + 1, n0[1] + 1)
    assert torch.equal(ys, yd)
    for f, a in pool.payload.items():
        assert torch.equal(a[idx], dense.payload[f]), f
    # and against the plain slab version on the same inputs: the owned rows
    # under the state-update contract, every other slab row untouched
    _assert_state_update_contract(
        {f: a[idx] for f, a in plain.payload.items()}, yp,
        {f: a[idx] for f, a in pool.payload.items()}, ys)
    keep = torch.ones((9, 6), dtype=torch.bool, device=cuda)
    keep[idx] = False
    for f, a in pool.payload.items():
        assert torch.equal(a[keep], plain.payload[f][keep]), f


@pytest.mark.parametrize("dk,dv", [(16, 37), (4096, 5), (4096, 13)])
@pytest.mark.parametrize("mag", [1.0, 1e-37])
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("scalar_decay", [True, False])
def test_state_update_kernel_edge_shapes_vs_plain(cuda, dk, dv, mag, rounding,
                                                  scalar_decay):
    """Kernel 1 at the wrapper's limits, one head (BH = 1): dk = 16 (one
    group a row) and dk = 4096 (256 groups, operands staged in 48 KB), dv
    not a multiple of the rows a thread owns.  At magnitude 1e-37 (v
    scaled too, so the new state stays there) the scales are subnormal and
    the quantizer takes its two-multiply path.  Operands at an odd offset
    are copied by the wrapper before the kernel's 16-byte loads."""
    qS, d, k, v, q = _su_inputs(1, 1, dk, dv, cuda, scalar_decay, mag)
    v = v * mag
    k_odd = torch.empty(dk + 1, device=cuda)[1:].view(1, 1, dk)
    k_odd.copy_(k)
    assert k_odd.data_ptr() % 16
    qp, yp = KS.plain(qS.clone(), d, k, v, q, rounding=rounding, seed=5)
    qk, yk = KS.mx_state_update(qS.clone(), d, k_odd, v, q, seed=5,
                                rounding=rounding)
    torch.cuda.synchronize()
    assert int(qk.payload["exponent"].min()) < 127 - 120 or mag == 1.0
    _assert_state_update_contract(qp.payload, yp, qk.payload, yk)


def test_state_update_slab_mode_idle_rows_on_scratch_slab(cuda):
    """Idle batch rows all point at scratch slab 0, as the paged pool's
    do: their launches race on it, and the active rows still equal dense
    mode on their gathered rows bitwise, every other slab untouched."""
    B, H, dk, dv = 4, 4, 320, 640
    g = torch.Generator(device=cuda).manual_seed(8)
    pool = F.mx8_quantize(torch.randn((6, 3, H, dv, dk), generator=g,
                                      device=cuda))
    slabs = torch.tensor([3, 0, 5, 0], dtype=torch.int32, device=cuda)
    _, d, k, v, q = _su_inputs(B, H, dk, dv, cuda, scalar_decay=False)
    active = torch.tensor([0, 2], device=cuda)
    idx = (slabs.long(), 1)
    rows = F.QuantizedTensor("mx8", (B, H, dv, dk), {
        f: a[idx].clone() for f, a in pool.payload.items()})
    before = pool.clone()
    dense, yd = KS.mx_state_update(rows, d, k, v, q, seed=4)
    _, ys = KS.mx_state_update(pool, d, k, v, q, seed=4, slabs=slabs,
                               group=1)
    torch.cuda.synchronize()
    assert torch.equal(ys[active], yd[active])
    for f, a in pool.payload.items():
        assert torch.equal(a[slabs.long()[active], 1],
                           dense.payload[f][active]), f
        assert torch.equal(a[1:3], before.payload[f][1:3]), f
        assert torch.equal(a[4], before.payload[f][4]), f
        assert torch.equal(a[[3, 5]][:, [0, 2]],
                           before.payload[f][[3, 5]][:, [0, 2]]), f


@pytest.mark.parametrize("mode", ["dense", "slab"])
def test_state_update_replays_in_a_cuda_graph_bitwise(cuda, mode):
    """20 CUDA-graph replays of kernel 1, each from the same state, give
    the eager launch's state bytes and y bitwise."""
    B, H, dk, dv = 4, 10, 256, 512
    g = torch.Generator(device=cuda).manual_seed(9)
    shape = (B, H, dv, dk) if mode == "dense" else (6, 2, H, dv, dk)
    start = F.mx8_quantize(torch.randn(shape, generator=g, device=cuda))
    _, d, k, v, q = _su_inputs(B, H, dk, dv, cuda, scalar_decay=True)
    kw = {} if mode == "dense" else dict(
        slabs=torch.tensor([1, 4, 2, 5], dtype=torch.int32, device=cuda),
        group=1)
    st = start.clone()
    eager_state, eager_y = KS.mx_state_update(st, d, k, v, q, seed=6, **kw)
    eager_state = eager_state.clone()
    torch.cuda.synchronize()
    st = start.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        KS.mx_state_update(st, d, k, v, q, seed=6, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _, y = KS.mx_state_update(st, d, k, v, q, seed=6, **kw)
    for i in range(20):
        for f, a in st.payload.items():
            a.copy_(start.payload[f])
        y.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, eager_y), i
        for f, a in st.payload.items():
            assert torch.equal(a, eager_state.payload[f]), (f, i)


def test_paged_smoke_engine_launches_each_kernel_per_layer(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.models import model as M
    from repro_torch.serving.api import Engine, ServeConfig
    cfg = get_smoke_config("zamba2-2.7b")
    params = M.init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                          device=cuda)
    eng = Engine(params, cfg, ServeConfig(batch=2, n_pages=4))
    rng = np.random.default_rng(0)
    hs = [eng.submit(rng.integers(0, cfg.vocab_size, n), max_new_tokens=5)
          for n in (9, 140, 17)]
    counters = (KS.mx_state_update, KP.mx_paged_attention_decode,
                KP.mx_paged_kv_append_quant, KP.mx_paged_kv_append,
                KA.mx_attention_decode)
    for c in counters:
        c.launches = 0
    KS.mx_state_update.slab_launches = 0
    eng.run()
    steps = eng.engine.step_count
    assert all(h.status == "done" and len(h.output) == 5 for h in hs)
    n_m2 = cfg.pattern.count("mamba2") * cfg.n_groups
    assert KS.mx_state_update.slab_launches == n_m2 * steps
    # the fused quantize-and-append, never the copy kernel
    assert [c.launches for c in counters] == [
        0, cfg.n_groups * steps, cfg.n_groups * steps, 0, 0]


def test_smoke_engine_launches_each_kernel_per_layer(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.serving.api import Engine, ServeConfig
    cfg = get_smoke_config("zamba2-2.7b")
    params = M.init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                          device=cuda)
    eng = Engine(params, cfg, ServeConfig(backend="slots", batch=2,
                                          cache_capacity=256))
    rng = np.random.default_rng(0)
    hs = [eng.submit(rng.integers(0, cfg.vocab_size, n), max_new_tokens=5)
          for n in (9, 40, 17)]
    KS.mx_state_update.launches = KA.mx_attention_decode.launches = 0
    eng.run()
    steps = eng.engine.step_count
    assert all(h.status == "done" and len(h.output) == 5 for h in hs)
    n_m2 = cfg.pattern.count("mamba2") * cfg.n_groups
    assert KS.mx_state_update.launches == n_m2 * steps
    assert KA.mx_attention_decode.launches == cfg.n_groups * steps


# ---------------------------------------------------------------------------
# speculative-verify attention (kernels 5 and 6) and the speculative engine
# ---------------------------------------------------------------------------

def _spec_pools(cuda, lengths, Kq, G, d, seed, n_stack=9, KVH=8):
    q1, K, V, bt, lens = _paged_kv(cuda, lengths, n_stack, KVH, d, KVH * G,
                                   seed)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    q = torch.randn((len(lengths), Kq, KVH * G, d), generator=g, device=cuda)
    return q, K, V, bt, lens


@pytest.mark.parametrize("Kq", [1, 2, 4])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("lens", [(4, 127, 128, 129), (1000, 131, 129, 5),
                                  (1025, 1154, 640, 8)])
def test_spec_attention_kernels_vs_plain_and_decode_kernels(cuda, Kq, G,
                                                            lens):
    """Kernel 6 and kernel 5 against their plain versions (rtol 2e-4, atol
    2e-5); kernel 5 bitwise kernel 6 over the gathered pages; row j
    bitwise kernels 2 and 3 at the shifted length -- across split
    boundaries, rows of 9-10 splits, shuffled non-contiguous pages, 9
    layers.  At Kq = 4, lengths 129, 131, 1025 and 1154 end row 0 one
    split before row 3: that split is fully masked for row 0."""
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_spec_attention as KV
    from repro_torch.kernels import ref as R
    q, K, V, bt, lengths = _spec_pools(cuda, lens, Kq, G, 80, seed=Kq * G)
    group = 6
    Kd, Vd = R.gather_pages(K, bt, group), R.gather_pages(V, bt, group)
    n5, n6 = (KV.mx_paged_spec_attention_decode.launches,
              KV.mx_spec_attention_decode.launches)
    y5 = KV.mx_paged_spec_attention_decode(q, K, V, bt, group, lengths)
    y6 = KV.mx_spec_attention_decode(q, Kd, Vd, lengths)
    torch.cuda.synchronize()
    assert (KV.mx_paged_spec_attention_decode.launches,
            KV.mx_spec_attention_decode.launches) == (n5 + 1, n6 + 1)
    assert y5.shape == (len(lens), Kq, 8 * G, 80)
    torch.testing.assert_close(y6, KV.plain(q, Kd, Vd, lengths), rtol=2e-4,
                               atol=2e-5)
    torch.testing.assert_close(
        y5, KV.plain_paged(q, K, V, bt, group, lengths), rtol=2e-4,
        atol=2e-5)
    assert torch.equal(y5, y6)
    for j in range(Kq):
        lj = lengths - (Kq - 1 - j)
        qj = q[:, j].contiguous()
        assert torch.equal(y6[:, j], KA.mx_attention_decode(qj, Kd, Vd, lj))
        assert torch.equal(y5[:, j], KP.mx_paged_attention_decode(
            qj, K, V, bt, group, lj))


#: (Kq, G): R = Kq * G query rows a kv head past one block's 16: yi-9b
#: (32), yi-34b (28), dbrx-132b (24), two row blocks each
ROW_BLOCK_CASES = [(4, 8), (4, 7), (4, 6)]


@pytest.mark.parametrize("Kq,G", ROW_BLOCK_CASES)
@pytest.mark.parametrize("lens", [(4, 127, 128, 129), (1000, 131, 129, 5),
                                  (1025, 1154, 640, 8)])
def test_spec_attention_row_blocks_vs_plain_and_decode_kernels(cuda, Kq, G,
                                                               lens):
    """Kernels 5 and 6 at Kq * G > 16 (head width 128, 4 kv heads): within
    rtol 2e-4, atol 2e-5 of their plain versions; kernel 5 bitwise kernel
    6 over the gathered pages; verify row j bitwise kernels 2 and 3 at
    length len - (Kq - 1 - j)."""
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_spec_attention as KV
    from repro_torch.kernels import ref as R
    q, K, V, bt, lengths = _spec_pools(cuda, lens, Kq, G, 128, seed=Kq * G,
                                       n_stack=3, KVH=4)
    group = 2
    Kd, Vd = R.gather_pages(K, bt, group), R.gather_pages(V, bt, group)
    y5 = KV.mx_paged_spec_attention_decode(q, K, V, bt, group, lengths)
    y6 = KV.mx_spec_attention_decode(q, Kd, Vd, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(y6, KV.plain(q, Kd, Vd, lengths), rtol=2e-4,
                               atol=2e-5)
    torch.testing.assert_close(
        y5, KV.plain_paged(q, K, V, bt, group, lengths), rtol=2e-4,
        atol=2e-5)
    assert torch.equal(y5, y6)
    for j in range(Kq):
        lj = lengths - (Kq - 1 - j)
        qj = q[:, j].contiguous()
        assert torch.equal(y6[:, j], KA.mx_attention_decode(qj, Kd, Vd, lj))
        assert torch.equal(y5[:, j], KP.mx_paged_attention_decode(
            qj, K, V, bt, group, lj))


def test_split_kernels_replay_in_a_cuda_graph_bitwise(cuda):
    """20 CUDA-graph replays of kernels 3 and 5 give the eager launch's
    output bitwise: the last block of each (row, kv head) leaves its split
    counter at zero, so every replay combines its splits afresh."""
    from repro_torch.kernels import mx_attention as KA_
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_spec_attention as KV
    lens = (1025, 300, 129, 700)                       # 2 to 9 splits a row
    q, K, V, bt, lengths = _spec_pools(cuda, lens, 4, 4, 80, seed=11)
    q1 = q[:, 0].contiguous()
    # yi-9b's verify shape: two row blocks, each with its own counters
    qy, Ky, Vy, bty, _ = _spec_pools(cuda, lens, 4, 8, 128, seed=12,
                                     n_stack=3, KVH=4)
    calls = {"kernel 3": lambda: KP.mx_paged_attention_decode(
                 q1, K, V, bt, 2, lengths),
             "kernel 5": lambda: KV.mx_paged_spec_attention_decode(
                 q, K, V, bt, 2, lengths),
             "kernel 5, row blocks": lambda: KV.mx_paged_spec_attention_decode(
                 qy, Ky, Vy, bty, 1, lengths)}
    for name, call in calls.items():
        eager = call()
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        for i in range(20):
            out.fill_(float("nan"))
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager), (name, i)
        for held in KA_._COUNTERS.values():
            assert int(held[-1].abs().sum()) == 0, name


def test_spec_attention_kernels_refuse_out_of_limit_and_mla(cuda):
    """GQA mode refuses only what a block cannot hold -- a row block's
    shared memory, a value row past the accumulators -- and launches the
    shapes of the old 16-row limit (20 rows; 16 rows of 144 values)."""
    from repro_torch.kernels import mx_spec_attention as KV
    from repro_torch.kernels import ref as R_
    for Kq, G, d in ((5, 4, 32), (2, 8, 144)):
        q, K, V, bt, lengths = _spec_pools(cuda, (130, 5), Kq, G, d,
                                           seed=Kq)
        torch.testing.assert_close(
            KV.mx_paged_spec_attention_decode(q, K, V, bt, 0, lengths),
            R_.mx_paged_spec_attention_decode_ref(q, K, V, bt, 0, lengths),
            rtol=2e-4, atol=2e-5)
    q5, K5, V5, bt5, l5 = _spec_pools(cuda, (130, 5), 2, 8, 512, seed=2,
                                      n_stack=1, KVH=1)
    with pytest.raises(ValueError, match="shared memory"):   # 366592 B
        KV.mx_paged_spec_attention_decode(q5, K5, V5, bt5, 0, l5)
    # MLA mode has no row limit, but its own width limits (no fallback);
    # q, K: the pools of width 144 above
    from repro_torch.kernels import ref as R
    with pytest.raises(ValueError, match="v_width"):          # missing
        KV.mx_paged_spec_attention_decode(q, K, None, bt, 0, lengths)
    with pytest.raises(ValueError, match="v_width"):          # dv > dk
        KV.mx_spec_attention_decode(q, R.gather_pages(K, bt, 0), None,
                                    lengths, v_width=160)
    q, K, _, bt, lengths = _spec_pools(cuda, (130, 5), 1, 2, 1168, seed=3,
                                       KVH=1)
    with pytest.raises(ValueError, match="dk <= 1152"):       # smem bound
        KV.mx_paged_spec_attention_decode(q, K, None, bt, 0, lengths,
                                          v_width=512)


# ---------------------------------------------------------------------------
# MLA mode of kernels 2, 3, 5 and 6 (latent stream, values = first dv lanes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,dk,dv", [
    (8, 64, 32),             # deepseek-v2-236b smoke widths: a partial block
    (16, 192, 128),          # the JAX kernel test's widths
    (128, 576, 512),         # deepseek-v2-236b: 128 heads, kv_lora + rope
])
@pytest.mark.parametrize("Kq", [1, 4])
@pytest.mark.parametrize("lens", [(4, 127, 128, 129), (1000, 131, 129, 5),
                                  (1100, 65, 193, 4)])
def test_mla_kernels_vs_plain_and_bitwise_contracts(cuda, H, dk, dv, Kq,
                                                    lens):
    """MLA mode of kernels 2, 3, 5 and 6 against their plain versions (rtol
    2e-4, atol 2e-5); the paged kernels bitwise the dense ones over the
    gathered pages; verify row j bitwise the decode kernels at the shifted
    length (Kq = 1: the verify kernels are the decode kernels).  The third
    lengths span 2 to 18 64-position splits (9 pages), and at Kq = 4 the
    last split of 65 and 193 is fully masked for verify rows 0 to 2."""
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_spec_attention as KV
    from repro_torch.kernels import ref as R
    q, K, _, bt, lengths = _spec_pools(cuda, lens, Kq, H, dk, seed=dk + Kq,
                                       n_stack=3, KVH=1)
    group, scale = 2, 0.125
    kw = dict(scale=scale, v_width=dv)
    Kd = R.gather_pages(K, bt, group)
    n0 = [c.mla_launches for c in (KA.mx_attention_decode,
                                   KP.mx_paged_attention_decode,
                                   KV.mx_paged_spec_attention_decode,
                                   KV.mx_spec_attention_decode)]
    y5 = KV.mx_paged_spec_attention_decode(q, K, None, bt, group, lengths,
                                           **kw)
    y6 = KV.mx_spec_attention_decode(q, Kd, None, lengths, **kw)
    torch.testing.assert_close(
        y6, KV.plain(q, Kd, None, lengths, scale, dv), rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(
        y5, KV.plain_paged(q, K, None, bt, group, lengths, scale, dv),
        rtol=2e-4, atol=2e-5)
    assert y5.shape == (len(lens), Kq, H, dv) and torch.equal(y5, y6)
    for j in range(Kq):
        lj = lengths - (Kq - 1 - j)
        qj = q[:, j].contiguous()
        y2 = KA.mx_attention_decode(qj, Kd, None, lj, **kw)
        y3 = KP.mx_paged_attention_decode(qj, K, None, bt, group, lj, **kw)
        torch.testing.assert_close(y2, KA.plain(qj, Kd, None, lj, scale, dv),
                                   rtol=2e-4, atol=2e-5)
        assert torch.equal(y3, y2) and torch.equal(y6[:, j], y2)
    torch.cuda.synchronize()
    assert [c.mla_launches for c in (KA.mx_attention_decode,
                                     KP.mx_paged_attention_decode,
                                     KV.mx_paged_spec_attention_decode,
                                     KV.mx_spec_attention_decode)] == [
        n0[0] + Kq, n0[1] + Kq, n0[2] + 1, n0[3] + 1]


@pytest.mark.parametrize("Kq", [1, 4])
def test_mla_kernels_keep_a_subnormal_latent(cuda, Kq):
    """A latent at magnitude 1e-37: the MX8 scales are subnormal, and about
    7 % of the values are subnormal in bf16 too.  The queries at 5e36 keep
    the scores O(1), and the latent is nonnegative, so every output is a
    normal weighted mean that no cancellation makes tiny: held to the plain
    versions at rtol 2e-4 with atol 0.  A product that flushed the
    subnormal values to zero would miss by up to 50 %."""
    from repro_torch.core import formats as F
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_spec_attention as KV
    from repro_torch.kernels import ref as R
    q, K, _, bt, lengths = _spec_pools(cuda, (300, 65, 129, 4), Kq, 128, 576,
                                       seed=37, n_stack=3, KVH=1)
    g = torch.Generator(device=cuda).manual_seed(38)
    K = F.mx8_quantize(torch.randn(K.shape, generator=g, device=cuda).abs()
                       * 1e-37)
    vals = F.dequantize(K)
    assert float(((vals != 0) & (vals.abs() < 2.0 ** -126)).float().mean()) \
        > 0.05
    q = q * 5e36
    group, scale = 1, 0.125
    kw = dict(scale=scale, v_width=512)
    Kd = R.gather_pages(K, bt, group)
    y5 = KV.mx_paged_spec_attention_decode(q, K, None, bt, group, lengths,
                                           **kw)
    p5 = KV.plain_paged(q, K, None, bt, group, lengths, scale, 512)
    torch.testing.assert_close(y5, p5, rtol=2e-4, atol=0.0)
    y6 = KV.mx_spec_attention_decode(q, Kd, None, lengths, **kw)
    assert torch.equal(y5, y6)
    q1 = q[:, -1].contiguous()
    y3 = KP.mx_paged_attention_decode(q1, K, None, bt, group, lengths, **kw)
    torch.testing.assert_close(y3, KP.plain(q1, K, None, bt, group, lengths,
                                            scale, 512), rtol=2e-4, atol=0.0)
    assert torch.equal(y3, KA.mx_attention_decode(q1, Kd, None, lengths, **kw))
    assert torch.equal(y6[:, -1], y3)


def test_mla_kernels_with_interleaved_kv_heads_and_odd_value_width(cuda):
    """Two kv heads (their latent rows interleave, so the split's mantissas
    stage a row a copy), G = 8 (a 16-row block spans two verify positions)
    and v_width 42 (the outputs' last quad partly past dv): kernels 5, 6,
    2, 3 against their plain versions and the three bitwise contracts."""
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_spec_attention as KV
    from repro_torch.kernels import ref as R
    Kq, dv = 4, 42
    q, K, _, bt, lengths = _spec_pools(cuda, (300, 65, 129, 4), Kq, 8, 64,
                                       seed=13, n_stack=3, KVH=2)
    group, scale = 2, 0.125
    kw = dict(scale=scale, v_width=dv)
    Kd = R.gather_pages(K, bt, group)
    y5 = KV.mx_paged_spec_attention_decode(q, K, None, bt, group, lengths,
                                           **kw)
    y6 = KV.mx_spec_attention_decode(q, Kd, None, lengths, **kw)
    torch.testing.assert_close(
        y6, KV.plain(q, Kd, None, lengths, scale, dv), rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(
        y5, KV.plain_paged(q, K, None, bt, group, lengths, scale, dv),
        rtol=2e-4, atol=2e-5)
    assert y5.shape == (4, Kq, 16, dv) and torch.equal(y5, y6)
    for j in range(Kq):
        lj = lengths - (Kq - 1 - j)
        qj = q[:, j].contiguous()
        y2 = KA.mx_attention_decode(qj, Kd, None, lj, **kw)
        y3 = KP.mx_paged_attention_decode(qj, K, None, bt, group, lj, **kw)
        torch.testing.assert_close(y2, KA.plain(qj, Kd, None, lj, scale, dv),
                                   rtol=2e-4, atol=2e-5)
        assert torch.equal(y3, y2) and torch.equal(y6[:, j], y2)


def test_mla_kernels_replay_in_a_cuda_graph_bitwise(cuda):
    """20 CUDA-graph replays of the MLA mode of kernels 3 and 5 give the
    eager launch's output bitwise, and the split counters are back at zero:
    the last block of each (row, row block) resets its own."""
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_spec_attention as KV
    q, K, _, bt, lengths = _spec_pools(cuda, (1025, 300, 129, 700), 4, 128,
                                       576, seed=12, n_stack=3, KVH=1)
    q1 = q[:, 0].contiguous()
    kw = dict(scale=0.1, v_width=512)
    calls = {"kernel 3": lambda: KP.mx_paged_attention_decode(
                 q1, K, None, bt, 2, lengths, **kw),
             "kernel 5": lambda: KV.mx_paged_spec_attention_decode(
                 q, K, None, bt, 2, lengths, **kw)}
    for name, call in calls.items():
        eager = call()
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        for i in range(20):
            out.fill_(float("nan"))
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager), (name, i)
        for held in KA._COUNTERS.values():
            assert int(held[-1].abs().sum()) == 0, name


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b",
                                  "zamba2-2.7b", "gla-2.7b", "opt-6.7b",
                                  "yi-9b"])
def test_smoke_ngram_spec_greedy_equals_plain_on_card(cuda, arch):
    """The n-gram speculative stream equals the plain paged stream (MX8,
    nearest rounding, CUDA kernels), and a verify step launches the paged
    verify kernel once and the append n times per attention layer, the
    slab-mode state update n times per recurrent layer."""
    from repro_torch import ops as OPS
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_spec_attention as KV
    from repro_torch.models import model as M
    from repro_torch.serving.api import Engine, ServeConfig
    cfg = get_smoke_config(arch).with_(
        state_quant=OPS.StateQuantConfig("mx8", "nearest", "cuda"))
    params = M.init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                          device=cuda)
    rng = np.random.default_rng(3)
    base = rng.integers(0, cfg.vocab_size, 6)
    prompts = [np.tile(base, 4), rng.integers(0, cfg.vocab_size, 9),
               np.tile(base[:3], 45)]
    outs, counts = [], None
    for spec in (None, "ngram"):
        eng = Engine(params, cfg, ServeConfig(batch=2, n_pages=17, n_slabs=5,
                                              spec=spec, spec_k=3))
        hs = [eng.submit(p, max_new_tokens=12) for p in prompts]
        if spec is not None:
            counters = (KV.mx_paged_spec_attention_decode,
                        KP.mx_paged_attention_decode,
                        KP.mx_paged_kv_append_quant, KP.mx_paged_kv_append)
            for c in counters:
                c.launches = 0
            KS.mx_state_update.slab_launches = 0
        eng.run()
        outs.append([h.output for h in hs])
        assert all(h.status == "done" and len(h.output) == 12 for h in hs)
    steps = eng.engine.step_count
    n_attn = (cfg.pattern.count("attn") * cfg.n_groups
              + (cfg.n_groups if cfg.shared_attn else 0))
    n_rec = sum(cfg.pattern.count(k) for k in ("mamba2", "gla", "retnet",
                                                "hgrn2")) * cfg.n_groups
    assert [c.launches for c in counters] == [n_attn * steps, 0,
                                              4 * n_attn * steps, 0]
    assert KS.mx_state_update.slab_launches == 4 * n_rec * steps
    assert outs[1] == outs[0]
    assert eng.stats()["proposed_tokens"] > 0


def test_attention_spec_step_appends_equal_sequential_kv_append_on_card(
        cuda):
    """On the card (append kernel, verify kernel): n appends with seeds
    seed + i equal n sequential ``kv_append`` calls byte for byte over every
    pool, and the verify is ``spec_attend`` over the appended cache."""
    from repro_torch import ops as OPS
    from repro_torch.core import paged as PG
    from repro_torch.kernels import mx_spec_attention as KV
    base, Kq = (1, 124, 125, 300), 4
    q, K, V, bt, _ = _spec_pools(cuda, [n + Kq for n in base], Kq, 2, 64,
                                 seed=5)
    lens = torch.tensor(base, dtype=torch.int32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    k_new, v_new = (torch.randn((4, Kq, 8, 64), generator=g, device=cuda)
                    for _ in "kv")
    cfg = OPS.StateQuantConfig()
    caches = [PG.PagedKVCache(K.clone(), V.clone(), bt, lens, 3, "mx8")
              for _ in range(2)]
    n0 = KV.mx_paged_spec_attention_decode.launches
    y, c = OPS.attention_spec_step(caches[0], k_new, v_new, q, cfg,
                                   seed=0xFFFFFFFF)
    assert KV.mx_paged_spec_attention_decode.launches == n0 + 1
    seq = caches[1]
    for i in range(Kq):
        seq = OPS.kv_append(seq, k_new[:, i:i + 1].contiguous(),
                            v_new[:, i:i + 1].contiguous(), cfg,
                            seed=(0xFFFFFFFF + i) & 0xFFFFFFFF)
    y_seq = OPS.spec_attend(seq, q, cfg)
    torch.cuda.synchronize()
    assert torch.equal(c.lengths, seq.lengths)
    for f in K.payload:
        assert torch.equal(c.k.payload[f], seq.k.payload[f]), f
        assert torch.equal(c.v.payload[f], seq.v.payload[f]), f
    assert torch.equal(y, y_seq)


# ---------------------------------------------------------------------------
# kernel 7: the MX8 quantizer, and the GLA family served on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 64), (300, 128), (5, 7, 32),
                                   (1, 4, 640, 320), (4, 4, 640, 320),
                                   (4, 10, 512, 256), (4, 20, 128, 128)])
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_mx_quant_kernel_bitwise_vs_plain(cuda, shape, rounding):
    """Bitwise in mantissa, exponent and micro: values across magnitudes,
    with zero groups and subnormals (the exponent floor and its micro 0)."""
    from repro_torch.kernels import mx_quant as KQ
    g = torch.Generator(device=cuda).manual_seed(len(shape) + shape[-1])
    x = torch.randn(shape, generator=g, device=cuda)
    mag = torch.pow(10.0, torch.randint(-40, 6, shape[:-1] + (1,),
                                        generator=g, device=cuda).float())
    x = x * mag
    x.view(-1, 16)[::7] = 0.0
    n0 = KQ.mx_quantize.launches
    got = KQ.mx_quantize(x, 1234, rounding=rounding)
    torch.cuda.synchronize()
    assert KQ.mx_quantize.launches == n0 + 1
    want = KQ.plain(x, rounding, 1234)
    for f in want.payload:
        assert torch.equal(got.payload[f], want.payload[f]), f


def test_mx_quant_kernel_takes_strided_and_unaligned_inputs(cuda):
    from repro_torch.kernels import mx_quant as KQ
    g = torch.Generator(device=cuda).manual_seed(0)
    base = torch.randn((4, 33, 64), generator=g, device=cuda)
    for x in (base.transpose(0, 1), base.reshape(-1)[1:1 + 64 * 20]
              .reshape(20, 64)):
        got = KQ.mx_quantize(x, 5, rounding="stochastic")
        want = KQ.plain(x.contiguous(), "stochastic", 5)
        for f in want.payload:
            assert torch.equal(got.payload[f], want.payload[f]), f


def test_gla_smoke_served_with_kernels_equals_plain_ops(cuda):
    """gla smoke through the paged engine, MX8 at round to nearest: the
    CUDA backend's tokens equal the torch backend's, with the state update
    launched once per layer per step and the quantizer once per layer per
    request prefill."""
    from repro_torch import ops as OPS
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import mx_quant as KQ
    from repro_torch.models import model as M
    from repro_torch.serving.api import Engine, ServeConfig
    base = get_smoke_config("gla-2.7b")
    params = M.init_model(base, torch.Generator(device=cuda).manual_seed(0),
                          device=cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, base.vocab_size, n) for n in (9, 140, 17)]
    outs = []
    for backend in ("cuda", "torch"):
        cfg = base.with_(state_quant=OPS.StateQuantConfig("mx8", "nearest",
                                                          backend))
        eng = Engine(params, cfg, ServeConfig(batch=2, n_pages=4,
                                              prefill_chunk=64))
        hs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        KS.mx_state_update.launches = KS.mx_state_update.slab_launches = 0
        KQ.mx_quantize.launches = 0
        eng.run()
        assert all(h.status == "done" and len(h.output) == 6 for h in hs)
        outs.append([h.output for h in hs])
        steps = eng.engine.step_count
        on = backend == "cuda"
        assert KS.mx_state_update.slab_launches == (
            cfg.n_layers * steps if on else 0)
        assert KS.mx_state_update.launches == 0
        assert KQ.mx_quantize.launches == (
            cfg.n_layers * len(prompts) if on else 0)
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# kernel 7's multi-stream launch and the slot pool's fused dense append
# ---------------------------------------------------------------------------

def _spread(shape, g, mag=None):
    """Values over 45 decades (or at one magnitude ``mag``), every seventh
    16-value group zero."""
    x = torch.randn(shape, generator=g, device=g.device)
    if mag is None:
        x *= torch.pow(10.0, torch.randint(-40, 6, shape[:-1] + (1,),
                                           generator=g,
                                           device=g.device).float())
    else:
        x *= mag
    x.view(-1, 16)[::7] = 0.0
    return x


@pytest.mark.parametrize("shape,pad_to", [
    ((1, 400, 4, 128), 512), ((1, 400, 32, 128), 512), ((3, 37, 2, 32), 128),
    ((4, 512, 1, 576), None), ((4, 4, 640, 320), None), ((5, 7, 32), None)])
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_mx_quant_streams_kernel_bitwise_vs_plain_and_per_stream(
        cuda, shape, pad_to, rounding):
    """One launch for two streams (seeds 9 and 0xFFFFFFFF), padded to the
    tile in the launch where ``pad_to`` is set: bitwise its plain version
    (``F.pad`` then ``mx_quantize_ref`` per stream) and a one-stream launch
    per stream on the padded copy."""
    from repro_torch.kernels import mx_quant as KQ
    g = torch.Generator(device=cuda).manual_seed(shape[-1] + len(shape))
    xs = [_spread(shape, g), _spread(shape, g)]
    seeds = [9, 0xFFFFFFFF]
    n0 = KQ.mx_quantize.launches
    got = KQ.mx_quantize_streams(xs, seeds, rounding=rounding, pad_to=pad_to)
    torch.cuda.synchronize()
    assert KQ.mx_quantize.launches == n0 + 1
    want = KQ.plain_streams(xs, seeds, rounding, pad_to)
    for x, q, p, s in zip(xs, got, want, seeds):
        if pad_to is not None:
            x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad_to - shape[1]))
        one = KQ.mx_quantize(x, s, rounding=rounding)
        for f in p.payload:
            assert torch.equal(q.payload[f], p.payload[f]), f
            assert torch.equal(q.payload[f], one.payload[f]), f


def _dense_append_case(cuda, KVH, w, n_streams, n, T=256, seed=0, mag=1.0):
    """Dense MX8 caches (B = 4, T) of random values, lengths 0, 130, T - 1
    and T + 9 (the last two clamped to T - n), the new rows (4, n, KVH, w)."""
    g = torch.Generator(device=cuda).manual_seed(seed + 31 * n + w)
    caches = [F.mx8_quantize(torch.randn((4, T, KVH, w), generator=g,
                                         device=cuda))
              for _ in range(n_streams)]
    rows = [_spread((4, n, KVH, w), g, mag) for _ in range(n_streams)]
    lens = torch.tensor([0, 130, T - 1, T + 9], dtype=torch.int32,
                        device=cuda)
    return caches, rows, lens


@pytest.mark.parametrize("KVH,w,n_streams", [(32, 80, 2), (32, 128, 2),
                                             (4, 128, 2), (1, 576, 1),
                                             (2, 32, 2)])
@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_dense_append_kernel_bitwise_vs_plain(cuda, KVH, w, n_streams, n,
                                              rounding):
    """The fused dense append at zamba2's, opt-6.7b's, yi-9b's and
    deepseek's stream widths (and a smoke width), n = 1 and Kq, magnitudes
    1, 1e-3, 1e-37 and 1e35: every cache byte equal to its plain version's
    (the eager quantize + ``_update_at``), the clamped slots included."""
    from repro_torch.kernels import mx_quant as KQ
    for mag in (1.0, 1e-3, 1e-37, 1e35):
        caches, rows, lens = _dense_append_case(cuda, KVH, w, n_streams, n,
                                                mag=mag)
        plain = [c.clone() for c in caches]
        n0 = (KQ.mx_kv_append_quant.launches,
              KQ.mx_kv_append_quant.mla_launches)
        KQ.mx_kv_append_quant(rows, caches, lens, 0xFFFFFFFF,
                              rounding=rounding)
        torch.cuda.synchronize()
        want = (n0[0] + 1, n0[1]) if n_streams == 2 else (n0[0], n0[1] + 1)
        assert (KQ.mx_kv_append_quant.launches,
                KQ.mx_kv_append_quant.mla_launches) == want
        KQ.plain_append(rows, plain, lens, 0xFFFFFFFF, rounding)
        for c, p in zip(caches, plain):
            for f in p.payload:
                assert torch.equal(c.payload[f], p.payload[f]), (f, mag)


def test_dense_append_replays_in_a_cuda_graph_bitwise(cuda):
    """Ten appends of K and V at yi-9b's widths (n = 1; the rows and
    lengths written in place between them, as a decode step would) from a
    CUDA graph captured once: every cache byte equal to the same ten
    appends launched eagerly."""
    from repro_torch.kernels import mx_quant as KQ
    caches, rows, lens = _dense_append_case(cuda, 4, 128, 2, 1, seed=5)
    eager = [c.clone() for c in caches]
    torch.manual_seed(6)
    news = [[torch.randn_like(r) for r in rows] for _ in range(10)]
    lens0 = lens.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up outside the capture
        KQ.mx_kv_append_quant(rows, [c.clone() for c in caches], lens, 7)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        KQ.mx_kv_append_quant(rows, caches, lens, 7)
    for i, new in enumerate(news):
        for r, x in zip(rows, new):
            r.copy_(x)
        lens.copy_(lens0 + 37 * i)
        graph.replay()
        KQ.mx_kv_append_quant(new, eager, lens0 + 37 * i, 7)
    torch.cuda.synchronize()
    for c, e in zip(caches, eager):
        for f in e.payload:
            assert torch.equal(c.payload[f], e.payload[f]), f


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "deepseek-v2-236b",
                                  "opt-6.7b", "yi-9b"])
def test_slot_engine_decode_makes_no_plain_quantizer_call(cuda, arch,
                                                          monkeypatch):
    """A slot engine on a smoke config: each decode step launches the fused
    dense append once per attention application (two streams, or one MLA
    latent), each prefill kernel 7 once per recurrent state and once per
    attention application (K and V together), and ``F.mx8_quantize`` never
    runs on the card inside ``M.decode_step`` or ``M.prefill``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import mx_quant as KQ
    from repro_torch.models import model as M
    from repro_torch.serving.api import Engine, ServeConfig
    cfg = get_smoke_config(arch)
    params = M.init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                          device=cuda)
    seen = {"inside": 0, "calls": 0}
    quantize = F.mx8_quantize

    def counted(x, *a, **kw):
        if seen["inside"] and x.is_cuda:
            seen["calls"] += 1
        return quantize(x, *a, **kw)

    def watched(fn):
        def inside(*a, **kw):
            seen["inside"] += 1
            try:
                return fn(*a, **kw)
            finally:
                seen["inside"] -= 1
        return inside

    monkeypatch.setattr(F, "mx8_quantize", counted)
    monkeypatch.setattr(M, "decode_step", watched(M.decode_step))
    monkeypatch.setattr(M, "prefill", watched(M.prefill))
    eng = Engine(params, cfg, ServeConfig(backend="slots", batch=2,
                                          cache_capacity=256))
    rng = np.random.default_rng(0)
    hs = [eng.submit(rng.integers(0, cfg.vocab_size, n), max_new_tokens=5)
          for n in (9, 40, 17)]
    KQ.mx_kv_append_quant.launches = KQ.mx_kv_append_quant.mla_launches = 0
    KQ.mx_quantize.launches = 0
    eng.run()
    torch.cuda.synchronize()
    steps = eng.engine.step_count
    assert all(h.status == "done" and len(h.output) == 5 for h in hs)
    assert seen["calls"] == 0

    def layers(kinds):
        return (sum(cfg.pattern.count(k) for k in kinds) * cfg.n_groups
                + sum(cfg.prelude.count(k) for k in kinds))
    n_attn = layers(("attn",)) + (cfg.n_groups if cfg.shared_attn else 0)
    n_mla = layers(("mla",))
    n_rec = layers(("mamba2", "gla", "retnet", "hgrn2"))
    assert (KQ.mx_kv_append_quant.launches,
            KQ.mx_kv_append_quant.mla_launches) == (n_attn * steps,
                                                    n_mla * steps)
    assert KQ.mx_quantize.launches == (n_rec + n_attn + n_mla) * len(hs)


# ---------------------------------------------------------------------------
# xlstm-1.3b: kernel 1 at the mLSTM's 1040-row heads, kernel 7 at its
# prefill state, and the smoke model served through both pools
# ---------------------------------------------------------------------------

def _mlstm_su_inputs(dev, B=2, lead=None):
    """A state of ``lead`` (default ``(B,)``) + (4, 1040, 1024): row 1024
    the normalizer, at 8-50 times the state, rows 1025-1039 zero; operands
    for B rows: v = [v, 1, 0 x 15], k times exp(i), scalar decay."""
    H, dv, dk = 4, 1040, 1024
    g = torch.Generator(device=dev).manual_seed(1040)
    S0 = torch.randn((lead or (B,)) + (H, dv, dk), generator=g, device=dev)
    S0[..., 1024, :] = (S0[..., 1024, :].abs() + 1.0) * 8.0
    S0[..., 1025:, :] = 0.0
    d = torch.sigmoid(torch.randn((B, H, 1), generator=g, device=dev) + 3.0)
    k, q = (torch.randn((B, H, dk), generator=g, device=dev) for _ in "kq")
    k *= torch.exp(torch.rand((B, H, 1), generator=g, device=dev) * 16 - 12)
    v = torch.randn((B, H, dv), generator=g, device=dev)
    v[..., 1024] = 1.0
    v[..., 1025:] = 0.0
    return S0, d, k, v, q


@pytest.mark.parametrize("mode", ["dense", "slab"])
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_state_update_kernel_bitwise_at_mlstm_heads(cuda, mode, rounding):
    """Kernel 1 at (2, 4, 1040, 1024), scalar decay: mantissa, exponent and
    micro bitwise the plain version (slab mode on a (3, 6, ...) pool at
    layer 4), y within the contract, the zero rows left zero."""
    S0, d, k, v, q = _mlstm_su_inputs(cuda, lead=(3, 6) if mode == "slab"
                                      else None)
    if mode == "dense":
        qS = F.mx8_quantize(S0)
        plain, yp = KS.plain(qS.clone(), d, k, v, q, rounding=rounding,
                             seed=0xFFFFFF00)
        kern, yk = KS.mx_state_update(qS, d, k, v, q, seed=0xFFFFFF00,
                                      rounding=rounding)
        got, want = kern.payload, plain.payload
    else:
        pool = F.mx8_quantize(S0)
        slabs = torch.tensor([2, 1], dtype=torch.int32, device=cuda)
        idx = (slabs.long(), 4)
        plain, yp = KS.plain_slab(pool.clone(), slabs, 4, d, k, v, q,
                                  rounding=rounding, seed=0xFFFFFF00)
        _, yk = KS.mx_state_update(pool, d, k, v, q, seed=0xFFFFFF00,
                                   rounding=rounding, slabs=slabs, group=4)
        got = {f: a[idx] for f, a in pool.payload.items()}
        want = {f: a[idx] for f, a in plain.payload.items()}
    torch.cuda.synchronize()
    for f in want:
        assert torch.equal(got[f], want[f]), f
    _assert_state_update_contract(want, yp, got, yk)
    assert not got["mantissa"][..., 1025:, :].any()


@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_mx_quant_kernel_bitwise_at_mlstm_prefill_state(cuda, rounding):
    from repro_torch.kernels import mx_quant as KQ
    S0, *_ = _mlstm_su_inputs(cuda, B=1)
    n0 = KQ.mx_quantize.launches
    got = KQ.mx_quantize(S0, 99, rounding=rounding)
    torch.cuda.synchronize()
    assert KQ.mx_quantize.launches == n0 + 1
    want = KQ.plain(S0, rounding, 99)
    for f in want.payload:
        assert torch.equal(got.payload[f], want.payload[f]), f


@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_xlstm_smoke_engine_launches_kernels_per_mlstm_layer(cuda, backend,
                                                             monkeypatch):
    """xlstm smoke through a slot or a paged engine: kernel 1 once per mLSTM
    layer a decode step (dense on slots, slab mode paged), kernel 7 once
    per mLSTM layer a prefill, no attention or append kernel, and no plain
    MX8 quantizer call on the card inside a step or a prefill."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_quant as KQ
    from repro_torch.models import model as M
    from repro_torch.serving.api import Engine, ServeConfig
    cfg = get_smoke_config("xlstm-1.3b")
    params = M.init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                          device=cuda)
    seen = {"inside": 0, "calls": 0}
    quantize = F.mx8_quantize

    def counted(x, *a, **kw):
        if seen["inside"] and x.is_cuda:
            seen["calls"] += 1
        return quantize(x, *a, **kw)

    def watched(fn):
        def inside(*a, **kw):
            seen["inside"] += 1
            try:
                return fn(*a, **kw)
            finally:
                seen["inside"] -= 1
        return inside

    monkeypatch.setattr(F, "mx8_quantize", counted)
    for name in ("decode_step", "paged_decode_step", "prefill"):
        monkeypatch.setattr(M, name, watched(getattr(M, name)))
    sc = (ServeConfig(backend="slots", batch=2, cache_capacity=256)
          if backend == "slots" else ServeConfig(batch=2, n_pages=4,
                                                 prefill_chunk=64))
    eng = Engine(params, cfg, sc)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 40, 2)]
    hs = [eng.submit(p, max_new_tokens=5) for p in prompts]
    others = (KA.mx_attention_decode, KP.mx_paged_attention_decode,
              KP.mx_paged_kv_append, KP.mx_paged_kv_append_quant,
              KQ.mx_kv_append_quant)
    for c in others + (KS.mx_state_update, KQ.mx_quantize):
        c.launches = 0
    KS.mx_state_update.slab_launches = 0
    eng.run()
    torch.cuda.synchronize()
    steps = eng.engine.step_count
    assert all(h.status == "done" and len(h.output) == 5 for h in hs)
    n_mlstm = cfg.pattern.count("mlstm") * cfg.n_groups
    dense, slab = ((n_mlstm * steps, 0) if backend == "slots"
                   else (0, n_mlstm * steps))
    assert (KS.mx_state_update.launches,
            KS.mx_state_update.slab_launches) == (dense, slab)
    assert KQ.mx_quantize.launches == n_mlstm * len(prompts)
    assert [c.launches for c in others] == [0] * len(others)
    assert seen["calls"] == 0


# ---------------------------------------------------------------------------
# the last five configs' widths: smollm-360m (G = 3 at 64), yi-34b (G = 7)
# and dbrx-132b (G = 6) at 128, paligemma-3b (G = 8 over one kv head at 256)
# ---------------------------------------------------------------------------

#: (H, KVH, d) of each model's attention
NEW_WIDTHS = [(15, 5, 64), (56, 8, 128), (48, 8, 128), (8, 1, 256)]


@pytest.mark.parametrize("H,KVH,d", NEW_WIDTHS)
@pytest.mark.parametrize("lens", [(4, 127, 128, 129), (1025, 1154, 640, 8)])
def test_new_widths_attention_kernels_vs_plain(cuda, H, KVH, d, lens):
    """Kernels 2 and 3 (decode) and 6 and 5 (verify, Kq = 1 and 4: Kq * G =
    12, 28, 24 and 32 rows a kv head) within rtol 2e-4, atol 2e-5 of their
    plain versions; paged bitwise dense over the gathered pages; verify row
    j bitwise kernels 2 and 3 at length len - (Kq - 1 - j)."""
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_spec_attention as KV
    from repro_torch.kernels import ref as R
    G = H // KVH
    q, K, V, bt, lengths = _spec_pools(cuda, lens, 4, G, d, seed=H + d,
                                       n_stack=3, KVH=KVH)
    group = 1
    Kd, Vd = R.gather_pages(K, bt, group), R.gather_pages(V, bt, group)
    q1 = q[:, 0].contiguous()
    y2 = KA.mx_attention_decode(q1, Kd, Vd, lengths)
    y3 = KP.mx_paged_attention_decode(q1, K, V, bt, group, lengths)
    torch.testing.assert_close(y2, KA.plain(q1, Kd, Vd, lengths), rtol=2e-4,
                               atol=2e-5)
    torch.testing.assert_close(y3, KP.plain(q1, K, V, bt, group, lengths),
                               rtol=2e-4, atol=2e-5)
    assert torch.equal(y3, y2)
    for Kq in (1, 4):
        qk = q[:, :Kq].contiguous()
        y5 = KV.mx_paged_spec_attention_decode(qk, K, V, bt, group, lengths)
        y6 = KV.mx_spec_attention_decode(qk, Kd, Vd, lengths)
        torch.testing.assert_close(y6, KV.plain(qk, Kd, Vd, lengths),
                                   rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(
            y5, KV.plain_paged(qk, K, V, bt, group, lengths), rtol=2e-4,
            atol=2e-5)
        assert torch.equal(y5, y6)
        for j in range(Kq):
            lj = lengths - (Kq - 1 - j)
            qj = qk[:, j].contiguous()
            assert torch.equal(y6[:, j],
                               KA.mx_attention_decode(qj, Kd, Vd, lj))
            assert torch.equal(y5[:, j], KP.mx_paged_attention_decode(
                qj, K, V, bt, group, lj))


def test_paligemma_block_fits_its_shared_memory(cuda):
    """A decode block at paligemma-3b's widths holds 8 rows x 256 = 2048
    accumulator items, and its verify pass of 32 rows runs as four such
    blocks: 229,376 B of dynamic shared memory, under the 231,424 B a
    block may opt into, one block an SM."""
    for R in (8, 32):
        assert KA.split_block_rows(R, 8, 256) == 8
        KA.split_checked(R, 8, 256, 256, "paligemma")
    assert KA.split_row_blocks(32, 8, 256) == 4
    assert KA.split_smem_bytes(8, 256, 256) == 229_376
    assert KA.split_smem_bytes(8, 256, 256) <= KA.SPLIT_MAX_SMEM
    assert KA.split_blocks_per_sm(8, 8, 256, 256) == 1


@pytest.mark.parametrize("KVH,d", [(5, 64), (8, 128), (1, 256)])
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_new_widths_fused_appends_bitwise(cuda, KVH, d, rounding):
    """The paged fused quantize-and-append (kernel 4) and the slot pool's
    dense one at the new K/V widths, magnitudes 1, 1e-3, 1e-37 and 1e35:
    every byte equal to its plain version's (and the paged one's to the
    eager quantize + copy it replaced), nothing outside the slots moved."""
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_quant as KQ
    for mag in APPEND_MAGS:
        pools, rows, bt, lengths = _append_quant_case(cuda, KVH, d, 2, mag)
        before = [p.clone() for p in pools]
        plain = [p.clone() for p in pools]
        eager = [p.clone() for p in pools]
        KP.mx_paged_kv_append_quant(rows, pools, bt, 7, lengths, 0xFFFFFFFF,
                                    rounding=rounding)
        KP.plain_append_quant(rows, plain, bt, 7, lengths, 0xFFFFFFFF,
                              rounding)
        _eager_append(eager, rows, bt, 7, lengths, 0xFFFFFFFF, rounding)
        torch.cuda.synchronize()
        keep = torch.ones(pools[0].payload["mantissa"].shape[:3],
                          dtype=torch.bool, device=cuda)
        for b, n_b in enumerate(lengths.tolist()):
            keep[bt[b, n_b // 128], 7, n_b % 128] = False
        for a, p, e, b0 in zip(pools, plain, eager, before):
            for f in ("mantissa", "exponent", "micro"):
                assert torch.equal(a.payload[f], p.payload[f]), (f, mag)
                assert torch.equal(a.payload[f], e.payload[f]), (f, mag)
                assert torch.equal(a.payload[f][keep],
                                   b0.payload[f][keep]), (f, mag)
        for n in (1, 4):
            caches, drows, dlens = _dense_append_case(cuda, KVH, d, 2, n,
                                                      mag=mag)
            dplain = [c.clone() for c in caches]
            KQ.mx_kv_append_quant(drows, caches, dlens, 0xFFFFFFFF,
                                  rounding=rounding)
            KQ.plain_append(drows, dplain, dlens, 0xFFFFFFFF, rounding)
            for c, p in zip(caches, dplain):
                for f in p.payload:
                    assert torch.equal(c.payload[f], p.payload[f]), (f, mag)


@pytest.mark.parametrize("shape", [(1, 400, 5, 64), (1, 400, 8, 128),
                                   (1, 400, 1, 256)])
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_new_widths_prefill_quantizer_bitwise(cuda, shape, rounding):
    """Kernel 7's two-stream launch at a prefill's K and V (smollm-360m,
    yi-34b / dbrx-132b, paligemma-3b: 256 patches + 144 tokens), padded to
    512 in the launch: bitwise its plain version."""
    from repro_torch.kernels import mx_quant as KQ
    g = torch.Generator(device=cuda).manual_seed(shape[-1] + shape[2])
    xs = [_spread(shape, g), _spread(shape, g)]
    got = KQ.mx_quantize_streams(xs, [5, 0xFFFFFFFF], rounding=rounding,
                                 pad_to=512)
    want = KQ.plain_streams(xs, [5, 0xFFFFFFFF], rounding, 512)
    for q, p in zip(got, want):
        for f in p.payload:
            assert torch.equal(q.payload[f], p.payload[f]), f


@pytest.mark.parametrize("arch", ["smollm-360m", "yi-34b", "dbrx-132b"])
@pytest.mark.parametrize("backend", ["slots", "paged"])
def test_new_configs_smoke_engines_launch_per_layer(cuda, arch, backend):
    """The three new served configs at smoke size on the card: the
    attention kernel of the pool once per layer a decode step, its fused
    append once per layer, kernel 7 once per layer a prefill; the greedy
    streams at round to nearest equal the plain ops' (``torch`` backend)."""
    from repro_torch import ops as OPS
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import mx_paged_attention as KP
    from repro_torch.kernels import mx_quant as KQ
    from repro_torch.models import model as M
    from repro_torch.serving.api import Engine, ServeConfig
    base = get_smoke_config(arch)
    params = M.init_model(base, torch.Generator(device=cuda).manual_seed(0),
                          device=cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, base.vocab_size, n) for n in (9, 40, 17)]
    sc = (ServeConfig(backend="slots", batch=2, cache_capacity=256)
          if backend == "slots" else ServeConfig(batch=2, n_pages=4,
                                                 prefill_chunk=64))
    decode, append = ((KA.mx_attention_decode, KQ.mx_kv_append_quant)
                      if backend == "slots" else
                      (KP.mx_paged_attention_decode,
                       KP.mx_paged_kv_append_quant))
    outs = []
    for be in ("cuda", "torch"):
        cfg = base.with_(state_quant=OPS.StateQuantConfig("mx8", "nearest",
                                                          be))
        eng = Engine(params, cfg, sc)
        hs = [eng.submit(p, max_new_tokens=5) for p in prompts]
        decode.launches = append.launches = KQ.mx_quantize.launches = 0
        eng.run()
        torch.cuda.synchronize()
        steps = eng.engine.step_count
        assert all(h.status == "done" and len(h.output) == 5 for h in hs)
        on = cfg.n_layers if be == "cuda" else 0
        assert (decode.launches, append.launches) == (on * steps,
                                                      on * steps)
        assert KQ.mx_quantize.launches == on * len(prompts)
        outs.append([h.output for h in hs])
    print(arch, backend, "kernels vs plain ops greedy streams equal:",
          outs[0] == outs[1])


def test_paligemma_smoke_prefix_decode_on_card(cuda):
    """paligemma smoke at model level on the card: patches + tokens
    through ``prefill`` (kernel 7 once per layer), then ``decode_step``s
    (kernel 2 and the dense append once per layer a step); the first
    step's logits within rtol 1e-3 of the plain ops' on the same prefill."""
    from repro_torch import ops as OPS
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import mx_quant as KQ
    from repro_torch.models import model as M
    base = get_smoke_config("paligemma-3b")
    params = M.init_model(base, torch.Generator(device=cuda).manual_seed(0),
                          device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"patches": torch.randn((2, base.prefix_len, base.frontend_dim),
                                    generator=g, device=cuda),
             "tokens": torch.randint(0, base.vocab_size, (2, 24),
                                     generator=g, device=cuda)}
    S = base.prefix_len + 24
    first = []
    for be in ("cuda", "torch"):
        cfg = base.with_(state_quant=OPS.StateQuantConfig("mx8", "nearest",
                                                          be))
        KQ.mx_quantize.launches = KA.mx_attention_decode.launches = 0
        KQ.mx_kv_append_quant.launches = 0
        logits, caches = M.prefill(params, cfg, batch)
        t = logits.argmax(-1)
        lens = torch.full((2,), S, dtype=torch.int32, device=cuda)
        steps = []
        for i in range(3):
            lg, caches = M.decode_step(params, cfg, t, caches, lens + i,
                                       seed=i + 1)
            steps.append(lg)
            t = lg.argmax(-1)
        torch.cuda.synchronize()
        on = cfg.n_layers if be == "cuda" else 0
        assert KQ.mx_quantize.launches == on
        assert KA.mx_attention_decode.launches == 3 * on
        assert KQ.mx_kv_append_quant.launches == 3 * on
        first.append(steps[0])
    a, b = first
    assert bool(torch.isfinite(a).all())
    assert bool(((a - b).abs() <= 1e-3 * (b.abs() + b.abs().max())).all())
