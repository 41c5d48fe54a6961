#!/usr/bin/env python3
"""Where a training step's time goes, on the card.

Usage, from the repository root, on a machine with one CUDA card:

    python3 tools/train_profile.py [--arch smollm-360m] [--seq-len 256]
                                   [--global-batch 8] [--steps 3]

Builds the model at full width and depth with the trainer's seeded
weights (fp32, TF32 off, no determinism settings), warms up with two
``make_train_step`` steps, then times ``--steps`` steps in three parts,
each ended by a synchronise: the loss (``train_loss``), the backward
(``torch.autograd.grad``) and AdamW (``adamw_update``).  One more step runs
under ``torch.profiler``: its device busy time, its device operations and
idle share, and the kernels by name, grouped (matrix products,
elementwise, reductions, indexing and copies, the rest).  Prints one JSON
object.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

GROUPS = (("matmul", ("gemm", "sgemm", "cutlass", "matmul", "ampere",
                      "sm90", "xmma", "gemv", "splitk")),
          ("reduce", ("reduce", "softmax", "norm", "logsumexp")),
          ("index", ("index", "scatter", "gather", "copy", "cat",
                     "embedding", "sort", "radix")),
          ("elementwise", ("elementwise", "vectorized", "unrolled",
                           "foreach", "fill")))


def group(name):
    low = name.lower()
    for g, keys in GROUPS:
        if any(k in low for k in keys):
            return g
    return "other"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    from repro_torch.core import tree as T
    from repro_torch.train.train_loop import batch_to_device, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    opt = O.OptimizerConfig()
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")
    opt_state = O.init_opt_state(params, opt)
    step_fn = make_train_step(cfg, opt)
    batch_fn = make_batch_fn(cfg, args.seq_len, args.global_batch)
    for i in range(2):
        params, opt_state, m = step_fn(params, opt_state, batch_fn(i))
        float(m["loss"])
    parts = {"loss": [], "backward": [], "adamw": []}
    for i in range(args.steps):
        batch = batch_to_device(batch_fn(2 + i), "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        leaves = [p.detach().requires_grad_(True) for p in T.leaves(params)]
        loss = M.train_loss(T.unflatten(params, leaves), cfg, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = T.unflatten(params, torch.autograd.grad(loss, leaves))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        params, opt_state, _ = O.adamw_update(params, grads, opt_state, opt)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        del leaves, loss, grads
        for k, a, b in (("loss", t0, t1), ("backward", t1, t2),
                        ("adamw", t2, t3)):
            parts[k].append((b - a) * 1e3)
    batch = batch_fn(9)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch)
        float(m["loss"])
        wall = time.perf_counter() - t0
    kernels = {}
    n_ops = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels.setdefault(e.name, [0.0, 0])
            kernels[e.name][0] += e.time_range.elapsed_us() / 1e3
            kernels[e.name][1] += 1
            n_ops += 1
    if not kernels:
        raise SystemExit("the profiler recorded no device events")
    busy = sum(v[0] for v in kernels.values())
    groups = {}
    for name, (ms, n) in kernels.items():
        g = groups.setdefault(group(name), [0.0, 0])
        g[0] += ms
        g[1] += n
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    med = lambda xs: sorted(xs)[len(xs) // 2]
    print(json.dumps(dict(
        arch=cfg.name, seq_len=args.seq_len, global_batch=args.global_batch,
        device=torch.cuda.get_device_name(0),
        parts_ms={k: med(v) for k, v in parts.items()},
        profiled_wall_ms=wall * 1e3, device_busy_ms=busy,
        idle_share=1 - busy / (wall * 1e3), device_ops=n_ops,
        groups_ms={g: round(v[0], 3) for g, v in groups.items()},
        groups_ops={g: v[1] for g, v in groups.items()},
        top_kernels=[(name[:90], round(ms, 3), n) for name, (ms, n) in top]),
        indent=1))


if __name__ == "__main__":
    sys.exit(main())
