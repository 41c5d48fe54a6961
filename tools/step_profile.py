#!/usr/bin/env python3
"""Where a decode step's device time goes, by kernel name, on the card.

Usage, from the repository root, on a machine with one CUDA card:

    python3 tools/step_profile.py [--src SRC] [--arch opt-6.7b,yi-9b]
                                  [--paths slots,paged] [--steps 5]

For each model (full width and depth, random weights from a seeded CUDA
generator, the config's MX8 state and KV) and each path (the slot pool:
``ServeConfig(backend="slots", batch=4, cache_capacity=1024)``; the paged
pool: ``ServeConfig(batch=4, n_pages=17, prefill_chunk=512)``) it admits
four requests of 64, 97, 133 and 120 tokens, steps once (the prefills and
a first decode step), then records ``--steps`` steady decode steps with
``torch.profiler``, as ``chip_smoke.py``'s decode profiles do.  It prints,
per path, the device busy time and device operations a step with the
kernels by name, and then, where both paths ran, the slot path's time and
operations a step over the paged path's, by kernel name and in groups
(matrix products, the port's MX8 kernels, indexing and scatters,
reductions, the rest).  The decode op ``kv_append`` runs inside a
``record_function`` range; the kernels that run inside the range's span on
the device timeline (one stream) are its own, and their time and count a
step are printed beside.

``--src`` points at another checkout's ``src`` directory (for example one
unpacked with ``git archive``) to profile that checkout's package instead
of this one's; the script uses only the package's public entry points.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = (64, 97, 133, 120)
PATHS = {"slots": dict(backend="slots", batch=4, cache_capacity=1024),
         "paged": dict(batch=4, n_pages=17, prefill_chunk=512)}


def _group(name: str) -> str:
    n = name.lower()
    if any(k in n for k in ("gemm", "gemv", "cutlass", "magma", "cublas")):
        return "matrix products"
    if "::mx_" in n or n.startswith("mx_"):
        return "the port's MX8 kernels"
    if any(k in n for k in ("index", "scatter", "gather", "put_")):
        return "indexing and scatters"
    if "reduce" in n:
        return "reductions"
    return "the rest (elementwise, copies, fills)"


def _watch_kv_append():
    """Run every decode ``kv_append`` inside a ``record_function`` range."""
    from torch.profiler import record_function
    from repro_torch.ops import attention as A
    real = A.kv_append

    def ranged(*args, **kwargs):
        with record_function("kv_append"):
            return real(*args, **kwargs)
    A.kv_append = ranged


def profile_path(params, cfg, path: str, n_steps: int, seed: int):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.api import Engine, ServeConfig
    eng = Engine(params, cfg, ServeConfig(**PATHS[path]))
    rng = np.random.default_rng(seed)
    for n in PROMPTS:
        eng.submit(rng.integers(0, cfg.vocab_size, n),
                   max_new_tokens=n_steps + 2)
    eng.step()                           # admissions (prefill) + first step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, spans, kernels = {}, [], []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        r = evt.time_range
        if evt.name == "kv_append":       # the range, on the device timeline
            spans.append((r.start, r.end))
            continue
        kernels.append((r.start, r.end))
        us, n = by_name.get(evt.name, (0.0, 0))
        by_name[evt.name] = (us + r.elapsed_us(), n + 1)
    # the kernels a kv_append range launched: one stream, so those that run
    # inside the range's device span
    inside = [(s, e) for s, e in kernels
              if any(a <= s and e <= b for a, b in spans)]
    append_us = sum(e - s for s, e in inside)
    eng.run()
    del eng
    busy = sum(us for us, _ in by_name.values())
    ops = sum(n for _, n in by_name.values())
    return dict(busy_ms=busy / n_steps / 1e3, ops=ops / n_steps,
                wall_ms=wall / n_steps * 1e3,
                append_ms=append_us / n_steps / 1e3,
                append_ops=len(inside) / n_steps,
                by_name={k: (us / n_steps / 1e3, n / n_steps)
                         for k, (us, n) in by_name.items()})


def main() -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory of the checkout to profile")
    ap.add_argument("--arch", default="opt-6.7b,yi-9b")
    ap.add_argument("--paths", default="slots,paged")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("step_profile: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; package: {Path(args.src).resolve()}", flush=True)
    _watch_kv_append()
    for arch in args.arch.split(","):
        cfg = get_config(arch)
        params = M.init_model(cfg, torch.Generator(device="cuda")
                              .manual_seed(0), device="cuda")
        res = {}
        for path in args.paths.split(","):
            r = profile_path(params, cfg, path, args.steps, seed=1)
            res[path] = r
            top = sorted(r["by_name"].items(), key=lambda kv: -kv[1][0])
            print(f"{arch} {path}: device_busy_ms_per_step="
                  f"{r['busy_ms']:.3f} device_ops_per_step={r['ops']:.0f} "
                  f"step_wall_ms={r['wall_ms']:.3f} "
                  f"kv_append_device_ms_per_step={r['append_ms']:.3f} "
                  f"kv_append_ops_per_step={r['append_ops']:.0f}",
                  flush=True)
            for name, (ms, n) in top[:12]:
                print(f"  {ms:9.4f} ms {n:7.1f} ops  {name[:90]}")
        if {"slots", "paged"} <= set(res):
            s, p = res["slots"]["by_name"], res["paged"]["by_name"]
            diff = {k: (s.get(k, (0, 0))[0] - p.get(k, (0, 0))[0],
                        s.get(k, (0, 0))[1] - p.get(k, (0, 0))[1])
                    for k in set(s) | set(p)}
            groups = {}
            for k, (ms, n) in diff.items():
                g = groups.setdefault(_group(k), [0.0, 0.0])
                g[0] += ms
                g[1] += n
            d = {k: res["slots"][k] - res["paged"][k]
                 for k in ("busy_ms", "ops", "append_ms", "append_ops")}
            print(f"{arch} slots over paged, a step: device_ms="
                  f"{d['busy_ms']:.3f} ops={d['ops']:.0f} of which "
                  f"kv_append device_ms={d['append_ms']:.3f} "
                  f"ops={d['append_ops']:.0f}")
            print("  by group: " + json.dumps(
                {g: [round(v[0], 4), round(v[1], 1)]
                 for g, v in sorted(groups.items(), key=lambda kv: -kv[1][0])
                 }))
            for name, (ms, n) in sorted(diff.items(),
                                        key=lambda kv: -abs(kv[1][0]))[:15]:
                print(f"  {ms:+9.4f} ms {n:+7.1f} ops  {name[:90]}")
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
