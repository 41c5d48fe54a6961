#!/usr/bin/env python3
"""What the trainer's determinism costs on the card, and what it buys.

Usage, from the repository root, on a machine with one CUDA card:

    python3 tools/train_determinism.py [--arch smollm-360m] [--steps 8]
                                       [--seq-len 256] [--global-batch 8]

Runs the train step of ``repro_torch.launch.train`` (the same config,
seeded weights, optimizer and pipeline; no checkpoint) in four processes
of its own, in the turns deterministic, plain, plain, deterministic.  A
deterministic process sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before CUDA
initialises and ``torch.use_deterministic_algorithms(True)``, as the
launcher does on the card; a plain one sets neither.  Each prints its
median step time (steps after the first; a step ends when its loss is read
back), its peak device memory and a SHA-256 digest of its final
parameters.  The summary gives each mode's step times, the deterministic
mode's cost over plain, and whether each mode's two runs ended bitwise
equal, and all four.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODES = ("deterministic", "plain")


def child(args):
    if args.mode != "plain":
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import make_train_step
    torch.use_deterministic_algorithms(args.mode != "plain")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    opt = O.OptimizerConfig(total_steps=args.steps,
                            warmup_steps=max(args.steps // 20, 1))
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")
    opt_state = O.init_opt_state(params, opt)
    step_fn = make_train_step(cfg, opt)
    batch_fn = make_batch_fn(cfg, args.seq_len, args.global_batch)
    torch.cuda.reset_peak_memory_stats()
    seconds, losses = [], []
    for i in range(args.steps):
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch_fn(i))
        losses.append(float(m["loss"]))
        seconds.append(time.perf_counter() - t0)
    digest = hashlib.sha256()
    for leaf in T.leaves(params):
        digest.update(leaf.detach().cpu().numpy().tobytes())
    steady = sorted(seconds[1:])
    print(json.dumps(dict(
        mode=args.mode, step_ms=steady[len(steady) // 2] * 1e3,
        first_step_ms=seconds[0] * 1e3,
        peak_GB=torch.cuda.max_memory_allocated() / 1e9,
        params_sha256=digest.hexdigest(), losses=losses)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mode", choices=MODES, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mode:
        return child(args)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    env.pop("CUBLAS_WORKSPACE_CONFIG", None)
    runs = []
    for mode in MODES + MODES[::-1]:
        cmd = [sys.executable, __file__, "--mode", mode, "--arch", args.arch,
               "--steps", str(args.steps), "--seq-len", str(args.seq_len),
               "--global-batch", str(args.global_batch)]
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                              timeout=600, check=True)
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps({k: v for k, v in runs[-1].items()
                          if k != "losses"}), flush=True)
    by = {m: [r for r in runs if r["mode"] == m] for m in MODES}
    ms = {m: sorted(r["step_ms"] for r in rs) for m, rs in by.items()}
    print(json.dumps(dict(
        arch=args.arch, seq_len=args.seq_len, global_batch=args.global_batch,
        steps=args.steps, step_ms=ms,
        cost=sum(ms["deterministic"]) / sum(ms["plain"]) - 1,
        bitwise_within_mode={m: len({r["params_sha256"] for r in rs}) == 1
                             for m, rs in by.items()},
        all_runs_bitwise=len({r["params_sha256"] for r in runs}) == 1)))


if __name__ == "__main__":
    sys.exit(main())
