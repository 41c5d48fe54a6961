"""Training launcher of the PyTorch port.

    python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 50 --seq-len 256 --global-batch 8 --ckpt-dir /tmp/ckpt

trains on the card; ``--device cpu`` runs the same code on the CPU, e.g.
at smoke size:

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --smoke-size --device cpu --steps 4 --seq-len 32 --global-batch 2 \\
        --ckpt-dir /tmp/ck

Fault tolerance: atomic checkpoints every ``--ckpt-every`` steps (the
parameters and both AdamW moments: 12 bytes a parameter at fp32),
auto-resume from the newest valid checkpoint, step-indexed data order
(restart-stable), a straggler watchdog in the loop.  Weights start from
``torch.Generator().manual_seed(0)`` on the device.

On the card the trainer is deterministic, so a resumed run is bitwise an
uninterrupted one: before CUDA initialises it sets
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and ``torch.use_deterministic_
algorithms(True)``, which gives the backward's scatters (the embedding
gather's, the MoE dispatch's) their deterministic kernels.  Each
checkpoint's seconds print as it is written.  At the end it
prints every step's loss, a SHA-256 digest of the final parameters (two
runs that end bitwise equal print the same one) and, last, the loss, the
median step time (steps after the first), tokens a second and the peak
device memory.
"""
import argparse
import hashlib
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke-size", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; default: the CUDA card "
                         "(an error if there is none)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args(argv)

    on_card = args.device is None or not args.device.startswith(("cpu",
                                                                 "meta"))
    if on_card:
        # read when cuBLAS makes its first handle, so set before any CUDA
        # work of this process
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import tree as T
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import (LoopConfig, make_train_step,
                                              train_loop)

    device = M.resolve_device(args.device)
    if device.type == "cuda":
        torch.use_deterministic_algorithms(True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = (get_smoke_config(args.arch) if args.smoke_size
           else get_config(args.arch))
    opt = O.OptimizerConfig(lr=args.lr, total_steps=args.steps,
                            warmup_steps=max(args.steps // 20, 1))

    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_model(cfg, gen, device=device)
    opt_state = O.init_opt_state(params, opt)
    n = sum(p.numel() for p in T.leaves(params))
    print(f"arch={cfg.name} params={n/1e6:.1f}M device={device}")

    step_fn = make_train_step(cfg, opt, grad_accum=args.grad_accum)
    seconds = []

    def timed_step(params, opt_state, batch):
        t0 = time.perf_counter()
        out = step_fn(params, opt_state, batch)
        float(out[2]["loss"])
        seconds.append(time.perf_counter() - t0)
        return out

    # the loop holds the only references to the trees it is handed, so
    # each step's old weights and moments go as the new ones arrive
    state = {"params": params, "opt_state": opt_state}
    del params, opt_state
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        state, start = mgr.restore(state)
        print(f"auto-resumed from step {start}")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    batch_fn = make_batch_fn(cfg, args.seq_len, args.global_batch)
    params, opt_state, hist = train_loop(
        timed_step, state.pop("params"), state.pop("opt_state"), batch_fn,
        LoopConfig(total_steps=args.steps, log_every=10,
                   checkpoint_every=args.ckpt_every),
        checkpoint_mgr=mgr, start_step=start)
    if not hist:
        print(f"done: nothing to train (step {start} of {args.steps})")
        return 0
    steady = sorted(seconds[1:] or seconds)
    step_s = steady[len(steady) // 2]
    peak = (f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f}"
            if device.type == "cuda" else "n/a")
    digest = hashlib.sha256()
    for leaf in T.leaves(params):
        digest.update(leaf.detach().cpu().numpy().tobytes())
    print("losses " + " ".join(repr(v) for v in hist))
    print(f"params_sha256 {digest.hexdigest()}")
    print(f"done: loss {hist[0]:.3f} -> {hist[-1]:.3f}; "
          f"step_ms {step_s * 1e3:.1f}; "
          f"tokens_per_s {args.global_batch * args.seq_len / step_s:.0f}; "
          f"peak_GB {peak}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
