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

On a mesh (``--mesh DxM``: D-way data parallelism with ZeRO-sharded
parameters and moments; M-way tensor parallelism, each rank computing
its heads and FFN columns with the residual stream's positions split at
the layer boundaries, and expert parallelism for MoE layers --
``dist/sharding.py``, ``dist/tp.py``) every rank runs this program and
rank 0 prints.  ``--host-devices N`` rehearses it on the CPU:
it spawns N ranks over gloo (the JAX package's fake host devices; D * M
must equal N):

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --smoke-size --device cpu --mesh 2x2 --host-devices 4 --steps 2 \
        --seq-len 32 --global-batch 4

Without it the ranks come from ``torchrun`` (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), one a card over NCCL,
or over gloo with ``--device cpu``.  Auto-resume restores into the mesh's
layouts, whatever mesh wrote the checkpoint.
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
    ap.add_argument("--mesh", default=None,
                    help="'data x model', e.g. 2x4 (needs that many ranks)")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="spawn this many CPU ranks over gloo to rehearse "
                         "--mesh (D * M must equal it)")
    args = ap.parse_args(argv)
    if args.host_devices and not args.mesh:
        ap.error("--host-devices rehearses a --mesh: give both")
    if args.mesh:
        shape = tuple(int(v) for v in args.mesh.split("x"))
        if len(shape) != 2 or min(shape) < 1:
            ap.error(f"--mesh {args.mesh!r}: want DxM, e.g. 2x4")
        if args.host_devices:
            if shape[0] * shape[1] != args.host_devices:
                ap.error(f"--mesh {args.mesh} needs {shape[0] * shape[1]} "
                         f"ranks, --host-devices gives {args.host_devices}")
            if args.device not in (None, "cpu"):
                ap.error("--host-devices ranks run on the CPU")
            args.device = "cpu"
            return _spawn(args)
        env = os.environ
        return _train(args, shape, int(env["RANK"]), int(env["WORLD_SIZE"]),
                      int(env.get("LOCAL_RANK", 0)), "env://")
    return _train(args)


def _spawn(args) -> int:
    """``--host-devices N``: N ranks of this program in spawned processes
    (gloo over localhost); the exit code is 0 only if every rank's is.  A
    rank that fails ends the others, which would wait for it in their
    next collective."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    n = args.host_devices
    from repro_torch.launch.mesh import local_init_method
    init = local_init_method()
    shape = tuple(int(v) for v in args.mesh.split("x"))
    procs = [ctx.Process(target=_rank_main, args=(args, shape, r, n, init))
             for r in range(n)]
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        print(f"ranks failed (rank, exit code): {bad}", file=sys.stderr)
        return 1
    return 0


def _rank_main(args, shape, rank, world, init):
    import torch
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    sys.exit(_train(args, shape, rank, world, rank, init))


def _train(args, shape=None, rank=0, world=1, local_rank=0,
           init_method=None) -> int:
    """Train on one device (``shape`` None) or as ``rank`` of a ``shape``
    mesh of ``world`` ranks; rank 0 prints."""
    on_card = args.device is None or not args.device.startswith(("cpu",
                                                                 "meta"))
    if on_card:
        # read when cuBLAS makes its first handle, so set before any CUDA
        # work of this process
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch
    say = print if rank == 0 else (lambda *a, **k: None)
    if shape is None:
        return _run(args, None, say)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_parallel
    if on_card:
        torch.cuda.set_device(local_rank)
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=init_method, world_size=world,
                            rank=rank)
    try:
        return _run(args, make_local_parallel(
            *shape, device_type="cuda" if on_card else "cpu"), say)
    finally:
        dist.destroy_process_group()


def _run(args, par, say) -> int:
    """The training run itself: on one device, or as a rank of ``par``'s
    mesh (the process group is up)."""
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
    say(f"arch={cfg.name} params={n/1e6:.1f}M device={device} "
        f"mesh={args.mesh or 'single'}")

    shardings = None
    if par is not None:
        from repro_torch.dist import sharding as SH
        p_shard = SH.param_shardings(params, cfg, par)
        shardings = {"params": p_shard,
                     "opt_state": SH.opt_state_shardings(opt_state, p_shard,
                                                         par)}
        params = SH.distribute(params, shardings["params"])
        opt_state = SH.distribute(opt_state, shardings["opt_state"])
    step_fn = make_train_step(cfg, opt, par=par, grad_accum=args.grad_accum)
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
        state, start = mgr.restore(state, shardings=shardings)
        say(f"auto-resumed from step {start}")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    batch_fn = make_batch_fn(cfg, args.seq_len, args.global_batch)
    params, opt_state, hist = train_loop(
        timed_step, state.pop("params"), state.pop("opt_state"), batch_fn,
        LoopConfig(total_steps=args.steps, log_every=10,
                   checkpoint_every=args.ckpt_every),
        checkpoint_mgr=mgr, start_step=start, log=say)
    if not hist:
        say(f"done: nothing to train (step {start} of {args.steps})")
        return 0
    steady = sorted(seconds[1:] or seconds)
    step_s = steady[len(steady) // 2]
    peak = (f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f}"
            if device.type == "cuda" else "n/a")
    digest = hashlib.sha256()
    for leaf in T.leaves(params):
        if par is not None:
            leaf = leaf.full_tensor()           # a collective: every rank
        digest.update(leaf.detach().cpu().numpy().tobytes())
    say("losses " + " ".join(repr(v) for v in hist))
    say(f"params_sha256 {digest.hexdigest()}")
    say(f"done: loss {hist[0]:.3f} -> {hist[-1]:.3f}; "
          f"step_ms {step_s * 1e3:.1f}; "
          f"tokens_per_s {args.global_batch * args.seq_len / step_s:.0f}; "
          f"peak_GB {peak}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
