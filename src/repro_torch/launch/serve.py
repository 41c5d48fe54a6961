"""Serving launcher of the PyTorch port.

    python -m repro_torch.launch.serve --arch zamba2-2.7b --paged \\
        --requests 6 --slots 4 --max-new 24 --pages 33

serves from the paged pool on the card (the CUDA kernels build at first
use); without ``--paged`` it serves from the fixed slot pool
(``--cache-capacity``).  ``--device cpu`` runs the same paths on the CPU
with the kernels' plain versions, e.g. at smoke size:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --smoke-size --device cpu --paged --requests 4 --max-new 6
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-v2-236b --smoke-size --device cpu --paged --pages 6
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gla-2.7b \\
        --smoke-size --device cpu --paged     # or retnet-2.7b, hgrn2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \\
        --smoke-size --device cpu --paged     # mLSTM + sLSTM

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --smoke-size --device cpu --paged     # or yi-34b, dbrx-132b

``--mixed`` alternates short prompts with multi-page long ones;
``--stream`` drives the engine open-loop (``step()``) and prints each
request's tokens as they are sampled; ``--turns N`` runs an N-turn chat
session on copy-on-write prefix sharing after the batch (paged only);
``--trace OUT`` writes the structured trace at exit (Chrome-trace JSON, or
JSONL for ``*.jsonl``), which ``python -m repro_torch.obs.schema OUT
--require steps,spans,bank,recompile`` checks:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --smoke-size --device cpu --paged --mixed --stream --turns 2 \
        --trace /tmp/serve.json

``--arch`` takes any of the fifteen architectures
(``repro_torch.configs.ALL_ARCHS``); an encoder (hubert-xlarge) exits with
nothing to serve, and a model with a modality frontend (paligemma-3b)
exits too: the engines prefill token prompts only, so it runs at model
level (``models.model.prefill`` with its patches, then ``decode_step``).
Weights are random, from ``--seed``, unless ``--ckpt-dir`` names a
checkpoint directory of the trainer (``repro_torch.launch.train``): then
the newest valid checkpoint's parameters are served (its optimizer state is
not read):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke-size --device cpu --paged --ckpt-dir /tmp/ck
"""
import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke-size", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU with the kernels' plain "
                         "versions; default: the CUDA card (an error if "
                         "there is none)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-capacity", type=int, default=256)
    ap.add_argument("--state-format", default="mx8",
                    choices=["mx8", "int8", "fp16", "fp32"])
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "cuda", "torch"],
                    help="SPU op backend; 'auto' asks the op registry for "
                         "the preferred backend capable of --state-format; "
                         "a concrete choice errors if a compute op the "
                         "model runs lacks that registration")
    # paged pool + scheduler
    ap.add_argument("--paged", action="store_true",
                    help="serve from the paged, bank-aware state/KV pool")
    ap.add_argument("--pages", type=int, default=33,
                    help="pool size in 128-token pages (incl. 1 scratch)")
    ap.add_argument("--slabs", type=int, default=None,
                    help="state slabs (default: 2*slots + 1)")
    ap.add_argument("--prefill-chunk", type=int, default=128,
                    help="longest full-sequence prefill; longer prompts "
                         "stream their tail through the decode batch")
    ap.add_argument("--policy", default="fcfs",
                    choices=["fcfs", "priority", "deadline"])
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the parameters of the newest valid "
                         "checkpoint there (``repro_torch.launch.train`` "
                         "writes them) instead of random weights")
    ap.add_argument("--mixed", action="store_true",
                    help="mixed workload: short and long prompts")
    # request-lifecycle demos
    ap.add_argument("--stream", action="store_true",
                    help="drive the engine open-loop (step()) and print "
                         "each request's tokens as they are sampled")
    ap.add_argument("--turns", type=int, default=0,
                    help="after the batch: run a --turns-turn chat session "
                         "on copy-on-write prefix sharing (paged only)")
    # observability
    ap.add_argument("--trace", default=None, metavar="OUT",
                    help="write the structured trace at exit: Chrome-trace "
                         "JSON (open in https://ui.perfetto.dev), or JSONL "
                         "if OUT ends in .jsonl")
    ap.add_argument("--metrics", default=None, metavar="OUT",
                    help="dump the metrics registry in Prometheus text "
                         "format at exit ('-' for stdout)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from repro_torch import ops as OPS
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.serving.api import Engine, ServeConfig
    from repro_torch.serving.engine import refuse_unservable
    from repro_torch.serving.sampler import SamplingConfig
    from repro_torch.serving.scheduler import SchedulerConfig

    cfg = (get_smoke_config(args.arch) if args.smoke_size
           else get_config(args.arch))
    if cfg.encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: nothing to serve")
    if args.turns and not args.paged:
        raise SystemExit("--turns needs --paged (sessions are built on "
                         "copy-on-write prefix sharing in the paged pool)")
    try:
        refuse_unservable(cfg)
    except ValueError as e:
        raise SystemExit(str(e))
    device = M.resolve_device(args.device)
    requested = None if args.backend == "auto" else args.backend
    # the capability check runs against the layout actually dispatched
    layout = "paged" if args.paged else "dense"
    compute_kinds = sorted({e.kind for e in OPS.decode_op_plans(cfg, 1, 128)}
                           - {"kv_append"})
    try:
        resolved = [OPS.resolve_backend(kind, args.state_format, requested,
                                        layout=layout,
                                        strict=requested is not None)
                    for kind in compute_kinds]
    except ValueError as e:
        raise SystemExit(f"--backend {args.backend}: {e}")
    backend = resolved[0]
    cfg = cfg.with_(state_quant=OPS.StateQuantConfig(
        fmt=args.state_format, rounding="stochastic", backend=backend))

    if args.ckpt_dir:
        from repro_torch.checkpoint.manager import CheckpointManager
        like = M.init_model(cfg, torch.Generator().manual_seed(0),
                            device="meta")
        restored, step = CheckpointManager(args.ckpt_dir).restore(
            {"params": like, "opt_state": None}, device=device)
        params = restored["params"]
        print(f"loaded checkpoint step {step}")
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = M.init_model(cfg, gen, device=device)
    sampling = SamplingConfig(temperature=args.temperature,
                              top_k=40 if args.temperature > 0 else 0,
                              top_p=args.top_p)
    pool = "paged" if args.paged else "slots"
    eng = Engine(params, cfg, ServeConfig(
        backend=pool, batch=args.slots, cache_capacity=args.cache_capacity,
        n_pages=args.pages, n_slabs=args.slabs,
        prefill_chunk=args.prefill_chunk, sampling=sampling,
        scheduler=SchedulerConfig(policy=args.policy), seed=args.seed))

    rng = np.random.default_rng(args.seed)
    handles = []
    for i in range(args.requests):
        if args.mixed:
            # alternate short prompts with multi-page long ones
            n = 8 + i % 24 if i % 3 else 130 + 16 * (i % 4)
        else:
            n = 8 + i % 24
        handles.append(eng.submit(
            rng.integers(0, cfg.vocab_size, n),
            max_new_tokens=args.max_new,
            priority=i % 3 if args.policy == "priority" else 0,
            deadline=(time.time() + 1 + i % 5
                      if args.policy == "deadline" else None)))
    t0 = time.perf_counter()
    if args.stream:
        # open loop: one step at a time, tokens printed as they surface
        running = True
        while running:
            running = eng.step()
            for h in handles:
                got = h.new_tokens()
                if got:
                    print(f"  req {h.rid} [{h.status}] += {got}")
        done = [h.request for h in handles]
    else:
        done = eng.run()
    stats = eng.stats()
    print(f"{len(done)} requests, {stats['tokens']:.0f} tokens, "
          f"{stats['tokens_per_s']:.1f} tok/s (wall "
          f"{time.perf_counter() - t0:.1f}s, state={args.state_format}, "
          f"backend={backend}, pool={pool}, device={device})")
    print(f"  steps: p50={stats['p50_step_s'] * 1e3:.1f}ms "
          f"p99={stats['p99_step_s'] * 1e3:.1f}ms "
          f"p99_nocompile={stats['p99_step_nocompile_s'] * 1e3:.1f}ms "
          f"({int(stats['compile_steps'])} steps paid a kernel build, "
          f"{int(stats['recompiles'])} step signatures)")
    traffic = {k.split("/", 1)[1]: v for k, v in stats.items()
               if k.startswith("op_traffic_bytes/")}
    if traffic:
        total = sum(traffic.values())
        parts = " ".join(f"{k}={v / 1e6:.1f}MB" for k, v in traffic.items())
        print(f"  spu op traffic: {parts} (total {total / 1e6:.1f}MB)")
    print("  " + " ".join(f"{k}={stats[k] * 1e3:.1f}ms" for k in (
        "mean_ttft_s", "p50_ttft_s", "p99_ttft_s", "p50_tok_latency_s",
        "p99_tok_latency_s")))
    if args.paged:
        rep = eng.engine.bank_report()
        print(f"  occupancy={stats['occupancy']:.2f} "
              f"fragmentation={stats['fragmentation']:.2f} "
              f"preemptions={int(stats['preemptions'])} "
              f"gather_bytes={stats['gather_bytes'] / 1e6:.1f}MB")
        print(f"  pimsim page-map: step={rep['t_real_s'] * 1e6:.2f}us "
              f"ideal={rep['t_ideal_s'] * 1e6:.2f}us "
              f"conflict_factor={rep['conflict_factor']:.2f} "
              f"bank_imbalance={rep['imbalance']:.2f}")
    if args.turns:
        print(f"-- {args.turns}-turn session (copy-on-write prefix "
              "sharing; turn N skips re-prefilling the history) --")
        chat = eng.session()
        before = eng.stats()["prefill_tokens"]
        for t in range(args.turns):
            turn = rng.integers(0, cfg.vocab_size, 8 + t)
            h = chat.send(turn, max_new_tokens=args.max_new)
            print(f"  turn {t}: sent {len(turn)} tokens -> {list(h)}")
        after = eng.stats()["prefill_tokens"]
        chat.close()
        print(f"  session ingested {after - before:.0f} fresh tokens "
              f"({eng.stats()['shared_page_hits']:.0f} shared-page hits; "
              "an unshared engine would re-prefill the whole history "
              "every turn)")
    if args.trace:
        eng.save_trace(args.trace)
        counts = eng.obs.recompiles.counts()
        print(f"trace: {len(eng.obs.tracer.events())} events -> "
              f"{args.trace} (step signatures: "
              + (" ".join(f"{k}={v}" for k, v in sorted(counts.items()))
                 or "none") + ")")
    if args.metrics:
        text = eng.prometheus_text()
        if args.metrics == "-":
            sys.stdout.write(text)
        else:
            with open(args.metrics, "w") as f:
                f.write(text)
            print(f"metrics: {args.metrics}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
