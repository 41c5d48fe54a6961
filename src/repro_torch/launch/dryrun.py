"""Dry run of the port: trace every (arch x shape x mesh) cell's step on a
fake 256- or 512-rank mesh, without allocating a tensor (the port's answer
to ``repro/launch/dryrun.py``, which lowers and compiles each cell).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k [--multi-pod] [--out dryrun_torch.json]

Per cell the dry run:
  1. creates a ``fake`` process group of 256 or 512 ranks (every collective
     returns at once; this process traces rank 0) and builds the production
     mesh ((16, 16) or (2, 16, 16)),
  2. lays out parameters, AdamW moments, the batch and the decode caches
     with the builders of ``dist/sharding.py`` as fake tensors
     (``FakeTensorMode``: shapes and dtypes, no storage), the config in
     ``bfloat16`` with ``DRYRUN_QUANT`` (mx8, stochastic rounding, the
     ``torch`` backend) and remat, as the JAX dry run's,
  3. runs the cell's step -- train (``CELL_TUNING``'s ``grad_accum``),
     prefill or decode, each through the port's sharded entry points --
     under :class:`CommBytesMode` and ``FlopCounterMode``,
  4. records the JAX record's keys where the port has a counterpart:
     ``flops_per_chip`` is the traced local step's count (matmuls and
     attention): every cell runs the tensor-parallel step, so it is the
     count of the rank's rows of its heads and FFN columns (its model
     shard's experts; the layers tp does not split whole), the train
     cells' forward, remat recomputation and backward included;
     ``link_bytes_per_chip`` the bytes the traced collectives move through
     a rank's links at the ring algorithm's count (:class:`CommBytesMode`:
     a train step gathers its parameters' ZeRO shards over the data axes,
     moves them into its tensor-parallel cut over the model axis, sums,
     gathers and scatters its activations over the model axis at every
     split layer, and reduce-scatters its gradients over the data axes;
     a serving step, its parameters at rest in
     ``dist/sharding.py::serving_param_shardings``, gathers none and
     makes only its all-reduces over the model axis),
     ``hbm_bytes_per_chip`` and ``cache_bytes_total`` come
     from ``analysis/roofline.py::analytic_cost`` as in the JAX package
     (its model of a GSPMD step: the port's eager step also reads every
     gathered parameter), whose link bytes stay beside under
     ``analytic``; ``sources`` says where each number came from,
     ``roofline`` and ``model_flops`` are computed as there, ``memory``
     is the argument and output bytes of the rank's shards (``temp_bytes``
     null: there is no compiler to report it), and ``trace_diag`` (the JAX
     ``hlo_diag``'s place) the collectives the step made, by kind, with
     their bytes.  Decode caches sit in the port's serving layout
     (``dist/sharding.py::serving_cache_shardings``: rows over the data
     axes, the tensor-parallel layers' heads over the model axis), so a
     decode step gathers no cache.

Attention-free models have FLOPs linear in the sequence (chunked linear
attention; the sLSTM's per-token loop, which the JAX dry run corrects
analytically): their train and prefill cells trace at ``PROBE_SEQ``
positions and scale by ``S / PROBE_SEQ``, exact for a linear count.  Their
link bytes are ``a + b * S`` (the parameter moves and gradient reductions
do not depend on ``S``; the tensor-parallel sums, gathers and scatters of
activations grow with it), so these cells trace a second time at
``PROBE_SEQ / 2`` positions and take each kind's bytes at ``S`` on the
line through both traces.
Attention traces with 4096-position chunks, as the JAX probe does (every
chunk pair is computed either way, so the count does not change).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import ops as OPS
from repro_torch.analysis import roofline as RL
from repro_torch.configs import (ALL_ARCHS, ASSIGNED_ARCHS, PAPER_ARCHS,
                                 cell_supported, get_config,
                                 get_smoke_config)
from repro_torch.core import tree as T
from repro_torch.dist import sharding as SH
from repro_torch.dist.compat import (CommDebugMode, fake_store,
                                     resolve_process_group)
from repro_torch.launch import specs as SP
from repro_torch.models.config import SHAPES
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import make_train_step

DRYRUN_QUANT = OPS.StateQuantConfig(fmt="mx8", rounding="stochastic",
                                    backend="torch")

#: positions an attention-free model's train / prefill cell traces at
PROBE_SEQ = 1024


def dryrun_config(arch: str, smoke: bool = False, **overrides):
    # fail fast if the forced (op, format, backend) triple ever unregisters
    for kind in OPS.OP_KINDS:
        OPS.resolve_backend(kind, DRYRUN_QUANT.fmt, DRYRUN_QUANT.backend,
                            strict=True)
    cfg = (get_smoke_config(arch) if smoke else get_config(arch)).with_(
        param_dtype="bfloat16",
        state_quant=DRYRUN_QUANT,
        scan_layers=True,
        remat=True,
    )
    return cfg.with_(**overrides) if overrides else cfg


# production tuning per cell, the JAX dry run's: microbatches bound the
# activations of the largest per-group working sets
CELL_TUNING = {
    ("zamba2-2.7b", "train_4k"): {"grad_accum": 2},
    ("deepseek-v2-236b", "train_4k"): {"grad_accum": 8},
    ("xlstm-1.3b", "train_4k"): {"grad_accum": 8},
}


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A ``fake`` process group of ``n_ranks`` for the duration: this
    process is rank 0 and every collective returns at once."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("the dry run needs this process free of a "
                           "process group")
    dist.init_process_group("fake", store=fake_store(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_mode():
    """Tensors with shapes and dtypes and no storage; a shape
    environment lets the MoE dispatch's boolean masks through (their sizes
    are symbols)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv
    return FakeTensorMode(shape_env=ShapeEnv())


def _fake(tree: Any) -> Any:
    """Each meta leaf of ``tree`` as a CPU tensor of its shape and dtype
    (a fake one, under :func:`fake_mode`)."""
    return T.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), tree)


def _nbytes(tree: Any) -> int:
    """Bytes of the local shards of ``tree``'s tensors."""
    total = 0
    for x in T.leaves(tree):
        if isinstance(x, SH.DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


def _attention_free(cfg) -> bool:
    return not (any(k in ("attn", "mla") for k in cfg.pattern + cfg.prelude)
                or cfg.shared_attn)


def trace_setup(cfg, sc) -> Tuple[Any, Any, float]:
    """(the config and shape a cell traces at, the factor its FLOPs scale
    by): 4096-position attention chunks, and an attention-free model's
    train / prefill sequence cut to ``PROBE_SEQ``."""
    cfg = cfg.with_(attn_q_chunk=max(cfg.attn_q_chunk, 4096),
                    attn_kv_chunk=max(cfg.attn_kv_chunk, 4096))
    if _attention_free(cfg) and sc.kind in ("train", "prefill") \
            and sc.seq_len > PROBE_SEQ:
        return (cfg, dataclasses.replace(sc, seq_len=PROBE_SEQ),
                sc.seq_len / PROBE_SEQ)
    return cfg, sc, 1.0


def run_step(cfg, sc, par, p_meta, grad_accum: int = 1):
    """Lay out the cell's inputs as fake tensors and run its step (call
    under :func:`fake_mode` with the process group up).  Returns
    (argument bytes, output bytes) of the rank's shards."""
    layouts = (SH.param_shardings if sc.kind == "train"
               else SH.serving_param_shardings)
    p_shard = layouts(p_meta, cfg, par)
    params = SH.distribute(_fake(p_meta), p_shard)
    if sc.kind == "train":
        opt = O.OptimizerConfig()
        o_meta = O.init_opt_state(p_meta, opt)
        opt_state = SH.distribute(_fake(o_meta), SH.opt_state_shardings(
            o_meta, p_shard, par))
        b_meta = SP.batch_struct(cfg, sc)
        batch = SH.distribute(_fake(b_meta), SH.batch_shardings(b_meta, par))
        args = _nbytes((params, opt_state, batch))
        out = make_train_step(cfg, opt, par=par, grad_accum=grad_accum)(
            params, opt_state, batch)
        return args, _nbytes(out[:2])
    if sc.kind == "prefill":
        b_meta = SP.batch_struct(cfg, sc)
        b_meta.pop("targets")
        batch = SH.distribute(_fake(b_meta), SH.batch_shardings(b_meta, par))
        out = SH.sharded_prefill(params, cfg, batch, par)
        return _nbytes((params, batch)), _nbytes(out)
    tok_m, len_m, cache_m = SP.decode_struct(cfg, sc)
    t_shard = SH.batch_shardings(tok_m, par)
    caches = SH.distribute(_fake(cache_m), SH.serving_cache_shardings(
        cache_m, cfg, par, sc.global_batch))
    tokens = SH.distribute(_fake(tok_m), t_shard)
    lengths = SH.distribute(_fake(len_m), t_shard)
    out = SH.sharded_decode_step(params, cfg, tokens, caches, lengths, par)
    return _nbytes((params, tokens, lengths, caches)), _nbytes(out)


#: bytes a rank moves through its links per byte of a collective's input,
#: over n ranks in a ring: an all-gather passes its n - 1 peers' shards, a
#: reduce-scatter (n - 1) / n of its input, an all-reduce both
_RING = {
    "all_gather_into_tensor": lambda n: n - 1,
    "reduce_scatter_tensor": lambda n: (n - 1) / n,
    "all_reduce": lambda n: 2 * (n - 1) / n,
    "all_to_all_single": lambda n: (n - 1) / n,
}


#: c10d's own (in-place) all-gather, as the kind it counts as: its
#: arguments are (output, input, process group, ...), the output the
#: group's inputs put together
_C10D = {"_allgather_base_": ("all_gather_into_tensor",)}


class CommBytesMode(CommDebugMode):
    """``CommDebugMode`` that also adds up, by kind, the bytes each traced
    functional collective, or c10d collective of :data:`_C10D`, moves
    through this rank's links (:data:`_RING` on its input's bytes and its
    group's size).  A collective of another kind, or of a symbolic size,
    is left out and counted as unsized."""

    def __init__(self):
        super().__init__()
        self.link_bytes: Dict[str, float] = {}
        self.sized = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        name = getattr(func, "_overloadpacket", None)
        name = getattr(name, "__name__", "")
        ns = getattr(func, "namespace", "")
        if out is NotImplemented:
            return out
        if ns == "_c10d_functional" and name in _RING:
            group = next(a for a in reversed(args) if isinstance(a, str))
            kind, x = name, args[0]
            size = lambda: resolve_process_group(group).size()
        elif ns == "c10d" and name in _C10D:
            (kind,), x = _C10D[name], args[1]
            size = lambda: int(args[0].numel()) // int(x.numel())
        else:
            return out
        try:
            nbytes = int(x.numel()) * x.element_size()
            n = size()
        except Exception:               # a data-dependent (symbolic) size
            return out
        self.link_bytes[kind] = (self.link_bytes.get(kind, 0.0)
                                 + nbytes * _RING[kind](n))
        self.sized += 1
        return out


def _at_seq(traced: Dict[int, Dict[str, float]],
            seq_len: int) -> Dict[str, float]:
    """Each kind's link bytes at ``seq_len`` positions, from two traces
    (positions -> bytes by kind): a + b * S through both, exact where the
    bytes are linear in S, as the parameter moves (constant) and the
    activations' sums (linear) are."""
    (s1, b1), (s2, b2) = sorted(traced.items())
    return {k: b2.get(k, 0.0) + (b2.get(k, 0.0) - b1.get(k, 0.0))
            * (seq_len - s2) / (s2 - s1) for k in sorted(set(b1) | set(b2))}


def _collectives(comm: CommBytesMode) -> Dict[str, Any]:
    by_kind: Dict[str, int] = {}
    for op, n in comm.get_comm_counts().items():
        name = str(op).split(".")[-1]
        name = _C10D.get(name, (name,))[0]
        by_kind[name] = by_kind.get(name, 0) + int(n)
    total = sum(by_kind.values())
    return {"collectives": by_kind, "n_collectives": total,
            "link_bytes": dict(comm.link_bytes),
            "unsized_collectives": total - comm.sized}


#: where each number of a record comes from
SOURCES = {
    "flops_per_chip": "FlopCounterMode over the traced local step",
    "link_bytes_per_chip": "the traced collectives at the ring count",
    "hbm_bytes_per_chip": "analytic_cost: the JAX package's GSPMD model",
    "cache_bytes_total": "analytic_cost",
    "analytic": "analytic_cost: the JAX package's GSPMD model",
}


def lower_cell(arch: str, shape: str, multi_pod: bool = False,
               cfg_overrides: Optional[dict] = None, verbose: bool = True,
               smoke: bool = False,
               mesh: Optional[Tuple[int, int]] = None) -> Dict[str, Any]:
    """Trace one cell on fake tensors; returns its roofline record.
    ``smoke``: the arch's reduced config; ``mesh``: a (data, model) mesh
    in place of the production one."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.mesh import make_local_parallel, make_parallel
    sc = SHAPES[shape]
    ok, reason = cell_supported(arch, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "status": "skipped", "reason": reason}

    t0 = time.time()
    cfg = dryrun_config(arch, smoke, **(cfg_overrides or {}))
    tuning = CELL_TUNING.get((arch, shape), {})
    grad_accum = tuning.get("grad_accum", 1)
    n_chips = (mesh[0] * mesh[1] if mesh is not None
               else 512 if multi_pod else 256)
    p_meta = SP.params_struct(cfg)
    n_params = RL.count_params(p_meta)
    cfg_trace, sc_trace, s_scale = trace_setup(cfg, sc)
    with fake_world(n_chips):
        par = (make_local_parallel(*mesh, device_type="cpu")
               if mesh is not None
               else make_parallel(multi_pod=multi_pod, device_type="cpu"))
        pods = par.size("pod") if "pod" in par.mesh.mesh_dim_names else 1
        with fake_mode(), CommBytesMode() as comm, \
                FlopCounterMode(display=False) as counter:
            arg_bytes, out_bytes = run_step(cfg_trace, sc_trace, par,
                                            p_meta, grad_accum)
        traced = float(counter.get_total_flops())
        diag = _collectives(comm)
        if s_scale != 1.0:
            # link bytes are a + b * S: a second trace at half the
            # positions gives b
            half = dataclasses.replace(sc_trace,
                                       seq_len=sc_trace.seq_len // 2)
            with fake_mode(), CommBytesMode() as comm_half:
                run_step(cfg_trace, half, par, p_meta, grad_accum)
            diag["link_bytes"] = _at_seq(
                {sc_trace.seq_len: diag["link_bytes"],
                 half.seq_len: dict(comm_half.link_bytes)}, sc.seq_len)
        tp, fsdp = par.tp, par.fsdp
    flops_per_chip = traced * s_scale

    ac = RL.analytic_cost(cfg, sc, chips=n_chips, tp=tp, fs=fsdp,
                          pods=pods, n_params=n_params,
                          grad_accum=grad_accum)
    if sc.kind == "train":
        tokens = sc.global_batch * sc.seq_len
        model_flops = RL.model_flops_train(_active_params(cfg, n_params),
                                           tokens)
    elif sc.kind == "prefill":
        tokens = sc.global_batch * sc.seq_len
        model_flops = (2.0 / 6.0) * RL.model_flops_train(
            _active_params(cfg, n_params), tokens)
    else:
        model_flops = RL.model_flops_decode(_active_params(cfg, n_params),
                                            sc.global_batch)
    link_bytes = sum(diag["link_bytes"].values())
    rf = RL.Roofline(flops_per_chip, ac["hbm_bytes"], link_bytes,
                     model_flops=model_flops, n_chips=n_chips)
    rec = {
        "arch": arch, "shape": shape, "multi_pod": multi_pod,
        "status": "ok", "n_chips": n_chips, "n_params": n_params,
        "kind": sc.kind, "tuning": tuning, "serve_2d": False,
        "flops_per_chip": flops_per_chip,
        "hbm_bytes_per_chip": ac["hbm_bytes"],
        "link_bytes_per_chip": link_bytes,
        "cache_bytes_total": ac["cache_bytes_total"],
        "analytic": {"hbm_bytes_per_chip": ac["hbm_bytes"],
                     "link_bytes_per_chip": ac["link_bytes"]},
        "sources": SOURCES,
        "trace_diag": diag,
        "probe": {"traced_flops": traced, "seq_scale": s_scale},
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": None, "alias_bytes": None,
                   "peak_estimate_bytes": None},
        "roofline": rf.row(),
        "model_flops": model_flops,
        "elapsed_s": round(time.time() - t0, 1),
    }
    if verbose:
        mm = rec["memory"]
        print(f"[{arch} x {shape} x {'2pod' if multi_pod else '1pod'}] OK "
              f"args={mm['argument_bytes'] / 2**30:.2f}GiB "
              f"t_comp={rf.t_compute * 1e3:.2f}ms "
              f"t_mem={rf.t_memory * 1e3:.2f}ms "
              f"t_coll={rf.t_collective * 1e3:.2f}ms -> {rf.bottleneck} "
              f"collectives={diag['n_collectives']} "
              f"({rec['elapsed_s']:.0f}s)", flush=True)
    return rec


def _active_params(cfg, n_params: float) -> float:
    """Active parameters per token (MoE: routed top_k + shared only)."""
    if cfg.moe is None:
        return n_params
    mc = cfg.moe
    expert_p = 3 * cfg.d_model * mc.d_expert      # wi, wg, wo per expert
    n_moe_layers = cfg.n_layers - len(cfg.prelude)
    inactive = (mc.n_experts - mc.top_k) * expert_p * n_moe_layers
    return n_params - inactive


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="one arch (default: sweep)")
    ap.add_argument("--archs", default=None,
                    help="comma-separated subset to sweep")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="dryrun_torch_results.json")
    ap.add_argument("--include-paper-models", action="store_true")
    ap.add_argument("--resume", default=None,
                    help="existing results json: completed cells are kept")
    args = ap.parse_args(argv)

    if args.arch:
        archs = [args.arch]
    elif args.archs:
        archs = args.archs.split(",")
    else:
        archs = list(ASSIGNED_ARCHS + PAPER_ARCHS
                     if args.include_paper_models else ASSIGNED_ARCHS)
    unknown = sorted(set(archs) - set(ALL_ARCHS))
    if unknown:
        ap.error(f"unknown arch(s) {unknown}; known: {ALL_ARCHS}")
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    done = {}
    if args.resume:
        try:
            with open(args.resume) as f:
                for rec in json.load(f):
                    if rec.get("status") in ("ok", "skipped"):
                        done[(rec["arch"], rec["shape"],
                              bool(rec.get("multi_pod")))] = rec
            print(f"resuming: {len(done)} cells already complete",
                  flush=True)
        except FileNotFoundError:
            pass

    results = []
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in sorted(meshes):
                if (arch, shape, mp) in done:
                    results.append(done[(arch, shape, mp)])
                    continue
                try:
                    rec = lower_cell(arch, shape, multi_pod=mp)
                except Exception as e:  # a failure here is a framework bug
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                           "status": "FAILED",
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                    print(f"[{arch} x {shape} x "
                          f"{'2pod' if mp else '1pod'}] FAILED: {e}",
                          flush=True)
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    print(f"\n{len(results)} cells, {failures} failures -> {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
