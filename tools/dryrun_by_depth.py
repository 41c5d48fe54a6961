"""The dry run's counts of a cell at its full depth, from two traces of it
cut in depth.

A model's groups are alike (the same layers, the same shapes), so every
count the dry run takes of a step -- ``flops_per_chip`` and each kind of
collective's link bytes -- is ``a + b * n_groups``: the embeddings, LM
head, loss and optimizer's scalar work once, each group's layers, their
parameter moves and gradient reductions, and their activation sums over
the model axis once a group.  Two traces at ``g1`` and ``g2`` groups give
``a`` and ``b``, and so the full depth's counts, exactly (up to the
floating-point sum of the two); zero groups (the prelude alone) is the
cheapest first trace.  This is for cells whose full trace takes
too long on fake tensors (a deep stack of chunked scans).

    python3 tools/dryrun_by_depth.py [--src CHECKOUT/src] --arch zamba2-2.7b \\
        --shape train_4k [--groups 0,1] [--check]

``--src`` runs another checkout's dry run (``launch/dryrun.py::
lower_cell`` with ``cfg_overrides={"n_layers": ...}``); ``--check`` also
traces the full depth and prints both, to hold the extrapolation to it.
Prints one JSON line.
"""
import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--groups", default="0,1")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D

    cfg = get_config(args.arch)
    per, pre = len(cfg.pattern), len(cfg.prelude)
    full = (cfg.n_layers - pre) // per
    g1, g2 = (int(v) for v in args.groups.split(","))
    t0 = time.perf_counter()
    recs = {g: D.lower_cell(args.arch, args.shape, verbose=False,
                            cfg_overrides={"n_layers": pre + g * per})
            for g in (g1, g2)}

    def at_full(key):
        a, b = (float(key(recs[g])) for g in (g1, g2))
        return a + (b - a) * (full - g1) / (g2 - g1)

    kinds = sorted(set().union(*(recs[g]["trace_diag"]["link_bytes"]
                                 for g in (g1, g2))))
    out = {"arch": args.arch, "shape": args.shape, "n_layers": cfg.n_layers,
           "groups": full, "traced_groups": [g1, g2], "src": args.src,
           "flops_per_chip": at_full(lambda r: r["flops_per_chip"]),
           "link_bytes_by_kind": {k: at_full(
               lambda r, k=k: r["trace_diag"]["link_bytes"].get(k, 0.0))
               for k in kinds}}
    out["link_bytes_per_chip"] = sum(out["link_bytes_by_kind"].values())
    if args.check:
        rec = D.lower_cell(args.arch, args.shape, verbose=False)
        out["traced_full"] = {"flops_per_chip": rec["flops_per_chip"],
                              "link_bytes_per_chip":
                                  rec["link_bytes_per_chip"]}
    out["elapsed_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
