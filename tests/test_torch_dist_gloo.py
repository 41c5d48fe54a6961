"""The distribution layer across processes: four CPU ranks over gloo, the
twin of ``tests/test_sharding.py``'s five tests (which run the JAX package
on eight fake host devices).

One spawn serves the file: a module fixture starts four ranks of
``_RANKS`` (a (2, 2) mesh, with (4, 1), (1, 4) and a 4-rank 'pod' axis
where a test needs them); each rank writes what it computed to an
``.npz``, and the tests hold those against the port's single-device steps
and against the JAX package (which the ranks never import):

* sharded training of llama3.2-1b (ZeRO parameters and moments, a mask
  with unequal counts per data rank, and two microbatches) against the
  single-device step: loss within 1e-4, parameters within 5e-3;
* MoE expert parallelism at dbrx's smoke size against JAX's ``_moe_local``
  under ``jax.vmap(axis_name=...)`` one data shard at a time, and its
  gradients against the unsharded MoE's where no expert overflows;
* sharded prefill + decode of zamba2 (data rows and tp = 2 through
  ``sharded_decode_step``; data rows alone, bitwise) and of dbrx (expert
  and tensor parallelism) against the single-device steps and JAX's;
* tensor-parallel serving at (1, 4): zamba2's attention, Mamba-2 and FFN
  against JAX's modules, prefill + decode through ``decode_step`` and the
  paged pool against JAX's model, the slot, paged (with a preemption) and
  paged + n-gram engines against the single-device engines, and a rank's
  weight and pool bytes;
* tensor-parallel serving of the GLA family, mLSTM and MLA: gla, retnet,
  xlstm (7 mLSTM + 1 sLSTM, whole on every rank) and deepseek-v2-236b
  through ``sharded_prefill`` / ``sharded_decode_step`` at (2, 2), where
  tp = 2 splits their heads, and at (1, 4), where deepseek splits its 4
  heads and the 2-head configs take the whole-layer fallback, against
  JAX's model (computed while the ranks run); the paged + n-gram engine
  on model groups of 2 (gla, xlstm) and 4 (deepseek) against the
  single-device engines; a rank's slab bytes and the latent pools;
* the split-sum emulation (``dist.emulate.split_sums``): one device with
  each sharded product cut and added as tp = 2 does it, bitwise the
  (2, 2) runs of gla and zamba2 at MX8 SR -- their drift from one device
  is the order of those sums alone;
* data axes inside the engines: the slot, paged (a preemption that
  resumes on another data rank; a prefix hit on a page another data rank
  wrote during decode) and paged + n-gram engines at (4, 1), two rows a
  rank, and at (2, 2), against JAX's single-device engines (computed
  while the ranks run) and the port's; dbrx at (4, 1), whose experts the
  model axis does not split, routing the whole batch as one device; a
  rank's cache and pool bytes;
* training under tensor parallelism: llama3.2-1b, zamba2, gla, xlstm and
  deepseek-v2-236b at (2, 2) and zamba2 at (1, 4), a step and a
  ``grad_accum=2`` step, sequence-parallel, against JAX's single-device
  ``make_train_step`` (loss within 1e-4, parameters within 5e-3), every
  gradient leaf against the port's single-device gradient, sequence
  parallelism on against off, the model ranks' replicated leaves; dbrx at
  (4, 1), whose experts the model axis does not split, an expert
  overflowing: the sharded prefill + decode steps bitwise one device's
  and a train step against JAX's, and on 2 rows (which the data ranks do
  not divide, so each holds them whole) bitwise one device's steps and a
  train step against one device's;
* the compressed all-reduce over the 'pod' axis against JAX's ``pmean``;
* a checkpoint saved at (2, 2) restored bitwise at (4, 1) and (1, 4);
* a dim sharded over ("data", "model") in JAX's major-to-minor order.
"""
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import subprocess_env
from repro import ops as JOPS
from repro.configs import get_smoke_config as j_smoke
from repro.dist import compression as JCOMP
from repro.models import attention as JATT
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro.serving.api import Engine as JEngine
from repro.serving.api import ServeConfig as JServeConfig
from repro_torch import ops as TOPS
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.api import Engine, ServeConfig
from repro_torch.core import tree as T
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.launch.mesh import local_init_method
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.train import optimizer as TO
from repro_torch.train.train_loop import make_train_step

torch.set_num_threads(1)  # test workers share the cores: one thread each

WORLD = 4
SEQ, BATCH = 32, 4
MOE_X = (4, 16)                       # dbrx's (batch, seq) for the EP test
DECODE = dict(B=4, S=16, steps=4)
#: the archs whose GLA-family, mLSTM and MLA heads the model axis splits
NEW_ARCHS = ("gla-2.7b", "retnet-2.7b", "xlstm-1.3b", "deepseek-v2-236b")
#: their engines: (arch, model-group size, (prompt name, new tokens) each)
NEW_ENGINES = [("gla-2.7b", 2, (("rep", 5), ("p8", 4))),
               ("xlstm-1.3b", 2, (("rep", 5), ("p8", 4))),
               ("deepseek-v2-236b", 4, (("rep", 5), ("p8", 4)))]
#: the tensor-parallel engines: (name, ServeConfig keywords, (prompt name,
#: new tokens) per request); the paged run's two requests each grow a
#: second page in a pool of 2 usable pages, so one is preempted
ENGINES = [("slots", dict(backend="slots", batch=2),
            (("p5", 4), ("p8", 4))),
           ("paged", dict(batch=2, n_pages=3, prefill_chunk=128),
            (("p125", 6), ("p124", 6))),
           ("ngram", dict(batch=2, spec="ngram"),
            (("rep", 5), ("p8", 4)))]

#: the data-parallel engine runs: name -> (ServeConfig keywords, (prompt
#: name, new tokens) per request, a late request: (prompt, new tokens, the
#: request whose length it waits for, that length) or None).  ``paged``: 8
#: requests grow a second page in a pool of 8 usable pages, so some are
#: preempted and resume in the first free row, on another data rank;
#: ``hit``: ``dp_l134`` prefills 120 positions and streams the rest, so its
#: first page is completed by a decode step on its row's rank and stored,
#: and the late request, seated on another data rank, adopts that page
DP_RUNS = {
    "slots": (dict(backend="slots", batch=8),
              tuple((f"dp_s{i}", 6) for i in range(8)), None),
    "paged": (dict(batch=8, n_pages=9),
              tuple((f"dp_p{i}", 6) for i in range(8)), None),
    "hit": (dict(batch=8, n_pages=17, prefix_cache=True, prefill_chunk=120),
            (("dp_l134", 3), ("dp_s0", 30), ("dp_s1", 30)),
            ("dp_l128t", 4, 0, 128)),
    "ngram": (dict(batch=8, spec="ngram"),
              (("rep", 5),) + tuple((f"dp_s{i}", 5) for i in range(7)),
              None),
}
#: the runs at each mesh: (run, state format)
DP41 = [("slots", "fp32"), ("slots", "sr"), ("paged", "fp32"),
        ("paged", "sr"), ("hit", "sr"), ("ngram", "fp32"), ("ngram", "sr")]
DP22 = [("slots", "fp32"), ("slots", "sr"), ("paged", "fp32"),
        ("paged", "sr"), ("ngram", "fp32")]
#: dbrx's runs at (4, 1), and the capacity factor at which an expert of
#: its 8 decode rows overflows (4 experts, top 2: a capacity of 4 entries)
DP_MOE = [("slots", "fp32"), ("paged", "sr")]
DP_MOE_CF = 1.0
#: tensor-parallel training: (arch, mesh) runs; MoE capacity wide enough
#: that no expert overflows (expert parallelism routes a rank's rows)
TRAIN_RUNS = [(a, "2x2") for a in ("llama3.2-1b", "zamba2-2.7b", "gla-2.7b",
                                   "xlstm-1.3b", "deepseek-v2-236b")]
TRAIN_RUNS.append(("zamba2-2.7b", "1x4"))

#: one engine run, the ranks' and the single-device side's code alike
_DP_RUN = '''
def dp_serve(Engine, E, params, c, name, prompts, par=None):
    """Run DP_RUNS[name]: (the requests' tokens, the logits of every live
    row at every sampled step and every decode step, stats, the engine)."""
    kw, reqs, late = %(DP_RUNS)r[name]
    eng = Engine(params, c, ServeConfig(**kw), par=par)
    core, seen, sample = eng.engine, [], E.sample
    B = kw["batch"]

    def live(x):
        x = x.detach().reshape(x.shape[0], -1, x.shape[-1])
        if x.shape[0] == B:
            on = (core.active if core.backend == "slots"
                  else [r is not None for r in core.rows])
            x = x[torch.as_tensor(np.asarray(on, bool))]
        seen.append(x.reshape(-1, x.shape[-1]).clone())

    def recording(logits, *a, **k):
        if core.backend == "slots" or logits.shape[0] == 1:
            live(logits)
        return sample(logits, *a, **k)
    guard = getattr(core, "_guard", None)
    if guard is not None:
        core._guard = lambda lg: (live(lg), guard(lg))[1]
    E.sample = recording
    try:
        hs = [eng.submit(prompts[p], max_new_tokens=n) for p, n in reqs]
        if late is not None:
            wait = hs[late[2]].rid
            act = core.active
            while wait not in act or act[wait].length < late[3]:
                eng.step()
            hs.append(eng.submit(prompts[late[0]], max_new_tokens=late[1]))
        eng.run()
    finally:
        E.sample = sample
    return (np.concatenate([np.asarray(h.result().output) for h in hs]),
            torch.cat(seen).numpy(), eng.stats(), core)
''' % dict(DP_RUNS=DP_RUNS)

_RANKS = r'''
import os, sys, time
import numpy as np
import torch
import torch.distributed as dist

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
out = sys.argv[1]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=os.environ["DIST_INIT"],
                        rank=rank, world_size=world)

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.core import tree as T
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.dist import compression as C
from repro_torch.dist import sharding as SH
from repro_torch.dist import tp as TP
from repro_torch.launch.mesh import make_local_parallel
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import make_train_step

res = {}
par = make_local_parallel(2, 2, device_type="cpu")
g = lambda seed: torch.Generator().manual_seed(seed)

def full(tree):
    return [x.full_tensor().numpy() for x in T.leaves(tree)]

# 1. sharded training: two steps, the second with two microbatches
cfg = get_smoke_config("llama3.2-1b")
opt = O.OptimizerConfig(lr=1e-3)
params = M.init_model(cfg, g(0), device="cpu")
state = O.init_opt_state(params, opt)
p_shard = SH.param_shardings(params, cfg, par)
params = SH.distribute(params, p_shard)
state = SH.distribute(state, SH.opt_state_shardings(state, p_shard, par))
batch = make_batch_fn(cfg, %(SEQ)d, %(BATCH)d)(0)
batch["mask"][0, 5:] = 0.0            # data rank 0's rows count less
batch["mask"][1, 20:] = 0.0
for i, ga in enumerate((1, 2)):
    params, state, m = make_train_step(cfg, opt, par=par, grad_accum=ga)(
        params, state, batch)
    res[f"train_loss{i}"] = m["loss"].numpy()
    res[f"train_gnorm{i}"] = m["grad_norm"].numpy()
res.update({f"train_p{i}": a for i, a in enumerate(full(params))})
res.update({f"train_m{i}": a for i, a in enumerate(full(state["m"]))})

# 2. MoE expert parallelism (dbrx): forward and gradients, each rank its
# rows and its experts
for tag, cf in (("moe", None), ("moe_nodrop", 8.0)):
    mcfg = get_smoke_config("dbrx-132b")
    if cf is not None:
        mcfg = mcfg.with_(moe=mcfg.moe.__class__(**{
            **mcfg.moe.__dict__, "capacity_factor": cf}))
    ref = np.load(os.path.join(out, "moe_in.npz"))
    E = mcfg.moe.n_experts
    d_i, m_i = par.coordinate("data"), par.coordinate("model")
    rows = slice(d_i * 2, d_i * 2 + 2)
    ex = slice(m_i * E // 2, (m_i + 1) * E // 2)
    p = {"router": torch.from_numpy(ref["router"]).requires_grad_(True)}
    for k in ("wi", "wg", "wo"):
        p[k] = torch.from_numpy(ref[k][ex]).requires_grad_(True)
    x = torch.from_numpy(ref["x"][rows]).requires_grad_(True)
    y = L.apply_moe(p, x, mcfg, par)
    (y * torch.from_numpy(ref["cot"][rows])).sum().backward()
    res[f"{tag}_y"] = y.detach().numpy()
    for k in ("router", "wi", "wg", "wo"):
        res[f"{tag}_g{k}"] = p[k].grad.numpy()
    res[f"{tag}_gx"] = x.grad.numpy()

# the serving sections' shared pieces: the state formats, a run through
# the sharded steps, the (1, 4) mesh, and a sampler that records every
# sampled step's logits
from repro_torch import ops as OPS
from repro_torch.models import attention as ATT
from repro_torch.models import ssm as SSM
from repro_torch.serving import engine as E
from repro_torch.serving.api import Engine, ServeConfig
from repro_torch.serving.memory import PagedStatePool
QUANT = {"sr": ("mx8", "stochastic", "cuda"), "rn": ("mx8", "nearest", "cuda"),
         "fp32": ("fp32", "nearest", "torch")}

def sharded_run(params, c, p_layout, tok, feed, par):
    """Prefill + decode steps through the sharded steps: every step's
    whole logits."""
    lengths = torch.full((tok.shape[0],), tok.shape[1], dtype=torch.int32)
    sp = SH.distribute(params, p_layout(params, c, par))
    tb = SH.distribute({"tokens": tok},
                       SH.batch_shardings({"tokens": tok}, par))
    logits, caches = SH.sharded_prefill(sp, c, tb, par)
    ln_layout = SH.batch_shardings(lengths, par)
    step_logits = [logits.full_tensor().numpy()]
    for s in range(len(feed)):
        t_d = SH.distribute(feed[s], ln_layout)
        l_d = SH.distribute(lengths + s, ln_layout)
        logits, caches = SH.sharded_decode_step(sp, c, t_d, caches, l_d, par,
                                                seed=5 + s)
        step_logits.append(logits.full_tensor().numpy())
    return np.stack(step_logits)

def payload(prefix, tree):
    return {f"{prefix}{i}": a.numpy() for i, a in enumerate(T.leaves(tree))}

par4 = make_local_parallel(1, 4, device_type="cpu")
eng_in = np.load(os.path.join(out, "engines_in.npz"))
seen = []
sample = E.sample
def recording(logits, *a, **k):
    seen.append(logits.detach().clone().reshape(-1, logits.shape[-1]))
    return sample(logits, *a, **k)

# 8. the GLA family, mLSTM and MLA under tensor parallelism: sharded
# prefill + decode at (2, 2) (tp = 2 splits the smoke configs' 2 heads and
# deepseek's 4) and at (1, 4) (deepseek splits its 4; the 2-head configs
# fall back to whole layers); then the paged + n-gram engine on model
# groups of 2 (no data axis: two replicas of tp = 2) and of 4
new = np.load(os.path.join(out, "new_in.npz"))
ntok, nfeed = torch.from_numpy(new["tok"]), torch.from_numpy(new["feed"])

def new_cfg(arch, tag):
    c = get_smoke_config(arch).with_(
        state_quant=OPS.StateQuantConfig(*QUANT[tag]))
    if c.moe is not None:            # no expert overflows: EP == one device
        c = c.with_(moe=c.moe.__class__(**{**c.moe.__dict__,
                                           "capacity_factor": 8.0}))
    return c

for arch in %(NEW_ARCHS)s:
    nw = M.init_model(new_cfg(arch, "fp32"), g(0), device="cpu")
    for tag in ("fp32", "sr"):
        for mesh, pr in (("2x2", par), ("1x4", par4)):
            res[f"new_{arch}_{mesh}_{tag}"] = sharded_run(
                nw, new_cfg(arch, tag), SH.serving_param_shardings, ntok,
                nfeed, pr)
tp2 = SH.Parallel(par.mesh, data_axes=())
E.sample = recording
for arch, size, prompts in %(NEW_ENGINES)s:
    seen.clear()
    c = new_cfg(arch, "fp32")
    eng = Engine(M.init_model(c, g(0), device="cpu"), c,
                 ServeConfig(batch=2, spec="ngram"),
                 par=tp2 if size == 2 else par4)
    hs = [eng.submit(eng_in[pr], max_new_tokens=n) for pr, n in prompts]
    eng.run()
    res[f"neweng_{arch}"] = np.concatenate([np.asarray(h.result().output)
                                            for h in hs])
    res[f"neweng_{arch}_logits"] = torch.cat(seen).numpy()
    res[f"neweng_{arch}_gather"] = np.asarray(eng.stats()["gather_bytes"])
    pool = eng.engine.pool
    res[f"neweng_{arch}_slabs"] = np.asarray(     # one slab's, each leaf
        [t[0].numel() * t.element_size() for t, sp in zip(pool.pools,
                                                           pool.paging.specs)
         if sp.kind == "slab"])
    if arch == "deepseek-v2-236b":   # the latent pages, whole on each rank
        res.update(payload("neweng_latent", [t for t, sp in zip(
            pool.pools, pool.paging.specs) if sp.kind == "page"]))
E.sample = sample

# 10. training under tensor parallelism: TRAIN_RUNS, sequence-parallel
# (the configs' default); the first step's loss and gradients (whole), the
# positions of the residual stream each layer took, the loss without
# sequence parallelism, then a step and a grad_accum=2 step: losses, the
# parameters, and the local shards of the leaves the model axis
# replicates; then dbrx at (4, 1), whose experts the model axis does not
# split, at a capacity an expert overflows: the sharded prefill + decode
# of 8 rows (two a rank) and a train step
from repro_torch.train.train_loop import (batch_to_device,
                                          sharded_loss_and_grads)

def train_cfg(arch, cf=8.0):
    c = get_smoke_config(arch)
    if c.moe is not None:
        c = c.with_(moe=c.moe.__class__(**{**c.moe.__dict__,
                                           "capacity_factor": cf}))
    return c

def full_like(local, dts):
    return full(SH.like(local, dts))

seen_S, element_forward = [], M._element_forward
def hooked(p, x, *a, **k):
    seen_S.append(x.shape[1])
    return element_forward(p, x, *a, **k)

meshes = {"2x2": par, "1x4": par4}
for arch, mesh in %(TRAIN_RUNS)s:
    pr, c, key = meshes[mesh], train_cfg(arch), f"tt_{arch}_{mesh}"
    w = M.init_model(c, g(0), device="cpu")
    b = make_batch_fn(c, %(SEQ)d, %(BATCH)d)(0)
    b["mask"][0, 5:] = 0.0
    ps = SH.distribute(w, SH.param_shardings(w, c, pr))
    seen_S.clear()
    M._element_forward = hooked
    try:
        loss, grads = sharded_loss_and_grads(ps, c, b, pr)
    finally:
        M._element_forward = element_forward
    res[key + "_S"] = np.asarray(seen_S)
    res[key + "_gloss"] = loss.numpy()
    res.update({f"{key}_g{i}": a for i, a in enumerate(full_like(grads, ps))})
    res[key + "_loss_nosp"] = sharded_loss_and_grads(
        ps, c.with_(seq_parallel=False), b, pr)[0].numpy()
    opt = O.OptimizerConfig(lr=1e-3)
    st = O.init_opt_state(w, opt)
    st = SH.distribute(st, SH.opt_state_shardings(
        st, SH.param_shardings(w, c, pr), pr))
    for i, ga in enumerate((1, 2)):
        ps, st, m = make_train_step(c, opt, par=pr, grad_accum=ga)(ps, st, b)
        res[f"{key}_loss{i}"] = m["loss"].numpy()
    res.update({f"{key}_p{i}": a for i, a in enumerate(full(ps))})
    mi = list(pr.mesh.mesh_dim_names).index("model")
    res.update({f"{key}_rep{i}": x.to_local().numpy()
                for i, x in enumerate(T.leaves(ps))
                if x.placements[mi] == SH.Replicate()})

par41 = make_local_parallel(4, 1, device_type="cpu")
rows = np.load(os.path.join(out, "rows_in.npz"))
mc = train_cfg("dbrx-132b", %(DP_MOE_CF)r)
mw41 = M.init_model(mc, g(0), device="cpu")
for tag in ("fp32", "sr"):
    res[f"moe41_{tag}"] = sharded_run(
        mw41, mc.with_(state_quant=OPS.StateQuantConfig(*QUANT[tag])),
        SH.serving_param_shardings, torch.from_numpy(rows["tok"]),
        torch.from_numpy(rows["feed"]), par41)
opt = O.OptimizerConfig(lr=1e-3)
st = O.init_opt_state(mw41, opt)
p_l = SH.param_shardings(mw41, mc, par41)
ps, st, m = make_train_step(mc, opt, par=par41)(
    SH.distribute(mw41, p_l), SH.distribute(st, SH.opt_state_shardings(
        st, p_l, par41)), make_batch_fn(mc, %(SEQ)d, %(BATCH)d)(0))
res["moe41_train_loss"] = m["loss"].numpy()
res.update({f"moe41_train_p{i}": a for i, a in enumerate(full(ps))})
# two rows at (4, 1): the data axes do not divide them, so every rank
# holds the whole batch (replicated) and routes it as it is
for tag in ("fp32", "sr"):
    res[f"moe41b2_{tag}"] = sharded_run(
        mw41, mc.with_(state_quant=OPS.StateQuantConfig(*QUANT[tag])),
        SH.serving_param_shardings, torch.from_numpy(rows["tok"][:2]),
        torch.from_numpy(rows["feed"][:, :2]), par41)
st = O.init_opt_state(mw41, opt)
b2 = batch_to_device(make_batch_fn(mc, %(SEQ)d, 2)(0), "cpu")
ps, st, m = make_train_step(mc, opt, par=par41)(
    SH.distribute(mw41, p_l), SH.distribute(st, SH.opt_state_shardings(
        st, p_l, par41)), SH.distribute(b2, SH.batch_shardings(b2, par41)))
res["moe41b2_train_loss"] = m["loss"].numpy()
res.update({f"moe41b2_train_p{i}": a for i, a in enumerate(full(ps))})

# sections 3 and 7 read JAX's zamba2 results, which the fixture writes
# while the ranks run the sections above
deadline = time.monotonic() + 600
while not os.path.exists(os.path.join(out, "zamba2.ready")):
    if time.monotonic() > deadline:
        raise TimeoutError("no zamba2 inputs from the fixture")
    time.sleep(0.05)

# 3. sharded prefill + decode (parameters, batch and caches in their
# layouts): zamba2 (JAX's weights; the tokens JAX's fp32 greedy run fed)
# at (2, 2), data rows and tp = 2, at its stochastic rounding, at
# round-to-nearest and at fp32 state, and at (4, 1), data rows alone;
# dbrx (MoE) at (1, 4) and (2, 2), its parameters at rest in the serving
# layout and in the training one
zcfg = get_smoke_config("zamba2-2.7b")
zw = torch.load(os.path.join(out, "zamba2.pt"))
tok = torch.from_numpy(np.load(os.path.join(out, "decode_in.npy")))
feed = torch.from_numpy(np.load(os.path.join(out, "feed.npy")))
B, S = tok.shape
zc = {t: zcfg.with_(state_quant=OPS.StateQuantConfig(*q))
      for t, q in QUANT.items()}

for tag in ("sr", "rn", "fp32"):
    res[f"decode_{tag}"] = sharded_run(zw, zc[tag], SH.serving_param_shardings,
                                       tok, feed, par)
for tag in ("sr", "rn"):
    res[f"decode41_{tag}"] = sharded_run(
        zw, zc[tag], SH.serving_param_shardings,
        torch.from_numpy(rows["tok"]), torch.from_numpy(rows["feed"]), par41)
mcfg = get_smoke_config("dbrx-132b")
mcfg = mcfg.with_(state_quant=OPS.StateQuantConfig(*QUANT["fp32"]),
                  moe=mcfg.moe.__class__(**{**mcfg.moe.__dict__,
                                            "capacity_factor": 8.0}))
mw = M.init_model(mcfg, g(0), device="cpu")
for shape, lay in (((1, 4), "serving_param_shardings"),
                   ((2, 2), "param_shardings")):
    res[f"moe_decode_{shape[0]}x{shape[1]}"] = sharded_run(
        mw, mcfg, getattr(SH, lay), tok, feed,
        make_local_parallel(*shape, device_type="cpu"))
lengths = torch.full((B,), S, dtype=torch.int32)

# 7. tensor-parallel serving at (1, 4): the modules, the model steps
# (dense and paged), the engines, a rank's bytes
mod = np.load(os.path.join(out, "tp_in.npz"))
x, x1 = torch.from_numpy(mod["x"]), torch.from_numpy(mod["x1"])
Bm, Sm = x.shape[:2]
pos = torch.arange(Sm)[None].expand(Bm, Sm)
pos1 = torch.full((Bm, 1), Sm)

for tag in ("fp32", "sr"):
    c = zc[tag]
    p = SH.tp_params(zw, c, par4)
    a = p["shared"]["attn"]
    y0, cache = M._attn_block_forward(a, x, c, pos, 0, True, par4)
    y1, cache = ATT.attention_decode(a, x1, cache, c, pos1, 7, par4)
    res[f"tp_{tag}_attn"] = torch.cat([y0, y1], 1).numpy()
    res.update(payload(f"tp_{tag}_kv", (cache.k, cache.v)))
    m2 = p["groups"][0][0]["mixer"]
    y0, st = SSM.mamba2_forward(m2, x, c, par=par4)
    y1, st = SSM.mamba2_decode(m2, x1, st, c, 9, par=par4)
    res[f"tp_{tag}_m2"] = torch.cat([y0, y1], 1).numpy()
    res.update(payload(f"tp_{tag}_S", st["S"]))
    res[f"tp_{tag}_ffn"] = L.apply_ffn(p["shared"]["ffn"], x, c.ffn_kind,
                                       TP.layer_par(c.d_ff, par4)).numpy()
    # prefill + decode steps: decode_step, and the paged pool
    logits, caches = M.prefill(p, c, {"tokens": tok}, par=par4)
    dense = [logits]
    for s in range(%(STEPS)d):
        logits, caches = M.decode_step(p, c, feed[s], caches, lengths + s,
                                       seed=5 + s, par=par4)
        dense.append(logits)
    res[f"tp_dense_{tag}"] = torch.stack(dense).numpy()
    pool = PagedStatePool(c, n_pages=B + 1, n_slabs=B + 1, device="cpu",
                          par=par4)
    paged = []
    for b in range(B):
        assert pool.register(b, 1)
        logits, rc = M.prefill(p, c, {"tokens": tok[b:b + 1]}, par=par4)
        pool.insert_prefill(b, rc)
        paged.append(logits[0])
    paged = [torch.stack(paged)]
    for s in range(%(STEPS)d):
        paged.append(pool.decode(p, list(range(B)), feed[s].numpy(),
                                 (lengths + s).numpy(), 5 + s))
    res[f"tp_paged_{tag}"] = torch.stack(paged).numpy()
    if tag == "sr":                  # a rank's bytes against tp = 1
        whole = PagedStatePool(c, n_pages=B + 1, n_slabs=B + 1,
                               device="cpu")
        for k, pl in (("tp", pool), ("whole", whole)):
            res[f"pool_{k}"] = np.asarray([t.numel() * t.element_size()
                                           for t in pl.pools])
        for k, w in (("tp", p), ("whole", zw)):
            res[f"weights_{k}"] = np.asarray([t.numel() for t in
                                              T.leaves(w)])

# the engines at fp32 state, every sampled step's logits recorded
E.sample = recording
for name, kw, prompts in %(ENGINES)s:
    seen.clear()
    eng = Engine(zw, zc["fp32"], ServeConfig(**kw), par=par4)
    hs = [eng.submit(eng_in[pr], max_new_tokens=n) for pr, n in prompts]
    eng.run()
    res[f"eng_{name}"] = np.concatenate([np.asarray(h.result().output)
                                         for h in hs])
    res[f"eng_{name}_logits"] = torch.cat(seen).numpy()
    res[f"eng_{name}_preempt"] = np.asarray(
        eng.stats().get("preemptions", 0))
E.sample = sample

# 4. the compressed all-reduce over a 4-rank 'pod' axis
from repro_torch.dist.compat import init_device_mesh
pod = SH.Parallel(init_device_mesh("cpu", (world,), mesh_dim_names=("pod",)),
                  data_axes=("pod",))
gw = np.load(os.path.join(out, "comp_in.npy"))[rank]
grads = {"w": torch.from_numpy(gw)}
red, ef = C.compressed_allreduce_mean(grads, C.init_error_feedback(grads),
                                      pod.group("pod"))
res["comp_red"], res["comp_ef"] = red["w"].numpy(), ef["w"].numpy()

# 5. elastic restore: saved at (2, 2), restored at (4, 1) and (1, 4)
scfg = get_smoke_config("smollm-360m")
sp = M.init_model(scfg, g(0), device="cpu")
mgr = CheckpointManager(os.path.join(out, "ckpt"))
mgr.save(7, SH.distribute(sp, SH.param_shardings(sp, scfg, par)))
for tag, shape in (("4x1", (4, 1)), ("1x4", (1, 4))):
    par_b = make_local_parallel(*shape, device_type="cpu")
    sh_b = SH.param_shardings(sp, scfg, par_b)
    got, step = mgr.restore({"params": sp, "opt_state": None},
                            shardings={"params": sh_b, "opt_state": None})
    res[f"ckpt_step_{tag}"] = np.asarray(step)
    res[f"ckpt_local_{tag}"] = np.asarray(
        [x.to_local().numel() for x in T.leaves(got["params"])])
    res.update({f"ckpt_{tag}_{i}": a
                for i, a in enumerate(full(got["params"]))})

# 6. one dim over two axes, major to minor: JAX's P(("data", "model"))
x = torch.arange(8, dtype=torch.float32)
res["major_minor"] = SH.distribute(
    x, par.named((("data", "model"),))).to_local().numpy()

# 9. data axes inside the engines: zamba2 (JAX's weights) at (4, 1), two
# rows a rank, and at (2, 2); dbrx (MoE) at (4, 1), where the model axis
# splits no experts and a capacity factor of 1 overflows an expert of the
# 8 decode rows; every run's tokens, its live rows' logits, stats
%(DP_RUN)s
for mesh, pr, runs in (("4x1", par41, %(DP41)s), ("2x2", par, %(DP22)s)):
    for name, tag in runs:
        toks, logits, st, core = dp_serve(Engine, E, zw, new_cfg(
            "zamba2-2.7b", tag), name, eng_in, pr)
        key = f"dp_{mesh}_{name}_{tag}"
        res[key], res[key + "_logits"] = toks, logits
        res[key + "_moves"] = np.asarray(st.get("dp_moves", -1.0))
        res[key + "_preempt"] = np.asarray(st.get("preemptions", 0.0))
        res[key + "_hits"] = np.asarray(st.get("prefix_hits", 0.0))
        if mesh == "2x2" and tag == "sr":   # a rank's bytes at dp = 2
            held = core.caches if name == "slots" else core.pool.pools
            res[key + "_bytes"] = np.asarray(
                [t.numel() * t.element_size() for t in T.leaves(held)])
for name, tag in %(DP_MOE)s:
    c = new_cfg("dbrx-132b", tag)
    c = c.with_(moe=c.moe.__class__(**{**c.moe.__dict__,
                                       "capacity_factor": %(DP_MOE_CF)r}))
    key = f"dp_moe_{name}_{tag}"
    res[key], res[key + "_logits"], _, _ = dp_serve(Engine, E, mw, c, name,
                                                    eng_in, par41)

np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
dist.barrier()
dist.destroy_process_group()
''' % dict(SEQ=SEQ, BATCH=BATCH, STEPS=DECODE["steps"], ENGINES=repr(ENGINES),
       NEW_ARCHS=repr(NEW_ARCHS), NEW_ENGINES=repr(NEW_ENGINES),
       DP_RUN=_DP_RUN, DP41=repr(DP41), DP22=repr(DP22), DP_MOE=repr(DP_MOE),
       DP_MOE_CF=DP_MOE_CF, TRAIN_RUNS=repr(TRAIN_RUNS))


def _moe_cfgs(capacity_factor=None):
    jc, tc = j_smoke("dbrx-132b"), t_smoke("dbrx-132b")
    if capacity_factor is not None:
        jc = jc.with_(moe=jc.moe.__class__(**{
            **jc.moe.__dict__, "capacity_factor": capacity_factor}))
        tc = tc.with_(moe=tc.moe.__class__(**{
            **tc.moe.__dict__, "capacity_factor": capacity_factor}))
    return jc, tc


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Four gloo ranks of ``_RANKS``, once for the file: their results
    (one dict a rank) and the inputs they were given."""
    out = tmp_path_factory.mktemp("gloo")
    jc, _ = _moe_cfgs()
    p = jax.tree.map(np.array, JL.init_moe(jax.random.PRNGKey(0), jc))
    r = np.random.default_rng(1)
    x = r.standard_normal(MOE_X + (jc.d_model,)).astype(np.float32)
    cot = r.standard_normal(x.shape).astype(np.float32)
    np.savez(out / "moe_in.npz", x=x, cot=cot, router=p["router"],
             wi=p["wi"], wg=p["wg"], wo=p["wo"])
    zc = t_smoke("zamba2-2.7b")
    tok = r.integers(0, zc.vocab_size, (DECODE["B"], DECODE["S"]))
    np.save(out / "decode_in.npy", tok)
    np.savez(out / "rows_in.npz", **ROWS)
    np.savez(out / "engines_in.npz", **ENGINE_PROMPTS)
    np.savez(out / "new_in.npz", **NEW_IN)
    grads = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                         (WORLD, 64, 32)))
    np.save(out / "comp_in.npy", grads)
    init = local_init_method()
    t0 = time.perf_counter()
    logs = [open(out / f"rank{i}.log", "w") for i in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANKS, str(out)],
        env=subprocess_env(RANK=str(i), WORLD_SIZE=str(WORLD),
                           DIST_INIT=init, OMP_NUM_THREADS="1"),
        stdout=logs[i], stderr=subprocess.STDOUT) for i in range(WORLD)]
    # JAX's side while the ranks run: zamba2's weights, fed tokens and
    # module inputs, which the ranks wait for after their first sections
    # (``zamba2.ready``), then the new mixers' prefill + decode on the
    # port's weights and the single-device engines of the data-parallel
    # runs on zamba2's, which they need none of
    try:
        jz = _zamba2_jax(tok)
        torch.save(jz["tparams"], out / "zamba2.pt")
        np.save(out / "feed.npy", jz["feed"])
        np.savez(out / "tp_in.npz", x=jz["x"], x1=jz["x1"])
        (out / "zamba2.ready").touch()
        new_jax = {arch: _new_mixers_jax(arch) for arch in NEW_ARCHS}
        dp_jax = {(name, tag): _dp_serve_jax(jz["jparams"], name, tag)
                  for name, tag in DP41}
        train_jax = {arch: _train_jax(arch) for arch in dict(TRAIN_RUNS)}
        train_jax["dbrx-132b"] = _train_jax("dbrx-132b", DP_MOE_CF, (1,))
        print(f"JAX's side: {time.perf_counter() - t0:.1f} s")
    except BaseException:
        for proc in procs:
            proc.kill()
        raise
    # a rank that fails leaves the others waiting in a collective: end
    # them all then, and at the deadline
    deadline = time.monotonic() + 600
    while any(proc.poll() is None for proc in procs) \
            and time.monotonic() < deadline \
            and not any(proc.poll() for proc in procs):
        time.sleep(0.1)
    for proc, log in zip(procs, logs):
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        log.close()
    for i, proc in enumerate(procs):
        text = (out / f"rank{i}.log").read_text()
        assert proc.returncode == 0, f"rank {i}:\n{text[-4000:]}"
    print(f"four gloo ranks: {time.perf_counter() - t0:.1f} s")
    res = [dict(np.load(out / f"rank{i}.npz")) for i in range(WORLD)]
    return res, dict(moe=(p, x, cot), tok=tok, grads=grads, zamba2=jz,
                     new=new_jax, dp_jax=dp_jax, train_jax=train_jax)


#: the data-rows-only decode at (4, 1): two rows a rank, as the whole
#: batch's products are bitwise its rows' on the CPU then (a lone row
#: takes the BLAS's one-row path, whose sums run in another order)
_RW = np.random.default_rng(11)
ROWS = {"tok": _RW.integers(0, 512, (8, 16)),
        "feed": _RW.integers(0, 512, (DECODE["steps"], 8))}

#: the engines' prompts (numpy's generator, seed 9)
_PR = np.random.default_rng(9)
ENGINE_PROMPTS = {"p5": _PR.integers(0, 512, 5), "p8": _PR.integers(0, 512, 8),
                  "p125": _PR.integers(0, 512, 125),
                  "p124": _PR.integers(0, 512, 124),
                  "rep": np.tile(_PR.integers(0, 512, 4), 4)}
_DPR = np.random.default_rng(21)
ENGINE_PROMPTS.update(
    {f"dp_s{i}": _DPR.integers(0, 512, n)
     for i, n in enumerate((5, 8, 6, 7, 9, 4, 10, 8))},
    **{f"dp_p{i}": _DPR.integers(0, 512, n)
       for i, n in enumerate((120, 126, 121, 127, 123, 125, 122, 124))})
ENGINE_PROMPTS["dp_l134"] = _DPR.integers(0, 512, 134)
ENGINE_PROMPTS["dp_l128t"] = np.concatenate([ENGINE_PROMPTS["dp_l134"][:128],
                                             _DPR.integers(0, 512, 8)])
exec(_DP_RUN)


#: the sharded xlstm's MX8 difference from one device, at most this many
#: times the one-ulp control's (``chip_smoke.py``'s factor)
CONTROL_FACTOR = 4
#: the new mixers' prompts and fed tokens (numpy's generator, seed 12)
_NW = np.random.default_rng(12)
NEW_IN = {"tok": _NW.integers(0, 512, (DECODE["B"], DECODE["S"])),
          "feed": _NW.integers(0, 512, (DECODE["steps"], DECODE["B"]))}


def _new_cfgs(arch, tag):
    """JAX's and the port's smoke config of ``arch`` at fp32 state or MX8
    SR, an MoE's capacity wide enough that no expert overflows (expert
    parallelism then routes as one device does)."""
    fmt, tb = ("fp32", "torch") if tag == "fp32" else ("mx8", "cuda")
    out = []
    for get, Q, b in ((j_smoke, JOPS, "jnp"), (t_smoke, TOPS, tb)):
        c = get(arch).with_(state_quant=Q.StateQuantConfig(fmt, "stochastic",
                                                           b))
        if c.moe is not None:
            c = c.with_(moe=c.moe.__class__(**{**c.moe.__dict__,
                                               "capacity_factor": 8.0}))
        out.append(c)
    return out


def _new_mixers_jax(arch):
    """JAX's prefill + decode of ``arch`` on the port's weights (seed 0)
    fed ``NEW_IN``: the logits of every step at fp32 state and MX8 SR."""
    from test_torch_train import _jax_layout
    tparams = TM.init_model(_new_cfgs(arch, "fp32")[1],
                            torch.Generator().manual_seed(0), device="cpu")
    jparams = jax.tree.map(jnp.asarray, _jax_layout(tparams, arch))
    tok, feed = NEW_IN["tok"], NEW_IN["feed"]
    lens = jnp.full((tok.shape[0],), tok.shape[1], jnp.int32)
    out = {"tparams": tparams}
    for tag in ("fp32", "sr"):
        jc = _new_cfgs(arch, tag)[0]
        jl, caches = jax.jit(lambda p, b: JM.prefill(p, jc, b))(
            jparams, {"tokens": jnp.asarray(tok, jnp.int32)})
        dec = jax.jit(lambda p, t, c, L, s: JM.decode_step(p, jc, t, c, L, s))
        logits = [jl]
        for s in range(DECODE["steps"]):
            jl, caches = dec(jparams, jnp.asarray(feed[s], jnp.int32), caches,
                             lens + s, jnp.int32(5 + s))
            logits.append(jl)
        out[tag] = np.stack([np.asarray(a) for a in logits])
    return out


def _train_cfgs(arch, cf=8.0):
    """JAX's and the port's smoke config of ``arch`` as the ranks train it:
    an MoE's capacity factor ``cf``."""
    out = []
    for get in (j_smoke, t_smoke):
        c = get(arch)
        if c.moe is not None:
            c = c.with_(moe=c.moe.__class__(**{**c.moe.__dict__,
                                               "capacity_factor": cf}))
        out.append(c)
    return out


def _train_batch(arch):
    """The ranks' batch (numpy): the pipeline's step 0, the mask of the
    tensor-parallel runs' first row cut at position 5 (dbrx's whole)."""
    b = make_batch_fn(t_smoke(arch), SEQ, BATCH)(0)
    if arch != "dbrx-132b":
        b["mask"][0, 5:] = 0.0
    return b


def _train_jax(arch, cf=8.0, accum=(1, 2)):
    """JAX's single-device ``make_train_step`` from the ranks' weights (the
    port's seed-0 init, carried into the JAX layout) on the ranks' batch,
    one step at each ``grad_accum`` of ``accum``: the losses and the
    parameters after, in the port's leaf order."""
    from repro.train import optimizer as JO
    from repro.train.train_loop import make_train_step as j_make_train_step
    from test_torch_train import _jax_layout
    jc, tc = _train_cfgs(arch, cf)
    jp = jax.tree.map(jnp.asarray, _jax_layout(TM.init_model(
        tc, torch.Generator().manual_seed(0), device="cpu"), arch))
    opt = JO.OptimizerConfig(lr=1e-3)
    st = JO.init_opt_state(jp, opt)
    b = _train_batch(arch)
    losses = []
    for ga in accum:
        jp, st, m = jax.jit(j_make_train_step(jc, opt, grad_accum=ga))(
            jp, st, b)
        losses.append(float(m["loss"]))
    return losses, [a.numpy() for a in T.leaves(params_from_jax(
        jax.tree.map(np.asarray, jp), tc, device="cpu"))]


def _zcfgs():
    """zamba2's smoke configs, JAX's and the port's, at fp32 state and at
    MX8 with stochastic rounding (JAX: ``jnp``; the port: its kernels'
    plain versions on the CPU)."""
    out = {}
    for tag, fmt, jb, tb in (("fp32", "fp32", "jnp", "torch"),
                             ("sr", "mx8", "jnp", "cuda")):
        out[tag] = (j_smoke("zamba2-2.7b").with_(
            state_quant=JOPS.StateQuantConfig(fmt, "stochastic", jb)),
            t_smoke("zamba2-2.7b").with_(
                state_quant=TOPS.StateQuantConfig(fmt, "stochastic", tb)))
    return out


def _zamba2_jax(tok):
    """JAX's side of the tensor-parallel cases, before the ranks start:
    the weights (and their port copy), the fp32 greedy run's tokens
    (every decode run is fed them), prefill + decode logits at fp32 and
    MX8 SR state, and the modules' outputs and stored states on one
    input."""
    cf = _zcfgs()
    tparams = TM.init_model(cf["fp32"][1], torch.Generator().manual_seed(0),
                            device="cpu")
    # the JAX package's layout: each pattern position's layers stacked
    tree = {k: v for k, v in tparams.items() if k != "groups"}
    tree["groups"] = [{k: v for k, v in T.unflatten(
        tparams["groups"][0][pos], [torch.stack(xs) for xs in zip(*(
            T.leaves(g[pos]) for g in tparams["groups"]))]).items()}
        for pos in range(len(cf["fp32"][1].pattern))]
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
    out = {"tparams": params_from_jax(jax.tree.map(np.asarray, jparams),
                                      cf["fp32"][1], device="cpu"),
           "jparams": jparams}
    B, S = tok.shape
    lens = jnp.full((B,), S, jnp.int32)
    feed = None
    for tag in ("fp32", "sr"):
        jc = cf[tag][0]
        jl, caches = jax.jit(lambda p, b: JM.prefill(p, jc, b))(
            jparams, {"tokens": jnp.asarray(tok, jnp.int32)})
        dec = jax.jit(lambda p, t, c, L, s: JM.decode_step(p, jc, t, c, L, s))
        logits, fed = [jl], []
        for s in range(DECODE["steps"]):
            nxt = (jnp.argmax(jl, -1).astype(jnp.int32) if feed is None
                   else jnp.asarray(feed[s]))
            fed.append(np.asarray(nxt))
            jl, caches = dec(jparams, nxt, caches, lens + s, jnp.int32(5 + s))
            logits.append(jl)
        feed = np.stack(fed) if feed is None else feed
        out[f"logits_{tag}"] = np.stack([np.asarray(a) for a in logits])
    out["feed"] = feed
    r = np.random.default_rng(4)
    x = r.standard_normal((2, 8, cf["fp32"][0].d_model)).astype(np.float32)
    x1 = r.standard_normal((2, 1, x.shape[-1])).astype(np.float32)
    out["x"], out["x1"] = x, x1
    pos = jnp.broadcast_to(jnp.arange(8)[None], (2, 8))
    pos1 = jnp.full((2, 1), 8)
    a, m2 = jparams["shared"]["attn"], jax.tree.map(
        lambda t: t[0], jparams["groups"][0])["mixer"]

    def modules(jc, x, x1):
        y0 = JATT.attention_forward(a, x, jc, pos)
        k, v = JATT.attention_prefill_kv(a, x, jc, pos)
        y1, cache = JATT.attention_decode(a, x1, JM._build_kv_cache(k, v, jc),
                                          jc, pos1, jnp.uint32(7))
        m0, st = JSSM.mamba2_forward(m2, x, jc)
        m1, st = JSSM.mamba2_decode(m2, x1, st, jc, jnp.uint32(9))
        return (jnp.concatenate([y0, y1], 1), (cache.k, cache.v),
                jnp.concatenate([m0, m1], 1), st["S"],
                JL.apply_ffn(jparams["shared"]["ffn"], x, jc.ffn_kind))

    for tag in ("fp32", "sr"):
        got = jax.jit(lambda x, x1, jc=cf[tag][0]: modules(jc, x, x1))(
            jnp.asarray(x), jnp.asarray(x1))
        for name, v in zip(("attn", "kv", "m2", "S", "ffn"), got):
            out[f"{name}_{tag}"] = v
    return out


def _coord(rank):
    """(data, model) of ``rank`` on the (2, 2) mesh (row-major)."""
    return rank // 2, rank % 2


def test_sharded_train_matches_single_device(ranks):
    res, _ = ranks
    cfg = t_smoke("llama3.2-1b")
    opt = TO.OptimizerConfig(lr=1e-3)
    params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    state = TO.init_opt_state(params, opt)
    batch = make_batch_fn(cfg, SEQ, BATCH)(0)
    batch["mask"][0, 5:] = 0.0
    batch["mask"][1, 20:] = 0.0
    losses = []
    for ga in (1, 2):
        params, state, m = make_train_step(cfg, opt, grad_accum=ga)(
            params, state, batch)
        losses.append(float(m["loss"]))
    for r in res:
        for i, want in enumerate(losses):
            assert abs(float(r[f"train_loss{i}"]) - want) < 1e-4
    leaves = T.leaves(params)
    d = max(float(np.max(np.abs(res[0][f"train_p{i}"] - p.numpy())))
            for i, p in enumerate(leaves))
    print("LOSS", losses, [float(res[0][f"train_loss{i}"]) for i in (0, 1)],
          "MAXDIFF", d)
    assert d < 5e-3
    # the ranks agree: one model, whatever its shards
    for r in res[1:]:
        for i in range(len(leaves)):
            np.testing.assert_array_equal(r[f"train_p{i}"],
                                          res[0][f"train_p{i}"])
    # ZeRO: the moments were reduced too (not a rank's own rows alone)
    m_diff = max(float(np.max(np.abs(res[0][f"train_m{i}"] - m.numpy())))
                 for i, m in enumerate(T.leaves(state["m"])))
    assert m_diff < 5e-4


def test_moe_ep_matches_jax_and_local(ranks):
    res, inp = ranks
    p, x, _ = inp["moe"]
    jc, tc = _moe_cfgs()
    E = jc.moe.n_experts
    for d_i in range(2):
        rows = slice(2 * d_i, 2 * d_i + 2)
        stacked = [p[k].reshape((2, E // 2) + p[k].shape[1:])
                   for k in ("wi", "wg", "wo")]
        yj = jax.vmap(lambda wi, wg, wo: JL._moe_local(
            jnp.asarray(x[rows]), jnp.asarray(p["router"]), wi, wg, wo, jc,
            ep_axis="m"), axis_name="m")(*map(jnp.asarray, stacked))
        for m_i in range(2):
            got = res[2 * d_i + m_i]["moe_y"]
            np.testing.assert_allclose(got, np.asarray(yj[m_i]), rtol=1e-5,
                                       atol=1e-5)
    y_ep = np.concatenate([res[0]["moe_y"], res[2]["moe_y"]])
    y_local = TL.apply_moe({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), tc).numpy()
    frac = float(np.mean(np.abs(y_local - y_ep) < 1e-4))
    print("AGREE", frac)
    assert frac > 0.95


def test_moe_ep_gradients_equal_the_unsharded_moe(ranks):
    """Where no expert overflows, EP's gradients are the unsharded MoE's:
    the router's and ``x``'s summed over the model axis (Megatron's f),
    none of them ``tp`` times too large."""
    res, inp = ranks
    p, x, cot = inp["moe"]
    _, tc = _moe_cfgs(8.0)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = TL.apply_moe(tp, xt, tc)
    (y * torch.from_numpy(cot)).sum().backward()
    y_ep = np.concatenate([res[0]["moe_nodrop_y"], res[2]["moe_nodrop_y"]])
    np.testing.assert_allclose(y_ep, y.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    tol = dict(rtol=1e-4, atol=1e-5)
    # the router: replicated, its gradient whole on every model rank after
    # the backward's sum; the data ranks hold their rows' shares
    for m_i in range(2):
        got = res[m_i]["moe_nodrop_grouter"] + res[2 + m_i][
            "moe_nodrop_grouter"]
        np.testing.assert_allclose(got, tp["router"].grad.numpy(), **tol)
    for k in ("wi", "wg", "wo"):
        got = np.concatenate([res[m_i][f"moe_nodrop_g{k}"]
                              + res[2 + m_i][f"moe_nodrop_g{k}"]
                              for m_i in range(2)])
        np.testing.assert_allclose(got, tp[k].grad.numpy(), **tol)
    for r in range(WORLD):
        d_i, _ = _coord(r)
        np.testing.assert_allclose(res[r]["moe_nodrop_gx"],
                                   xt.grad.numpy()[2 * d_i:2 * d_i + 2],
                                   **tol)


def _single_device_decode(cfg, tok, params, feed):
    """Prefill + decode steps of the port on one device, fed ``feed``: the
    logits of every step, (steps + 1, B, V)."""
    B, S = tok.shape
    logits, caches = TM.prefill(params, cfg, {"tokens": tok})
    out = [logits.numpy()]
    lengths = torch.full((B,), S, dtype=torch.int32)
    for s in range(DECODE["steps"]):
        logits, caches = TM.decode_step(params, cfg,
                                        torch.from_numpy(feed[s]), caches,
                                        lengths + s, seed=5 + s)
        out.append(logits.numpy())
    return np.stack(out)


def test_decode_sharded_matches_single_device(ranks):
    """Each rank decodes its rows of its heads, with its
    stochastic-rounding draws counted from its first row of the whole
    batch and its first head of each layer, at zamba2's stochastic
    rounding and at round-to-nearest.  At (4, 1), data rows alone, the
    sharded prefill + decode steps are the single-device steps on the
    whole batch, bitwise.  At (2, 2), data rows and tp = 2, they are so
    but for the order of the row-parallel sums: |dlogit| below JAX's 1e-2
    and the greedy tokens equal.  Every rank holds the same logits,
    bitwise."""
    res, inp = ranks
    cfg = t_smoke("zamba2-2.7b")
    tok = torch.from_numpy(inp["tok"])
    jz = inp["zamba2"]
    rn = cfg.with_(state_quant=cfg.state_quant.__class__(
        cfg.state_quant.fmt, "nearest", cfg.state_quant.backend))
    for tag, c in (("sr", cfg), ("rn", rn)):
        want = _single_device_decode(c, torch.from_numpy(ROWS["tok"]),
                                     jz["tparams"], ROWS["feed"])
        for r in res:
            np.testing.assert_array_equal(r[f"decode41_{tag}"], want)
        want = _single_device_decode(c, tok, jz["tparams"], jz["feed"])
        got = res[0][f"decode_{tag}"]
        print(tag, "max |dlogit|", float(np.max(np.abs(got - want))))
        assert np.max(np.abs(got - want)) < 1e-2, tag
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        for r in res[1:]:
            np.testing.assert_array_equal(r[f"decode_{tag}"], got)


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_moe_sharded_decode_matches_single_device(ranks, mesh):
    """dbrx (MoE, GQA) through the sharded prefill + 4 decode steps, at
    fp32 state and a capacity no expert overflows: at (1, 4) its 2 kv
    heads stay whole and each rank runs 1 of its 4 experts, parameters at
    rest in the serving layout; at (2, 2) each rank runs 1 kv head and 2
    experts on its rows, parameters at rest in the training layout (moved
    into the serving one).  The single-device steps' logits within rtol
    1e-4, atol 1e-4 * max|logits|, greedy tokens equal, every rank the
    same bits."""
    res, inp = ranks
    cfg = t_smoke("dbrx-132b")
    cfg = cfg.with_(state_quant=TOPS.StateQuantConfig("fp32", "nearest",
                                                      "torch"),
                    moe=cfg.moe.__class__(**{**cfg.moe.__dict__,
                                             "capacity_factor": 8.0}))
    params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    want = _single_device_decode(cfg, torch.from_numpy(inp["tok"]), params,
                                 inp["zamba2"]["feed"])
    got = res[0][f"moe_decode_{mesh}"]
    print(mesh, "max |dlogit|", float(np.max(np.abs(got - want))))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    for r in res[1:]:
        np.testing.assert_array_equal(r[f"moe_decode_{mesh}"], got)


def _mx8_close(got, want):
    """The MX8 parity contract: exponent and micro bytes bitwise,
    mantissas off by at most one step at a mismatch rate <= 1e-5."""
    for f in ("exponent", "micro"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    mg = got["mantissa"].astype(np.int32)
    mw = want["mantissa"].astype(np.int32)
    assert np.abs(mg - mw).max() <= 1
    assert (mg != mw).mean() <= 1e-5


def _leaves_np(res, prefix, n):
    return [res[f"{prefix}{i}"] for i in range(n)]


def test_tensor_parallel_modules_match_jax(ranks):
    """At (1, 4), each rank's zamba2 shared attention (prefill then one
    decode step, 1 kv head a rank), Mamba-2 (2 heads a rank) and FFN (32
    columns a rank), summed over the model axis, against JAX's whole
    modules: at fp32 state within rtol 1e-5, atol 1e-5 * max|y|; at MX8
    SR every rank's stored state against JAX's slice of its heads, by the
    MX8 parity contract (its SR draws counted from its first head)."""
    res, inp = ranks
    jz = inp["zamba2"]
    for tag in ("fp32", "sr"):
        for mod in ("attn", "m2", "ffn"):
            want = jz[f"{mod}_{tag}"]
            for r in res:
                np.testing.assert_allclose(
                    r[f"tp_{tag}_{mod}"], want, rtol=1e-5,
                    atol=1e-5 * np.abs(want).max(), err_msg=f"{mod} {tag}")
        if tag != "sr":
            continue
        for rank, r in enumerate(res):
            kvh, heads = 1, 2               # a rank's kv heads, its heads
            got_kv = _leaves_np(r, "tp_sr_kv", 6)
            for i, stream in enumerate(jz["kv_sr"]):
                _mx8_close({f: got_kv[3 * i + j] for j, f in enumerate(
                    ("exponent", "mantissa", "micro"))},
                    {f: np.asarray(a)[:, :, rank * kvh:(rank + 1) * kvh]
                     for f, a in stream.payload.items()})
            got_s = _leaves_np(r, "tp_sr_S", 3)
            _mx8_close({f: got_s[j] for j, f in enumerate(
                ("exponent", "mantissa", "micro"))},
                {f: np.asarray(a)[:, rank * heads:(rank + 1) * heads]
                 for f, a in jz["S_sr"].payload.items()})


def test_tensor_parallel_decode_matches_jax(ranks):
    """Prefill + 4 decode steps of zamba2 fed the same tokens: at (1, 4)
    through ``decode_step`` and the paged pool (``paged_decode_step``),
    at (2, 2) through ``sharded_decode_step`` (data rows and tp = 2),
    against JAX's ``M.prefill`` / ``M.decode_step``.  fp32 state: logits
    within rtol 1e-4, atol 1e-4 * max|logits|, greedy tokens equal.  MX8
    SR: |dlogit| < 1e-2 (``tests/test_sharding.py``'s bound), token
    agreement printed.  Every rank holds the same logits, bitwise."""
    res, inp = ranks
    jz = inp["zamba2"]
    for tag in ("fp32", "sr"):
        want = jz[f"logits_{tag}"]
        for run in (f"tp_dense_{tag}", f"tp_paged_{tag}", f"decode_{tag}"):
            got = res[0][run]
            for r in res[1:]:
                np.testing.assert_array_equal(r[run], got, err_msg=run)
            agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
            err = float(np.max(np.abs(got - want)))
            print(f"{run}: max |dlogit| {err:.3g}, greedy token agreement "
                  f"{agree:.2f}")
            if tag == "fp32":
                np.testing.assert_allclose(got, want, rtol=1e-4,
                                           atol=1e-4 * np.abs(want).max())
                assert agree == 1.0, run
            else:
                assert err < 1e-2, run


def _single_device_engines(params, cfg):
    out = {}
    for name, kw, prompts in ENGINES:
        eng = Engine(params, cfg, ServeConfig(**kw))
        hs = [eng.submit(ENGINE_PROMPTS[pr], max_new_tokens=n)
              for pr, n in prompts]
        eng.run()
        out[name] = (np.concatenate([np.asarray(h.result().output)
                                     for h in hs]),
                     eng.stats().get("preemptions", 0))
    return out


def test_tensor_parallel_engines_match_single_device(ranks):
    """The slot, paged and paged + n-gram engines at (1, 4), fp32 state:
    the single-device engines' greedy tokens, the paged run through a
    preemption (spill and resume of each rank's own pages), and every
    rank's sampled logits the same bits at every step."""
    res, inp = ranks
    cfg = _zcfgs()["fp32"][1]
    want = _single_device_engines(inp["zamba2"]["tparams"], cfg)
    for name, _, _ in ENGINES:
        for r in res:
            np.testing.assert_array_equal(r[f"eng_{name}"], want[name][0],
                                          err_msg=name)
            np.testing.assert_array_equal(r[f"eng_{name}_logits"],
                                          res[0][f"eng_{name}_logits"])
    assert int(res[0]["eng_paged_preempt"]) == want["paged"][1] >= 1


def test_tensor_parallel_bytes_a_rank(ranks):
    """A rank's weight and pool bytes at tp = 4: each leaf the model axis
    splits holds a quarter of its tp = 1 size, the rest the whole."""
    res, _ = ranks
    for kind in ("weights", "pool"):
        tp, whole = res[0][f"{kind}_tp"], res[0][f"{kind}_whole"]
        split = tp != whole
        assert split.any() and (tp[split] * 4 == whole[split]).all(), kind
        print(f"{kind}: a rank {int(tp.sum())} of {int(whole.sum())} "
              f"(split leaves {int(tp[split].sum())} of "
              f"{int(whole[split].sum())})")


def _single_device_new(arch, tag, nudge=False):
    """The port's single-device prefill + decode of ``arch`` fed
    ``NEW_IN``, on the ranks' weights; with ``nudge``, the first decode
    step's first state update returns its ``y`` one ulp up (every value),
    every later one untouched: the control of the MX8 amplification."""
    from repro_torch.models import ssm as TSSM
    c = _new_cfgs(arch, tag)[1]
    params = TM.init_model(_new_cfgs(arch, "fp32")[1],
                           torch.Generator().manual_seed(0), device="cpu")
    real, calls = TSSM._spu_state_update, [0]

    def nudged(*args, **kw):
        S, y = real(*args, **kw)
        calls[0] += 1
        if calls[0] == 1:
            y = torch.nextafter(y, torch.full_like(y, float("inf")))
        return S, y
    TSSM._spu_state_update = nudged if nudge else real
    try:
        return _single_device_decode(c, torch.from_numpy(NEW_IN["tok"]),
                                     params, NEW_IN["feed"])
    finally:
        TSSM._spu_state_update = real


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_tensor_parallel_new_mixers_decode_matches_jax(ranks, arch, mesh):
    """The GLA family, xLSTM and deepseek-v2-236b (MLA + MoE) through the
    sharded prefill + 4 decode steps, fed the same tokens: at (2, 2) tp =
    2 splits every mixer's heads but the sLSTM's (data rows split too), at
    (1, 4) deepseek's MLA splits its 4 heads and the 2-head mixers run
    whole (``layer_par``), against JAX's ``M.prefill`` /
    ``M.decode_step``, as ``test_tensor_parallel_decode_matches_jax``
    holds zamba2: fp32 state within rtol 1e-4, atol 1e-4 * max|logits|,
    greedy tokens equal; MX8 SR |dlogit| < 1e-2; every rank the same bits.
    xlstm at MX8 SR is held so at prefill only: seven mLSTM layers amplify
    each MX8 mantissa that a last-bit difference flips
    (``test_torch_xlstm.py``), so the single-device port's own decode
    steps part from JAX's past 1e-2 too.  Its decode steps are held to the
    size of that amplification instead: the sharded run's difference from
    the single-device port at most ``CONTROL_FACTOR`` times what moving one
    state update's ``y`` one ulp does to the single-device run (the
    control of ``chip_smoke.py``'s reference check)."""
    res, inp = ranks
    jx = inp["new"][arch]
    for tag in ("fp32", "sr"):
        run = f"new_{arch}_{mesh}_{tag}"
        got, want = res[0][run], jx[tag]
        for r in res[1:]:
            np.testing.assert_array_equal(r[run], got, err_msg=run)
        err = np.abs(got - want).max(axis=(1, 2))
        agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
        print(f"{run}: max |dlogit| by step {np.array2string(err, precision=3)}"
              f", greedy token agreement {agree:.2f}")
        assert np.isfinite(got).all(), run
        if tag == "fp32":
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max())
            assert agree == 1.0, run
        elif arch == "xlstm-1.3b":
            one = _single_device_new(arch, tag)
            d_tp = float(np.abs(got - one).max())
            d_ctl = float(np.abs(_single_device_new(arch, tag, True)
                                 - one).max())
            by_step = np.abs(one - want).max(axis=(1, 2))
            print(f"{run}: the single-device port's |dlogit| from JAX by "
                  f"step {np.array2string(by_step, precision=3)}; from it: "
                  f"sharded {d_tp:.3g}, one-ulp control {d_ctl:.3g}")
            assert err[0] < 1e-2 and d_tp <= CONTROL_FACTOR * d_ctl, run
        else:
            assert err.max() < 1e-2, run


@pytest.mark.parametrize("arch", [a for a, _, _ in NEW_ENGINES])
def test_tensor_parallel_new_mixers_engines_match_single_device(ranks, arch):
    """The paged engine with n-gram speculation, fp32 state, on model
    groups of 2 (gla, xlstm: 1 head a rank) and of 4 (deepseek: 1 query
    head a rank, the MoE expert-parallel): the single-device engine's
    greedy tokens, every rank's sampled logits the same bits, and a rank's
    own bytes in ``stats()`` (the prefills' slab inserts: half of one
    device's for gla, less than it for xlstm, whose sLSTM is whole)."""
    res, _ = ranks
    c = _new_cfgs(arch, "fp32")[1]
    params = TM.init_model(c, torch.Generator().manual_seed(0), device="cpu")
    prompts = next(p for a, _, p in NEW_ENGINES if a == arch)
    eng = Engine(params, c, ServeConfig(batch=2, spec="ngram"))
    hs = [eng.submit(ENGINE_PROMPTS[pr], max_new_tokens=n)
          for pr, n in prompts]
    eng.run()
    want = np.concatenate([np.asarray(h.result().output) for h in hs])
    for r in res:
        np.testing.assert_array_equal(r[f"neweng_{arch}"], want)
        np.testing.assert_array_equal(r[f"neweng_{arch}_logits"],
                                      res[0][f"neweng_{arch}_logits"])
    gathered = float(res[0][f"neweng_{arch}_gather"])
    whole = eng.stats()["gather_bytes"]
    print(f"{arch}: a rank's gather bytes {gathered:.0f} of {whole:.0f}")
    if arch == "gla-2.7b":
        assert gathered * 2 == whole
    elif arch == "xlstm-1.3b":
        assert whole / 2 < gathered < whole


def test_tensor_parallel_slabs_and_latent_pools(ranks):
    """At tp = 2 a rank's GLA slab is half of one device's and each
    mLSTM slab leaf (state, conv tail) half, the sLSTM's carries whole;
    deepseek's latent pages (whole: one stream for every query head) are
    the same bits on every rank after the engine run."""
    res, _ = ranks
    from repro_torch.serving.memory import PagedStatePool
    for arch in ("gla-2.7b", "xlstm-1.3b"):
        c = _new_cfgs(arch, "fp32")[1]
        pool = PagedStatePool(c, n_pages=2, device="cpu")
        whole = np.asarray([t[0].numel() * t.element_size() for t, sp in
                            zip(pool.pools, pool.paging.specs)
                            if sp.kind == "slab"])
        got = res[0][f"neweng_{arch}_slabs"]
        assert got.shape == whole.shape
        half = got * 2 == whole
        if arch == "gla-2.7b":
            assert half.all()
        else:                    # 7 mLSTM layers' S and conv; 4 sLSTM leaves
            assert half.sum() == 2 * c.pattern.count("mlstm")
            assert (got[~half] == whole[~half]).all()
        print(f"{arch}: a rank's slab {int(got.sum())} of {int(whole.sum())}"
              " bytes")
    latent = sorted(k for k in res[0] if k.startswith("neweng_latent"))
    assert latent
    for r in res[1:]:
        for k in latent:
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)


def _dp_cfg(tag):
    """zamba2's smoke config as the ranks' ``new_cfg`` gives it."""
    q = {"fp32": ("fp32", "nearest", "torch"),
         "sr": ("mx8", "stochastic", "cuda")}[tag]
    return t_smoke("zamba2-2.7b").with_(state_quant=TOPS.StateQuantConfig(*q))


def _dp_single(name, tag, params, cfg=None):
    """The port's single-device engine's run of ``DP_RUNS[name]`` on
    ``params`` (zamba2's: ``cfg`` None), with one intra-op thread as each
    rank runs (a long prefill's BLAS product sums by the thread count)."""
    from repro_torch.serving import engine as TE
    return dp_serve(Engine, TE, params, cfg or _dp_cfg(tag), name,
                    ENGINE_PROMPTS)


def _dp_serve_jax(jparams, name, tag):
    """JAX's single-device engine's run of ``DP_RUNS[name]`` on zamba2's
    weights (the ranks' ``zw``, converted from these): the requests'
    tokens and the logits of every live row at every sampled prefill and
    every decode or verify step, recorded as ``dp_serve`` records the
    port's (the paged engine's decode and verify logits at its non-finite
    scan, which ``nan_guard`` turns on and which changes nothing else;
    ``prefetch_window=0`` as the file's other JAX engines run)."""
    from repro.serving import engine as JE
    kw, reqs, late = DP_RUNS[name]
    slots = kw.get("backend") == "slots"
    extra = {} if slots else dict(prefetch_window=0, nan_guard=True)
    eng = JEngine(jparams, _zcfgs()[tag][0], JServeConfig(**kw, **extra))
    core, seen, real = eng.engine, [], JE._sample_tokens

    def live(x):
        x = np.asarray(x)
        x = x.reshape(x.shape[0], -1, x.shape[-1])
        if x.shape[0] == kw["batch"]:
            on = core.active if slots else [r is not None for r in core.rows]
            x = x[np.asarray(on, bool)]
        seen.append(x.reshape(-1, x.shape[-1]))

    def recording(key, logits, sampling):
        if slots or logits.shape[0] == 1:
            live(logits)
        return real(key, logits, sampling)
    if not slots:
        scan = core._scan_nonfinite
        core._scan_nonfinite = lambda lg: (live(lg), scan(lg))[1]
    JE._sample_tokens = recording
    try:
        hs = [eng.submit(ENGINE_PROMPTS[p], max_new_tokens=n)
              for p, n in reqs]
        if late is not None:
            wait = hs[late[2]].rid
            while wait not in core.active \
                    or core.active[wait].length < late[3]:
                eng.step()
            hs.append(eng.submit(ENGINE_PROMPTS[late[0]],
                                 max_new_tokens=late[1]))
        eng.run()
    finally:
        JE._sample_tokens = real
    return (np.concatenate([np.asarray(h.result().output) for h in hs]),
            np.concatenate(seen))


def _dp_against_jax(key, toks, logits, jx, tag):
    """The data-parallel run ``key`` against JAX's single-device engine
    ``jx``: its tokens, and its logits within the file's JAX bounds (fp32
    state: rtol 1e-4, atol 1e-4 * max|logits|; MX8 SR: |dlogit| < 1e-2)."""
    np.testing.assert_array_equal(toks, jx[0], err_msg=key)
    assert logits.shape == jx[1].shape, key
    print(f"{key}: max |dlogit| from JAX's engine "
          f"{float(np.abs(logits - jx[1]).max()):.3g}")
    if tag == "fp32":
        np.testing.assert_allclose(logits, jx[1], rtol=1e-4,
                                   atol=1e-4 * np.abs(jx[1]).max(),
                                   err_msg=key)
    else:
        assert float(np.abs(logits - jx[1]).max()) < 1e-2, key


@pytest.mark.parametrize("arch", ["gla-2.7b", "zamba2-2.7b"])
def test_tp2_drift_is_the_order_of_the_row_parallel_sums(ranks, arch):
    """The (2, 2) runs at MX8 SR (tp = 2 over the model axis, data rows
    over the other), against one device whose row-parallel sums -- the
    ``wo`` / out-projection and FFN down rows, Mamba-2's gated-norm and
    the mLSTM's gate sums -- are cut into the two ranks' parts and added
    in rank order (``dist.emulate.split_sums``), everything else,
    stochastic rounding included, the whole layer's: bitwise, prefill and
    every decode step.  So the sharded run's drift from one device is the
    order of those sums alone, not an SR counter (the head base of
    ``ops.sr_heads_from``)."""
    from repro_torch.dist.emulate import split_sums
    res, inp = ranks
    if arch == "gla-2.7b":
        got = res[0][f"new_{arch}_2x2_sr"]
        c = _new_cfgs(arch, "sr")[1]
        params = TM.init_model(_new_cfgs(arch, "fp32")[1],
                               torch.Generator().manual_seed(0), device="cpu")
        tok, feed = NEW_IN["tok"], NEW_IN["feed"]
    else:
        got = res[0]["decode_sr"]
        c = _zcfgs()["sr"][1]
        params, tok, feed = inp["zamba2"]["tparams"], inp["tok"], \
            inp["zamba2"]["feed"]
    one = _single_device_decode(c, torch.from_numpy(tok), params, feed)
    with split_sums(params, c, 2) as emulated:
        emu = _single_device_decode(c, torch.from_numpy(tok), emulated, feed)
    print(f"{arch} MX8 SR at (2, 2): |dlogit| from one device "
          f"{float(np.abs(got - one).max()):.3g}, from the emulation "
          f"{float(np.abs(got - emu).max()):.3g}")
    np.testing.assert_array_equal(got, emu)
    assert not np.array_equal(got, one)


@pytest.mark.parametrize("name", list(DP_RUNS))
def test_data_parallel_engines_match_single_device(ranks, name):
    """At (4, 1), two of the 8 decode rows a rank, on zamba2's weights
    from JAX: the engine run's tokens are JAX's single-device engine's
    and the port's on every rank, its live rows' logits (every sampled
    prefill, every decode or verify step) within the file's JAX bounds
    and the same bits on every rank.  At MX8 SR they are bitwise the
    port's single-device engine's, but for the n-gram run's verify steps.
    Those, and every run at fp32 state, are so to rtol 1e-5, atol 1e-5 *
    max|logits|: on an AVX-512 host the CPU's vectorized softplus
    (Mamba-2's dt) rounds a rank's 2 x 8 heads, which fall in its scalar
    tail, otherwise than one device's 8 x 8, and an fp32 state (or the
    verify step's ``y``) keeps the last-bit difference that an MX8 state
    mostly rounds away.  ``paged`` resumes preempted requests on other
    data ranks, ``hit`` adopts a page that another data rank's decode
    step wrote: both move pages between ranks (``dp_moves``)."""
    res, inp = ranks
    for run, tag in DP41:
        if run != name:
            continue
        key = f"dp_4x1_{name}_{tag}"
        toks, logits, st, _ = _dp_single(name, tag, inp["zamba2"]["tparams"])
        for r in res:
            np.testing.assert_array_equal(r[key], toks, err_msg=key)
            np.testing.assert_array_equal(r[key + "_logits"],
                                          res[0][key + "_logits"])
        got = res[0][key + "_logits"]
        _dp_against_jax(key, res[0][key], got, inp["dp_jax"][name, tag], tag)
        print(f"{key}: max |dlogit| {float(np.abs(got - logits).max()):.3g}"
              f", moves {float(res[0][key + '_moves'])}")
        if tag == "sr" and name != "ngram":
            np.testing.assert_array_equal(got, logits, err_msg=key)
        else:
            np.testing.assert_allclose(got, logits, rtol=1e-5,
                                       atol=1e-5 * np.abs(logits).max())
        if name in ("paged", "hit"):
            assert float(res[0][key + "_moves"]) > 0, key
        if name == "paged":
            assert float(res[0][key + "_preempt"]) == st["preemptions"] >= 1
        if name == "hit":
            assert float(res[0][key + "_hits"]) == st["prefix_hits"] == 1


@pytest.mark.parametrize("name", ["slots", "paged", "ngram"])
def test_data_parallel_engines_at_2x2(ranks, name):
    """At (2, 2), data rows over one axis and tp = 2 over the other: the
    tokens of JAX's and of the port's single-device engines, the logits
    within the file's JAX bounds of JAX's engine (fp32 state: rtol 1e-4;
    MX8 SR: 1e-2, ``tests/test_sharding.py``'s bound for a sharded
    decode) and, at MX8 SR, of the port's; every rank the same bits.  The
    one-ulp control of the file's MX8 checks moves these runs' logits
    ~40x less than tp = 2's sum order in every layer does (2.2e-5 against
    8.4e-4), so it bounds nothing here, and the single-device engine
    under the split-sum emulation is not bitwise these runs either
    (``PERF.md`` gives the readings)."""
    res, inp = ranks
    for run, tag in DP22:
        if run != name:
            continue
        key = f"dp_2x2_{name}_{tag}"
        for r in res[1:]:
            np.testing.assert_array_equal(r[key], res[0][key], err_msg=key)
            np.testing.assert_array_equal(r[key + "_logits"],
                                          res[0][key + "_logits"])
        toks, logits, _, _ = _dp_single(name, tag, inp["zamba2"]["tparams"])
        np.testing.assert_array_equal(res[0][key], toks, err_msg=key)
        got = res[0][key + "_logits"]
        _dp_against_jax(key, res[0][key], got, inp["dp_jax"][name, tag], tag)
        if tag == "sr":
            assert got.shape == logits.shape, key
            d_tp = float(np.abs(got - logits).max())
            print(f"{key}: |dlogit| from one device {d_tp:.3g}")
            assert d_tp < 1e-2, key


def _moe_overflows(cfg, n_tokens=8):
    """A wrapper of ``_moe_local`` for one device's run, and the list it
    fills: for each call over ``n_tokens`` tokens (8: a step of the 8
    decode rows), the most entries one expert was given, beside the
    capacity."""
    real, seen = TL._moe_local, []

    def counted(x, router, *a, **k):
        xf = x.reshape(-1, x.shape[-1])
        if xf.shape[0] == n_tokens:
            probs = torch.softmax((xf.float() @ router).float(), -1)
            sel = torch.topk(probs, cfg.moe.top_k, -1).indices
            most = int(torch.bincount(sel.flatten(),
                                      minlength=cfg.moe.n_experts).max())
            seen.append((most, TL.moe_capacity(n_tokens, cfg)))
        return real(x, router, *a, **k)
    return counted, seen


@pytest.mark.parametrize("run", DP_MOE, ids=lambda r: "_".join(r))
def test_data_parallel_moe_routes_the_whole_batch(ranks, run):
    """dbrx at (4, 1): its model axis splits none of its experts, so each
    data rank computes the whole batch and routes it with the whole
    batch's capacity, as JAX's ``apply_moe`` does under GSPMD (a rank's 2
    rows alone would never fill an expert's 4 entries).  A capacity factor
    of 1 overflows an expert at some step of the single-device run, whose
    tokens and logits every rank's equal bitwise."""
    res, _ = ranks
    name, tag = run
    c = t_smoke("dbrx-132b")
    q = {"fp32": ("fp32", "nearest", "torch"),
         "sr": ("mx8", "stochastic", "cuda")}[tag]
    c = c.with_(state_quant=TOPS.StateQuantConfig(*q),
                moe=c.moe.__class__(**{**c.moe.__dict__,
                                       "capacity_factor": DP_MOE_CF}))
    params = TM.init_model(c, torch.Generator().manual_seed(0), device="cpu")
    counted, seen = _moe_overflows(c)
    real = TL._moe_local
    TL._moe_local = counted
    try:
        toks, logits, _, _ = _dp_single(name, tag, params, c)
    finally:
        TL._moe_local = real
    assert any(most > cap for most, cap in seen), seen
    key = f"dp_moe_{name}_{tag}"
    for r in res:
        np.testing.assert_array_equal(r[key], toks, err_msg=key)
        np.testing.assert_array_equal(r[key + "_logits"], logits,
                                      err_msg=key)


def test_data_parallel_bytes_a_rank(ranks):
    """A rank's bytes at (2, 2) against one device's: the slot engine
    holds its 4 of the 8 slots' caches (each leaf a half, the heads tp = 2
    splits a quarter); the paged engine holds every page and slab id, each
    of its heads only (the data axes split rows, not the id space: a
    row's pages move to it when it needs them)."""
    res, _ = ranks
    cfg = _dp_cfg("sr")
    params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    whole = {}
    for name in ("slots", "paged"):
        core = Engine(params, cfg, ServeConfig(**DP_RUNS[name][0])).engine
        held = core.caches if name == "slots" else core.pool.pools
        whole[name] = np.asarray([t.numel() * t.element_size()
                                  for t in T.leaves(held)])
    for name, w in whole.items():
        got = res[0][f"dp_2x2_{name}_sr_bytes"]
        assert got.shape == w.shape
        print(f"{name}: a rank {int(got.sum())} of {int(w.sum())} bytes")
        if name == "slots":
            assert ((got * 2 == w) | (got * 4 == w)).all()
            assert (got * 4 == w).any()
        else:
            assert ((got == w) | (got * 2 == w)).all()


def _train_runs():
    return [f"{a}-{m}" for a, m in TRAIN_RUNS]


def _run_key(run):
    arch, mesh = run.rsplit("-", 1)
    return arch, mesh, f"tt_{arch}_{mesh}"


@pytest.mark.parametrize("run", _train_runs())
def test_tensor_parallel_train_matches_jax(ranks, run):
    """A step and a ``grad_accum=2`` step of the tensor-parallel step
    (each rank its rows and its cut: heads and FFN columns over the model
    axis, sequence-parallel at the layer boundaries) against JAX's
    single-device ``make_train_step`` on the same weights and batch, with
    ``tests/test_sharding.py``'s tolerances: loss within 1e-4, parameters
    within 5e-3; every rank the same losses."""
    res, inp = ranks
    arch, mesh, key = _run_key(run)
    want_l, want_p = inp["train_jax"][arch]
    for r in res:
        for i, want in enumerate(want_l):
            assert abs(float(r[f"{key}_loss{i}"]) - want) < 1e-4, (run, i)
            assert float(r[f"{key}_loss{i}"]) == float(res[0][f"{key}_loss{i}"])
    d = max(float(np.max(np.abs(res[0][f"{key}_p{i}"] - w)))
            for i, w in enumerate(want_p))
    print(run, "losses", [float(res[0][f"{key}_loss{i}"]) for i in (0, 1)],
          "JAX", want_l, "max |dparam|", d)
    assert d < 5e-3, run


def _one_device_grads(arch, cfg=None):
    """The port's single-device loss and gradient of the ranks' first
    step."""
    from repro_torch.train.train_loop import _loss_and_grads, batch_to_device
    tc = cfg or _train_cfgs(arch)[1]
    params = TM.init_model(tc, torch.Generator().manual_seed(0),
                           device="cpu")
    loss, grads = _loss_and_grads(params, tc, batch_to_device(
        _train_batch(arch), "cpu"))
    return params, float(loss), grads


def _grad_excess(got, want, rtol=1e-4, atol=1e-5):
    """How far ``got`` lies past ``rtol`` and ``atol * max|want|`` of
    ``want``, in units of max|want| (<= 0: within)."""
    m = float(want.abs().max()) or 1.0
    over = (torch.from_numpy(got) - want).abs() - (rtol * want.abs()
                                                   + atol * m)
    return float(over.max()) / m


@pytest.mark.parametrize("run", _train_runs())
def test_tensor_parallel_train_gradients_match_one_device(ranks, run):
    """Every leaf's gradient of the first step -- whole for the cut on
    each model rank (a missing f leaves a rank's partial gradient, off by
    about 1 / tp), reduced into the training layout and gathered -- against
    the port's single-device gradient: rtol 1e-4, atol 1e-5 * max|g|, the
    port's gradient contract (``tests/test_torch_train.py``); the leaf's
    path (``wbc``, ``conv_bc_*``, ``wq_a``, ``wkv_a``, the norms...) in the
    message.  xlstm's model gradient sits below fp32's conditioning at this
    size (``test_torch_train.py``): its leaves are held to
    ``CONTROL_FACTOR`` times what moving every weight one ulp does to the
    single-device gradient."""
    res, _ = ranks
    arch, mesh, key = _run_key(run)
    params, loss, grads = _one_device_grads(arch)
    assert abs(float(res[0][key + "_gloss"]) - loss) < 1e-5
    paths = ["/".join(map(str, p)) for p, _ in T.leaves_with_paths(grads)]
    excess = {p: _grad_excess(res[0][f"{key}_g{i}"], g) for i, (p, g) in
              enumerate(zip(paths, T.leaves(grads)))}
    for r in res[1:]:
        for i in range(len(paths)):
            np.testing.assert_array_equal(r[f"{key}_g{i}"],
                                          res[0][f"{key}_g{i}"])
    worst = max(excess, key=excess.get)
    print(run, "worst leaf", worst, f"{excess[worst]:.3g}")
    if arch != "xlstm-1.3b":
        bad = {p: e for p, e in excess.items() if e > 0}
        assert not bad, (run, bad)
        return
    nudged = T.tree_map(lambda w: torch.nextafter(
        w, torch.full_like(w, float("inf"))), params)
    from repro_torch.train.train_loop import _loss_and_grads, batch_to_device
    tc = _train_cfgs(arch)[1]
    _, g_ctl = _loss_and_grads(nudged, tc, batch_to_device(
        _train_batch(arch), "cpu"))

    def rel(a, b):
        return max(float((torch.as_tensor(x) - y).abs().max())
                   / (float(y.abs().max()) or 1.0) for x, y in zip(a, b))
    d_tp = rel([res[0][f"{key}_g{i}"] for i in range(len(paths))],
               T.leaves(grads))
    d_ctl = rel(T.leaves(g_ctl), T.leaves(grads))
    print(run, f"max |dg| / max|g|: tensor-parallel {d_tp:.3g}, one-ulp "
          f"control {d_ctl:.3g}")
    assert d_tp <= CONTROL_FACTOR * d_ctl, run


@pytest.mark.parametrize("run", _train_runs())
def test_sequence_parallelism_holds_a_ranks_positions(ranks, run):
    """Sequence parallelism on (the configs' default) against off: the
    first step's loss within 1e-6; with it on, every layer took a
    residual stream of ``S / tp`` positions (a hook on the element
    forward, the backward's recomputation included)."""
    res, _ = ranks
    arch, mesh, key = _run_key(run)
    tp = int(mesh.split("x")[1])
    for r in res:
        seen = r[key + "_S"]
        assert len(seen) > 0 and (seen == SEQ // tp).all(), (run, seen)
        assert abs(float(r[key + "_gloss"])
                   - float(r[key + "_loss_nosp"])) < 1e-6, run


def test_tensor_parallel_train_replicated_leaves_agree(ranks):
    """After the two steps, the ranks of a model group hold the same bits
    in every leaf the model axis replicates (its local shard: the data
    axes may split it), at (2, 2) and (1, 4)."""
    res, _ = ranks
    for arch, mesh in TRAIN_RUNS:
        key = f"tt_{arch}_{mesh}_rep"
        names = sorted(k for k in res[0] if k.startswith(key))
        assert names, (arch, mesh)
        for rank, r in enumerate(res):
            peer = rank - rank % 2 if mesh == "2x2" else 0
            for k in names:
                np.testing.assert_array_equal(r[k], res[peer][k], err_msg=k)


@pytest.mark.parametrize("tag", ["fp32", "sr"])
def test_sharded_steps_route_a_whole_batch_moe(ranks, tag):
    """dbrx at (4, 1): the model axis splits none of its experts, so the
    sharded prefill + 4 decode steps of 8 rows (two a rank) route the
    MoE over the whole batch, as JAX's ``apply_moe`` does under GSPMD,
    and are bitwise the port's one-device steps; a capacity factor of 1
    overflows an expert at some decode step of the one-device run."""
    res, _ = ranks
    tc = _train_cfgs("dbrx-132b", DP_MOE_CF)[1]
    q = {"fp32": ("fp32", "nearest", "torch"),
         "sr": ("mx8", "stochastic", "cuda")}[tag]
    c = tc.with_(state_quant=TOPS.StateQuantConfig(*q))
    params = TM.init_model(c, torch.Generator().manual_seed(0), device="cpu")
    counted, seen = _moe_overflows(c)
    real = TL._moe_local
    TL._moe_local = counted
    try:
        want = _single_device_decode(c, torch.from_numpy(ROWS["tok"]),
                                     params, ROWS["feed"])
    finally:
        TL._moe_local = real
    assert any(most > cap for most, cap in seen), seen
    for r in res:
        np.testing.assert_array_equal(r[f"moe41_{tag}"], want)


def test_train_step_routes_a_whole_batch_moe(ranks):
    """dbrx's train step at (4, 1), a capacity factor of 1 (an expert of
    the batch's 128 tokens overflows): each rank routes the MoE over the
    whole batch and keeps its rows, so the step matches JAX's
    single-device step (loss within 1e-4, parameters within 5e-3)."""
    res, inp = ranks
    tc = _train_cfgs("dbrx-132b", DP_MOE_CF)[1]
    counted, seen = _moe_overflows(tc, SEQ * BATCH)
    real = TL._moe_local
    TL._moe_local = counted
    try:
        _one_device_grads("dbrx-132b", tc)
    finally:
        TL._moe_local = real
    assert any(most > cap for most, cap in seen), seen
    want_l, want_p = inp["train_jax"]["dbrx-132b"]
    for r in res:
        assert abs(float(r["moe41_train_loss"]) - want_l[0]) < 1e-4
    d = max(float(np.max(np.abs(res[0][f"moe41_train_p{i}"] - w)))
            for i, w in enumerate(want_p))
    print("dbrx (4, 1) train: loss", float(res[0]["moe41_train_loss"]),
          "JAX", want_l[0], "max |dparam|", d)
    assert d < 5e-3


@pytest.mark.parametrize("tag", ["fp32", "sr"])
def test_sharded_steps_route_an_undivided_batch_moe(ranks, tag):
    """dbrx at (4, 1) with 2 rows, which the 4 data ranks do not divide:
    the batch is laid out replicated, every rank holds it whole and routes
    the MoE over it as it is (not 4 copies stacked), so the sharded prefill
    + 4 decode steps are bitwise the port's one-device steps; a capacity
    factor of 1 overflows an expert at the one-device prefill."""
    res, _ = ranks
    tc = _train_cfgs("dbrx-132b", DP_MOE_CF)[1]
    q = {"fp32": ("fp32", "nearest", "torch"),
         "sr": ("mx8", "stochastic", "cuda")}[tag]
    c = tc.with_(state_quant=TOPS.StateQuantConfig(*q))
    params = TM.init_model(c, torch.Generator().manual_seed(0), device="cpu")
    counted, seen = _moe_overflows(c, 2 * ROWS["tok"].shape[1])
    real = TL._moe_local
    TL._moe_local = counted
    try:
        want = _single_device_decode(c, torch.from_numpy(ROWS["tok"][:2]),
                                     params, ROWS["feed"][:, :2])
    finally:
        TL._moe_local = real
    assert any(most > cap for most, cap in seen), seen
    for r in res:
        np.testing.assert_array_equal(r[f"moe41b2_{tag}"], want)


def test_train_step_routes_an_undivided_batch_moe(ranks):
    """dbrx's train step at (4, 1) on 2 rows, laid out replicated (the 4
    data ranks do not divide them): each rank routes the whole batch as it
    is, each loss weighted by a quarter, so the step matches the port's
    one-device step (loss within 1e-6, parameters within 1e-6); a
    capacity factor of 1 overflows an expert of the batch's 64 tokens."""
    from repro_torch.train.train_loop import batch_to_device
    res, _ = ranks
    tc = _train_cfgs("dbrx-132b", DP_MOE_CF)[1]
    params = TM.init_model(tc, torch.Generator().manual_seed(0),
                           device="cpu")
    opt = TO.OptimizerConfig(lr=1e-3)
    b2 = batch_to_device(make_batch_fn(tc, SEQ, 2)(0), "cpu")
    counted, seen = _moe_overflows(tc, 2 * SEQ)
    real = TL._moe_local
    TL._moe_local = counted
    try:
        want_p, _, m = make_train_step(tc, opt)(
            params, TO.init_opt_state(params, opt), b2)
    finally:
        TL._moe_local = real
    assert any(most > cap for most, cap in seen), seen
    for r in res:
        assert abs(float(r["moe41b2_train_loss"]) - float(m["loss"])) < 1e-6
        d = max(float(np.max(np.abs(r[f"moe41b2_train_p{i}"] - w.numpy())))
                for i, w in enumerate(T.leaves(want_p)))
        assert d < 1e-6, d


def test_gradient_compression_error_feedback(ranks):
    res, inp = ranks
    grads = inp["grads"]
    ef0 = np.zeros((WORLD,) + grads.shape[1:], np.float32)
    red_j, ef_j = jax.vmap(lambda g, e: JCOMP.compressed_allreduce_mean(
        {"w": g}, {"w": e}, "pod"), axis_name="pod")(
        jnp.asarray(grads), jnp.asarray(ef0))
    for r in range(WORLD):
        np.testing.assert_allclose(res[r]["comp_red"],
                                   np.asarray(red_j["w"][r]), rtol=1e-6,
                                   atol=1e-7)
        # the residual is the rank's own: bitwise JAX's
        np.testing.assert_array_equal(res[r]["comp_ef"],
                                      np.asarray(ef_j["w"][r]))
    exact = grads.mean(0)
    err = float(np.max(np.abs(res[0]["comp_red"] - exact)))
    step = float(np.abs(grads).max()) / 127
    print("ERR", err, "STEP", step)
    assert err < 4 * step
    assert float(np.max(np.abs(res[0]["comp_ef"]))) > 0


def test_checkpoint_elastic_mesh_reshard(ranks):
    res, _ = ranks
    cfg = t_smoke("smollm-360m")
    params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    leaves = T.leaves(params)
    for tag in ("4x1", "1x4"):
        for r in res:
            assert int(r[f"ckpt_step_{tag}"]) == 7
            for i, p in enumerate(leaves):
                np.testing.assert_array_equal(r[f"ckpt_{tag}_{i}"],
                                              p.numpy())
        # each rank holds a quarter of the sharded leaves, not all of them
        assert int(res[0][f"ckpt_local_{tag}"].sum()) < sum(
            p.numel() for p in leaves)


def test_a_dim_over_two_axes_is_sharded_major_to_minor(ranks):
    """``Spec(("data", "model"))`` on a (2, 2) mesh: rank (i, j) holds
    chunk ``i * 2 + j``, the device order of JAX's ``P(("data",
    "model"))``."""
    res, _ = ranks
    for r in range(WORLD):
        d_i, m_i = _coord(r)
        chunk = d_i * 2 + m_i
        np.testing.assert_array_equal(res[r]["major_minor"],
                                      [2 * chunk, 2 * chunk + 1])
