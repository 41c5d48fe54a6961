"""The train launcher on a CPU mesh (``--mesh 2x2 --host-devices 4``, four
gloo ranks in one spawn) and the dry run on fake meshes: a train cell of an
attention model, a prefill cell of an SSM and a decode cell of an MoE model
at smoke size on a fake (2, 4) mesh, and one cell on the fake production
(16, 16) mesh.  A cell's record has the JAX dry run's keys where the port
has a counterpart, plus ``analytic`` and ``sources``; its traced FLOPs are
``FlopCounterMode``'s count of the single-device step on the rank's rows
(an expert-parallel MoE: on its model shard's experts; a serving cell:
the tensor-parallel step of the rank's heads and FFN columns); its link
bytes
are its traced collectives' (counted as a test here checks on known
collectives), and ``analytic_cost`` is the JAX function's."""
import dataclasses
import re
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import subprocess_env
from repro.analysis import roofline as JRL
from repro.configs import get_smoke_config as j_smoke
from repro import ops as JOPS
from repro.models.config import SHAPES as J_SHAPES
from repro_torch.analysis import roofline as RL
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as SP
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import SHAPES
from repro_torch.train import optimizer as TO
from repro_torch.train.train_loop import make_train_step

torch.set_num_threads(1)  # test workers share the cores: one thread each


def test_train_launcher_on_a_cpu_mesh():
    args = ["--arch", "smollm-360m", "--smoke-size", "--device", "cpu",
            "--steps", "2", "--seq-len", "32", "--global-batch", "4"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args, "--mesh",
         "2x2", "--host-devices", "4"], capture_output=True, text=True,
        timeout=300, env=subprocess_env(OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert re.fullmatch(r"arch=\S+ params=[\d.]+M device=cpu mesh=2x2",
                        lines[0]), lines[0]
    assert re.match(r"done: loss [\d.]+ -> [\d.]+", lines[-1]), lines[-1]
    # rank 0 alone prints
    assert sum(ln.startswith("arch=") for ln in lines) == 1
    got = [float(v) for v in next(ln for ln in lines
                                  if ln.startswith("losses ")).split()[1:]]
    # the single-device step from the launcher's weights and schedule
    cfg = t_smoke("smollm-360m")
    opt = TO.OptimizerConfig(lr=3e-4, total_steps=2, warmup_steps=1)
    params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    state = TO.init_opt_state(params, opt)
    step = make_train_step(cfg, opt)
    batch_fn = make_batch_fn(cfg, 32, 4)
    want = []
    for s in range(2):
        params, state, m = step(params, state, batch_fn(s))
        want.append(float(m["loss"]))
    assert len(got) == 2
    assert max(abs(a - b) for a, b in zip(got, want)) < 1e-4, (got, want)


def test_launcher_refuses_a_mesh_it_cannot_build():
    from repro_torch.launch import train
    for bad in (["--mesh", "2x2", "--host-devices", "3"],
                ["--host-devices", "4"],
                ["--mesh", "2x2", "--host-devices", "4", "--device", "cuda"]):
        with pytest.raises(SystemExit):
            train.main(["--arch", "smollm-360m", "--smoke-size", *bad])


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def test_importing_the_dry_run_creates_no_process_group():
    """The import walk imports every module in one process: the dry run
    makes its fake group per cell, never at import."""
    proc = subprocess.run(
        [sys.executable, "-c", "import torch.distributed as d; "
         "import repro_torch.launch.dryrun, repro_torch.launch.mesh; "
         "assert not d.is_initialized(); print('clean')"],
        capture_output=True, text=True, timeout=120, env=subprocess_env())
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr

_KEYS = {"arch", "shape", "multi_pod", "status", "n_chips", "n_params",
         "kind", "tuning", "serve_2d", "flops_per_chip",
         "hbm_bytes_per_chip", "link_bytes_per_chip", "cache_bytes_total",
         "trace_diag", "probe", "memory", "roofline", "model_flops",
         "elapsed_s", "analytic", "sources"}

# (arch, shape, config overrides): an attention model's train cell, an
# SSM's prefill cell (its chunk widened to keep the trace short: the count
# of one config against the same config), an MoE model's decode cell
CELLS = [("llama3.2-1b", "train_4k", {}),
         ("mamba2-2.7b", "prefill_32k", {"chunk": 128}),
         ("dbrx-132b", "decode_32k", {})]


def _cfg(arch, over):
    cfg = D.dryrun_config(arch, smoke=True)
    if "chunk" in over:
        cfg = cfg.with_(ssm=dataclasses.replace(cfg.ssm, chunk=over["chunk"]))
    return cfg


def _single_device_flops(cfg, sc, rows, ep_shards=1, tp=1):
    """``FlopCounterMode``'s count of the single-device step on ``rows``
    of the batch (fake tensors; an MoE's dispatch on ``1 / ep_shards`` of
    its experts, as an expert-parallel rank computes).  With ``tp`` > 1:
    the tensor-parallel step of model rank 0 on its ``tp_params`` (a
    decode cell: and its heads' caches; a train cell: the loss and its
    gradient, as AdamW counts no FLOPs), over a shape-only model axis of
    ``tp`` ranks, its collectives over that axis left out (they count no
    FLOPs, and sequence parallelism changes no product; an MoE's expert
    shard is then ``ep_shards``' count)."""
    from repro_torch.dist import sharding as SH
    from repro_torch.dist import tp as TP
    from repro_torch.train.train_loop import _loss_and_grads
    par = None
    stubs = dict(tp_sum=lambda x, p: x, tp_sum_split=lambda x, p: x,
                 tp_copy=lambda x, p: x, tp_enter=lambda x, p: (x, x),
                 seq_par=lambda p, S: None,
                 expert_parallel=lambda c, p: False)
    if tp > 1:
        par = SH.Parallel(SH.AbstractMesh((tp,), ("model",)), data_axes=())
        orig = {k: getattr(TP, k) for k in stubs}
        for k, v in stubs.items():
            setattr(TP, k, v)
    if ep_shards > 1:
        dispatch = TL._moe_dispatch_compute

        def local(x, sel, w, wi, wg, wo, cap, e_offset=0):
            n = wi.shape[0] // ep_shards
            return dispatch(x, sel, w, wi[:n], wg[:n], wo[:n], cap)
        TL._moe_dispatch_compute = local
    sc = dataclasses.replace(sc, global_batch=rows)
    try:
        with D.fake_mode(), FlopCounterMode(display=False) as counter:
            params = D._fake(SP.params_struct(cfg))
            if par is not None:
                params = SH.tp_params(params, cfg, par)
            if sc.kind == "train" and par is not None:
                _loss_and_grads(params, cfg, D._fake(SP.batch_struct(
                    cfg, sc)), par=par)
            elif sc.kind == "train":
                opt = TO.OptimizerConfig()
                batch = D._fake(SP.batch_struct(cfg, sc))
                make_train_step(cfg, opt)(params, TO.init_opt_state(
                    params, opt), batch)
            elif sc.kind == "prefill":
                batch = D._fake(SP.batch_struct(cfg, sc))
                batch.pop("targets")
                TM.prefill(params, cfg, batch, par=par)
            else:
                tok, lengths, caches = (D._fake(t) for t in
                                        SP.decode_struct(cfg, sc))
                if par is not None:         # the rank's heads' caches
                    caches = D._fake(TM.init_decode_caches(
                        cfg, rows, -(-sc.seq_len // 128) * 128, "meta",
                        par))
                TM.decode_step(params, cfg, tok, caches, lengths, par=par)
    finally:
        if ep_shards > 1:
            TL._moe_dispatch_compute = dispatch
        if par is not None:
            for k, v in orig.items():
                setattr(TP, k, v)
    return float(counter.get_total_flops())


@pytest.mark.parametrize("arch,shape,over", CELLS,
                         ids=[f"{a}-{s}" for a, s, _ in CELLS])
def test_dryrun_cell_on_a_fake_mesh(arch, shape, over):
    cfg = _cfg(arch, over)
    rec = D.lower_cell(arch, shape, smoke=True, mesh=(2, 4), verbose=False,
                       cfg_overrides={"ssm": cfg.ssm} if over else None)
    assert set(rec) == _KEYS and rec["status"] == "ok"
    assert rec["n_chips"] == 8 and rec["memory"]["temp_bytes"] is None
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["trace_diag"]["n_collectives"] > 0
    assert rec["trace_diag"]["unsized_collectives"] == 0
    assert rec["link_bytes_per_chip"] == sum(
        rec["trace_diag"]["link_bytes"].values()) > 0
    assert rec["roofline"]["t_collective_s"] == pytest.approx(
        rec["link_bytes_per_chip"] / RL.LINK_BW, rel=1e-12)
    assert set(rec["roofline"]) == {"t_compute_s", "t_memory_s",
                                    "t_collective_s", "bottleneck",
                                    "useful_flops_frac"}
    sc = SHAPES[shape]
    cfg_trace, sc_trace, scale = D.trace_setup(cfg, sc)
    assert rec["probe"] == {"traced_flops": rec["flops_per_chip"] / scale,
                            "seq_scale": scale}
    ep = 4 if cfg.moe is not None else 1
    want = _single_device_flops(cfg_trace, sc_trace, sc.global_batch // 2,
                                ep, tp=4)
    assert rec["probe"]["traced_flops"] == want > 0
    # every step is tensor-parallel: it sums over the model axis
    assert rec["trace_diag"]["collectives"].get("all_reduce", 0) > 0
    # fewer FLOPs where tp splits heads or FFN columns; dbrx's 2 kv heads
    # at tp = 4 replicate and its FFN is an MoE, so its step is the whole
    # one (its experts aside)
    whole = _single_device_flops(cfg_trace, sc_trace, sc.global_batch // 2,
                                 ep)
    split = ("mamba2" in cfg.pattern or cfg.n_kv_heads % 4 == 0
             or (cfg.ffn_kind not in ("moe", "none") and cfg.d_ff % 4 == 0))
    assert want < whole if split else want == whole
    # the memory and link terms are the JAX package's function, on the JAX
    # dry run's config
    jcfg = j_smoke(arch).with_(
        param_dtype="bfloat16", scan_layers=True, remat=True,
        state_quant=JOPS.StateQuantConfig("mx8", "stochastic", "jnp"))
    if over:
        jcfg = jcfg.with_(ssm=dataclasses.replace(jcfg.ssm, **over))
    kw = dict(chips=8, tp=4, fs=2, pods=1, n_params=rec["n_params"])
    want_ac = JRL.analytic_cost(jcfg, J_SHAPES[shape], **kw)
    assert RL.analytic_cost(cfg, sc, **kw) == pytest.approx(want_ac,
                                                             rel=1e-12)
    ac = RL.analytic_cost(cfg, sc, **kw)
    assert rec["hbm_bytes_per_chip"] == ac["hbm_bytes"]
    assert rec["analytic"] == {"hbm_bytes_per_chip": ac["hbm_bytes"],
                               "link_bytes_per_chip": ac["link_bytes"]}
    assert set(rec["sources"]) <= set(rec)


def test_collective_bytes_at_the_ring_count():
    """:class:`CommBytesMode` on known collectives of a fake (2, 4) mesh:
    an all-gather over 'data' of a 1 KiB shard moves 1 KiB (its one
    peer's shard), a reduce-scatter over 'data' of 2 KiB moves 1 KiB, an
    all-reduce over 'model' of 2 KiB moves 2 * 3/4 of it."""
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import make_local_parallel
    with D.fake_world(8):
        par = make_local_parallel(2, 4, device_type="cpu")
        mesh = par.mesh
        with D.fake_mode(), D.CommBytesMode() as comm:
            x = SH.distribute(torch.empty(16, 32), par.named(("data", None)))
            SH.gather(x)
            SH.DTensor.from_local(torch.empty(16, 32), mesh, (
                SH.Partial(), SH.Replicate()), run_check=False).redistribute(
                mesh, (SH.Shard(0), SH.Replicate()))
            SH.DTensor.from_local(torch.empty(16, 32), mesh, (
                SH.Replicate(), SH.Partial()),
                run_check=False).full_tensor()
    assert comm.link_bytes == {"all_gather_into_tensor": 1024.0,
                               "reduce_scatter_tensor": 1024.0,
                               "all_reduce": 3072.0}
    assert comm.sized == 3


def test_dryrun_on_the_fake_production_mesh():
    """A train cell over the production (16, 16) mesh: 256 fake ranks."""
    rec = D.lower_cell("smollm-360m", "train_4k", smoke=True, verbose=False)
    assert rec["n_chips"] == 256 and set(rec) == _KEYS
    kinds = rec["trace_diag"]["collectives"]
    # ZeRO: parameters gathered, gradients reduce-scattered
    assert kinds.get("all_gather_into_tensor", 0) > 0
    assert kinds.get("reduce_scatter_tensor", 0) > 0
    cfg, sc, _ = D.trace_setup(D.dryrun_config("smollm-360m", smoke=True),
                               SHAPES["train_4k"])
    want = _single_device_flops(cfg, sc, 256 // 16, tp=16)
    assert rec["flops_per_chip"] == want
    assert not torch.distributed.is_initialized()
