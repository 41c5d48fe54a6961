"""Tensor-parallel training's pieces in one process: the collectives of
``repro_torch/dist/tp.py`` at tp = 1 (a one-rank gloo group), the
single-device ``train_loss`` unchanged by them, and the dry run's train
cell on the tensor-parallel step.

* every f / g / sequence / row collective is the identity at tp = 1,
  forward and backward, bitwise (``tp_sum``, ``tp_sum_split``,
  ``tp_copy``, ``tp_enter``, ``seq_gather``, ``seq_whole``, ``seq_local``,
  ``rows_whole``, ``rows_local``, ``model_gather``), and ``seq_par`` is
  None there;
* ``train_loss`` without ``par`` is bitwise the plain path's (the layers
  without any tensor-parallel argument, then the final norm and the
  chunked cross-entropy), loss and every gradient, and so is
  ``train_loss`` with a (1, 1) mesh's ``par``;
* the dry run's zamba2-2.7b ``train_4k`` cell (smoke widths, a (2, 4)
  fake mesh) counts fewer FLOPs a rank than the single-device step on
  its rows, what the train cells counted while the step replicated the
  model axis (its 8 Mamba-2 heads and 32 attention heads divide 4);
* an attention-free cell's link bytes, taken at its 4,096 positions from
  traces at ``PROBE_SEQ`` and half of it, are those of a trace at 4,096.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_smoke_config
from repro_torch.core import tree as T
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.dist import tp as TP
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import local_init_method, make_local_parallel
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import SHAPES
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import batch_to_device, make_train_step

torch.set_num_threads(1)  # test workers share the cores: one thread each

ARCHS = ("llama3.2-1b", "zamba2-2.7b", "xlstm-1.3b", "deepseek-v2-236b",
         "dbrx-132b")


@pytest.fixture
def one_rank():
    """A (1, 1) ``Parallel`` over a gloo group of this one process,
    destroyed after the test (the dry run needs a process free of one)."""
    dist.init_process_group("gloo", init_method=local_init_method(),
                            rank=0, world_size=1)
    try:
        yield make_local_parallel(1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _identity_both_ways(fn, x):
    """``fn(x)``'s value and its backward of a random cotangent, which the
    identity gives back as they are."""
    x = x.clone().requires_grad_(True)
    y = fn(x)
    cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(3))
    (g,) = torch.autograd.grad(y, x, cot)
    return y.detach(), g, cot


@pytest.mark.parametrize("name", ["tp_sum", "tp_sum_split", "tp_copy",
                                  "tp_enter0", "tp_enter1", "seq_gather",
                                  "seq_whole", "seq_local", "rows_whole",
                                  "rows_local", "model_gather"])
def test_collectives_are_the_identity_at_tp_1(one_rank, name):
    par = one_rank
    fns = {"tp_enter0": lambda x: TP.tp_enter(x, par)[0],
           "tp_enter1": lambda x: TP.tp_enter(x, par)[1],
           "model_gather": lambda x: TP.model_gather(x, 1, par)}
    fn = fns.get(name, lambda x: getattr(TP, name)(x, par))
    x = torch.randn((2, 6, 5), generator=torch.Generator().manual_seed(1))
    x[0, 0, 0] = -0.0
    y, g, cot = _identity_both_ways(fn, x)
    assert torch.equal(y, x) and torch.equal(y.signbit(), x.signbit())
    assert torch.equal(g, cot)
    # without par too (the single-device model's calls)
    if name in ("tp_sum", "tp_sum_split", "tp_copy"):
        assert getattr(TP, name)(x, None) is x
    assert TP.seq_par(par, 6) is None and TP.seq_par(None, 6) is None


def _plain_loss(params, cfg, batch):
    """The training objective through the plain path: every layer with no
    tensor-parallel, row or sequence argument."""
    x, positions, prefix_len = M.embed_inputs(params, cfg, batch)
    x, _ = M._run_blocks(params, x, cfg, positions, prefix_len,
                         want_cache=False)
    x = L.apply_norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    return L.chunked_softmax_xent(x, M._lm_head(params, cfg),
                                  batch["targets"],
                                  batch["mask"].to(torch.float32),
                                  cfg.logit_chunk)


def _loss_grads(fn, params):
    leaves = [p.detach().requires_grad_(True) for p in T.leaves(params)]
    loss = fn(T.unflatten(params, leaves))
    return loss.detach(), torch.autograd.grad(loss, leaves,
                                              allow_unused=True,
                                              materialize_grads=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_without_par_is_the_plain_path(one_rank, arch):
    cfg = get_smoke_config(arch)
    params = M.init_model(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    batch = batch_to_device(make_batch_fn(cfg, 32, 2)(0), "cpu")
    want = _loss_grads(lambda p: _plain_loss(p, cfg, batch), params)
    for par in (None, one_rank):
        got = _loss_grads(lambda p: M.train_loss(p, cfg, batch, par=par),
                          params)
        assert torch.equal(got[0], want[0]), par
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1])), par


def test_one_rank_mesh_train_step_is_the_plain_step(one_rank):
    """``make_train_step`` over the (1, 1) mesh: the loss and parameters
    of the single-device step, bitwise (the cut is the whole tree)."""
    from repro_torch.dist import sharding as SH
    cfg = get_smoke_config("zamba2-2.7b")
    opt = O.OptimizerConfig(lr=1e-3)
    params = M.init_model(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    state = O.init_opt_state(params, opt)
    batch = make_batch_fn(cfg, 32, 2)(0)
    p1, _, m1 = make_train_step(cfg, opt)(params, state, batch)
    lay = SH.param_shardings(params, cfg, one_rank)
    p2, _, m2 = make_train_step(cfg, opt, par=one_rank)(
        SH.distribute(params, lay), SH.distribute(
            state, SH.opt_state_shardings(state, lay, one_rank)), batch)
    assert torch.equal(m1["loss"], m2["loss"])
    assert all(torch.equal(a, b.to_local())
               for a, b in zip(T.leaves(p1), T.leaves(p2)))


def test_dryrun_train_cell_counts_the_tensor_parallel_step():
    """Its Mamba-2 chunk widened to the sequence to keep the trace short (the
    count of one config against the same config)."""
    cfg = D.dryrun_config("zamba2-2.7b", smoke=True)
    cfg = cfg.with_(ssm=dataclasses.replace(cfg.ssm, chunk=4096))
    rec = D.lower_cell("zamba2-2.7b", "train_4k", smoke=True, mesh=(2, 4),
                       verbose=False, cfg_overrides={"ssm": cfg.ssm})
    cfg_t, sc_t, scale = D.trace_setup(cfg, SHAPES["train_4k"])
    sc_t = dataclasses.replace(sc_t, global_batch=sc_t.global_batch // 2)
    # the single-device step on a rank's rows: the train cells' count when
    # every model rank computed the whole model
    with D.fake_mode(), FlopCounterMode(display=False) as counter:
        params = D._fake(SP.params_struct(cfg_t))
        opt = O.OptimizerConfig()
        make_train_step(cfg_t, opt, grad_accum=rec["tuning"].get(
            "grad_accum", 1))(params, O.init_opt_state(params, opt),
                              D._fake(SP.batch_struct(cfg_t, sc_t)))
    replicated = float(counter.get_total_flops()) * scale
    print("flops_per_chip", rec["flops_per_chip"], "replicated", replicated)
    assert 0 < rec["flops_per_chip"] < replicated
    assert rec["trace_diag"]["collectives"].get("all_reduce", 0) > 0


def test_dryrun_link_bytes_at_the_full_sequence(monkeypatch):
    """mamba2-2.7b's ``train_4k`` cell (smoke widths, a (2, 4) fake mesh,
    its chunk widened to keep the traces short): traced at ``PROBE_SEQ``
    = 1,024 and 512 positions, each kind's link bytes on the line through
    both at 4,096 are those of the cell traced at its 4,096 positions
    (``PROBE_SEQ`` raised to 4,096: no scaling)."""
    cfg = D.dryrun_config("mamba2-2.7b", smoke=True)
    over = {"ssm": dataclasses.replace(cfg.ssm, chunk=512)}
    rec = {}
    for probe in (1024, 4096):
        monkeypatch.setattr(D, "PROBE_SEQ", probe)
        rec[probe] = D.lower_cell("mamba2-2.7b", "train_4k", smoke=True,
                                  mesh=(2, 4), verbose=False,
                                  cfg_overrides=over)
    assert rec[1024]["probe"]["seq_scale"] == 4.0
    assert rec[4096]["probe"]["seq_scale"] == 1.0
    got, want = (rec[p]["trace_diag"]["link_bytes"] for p in (1024, 4096))
    assert set(got) == set(want) and want["all_gather_into_tensor"] > 0
    for kind, v in want.items():
        assert got[kind] == pytest.approx(v, rel=1e-12), kind
    assert rec[1024]["link_bytes_per_chip"] == pytest.approx(
        rec[4096]["link_bytes_per_chip"], rel=1e-12)
