"""The port's cost models -- ``core/pimsim.py`` and ``analysis/roofline.py``
-- against the JAX package's, on the same inputs.

Contracts:

* every pimsim function equals the JAX one (rtol 1e-12) for each
  ``PAPER_MODELS`` entry, each system of ``SYSTEM_FMT``, each design, batch
  1 / 32 / 128 and seq_len 512 / 2048 (both are arithmetic over the ops'
  ``traffic(plan)``);
* the three pimsim tests of ``tests/test_substrates.py`` (Fig. 5 ratios,
  Fig. 12 ordering, batch scaling) hold on the port;
* ``StateWorkload.state_bytes`` and ``_cache_state_bytes`` are the port
  registry's traffic (``tests/test_ops_registry.py``'s two tests);
* ``analytic_cost`` equals JAX's for every config, kind train / prefill /
  decode, both layouts, and a few (chips, tp, fs, pods);
* ``parse_collectives`` equals JAX's on synthetic HLO text;
* ``count_params`` over the port's parameter tree (``params_from_jax``)
  equals JAX's over the same shapes;
* the roofline's terms use the H100's constants.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.analysis import roofline as JRL
from repro.configs import ALL_ARCHS as J_ARCHS
from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.core import pimsim as JPS
from repro.models import config as JC
from repro.models import model as JM
from repro_torch import ops as TOPS
from repro_torch.analysis import roofline as TRL
from repro_torch.configs import ALL_ARCHS as T_ARCHS
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import pimsim as TPS
from repro_torch.models import config as TC
from repro_torch.models.convert import params_from_jax

torch.set_num_threads(1)  # test workers share the cores: one thread each

BATCHES = (1, 32, 128)
SEQS = (512, 2048)
DESIGNS = ("time_multiplexed", "pipelined", "pimba")
RTOL = 1e-12


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    else:
        assert a == pytest.approx(b, rel=RTOL, abs=0.0), (a, b)


# ---------------------------------------------------------------------------
# pimsim
# ---------------------------------------------------------------------------

def test_pimsim_tables_equal_jax():
    assert TPS.SYSTEM_FMT == JPS.SYSTEM_FMT
    assert TPS.PAPER_MODELS.keys() == JPS.PAPER_MODELS.keys()
    for name in TPS.PAPER_MODELS:
        assert dataclasses.asdict(TPS.PAPER_MODELS[name]) == \
            dataclasses.asdict(JPS.PAPER_MODELS[name])
    assert (TPS.GPU_STATE_PASSES, TPS.GPU_ATTN_PASSES) == \
        (JPS.GPU_STATE_PASSES, JPS.GPU_ATTN_PASSES)
    assert dataclasses.asdict(TPS.SystemConfig()) == \
        dataclasses.asdict(JPS.SystemConfig())


@pytest.mark.parametrize("name", sorted(JPS.PAPER_MODELS))
def test_pimsim_equals_jax(name):
    """Every entry point, every system, design, batch and length."""
    tsys, jsys = TPS.SystemConfig(), JPS.SystemConfig()
    ts, js = TPS.PAPER_MODELS[name], JPS.PAPER_MODELS[name]
    for system, fmt in JPS.SYSTEM_FMT.items():
        for b in BATCHES:
            if js.n_layers:
                tw = TPS.StateWorkload(b, ts.n_layers, ts.n_heads, ts.dk,
                                       ts.dv, fmt)
                jw = JPS.StateWorkload(b, js.n_layers, js.n_heads, js.dk,
                                       js.dv, fmt)
                _close(tw.state_bytes, jw.state_bytes)
                _close(tw.flops, jw.flops)
                _close(TPS.gpu_state_update_latency(tw, tsys),
                       JPS.gpu_state_update_latency(jw, jsys))
                _close(TPS._bursts_per_device(tw, tsys),
                       JPS._bursts_per_device(jw, jsys))
                for design in DESIGNS:
                    _close(TPS.pim_state_update_latency(tw, tsys, design),
                           JPS.pim_state_update_latency(jw, jsys, design))
            for s in SEQS:
                _close(TPS.generation_step_latency(ts, b, s, tsys, system),
                       JPS.generation_step_latency(js, b, s, jsys, system))
                _close(TPS.generation_throughput(ts, b, s, tsys, system),
                       JPS.generation_throughput(js, b, s, jsys, system))
                for k in (1, 3):
                    _close(TPS.spec_verify_step_latency(ts, b, s, k, tsys,
                                                        system),
                           JPS.spec_verify_step_latency(js, b, s, k, jsys,
                                                        system))
                    _close(TPS.spec_generation_throughput(
                        ts, b, s, k, 0.7, tsys, system),
                        JPS.spec_generation_throughput(
                            js, b, s, k, 0.7, jsys, system))


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_state_workload_paged_layout_equals_jax(layout):
    for fmt in ("fp16", "int8", "mx8"):
        tw = TPS.StateWorkload(8, 4, 2, 64, 32, fmt, layout)
        jw = JPS.StateWorkload(8, 4, 2, 64, 32, fmt, layout)
        assert tw.plan.layout == layout
        _close(tw.state_bytes, jw.state_bytes)


def test_expected_tokens_per_spec_step_equals_jax():
    for k in (0, 1, 3, 7):
        for a in (0.0, 0.3, 0.7, 1.0):
            _close(TPS.expected_tokens_per_spec_step(k, a),
                   JPS.expected_tokens_per_spec_step(k, a))
    with pytest.raises(AssertionError):
        TPS.expected_tokens_per_spec_step(3, 1.5)


def test_unknown_design_raises():
    w = TPS.StateWorkload(1, 1, 1, 64, 64)
    with pytest.raises(ValueError):
        TPS.pim_state_update_latency(w, TPS.SystemConfig(), "systolic")


# tests/test_substrates.py, mirrored on the port

def test_pimsim_fig5_ratios():
    sys_cfg = TPS.SystemConfig()
    spec = TPS.PAPER_MODELS["retnet-2.7b"]
    w = TPS.StateWorkload(128, spec.n_layers, spec.n_heads, spec.dk, spec.dv,
                          "fp16")
    t_gpu = TPS.gpu_state_update_latency(w, sys_cfg)
    tm = t_gpu / TPS.pim_state_update_latency(w, sys_cfg, "time_multiplexed")
    pl = t_gpu / TPS.pim_state_update_latency(w, sys_cfg, "pipelined")
    assert 2.3 < tm < 3.3, f"time-mux {tm} (paper: 2.8x)"
    assert 3.6 < pl < 5.0, f"pipelined {pl} (paper: 4.3x)"


def test_pimsim_fig12_throughput_ordering():
    sys_cfg = TPS.SystemConfig()
    for name in ("retnet-2.7b", "mamba2-2.7b", "zamba2-7b"):
        spec = TPS.PAPER_MODELS[name]
        th = {s: TPS.generation_throughput(spec, 128, 2048, sys_cfg, s)
              for s in ("gpu", "gpu_q", "gpu_pim", "pimba")}
        assert th["gpu"] < th["gpu_q"] <= th["gpu_pim"] < th["pimba"], \
            (name, th)
        assert th["pimba"] / th["gpu"] <= 4.5   # paper: up to 4.1x
        assert th["pimba"] / th["gpu_pim"] <= 2.4  # paper: up to 2.1x


def test_pimsim_batch_scaling():
    """State-update fraction grows with batch (paper Fig. 3 trend)."""
    sys_cfg = TPS.SystemConfig()
    spec = TPS.PAPER_MODELS["retnet-2.7b"]
    fracs = []
    for b in (32, 128):
        lat = TPS.generation_step_latency(spec, b, 2048, sys_cfg, "gpu")
        fracs.append(lat["state"] / lat["total"])
    assert fracs[1] > fracs[0]
    assert fracs[1] > 0.5           # paper: 73.8% at batch 128


# tests/test_ops_registry.py, mirrored on the port

def test_pimsim_bytes_sourced_from_op_traffic():
    """The timing model's workload bytes ARE the registered op's traffic."""
    w = TPS.StateWorkload(8, 4, 2, 64, 32, "mx8")
    assert w.plan.backend == "torch"
    t = TOPS.traffic(w.plan)
    assert w.state_bytes == pytest.approx(w.n_layers * t.state_read)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_roofline_bytes_sourced_from_op_traffic(layout):
    cfg = t_smoke("zamba2-2.7b")
    sc = TC.ShapeConfig("probe", 256, 4, "decode")
    by_kind = TOPS.decode_traffic_by_kind(cfg, sc.global_batch, sc.seq_len,
                                          layout)
    kv, state = TRL._cache_state_bytes(cfg, sc, layout)
    assert state == pytest.approx(by_kind["state_update"].state_read)
    assert kv == pytest.approx(by_kind["attn_decode"].state_read)
    jkv, jstate = JRL._cache_state_bytes(j_smoke("zamba2-2.7b"), sc, layout)
    assert (kv, state) == (jkv, jstate)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

def test_h100_constants_and_terms():
    assert (TRL.PEAK_FLOPS, TRL.HBM_BW, TRL.LINK_BW, TRL.PEAK_FP32_FLOPS) \
        == (989e12, 3.35e12, 450e9, 67e12)
    r = TRL.Roofline(flops_per_chip=989e12, hbm_bytes_per_chip=6.7e12,
                     link_bytes_per_chip=45e9, model_flops=494.5e12)
    assert (r.t_compute, r.t_memory, r.t_collective) == \
        pytest.approx((1.0, 2.0, 0.1))
    assert r.bottleneck == "memory" and r.t_bound == pytest.approx(2.0)
    assert r.useful_flops_frac == pytest.approx(0.5)
    assert r.row()["bottleneck"] == "memory"
    assert TRL._DTYPE_BYTES == JRL._DTYPE_BYTES
    assert TRL.model_flops_train(7e9, 1e6) == JRL.model_flops_train(7e9, 1e6)
    assert TRL.model_flops_decode(7e9, 128) == \
        JRL.model_flops_decode(7e9, 128)


def test_shape_configs_equal_jax():
    assert TC.SHAPES.keys() == JC.SHAPES.keys()
    for k in TC.SHAPES:
        assert dataclasses.asdict(TC.SHAPES[k]) == \
            dataclasses.asdict(JC.SHAPES[k])
        assert TC.SHAPES[k].cache_len == JC.SHAPES[k].cache_len


#: (chips, tp, fs, pods)
MESHES = ((1, 1, 1, 1), (8, 2, 4, 1), (16, 4, 2, 2))


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_analytic_cost_equals_jax(arch):
    assert sorted(T_ARCHS) == sorted(J_ARCHS)
    tcfg, jcfg = t_full(arch), j_full(arch)
    for kind, seq, batch in (("train", 4096, 256), ("prefill", 4096, 32),
                             ("decode", 32768, 128), ("decode", 1000, 1)):
        sc = TC.ShapeConfig("probe", seq, batch, kind)
        for chips, tp, fs, pods in MESHES:
            for layout in ("dense", "paged"):
                for serve_2d in (False, True):
                    kw = dict(chips=chips, tp=tp, fs=fs, pods=pods,
                              n_params=7.1e9, grad_accum=2,
                              serve_2d=serve_2d, cache_layout=layout)
                    _close(TRL.analytic_cost(tcfg, sc, **kw),
                           JRL.analytic_cost(jcfg, sc, **kw))


_HLO = """
HloModule probe
  %ag = bf16[8,1024]{1,0} all-gather(bf16[2,1024]{1,0} %p0), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = f32[4096]{0} all-reduce(f32[4096]{0} %p1), replica_groups=[2,4]<=[8], to_apply=%add
  %ars = (f32[128]{0}, bf16[64,2]{1,0}) all-reduce-start(f32[128]{0} %a, bf16[64,2]{1,0} %b), replica_groups={{0,1}}
  %ard = (f32[128]{0}, bf16[64,2]{1,0}) all-reduce-done((f32[128]{0}, bf16[64,2]{1,0}) %ars)
  %rs = bf16[256]{0} reduce-scatter(bf16[1024]{0} %p2), replica_groups={{0,1,2,3}}, dimensions={0}
  %a2a = s8[16,16]{1,0} all-to-all(s8[16,16]{1,0} %p3), replica_groups={{0,1,2,3,4,5,6,7}}
  %cp = f32[32,32]{1,0} collective-permute(f32[32,32]{1,0} %p4), source_target_pairs={{0,1},{1,0}}
  %one = f32[8]{0} all-reduce(f32[8]{0} %p5), replica_groups={{0}}
  %add.1 = f32[] add(f32[] %x, f32[] %y)
"""


@pytest.mark.parametrize("default_group", [1, 2, 8])
def test_parse_collectives_equals_jax(default_group):
    t = TRL.parse_collectives(_HLO, default_group)
    j = JRL.parse_collectives(_HLO, default_group)
    assert t.by_kind == j.by_kind and t.op_count == j.op_count
    assert t.total_link_bytes == j.total_link_bytes
    # every kind counted once; the -done half and a group of one are not
    # (the permute names no replica group: it takes ``default_group``)
    kinds = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all"}
    if default_group > 1:
        kinds.add("collective-permute")
    assert set(t.by_kind) == kinds
    assert t.op_count == len(kinds) + 1


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b",
                                  "deepseek-v2-236b"])
def test_count_params_equals_jax(arch):
    # the count reads shapes only: the JAX tree's shapes, as zeros
    shapes = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0),
                                                  j_smoke(arch)))
    tparams = params_from_jax(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes),
        t_smoke(arch), device="cpu")
    assert TRL.count_params(tparams) == JRL.count_params(shapes)
    meta = torch.nn.Parameter(torch.empty(3, 4, device="meta"))
    assert TRL.count_params({"a": [meta, (meta,)]}) == 24.0


def test_state_update_float_exported():
    from repro_torch.kernels import ref
    assert TOPS.state_update_float is ref.state_update_float
    assert "state_update_float" in TOPS.__all__
