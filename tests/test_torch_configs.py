"""The last three served configs of the port -- smollm-360m (G = 3, head
width 64, tied embeddings), yi-34b (G = 7) and dbrx-132b (MoE: 16 experts,
top-4, no shared expert) -- against the JAX package, on the CPU, at
``SMOKE`` size (JAX weights through ``params_from_jax``).

Contracts (ROADMAP.md, "Parity contracts"):

* configs field for field (``CONFIG`` and ``SMOKE``, every field; the
  state format's backend maps ``pallas`` to ``cuda``); each full config's
  parameter count equal to the JAX package's ``eval_shape`` count, counted
  on torch's ``meta`` device (no storage);
* ``params_from_jax`` leaf for leaf, the same tree as the port's own init;
* fp32 state: prefill and 8 greedy decode steps' logits to rtol 1e-4, atol
  1e-4 * max|logits| (``test_torch_dense_family.py``'s yi-9b contract) and
  identical greedy tokens; MX8 state (the kernels' plain versions): the
  prefill to rtol 1e-4, the first decode step to rtol 1e-3, the greedy
  token agreement reported;
* the paged pool's decode bitwise its dense-gather path's;
* fp32 greedy streams equal to the JAX slot, paged and paged + n-gram
  engines' (batch 2), with the same speculation accounting; MX8 at round
  to nearest: speculation changes no greedy token (dbrx at batch 1: MoE
  capacity couples the tokens routed together);
* ``decode_op_plans`` and ``traffic(plan)`` equal to the JAX registry's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as JOPS
from repro.configs import ALL_ARCHS as J_ARCHS
from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.models import model as JM
from repro.serving.api import Engine as JEngine
from repro.serving.api import ServeConfig as JServeConfig
from repro_torch import ops as TOPS
from repro_torch.configs import ALL_ARCHS
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.paged import pages_for
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.api import Engine, ServeConfig
from repro_torch.serving.memory import PagedStatePool

from test_torch_dense_family import _close, _decode_steps, _run

ARCHS = ("smollm-360m", "yi-34b", "dbrx-132b")
_PAIRS = {}


def same_config(mine, theirs):
    """Every field equal, the state format's backend mapped across (the
    JAX package's ``pallas`` is the port's ``cuda``)."""
    a, b = dataclasses.asdict(mine), dataclasses.asdict(theirs)
    assert b["state_quant"].pop("backend") == "pallas"
    assert a["state_quant"].pop("backend") == "cuda"
    assert a == b


def meta_param_count(cfg):
    """The port's parameter count of ``cfg``, without storage."""
    params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                           device="meta")
    return sum(a.numel() for a in jax.tree_util.tree_leaves(params))


def jax_param_count(cfg):
    shapes = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0),
                                                  cfg))
    return sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes))


def _pair(arch, fmt="fp32", rounding="stochastic"):
    """(JAX cfg, port cfg, JAX params, port params): the same weights."""
    key = (arch, fmt, rounding)
    if key not in _PAIRS:
        jb, tb = ("jnp", "torch") if fmt != "mx8" else ("jnp", "cuda")
        jcfg = j_smoke(arch).with_(state_quant=JOPS.StateQuantConfig(
            fmt, rounding, jb))
        tcfg = t_smoke(arch).with_(state_quant=TOPS.StateQuantConfig(
            fmt, rounding, tb))
        base = _PAIRS.get((arch, "fp32", "stochastic"))
        if base is None:
            jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)
            tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
        else:                               # one JAX init a config
            jparams, tparams = base[2], base[3]
        _PAIRS[key] = (jcfg, tcfg, jparams, tparams)
    return _PAIRS[key]


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

def test_all_fifteen_archs_are_ported():
    assert set(ALL_ARCHS) == set(J_ARCHS) and len(ALL_ARCHS) == 15


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax_field_for_field(arch):
    same_config(t_full(arch), j_full(arch))
    same_config(t_smoke(arch), j_smoke(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_equals_jax_eval_shape(arch):
    want = {"smollm-360m": 361_821_120, "yi-34b": 34_388_917_248,
            "dbrx-132b": 131_596_523_520}[arch]
    assert meta_param_count(t_full(arch)) == jax_param_count(j_full(arch)) \
        == want


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_leaf_for_leaf(arch):
    jcfg, tcfg, jparams, tparams = _pair(arch)
    own = TM.init_model(tcfg, torch.Generator().manual_seed(0), device="cpu")
    conv, mine = (jax.tree_util.tree_leaves(t) for t in (tparams, own))
    assert [tuple(a.shape) for a in conv] == [tuple(a.shape) for a in mine]
    assert set(tparams) == set(own)
    assert ("lm_head" in tparams) == (not tcfg.tie_embeddings)
    for g in range(tcfg.n_groups):
        for name, a in tparams["groups"][g][0]["ffn"].items():
            np.testing.assert_array_equal(
                a.numpy(), np.asarray(jparams["groups"][0]["ffn"][name][g]))
    if arch == "dbrx-132b":
        ffn = tparams["groups"][0][0]["ffn"]
        assert set(ffn) == {"router", "wi", "wg", "wo"}      # no shared
        assert tuple(ffn["wi"].shape) == (4, 128, 128)


# ---------------------------------------------------------------------------
# models: prefill and decode against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_prefill_and_greedy_decode_match_jax(arch):
    for i, (jl, tl) in enumerate(_run(*_pair(arch))):
        _close(jl, tl, 1e-4)
        np.testing.assert_array_equal(np.asarray(jnp.argmax(jl, -1)),
                                      torch.argmax(tl, -1).numpy(),
                                      err_msg=f"{arch} step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_mx8_first_step_and_token_agreement(arch):
    """The kernels' plain versions (``cuda`` backend, CPU tensors) against
    the JAX ops: prefill to rtol 1e-4, the first decode step to rtol 1e-3,
    token agreement reported, not asserted."""
    steps = _run(*_pair(arch, "mx8"))
    _close(steps[0][0], steps[0][1], 1e-4)
    _close(steps[1][0], steps[1][1], 1e-3)
    agree = np.mean([np.array_equal(np.asarray(jnp.argmax(jl, -1)),
                                    torch.argmax(tl, -1).numpy())
                     for jl, tl in steps])
    print(f"{arch} mx8 greedy token agreement over {len(steps)} steps: "
          f"{agree:.2f}")
    assert all(np.isfinite(tl.numpy()).all() for _, tl in steps)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_bit_identical_to_dense_gather(arch):
    """MX8, the ``cuda`` backend's plain versions on the CPU, a 127-token
    prompt decoded across the page boundary."""
    cfg = t_smoke(arch)
    assert cfg.state_quant.fmt == "mx8"
    params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    pool = PagedStatePool(cfg, n_pages=8, n_slabs=3, device="cpu")
    prompt = np.random.default_rng(127).integers(0, cfg.vocab_size, 127)
    logits, row = TM.prefill(params, cfg,
                             {"tokens": torch.as_tensor(prompt)[None]})
    assert pool.register(1, pages_for(127))
    pool.insert_prefill(1, row)
    tok = int(logits[0].argmax())
    snapshot = [p.clone() for p in pool.pools]
    pages0 = list(pool.page_table[1])
    pool.decode_mode = "gather"
    ref = _decode_steps(pool, params, tok, 127, n_steps=3)
    for p, s in zip(pool.pools, snapshot):
        p.copy_(s)
    pool.placement.unref([p for p in pool.page_table[1] if p not in pages0])
    pool.page_table[1] = list(pages0)
    pool.decode_mode = "paged"
    got = _decode_steps(pool, params, tok, 127, n_steps=3)
    for step, (a, b) in enumerate(zip(ref, got)):
        assert torch.equal(a, b), f"{arch} step {step}"


# ---------------------------------------------------------------------------
# serving: the three paths against the JAX engines
# ---------------------------------------------------------------------------

_PATHS = {"slots": dict(backend="slots", batch=2, cache_capacity=256),
          "paged": dict(batch=2, n_pages=6, prefill_chunk=64),
          "paged+ngram": dict(batch=2, n_pages=6, prefill_chunk=64,
                              spec="ngram", spec_k=3)}


def _prompts(vocab):
    """A repeated pattern (the n-gram source proposes from it) and a prompt
    past ``prefill_chunk`` (its tail streams through decode)."""
    rng = np.random.default_rng(5)
    return [np.tile(rng.integers(0, vocab, 5), 4).astype(np.int32),
            rng.integers(0, vocab, 90).astype(np.int32)]


@pytest.mark.parametrize("path", list(_PATHS))
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_match_jax(arch, path):
    """fp32 state, greedy: the streams of the port's engine equal the JAX
    package's, and so does the speculation accounting."""
    jcfg, tcfg, jparams, tparams = _pair(arch, "fp32", "nearest")
    kw = _PATHS[path]
    jkw = {} if path == "slots" else dict(prefetch_window=0)
    jeng = JEngine(jparams, jcfg, JServeConfig(**kw, **jkw))
    teng = Engine(tparams, tcfg, ServeConfig(**kw))
    prompts = _prompts(tcfg.vocab_size)
    jh = [jeng.submit(p, max_new_tokens=5) for p in prompts]
    th = [teng.submit(p, max_new_tokens=5) for p in prompts]
    jeng.run()
    teng.run()
    for a, b in zip(jh, th):
        assert (a.status, a.output) == (b.status, b.output), a.rid
    js, ts = jeng.stats(), teng.stats()
    keys = ["tokens"]
    if "spec" in kw:
        keys += ["proposed_tokens", "accepted_tokens", "acceptance_rate",
                 "accepted_tokens_per_step"]
    for k in keys:
        assert ts[k] == js[k], k


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_greedy_equals_plain_mx8(arch):
    """MX8 at round to nearest, the plain versions on the CPU: speculation
    changes no greedy token.  dbrx runs at batch 1: its MoE capacity
    couples the tokens routed together, and a verify step routes B * Kq of
    them where a plain step routes B."""
    cfg = t_smoke(arch).with_(state_quant=TOPS.StateQuantConfig(
        "mx8", "nearest", "cuda"))
    params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    batch = 1 if cfg.moe is not None else 2
    prompts = _prompts(cfg.vocab_size)
    outs = {}
    for spec in (None, "ngram"):
        eng = Engine(params, cfg, ServeConfig(batch=batch, n_pages=17,
                                              spec=spec, spec_k=3))
        hs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run()
        outs[spec] = [h.output for h in hs]
    assert outs["ngram"] == outs[None]
    assert eng.stats()["proposed_tokens"] > 0


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("spec_k", [0, 3])
@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_op_plans_match_jax(arch, size, spec_k, layout):
    jc, tc = ((j_smoke(arch), t_smoke(arch)) if size == "smoke"
              else (j_full(arch), t_full(arch)))
    je = JOPS.decode_op_plans(jc, 4, 300, layout=layout, spec_k=spec_k)
    te = TOPS.decode_op_plans(tc, 4, 300, layout=layout, spec_k=spec_k)
    kind = "spec_verify" if spec_k else "attn_decode"
    assert [(e.kind, e.count) for e in te] == [
        (kind, tc.n_layers), ("kv_append", tc.n_layers * (spec_k + 1))]
    assert [(e.kind, e.count) for e in te] == [(e.kind, e.count) for e in je]
    for a, b in zip(je, te):
        assert b.plan.dims == a.plan.dims
        assert b.traffic.__dict__ == a.traffic.__dict__, a.kind


def test_launcher_serves_smollm_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "smollm-360m", "--smoke-size", "--device",
                       "cpu", "--paged", "--requests", "3",
                       "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "3 requests" in out and "pool=paged" in out
