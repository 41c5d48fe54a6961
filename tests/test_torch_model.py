"""Model-level parity: the port's prefill and decode against the JAX
package's, with the same weights (converted through numpy).

Contracts (ROADMAP.md, "Parity contracts"):

* prefill logits: rtol 1e-4, atol 1e-4 * max|logits| -- both sides compute
  in fp32, but the projections and the chunked scan accumulate in other
  orders (XLA:CPU vs PyTorch's CPU kernels);
* fp32 state, 8 greedy decode steps: the same tolerance on every step's
  logits, and identical tokens;
* MX8 state: the first decode step's logits within rtol 1e-3, atol
  1e-3 * max|logits| (a handful of stochastic-rounding decisions may flip
  where the two sides' state differs in the last bit), and the greedy
  token-agreement rate over 8 steps reported, not asserted: one flipped
  decision changes every later token.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as JOPS
from repro.configs import get_smoke_config as j_smoke
from repro.models import model as JM
from repro_torch import ops as TOPS
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax

ARCHS = ("zamba2-2.7b", "mamba2-2.7b", "llama3.2-1b", "deepseek-v2-236b",
         "gla-2.7b", "retnet-2.7b", "hgrn2-2.7b")
N_STEPS = 8


def _pair(arch, fmt):
    jb, tb = ("jnp", "torch") if fmt != "mx8" else ("jnp", "cuda")
    jcfg = j_smoke(arch).with_(state_quant=JOPS.StateQuantConfig(
        fmt, "stochastic", jb))
    tcfg = t_smoke(arch).with_(state_quant=TOPS.StateQuantConfig(
        fmt, "stochastic", tb))
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _close(a, b, rtol):
    a, b = np.asarray(a), b.numpy()
    np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * np.abs(a).max())


def _run(arch, fmt, n_steps=N_STEPS):
    jcfg, tcfg, jparams, tparams = _pair(arch, fmt)
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 24))
    jl, jc = jax.jit(lambda p, b: JM.prefill(p, jcfg, b))(
        jparams, {"tokens": jnp.asarray(prompt, jnp.int32)})
    tl, tc = TM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(prompt)})
    # as examples/quickstart.py does: mark the warm caches' lengths
    jc = JM.set_cache_lengths(jc, jnp.full((2,), 24, jnp.int32))
    tc = TM.set_cache_lengths(tc, torch.full((2,), 24))
    jdec = jax.jit(lambda p, t, c, L, s: JM.decode_step(p, jcfg, t, c, L, s))
    out = [(jl, tl)]
    jt = jnp.argmax(jl, -1).astype(jnp.int32)
    tt = torch.argmax(tl, -1)
    for i in range(n_steps):
        lens = np.full((2,), 24 + i, np.int32)
        jl, jc = jdec(jparams, jt, jc, jnp.asarray(lens), jnp.int32(i))
        tl, tc = TM.decode_step(tparams, tcfg, tt, tc, torch.from_numpy(lens),
                                seed=i)
        out.append((jl, tl))
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_state_prefill_and_greedy_decode_match(arch):
    steps = _run(arch, "fp32")
    for i, (jl, tl) in enumerate(steps):
        _close(jl, tl, 1e-4)
        np.testing.assert_array_equal(np.asarray(jnp.argmax(jl, -1)),
                                      torch.argmax(tl, -1).numpy(),
                                      err_msg=f"{arch} step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_mx8_state_first_step_and_token_agreement(arch):
    steps = _run(arch, "mx8")
    _close(steps[0][0], steps[0][1], 1e-4)          # prefill: no SR yet
    _close(steps[1][0], steps[1][1], 1e-3)          # first decode step
    agree = np.mean([np.array_equal(np.asarray(jnp.argmax(jl, -1)),
                                    torch.argmax(tl, -1).numpy())
                     for jl, tl in steps])
    print(f"{arch} mx8 greedy token agreement over {len(steps)} steps: "
          f"{agree:.2f}")
    assert all(np.isfinite(tl.numpy()).all() for _, tl in steps)


def test_port_init_model_matches_jax_shapes():
    jcfg, tcfg, jparams, tparams = _pair("zamba2-2.7b", "fp32")
    own = TM.init_model(tcfg, torch.Generator().manual_seed(0), device="cpu")
    conv = jax.tree_util.tree_leaves(tparams)
    mine = jax.tree_util.tree_leaves(own)
    assert [tuple(a.shape) for a in conv] == [tuple(a.shape) for a in mine]
    assert [a.dtype for a in conv] == [a.dtype for a in mine]
