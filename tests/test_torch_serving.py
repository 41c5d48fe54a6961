"""The port's slot-pool serving against the JAX package's ``Engine``.

With fp32 state and greedy sampling, token streams must be identical to
the JAX slot engine's for the same weights and prompts (mixed lengths, more
requests than slots, so rows are admitted mid-run), and ``stats()`` must
have the same key set.
"""
import jax
import numpy as np
import pytest
import torch

from repro import ops as JOPS
from repro.configs import get_smoke_config as j_smoke
from repro.models import model as JM
from repro.serving.api import Engine as JEngine
from repro.serving.api import ServeConfig as JServeConfig
from repro_torch import ops as TOPS
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.api import Engine, ServeConfig

PROMPT_LENS = (8, 13, 21, 13, 8)
MAX_NEW = 6


@pytest.fixture(scope="module")
def zamba_fp32():
    jcfg = j_smoke("zamba2-2.7b").with_(state_quant=JOPS.StateQuantConfig(
        "fp32", "stochastic", "jnp"))
    tcfg = t_smoke("zamba2-2.7b").with_(state_quant=TOPS.StateQuantConfig(
        "fp32", "stochastic", "torch"))
    jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    return jcfg, tcfg, jparams, tparams, prompts


def _port_engine(zamba_fp32, **kw):
    _, tcfg, _, tparams, _ = zamba_fp32
    base = dict(backend="slots", batch=3, cache_capacity=128)
    base.update(kw)
    return Engine(tparams, tcfg, ServeConfig(**base))


def test_greedy_streams_match_jax_engine(zamba_fp32):
    jcfg, tcfg, jparams, tparams, prompts = zamba_fp32
    jeng = JEngine(jparams, jcfg, JServeConfig(backend="slots", batch=3,
                                               cache_capacity=128))
    teng = _port_engine(zamba_fp32)
    jh = [jeng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    th = [teng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    jeng.run()
    teng.run()
    for a, b in zip(jh, th):
        assert a.status == b.status == "done"
        assert a.output == b.output, (a.rid, a.output, b.output)
    js, ts = jeng.stats(), teng.stats()
    assert set(js) == set(ts)
    assert ts["tokens"] == js["tokens"] == MAX_NEW * len(prompts)
    assert ts["recompiles"] == 0.0
    for k in js:
        if k.startswith("op_traffic_bytes/"):
            assert ts[k] == pytest.approx(js[k], rel=1e-12), k


def test_truncated_and_aborted_statuses(zamba_fp32):
    prompts = zamba_fp32[4]
    eng = _port_engine(zamba_fp32, batch=2)
    # capacity 128 with a 120-token prompt: clipped long before 200 tokens
    clipped = eng.submit(np.resize(prompts[2], 120), max_new_tokens=200)
    live = eng.submit(prompts[0], max_new_tokens=50)
    queued = eng.submit(prompts[1], max_new_tokens=4)
    eng.step()
    eng.step()
    assert live.status == "running" and queued.status == "queued"
    assert queued.abort() and queued.status == "aborted"
    assert live.abort() and live.status == "aborted"
    assert len(live.output) >= 2        # tokens streamed so far stay
    req = clipped.result()
    assert req.status == "truncated" and req.truncated
    assert len(req.output) == 128 - 120
    st = eng.stats()
    assert (st["requests_aborted"], st["requests_truncated"]) == (2.0, 1.0)
    assert not eng.has_work()


def test_handle_streams_in_order(zamba_fp32):
    prompts = zamba_fp32[4]
    eng = _port_engine(zamba_fp32)
    h = eng.submit(prompts[2], max_new_tokens=5)
    other = eng.submit(prompts[4], max_new_tokens=3)
    streamed = list(h)
    assert streamed == h.output and len(streamed) == 5
    assert other.result().status == "done" and len(other.output) == 3


def test_stats_schema_before_any_finish(zamba_fp32):
    st = _port_engine(zamba_fp32).stats()
    jcfg, _, jparams, _, _ = zamba_fp32
    js = JEngine(jparams, jcfg, JServeConfig(backend="slots", batch=3,
                                             cache_capacity=128)).stats()
    assert set(st) == set(js)
    assert all(v == 0.0 for v in st.values())


def test_engine_with_cuda_backend_on_cpu_runs_plain_versions(zamba_fp32):
    """MX8 with the ``cuda`` backend requested: on CPU tensors the kernel
    wrappers take their plain versions, so the engine serves and launches
    no kernel."""
    from repro_torch.kernels.mx_attention import mx_attention_decode
    from repro_torch.kernels.mx_state_update import mx_state_update
    tcfg = t_smoke("zamba2-2.7b")
    assert tcfg.state_quant.backend == "cuda"
    params = TM.init_model(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    n0, m0 = mx_state_update.launches, mx_attention_decode.launches
    eng = Engine(params, tcfg, ServeConfig(backend="slots", batch=2))
    hs = [eng.submit(p, max_new_tokens=4) for p in zamba_fp32[4][:3]]
    eng.run()
    assert all(h.status == "done" and len(h.output) == 4 for h in hs)
    assert (mx_state_update.launches, mx_attention_decode.launches) == (n0, m0)


def test_sampler_modes():
    from repro_torch.serving.sampler import SamplingConfig, sample
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, -1.0, 4.9, 0.0]])
    # greedy: the first maximal logit, as jnp.argmax
    assert sample(logits, SamplingConfig()).tolist() == [1, 0]
    gen = torch.Generator().manual_seed(0)
    top1 = SamplingConfig(temperature=1.0, top_k=1)
    assert sample(logits[1:], top1, gen).tolist() == [0]
    # top-p below the largest probability degrades to greedy
    tiny_p = SamplingConfig(temperature=0.7, top_p=1e-6)
    assert sample(logits[1:], tiny_p, gen).tolist() == [0]
    # top-k=2 never samples outside the two largest logits
    k2 = SamplingConfig(temperature=5.0, top_k=2)
    draws = {int(sample(logits[1:], k2, gen)) for _ in range(50)}
    assert draws <= {0, 2} and len(draws) == 2
    # the same generator seed gives the same draws
    full = SamplingConfig(temperature=1.0)
    a = [int(sample(logits, full, torch.Generator().manual_seed(3))[0])
         for _ in range(3)]
    b = [int(sample(logits, full, torch.Generator().manual_seed(3))[0])
         for _ in range(3)]
    assert a == b
