"""Kernel 7 (the MX8 quantizer of the REG_WRITE path), the REG_WRITE sites
and the deprecated shims, against the JAX package on the same seeded numpy
inputs.

Contracts (ROADMAP.md, "Parity contracts"):

* the plain version of kernel 7 against the Pallas kernel in interpret mode
  (``row_block=64``, so the JAX side pads and splits rows): exponent and
  micro bytes bitwise; mantissas to a mismatch rate <= 1e-5, one step
  where they differ (the port's scales are exact powers of two, XLA:CPU's
  ``exp2`` is not);
* on a CPU tensor the wrapper is its plain version, bitwise, and at
  round-to-nearest it is ``F.quantize(x, "mx8")`` bitwise;
* ``_store_state`` and ``_build_kv_cache`` quantize through
  ``mx_quantize`` with the ``cuda`` backend and through ``F.quantize``
  with ``torch``, with the same bytes either way;
* the shims warn ``SpuDeprecationWarning`` and return what the registry
  returns, bitwise (after ``tests/test_ops_registry.py``).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as JOPS
from repro.kernels.mx_quant import mx_quantize as j_quant
from repro_torch import ops as OPS
from repro_torch.configs import get_smoke_config
from repro_torch.core import attention_cache as AC
from repro_torch.core import formats as F
from repro_torch.kernels import mx_quant as KQ
from repro_torch.kernels import ref as R
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM
from repro_torch.ops.base import SpuDeprecationWarning

torch.set_num_threads(1)  # test workers share the cores: one thread each

SHAPES = [(16, 64), (300, 128), (5, 7, 32)]


def _x(shape, seed=0, mag=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * mag).astype(np.float32)


def _payload(qt):
    return {f: np.asarray(a) for f, a in qt.payload.items()}


# ---------------------------------------------------------------------------
# kernel 7's plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_quantizer_matches_pallas_interpret(shape, rounding):
    x = _x(shape, seed=len(shape) + shape[-1])
    want = _payload(j_quant(jnp.asarray(x), 11, rounding=rounding,
                            row_block=64, interpret=True))
    got = KQ.plain(torch.from_numpy(x), rounding, 11)
    assert tuple(got.shape) == shape
    for f in ("exponent", "micro"):
        np.testing.assert_array_equal(got.payload[f].numpy(), want[f], f)
    dm = np.abs(got.payload["mantissa"].numpy().astype(np.int32)
                - want["mantissa"].astype(np.int32))
    assert dm.max() <= 1
    assert (dm > 0).mean() <= 1e-5


@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_wrapper_on_cpu_is_the_plain_version(rounding):
    x = torch.from_numpy(_x((6, 5, 48), seed=3, mag=1e-3))
    before = KQ.mx_quantize.launches
    got = KQ.mx_quantize(x, 2**32 + 9, rounding=rounding)
    want = R.mx_quantize_ref(x, rounding, 9)         # seeds wrap to uint32
    assert KQ.mx_quantize.launches == before         # no kernel on the CPU
    for f in want.payload:
        assert torch.equal(got.payload[f], want.payload[f]), f
    if rounding == "nearest":
        ref = F.quantize(x, "mx8")
        for f in ref.payload:
            assert torch.equal(got.payload[f], ref.payload[f]), f
    assert got.payload["exponent"].shape == (6, 5, 3)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        KQ.mx_quantize(torch.zeros((2, 16), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        KQ.mx_quantize(torch.zeros((2, 24)))
    with pytest.raises(ValueError):
        KQ.mx_quantize(torch.zeros((2, 16)), rounding="up")


def test_stochastic_bits_follow_the_flat_index():
    """SR bits come from the flat index of the whole array: a reshape of
    the same values quantizes to the same bytes."""
    x = torch.from_numpy(_x((4, 6, 32), seed=5))
    a = KQ.mx_quantize(x, 3, rounding="stochastic")
    b = KQ.mx_quantize(x.reshape(24, 32), 3, rounding="stochastic")
    for f in a.payload:
        assert torch.equal(a.payload[f].reshape(b.payload[f].shape),
                           b.payload[f]), f


# ---------------------------------------------------------------------------
# the REG_WRITE sites
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_reg_write_sites_route_by_backend(monkeypatch, backend):
    """MX8 with the ``cuda`` backend: kernel 7 (on CPU tensors its plain
    version) once for the state and once for K and V together; ``torch``:
    ``F.quantize`` per stream.  The same bytes either way."""
    calls = {"kernel": 0, "streams": 0, "quantize": 0}
    real_kernel, real_quantize = KQ.plain_streams, F.quantize

    def kernel(xs, *a, **kw):
        calls["kernel"] += 1
        calls["streams"] += len(xs)
        return real_kernel(xs, *a, **kw)

    def quantize(x, fmt, *a, **kw):
        calls["quantize"] += 1
        return real_quantize(x, fmt, *a, **kw)

    monkeypatch.setattr(KQ, "plain_streams", kernel)
    monkeypatch.setattr(F, "quantize", quantize)
    cfg = get_smoke_config("zamba2-2.7b").with_(
        state_quant=OPS.StateQuantConfig("mx8", "stochastic", backend))
    S = torch.from_numpy(_x((2, 3, 16, 32), seed=1))
    st = SSM._store_state(S, cfg)
    k, v = (torch.from_numpy(_x((2, 5, 2, 32), seed=s)) for s in (2, 3))
    cache = M._build_kv_cache(k, v, cfg)
    want = {"kernel": 2, "streams": 3, "quantize": 0} if backend == "cuda" \
        else {"kernel": 0, "streams": 0, "quantize": 3}
    assert calls == want
    # the same bytes either way (round to nearest)
    ref = real_quantize(S.transpose(-1, -2).contiguous(), "mx8")
    for f in ref.payload:
        assert torch.equal(st.payload[f], ref.payload[f]), f
    assert isinstance(cache, AC.KVCache) and cache.k.shape[1] == 128
    for got, x in ((cache.k, k), (cache.v, v)):
        want_q = real_quantize(torch.nn.functional.pad(x, (0, 0, 0, 0, 0,
                                                           123)), "mx8")
        for f in want_q.payload:
            assert torch.equal(got.payload[f], want_q.payload[f]), f


def test_prefill_runs_one_quantizer_per_state_and_kv_stream(monkeypatch):
    """gla smoke: one REG_WRITE per layer state; zamba2 smoke: one per
    Mamba-2 state and one for each shared-attention application's K and V
    together (two streams): kernel 7's launches on the card."""
    n = {"calls": 0, "streams": 0}
    real = KQ.plain_streams

    def counting(xs, *a, **kw):
        n["calls"] += 1
        n["streams"] += len(xs)
        return real(xs, *a, **kw)

    monkeypatch.setattr(KQ, "plain_streams", counting)
    for arch in ("gla-2.7b", "zamba2-2.7b"):
        cfg = get_smoke_config(arch)
        assert cfg.state_quant.backend == "cuda"
        params = M.init_model(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
        n["calls"] = n["streams"] = 0
        M.prefill(params, cfg, {"tokens": torch.arange(20)[None]})
        n_attn = cfg.n_groups if cfg.shared_attn else 0
        assert n == {"calls": cfg.n_layers + n_attn,
                     "streams": cfg.n_layers + 2 * n_attn}, arch


# ---------------------------------------------------------------------------
# the deprecated shims (after tests/test_ops_registry.py)
# ---------------------------------------------------------------------------

def _su_inputs(seed=0, B=2, H=3, dk=32, dv=16):
    g = torch.Generator().manual_seed(seed)
    S0 = torch.randn((B, H, dv, dk), generator=g)
    d = torch.sigmoid(torch.randn((B, H, dk), generator=g))
    k, q = (torch.randn((B, H, dk), generator=g) for _ in "kq")
    v = torch.randn((B, H, dv), generator=g)
    return F.mx8_quantize(S0), d, k, v, q


def test_kernels_ops_state_update_shim():
    from repro_torch.kernels import ops as KOPS
    qS, d, k, v, q = _su_inputs()
    cfg = OPS.StateQuantConfig("mx8", "stochastic", "cuda")
    Sn, y = OPS.state_update_step(qS.clone(), d, k, v, q, cfg, seed=3)
    with pytest.warns(SpuDeprecationWarning):
        Sn2, y2 = KOPS.state_update(qS.clone(), d, k, v, q, 3)
    for f in Sn.payload:
        assert torch.equal(Sn.payload[f], Sn2.payload[f]), f
    assert torch.equal(y, y2)
    S = F.dequantize(qS)
    with pytest.warns(SpuDeprecationWarning):
        Sf, yf = KOPS.state_update_float(S, d, k, v, q, dtype=torch.float32)
    Sr, yr = R.state_update_float(S, d, k, v, q, dtype=torch.float32)
    assert torch.equal(Sf, Sr) and torch.equal(yf, yr)


def test_core_state_update_step_shim():
    from repro_torch.core import state_update as SU
    qS, d, k, v, q = _su_inputs(seed=1)
    cfg = SU.StateQuantConfig(fmt="mx8", rounding="stochastic",
                              backend="torch")
    Sn, y = OPS.state_update_step(qS, d, k, v, q, cfg, seed=7)
    with pytest.warns(SpuDeprecationWarning):
        Sn2, y2 = SU.state_update_step(qS, d, k, v, q, cfg, seed=7)
    for f in Sn.payload:
        assert torch.equal(Sn.payload[f], Sn2.payload[f]), f
    assert torch.equal(y, y2)
    jcfg = JOPS.StateQuantConfig(fmt="mx8", rounding="stochastic",
                                 backend="jnp")
    assert SU.state_nbytes(2, 3, 32, 16, cfg) == \
        JOPS.state_nbytes(2, 3, 32, 16, jcfg)


def test_kernels_ops_attention_decode_shim():
    from repro_torch.kernels import ops as KOPS
    g = torch.Generator().manual_seed(2)
    B, H, KVH, dh, T = 2, 4, 2, 32, 128
    q = torch.randn((B, H, dh), generator=g)
    qK, qV = (F.mx8_quantize(torch.randn((B, T, KVH, dh), generator=g))
              for _ in "kv")
    lengths = torch.tensor([100, 64], dtype=torch.int32)
    cfg = OPS.StateQuantConfig("mx8", "nearest", "cuda")
    y = OPS.attn_decode(AC.KVCache(qK, qV, lengths, "mx8"), q, cfg)
    with pytest.warns(SpuDeprecationWarning):
        y2 = KOPS.attention_decode(q, qK, qV, lengths)
    assert torch.equal(y, y2)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_kernels_ops_quantize_mx8_shim(backend):
    from repro_torch.kernels import ops as KOPS
    x = torch.from_numpy(_x((8, 64), seed=4))
    with pytest.warns(SpuDeprecationWarning):
        got = KOPS.quantize_mx8(x, 5, rounding="stochastic", backend=backend)
    want = R.mx_quantize_ref(x, "stochastic", 5)
    for f in want.payload:
        assert torch.equal(got.payload[f], want.payload[f]), f


def test_shim_modules_import_without_warning():
    import importlib
    with warnings.catch_warnings():
        warnings.simplefilter("error", SpuDeprecationWarning)
        import repro_torch.core.state_update
        import repro_torch.kernels.ops
        importlib.reload(repro_torch.kernels.ops)
        importlib.reload(repro_torch.core.state_update)
        repro_torch.core.state_update.StateQuantConfig(fmt="fp32")
