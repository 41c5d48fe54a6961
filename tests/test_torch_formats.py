"""The PyTorch port's formats against the JAX package's, on the same inputs.

Contracts (see ROADMAP.md, "Parity contracts"):

* the SR counter hash and ``sr_bits``: bitwise;
* MX8 exponent and micro bits: bitwise;
* MX8 mantissa: mismatch rate <= 1e-5 over the magnitude sweep, and where
  the two differ, by one step.  The port builds exact power-of-two scales;
  XLA:CPU's ``exp2`` is a few ulps off for integer arguments, which moves
  a quotient that sits on a rounding boundary to the other side;
* every other format: bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro_torch.core import formats as TF

torch.set_num_threads(1)  # test workers share the cores: one thread each

MAGNITUDES = (1e-4, 1e-3, 1e-2, 1.0, 30.0)
SHAPES = ((64, 256), (3, 5, 128))


def _x(shape, mag, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * mag
            ).astype(np.float32)


_JITTED = {}


def _jax_quant(x, fmt, rounding, seed):
    """The jitted JAX quantizer (one jit per format and rounding)."""
    fn = _JITTED.get((fmt, rounding))
    if fn is None:
        fn = _JITTED[(fmt, rounding)] = jax.jit(
            lambda a, b: JF.quantize(a, fmt, rounding, b))
    bits = JF.sr_bits(x.shape, seed) if rounding == "stochastic" else None
    return fn(jnp.asarray(x), bits)


def _torch_quant(x, fmt, rounding, seed):
    bits = TF.sr_bits(x.shape, seed) if rounding == "stochastic" else None
    return TF.quantize(torch.from_numpy(x), fmt, rounding, bits)


def _np(t):
    if isinstance(t, torch.Tensor):
        if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2,
                       torch.bfloat16):
            t = t.view(torch.uint8) if t.element_size() == 1 \
                else t.view(torch.int16)
        return t.numpy()
    a = np.asarray(t)
    if a.dtype.itemsize == 1 and a.dtype.kind == "V" or "float8" in str(
            a.dtype):
        return a.view(np.uint8)
    if "bfloat16" in str(a.dtype):
        return a.view(np.int16)
    return a


def test_exact_pow2_covers_subnormals():
    e = torch.arange(-149, 128)
    got = TF.exact_pow2(e).double().numpy()
    np.testing.assert_array_equal(got, np.ldexp(1.0, e.numpy()))


@pytest.mark.parametrize("seed", [0, 1, 0x7FFFFFFF, 0xFFFFFFFF])
def test_counter_hash_and_sr_bits_bitwise(seed):
    c = np.random.default_rng(seed % 97).integers(0, 2 ** 32, 4096,
                                                  dtype=np.uint64)
    want = np.asarray(JF.counter_hash_u32(jnp.asarray(c.astype(np.uint32)),
                                          np.uint32(seed)))
    got = TF.counter_hash_u32(torch.from_numpy(c.astype(np.int64)), seed)
    np.testing.assert_array_equal(want.astype(np.int64), got.numpy())
    want = np.asarray(JF.sr_bits((7, 33), np.uint32(seed), offset=5))
    got = TF.sr_bits((7, 33), seed, offset=5)
    np.testing.assert_array_equal(want.astype(np.int64), got.numpy())


@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_mx8_parity_over_magnitudes(rounding):
    mismatched = total = 0
    rates = {}
    for mag in MAGNITUDES:
        for i, shape in enumerate(SHAPES):
            for seed in (0, 7):
                x = _x(shape, mag, seed + 13 * i)
                qj = _jax_quant(x, "mx8", rounding, seed)
                qt = _torch_quant(x, "mx8", rounding, seed)
                for f in ("exponent", "micro"):
                    np.testing.assert_array_equal(
                        np.asarray(qj.payload[f]), qt.payload[f].numpy(),
                        err_msg=f"{f} mag={mag} shape={shape}")
                mj = np.asarray(qj.payload["mantissa"]).astype(np.int32)
                mt = qt.payload["mantissa"].numpy().astype(np.int32)
                assert np.abs(mj - mt).max() <= 1, (mag, shape)
                n_bad = int((mj != mt).sum())
                mismatched += n_bad
                total += mj.size
                rates[mag] = rates.get(mag, 0) + n_bad
    rate = mismatched / total
    assert rate <= 1e-5, f"mantissa mismatch rate {rate:.2e} ({rates})"


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3", "fp8_e5m2", "fp16",
                                 "bf16", "fp32"])
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("mag", [1e-3, 1.0, 30.0])
def test_other_formats_bitwise(fmt, rounding, mag):
    x = _x((16, 128), mag, 3)
    qj = _jax_quant(x, fmt, rounding, 5)
    qt = _torch_quant(x, fmt, rounding, 5)
    assert set(qj.payload) == set(qt.payload)
    for f in qj.payload:
        np.testing.assert_array_equal(_np(qj.payload[f]), _np(qt.payload[f]),
                                      err_msg=f"{fmt}/{f}")
    np.testing.assert_array_equal(np.asarray(JF.dequantize(qj)),
                                  TF.dequantize(qt).numpy())


def test_mx8_dequantize_is_exact_scale():
    """Dequantizing the same payload: the port's values are mantissa times
    an exact power of two; JAX's differ from them by a few ulps at most,
    the error of XLA:CPU's ``exp2``."""
    x = _x((32, 64), 1e-3, 4)
    qj = _jax_quant(x, "mx8", "nearest", 0)
    qt = TF.QuantizedTensor("mx8", x.shape, {
        f: torch.from_numpy(np.array(a)) for f, a in qj.payload.items()})
    got = TF.dequantize(qt).numpy()
    want = np.asarray(JF.dequantize(qj))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    e = qt.payload["exponent"].numpy().astype(np.int64) - 127
    m = qt.payload["micro"].numpy().astype(np.int64)
    micro = (m[..., None] >> np.arange(8)) & 1
    scale = np.ldexp(1.0, e[..., None] - 6 - micro)
    mant = qt.payload["mantissa"].numpy().reshape(32, 4, 8, 2)
    np.testing.assert_array_equal(
        got, (mant * scale[..., None]).reshape(32, 64).astype(np.float32))
