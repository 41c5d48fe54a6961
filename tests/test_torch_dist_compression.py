"""``repro_torch/dist/compression.py`` on one process: the seven tests of
``tests/test_dist_compression.py`` on the port's compressor, and ``q``,
``scale`` and the residual held bitwise against the JAX package's on the
same fp32 inputs (both round half to even).  The compressed all-reduce
across ranks is in ``tests/test_torch_dist_gloo.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import compression as JC
from repro_torch.core import tree as T
from repro_torch.dist.compression import (INT8_MAX,
                                          compressed_allreduce_mean,
                                          compressed_bytes, dequantize_int8,
                                          init_error_feedback, quantize_int8)

torch.set_num_threads(1)  # test workers share the cores: one thread each


def _t(rng, shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(64,), (32, 48), (4, 8, 16)])
def test_quantize_roundtrip_error_bound(rng, shape):
    x = _t(rng, shape)
    q, scale = quantize_int8(x)
    assert q.dtype == torch.int8
    err = torch.max(torch.abs(dequantize_int8(q, scale) - x))
    # round-to-nearest against a max-abs grid: half a step, plus float slop
    step = float(torch.max(torch.abs(x))) / INT8_MAX
    assert float(err) <= 0.5 * step * (1 + 1e-5)


def test_quantize_zero_tensor_is_exact():
    q, scale = quantize_int8(torch.zeros((16, 16)))
    np.testing.assert_array_equal(q.numpy(), 0)
    assert np.isfinite(float(scale))


def test_error_feedback_carries_residual_across_steps(rng):
    """The residual rounded away at step t is re-applied at t+1: averaged
    over many steps of a constant gradient, the compressed stream
    converges on the true gradient far beyond one-shot precision."""
    g = {"w": _t(rng, (32, 16))}
    ef = init_error_feedback(g)
    steps = 64
    acc = torch.zeros_like(g["w"])
    for _ in range(steps):
        red, ef = compressed_allreduce_mean(g, ef, group=None)
        acc = acc + red["w"]
    mean_err = float(torch.max(torch.abs(acc / steps - g["w"])))
    one_shot = float(torch.max(torch.abs(compressed_allreduce_mean(
        g, init_error_feedback(g), None)[0]["w"] - g["w"])))
    step = float(torch.max(torch.abs(g["w"]))) / INT8_MAX
    assert one_shot <= 0.5 * step * (1 + 1e-5)
    assert mean_err < max(one_shot / 4, 1e-6)


def test_error_feedback_residual_is_bounded(rng):
    """Error feedback must not let the carried residual blow up."""
    g = {"w": _t(rng, (8, 8))}
    ef = init_error_feedback(g)
    for _ in range(200):
        _, ef = compressed_allreduce_mean(g, ef, group=None)
    step = float(torch.max(torch.abs(g["w"]))) / INT8_MAX
    assert float(torch.max(torch.abs(ef["w"]))) <= 2 * step


def test_compressed_bytes_beats_bf16_wire():
    tree = {"a": torch.zeros((128, 64)), "b": torch.zeros((1000,))}
    n_vals = 128 * 64 + 1000
    wire = compressed_bytes(tree)
    assert wire < n_vals * 2            # bf16 baseline
    assert wire >= n_vals               # 1 byte/value + scales
    jtree = {"a": jnp.zeros((128, 64)), "b": jnp.zeros((1000,))}
    assert wire == JC.compressed_bytes(jtree)


def test_treedef_and_shapes_preserved(rng):
    g = {"a": _t(rng, (4, 4)), "nest": {"b": _t(rng, (8,))}}
    ef = init_error_feedback(g)
    red, ef2 = compressed_allreduce_mean(g, ef, group=None)
    for tree in (red, ef2):
        assert [p for p, _ in T.leaves_with_paths(tree)] == \
            [p for p, _ in T.leaves_with_paths(g)]
    for x, y in zip(T.leaves(red), T.leaves(g)):
        assert x.shape == y.shape


@pytest.mark.parametrize("unit", [1.0, 2.0 ** -10, 2.0 ** -100, 2.0 ** 100])
def test_q_scale_and_residual_bitwise_jax(rng, unit):
    """Three error-feedback steps: ``q``, ``scale``, the reduced payload
    and the residual are bitwise the JAX package's.  The largest value is
    127 units, so the grid step is the unit and the halves in row 0 are
    ties, which both round to even."""
    x = (rng.normal(size=(48, 40)) * 20 * unit).astype(np.float32)
    x[0, :7] = np.float32(unit) * np.asarray(
        [127, 0.5, 1.5, -2.5, 2.5, 0, -0.5], np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    qj, sj = JC.quantize_int8(jnp.asarray(x))
    assert float(s) == unit
    np.testing.assert_array_equal(q.numpy()[0, 1:7], [0, 2, -2, 2, 0, 0])
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    assert s.numpy().tobytes() == np.asarray(sj).tobytes()
    g, gj = {"w": torch.from_numpy(x)}, {"w": jnp.asarray(x)}
    ef, efj = init_error_feedback(g), JC.init_error_feedback(gj)
    for _ in range(3):
        red, ef = compressed_allreduce_mean(g, ef)
        redj, efj = JC.compressed_allreduce_mean(gj, efj)
        np.testing.assert_array_equal(red["w"].numpy(), np.asarray(redj["w"]))
        np.testing.assert_array_equal(ef["w"].numpy(), np.asarray(efj["w"]))
