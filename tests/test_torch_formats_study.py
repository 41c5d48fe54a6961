"""The port's swamping study (``analysis/formats_study.py``, paper Fig. 4's
mechanism) against the JAX package's.

Contracts:

* fed the JAX study's own draws (``PRNGKey(7t+1 .. 7t+3)``), the port's
  study equals JAX's ``run_swamping_study(T=100)`` per (format, rounding)
  to rtol 1e-3;
* the orderings of ``tests/test_state_update.py``'s swamping test hold on
  the port at T = 300, from the port's own generator;
* the ``cuda`` backend on CPU tensors (kernel 1's plain version) gives the
  torch backend's study bitwise;
* the study runs on the card unless asked for the CPU, and raises when
  there is no card.
"""
import jax
import numpy as np
import pytest
import torch

from repro.analysis.formats_study import run_swamping_study as j_study
from repro_torch.analysis import formats_study as TFS

torch.set_num_threads(1)  # test workers share the cores: one thread each

T_PARITY = 100
DK = DV = 32


def _jax_draws(T, dk=DK, dv=DV):
    """The JAX study's draws, step by step, as (T, 1, 1, dim) arrays."""
    def stack(offset, n):
        return np.stack([np.asarray(jax.random.normal(
            jax.random.PRNGKey(7 * t + offset), (1, 1, n)))
            for t in range(T)])
    return stack(1, dk), stack(2, dv), stack(3, dk)


@pytest.fixture(scope="module")
def parity():
    draws = _jax_draws(T_PARITY)
    return j_study(T=T_PARITY), TFS.run_swamping_study(T_PARITY, draws=draws,
                                                device="cpu")


@pytest.mark.parametrize("key", TFS.DEFAULT_FORMATS,
                         ids=[f"{f}-{r}" for f, r in TFS.DEFAULT_FORMATS])
def test_study_equals_jax_on_its_draws(parity, key):
    jax_errs, port_errs = parity
    assert set(port_errs) == set(jax_errs)
    assert port_errs[key] == pytest.approx(jax_errs[key], rel=1e-3)


@pytest.fixture(scope="module")
def port_300():
    return TFS.run_swamping_study(T=300, device="cpu")


def test_swamping_ordering_across_formats(port_300):
    errs = port_300
    # narrow-mantissa fp8 under RNE diverges; wider formats track fp32
    assert errs[("mx8", "stochastic")] < errs[("fp8_e5m2", "nearest")] / 2
    assert errs[("int8", "stochastic")] < errs[("fp8_e5m2", "nearest")] / 3
    assert errs[("fp8_e4m3", "nearest")] < errs[("fp8_e5m2", "nearest")]
    assert errs[("fp16", "nearest")] < 0.01
    # stochastic rounding rescues the block/narrow formats
    # (paper Fig. 4: e5m2 62 -> 12.2 ppl with SR)
    assert errs[("mx8", "stochastic")] < errs[("mx8", "nearest")]
    assert errs[("fp8_e5m2", "stochastic")] < errs[("fp8_e5m2", "nearest")] / 2
    assert errs[("fp8_e4m3", "stochastic")] < errs[("fp8_e4m3", "nearest")] / 2


def test_default_draws_come_from_an_explicit_generator(port_300):
    g = torch.Generator().manual_seed(7)
    again = TFS.run_swamping_study(
        T=300, formats=[("mx8", "stochastic")],
        draws=TFS.swamping_draws(300, generator=g, device="cpu"),
        device="cpu")
    assert again[("mx8", "stochastic")] == port_300[("mx8", "stochastic")]
    d, ks, vs, qs = TFS.swamping_inputs(
        TFS.swamping_draws(5, device="cpu"), device="cpu")
    assert d.shape == (1, 1, DK) and ks.shape == (5, 1, 1, DK)
    assert vs.shape == (5, 1, 1, DV) and qs.shape == (5, 1, 1, DK)


def test_kernel_backend_on_cpu_equals_torch_backend():
    draws = TFS.swamping_draws(60, device="cpu")
    mx8 = [("mx8", "nearest"), ("mx8", "stochastic")]
    assert TFS.run_swamping_study(60, formats=mx8, draws=draws,
                                  device="cpu", backend="cuda") == \
        TFS.run_swamping_study(60, formats=mx8, draws=draws, device="cpu")


def test_short_draws_refused():
    with pytest.raises(ValueError, match="draws hold 5 steps"):
        TFS.run_swamping_study(T=6, draws=TFS.swamping_draws(5, device="cpu"),
                               device="cpu")


@pytest.mark.parametrize("call", [
    lambda: TFS.run_swamping_study(T=2),
    lambda: TFS.swamping_draws(2),
    lambda: TFS.swamping_inputs(TFS.swamping_draws(2, device="cpu")),
], ids=["study", "draws", "inputs"])
def test_study_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch, call):
    """Like every entry point of the port, the study takes the card by
    default and refuses, rather than falls back, when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        call()
