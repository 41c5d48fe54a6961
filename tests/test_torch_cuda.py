"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA device every test skips (decided in the
fixture, never at import).  Run on the card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.

Contracts: the state update's exponent and micro bytes bitwise, mantissa
mismatch rate <= 1e-5 (the plain version emulates the kernel's FMA in
fp64, which differs only in rare double-rounding cases), ``y`` to rtol 1e-5
with atol 1e-5 * max|y| on rows whose state matches; decode attention to
rtol 2e-4, atol 2e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import formats as F
from repro_torch.kernels import mx_attention as KA
from repro_torch.kernels import mx_state_update as KS

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _su_inputs(B, H, dk, dv, dev, scalar_decay, mag=1.0):
    g = torch.Generator(device=dev).manual_seed(dk + dv)
    S0 = torch.randn((B, H, dv, dk), generator=g, device=dev) * mag
    d = torch.sigmoid(torch.randn((B, H, 1 if scalar_decay else dk),
                                  generator=g, device=dev))
    k, q = (torch.randn((B, H, dk), generator=g, device=dev) for _ in "kq")
    v = torch.randn((B, H, dv), generator=g, device=dev)
    return F.mx8_quantize(S0), d, k, v, q


@pytest.mark.parametrize("B,H,dk,dv", [(4, 80, 64, 64), (4, 80, 128, 64),
                                       (1, 3, 16, 48)])
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("scalar_decay", [True, False])
def test_state_update_kernel_vs_plain(cuda, B, H, dk, dv, rounding,
                                      scalar_decay):
    qS, d, k, v, q = _su_inputs(B, H, dk, dv, cuda, scalar_decay)
    qp, yp = KS.plain(qS.clone(), d, k, v, q, rounding=rounding, seed=77)
    n0 = KS.mx_state_update.launches
    qk, yk = KS.mx_state_update(qS.clone(), d, k, v, q, seed=77,
                                rounding=rounding)
    torch.cuda.synchronize()
    assert KS.mx_state_update.launches == n0 + 1
    for f in ("exponent", "micro"):
        assert torch.equal(qp.payload[f], qk.payload[f]), f
    diff = qp.payload["mantissa"] != qk.payload["mantissa"]
    assert (qp.payload["mantissa"].int() - qk.payload["mantissa"].int()
            ).abs().max() <= 1
    assert diff.float().mean().item() <= 1e-5
    ok = ~diff.any(-1)
    torch.testing.assert_close(yk[ok], yp[ok], rtol=1e-5,
                               atol=1e-5 * yp.abs().max().item())


@pytest.mark.parametrize("B,T,H,KVH,d,lens", [
    (4, 1024, 32, 32, 80, (1, 129, 700, 1024)),
    (2, 256, 4, 2, 32, (5, 200)),
    (1, 384, 16, 2, 128, (300,)),
])
def test_attention_kernel_vs_plain(cuda, B, T, H, KVH, d, lens):
    g = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn((B, H, d), generator=g, device=cuda)
    K = F.mx8_quantize(torch.randn((B, T, KVH, d), generator=g, device=cuda))
    V = F.mx8_quantize(torch.randn((B, T, KVH, d), generator=g, device=cuda))
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    n0 = KA.mx_attention_decode.launches
    yk = KA.mx_attention_decode(q, K, V, lengths)
    torch.cuda.synchronize()
    assert KA.mx_attention_decode.launches == n0 + 1
    torch.testing.assert_close(yk, KA.plain(q, K, V, lengths), rtol=2e-4,
                               atol=2e-5)


def test_attention_kernel_refuses_mla_mode(cuda):
    q = torch.zeros((1, 2, 32), device=cuda)
    K = F.mx8_quantize(torch.zeros((1, 128, 1, 32), device=cuda))
    with pytest.raises(NotImplementedError, match="MLA"):
        KA.mx_attention_decode(q, K, None, torch.ones(1, dtype=torch.int32,
                                                      device=cuda), v_width=16)


def test_smoke_engine_launches_each_kernel_per_layer(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.serving.api import Engine, ServeConfig
    cfg = get_smoke_config("zamba2-2.7b")
    params = M.init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                          device=cuda)
    eng = Engine(params, cfg, ServeConfig(backend="slots", batch=2,
                                          cache_capacity=256))
    rng = np.random.default_rng(0)
    hs = [eng.submit(rng.integers(0, cfg.vocab_size, n), max_new_tokens=5)
          for n in (9, 40, 17)]
    KS.mx_state_update.launches = KA.mx_attention_decode.launches = 0
    eng.run()
    steps = eng.engine.step_count
    assert all(h.status == "done" and len(h.output) == 5 for h in hs)
    n_m2 = cfg.pattern.count("mamba2") * cfg.n_groups
    assert KS.mx_state_update.launches == n_m2 * steps
    assert KA.mx_attention_decode.launches == cfg.n_groups * steps
