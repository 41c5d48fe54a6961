"""The two configs of the port that run at model level only --
paligemma-3b (a patch-embedding prefix, bidirectional, before the text
tokens; one kv head of width 256 at full size) and hubert-xlarge (an
encoder over audio frames: non-causal, sinusoidal positions, no decode
step) -- against the JAX package, on the CPU, at ``SMOKE`` size.

Contracts:

* configs field for field, parameter counts equal to the JAX package's
  ``eval_shape`` count (torch's ``meta`` device), ``params_from_jax``
  carrying ``frontend_proj`` (and no ``embed`` for audio frames);
* ``blockwise_attention`` causal, with a bidirectional prefix (inside one
  chunk, across chunks, the whole sequence) and non-causal, against the
  JAX package's, to rtol 1e-5; both refuse a length the chunks do not
  divide;
* ``embed_inputs`` against the JAX package's (rtol 1e-5: the frontend's
  projection is a matmul on either side);
* paligemma: ``prefill`` of patches + tokens, then 8 greedy
  ``decode_step``s at ``lengths = prefix_len + S``, fp32 state: logits to
  rtol 1e-4, atol 1e-4 * max|logits|, identical tokens; MX8 (the kernels'
  plain versions): prefill to rtol 1e-4, first step to rtol 1e-3, token
  agreement reported; the prefix is bidirectional and the text is not;
* hubert: per-position prefill logits (B, S, V) to rtol 1e-4 and no
  caches; a frame late in the clip moves the first position's logits;
* the refusals: every decode entry point on an encoder, both engines and
  the launcher on an encoder and on a frontend (the engines prefill token
  prompts only, as the JAX package's do), ``check_supported`` on an
  unknown frontend; paligemma's ``decode_op_plans`` equal to JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as JOPS
from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.models import attention as JATT
from repro.models import model as JM
from repro_torch import ops as TOPS
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import attention as TATT
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.api import Engine, ServeConfig

from test_torch_configs import jax_param_count, meta_param_count, same_config
from test_torch_dense_family import _close

torch.set_num_threads(1)  # test workers share the cores: one thread each

ARCHS = ("paligemma-3b", "hubert-xlarge")
VLM, AUDIO = ARCHS
N_STEPS = 8
_PAIRS = {}


def _pair(arch, fmt="fp32", rounding="stochastic"):
    """(JAX cfg, port cfg, JAX params, port params): the same weights, one
    JAX init a config."""
    key = (arch, fmt, rounding)
    if key not in _PAIRS:
        jb, tb = ("jnp", "torch") if fmt != "mx8" else ("jnp", "cuda")
        jcfg = j_smoke(arch).with_(state_quant=JOPS.StateQuantConfig(
            fmt, rounding, jb))
        tcfg = t_smoke(arch).with_(state_quant=TOPS.StateQuantConfig(
            fmt, rounding, tb))
        base = next((v for k, v in _PAIRS.items() if k[0] == arch), None)
        if base is None:
            jparams = JM.init_model(jax.random.PRNGKey(0), jcfg)
            tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
        else:
            jparams, tparams = base[2], base[3]
        _PAIRS[key] = (jcfg, tcfg, jparams, tparams)
    return _PAIRS[key]


def _batch(cfg, B=2, n_text=24, n_frames=48, seed=1):
    """numpy inputs: patches (B, prefix_len, frontend_dim) and tokens for
    the patch frontend, frames (B, n_frames, frontend_dim) for audio."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        return {"frames": rng.standard_normal(
            (B, n_frames, cfg.frontend_dim)).astype(np.float32)}
    return {"patches": rng.standard_normal(
                (B, cfg.prefix_len, cfg.frontend_dim)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, n_text))}


def _jax_batch(batch):
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
            for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax_field_for_field(arch):
    same_config(t_full(arch), j_full(arch))
    same_config(t_smoke(arch), j_smoke(arch))
    TM.check_supported(t_full(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_equals_jax_eval_shape(arch):
    want = {VLM: 2_511_022_080, AUDIO: 945_267_200}[arch]
    assert meta_param_count(t_full(arch)) == jax_param_count(j_full(arch)) \
        == want


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_frontend_proj(arch):
    jcfg, tcfg, jparams, tparams = _pair(arch)
    np.testing.assert_array_equal(tparams["frontend_proj"].numpy(),
                                  np.asarray(jparams["frontend_proj"]))
    assert tuple(tparams["frontend_proj"].shape) == (tcfg.frontend_dim,
                                                     tcfg.d_model)
    assert ("embed" in tparams) == (arch == VLM)
    own = TM.init_model(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(own) == set(tparams)
    conv, mine = (jax.tree_util.tree_leaves(t) for t in (tparams, own))
    assert [tuple(a.shape) for a in conv] == [tuple(a.shape) for a in mine]


# ---------------------------------------------------------------------------
# prefix-LM and non-causal attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,prefix_len", [
    (True, 0), (True, 5), (True, 20), (True, 64), (False, 0), (False, 20)])
def test_blockwise_attention_matches_jax(causal, prefix_len):
    """Grouped queries (4 heads over 1 kv head), 64 positions in 16-position
    chunks: a prefix inside the first chunk, one across two chunks, one
    that opens the whole sequence; non-causal ignores the prefix."""
    rng = np.random.default_rng(prefix_len + 100 * causal)
    q = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 64, 1, 16)).astype(np.float32)
    v = rng.standard_normal((2, 64, 1, 24)).astype(np.float32)
    kw = dict(causal=causal, prefix_len=prefix_len, q_chunk=16, kv_chunk=16)
    want = JATT.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), **kw)
    got = TATT.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), **kw)
    _close(want, got, 1e-5)
    if prefix_len == 64 or not causal:
        full = TATT.blockwise_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=False, q_chunk=64, kv_chunk=64)
        _close(full.numpy(), got, 1e-5)


def test_blockwise_attention_refuses_what_the_chunks_do_not_divide():
    x = torch.zeros((1, 40, 2, 8))
    with pytest.raises(ValueError, match="multiple of the chunks"):
        TATT.blockwise_attention(x, x, x, q_chunk=16, kv_chunk=16)
    with pytest.raises(AssertionError):
        JATT.blockwise_attention(jnp.zeros((1, 40, 2, 8)),
                                 jnp.zeros((1, 40, 2, 8)),
                                 jnp.zeros((1, 40, 2, 8)), q_chunk=16,
                                 kv_chunk=16)


@pytest.mark.parametrize("arch", ARCHS)
def test_embed_inputs_matches_jax(arch):
    jcfg, tcfg, jparams, tparams = _pair(arch)
    batch = _batch(tcfg)
    jx, jpos, jprefix = JM.embed_inputs(jparams, jcfg, _jax_batch(batch))
    tx, tpos, tprefix = TM.embed_inputs(tparams, tcfg, _torch_batch(batch))
    _close(jx, tx, 1e-5)
    np.testing.assert_array_equal(np.asarray(jpos), tpos.numpy())
    assert tprefix == jprefix == (tcfg.prefix_len if arch == VLM else 0)


# ---------------------------------------------------------------------------
# paligemma: patch prefix + tokens, then decode
# ---------------------------------------------------------------------------

def _run_vlm(jcfg, tcfg, jparams, tparams, n_steps=N_STEPS):
    """Prefill 16 patches + 24 tokens a row (B = 2) and decode ``n_steps``
    greedy steps from ``lengths = prefix_len + S`` on both sides."""
    batch = _batch(tcfg)
    S = tcfg.prefix_len + batch["tokens"].shape[1]
    jl, jc = jax.jit(lambda p, b: JM.prefill(p, jcfg, b))(
        jparams, _jax_batch(batch))
    tl, tc = TM.prefill(tparams, tcfg, _torch_batch(batch))
    jc = JM.set_cache_lengths(jc, jnp.full((2,), S, jnp.int32))
    tc = TM.set_cache_lengths(tc, torch.full((2,), S))
    jdec = jax.jit(lambda p, t, c, L, s: JM.decode_step(p, jcfg, t, c, L, s))
    out = [(jl, tl)]
    jt, tt = jnp.argmax(jl, -1).astype(jnp.int32), torch.argmax(tl, -1)
    for i in range(n_steps):
        lens = np.full((2,), S + i, np.int32)
        jl, jc = jdec(jparams, jt, jc, jnp.asarray(lens), jnp.int32(i))
        tl, tc = TM.decode_step(tparams, tcfg, tt, tc,
                                torch.from_numpy(lens), seed=i)
        out.append((jl, tl))
        jt, tt = jnp.argmax(jl, -1).astype(jnp.int32), torch.argmax(tl, -1)
    return out


def test_vlm_fp32_prefill_and_greedy_decode_match_jax():
    for i, (jl, tl) in enumerate(_run_vlm(*_pair(VLM))):
        _close(jl, tl, 1e-4)
        np.testing.assert_array_equal(np.asarray(jnp.argmax(jl, -1)),
                                      torch.argmax(tl, -1).numpy(),
                                      err_msg=f"step {i}")


def test_vlm_mx8_first_step_and_token_agreement():
    steps = _run_vlm(*_pair(VLM, "mx8"))
    _close(steps[0][0], steps[0][1], 1e-4)
    _close(steps[1][0], steps[1][1], 1e-3)
    agree = np.mean([np.array_equal(np.asarray(jnp.argmax(jl, -1)),
                                    torch.argmax(tl, -1).numpy())
                     for jl, tl in steps])
    print(f"{VLM} mx8 greedy token agreement over {len(steps)} steps: "
          f"{agree:.2f}")
    assert all(np.isfinite(tl.numpy()).all() for _, tl in steps)


def test_vlm_prefix_is_bidirectional_and_text_causal():
    """The second layer's cached K at position 0 (a patch) reads the first
    layer's attention there: it moves with the last patch (the prefix is
    open to every query) and not with the text tokens (causal)."""
    _, tcfg, _, tparams = _pair(VLM)
    batch = _torch_batch(_batch(tcfg))

    def k0(b):
        return TM.prefill(tparams, tcfg, b)[1][1][0].k[:, 0]

    base = k0(batch)
    moved = dict(batch, patches=batch["patches"].clone())
    moved["patches"][:, -1] += 1.0
    assert not torch.equal(k0(moved), base)
    text = dict(batch, tokens=(batch["tokens"] + 1) % tcfg.vocab_size)
    assert torch.equal(k0(text), base)


# ---------------------------------------------------------------------------
# hubert: the encoder's prefill
# ---------------------------------------------------------------------------

def test_encoder_per_position_logits_match_jax():
    jcfg, tcfg, jparams, tparams = _pair(AUDIO)
    batch = _batch(tcfg)
    jl, jc = jax.jit(lambda p, b: JM.prefill(p, jcfg, b))(
        jparams, _jax_batch(batch))
    tl, tc = TM.prefill(tparams, tcfg, _torch_batch(batch))
    assert jc is None and tc is None
    assert tuple(tl.shape) == (2, 48, tcfg.vocab_size)
    _close(jl, tl, 1e-4)


def test_encoder_is_not_causal():
    _, tcfg, _, tparams = _pair(AUDIO)
    batch = _torch_batch(_batch(tcfg))
    base = TM.prefill(tparams, tcfg, batch)[0]
    frames = batch["frames"].clone()
    frames[:, -1] += 1.0
    moved = TM.prefill(tparams, tcfg, {"frames": frames})[0]
    assert not torch.equal(moved[:, 0], base[:, 0])


# ---------------------------------------------------------------------------
# refusals and plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", ["decode_step", "paged_decode_step",
                                  "paged_spec_decode_step"])
def test_encoder_has_no_decode_step(step):
    _, tcfg, _, tparams = _pair(AUDIO)
    tokens = torch.zeros((2,) if step != "paged_spec_decode_step" else (2, 4),
                         dtype=torch.long)
    with pytest.raises(ValueError, match="encoder-only: no decode step"):
        getattr(TM, step)(tparams, tcfg, tokens, None,
                          torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("backend", ["slots", "paged"])
@pytest.mark.parametrize("arch,match", [
    (VLM, "prefill token prompts only"), (AUDIO, "encoder-only")])
def test_engines_refuse(arch, match, backend):
    _, tcfg, _, tparams = _pair(arch)
    with pytest.raises(ValueError, match=match):
        Engine(tparams, tcfg, ServeConfig(backend=backend, batch=2))


@pytest.mark.parametrize("arch,match", [
    (VLM, "prefill token prompts only"), (AUDIO, "nothing to serve")])
def test_launcher_refuses(arch, match):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match=match):
        serve.main(["--arch", arch, "--smoke-size", "--device", "cpu"])


def test_check_supported_refuses_an_unknown_frontend():
    with pytest.raises(NotImplementedError, match="frontend 'video'"):
        TM.check_supported(t_smoke(VLM).with_(frontend="video"))


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("spec_k", [0, 3])
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_vlm_decode_op_plans_match_jax(size, spec_k, layout):
    jc, tc = ((j_smoke(VLM), t_smoke(VLM)) if size == "smoke"
              else (j_full(VLM), t_full(VLM)))
    je = JOPS.decode_op_plans(jc, 4, 300, layout=layout, spec_k=spec_k)
    te = TOPS.decode_op_plans(tc, 4, 300, layout=layout, spec_k=spec_k)
    assert [(e.kind, e.count) for e in te] == [(e.kind, e.count) for e in je]
    for a, b in zip(je, te):
        assert b.plan.dims == a.plan.dims
        assert b.traffic.__dict__ == a.traffic.__dict__, a.kind
    if size == "full":
        assert dict(te[0].plan.dims, B=0) == dict(
            B=0, T=300, KVH=1, dk=256, dv=256, n=1, H=8,
            **({"Kq": spec_k + 1} if spec_k else {}))
