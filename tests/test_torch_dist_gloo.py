"""The distribution layer across processes: four CPU ranks over gloo, the
twin of ``tests/test_sharding.py``'s five tests (which run the JAX package
on eight fake host devices).

One spawn serves the file: a module fixture starts four ranks of
``_RANKS`` (a (2, 2) mesh, with (4, 1), (1, 4) and a 4-rank 'pod' axis
where a test needs them); each rank writes what it computed to an
``.npz``, and the tests hold those against the port's single-device steps
and against the JAX package (which the ranks never import):

* sharded training of llama3.2-1b (ZeRO parameters and moments, a mask
  with unequal counts per data rank, and two microbatches) against the
  single-device step: loss within 1e-4, parameters within 5e-3;
* MoE expert parallelism at dbrx's smoke size against JAX's ``_moe_local``
  under ``jax.vmap(axis_name=...)`` one data shard at a time, and its
  gradients against the unsharded MoE's where no expert overflows;
* sharded prefill + decode of zamba2 against the single-device steps;
* the compressed all-reduce over the 'pod' axis against JAX's ``pmean``;
* a checkpoint saved at (2, 2) restored bitwise at (4, 1) and (1, 4);
* a dim sharded over ("data", "model") in JAX's major-to-minor order.
"""
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import subprocess_env
from repro.configs import get_smoke_config as j_smoke
from repro.dist import compression as JCOMP
from repro.models import layers as JL
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import tree as T
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.launch.mesh import local_init_method
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.train import optimizer as TO
from repro_torch.train.train_loop import make_train_step

WORLD = 4
SEQ, BATCH = 32, 4
MOE_X = (4, 16)                       # dbrx's (batch, seq) for the EP test
DECODE = dict(B=4, S=16, steps=4)

_RANKS = r'''
import os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
out = sys.argv[1]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=os.environ["DIST_INIT"],
                        rank=rank, world_size=world)

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.core import tree as T
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.dist import compression as C
from repro_torch.dist import sharding as SH
from repro_torch.launch.mesh import make_local_parallel
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import make_train_step

res = {}
par = make_local_parallel(2, 2, device_type="cpu")
g = lambda seed: torch.Generator().manual_seed(seed)

def full(tree):
    return [x.full_tensor().numpy() for x in T.leaves(tree)]

# 1. sharded training: two steps, the second with two microbatches
cfg = get_smoke_config("llama3.2-1b")
opt = O.OptimizerConfig(lr=1e-3)
params = M.init_model(cfg, g(0), device="cpu")
state = O.init_opt_state(params, opt)
p_shard = SH.param_shardings(params, cfg, par)
params = SH.distribute(params, p_shard)
state = SH.distribute(state, SH.opt_state_shardings(state, p_shard, par))
batch = make_batch_fn(cfg, %(SEQ)d, %(BATCH)d)(0)
batch["mask"][0, 5:] = 0.0            # data rank 0's rows count less
batch["mask"][1, 20:] = 0.0
for i, ga in enumerate((1, 2)):
    params, state, m = make_train_step(cfg, opt, par=par, grad_accum=ga)(
        params, state, batch)
    res[f"train_loss{i}"] = m["loss"].numpy()
    res[f"train_gnorm{i}"] = m["grad_norm"].numpy()
res.update({f"train_p{i}": a for i, a in enumerate(full(params))})
res.update({f"train_m{i}": a for i, a in enumerate(full(state["m"]))})

# 2. MoE expert parallelism (dbrx): forward and gradients, each rank its
# rows and its experts
for tag, cf in (("moe", None), ("moe_nodrop", 8.0)):
    mcfg = get_smoke_config("dbrx-132b")
    if cf is not None:
        mcfg = mcfg.with_(moe=mcfg.moe.__class__(**{
            **mcfg.moe.__dict__, "capacity_factor": cf}))
    ref = np.load(os.path.join(out, "moe_in.npz"))
    E = mcfg.moe.n_experts
    d_i, m_i = par.coordinate("data"), par.coordinate("model")
    rows = slice(d_i * 2, d_i * 2 + 2)
    ex = slice(m_i * E // 2, (m_i + 1) * E // 2)
    p = {"router": torch.from_numpy(ref["router"]).requires_grad_(True)}
    for k in ("wi", "wg", "wo"):
        p[k] = torch.from_numpy(ref[k][ex]).requires_grad_(True)
    x = torch.from_numpy(ref["x"][rows]).requires_grad_(True)
    y = L.apply_moe(p, x, mcfg, par)
    (y * torch.from_numpy(ref["cot"][rows])).sum().backward()
    res[f"{tag}_y"] = y.detach().numpy()
    for k in ("router", "wi", "wg", "wo"):
        res[f"{tag}_g{k}"] = p[k].grad.numpy()
    res[f"{tag}_gx"] = x.grad.numpy()

# 3. sharded prefill + greedy decode of zamba2, at its stochastic rounding
# and at round-to-nearest
zcfg = get_smoke_config("zamba2-2.7b")
tok = torch.from_numpy(np.load(os.path.join(out, "decode_in.npy")))
B, S = tok.shape
for tag, rounding in (("sr", "stochastic"), ("rn", "nearest")):
    c = zcfg.with_(state_quant=zcfg.state_quant.__class__(
        zcfg.state_quant.fmt, rounding, zcfg.state_quant.backend))
    zp = M.init_model(c, g(0), device="cpu")
    zp = SH.distribute(zp, SH.param_shardings(zp, c, par))
    tb = SH.distribute({"tokens": tok},
                       SH.batch_shardings({"tokens": tok}, par))
    logits, caches = SH.sharded_prefill(zp, c, tb, par)
    lengths = torch.full((B,), S, dtype=torch.int32)
    ln_layout = SH.batch_shardings(lengths, par)
    step_logits = [logits.full_tensor().numpy()]
    nxt = torch.argmax(logits.full_tensor(), -1)
    for s in range(%(STEPS)d):
        t_d = SH.distribute(nxt, ln_layout)
        l_d = SH.distribute(lengths + s, ln_layout)
        logits, caches = SH.sharded_decode_step(zp, c, t_d, caches, l_d, par,
                                                seed=5 + s)
        step_logits.append(logits.full_tensor().numpy())
        nxt = torch.argmax(logits.full_tensor(), -1)
    res[f"decode_{tag}"] = np.stack(step_logits)

# 4. the compressed all-reduce over a 4-rank 'pod' axis
from repro_torch.dist.compat import init_device_mesh
pod = SH.Parallel(init_device_mesh("cpu", (world,), mesh_dim_names=("pod",)),
                  data_axes=("pod",))
gw = np.load(os.path.join(out, "comp_in.npy"))[rank]
grads = {"w": torch.from_numpy(gw)}
red, ef = C.compressed_allreduce_mean(grads, C.init_error_feedback(grads),
                                      pod.group("pod"))
res["comp_red"], res["comp_ef"] = red["w"].numpy(), ef["w"].numpy()

# 5. elastic restore: saved at (2, 2), restored at (4, 1) and (1, 4)
scfg = get_smoke_config("smollm-360m")
sp = M.init_model(scfg, g(0), device="cpu")
mgr = CheckpointManager(os.path.join(out, "ckpt"))
mgr.save(7, SH.distribute(sp, SH.param_shardings(sp, scfg, par)))
for tag, shape in (("4x1", (4, 1)), ("1x4", (1, 4))):
    par_b = make_local_parallel(*shape, device_type="cpu")
    sh_b = SH.param_shardings(sp, scfg, par_b)
    got, step = mgr.restore({"params": sp, "opt_state": None},
                            shardings={"params": sh_b, "opt_state": None})
    res[f"ckpt_step_{tag}"] = np.asarray(step)
    res[f"ckpt_local_{tag}"] = np.asarray(
        [x.to_local().numel() for x in T.leaves(got["params"])])
    res.update({f"ckpt_{tag}_{i}": a
                for i, a in enumerate(full(got["params"]))})

# 6. one dim over two axes, major to minor: JAX's P(("data", "model"))
x = torch.arange(8, dtype=torch.float32)
res["major_minor"] = SH.distribute(
    x, par.named((("data", "model"),))).to_local().numpy()

np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
dist.barrier()
dist.destroy_process_group()
''' % dict(SEQ=SEQ, BATCH=BATCH, STEPS=DECODE["steps"])


def _moe_cfgs(capacity_factor=None):
    jc, tc = j_smoke("dbrx-132b"), t_smoke("dbrx-132b")
    if capacity_factor is not None:
        jc = jc.with_(moe=jc.moe.__class__(**{
            **jc.moe.__dict__, "capacity_factor": capacity_factor}))
        tc = tc.with_(moe=tc.moe.__class__(**{
            **tc.moe.__dict__, "capacity_factor": capacity_factor}))
    return jc, tc


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Four gloo ranks of ``_RANKS``, once for the file: their results
    (one dict a rank) and the inputs they were given."""
    out = tmp_path_factory.mktemp("gloo")
    jc, _ = _moe_cfgs()
    p = jax.tree.map(np.array, JL.init_moe(jax.random.PRNGKey(0), jc))
    r = np.random.default_rng(1)
    x = r.standard_normal(MOE_X + (jc.d_model,)).astype(np.float32)
    cot = r.standard_normal(x.shape).astype(np.float32)
    np.savez(out / "moe_in.npz", x=x, cot=cot, router=p["router"],
             wi=p["wi"], wg=p["wg"], wo=p["wo"])
    zc = t_smoke("zamba2-2.7b")
    tok = r.integers(0, zc.vocab_size, (DECODE["B"], DECODE["S"]))
    np.save(out / "decode_in.npy", tok)
    grads = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                         (WORLD, 64, 32)))
    np.save(out / "comp_in.npy", grads)
    init = local_init_method()
    t0 = time.perf_counter()
    logs = [open(out / f"rank{i}.log", "w") for i in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANKS, str(out)],
        env=subprocess_env(RANK=str(i), WORLD_SIZE=str(WORLD),
                           DIST_INIT=init, OMP_NUM_THREADS="1"),
        stdout=logs[i], stderr=subprocess.STDOUT) for i in range(WORLD)]
    # a rank that fails leaves the others waiting in a collective: end
    # them all then, and at the deadline
    deadline = time.monotonic() + 600
    while any(proc.poll() is None for proc in procs) \
            and time.monotonic() < deadline \
            and not any(proc.poll() for proc in procs):
        time.sleep(0.1)
    for proc, log in zip(procs, logs):
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        log.close()
    for i, proc in enumerate(procs):
        text = (out / f"rank{i}.log").read_text()
        assert proc.returncode == 0, f"rank {i}:\n{text[-4000:]}"
    print(f"four gloo ranks: {time.perf_counter() - t0:.1f} s")
    res = [dict(np.load(out / f"rank{i}.npz")) for i in range(WORLD)]
    return res, dict(moe=(p, x, cot), tok=tok, grads=grads)


def _coord(rank):
    """(data, model) of ``rank`` on the (2, 2) mesh (row-major)."""
    return rank // 2, rank % 2


def test_sharded_train_matches_single_device(ranks):
    res, _ = ranks
    cfg = t_smoke("llama3.2-1b")
    opt = TO.OptimizerConfig(lr=1e-3)
    params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    state = TO.init_opt_state(params, opt)
    batch = make_batch_fn(cfg, SEQ, BATCH)(0)
    batch["mask"][0, 5:] = 0.0
    batch["mask"][1, 20:] = 0.0
    losses = []
    for ga in (1, 2):
        params, state, m = make_train_step(cfg, opt, grad_accum=ga)(
            params, state, batch)
        losses.append(float(m["loss"]))
    for r in res:
        for i, want in enumerate(losses):
            assert abs(float(r[f"train_loss{i}"]) - want) < 1e-4
    leaves = T.leaves(params)
    d = max(float(np.max(np.abs(res[0][f"train_p{i}"] - p.numpy())))
            for i, p in enumerate(leaves))
    print("LOSS", losses, [float(res[0][f"train_loss{i}"]) for i in (0, 1)],
          "MAXDIFF", d)
    assert d < 5e-3
    # the ranks agree: one model, whatever its shards
    for r in res[1:]:
        for i in range(len(leaves)):
            np.testing.assert_array_equal(r[f"train_p{i}"],
                                          res[0][f"train_p{i}"])
    # ZeRO: the moments were reduced too (not a rank's own rows alone)
    m_diff = max(float(np.max(np.abs(res[0][f"train_m{i}"] - m.numpy())))
                 for i, m in enumerate(T.leaves(state["m"])))
    assert m_diff < 5e-4


def test_moe_ep_matches_jax_and_local(ranks):
    res, inp = ranks
    p, x, _ = inp["moe"]
    jc, tc = _moe_cfgs()
    E = jc.moe.n_experts
    for d_i in range(2):
        rows = slice(2 * d_i, 2 * d_i + 2)
        stacked = [p[k].reshape((2, E // 2) + p[k].shape[1:])
                   for k in ("wi", "wg", "wo")]
        yj = jax.vmap(lambda wi, wg, wo: JL._moe_local(
            jnp.asarray(x[rows]), jnp.asarray(p["router"]), wi, wg, wo, jc,
            ep_axis="m"), axis_name="m")(*map(jnp.asarray, stacked))
        for m_i in range(2):
            got = res[2 * d_i + m_i]["moe_y"]
            np.testing.assert_allclose(got, np.asarray(yj[m_i]), rtol=1e-5,
                                       atol=1e-5)
    y_ep = np.concatenate([res[0]["moe_y"], res[2]["moe_y"]])
    y_local = TL.apply_moe({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), tc).numpy()
    frac = float(np.mean(np.abs(y_local - y_ep) < 1e-4))
    print("AGREE", frac)
    assert frac > 0.95


def test_moe_ep_gradients_equal_the_unsharded_moe(ranks):
    """Where no expert overflows, EP's gradients are the unsharded MoE's:
    the router's and ``x``'s summed over the model axis (Megatron's f),
    none of them ``tp`` times too large."""
    res, inp = ranks
    p, x, cot = inp["moe"]
    _, tc = _moe_cfgs(8.0)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = TL.apply_moe(tp, xt, tc)
    (y * torch.from_numpy(cot)).sum().backward()
    y_ep = np.concatenate([res[0]["moe_nodrop_y"], res[2]["moe_nodrop_y"]])
    np.testing.assert_allclose(y_ep, y.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    tol = dict(rtol=1e-4, atol=1e-5)
    # the router: replicated, its gradient whole on every model rank after
    # the backward's sum; the data ranks hold their rows' shares
    for m_i in range(2):
        got = res[m_i]["moe_nodrop_grouter"] + res[2 + m_i][
            "moe_nodrop_grouter"]
        np.testing.assert_allclose(got, tp["router"].grad.numpy(), **tol)
    for k in ("wi", "wg", "wo"):
        got = np.concatenate([res[m_i][f"moe_nodrop_g{k}"]
                              + res[2 + m_i][f"moe_nodrop_g{k}"]
                              for m_i in range(2)])
        np.testing.assert_allclose(got, tp[k].grad.numpy(), **tol)
    for r in range(WORLD):
        d_i, _ = _coord(r)
        np.testing.assert_allclose(res[r]["moe_nodrop_gx"],
                                   xt.grad.numpy()[2 * d_i:2 * d_i + 2],
                                   **tol)


def _single_device_decode(cfg, tok):
    """Prefill + greedy decode steps of the port on one device: the logits
    of every step, (steps + 1, B, V)."""
    params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    B, S = tok.shape
    logits, caches = TM.prefill(params, cfg, {"tokens": tok})
    out = [logits.numpy()]
    lengths = torch.full((B,), S, dtype=torch.int32)
    nxt = torch.argmax(logits, -1)
    for s in range(DECODE["steps"]):
        logits, caches = TM.decode_step(params, cfg, nxt, caches,
                                        lengths + s, seed=5 + s)
        out.append(logits.numpy())
        nxt = torch.argmax(logits, -1)
    return np.stack(out)


def test_decode_sharded_matches_single_device(ranks):
    """Each rank decodes its rows (model axis: replicated), with its
    stochastic-rounding draws counted from its first row of the whole
    batch, so the sharded prefill + decode steps are the single-device
    steps on the whole batch, at zamba2's stochastic rounding and at
    round-to-nearest: |dlogit| below JAX's 1e-2 and the greedy tokens
    equal -- here bitwise, on every rank."""
    res, inp = ranks
    cfg = t_smoke("zamba2-2.7b")
    tok = torch.from_numpy(inp["tok"])
    rn = cfg.with_(state_quant=cfg.state_quant.__class__(
        cfg.state_quant.fmt, "nearest", cfg.state_quant.backend))
    for tag, c in (("sr", cfg), ("rn", rn)):
        want = _single_device_decode(c, tok)
        got = res[0][f"decode_{tag}"]
        assert np.max(np.abs(got - want)) < 1e-2, tag
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_array_equal(got, want)
        for r in res[1:]:
            np.testing.assert_array_equal(r[f"decode_{tag}"], got)


def test_gradient_compression_error_feedback(ranks):
    res, inp = ranks
    grads = inp["grads"]
    ef0 = np.zeros((WORLD,) + grads.shape[1:], np.float32)
    red_j, ef_j = jax.vmap(lambda g, e: JCOMP.compressed_allreduce_mean(
        {"w": g}, {"w": e}, "pod"), axis_name="pod")(
        jnp.asarray(grads), jnp.asarray(ef0))
    for r in range(WORLD):
        np.testing.assert_allclose(res[r]["comp_red"],
                                   np.asarray(red_j["w"][r]), rtol=1e-6,
                                   atol=1e-7)
        # the residual is the rank's own: bitwise JAX's
        np.testing.assert_array_equal(res[r]["comp_ef"],
                                      np.asarray(ef_j["w"][r]))
    exact = grads.mean(0)
    err = float(np.max(np.abs(res[0]["comp_red"] - exact)))
    step = float(np.abs(grads).max()) / 127
    print("ERR", err, "STEP", step)
    assert err < 4 * step
    assert float(np.max(np.abs(res[0]["comp_ef"]))) > 0


def test_checkpoint_elastic_mesh_reshard(ranks):
    res, _ = ranks
    cfg = t_smoke("smollm-360m")
    params = TM.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    leaves = T.leaves(params)
    for tag in ("4x1", "1x4"):
        for r in res:
            assert int(r[f"ckpt_step_{tag}"]) == 7
            for i, p in enumerate(leaves):
                np.testing.assert_array_equal(r[f"ckpt_{tag}_{i}"],
                                              p.numpy())
        # each rank holds a quarter of the sharded leaves, not all of them
        assert int(res[0][f"ckpt_local_{tag}"].sum()) < sum(
            p.numel() for p in leaves)


def test_a_dim_over_two_axes_is_sharded_major_to_minor(ranks):
    """``Spec(("data", "model"))`` on a (2, 2) mesh: rank (i, j) holds
    chunk ``i * 2 + j``, the device order of JAX's ``P(("data",
    "model"))``."""
    res, _ = ranks
    for r in range(WORLD):
        d_i, m_i = _coord(r)
        chunk = d_i * 2 + m_i
        np.testing.assert_array_equal(res[r]["major_minor"],
                                      [2 * chunk, 2 * chunk + 1])
