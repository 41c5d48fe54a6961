"""The port's layout builders (``repro_torch/dist/sharding.py``) against the
JAX package's, spec for spec, with no process and no device: both run
against a shape-only mesh (the JAX side through a ``Parallel`` whose
``named`` returns the spec itself), for every config's smoke parameters
at five meshes.

The port's parameters and caches are per-layer lists where the JAX
package stacks a ``(G, ...)`` group axis: a per-layer leaf is compared
against the JAX stacked leaf without its stack entry (which must be
``None``).  Also here: the placements a spec turns into, the configs'
dry-run cells, and the shape-only input specs."""
import dataclasses
import types

import jax
import pytest
import torch

from repro.configs import ALL_ARCHS as J_ARCHS
from repro.configs import cell_supported as j_cell_supported
from repro.configs import get_smoke_config as j_smoke
from repro.dist import sharding as JSH
from repro.launch import specs as JSP
from repro.models import model as JM
from repro.models.config import SHAPES as J_SHAPES
from repro_torch import configs as TC
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import tree as T
from repro_torch.dist import sharding as SH
from repro_torch.launch import specs as TSP
from repro_torch.models import model as TM
from repro_torch.models.config import SHAPES

torch.set_num_threads(1)  # test workers share the cores: one thread each

MESHES = [
    ((2, 4), ("data", "model"), ("data",)),
    ((4, 2), ("data", "model"), ("data",)),
    ((1, 8), ("data", "model"), ("data",)),
    ((8, 1), ("data", "model"), ("data",)),
    ((2, 2, 2), ("pod", "data", "model"), ("pod", "data")),
]
MESH_IDS = ["2x4", "4x2", "1x8", "8x1", "pod2x2x2"]


class _SpecParallel(JSH.Parallel):
    """The JAX ``Parallel`` over a shape-only mesh: layouts as specs."""

    def named(self, spec):
        return spec


def _pars(mesh):
    shape, names, data_axes = mesh
    jpar = _SpecParallel(mesh=types.SimpleNamespace(
        shape=dict(zip(names, shape))), data_axes=data_axes)
    tpar = SH.Parallel(SH.AbstractMesh(shape, names), data_axes=data_axes)
    return jpar, tpar


def _jax_names(path):
    out = []
    for k in path:
        if isinstance(k, jax.tree_util.DictKey):
            out.append(str(k.key))
        elif isinstance(k, jax.tree_util.SequenceKey):
            out.append(str(k.idx))
        elif isinstance(k, jax.tree_util.GetAttrKey):
            out.append(k.name)
        else:
            out.append(str(k))
    return tuple(out)


def _norm(spec):
    """A spec with each entry as its tuple of axes (JAX writes a one-axis
    tuple entry as the bare name)."""
    return tuple(SH._axes(e) for e in spec)


def _jax_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {_jax_names(p): _norm(s) for p, s in flat}


def _port_specs(tree):
    return {tuple(str(k) for k in p): _norm(layout.spec)
            for p, layout in T.leaves_with_paths(tree)}


def _match(port, jax_specs, stacked_at):
    """Pair each port leaf with the JAX leaf it comes from: a group layer's
    ``(..., g, pos, rest)`` is JAX's ``(..., pos, rest)`` with a stack
    entry first.  ``stacked_at``: the path prefix length of the layer index
    ``g`` for a group leaf, or None for a leaf outside the groups; a JAX
    ``P()`` (replicated) is ``()`` on both sides."""
    pairs = []
    for path, spec in port.items():
        at = stacked_at(path)
        if at is None:
            pairs.append((path, spec, jax_specs[path]))
            continue
        jpath = path[:at] + path[at + 1:]
        want = jax_specs[jpath]
        if want:                   # P() replicates the stacked leaf whole
            assert want[0] == (), (jpath, want)     # the scan-stack axis
            want = want[1:]
        pairs.append((path, spec, want))
    return pairs


def _param_group_index(path):
    return 1 if path[0] == "groups" else None


def _cache_group_index(path):
    if path[0] == "prelude":
        return None
    return 1 if path[0] == "groups" else 0


# (batch, capacity) of the cache layouts: a batch that divides every
# mesh's data axes, and one that does not (the caches' time axis then
# spreads over data and model)
_CACHE_CELLS = ((8, 128), (3, 256))


@pytest.fixture(scope="module", autouse=True)
def _jax_probe_once():
    """The JAX builder probes its cache skeleton (three ``eval_shape``s)
    on every call; it is a pure function of the config, so the module
    asks it once per config."""
    probe = JSH._probe_cache_axes
    seen = {}
    JSH._probe_cache_axes = lambda cfg: (
        seen[cfg] if cfg in seen else seen.setdefault(cfg, probe(cfg)))
    yield
    JSH._probe_cache_axes = probe


@pytest.fixture(scope="module")
def trees():
    out = {}
    for arch in TC.ALL_ARCHS:
        jc, tc = j_smoke(arch), t_smoke(arch)
        tparams = TM.init_model(tc, torch.Generator().manual_seed(0),
                                device="meta")
        caches = {} if tc.encoder_only else {
            (B, cap): (JM.abstract_decode_caches(jc, B, cap),
                       TM.init_decode_caches(tc, B, cap, device="meta"))
            for B, cap in _CACHE_CELLS}
        out[arch] = (jc, tc, JSP.params_struct(jc), tparams, caches)
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", TC.ALL_ARCHS)
def test_param_and_opt_layouts_equal_jax(trees, arch, mesh):
    jc, tc, jparams, tparams, _ = trees[arch]
    jpar, tpar = _pars(mesh)
    jspec = _jax_specs(JSH.param_shardings(jparams, jc, jpar))
    tlay = SH.param_shardings(tparams, tc, tpar)
    pairs = _match(_port_specs(tlay), jspec, _param_group_index)
    assert len(pairs) == sum(1 for _ in T.leaves_with_paths(tparams)) > 0
    for path, got, want in pairs:
        assert got == want, (path, got, want)
    # every JAX leaf has a port counterpart: per group layer, or itself
    n_groups = tc.n_groups
    assert len(pairs) == sum(n_groups if p[0] == "groups" else 1
                             for p in jspec)
    # ZeRO: the moments follow the parameters, the step replicates
    jopt = JSH.opt_state_shardings(None, JSH.param_shardings(
        jparams, jc, jpar), jpar)
    topt = SH.opt_state_shardings(None, tlay, tpar)
    assert topt["m"] is tlay and topt["v"] is tlay
    assert tuple(topt["step"].spec) == tuple(jopt["step"]) == ()


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", TC.ALL_ARCHS)
def test_batch_and_cache_layouts_equal_jax(trees, arch, mesh):
    jc, tc, _, _, caches = trees[arch]
    jpar, tpar = _pars(mesh)
    for B, cap in _CACHE_CELLS:
        sc = dataclasses.replace(SHAPES["train_4k"], global_batch=B,
                                 seq_len=256)
        jb = _jax_specs(JSH.batch_shardings(JSP.batch_struct(jc, sc), jpar))
        tb = _port_specs(SH.batch_shardings(TSP.batch_struct(tc, sc), tpar))
        assert tb == jb
        if not tc.encoder_only:
            jcache, tcache = caches[(B, cap)]
            jspec = _jax_specs(JSH.cache_shardings(jcache, jc, jpar, B))
            tspec = _port_specs(SH.cache_shardings(tcache, tc, tpar, B))
            pairs = _match(tspec, jspec, _cache_group_index)
            assert pairs
            for path, got, want in pairs:
                assert got == want, (path, got, want)


def _tp_head_dim(cfg, path, tp):
    """The dim of a cache leaf (at ``path`` in the port's cache tree) that
    the tensor-parallel step splits over ``tp`` model ranks, from the
    config alone: a GQA layer's K and V payloads (dim 2, its kv heads)
    where tp divides the kv heads, a Mamba-2 or mLSTM layer's state (dim
    1, its heads) and conv tail (dim 2, its heads' channels) and a
    GLA-family layer's state where tp divides its heads; else None (MLA's
    latent and the sLSTM's carries are whole on every rank)."""
    if tp == 1:
        return None
    if path[0] == "prelude":
        kind = cfg.prelude[path[1]]
        path = path[2:]
    else:
        path = path[2:] if path[0] == "groups" else path[1:]
        kind = (cfg.pattern[path[0]] if path[0] < len(cfg.pattern)
                else "attn")               # the shared block's, last
        path = path[1:]
    if kind == "attn" and cfg.n_kv_heads % tp == 0 and path[0] in "kv":
        return 2
    if kind == "mamba2":
        heads = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
        if heads % tp == 0:
            return {"S": 1, "conv_x": 2}.get(path[0])
    if kind in ("gla", "retnet", "hgrn2", "mlstm"):
        if (cfg.ssm.n_heads or cfg.n_heads) % tp == 0:
            return {"S": 1, "conv": 2}.get(path[0])
    return None


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", [a for a in TC.ALL_ARCHS
                                  if not t_smoke(a).encoder_only])
def test_serving_cache_layout_keeps_only_the_batch_entries(trees, arch,
                                                           mesh):
    """The layout the port's serving steps keep caches in: each leaf's
    batch entry where JAX's layout has one (checked equal to JAX's
    above), the model axis on the heads of the caches the tensor-parallel
    step splits (GQA K and V where tp divides the kv heads; the state of
    Mamba-2, the GLA family and mLSTM, and the conv tails, where tp
    divides their heads), and no other dim
    sharded -- each rank keeps its rows of its heads, so a decode step
    gathers no cache."""
    _, tc, _, _, caches = trees[arch]
    _, tpar = _pars(mesh)
    batch = tpar.batch_axes
    for B, cap in _CACHE_CELLS:
        tcache = caches[(B, cap)][1]
        full = T.leaves(SH.cache_shardings(tcache, tc, tpar, B))
        serving = T.leaves(SH.serving_cache_shardings(tcache, tc, tpar, B))
        paths = [p for p, _ in T.leaves_with_paths(tcache)]
        assert len(serving) == len(full) == len(paths) > 0
        split = 0
        for path, f, s in zip(paths, full, serving):
            hd = _tp_head_dim(tc, path, tpar.tp)
            split += hd is not None
            assert all(e is None or e == batch or e == "model"
                       for e in s.spec), s.spec
            assert [e == batch for e in s.spec] == [e == batch
                                                    for e in f.spec]
            assert [e == "model" for e in s.spec] == [
                i == hd for i in range(len(s.spec))], (path, s.spec)
        # the attention / state-update archs split their caches at tp > 1
        recurrent = {"mamba2", "gla", "retnet", "hgrn2", "mlstm"}
        if tpar.tp > 1 and ("mamba2" in tc.pattern or (
                "attn" in tc.pattern + tc.prelude or tc.shared_attn)
                and tc.n_kv_heads % tpar.tp == 0 or set(tc.pattern)
                & recurrent and (tc.ssm.n_heads or tc.n_heads) % tpar.tp
                == 0):
            assert split > 0


def test_placements_of_a_spec():
    """``Shard(d)`` on each mesh dim named at tensor dim d; a tuple entry
    shards one dim over several axes major to minor, which DTensor does in
    mesh order (and refuses out of it)."""
    mesh = SH.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    S, R = SH.Shard, SH.Replicate
    assert SH.Layout(mesh, SH.Spec(("pod", "data"), "model")).placements \
        == (S(0), S(0), S(1))
    assert SH.Layout(mesh, SH.Spec(None, ("data", "model"))).placements \
        == (R(), S(1), S(1))
    assert SH.Layout(mesh, SH.Spec()).placements == (R(), R(), R())
    with pytest.raises(ValueError):
        SH.Layout(mesh, SH.Spec(("model", "data"))).placements
    par = SH.Parallel(mesh, data_axes=("pod", "data"))
    assert (par.tp, par.fsdp, par.fsdp_axes, par.batch_size_divisor) == \
        (2, 2, ("data",), 4)


def test_dryrun_cells_and_arch_lists_equal_jax():
    assert TC.ASSIGNED_ARCHS + TC.PAPER_ARCHS == tuple(J_ARCHS)
    for arch in J_ARCHS:
        for shape in J_SHAPES:
            assert TC.cell_supported(arch, shape) == \
                j_cell_supported(arch, shape)


@pytest.mark.parametrize("arch", ["paligemma-3b", "hubert-xlarge",
                                  "zamba2-2.7b", "deepseek-v2-236b"])
def test_input_specs_equal_jax(arch):
    """``batch_struct`` / ``decode_struct`` / ``params_struct``: meta
    tensors of the JAX ShapeDtypeStructs' shapes and dtypes (parameters:
    the same count)."""
    jc, tc = j_smoke(arch), t_smoke(arch)
    sc = SHAPES["train_4k"]
    jb, tb = JSP.batch_struct(jc, sc), TSP.batch_struct(tc, sc)
    assert sorted(jb) == sorted(tb)
    for k in jb:
        assert tb[k].device.type == "meta"
        assert tuple(tb[k].shape) == jb[k].shape
        assert str(tb[k].dtype).removeprefix("torch.") == str(jb[k].dtype)
    jp, tp = JSP.params_struct(jc), TSP.params_struct(tc)
    assert sum(x.size for x in jax.tree.leaves(jp)) == sum(
        x.numel() for x in T.leaves(tp))
    if not tc.encoder_only:
        jt, jl, jcache = JSP.decode_struct(jc, SHAPES["decode_32k"])
        tt, tl, tcache = TSP.decode_struct(tc, SHAPES["decode_32k"])
        assert tuple(tt.shape) == jt.shape and tt.dtype == torch.int32
        assert tuple(tl.shape) == jl.shape
        assert sum(x.numel() * x.element_size()
                   for x in T.leaves(tcache)) == sum(
            x.size * x.dtype.itemsize for x in jax.tree.leaves(jcache))
