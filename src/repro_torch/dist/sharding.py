"""Sharding layouts for train / serve / dry-run steps (the port's copy of
``repro/dist/sharding.py``), and their eager execution.

One :class:`Parallel` binds a ``DeviceMesh`` with named dims to axis roles
(which axes carry data parallelism, which one carries tensor / expert
parallelism); the builders turn it into a :class:`Layout` tree for every
tree a step touches, rule for rule the JAX package's:

* :func:`param_shardings`     -- the larger of the two trailing weight dims
  that divides tp over the model axis, plus FSDP / ZeRO of the first dim
  over the intra-pod data axes; MoE expert banks shard their expert dim
  over the model axis instead.
* :func:`opt_state_shardings` -- AdamW moments follow the parameter layout
  (ZeRO), the step counter is replicated.
* :func:`batch_shardings`     -- the leading (batch) dim over all data axes.
* :func:`cache_shardings`     -- decode caches; batch and time axes are
  located by probing the port's ``init_decode_caches`` on the ``meta``
  device at two batch sizes and two capacities, never guessed.
* :func:`serving_cache_shardings` -- the port's own layout for the caches
  its serving steps keep: the batch entries of :func:`cache_shardings`,
  and the model axis on the heads of the caches the tensor-parallel step
  splits.
* :func:`serving_param_shardings` -- the port's own layout for the
  parameters of its serving steps: :func:`tp_params`' cuts on the model
  axis.
* :func:`replicated`          -- the trivial layout.

Rules shard only a dim that divides evenly; anything else replicates.  The
port's parameters and caches are per-layer lists (``params_from_jax``
unstacks the JAX package's ``(G, ...)`` group axis), so the JAX layouts'
leading ``None`` for that scan-stack axis drops out and every other entry
is the same.

GSPMD partitions the JAX package's steps; the port has no such compiler,
so it runs a layout eagerly.  At rest every leaf is a ``DTensor`` in its
layout.  In a step each rank takes what it computes with -- its rows of
the batch over the data axes (:func:`gather`) and its tensor-parallel cut
of the parameters (:func:`cut_params`) -- runs the port's code, and puts
the results back into their layouts (:func:`place`; gradients:
:func:`reduce_grads`, which sums them over the data axes).  Kernels see
the local tensors, never a ``DTensor``.

The model axis splits by heads (tensor parallelism, Megatron's column /
row products): :func:`tp_params` cuts a rank's columns of the GQA, MLA,
Mamba-2, GLA-family, mLSTM and dense-FFN input projections and the
matching rows of their output projections (an MoE's experts where the
model axis divides them), and :func:`serving_param_shardings` is that cut
as a layout.  Serving keeps parameters at rest in it; each rank keeps its
heads' caches (:func:`serving_cache_shardings`), and the serving engines
split their decode rows over the data axes besides (``dist/rows.py``);
:func:`sharded_prefill` / :func:`sharded_decode_step` run the same step
on a batch laid out over the data axes.  Training keeps the JAX
package's layout (:func:`param_shardings`, ZeRO over the data axes) at
rest and computes on the cut: ``train/train_loop.py::make_train_step``
takes each rank's :func:`cut_params`, runs forward and backward with
Megatron's f / g around every model-axis sum and sequence parallelism at
the layer boundaries (``dist/tp.py``), so every gradient comes out whole
for the rank's cut, and :func:`reduce_grads` moves it into the training
layout.  Where the model axis splits no MoE experts, the sharded steps
route the MoE over the whole batch of the data axes, as JAX's does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple

import torch

from repro_torch.core import attention_cache as AC
from repro_torch.core import tree as T
from repro_torch.dist.compat import (DTensor, Partial, Replicate, Shard,
                                     distribute_tensor)
from repro_torch.dist import tp as TP


class Spec(tuple):
    """The port's ``PartitionSpec``: one entry per tensor dim -- ``None``,
    a mesh axis name, or a tuple of names that shards one dim over several
    axes, major to minor."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "Spec(" + ", ".join(repr(e) for e in self) + ")"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Named axes and their sizes without devices or processes: what the
    builders need to compute a layout (the JAX package's shape-only
    mesh).  ``shape`` and ``mesh_dim_names`` as on a ``DeviceMesh``."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def get_coordinate(self) -> Tuple[int, ...]:
        """Rank 0's coordinate: what a layout probe computes for."""
        return (0,) * len(self.shape)


@dataclasses.dataclass(frozen=True)
class Layout:
    """A mesh and a :class:`Spec` (the JAX package's ``NamedSharding``)."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        """DTensor placements: ``Shard(d)`` on each mesh dim the spec names
        at tensor dim ``d``, ``Replicate()`` elsewhere.  A tuple entry's
        axes must follow the mesh's order: DTensor splits a dim over mesh
        dims in their order, which is then JAX's major-to-minor."""
        names = tuple(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            idx = [names.index(a) for a in _axes(entry)]
            if idx != sorted(idx):
                raise ValueError(f"{self.spec}: axes {_axes(entry)} of dim "
                                 f"{d} are not in the mesh's order {names}")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class Parallel:
    """A mesh plus the roles of its axes.

    ``data_axes`` carry pure data parallelism (the optional leading 'pod'
    axis is the inter-pod network -- see launch/mesh.py); ``model_axis``
    carries tensor / expert parallelism.  ``mesh`` is a ``DeviceMesh`` with
    named dims (or an :class:`AbstractMesh` where only layouts are built).
    ``seq``: a training step's sequence-parallel form
    (``dist/tp.py::seq_par``), where a split layer's input and output are
    a rank's positions.
    """

    mesh: Any
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    seq: bool = False

    def size(self, axis: str) -> int:
        return int(self.mesh.shape[self.mesh.mesh_dim_names.index(axis)])

    @property
    def tp(self) -> int:
        """Tensor-parallel degree (size of the model axis)."""
        return self.size(self.model_axis)

    @property
    def fsdp_axes(self) -> Tuple[str, ...]:
        """Data axes that take part in parameter / ZeRO sharding: not
        'pod' (parameters replicate across pods, so only gradient
        all-reduces cross the slow inter-pod network)."""
        return tuple(a for a in self.data_axes if a != "pod")

    @property
    def fsdp(self) -> int:
        """FSDP / ZeRO degree (intra-pod data-parallel size)."""
        out = 1
        for a in self.fsdp_axes:
            out *= self.size(a)
        return out

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """Spec entry for the batch dim (all data axes)."""
        return tuple(self.data_axes)

    @property
    def batch_size_divisor(self) -> int:
        """Global batch sizes must divide this to shard over batch_axes."""
        out = 1
        for a in self.data_axes:
            out *= self.size(a)
        return out

    def named(self, spec) -> Layout:
        return Layout(self.mesh, Spec(*spec))

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return int(self.mesh.get_coordinate()[
            self.mesh.mesh_dim_names.index(axis)])

    def data_index(self) -> int:
        """This rank's index over the data axes, major to minor: its rows
        of a batch sharded over ``batch_axes``."""
        out = 0
        for a in self.data_axes:
            out = out * self.size(a) + self.coordinate(a)
        return out

    def group(self, axis: str):
        """The process group of ``axis`` through this rank."""
        return self.mesh.get_group(axis)

    @property
    def model_index(self) -> int:
        """This rank's place on the model axis."""
        return self.coordinate(self.model_axis)

    @property
    def model_group(self):
        """The process group of the model axis through this rank."""
        return self.group(self.model_axis)


def replicated(par: Parallel) -> Layout:
    return par.named(())


# ---------------------------------------------------------------------------
# tensor-parallel serving: heads and FFN columns over the model axis
# ---------------------------------------------------------------------------

def tp_params(params: Any, cfg, par: Optional[Parallel]) -> Any:
    """A rank's parameters for the tensor-parallel serving step, cut from
    the whole tensors (the same on every rank: seeded, restored, or
    ``models/convert.py::params_from_jax``'s), Megatron's layout.  Each
    mixer cuts its own weights (``models/attention.py::tp_shard`` for GQA
    attention, pattern layers and the shared block alike,
    ``attention.py::mla_tp_shard`` for MLA's query heads;
    ``models/ssm.py::TP_SHARDS`` for Mamba-2, the GLA family and mLSTM;
    ``models/layers.py::ffn_tp_shard`` for the dense FFNs' columns and an
    MoE's experts); this walks the tree.  A layer whose heads the model
    axis does not divide stays whole (``dist/tp.py::layer_par``).

    Everything else stays whole on every rank: embeddings, LM head, the
    norms over ``d``, MLA's query and latent down-projections, and the
    sLSTM.  The cut leaves are copies, so dropping the whole tree frees
    it.  This serving
    layout is the port's own: JAX's engines keep the weights as given and
    let GSPMD place the products from ``shard_heads``; the port, with no
    partitioner, cuts the weights once and runs each rank's shard."""
    if par is None or par.tp == 1:
        return params
    from repro_torch.models import attention as ATT
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as SSM

    def element(p, kind):
        out = dict(p)
        if kind == "attn":
            out["mixer"] = ATT.tp_shard(p["mixer"], cfg, par)
        elif kind == "mla":
            out["mixer"] = ATT.mla_tp_shard(p["mixer"], cfg, par)
        elif kind in SSM.TP_SHARDS:
            out["mixer"] = SSM.TP_SHARDS[kind](p["mixer"], cfg, par)
        if "ffn" in p:
            out["ffn"] = L.ffn_tp_shard(p["ffn"], cfg, par)
        return out

    out = dict(params)
    if "prelude" in params:
        out["prelude"] = [element(p, k)
                          for p, k in zip(params["prelude"], cfg.prelude)]
    out["groups"] = [[element(p, k) for p, k in zip(g, cfg.pattern)]
                     for g in params["groups"]]
    if "shared" in params:
        sh = params["shared"]
        out["shared"] = {**sh, "attn": ATT.tp_shard(sh["attn"], cfg, par),
                         "ffn": L.ffn_tp_shard(sh["ffn"], cfg, par)}
    return out


def serving_param_shardings(params: Any, cfg, par: Parallel) -> Any:
    """The layout the port's serving steps keep parameters in: the model
    axis on the dim :func:`tp_params` cuts (each of its cuts is one of tp
    equal, contiguous parts, in rank order: a ``Shard``), replicated over
    the data axes.  A rank then holds its :func:`tp_params` at rest, and
    :func:`sharded_prefill` / :func:`sharded_decode_step` move no weight.
    The cut dims are located exactly, by cutting a ``meta`` copy of
    ``params`` (tensors of any device, ``DTensor`` s included)."""
    whole = T.leaves(params)
    part = T.leaves(tp_params(T.tree_map(lambda t: torch.empty(
        t.shape, dtype=t.dtype, device="meta"), params), cfg, par))
    out = []
    for a, b in zip(whole, part):
        dims: list = [None] * len(a.shape)
        cut = next((i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                    if x != y), None)
        if cut is not None:
            dims[cut] = par.model_axis
        out.append(par.named(dims))
    return T.unflatten(params, out)


# ---------------------------------------------------------------------------
# trees: the parameter and optimizer trees, and the decode caches
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# params / optimizer
# ---------------------------------------------------------------------------

def is_expert_bank(path, shape, cfg) -> bool:
    """An MoE ``(E, d_in, d_out)`` expert bank (MoE models also carry 2-D
    dense ``wi`` / ``wg`` / ``wo`` under ``ffn``: prelude layers, shared
    experts, which take the generic layout)."""
    names = [str(k) for k in path]
    return (getattr(cfg, "moe", None) is not None and bool(names)
            and names[-1] in ("wi", "wg", "wo") and "ffn" in names
            and len(shape) == 3)


def param_shardings(params: Any, cfg, par: Parallel) -> Any:
    """Layout tree mirroring ``params`` (tensors of any device, ``meta``
    included).

    Per weight: the larger of the two trailing dims that divides tp is
    tensor-parallel; the first dim is FSDP-sharded over the intra-pod data
    axes.  MoE expert banks shard their expert dim over the model axis
    instead, the layout ``apply_moe``'s expert parallelism computes in.
    1-D leaves (norm scales, gates) are replicated.
    """
    tp, fsdp = par.tp, par.fsdp

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) < 2:
            return replicated(par)
        dims: list = [None] * len(shape)
        if is_expert_bank(path, shape, cfg) and tp > 1 and shape[0] % tp == 0:
            dims[0] = par.model_axis
        elif tp > 1:
            cands = [i for i in (len(shape) - 1, len(shape) - 2)
                     if shape[i] % tp == 0 and shape[i] >= tp]
            if cands:
                dims[max(cands, key=lambda i: shape[i])] = par.model_axis
        if fsdp > 1 and dims[0] is None and shape[0] % fsdp == 0 \
                and shape[0] >= fsdp:
            dims[0] = par.fsdp_axes
        return par.named(dims)

    return T.unflatten(params, [one(p, leaf) for p, leaf
                                in T.leaves_with_paths(params)])


def opt_state_shardings(opt_state: Any, p_shard: Any, par: Parallel) -> Any:
    """AdamW state layout: moments follow the parameter layouts exactly
    (which already carry the fs factor: ZeRO over the data axis); the step
    counter is replicated."""
    del opt_state  # structure is {'m': params, 'v': params, 'step': scalar}
    return {"m": p_shard, "v": p_shard, "step": replicated(par)}


# ---------------------------------------------------------------------------
# batches / caches
# ---------------------------------------------------------------------------

def batch_shardings(batch: Any, par: Parallel) -> Any:
    """Leading (batch) dim over all data axes; indivisible leaves
    replicate."""
    div = par.batch_size_divisor

    def one(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape or shape[0] % div != 0:
            return replicated(par)
        return par.named((par.batch_axes,) + (None,) * (len(shape) - 1))

    return T.tree_map(one, batch)


@functools.lru_cache(maxsize=32)
def _probe_cache_axes(cfg) -> tuple:
    """(batch_dim, time_dim) of every decode-cache leaf, located exactly:
    the port's cache skeleton on the ``meta`` device at two batch sizes and
    two capacities; a dim is the batch (time) axis iff it moves with B
    (T).  A pure function of the (frozen) config, kept for the last few
    configs: a serving prefill lays out its caches every call."""
    from repro_torch.models import model as M
    a, b, c = (T.leaves(M.init_decode_caches(cfg, B, cap, device="meta"))
               for B, cap in ((2, 128), (6, 128), (2, 256)))
    out = []
    for la, lb, lc in zip(a, b, c):
        bdim = next((i for i, (x, y) in enumerate(zip(la.shape, lb.shape))
                     if x != y), None)
        tdim = next((i for i, (x, y) in enumerate(zip(la.shape, lc.shape))
                     if x != y), None)
        out.append((bdim, tdim))
    return tuple(out)


def cache_shardings(cache_shapes: Any, cfg, par: Parallel,
                    global_batch: int) -> Any:
    """Decode-cache layout for a warm cache of ``global_batch`` sequences.

    Batch axis over the data axes when the global batch divides.  Leaves
    WITH a time axis (KV caches) shard it over the model axis -- every leaf
    of one container shares that axis, so the whole cache keeps one layout;
    time-less state slabs shard their largest head-like dim instead.  When
    the batch cannot shard, the time axis spreads over BOTH data and model
    axes so the cache still scales with the whole mesh.
    """
    items = T.leaves(cache_shapes)
    axes = _probe_cache_axes(cfg)
    if len(axes) != len(items):
        raise ValueError(f"cache skeleton mismatch: probed {len(axes)} "
                         f"leaves, got {len(items)}")
    div, tp = par.batch_size_divisor, par.tp
    shard_batch = global_batch % div == 0

    out = []
    for (bdim, tdim), leaf in zip(axes, items):
        shape = tuple(leaf.shape)
        dims: list = [None] * len(shape)
        batch_ok = (shard_batch and bdim is not None
                    and shape[bdim] % div == 0)
        if batch_ok:
            dims[bdim] = par.batch_axes
        if tp > 1:
            start = bdim + 1 if bdim is not None else 0
            if tdim is not None:
                if shape[tdim] % tp == 0:
                    if not batch_ok and div > 1 \
                            and shape[tdim] % (div * tp) == 0:
                        dims[tdim] = par.batch_axes + (par.model_axis,)
                    else:
                        dims[tdim] = par.model_axis
            else:
                heads = [i for i in range(start, len(shape))
                         if dims[i] is None and shape[i] % tp == 0
                         and shape[i] >= tp]
                if heads:
                    dims[max(heads, key=lambda i: shape[i])] = par.model_axis
        out.append(par.named(dims))
    return T.unflatten(cache_shapes, out)


@functools.lru_cache(maxsize=32)
def _probe_head_axes(cfg, tp: int) -> tuple:
    """The dim of every decode-cache leaf that the tensor-parallel step
    splits over a model axis of ``tp`` ranks (None: whole on every rank),
    located exactly: the dim where a rank's cache skeleton
    (``init_decode_caches(..., par=)`` on ``meta``) is smaller than the
    whole one's."""
    from repro_torch.models import model as M
    probe = Parallel(AbstractMesh((tp,), ("model",)), data_axes=())
    whole = T.leaves(M.init_decode_caches(cfg, 2, 128, device="meta"))
    part = T.leaves(M.init_decode_caches(cfg, 2, 128, device="meta",
                                         par=probe))
    return tuple(next((i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                       if x != y), None) for a, b in zip(whole, part))


def serving_cache_shardings(cache_shapes: Any, cfg, par: Parallel,
                            global_batch: int) -> Any:
    """The layout the port's serving steps keep decode caches in: the
    batch entries of JAX's (:func:`cache_shardings`), plus the model axis
    on the head dim of every cache the tensor-parallel step splits (a GQA
    layer's K and V where tp divides its kv heads; a Mamba-2, GLA-family
    or mLSTM layer's state and conv tail where tp divides its heads:
    :func:`tp_params`).  A rank then holds its rows of its heads' caches,
    what its step reads and writes, and a decode step gathers no cache.
    The caches that are whole on every rank (MLA's latent, which every
    query head reads; the sLSTM's carries; a layer tp does not divide)
    keep only their batch entries, where JAX's layout shards MLA's time
    axis."""
    batch = par.batch_axes
    heads = _probe_head_axes(cfg, par.tp) if par.tp > 1 else None
    out = []
    for i, l in enumerate(T.leaves(cache_shardings(cache_shapes, cfg, par,
                                                   global_batch))):
        dims = [e if e == batch else None for e in l.spec]
        if heads is not None and heads[i] is not None:
            dims[heads[i]] = par.model_axis
        out.append(par.named(dims))
    return T.unflatten(cache_shapes, out)


def logits_sharding(shape, par: Parallel, global_batch: int) -> Layout:
    """Logits: batch over the data axes where the batch divides, vocab
    over the model axis where it divides (the JAX dry run's)."""
    dims: list = [None] * len(shape)
    if global_batch % par.batch_size_divisor == 0:
        dims[0] = par.batch_axes
    if shape[-1] % par.tp == 0:
        dims[-1] = par.model_axis
    return par.named(dims)


# ---------------------------------------------------------------------------
# eager execution of a layout
# ---------------------------------------------------------------------------

def _mesh_placements(target) -> Tuple[Any, tuple]:
    """(mesh, placements) of a :class:`Layout` or a ``DTensor``."""
    if isinstance(target, DTensor):
        return target.device_mesh, tuple(target.placements)
    return target.mesh, target.placements


def _rows(placements, names, keep) -> tuple:
    """What a rank computes with: the placements' row shards (``Shard(0)``)
    on the ``keep`` axes stay, everything else is gathered."""
    return tuple(p if n in keep and p == Shard(0) else Replicate()
                 for p, n in zip(placements, names))


def distribute(tree: Any, layouts: Any) -> Any:
    """``tree`` (full tensors, the same on every rank: seeded, or read
    from a checkpoint) as DTensors in ``layouts``: each rank keeps its own
    slice, with no communication."""
    def one(t, layout):
        mesh, pl = _mesh_placements(layout)
        return distribute_tensor(t.detach().to(mesh.device_type), mesh, pl,
                                 src_data_rank=None)
    return T.tree_map(one, tree, layouts)


def _gather_leaf(x, keep: Tuple[str, ...]):
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    target = _rows(x.placements, mesh.mesh_dim_names, keep)
    if target != tuple(x.placements):
        x = x.redistribute(mesh, target)
    return x.to_local()


def gather(tree: Any, keep: Tuple[str, ...] = ()) -> Any:
    """Each ``DTensor`` leaf of ``tree`` as the local tensor a rank
    computes with: a leaf sharded along its leading (batch) dim over the
    ``keep`` axes stays so -- the rank's rows -- and every other shard is
    gathered.  Other leaves pass through."""
    return T.tree_map(lambda x: _gather_leaf(x, keep), tree)


def place(tree: Any, layouts: Any, keep: Tuple[str, ...] = ()) -> Any:
    """Local results into their layouts: each leaf of ``tree`` is what
    :func:`gather` gives a rank (its rows over the ``keep`` axes, whole
    elsewhere); ``layouts`` holds a :class:`Layout` or a ``DTensor`` (its
    own layout) per leaf.  Moving from replicated to sharded slices
    locally, with no communication."""
    def one(t, target):
        mesh, pl = _mesh_placements(target)
        src = _rows(pl, mesh.mesh_dim_names, keep)
        d = DTensor.from_local(t, mesh, src, run_check=False)
        return d.redistribute(mesh, pl) if src != pl else d
    return T.tree_map(one, tree, layouts)


def _model_dim(mesh, par) -> int:
    return tuple(mesh.mesh_dim_names).index(par.model_axis)


def _model_move(t: torch.Tensor, src, dst, mesh, par) -> torch.Tensor:
    """A rank's local ``t`` placed ``src`` on the model axis, as placed
    ``dst`` there: a ``Shard`` kept, cut locally from a replicated tensor,
    put together (``dist/tp.py::model_gather``), or moved to another dim
    (an all-to-all over the model axis)."""
    if src == dst:
        return t
    if src == Replicate():
        return TP.narrow(t, dst.dim, par.model_index * (t.shape[dst.dim]
                                                        // par.tp),
                         t.shape[dst.dim] // par.tp)
    if dst == Replicate():
        return TP.model_gather(t, src.dim, par)
    sub = mesh[par.model_axis]
    return DTensor.from_local(t, sub, (src,), run_check=False).redistribute(
        sub, (dst,)).to_local()


def cut_params(params: Any, cfg, par: Parallel) -> Any:
    """The parameters a rank computes with (the tensor-parallel step of
    training and serving): the local shards of ``params`` (DTensors, in
    any layout) in :func:`serving_param_shardings`, its :func:`tp_params`.
    A tree at rest in that layout moves nothing.  From the training
    layout each leaf is gathered over the data axes (the ZeRO shards) and
    moved on the model axis into its cut."""
    def one(x, layout):
        if not isinstance(x, DTensor):
            return x
        mesh, m = x.device_mesh, _model_dim(x.device_mesh, par)
        mid = tuple(pl if i == m else Replicate()
                    for i, pl in enumerate(x.placements))
        if mid != tuple(x.placements):
            x = x.redistribute(mesh, mid)
        return _model_move(x.to_local(), mid[m], layout.placements[m], mesh,
                           par)
    return T.tree_map(one, params, serving_param_shardings(params, cfg, par))


def reduce_grads(grads: Any, params: Any, cfg, par: Parallel) -> Any:
    """Each rank's gradients of its :func:`cut_params` (of its rows; whole
    for its cut on every model rank) into the parameters' layouts, as
    local shards: each is declared in the layout of its cut -- ``Shard``
    over the model axis on the cut dim, ``Replicate`` there where the leaf
    is whole, and ``Partial`` over the data axes, as each rank holds its
    rows' share -- moved on the model axis into the training layout, and
    reduce-scattered (or all-reduced where the parameter is replicated)
    over the data axes."""
    data = set(par.data_axes)
    cut = serving_param_shardings(params, cfg, par)

    def one(g, p, c):
        mesh, m = p.device_mesh, _model_dim(p.device_mesh, par)
        g = _model_move(g, c.placements[m], p.placements[m], mesh, par)
        src = tuple(Partial() if n in data else
                    (p.placements[i] if i == m else Replicate())
                    for i, n in enumerate(mesh.mesh_dim_names))
        return DTensor.from_local(g, mesh, src, run_check=False).redistribute(
            mesh, tuple(p.placements)).to_local()

    return T.tree_map(one, grads, params, cut)


def global_norm(local_grads: Any, params: Any) -> torch.Tensor:
    """The global L2 norm of a gradient tree held as local shards in the
    layouts of ``params`` (DTensors), summed in leaf order as
    ``train/optimizer.py::global_norm`` sums the whole tree: each leaf's
    sum of squares is counted once -- by the ranks at index 0 of every
    mesh axis that replicates it -- and one vector of them, all-reduced
    over every mesh dim, adds the shards'."""
    sums = []
    mesh = None
    for g, p in zip(T.leaves(local_grads), T.leaves(params)):
        mesh = p.device_mesh
        coord = mesh.get_coordinate()
        s = torch.sum(torch.square(g.to(torch.float32)))
        owner = all(c == 0 for c, pl in zip(coord, p.placements)
                    if pl == Replicate())
        sums.append(s if owner else torch.zeros_like(s))
    v = DTensor.from_local(torch.stack(sums), mesh,
                           (Partial(),) * mesh.ndim,
                           run_check=False).full_tensor()
    return torch.sqrt(sum(v.unbind()))


def local_shards(tree: Any) -> Any:
    """Each ``DTensor`` leaf's local shard."""
    return T.tree_map(lambda x: x.to_local() if isinstance(x, DTensor) else x,
                    tree)


def like(local: Any, dtensors: Any) -> Any:
    """Local shards back into DTensors laid out as ``dtensors``."""
    return T.tree_map(lambda t, d: DTensor.from_local(
        t, d.device_mesh, d.placements, run_check=False, shape=d.shape,
        stride=d.stride()), local, dtensors)


# ---------------------------------------------------------------------------
# sharded serving steps
# ---------------------------------------------------------------------------

def _local(x, layout):
    """A ``DTensor`` leaf moved into ``layout``, as the local tensor; other
    leaves pass through."""
    if not isinstance(x, DTensor):
        return x
    pl = layout.placements
    if tuple(x.placements) != pl:
        x = x.redistribute(x.device_mesh, pl)
    return x.to_local()


def _adopt(t: torch.Tensor, layout, like=None):
    """A rank's local tensor ``t`` in ``layout``, as a ``DTensor``; moved
    on into ``like``'s layout where a ``DTensor`` ``like`` is given."""
    d = DTensor.from_local(t, layout.mesh, layout.placements,
                           run_check=False)
    if like is not None and tuple(like.placements) != layout.placements:
        d = d.redistribute(like.device_mesh, tuple(like.placements))
    return d


def split_rows(local: int, B: int, par: Parallel) -> Optional[Parallel]:
    """``par`` where its data axes split a batch of ``B`` rows (a rank
    holds ``local`` of them, fewer than ``B``): an MoE the model axis does
    not split then routes the whole batch (``layers.apply_moe``'s
    ``rows``).  None where every rank holds the whole batch (one the data
    axes do not divide, laid out replicated), which it routes as it is."""
    return par if local < B else None


def sharded_prefill(params: Any, cfg, batch: Any, par: Parallel):
    """``M.prefill`` with parameters and batch in their layouts (DTensor
    trees; the parameters best at rest in :func:`serving_param_shardings`):
    each rank runs its rows of the tensor-parallel step on its
    :func:`tp_params`.  Returns (last-position logits, caches) in their
    layouts (:func:`logits_sharding`, :func:`serving_cache_shardings`);
    an encoder's caches are None.  An MoE whose experts the model axis
    does not split routes the whole batch (``M.prefill``'s ``rows``)."""
    from repro_torch.models import model as M
    keep = par.batch_axes
    local_b = gather(batch, keep)
    B = next(iter(T.leaves(batch))).shape[0]
    logits, caches = M.prefill(
        cut_params(params, cfg, par), cfg, local_b, par=par,
        rows=split_rows(next(iter(T.leaves(local_b))).shape[0], B, par))
    logits = place(logits, logits_sharding(
        (B,) + tuple(logits.shape[1:]), par, B), keep)
    if caches is None:
        return logits, None
    cap = next((c.max_len for c in M.iter_kv_caches(caches)),
               AC.PAGE_TOKENS)
    skel = M.init_decode_caches(cfg, B, cap, device="meta")
    return logits, T.tree_map(_adopt, caches,
                              serving_cache_shardings(skel, cfg, par, B))


def _row_base(x) -> int:
    """The index in the whole batch of this rank's first row of ``x``: a
    ``DTensor`` whose leading dim is split in equal parts over the mesh
    dims that shard it (major to minor, as :class:`Layout` lays a tuple
    entry out); 0 for a tensor or a replicated leading dim."""
    if not isinstance(x, DTensor):
        return 0
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    idx, parts = 0, 1
    for i, pl in enumerate(x.placements):
        if pl == Shard(0):
            idx = idx * mesh.size(i) + coord[i]
            parts *= mesh.size(i)
    if x.shape[0] % parts:
        raise ValueError(f"batch {x.shape[0]} is not split in {parts} equal "
                         "parts")
    return idx * (x.shape[0] // parts)


def sharded_decode_step(params: Any, cfg, tokens, caches: Any, lengths,
                        par: Parallel, seed: int = 0):
    """``M.decode_step`` with parameters, tokens, lengths and caches in
    their layouts: each rank decodes its rows through the tensor-parallel
    step (its :func:`tp_params`, as :func:`sharded_prefill` takes them)
    against its rows' caches of its heads
    (moved into :func:`serving_cache_shardings` unless they are in it, as
    :func:`sharded_prefill` leaves them).  Stochastic rounding counts from
    the rank's first row of the whole batch (``ops.sr_rows_from``) and,
    per layer, from its first head (``ops.sr_heads_from``), so each element
    draws what the single-device step draws for it; an MoE whose experts
    the model axis does not split routes the whole batch, as
    :func:`sharded_prefill`'s.  Returns (logits, new
    caches) in their layouts; the caches keep the layouts they came in."""
    from repro_torch import ops as OPS
    from repro_torch.models import model as M
    keep = par.batch_axes
    B = tokens.shape[0]
    target = serving_cache_shardings(caches, cfg, par, B)
    local_t = gather(tokens, keep)
    with OPS.sr_rows_from(_row_base(tokens)):
        logits, new = M.decode_step(
            cut_params(params, cfg, par), cfg, local_t,
            T.tree_map(_local, caches, target), gather(lengths, keep),
            seed, par=par, rows=split_rows(local_t.shape[0], B, par))
    logits = place(logits, logits_sharding(
        (B,) + tuple(logits.shape[1:]), par, B), keep)
    return logits, T.tree_map(_adopt, new, target, caches)
