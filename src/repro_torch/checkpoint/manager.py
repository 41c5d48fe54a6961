"""Fault-tolerant checkpointing over the port's trees (the port's copy of
``repro/checkpoint/manager.py``).

Durability protocol (survives SIGKILL at any point):
  1. write every leaf and a manifest into ``step_N.tmp/``
  2. fsync, then atomically ``rename`` to ``step_N/``
  3. update ``LATEST`` via write-tmp + rename

Restore never trusts a directory without a complete manifest; a torn write
leaves only a ``.tmp`` dir that is ignored (and garbage-collected), and a
``LATEST`` naming a torn checkpoint falls back to the newest valid one.

Leaves are whole tensors in ``arrays.npz`` (bf16 as its uint16 bits), named
in the manifest by their tree path (``params/groups/0/1/mixer/wq``), so a
template may restore a subtree alone: ``{"params": ..., "opt_state":
None}`` reads a trainer's checkpoint for serving.

On a mesh the leaves are DTensors: every rank gathers each whole tensor,
rank 0 writes them and the others wait at a barrier, so a checkpoint is
the same file whatever the mesh (the manifest's ``shards`` stays None, as
in the JAX package).  ``restore(..., shardings=...)`` places each leaf in
a layout of any mesh -- elastic: a run saved on one mesh shape resumes on
another.
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import tree as T
from repro_torch.dist.compat import DTensor


def _name(path) -> str:
    return "/".join(str(k) for k in path)


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    dtype = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), dtype
    return t.numpy(), dtype


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._gc_tmp()

    # ---------------- save ----------------

    def save(self, step: int, params: Any, opt_state: Any = None,
             extra: Optional[dict] = None) -> str:
        items = list(T.leaves_with_paths({"params": params,
                                          "opt_state": opt_state}))
        final = os.path.join(self.dir, f"step_{step:08d}")
        if any(isinstance(leaf, DTensor) for _, leaf in items):
            # a collective: every rank gathers every leaf, in one order
            items = [(p, leaf.full_tensor() if isinstance(leaf, DTensor)
                      else leaf) for p, leaf in items]
            if dist.get_rank() != 0:
                dist.barrier()
                return final
            try:
                return self._write(final, step, items, extra)
            finally:
                dist.barrier()
        return self._write(final, step, items, extra)

    def _write(self, final: str, step: int, items, extra) -> str:
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        dtypes = []
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            # the .npz layout np.savez writes, each leaf's bytes handed to
            # the zip member as they are (np.savez copies them twice more)
            with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED,
                                 allowZip64=True) as zf:
                for i, (_, leaf) in enumerate(items):
                    arr, dt = _to_numpy(leaf)
                    dtypes.append(dt)
                    with zf.open(f"leaf_{i}.npy", "w",
                                 force_zip64=True) as member:
                        np.lib.format.write_array_header_2_0(
                            member, np.lib.format.header_data_from_array_1_0(
                                arr))
                        member.write(memoryview(arr).cast("B"))
            f.flush()
            os.fsync(f.fileno())
        manifest = {"step": step, "n_leaves": len(items),
                    "paths": [_name(p) for p, _ in items], "dtypes": dtypes,
                    "shards": None, "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._set_latest(step)
        self._gc_old()
        return final

    # ---------------- restore ----------------

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.dir, "LATEST")
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                step = int(f.read().strip())
        except ValueError:
            return None
        if not self._valid(step):
            # fall back to the newest valid checkpoint on disk
            for s in sorted(self._steps_on_disk(), reverse=True):
                if self._valid(s):
                    return s
            return None
        return step

    def restore(self, like: Any, step: Optional[int] = None,
                device=None, shardings: Any = None) -> Tuple[Any, int]:
        """Restore into the structure of ``like``, a ``{'params': ...,
        'opt_state': ...}`` template whose leaves give each tensor's shape
        and dtype (``meta`` tensors or DTensors will do); a subtree that is
        ``None`` is not read.  Leaves land on ``device`` (default: each
        template leaf's own) as plain contiguous tensors that require no
        gradient -- or, with ``shardings`` (a tree of ``dist.sharding``
        layouts shaped as ``like``), as DTensors in those layouts on their
        mesh's device: every rank reads the file and keeps its slice.
        Returns (tree, step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        index = {p: i for i, p in enumerate(manifest["paths"])}
        wanted = list(T.leaves_with_paths(like))
        roots = {p[0] for p, _ in wanted}
        stored = {p for p in manifest["paths"] if p.split("/")[0] in roots}
        names = [_name(p) for p, _ in wanted]
        if set(names) != stored:
            raise ValueError(
                f"checkpoint step {step} holds {len(stored)} leaves under "
                f"{sorted(roots)}, the template {len(names)} -- model or "
                "optimizer structure changed")
        out = []
        with np.load(os.path.join(d, "arrays.npz")) as data:
            for name, (_, tmpl) in zip(names, wanted):
                i = index[name]
                t = _from_numpy(data[f"leaf_{i}"], manifest["dtypes"][i])
                if t.shape != tmpl.shape or t.dtype != tmpl.dtype:
                    raise ValueError(
                        f"{name}: checkpoint {t.dtype} {tuple(t.shape)}, "
                        f"template {tmpl.dtype} {tuple(tmpl.shape)}")
                out.append(t if shardings is not None else
                           t.to(device if device is not None
                                else tmpl.device))
        tree = T.unflatten(like, out)
        if shardings is not None:
            from repro_torch.dist import sharding as SH
            tree = SH.distribute(tree, shardings)
        return tree, step

    # ---------------- internals ----------------

    def _valid(self, step: int) -> bool:
        d = os.path.join(self.dir, f"step_{step:08d}")
        return (os.path.exists(os.path.join(d, "manifest.json"))
                and os.path.exists(os.path.join(d, "arrays.npz")))

    def _steps_on_disk(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return out

    def _set_latest(self, step: int):
        tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(tmp, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, os.path.join(self.dir, "LATEST"))

    def _gc_tmp(self):
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                p = os.path.join(self.dir, name)
                (shutil.rmtree if os.path.isdir(p) else os.remove)(p)

    def _gc_old(self):
        steps = sorted(self._steps_on_disk(), reverse=True)
        for s in steps[self.keep:]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"))
