"""Where the installed PyTorch keeps the distributed APIs the port codes
against (the twin of ``repro/dist/compat.py``, which backfills JAX APIs
that moved between JAX versions).

``DeviceMesh`` / ``init_device_mesh``, DTensor and its placements
(``torch.distributed.tensor`` since PyTorch 2.4, formerly
``torch.distributed._tensor``), the debug mode that counts collectives,
the functional collectives, a process group by its name, and the
``fake`` process group's store (a world of any size in one process: the
dry run's stand-in for a pod) each moved between releases.  This module imports
each from where the installed torch keeps it and raises an
``ImportError`` naming the API when there is none: no silent fallback.
Everything else in the port imports them from here.  (The MoE's expert
parallelism, JAX's one ``shard_map``, is two explicit collectives in
``models/layers.py``, so ``local_map`` is not needed.)
"""
from __future__ import annotations

import importlib
from typing import Sequence


def _first(api: str, candidates: Sequence[str]):
    """``api`` from the first module of ``candidates`` that has it."""
    tried = []
    for mod in candidates:
        try:
            return getattr(importlib.import_module(mod), api)
        except (ImportError, AttributeError) as e:
            tried.append(f"{mod}: {type(e).__name__}")
    raise ImportError(f"this PyTorch has no {api} (looked in "
                      f"{'; '.join(tried)})")


_TENSOR = ("torch.distributed.tensor", "torch.distributed._tensor")

DeviceMesh = _first("DeviceMesh", ("torch.distributed.device_mesh",))
init_device_mesh = _first("init_device_mesh",
                          ("torch.distributed.device_mesh",))
DTensor = _first("DTensor", _TENSOR)
distribute_tensor = _first("distribute_tensor", _TENSOR)
Shard = _first("Shard", _TENSOR)
Replicate = _first("Replicate", _TENSOR)
Partial = _first("Partial", _TENSOR + ("torch.distributed._tensor."
                                       "placement_types",))
CommDebugMode = _first("CommDebugMode", ("torch.distributed.tensor.debug",
                                         "torch.distributed._tensor.debug"))
funcol = importlib.import_module("torch.distributed._functional_collectives")
#: c10d's all-gather into one buffer (``all_gather_single`` since PyTorch
#: 2.13, ``all_gather_into_tensor`` before)
_c10d = importlib.import_module("torch.distributed")
all_gather_single = getattr(_c10d, "all_gather_single", None) \
    or _c10d.all_gather_into_tensor
resolve_process_group = _first("_resolve_process_group",
                               ("torch.distributed.distributed_c10d",))


def fake_store():
    """A store for ``init_process_group("fake", ...)``: every collective
    of that group returns at once, so one process traces a rank of a
    world of any size.  Imported when called (it lives in torch's testing
    package)."""
    return _first("FakeStore", ("torch.testing._internal.distributed."
                                "fake_pg",))()
