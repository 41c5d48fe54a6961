"""Speculative decoding: draft sources and the acceptance-aware controller
(PyTorch port of ``repro/serving/spec``).

The target-model side (the ``spec_verify`` SPU op, the multi-position paged
step with state snapshots, and the engine's accept / rollback logic) lives
in :mod:`repro_torch.ops.spec_verify`, :mod:`repro_torch.models.model` and
:mod:`repro_torch.serving.engine`; this package holds the host-side pieces
that decide *what* to draft and *how much*:

  * :class:`DraftSource` -- the protocol the engine drives
  * :class:`NGramDraft` -- self-drafting suffix matcher (no second model)
  * :class:`ModelDraft` -- small-model drafting over a private paged pool
  * :class:`KController` -- per-request draft length from acceptance history

Enable with ``ServeConfig(spec="ngram")`` or ``spec="model:<arch>"``.
"""
from repro_torch.serving.spec.controller import KController
from repro_torch.serving.spec.draft import DraftSource, ModelDraft, NGramDraft

__all__ = ["DraftSource", "KController", "ModelDraft", "NGramDraft"]
