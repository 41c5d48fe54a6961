"""Graceful-degradation primitives of the port's serving stack (PyTorch port
of ``repro/serving/resilience.py``; :mod:`repro_torch.serving.faults` is the
attack half):

  * **blob checksums** -- every host-side blob (preemption spill, prefix
    store demotion) carries a CRC32 recorded at extraction and verified at
    resume / promote, so a corrupted byte is *detected* at the tier
    boundary (:class:`BlobCorruption`) instead of silently poisoning
    decode; :func:`corrupt_blob` is the injected ``blob_corrupt`` payload;
  * **bounded retry** -- :func:`retry_transient` wraps an allocation-style
    call (falsy on a transient shortage) in a bounded retry loop; the PL206
    lint rule requires alloc / pin call sites to go through it;
  * **the degradation ladder** -- :data:`LADDER` names the rungs admission
    escalates through once retries are exhausted;
  * **the step watchdog** -- :class:`StepWatchdog` flags steps over a
    wall-clock budget into the metrics (it never kills work).

Blobs are CPU tensors, pinned where they came off the card (every storage
dtype, bf16 and fp8 included); checksums run over their raw bytes.
"""
from __future__ import annotations

import time
import zlib
from typing import Callable, List, Optional, Sequence

import torch

__all__ = ["BlobCorruption", "crc_blob", "corrupt_blob", "verify_blob",
           "retry_transient", "LADDER", "StepWatchdog",
           "RETRY_ATTEMPTS", "REPREFILL_CAP"]

#: bounded-retry attempts at transient alloc / pin sites before escalating
RETRY_ATTEMPTS = 3

#: bounded re-prefills of one request after blob corruption before the
#: request is declared ``failed``
REPREFILL_CAP = 2

#: the graceful-degradation ladder admission escalates through once
#: bounded retries are exhausted, least to most disruptive
LADDER = ("drop_prefix", "demote_store", "preempt", "shed")


class BlobCorruption(RuntimeError):
    """A host-tier blob failed its checksum at the device boundary."""

    def __init__(self, what: str, rid: Optional[int] = None,
                 expect: Optional[int] = None, got: Optional[int] = None):
        self.what = what
        self.rid = rid
        self.expect = expect
        self.got = got
        where = f" (rid {rid})" if rid is not None else ""
        super().__init__(
            f"checksum mismatch on {what}{where}: "
            f"expected {expect:#010x}, got {got:#010x}"
            if expect is not None and got is not None
            else f"checksum mismatch on {what}{where}")


def crc_blob(blob: Sequence[torch.Tensor]) -> int:
    """CRC32 chained over a blob's tensors (order- and shape-sensitive)."""
    crc = 0
    for t in blob:
        crc = zlib.crc32(str(tuple(t.shape)).encode(), crc)
        crc = zlib.crc32(t.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy(), crc)
    return crc & 0xFFFFFFFF


def corrupt_blob(blob: List[torch.Tensor]) -> None:
    """Flip one byte of the first non-empty tensor (the injected
    ``blob_corrupt`` payload; the blob's recorded CRC no longer matches).
    A blob tensor may be a read-only or overlapping view, so the poisoned
    copy replaces the list entry instead of mutating in place; a pinned
    tensor's copy is pinned too."""
    for i, t in enumerate(blob):
        if t.numel():
            bad = torch.empty(tuple(t.shape), dtype=t.dtype, device=t.device,
                              pin_memory=t.device.type == "cpu"
                              and t.is_pinned())
            bad.copy_(t)
            bad.reshape(-1).view(torch.uint8)[0] ^= 0xFF
            blob[i] = bad
            return


def verify_blob(blob: Sequence[torch.Tensor], crc: Optional[int], what: str,
                rid: Optional[int] = None) -> None:
    """Raise :class:`BlobCorruption` when ``blob`` no longer matches the
    ``crc`` recorded at extraction (None = unchecked blob)."""
    if crc is None:
        return
    got = crc_blob(blob)
    if got != crc:
        raise BlobCorruption(what, rid=rid, expect=crc, got=got)


def retry_transient(fn: Callable[[], object], attempts: int = RETRY_ATTEMPTS,
                    backoff_s: float = 0.0,
                    on_retry: Optional[Callable[[int], None]] = None):
    """Call ``fn`` until it returns truthy, up to ``attempts`` times.

    The contract of allocation-style calls (``pool.register``/``grow``/
    ``resume``/``fork``): falsy means a *transient* shortage, an exception a
    real fault -- exceptions propagate immediately.  ``on_retry(k)``
    observes the k-th retry.  Returns the last result (falsy when every
    attempt failed: the caller escalates)."""
    result = fn()
    for k in range(1, max(1, attempts)):
        if result:
            return result
        if on_retry is not None:
            on_retry(k)
        if backoff_s > 0.0:
            time.sleep(backoff_s * (2 ** (k - 1)))
        result = fn()
    return result


class StepWatchdog:
    """Wall-clock budget check for engine steps.

    ``observe(step, dt)`` compares a step's duration against the budget;
    disabled (zero cost) when the budget is None.  The watchdog only
    *flags* -- a slow step feeds the obs stream (``watchdog_trips_total``,
    a ``cat="fault"`` instant), it never aborts work.
    """

    def __init__(self, budget_s: Optional[float], obs=None):
        self.budget_s = budget_s
        self.obs = obs
        self.trips = 0
        self.slowest_s = 0.0

    @property
    def enabled(self) -> bool:
        return self.budget_s is not None

    def observe(self, step: int, dt: float) -> bool:
        """True when the step blew its budget (after reporting it)."""
        if self.budget_s is None:
            return False
        self.slowest_s = max(self.slowest_s, dt)
        if dt <= self.budget_s:
            return False
        self.trips += 1
        if self.obs is not None:
            self.obs.metrics.counter("watchdog_trips_total").inc()
            self.obs.tracer.instant(
                "watchdog.slow_step", cat="fault", track="engine",
                step=step, dt_s=dt, budget_s=self.budget_s)
        return True
