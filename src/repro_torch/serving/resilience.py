"""Graceful-degradation primitives of the port's serving stack: the part of
``repro/serving/resilience.py`` the paged pool and engine use.

  * **blob checksums** -- every host-side spill blob carries a CRC32
    recorded at extraction and verified at resume, so a corrupted byte is
    *detected* at the tier boundary (:class:`BlobCorruption`) instead of
    silently poisoning decode;
  * **bounded retry** -- :func:`retry_transient` wraps an allocation-style
    call (falsy on a transient shortage) in a bounded retry loop; the PL206
    lint rule requires the engine's alloc call sites to go through it.

Blobs are CPU tensors (every storage dtype, bf16 and fp8 included);
checksums run over their raw bytes.  The step watchdog and fault
injection follow with the resilience slice (ROADMAP.md).
"""
from __future__ import annotations

import time
import zlib
from typing import Callable, Optional, Sequence

import torch

__all__ = ["BlobCorruption", "crc_blob", "verify_blob", "retry_transient",
           "RETRY_ATTEMPTS"]

#: bounded-retry attempts at transient alloc sites before escalating
RETRY_ATTEMPTS = 3


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
