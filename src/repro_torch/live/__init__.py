"""Live ingest: an append-only log and standing windowed bootstrap sessions.

The port of the JAX package's ``live`` package.  Batches arrive
continuously (``IngestLog``, or its crash-safe cross-process sibling
``DurableIngestLog`` over sealed on-disk segments); one or more standing
``LiveSession``s fold each batch into mergeable per-pane states on the
card (O(Δn) an arrival) and re-emit an accuracy report per batch, with
bounded memory and lag, and honest CIs under duplication, reordering,
loss, torn writes and load shedding.
"""
from repro_torch.live.durable_log import (DurableIngestLog, LogLockedError,
                                          RecoveryReport)
from repro_torch.live.log import BackpressureError, IngestLog, LogBatch
from repro_torch.live.segment import (CorruptSegmentError, SegmentError,
                                      TornSegmentError)
from repro_torch.live.session import LiveCounters, LiveReport, LiveSession

__all__ = [
    "BackpressureError",
    "CorruptSegmentError",
    "DurableIngestLog",
    "IngestLog",
    "LiveCounters",
    "LiveReport",
    "LiveSession",
    "LogBatch",
    "LogLockedError",
    "RecoveryReport",
    "SegmentError",
    "TornSegmentError",
]
