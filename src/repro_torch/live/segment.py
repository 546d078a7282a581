"""On-disk segment format of the durable ingest log.

The port's own copy of the JAX package's ``live/segment.py`` (numpy and
file I/O only): the format is the same byte for byte, so a segment
written by either package reads in the other.  One sealed segment file
holds one ingest batch (one immutable ``ShardedStore`` split), so the file
``seg_<seq>.seg`` IS batch ``seq`` and recovery never guesses where a
batch starts:

    header   magic "EARLSEG1" | version u32 | dim u32 | first_seq u64
             | header_crc u32                                  (28 bytes)
    record   rec_magic u32 | seq u64 | rows u32 | payload_len u32
             | rec_crc u32                                     (24 bytes)
             payload: rows x dim float32, little-endian
             payload_crc u32
    footer   foot_magic u32 | n_records u32 | last_seq u64
             | body_crc u32 | foot_crc u32                     (24 bytes)

Every region is covered by a CRC32: the header, record and footer CRCs
cover their own fixed-size prefix, ``payload_crc`` the rows, and
``body_crc`` chains the record *metadata* (each record header plus its
payload_crc bytes), so the footer binds the structure without a second
pass over the payload.  Any single torn tail or flipped bit is detected,
and the two failure classes get distinct exceptions:

* ``TornSegmentError``: the file ENDS before the structure does (a
  producer died mid-write, or the filesystem dropped un-fsynced pages).
  Recovery truncates here and resumes appending.
* ``CorruptSegmentError``: the file is long enough but fails a CRC or
  magic check.  The writer-side scan truncates the same way; a tailing
  consumer may instead degrade the batch to an invalid split under
  ``FailurePolicy``.

Sealing writes ``.tmp_seg_<seq>.<pid>`` and renames it into place, so a
half-written segment never carries a sealed name.  ``sync=True`` fsyncs
the file before the rename and the directory after it; group commit
re-syncs a batch of sealed files through ``sync_file``/``sync_dir``.
Every file byte passes through ``_write``, the seam that
``ft.inject.enospc_after`` replaces to fill the disk mid-append.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"EARLSEG1"
VERSION = 1
REC_MAGIC = 0x30434552      # "REC0" little-endian
FOOT_MAGIC = 0x30544F46     # "FOT0" little-endian

_HEADER_BODY = struct.Struct("<8sIIQ")   # magic, version, dim, first_seq
_REC_BODY = struct.Struct("<IQII")       # magic, seq, rows, payload_len
_FOOT_BODY = struct.Struct("<IIQI")      # magic, n_records, last_seq, body_crc
_CRC = struct.Struct("<I")

HEADER_SIZE = _HEADER_BODY.size + _CRC.size      # 28
REC_HEADER_SIZE = _REC_BODY.size + _CRC.size     # 24
FOOTER_SIZE = _FOOT_BODY.size + _CRC.size        # 24

_CHUNK = 1 << 20


class SegmentError(IOError):
    """A segment file failed validation."""


class TornSegmentError(SegmentError):
    """The file ends before its structure does (crash mid-write)."""


class CorruptSegmentError(SegmentError):
    """The file is structurally complete but fails a CRC/magic check."""


def _write(f, data) -> None:
    """Single funnel for all segment bytes — the disk-fault injection
    seam (``ft.inject.enospc_after`` patches this to fail mid-append)."""
    f.write(data)


def _sealed(body: struct.Struct, *fields) -> bytes:
    b = body.pack(*fields)
    return b + _CRC.pack(zlib.crc32(b))


def segment_name(seq: int) -> str:
    return f"seg_{seq:08d}.seg"


def parse_segment_name(name: str) -> Optional[int]:
    if not (name.startswith("seg_") and name.endswith(".seg")):
        return None
    digits = name[len("seg_"):-len(".seg")]
    return int(digits) if digits.isdigit() else None


def list_segments(root: str) -> Dict[int, str]:
    """seq -> absolute path of every sealed segment file under ``root``."""
    out: Dict[int, str] = {}
    for name in os.listdir(root):
        seq = parse_segment_name(name)
        if seq is not None:
            out[seq] = os.path.join(root, name)
    return out


def _segment_pieces(seq: int, data: np.ndarray):
    """The byte regions of one sealed single-record segment, in file
    order: (prefix bytes, payload buffer, suffix bytes).  The payload is
    a zero-copy view of the (contiguous) array — ``write_segment``
    streams it straight to the file, and the single CRC pass over the
    data happens here."""
    data = np.ascontiguousarray(data, np.float32)
    if data.ndim == 1:
        data = data[:, None]
    if data.ndim != 2 or data.size == 0:
        raise ValueError(f"segment payload must be non-empty 2-D, "
                         f"got shape {data.shape}")
    rows, dim = data.shape
    payload = memoryview(data).cast("B")
    rec_header = _sealed(_REC_BODY, REC_MAGIC, seq, rows, len(payload))
    pcrc = _CRC.pack(zlib.crc32(payload))
    body_crc = zlib.crc32(pcrc, zlib.crc32(rec_header))
    prefix = _sealed(_HEADER_BODY, MAGIC, VERSION, dim, seq) + rec_header
    suffix = pcrc + _sealed(_FOOT_BODY, FOOT_MAGIC, 1, seq, body_crc)
    return prefix, payload, suffix


def build_segment(seq: int, data: np.ndarray) -> bytes:
    """Serialize one batch as one sealed single-record segment."""
    prefix, payload, suffix = _segment_pieces(seq, data)
    return prefix + bytes(payload) + suffix


def _check_crc(buf: bytes, pos: int, body: struct.Struct,
               what: str) -> Tuple:
    fields = body.unpack_from(buf, pos)
    (crc,) = _CRC.unpack_from(buf, pos + body.size)
    if zlib.crc32(buf[pos:pos + body.size]) != crc:
        raise CorruptSegmentError(f"{what} CRC mismatch at byte {pos}")
    return fields


def parse_segment(buf: bytes, *, expect_seq: Optional[int] = None,
                  expect_dim: Optional[int] = None
                  ) -> Tuple[int, int, List[Tuple[int, np.ndarray]]]:
    """Validate a full segment image; returns (first_seq, dim, records).

    Raises ``TornSegmentError`` whenever the buffer ends before the
    structure does (any truncation point maps here) and
    ``CorruptSegmentError`` for any in-place byte damage (any bit flip
    maps here) — the recovery scanner's two verdicts.
    """
    if len(buf) < HEADER_SIZE:
        raise TornSegmentError(
            f"short header ({len(buf)}/{HEADER_SIZE} bytes)")
    if buf[:len(MAGIC)] != MAGIC:
        raise CorruptSegmentError(f"bad magic {buf[:len(MAGIC)]!r}")
    magic, version, dim, first_seq = _check_crc(buf, 0, _HEADER_BODY,
                                                "header")
    if version != VERSION:
        raise CorruptSegmentError(f"unsupported version {version}")
    if dim < 1:
        raise CorruptSegmentError(f"bad dim {dim}")
    if expect_seq is not None and first_seq != expect_seq:
        raise CorruptSegmentError(
            f"segment claims first_seq {first_seq}, expected {expect_seq}")
    if expect_dim is not None and dim != expect_dim:
        raise CorruptSegmentError(
            f"segment dim {dim} does not match the log's dim {expect_dim}")

    pos = HEADER_SIZE
    records: List[Tuple[int, np.ndarray]] = []
    body_crc = 0
    while True:
        remaining = len(buf) - pos
        if remaining < _CRC.size:
            raise TornSegmentError(f"file ends at byte {pos + remaining} "
                                   "before a footer")
        (peek,) = _CRC.unpack_from(buf, pos)
        if peek == FOOT_MAGIC:
            break
        if peek != REC_MAGIC:
            raise CorruptSegmentError(
                f"bad record magic 0x{peek:08x} at byte {pos}")
        if remaining < REC_HEADER_SIZE:
            raise TornSegmentError(f"short record header at byte {pos}")
        _, seq, rows, payload_len = _check_crc(buf, pos, _REC_BODY,
                                               "record header")
        if rows < 1 or payload_len != rows * dim * 4:
            raise CorruptSegmentError(
                f"record at byte {pos} claims {rows} rows / "
                f"{payload_len} payload bytes (dim {dim})")
        end = pos + REC_HEADER_SIZE + payload_len + _CRC.size
        if len(buf) < end:
            raise TornSegmentError(
                f"short payload for record seq {seq} "
                f"({len(buf) - pos - REC_HEADER_SIZE}/{payload_len} bytes)")
        payload = buf[pos + REC_HEADER_SIZE:end - _CRC.size]
        (pcrc,) = _CRC.unpack_from(buf, end - _CRC.size)
        if zlib.crc32(payload) != pcrc:
            raise CorruptSegmentError(
                f"payload CRC mismatch for record seq {seq}")
        # the footer chains record METADATA (header + payload_crc), not
        # the payload bytes — those are the record CRC's job (one CRC
        # pass per byte of data, at write time and at read time)
        body_crc = zlib.crc32(buf[pos:pos + REC_HEADER_SIZE], body_crc)
        body_crc = zlib.crc32(buf[end - _CRC.size:end], body_crc)
        arr = np.frombuffer(payload, np.float32).reshape(rows, dim)
        records.append((int(seq), arr))
        pos = end

    if len(buf) - pos < FOOTER_SIZE:
        raise TornSegmentError(f"short footer at byte {pos}")
    _, n_records, last_seq, crc = _check_crc(buf, pos, _FOOT_BODY, "footer")
    if len(buf) != pos + FOOTER_SIZE:
        raise CorruptSegmentError(
            f"{len(buf) - pos - FOOTER_SIZE} trailing bytes after footer")
    if not records:
        raise CorruptSegmentError("segment has a footer but no records")
    if n_records != len(records):
        raise CorruptSegmentError(
            f"footer claims {n_records} records, found {len(records)}")
    if last_seq != records[-1][0]:
        raise CorruptSegmentError(
            f"footer claims last_seq {last_seq}, found {records[-1][0]}")
    if crc != body_crc:
        raise CorruptSegmentError("footer body CRC mismatch")
    return int(first_seq), int(dim), records


def read_segment(path: str, *, expect_seq: Optional[int] = None,
                 expect_dim: Optional[int] = None
                 ) -> Tuple[int, int, List[Tuple[int, np.ndarray]]]:
    """Read and fully validate one sealed segment file."""
    with open(path, "rb") as f:
        buf = f.read()
    return parse_segment(buf, expect_seq=expect_seq, expect_dim=expect_dim)


@dataclasses.dataclass(frozen=True)
class SegmentProbe:
    """Best-effort metadata of a (possibly damaged) segment file: what the
    degrade path needs to zero-fill a batch it cannot read — the extent
    (``rows`` x ``dim``) is trusted only if its own header CRCs held."""
    ok: bool
    error: Optional[str]            # None | "torn" | "corrupt"
    reason: str
    first_seq: Optional[int] = None
    dim: Optional[int] = None
    rows: Optional[int] = None


def probe_segment(path: str) -> SegmentProbe:
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except OSError as exc:
        return SegmentProbe(ok=False, error="torn", reason=str(exc))
    first_seq = dim = rows = None
    try:
        if len(buf) >= HEADER_SIZE:
            try:
                _, _, dim, first_seq = _check_crc(buf, 0, _HEADER_BODY,
                                                  "header")
            except CorruptSegmentError:
                dim = first_seq = None
        if dim is not None and len(buf) >= HEADER_SIZE + REC_HEADER_SIZE:
            try:
                _, _, rows, _ = _check_crc(buf, HEADER_SIZE, _REC_BODY,
                                           "record header")
            except CorruptSegmentError:
                rows = None
        parse_segment(buf)
    except TornSegmentError as exc:
        return SegmentProbe(ok=False, error="torn", reason=str(exc),
                            first_seq=first_seq, dim=dim, rows=rows)
    except CorruptSegmentError as exc:
        return SegmentProbe(ok=False, error="corrupt", reason=str(exc),
                            first_seq=first_seq, dim=dim, rows=rows)
    return SegmentProbe(ok=True, error=None, reason="",
                        first_seq=first_seq, dim=dim, rows=rows)


def sync_file(path: str) -> None:
    """Make a sealed segment's bytes durable.  ``fdatasync`` (where the
    platform has it) flushes the data and the size-changing metadata a
    reader needs, but skips the pure-timestamp inode update — one fewer
    journal commit per segment than a full ``fsync``."""
    fd = os.open(path, os.O_RDONLY)
    try:
        getattr(os, "fdatasync", os.fsync)(fd)
    finally:
        os.close(fd)


def sync_dir(root: str) -> None:
    """fsync the directory so renames of sealed segments are durable."""
    fd = os.open(root, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_segment(root: str, seq: int, data: np.ndarray, *,
                  sync: bool = False) -> str:
    """Seal one batch as ``seg_<seq>.seg`` under ``root`` (atomic rename).

    ``sync=True`` fsyncs the file before the rename and the directory
    after it — the batch is durable when this returns.  ``sync=False``
    leaves flushing to the caller's group-commit (``sync_file`` +
    ``sync_dir``) or to the OS.  On any write failure the staging file is
    removed: a failed append never leaves a sealed name behind, so the
    log stays readable (ENOSPC contract).
    """
    prefix, payload, suffix = _segment_pieces(seq, data)
    tmp = os.path.join(root, f".tmp_seg_{seq:08d}.{os.getpid()}")
    final = os.path.join(root, segment_name(seq))
    try:
        with open(tmp, "wb") as f:
            _write(f, prefix)
            for off in range(0, len(payload), _CHUNK):
                _write(f, payload[off:off + _CHUNK])
            _write(f, suffix)
            if sync:
                f.flush()
                getattr(os, "fdatasync", os.fsync)(f.fileno())
        os.rename(tmp, final)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if sync:
        sync_dir(root)
    return final
