"""Dependency-free TensorBoard scalar logging.

The port's copy of ``gaze_tpu/utils/tboard.py`` (a pure-Python module,
copied so the port imports nothing of the JAX package). It writes the
TFRecord/Event wire format directly — protobuf varint/field encoding
plus the masked-CRC32C record framing — so no tensorboard or tensorflow
install is needed to write, and any stock TensorBoard install reads the
``events.out.tfevents.*`` files.

Scalars only (loss curves, validation metrics, throughput). Images go
through ``logging.dump_heatmap_png``.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven — TFRecord framing checksums.

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf writers (wire types: 0 varint, 1 fixed64, 2 bytes,
# 5 fixed32). Field numbers follow tensorflow/core/util/event.proto and
# tensorflow/core/framework/summary.proto.


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _pb_double(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _pb_float(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _pb_varint(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(num: int, v: bytes) -> bytes:
    return _field(num, 2) + _varint(len(v)) + v


def _event(wall_time: float, step: Optional[int] = None,
           file_version: Optional[str] = None,
           summary: Optional[bytes] = None) -> bytes:
    # Event: 1 wall_time (double), 2 step (int64), 3 file_version
    # (string), 5 summary (Summary)
    msg = _pb_double(1, wall_time)
    if step is not None:
        msg += _pb_varint(2, step)
    if file_version is not None:
        msg += _pb_bytes(3, file_version.encode())
    if summary is not None:
        msg += _pb_bytes(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    # Summary.Value: 1 tag (string), 2 simple_value (float);
    # Summary: 1 value (repeated Value)
    val = _pb_bytes(1, tag.encode()) + _pb_float(2, float(value))
    return _pb_bytes(1, val)


def _record(data: bytes) -> bytes:
    # TFRecord: len u64 | masked_crc32c(len) u32 | data | masked_crc32c(data)
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", _masked_crc(header))
            + data + struct.pack("<I", _masked_crc(data)))


class SummaryWriter:
    """Append-only scalar event writer, TensorBoard-compatible.

    >>> w = SummaryWriter("runs/sp")
    >>> w.add_scalar("loss", 0.12, step=100)
    >>> w.close()
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}")
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._f.write(_record(_event(time.time(),
                                     file_version="brain.Event:2")))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(_record(_event(
            time.time(), step=step, summary=_scalar_summary(tag, value)
        )))

    def add_scalars(self, values: Dict[str, float], step: int) -> None:
        for tag, v in values.items():
            self.add_scalar(tag, v, step)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()


# ---------------------------------------------------------------------------
# Reader (for tests + offline inspection without tensorboard installed).


def read_scalars(path: str):
    """Parse an events file written by SummaryWriter; yields
    (step, tag, value). Verifies record CRCs."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (n,) = struct.unpack_from("<Q", data, pos)
        header = data[pos : pos + 8]
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        if _masked_crc(header) != hcrc:
            raise ValueError("corrupt record header crc")
        payload = data[pos + 12 : pos + 12 + n]
        (dcrc,) = struct.unpack_from("<I", data, pos + 12 + n)
        if _masked_crc(payload) != dcrc:
            raise ValueError("corrupt record data crc")
        pos += 12 + n + 4
        step, summary = 0, None
        p = 0
        while p < len(payload):
            tag_byte = payload[p]
            num, wire = tag_byte >> 3, tag_byte & 7
            p += 1
            if wire == 1:
                p += 8
            elif wire == 5:
                p += 4
            elif wire == 0:
                v = 0
                shift = 0
                while True:
                    b = payload[p]
                    p += 1
                    v |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                if num == 2:
                    step = v
            elif wire == 2:
                ln = 0
                shift = 0
                while True:
                    b = payload[p]
                    p += 1
                    ln |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                if num == 5:
                    summary = payload[p : p + ln]
                p += ln
        if summary:
            q = 0
            while q < len(summary):
                assert summary[q] == 0x0A
                q += 1
                ln = summary[q]
                q += 1
                val = summary[q : q + ln]
                q += ln
                r, tag_s, simple = 0, None, None
                while r < len(val):
                    if val[r] == 0x0A:
                        tl = val[r + 1]
                        tag_s = val[r + 2 : r + 2 + tl].decode()
                        r += 2 + tl
                    elif val[r] == 0x15:
                        (simple,) = struct.unpack_from("<f", val, r + 1)
                        r += 5
                    else:
                        raise ValueError("unexpected Value field")
                yield step, tag_s, simple
