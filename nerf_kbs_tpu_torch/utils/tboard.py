"""Dependency-free TensorBoard scalar event writer (the JAX package's
``utils/tboard.py``, copied: the port imports nothing of that package).

``TrainerConfig.vis`` containing "tensorboard" makes the trainer append every
float metric it logs as a scalar event that a stock TensorBoard reads.

Written from the wire formats, not against a library:
- TFRecord: ``uint64 len | uint32 masked_crc32c(len) | bytes data |
  uint32 masked_crc32c(data)``, crc32c = Castagnoli (reflected poly
  0x82F63B78), mask = ((c >> 15 | c << 17) + 0xa282ead8) mod 2^32.
- Event proto: wall_time (field 1, double), step (field 2, int64),
  file_version (field 3, string) / summary (field 5, message);
  Summary.Value: tag (field 1, string), simple_value (field 2, float).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 * (_c & 1))
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = (c >> 8) ^ _CRC_TABLE[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = _crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _bytes_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int, *, file_version: str | None = None,
           scalars: dict[str, float] | None = None) -> bytes:
    msg = _field(1, 1) + struct.pack("<d", wall_time)
    msg += _field(2, 0) + _varint(step)
    if file_version is not None:
        msg += _bytes_field(3, file_version.encode())
    if scalars:
        summary = b""
        for tag, val in scalars.items():
            value = _bytes_field(1, tag.encode())
            value += _field(2, 5) + struct.pack("<f", float(val))
            summary += _bytes_field(1, value)
        msg += _bytes_field(5, summary)
    return msg


class TensorboardWriter:
    """Appends scalar events to ``<logdir>/events.out.tfevents.*``."""

    def __init__(self, logdir: str | os.PathLike):
        Path(logdir).mkdir(parents=True, exist_ok=True)
        host = socket.gethostname() or "host"
        self._path = Path(logdir) / (
            f"events.out.tfevents.{int(time.time())}.{host}.{os.getpid()}"
        )
        self._f = open(self._path, "ab")
        self._record(_event(time.time(), 0, file_version="brain.Event:2"))

    def _record(self, data: bytes) -> None:
        ln = struct.pack("<Q", len(data))
        self._f.write(ln + struct.pack("<I", _masked_crc(ln)) + data
                      + struct.pack("<I", _masked_crc(data)))
        self._f.flush()

    def add_scalars(self, step: int, scalars: dict[str, float]) -> None:
        vals = {k: float(v) for k, v in scalars.items()
                if isinstance(v, (int, float)) and k != "step"}
        if vals:
            self._record(_event(time.time(), int(step), scalars=vals))

    def close(self) -> None:
        self._f.close()
