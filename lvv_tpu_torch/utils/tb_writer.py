"""Minimal TensorBoard scalar event writer, no dependencies (the port's
copy of lvv_tpu/utils/tb_writer.py).

It writes `events.out.tfevents.*` files natively: TFRecord framing (length +
masked-crc32c) around hand-encoded `Event{wall_time, step,
summary{value{tag, simple_value}}}` protobufs. TensorBoard's scalar
dashboard reads these directly.

Protobuf wire format used (tensorflow/core/util/event.proto):
  Event:   field 1 double wall_time, 2 int64 step, 5 message summary
  Summary: field 1 repeated message value
  Value:   field 1 string tag, 2 float simple_value
"""
from __future__ import annotations

import pathlib
import struct
import time
from typing import Union

_CRC_TABLE = []


def _crc32c_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _encode_event(tag: str, value: float, step: int,
                  wall_time: float) -> bytes:
    tag_b = tag.encode()
    val = (_field(1, 2) + _varint(len(tag_b)) + tag_b
           + _field(2, 5) + struct.pack("<f", float(value)))
    summary = _field(1, 2) + _varint(len(val)) + val
    event = (_field(1, 1) + struct.pack("<d", wall_time)
             + _field(2, 0) + _varint(int(step) & (2 ** 64 - 1))
             + _field(5, 2) + _varint(len(summary)) + summary)
    return event


def _tfrecord(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc(header))
            + payload + struct.pack("<I", masked_crc(payload)))


class SummaryWriter:
    """`add_scalar(tag, value, step)` -> TensorBoard event file."""

    def __init__(self, log_dir: Union[str, pathlib.Path]):
        self.dir = pathlib.Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.lvv"
        self._f = open(self.dir / fname, "ab")
        # file-version header event (tensorboard expects it first)
        version = _field(1, 1) + struct.pack("<d", time.time()) + \
            _field(3, 2) + _varint(len(b"brain.Event:2")) + b"brain.Event:2"
        self._f.write(_tfrecord(version))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: float | None = None) -> None:
        ev = _encode_event(tag, value, step,
                           time.time() if wall_time is None else wall_time)
        self._f.write(_tfrecord(ev))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
