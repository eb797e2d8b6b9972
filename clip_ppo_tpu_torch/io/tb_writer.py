"""TensorBoard event writer with the reference's tag semantics, free of any
dependency.

The metrics layer machine-reads these logs (`calculate_metrics.py:16-87`):
scalar tags like ``charts/episodic_return`` and the disturbance severity as
the text tensor tag ``config/disturbance_severity/text_summary``. This
writer produces both formats (``simple_value`` scalars; DT_STRING tensors
with the "text" plugin metadata, as torch's SummaryWriter does), encoding
the ``Event`` protobuf records and the TFRecord framing (length, masked
CRC32C of the length, payload, masked CRC32C of the payload) by hand.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time

# -- CRC32C (Castagnoli), as TFRecord frames use it ---------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header)) + payload
            + struct.pack("<I", _masked_crc(payload)))


# -- protobuf wire format -------------------------------------------------------


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int | None = None, file_version: str | None = None,
           summary: bytes | None = None) -> bytes:
    """tensorflow.Event: wall_time=1 (double), step=2, file_version=3, summary=5."""
    out = _key(1, 1) + struct.pack("<d", wall_time)
    if step is not None:
        out += _key(2, 0) + _varint(int(step))
    if file_version is not None:
        out += _len_field(3, file_version.encode())
    if summary is not None:
        out += _len_field(5, summary)
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    """Summary{value=1: Value{tag=1, simple_value=2 (float)}}."""
    val = _len_field(1, tag.encode()) + _key(2, 5) + struct.pack("<f", float(value))
    return _len_field(1, val)


def _text_summary(tag: str, text: str) -> bytes:
    """Summary.Value with metadata=9 {plugin_data=1 {plugin_name=1 "text",
    content=2 "{}"}} and tensor=8 {dtype=1 DT_STRING (7), tensor_shape=2
    {dim=2 {size=1 1}}, string_val=8}."""
    plugin = _len_field(1, b"text") + _len_field(2, b"{}")
    metadata = _len_field(1, plugin)
    shape = _len_field(2, _key(1, 0) + _varint(1))
    tensor = _key(1, 0) + _varint(7) + _len_field(2, shape) + _len_field(8, text.encode("utf-8"))
    val = _len_field(1, tag.encode()) + _len_field(9, metadata) + _len_field(8, tensor)
    return _len_field(1, val)


_WRITERS = itertools.count()


class SummaryWriter:
    """torch-SummaryWriter-compatible ``add_scalar`` / ``add_text``."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        # The last field counts this process's writers, as tensorboard's
        # EventFileWriter does: two writers of one process and one second
        # (a run resumed in the same process) get files of their own.
        name = (f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}."
                f"{os.getpid()}.{next(_WRITERS)}")
        self._file = open(os.path.join(log_dir, name), "wb")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        self._file.write(tfrecord(event))

    def add_scalar(self, tag: str, value, global_step: int | None = None) -> None:
        self._write(_event(time.time(), global_step, summary=_scalar_summary(tag, value)))

    def add_text(self, tag: str, text: str, global_step: int | None = None) -> None:
        # '<tag>/text_summary', the layout `get_disturbance_severity` reads
        # back (`calculate_metrics.py:57-87`).
        self._write(_event(time.time(), global_step,
                           summary=_text_summary(tag + "/text_summary", text)))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()


def hyperparameters_table(args_dict: dict) -> str:
    """Markdown hyperparameter table text (`ppo_minigrid.py:184-187`)."""
    rows = "\n".join([f"|{key}|{value}|" for key, value in args_dict.items()])
    return "|param|value|\n|-|-|\n%s" % rows
