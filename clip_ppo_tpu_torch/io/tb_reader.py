"""TensorBoard event reader free of any dependency: the counterpart of
tensorboard's ``EventAccumulator`` for the logs this package and the JAX
package write.

It is the inverse of :mod:`clip_ppo_tpu_torch.io.tb_writer`: TFRecord
framing (length, masked CRC32C of the length, payload, masked CRC32C of the
payload, both CRCs checked) and the ``Event`` / ``Summary`` protobuf decoded
by hand, ``simple_value`` scalars and tensors (the DT_STRING text tensors
``add_text`` writes). What it returns is what ``EventAccumulator`` returns
for such logs:

* every file of the directory whose name holds ``tfevents`` (not
  ``*.profile-empty``), read in sorted name order, one after the other;
  a record that is cut short or fails its CRC ends the file's reading for
  this ``Reload``, as tensorboard's loader treats it as still being written;
* the purge of orphaned data: with a ``file_version`` of 2 or more (both
  writers write ``brain.Event:2``), a ``SessionLog.START`` drops every
  scalar at or past its step; without one, a summary whose step goes back
  drops that summary's tags' scalars at or past it (tensors are never
  purged, as in tensorboard);
* the default size guidance: a per-tag reservoir of 10,000 scalars and 10
  tensors, each tag's sampled with ``random.Random(0)``, always keeping the
  last item (``tensorboard.backend.event_processing.reservoir``). A run that
  logs more than 10,000 episodic returns is thus read as a sample.
"""

from __future__ import annotations

import os
import random
import struct
from typing import Iterator, NamedTuple

from clip_ppo_tpu_torch.io.tb_writer import _masked_crc

SCALARS = "scalars"
TENSORS = "tensors"
DEFAULT_SIZE_GUIDANCE = {SCALARS: 10_000, TENSORS: 10}


class ScalarEvent(NamedTuple):
    wall_time: float
    step: int
    value: float


class TensorProto(NamedTuple):
    """The fields of ``tensorflow.TensorProto`` the metrics read."""

    dtype: int
    string_val: list


class TensorEvent(NamedTuple):
    wall_time: float
    step: int
    tensor_proto: TensorProto


# -- protobuf wire format ------------------------------------------------------


def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    out, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[tuple[int, object]]:
    """(field number, value) of each field of a message: an int for a
    varint, bytes for a length-delimited field, 8 or 4 raw bytes for
    fixed64 and fixed32."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, value


def _int64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _tensor(buf: bytes) -> TensorProto:
    """TensorProto: dtype=1, string_val=8 (the text tensors' fields)."""
    dtype, strings = 0, []
    for field, value in _fields(buf):
        if field == 1:
            dtype = value
        elif field == 8:
            strings.append(bytes(value))
    return TensorProto(dtype, strings)


class _Event(NamedTuple):
    wall_time: float
    step: int
    file_version: str | None
    session_start: bool
    summary: list | None  # [(tag, kind, datum)] with kind "scalar" or "tensor"


def _summary(buf: bytes) -> list:
    """Summary{value=1: Value{tag=1, simple_value=2, node_name=7,
    tensor=8}}; other kinds of value (images, histograms, audio) are not
    written by either package and are skipped."""
    out = []
    for field, value in _fields(buf):
        if field != 1:
            continue
        tag, node_name, kind, datum = "", "", None, None
        for f, v in _fields(value):
            if f == 1:
                tag = bytes(v).decode("utf-8")
            elif f == 7:
                node_name = bytes(v).decode("utf-8")
            elif f == 2:
                kind, datum = "scalar", struct.unpack("<f", v)[0]
            elif f == 8:
                kind, datum = "tensor", _tensor(v)
        if kind == "tensor" and not tag:
            tag = node_name
        out.append((tag, kind, datum))
    return out


def _event(buf: bytes) -> _Event:
    """Event: wall_time=1 (double), step=2, file_version=3, summary=5,
    session_log=7 {status=1, START = 1}."""
    wall_time, step, file_version, start, summary = 0.0, 0, None, False, None
    for field, value in _fields(buf):
        if field == 1:
            wall_time = struct.unpack("<d", value)[0]
        elif field == 2:
            step = _int64(value)
        elif field == 3:
            file_version = bytes(value).decode("utf-8")
        elif field == 5:
            summary = _summary(value)
        elif field == 7:
            start = any(f == 1 and v == 1 for f, v in _fields(value))
    return _Event(wall_time, step, file_version, start, summary)


def read_records(path: str, offset: int = 0) -> Iterator[tuple[bytes, int]]:
    """(payload, offset just past it) of each whole TFRecord of ``path``
    from ``offset``, stopping at the first record that is cut short or
    fails either masked CRC32C."""
    with open(path, "rb") as f:
        f.seek(offset)
        data = f.read()
    pos = 0
    while pos + 12 <= len(data):
        header = data[pos:pos + 8]
        if struct.unpack("<I", data[pos + 8:pos + 12])[0] != _masked_crc(header):
            return
        n = struct.unpack("<Q", header)[0]
        end = pos + 12 + n + 4
        if end > len(data):
            return
        payload = data[pos + 12:pos + 12 + n]
        if struct.unpack("<I", data[end - 4:end])[0] != _masked_crc(payload):
            return
        pos = end
        yield payload, offset + pos


# -- the reservoir ---------------------------------------------------------------


class _Bucket:
    """One tag's reservoir: tensorboard's ``_ReservoirBucket``."""

    def __init__(self, max_size: int):
        self.items: list = []
        self._max_size = max_size
        self._seen = 0
        self._random = random.Random(0)

    def add(self, item) -> None:
        if len(self.items) < self._max_size or self._max_size == 0:
            self.items.append(item)
        else:
            r = self._random.randint(0, self._seen)
            if r < self._max_size:
                self.items.pop(r)
                self.items.append(item)
            else:
                self.items[-1] = item
        self._seen += 1

    def keep(self, fn) -> int:
        """Keep the items for which ``fn`` holds; scale the count seen by
        the share kept. Returns the number removed."""
        before = len(self.items)
        self.items = [x for x in self.items if fn(x)]
        share = len(self.items) / float(before) if before > 0 else 0
        self._seen = int(round(self._seen * share))
        return before - len(self.items)


class _Reservoir:
    def __init__(self, size: int):
        self._size = size
        self._buckets: dict[str, _Bucket] = {}

    def keys(self) -> list[str]:
        return list(self._buckets)

    def items(self, key: str) -> list:
        if key not in self._buckets:
            raise KeyError(f"Key {key} was not found in Reservoir")
        return list(self._buckets[key].items)

    def add(self, key: str, item) -> None:
        if key not in self._buckets:
            self._buckets[key] = _Bucket(self._size)
        self._buckets[key].add(item)

    def keep(self, fn, key: str | None = None) -> int:
        if key is not None:
            return self._buckets[key].keep(fn) if key in self._buckets else 0
        return sum(b.keep(fn) for b in self._buckets.values())


# -- the accumulator ---------------------------------------------------------------


def _is_events_file(name: str) -> bool:
    return "tfevents" in name and not name.endswith(".profile-empty")


class EventAccumulator:
    """``EventAccumulator(path).Reload()``, then ``Tags()``, ``Scalars(tag)``
    and ``Tensors(tag)``, for a run directory or one event file."""

    def __init__(self, path: str, size_guidance: dict | None = None,
                 purge_orphaned_data: bool = True):
        sizes = dict(DEFAULT_SIZE_GUIDANCE, **(size_guidance or {}))
        self.path = path
        self.purge_orphaned_data = purge_orphaned_data
        self.scalars = _Reservoir(sizes[SCALARS])
        self.tensors = _Reservoir(sizes[TENSORS])
        self.file_version: float | None = None
        self.most_recent_step = -1
        self.most_recent_wall_time = -1.0
        self._current: str | None = None
        self._offsets: dict[str, int] = {}

    def _paths(self) -> list[str]:
        if os.path.isfile(self.path):
            return [self.path]
        return sorted(os.path.join(self.path, name) for name in os.listdir(self.path)
                      if _is_events_file(name)
                      and os.path.isfile(os.path.join(self.path, name)))

    def Reload(self) -> "EventAccumulator":  # noqa: N802 (tensorboard's name)
        """Read every event not read yet: the current file's rest, then each
        file after it in name order (tensorboard never goes back to an
        earlier file)."""
        for path in self._paths():
            if self._current is not None and path < self._current:
                continue
            self._current = path
            for payload, offset in read_records(path, self._offsets.get(path, 0)):
                self._offsets[path] = offset
                self._process(_event(payload))
        return self

    def _process(self, event: _Event) -> None:
        if event.file_version is not None:
            try:
                self.file_version = float(event.file_version.split("brain.Event:")[-1])
            except ValueError:
                self.file_version = -1
        if self.purge_orphaned_data:
            if self.file_version and self.file_version >= 2:
                if event.session_start:
                    self._purge(event, by_tags=False)
            elif event.step < self.most_recent_step and event.summary is not None:
                self._purge(event, by_tags=True)
            else:
                self.most_recent_step = event.step
                self.most_recent_wall_time = event.wall_time
        for tag, kind, datum in event.summary or ():
            if kind == "scalar":
                self.scalars.add(tag, ScalarEvent(event.wall_time, event.step, datum))
            elif kind == "tensor":
                self.tensors.add(tag, TensorEvent(event.wall_time, event.step, datum))

    def _purge(self, event: _Event, by_tags: bool) -> None:
        """Drop the scalars at or past ``event.step``: of the event's own
        tags (``by_tags``) or of every tag."""
        def not_expired(x):
            return x.step < event.step

        if by_tags:
            for tag, _kind, _datum in event.summary:
                self.scalars.keep(not_expired, tag)
        else:
            self.scalars.keep(not_expired)

    def Tags(self) -> dict:  # noqa: N802
        return {"images": [], "audio": [], "histograms": [], SCALARS: self.scalars.keys(),
                "distributions": [], TENSORS: self.tensors.keys(), "graph": False,
                "meta_graph": False, "run_metadata": []}

    def Scalars(self, tag: str) -> list[ScalarEvent]:  # noqa: N802
        return self.scalars.items(tag)

    def Tensors(self, tag: str) -> list[TensorEvent]:  # noqa: N802
        return self.tensors.items(tag)
