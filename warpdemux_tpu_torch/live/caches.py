"""Per-channel read caches for the live-read stream (a numpy copy of
warpdemux_tpu/live/caches.py).

Capability parity with the reference's vendored read_until caches
(warpdemux/read_until/read_cache.py): `ReadCache` keeps the latest chunk per
channel with oldest-channel eviction; `AccumulatingCache` concatenates
successive raw chunks of the same read up to a byte budget so multi-chunk
classification can re-analyze the full prefix.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np


@dataclass
class LiveRead:
    """A (possibly accumulated) chunk of a read in progress."""

    channel: int
    read_id: str
    read_number: int
    signal: np.ndarray  # calibrated pA, float32
    chunk_start: int = 0
    start_sample: int = 0  # where the read began (missed-start gate input)
    chunk_classifications: tuple = ()


class ReadCache:
    """Latest chunk per channel; evicts the oldest channel when full."""

    def __init__(self, size: int = 512):
        if size < 1:
            raise ValueError("size must be >= 1")
        self.size = size
        self._dict: OrderedDict[int, LiveRead] = OrderedDict()
        self._lock = threading.RLock()
        self.missed = 0
        self.replaced = 0

    def __len__(self):
        with self._lock:
            return len(self._dict)

    def set(self, channel: int, read: LiveRead) -> None:
        with self._lock:
            if channel in self._dict:
                old = self._dict.pop(channel)
                if old.read_number == read.read_number:
                    self.replaced += 1
                else:
                    self.missed += 1
            elif len(self._dict) >= self.size:
                self._dict.popitem(last=False)
                self.missed += 1
            self._dict[channel] = read

    def pop_all(self) -> list[tuple[int, LiveRead]]:
        with self._lock:
            items = list(self._dict.items())
            self._dict.clear()
            return items


class AccumulatingCache(ReadCache):
    """Concatenates chunks of the same read (reference
    read_until/read_cache.py:153-284) up to `max_raw_signal` samples."""

    def __init__(self, size: int = 512, max_raw_signal: int = 12000):
        super().__init__(size)
        self.max_raw_signal = max_raw_signal

    def set(self, channel: int, read: LiveRead) -> None:
        with self._lock:
            prev = self._dict.get(channel)
            if prev is not None and prev.read_number == read.read_number:
                joined = np.concatenate([prev.signal, read.signal])
                if joined.size > self.max_raw_signal:
                    joined = joined[: self.max_raw_signal]
                read = LiveRead(
                    channel=read.channel,
                    read_id=read.read_id,
                    read_number=read.read_number,
                    signal=joined,
                    chunk_start=prev.chunk_start,
                    start_sample=read.start_sample,
                    chunk_classifications=prev.chunk_classifications
                    + read.chunk_classifications,
                )
                self._dict.pop(channel)
                self._dict[channel] = read
                self.replaced += 1
            else:
                super().set(channel, read)


class _ChannelBuffer:
    """Preallocated per-channel accumulation buffer (the reference's
    ChannelCache, read_until/read_cache.py:287-491): chunk appends are
    memcpy into a fixed array — zero allocation on the 100 ms hot path."""

    __slots__ = (
        "buf", "filled", "read_id", "read_number", "chunk_start",
        "start_sample", "chunk_classifications", "fresh",
    )

    def __init__(self, max_raw_signal: int):
        self.buf = np.zeros(max_raw_signal, np.float32)
        self.reset("", -1)

    def reset(self, read_id: str, read_number: int, chunk_start: int = 0,
              start_sample: int = 0):
        self.filled = 0
        self.read_id = read_id
        self.read_number = read_number
        self.chunk_start = chunk_start
        self.start_sample = start_sample
        self.chunk_classifications: tuple = ()
        self.fresh = False

    def append(self, signal: np.ndarray, classifications: tuple):
        take = min(signal.size, self.buf.size - self.filled)
        if take > 0:
            self.buf[self.filled : self.filled + take] = signal[:take]
            self.filled += take
        self.chunk_classifications = (
            self.chunk_classifications + classifications
        )
        self.fresh = True


class PreallocAccumulatingCache:
    """AccumulatingCache semantics over preallocated channel buffers.

    Same pop_all()/set() surface as ReadCache, but every channel owns a
    fixed float32 buffer sized max_raw_signal; accumulation never allocates
    and pop_all returns *copies* of only the filled prefix. Mirrors the
    reference's PreallocAccumulatingCache (read_until/read_cache.py:287-491).
    """

    def __init__(self, size: int = 512, max_raw_signal: int = 12000):
        self.size = size
        self.max_raw_signal = max_raw_signal
        self._chan: dict[int, _ChannelBuffer] = {}
        self._lock = threading.RLock()
        self.missed = 0
        self.replaced = 0

    def __len__(self):
        with self._lock:
            return sum(1 for c in self._chan.values() if c.fresh)

    def set(self, channel: int, read: LiveRead) -> None:
        with self._lock:
            cb = self._chan.get(channel)
            if cb is None:
                if len(self._chan) >= self.size:
                    self.missed += 1
                    return
                cb = _ChannelBuffer(self.max_raw_signal)
                self._chan[channel] = cb
                cb.reset(read.read_id, read.read_number, read.chunk_start,
                         read.start_sample)
            elif cb.read_number != read.read_number:
                if cb.fresh:
                    self.missed += 1
                cb.reset(read.read_id, read.read_number, read.chunk_start,
                         read.start_sample)
            else:
                self.replaced += 1
            cb.append(read.signal, tuple(read.chunk_classifications))

    def pop_all(self) -> list[tuple[int, LiveRead]]:
        out = []
        with self._lock:
            for channel, cb in self._chan.items():
                if not cb.fresh or cb.filled == 0:
                    continue
                out.append(
                    (
                        channel,
                        LiveRead(
                            channel=channel,
                            read_id=cb.read_id,
                            read_number=cb.read_number,
                            signal=cb.buf[: cb.filled].copy(),
                            chunk_start=cb.chunk_start,
                            start_sample=cb.start_sample,
                            chunk_classifications=cb.chunk_classifications,
                        ),
                    )
                )
                cb.fresh = False
        return out
