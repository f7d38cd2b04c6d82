"""Data pipeline: RecordIO-style binary token store + prefetching loader
(the port's copy of ``repro.train.data``, which imports only numpy; the
file format and the batches are the same, so either package reads the
other's files).

The paper (F6, §4.4.1) stores datasets in TFRecord/RecordIO formats —
contiguous binary layouts optimized for sequential reads. We implement the
same idea for token data: fixed-width records in one contiguous file with a
small JSON index header, memory-mapped reads, and a background-thread
prefetch loader (producer/consumer, mirroring the pipeline executor).

Fault tolerance: the loader exposes a ``cursor`` (records consumed) saved
in checkpoints; ``make_loader(..., skip=cursor)`` resumes exactly.
"""
from __future__ import annotations

import json
import os
import queue
import struct
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

_MAGIC = b"RIO1"


class RecordIOWriter:
    """Fixed-width int32 token records: [magic][json header][payload]."""

    def __init__(self, path: str, seq_len: int) -> None:
        self.path = path
        self.seq_len = seq_len
        self.count = 0
        self._tmp = path + ".tmp"
        self._f = open(self._tmp, "wb")
        self._f.write(_MAGIC)
        self._f.write(struct.pack("<I", 0))  # header length placeholder
        self._header_pos = self._f.tell()

    def append(self, tokens: np.ndarray) -> None:
        tokens = np.asarray(tokens, dtype=np.int32)
        if tokens.shape != (self.seq_len,):
            raise ValueError(f"record must be ({self.seq_len},), got {tokens.shape}")
        self._f.write(tokens.tobytes())
        self.count += 1

    def close(self) -> None:
        self._f.close()
        header = json.dumps(
            {"seq_len": self.seq_len, "count": self.count, "dtype": "int32"}
        ).encode()
        # rewrite with header (header follows magic+len, then payload)
        with open(self._tmp, "rb") as f:
            f.seek(self._header_pos)
            payload = f.read()
        with open(self._tmp, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<I", len(header)))
            f.write(header)
            f.write(payload)
        os.replace(self._tmp, self.path)


class RecordIOReader:
    """Memory-mapped sequential/random reads over a RecordIO token file."""

    def __init__(self, path: str) -> None:
        with open(path, "rb") as f:
            magic = f.read(4)
            if magic != _MAGIC:
                raise ValueError(f"{path}: bad magic {magic!r}")
            (hlen,) = struct.unpack("<I", f.read(4))
            header = json.loads(f.read(hlen).decode())
            self.offset = f.tell()
        self.seq_len = int(header["seq_len"])
        self.count = int(header["count"])
        self._mm = np.memmap(path, dtype=np.int32, mode="r", offset=self.offset)

    def __len__(self) -> int:
        return self.count

    def record(self, i: int) -> np.ndarray:
        if not 0 <= i < self.count:
            raise IndexError(i)
        s = self.seq_len
        return np.asarray(self._mm[i * s : (i + 1) * s])

    def batch(self, start: int, batch_size: int) -> np.ndarray:
        """Contiguous batch with wraparound (epoch crossing)."""
        idx = (start + np.arange(batch_size)) % self.count
        if np.all(np.diff(idx) == 1):  # fast contiguous path
            s = self.seq_len
            i0 = int(idx[0])
            return np.asarray(self._mm[i0 * s : (i0 + batch_size) * s]).reshape(
                batch_size, s
            )
        return np.stack([self.record(int(i)) for i in idx])


class SyntheticTokenDataset:
    """Deterministic synthetic LM data (Zipf-ish marginals), offline stand-in."""

    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0) -> None:
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.seed = seed

    def batch(self, start: int, batch_size: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + start)
        ranks = rng.zipf(1.3, size=(batch_size, self.seq_len)).astype(np.int64)
        return (ranks % self.vocab_size).astype(np.int32)

    def write_recordio(self, path: str, num_records: int) -> None:
        w = RecordIOWriter(path, self.seq_len)
        for i in range(num_records):
            w.append(self.batch(i, 1)[0])
        w.close()


def make_loader(
    source,
    batch_size: int,
    skip: int = 0,
    prefetch: int = 2,
) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
    """Background-prefetching loader yielding (cursor, batch) pairs.

    ``cursor`` is the number of records consumed INCLUDING this batch — save
    it in the checkpoint; pass it back as ``skip`` to resume.
    """
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def produce() -> None:
        cursor = skip
        while not stop.is_set():
            batch = source.batch(cursor, batch_size)
            cursor += batch_size
            q.put((cursor, {"tokens": batch}))

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
        try:  # unblock the producer if it's waiting on a full queue
            q.get_nowait()
        except queue.Empty:
            pass
