"""Read-batch loading (a copy of longreadmapper_tpu/runtime/reads.py;
reference: accaln.c:45-58 `reads_load` and the batch/chunk loop at
alnmain.c:302-330).

Input runs through a background prefetch thread (the input-side analog of
pSAscan's async_stream_reader.h / background_block_reader.h, SURVEY.md P4):
disk+gzip waits overlap the device pipeline instead of sitting on the
critical path.  Depth 2 bounds memory at ~2 batches of raw reads.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Tuple

from ..formats.fastx import read_fastx

ReadTuple = Tuple[str, str, Optional[str]]  # (name, seq, qual)


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Run `it` on a daemon thread, buffering up to `depth` items.

    I/O and zlib inflate release the GIL, so parsing the next batch
    overlaps device work even on one core; exceptions re-raise at the
    consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END, _ERR = object(), object()

    def run():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # re-raise on the consumer side
            q.put((_ERR, e))
            return
        q.put(_END)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
            raise item[1]
        yield item


def load_read_batches(path: str, batch_size: int,
                      background: bool = True) -> Iterator[List[ReadTuple]]:
    """Yield batches of up to `batch_size` reads from a FASTA/FASTQ file."""

    def gen():
        batch: List[ReadTuple] = []
        for rec in read_fastx(path):
            batch.append((rec.name, rec.seq, rec.qual))
            if len(batch) == batch_size:
                yield batch
                batch = []
        if batch:
            yield batch

    return prefetch(gen()) if background else gen()


def chunks(batch: List[ReadTuple], size: int) -> Iterator[List[ReadTuple]]:
    for i in range(0, len(batch), size):
        yield batch[i:i + size]
