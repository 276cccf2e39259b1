"""RecordDataset: shard-assigned, shuffled, batched record input with
background prefetch, a copy of the JAX package's ``data/dataset.py``: the
same files, seed, host index and host count give the same batches.

Each host constructs the dataset with its ``(host_index, num_hosts)`` and,
in the default file-sharded mode, reads ONLY its round-robin share of the
sorted shard list, so host input bandwidth and memory scale 1/hosts. When
the file list cannot cover the hosts, ``shard_by="records"`` stripes the
record sequence instead (disjoint per host, but every host index-scans
all files).

Epoch order is a seeded permutation over the host's records (seed folded
with the epoch number, so every epoch reshuffles deterministically and a
restarted host replays the identical stream). Decoding can run on a
background thread into a bounded queue, overlapping file IO + CRC +
decode with device compute; a subclass may replace the decode stage
(``_decode_records``), as ``images.ImageDataset`` does with its worker
pool.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tfk8s_tpu_torch.data import example as example_codec
from tfk8s_tpu_torch.data.recordio import RecordFile, shard_files


class RecordDataset:
    def __init__(
        self,
        files: Sequence[str],
        batch_size: int,
        host_index: int = 0,
        num_hosts: int = 1,
        seed: int = 0,
        shuffle: bool = True,
    ):
        """The per-host input division (``shard_by``) is by files when the
        list covers the hosts: round-robin over the sorted file list, each
        host opening ONLY its share. Otherwise by records: every host
        indexes all files but owns the record stripe
        ``host_index::num_hosts``. Batches are whole: a remainder is
        dropped. Every read is CRC-checked."""
        # dedupe up front: overlapping globs in the input spec must not
        # double-index records (which would overlap host stripes AND
        # double-weight the duplicated shard per epoch)
        unique = sorted(set(files))
        shard_by = "files" if len(unique) >= num_hosts else "records"
        self.shard_by = shard_by
        if shard_by == "files":
            self.files = shard_files(unique, host_index, num_hosts)
        else:
            if not 0 <= host_index < num_hosts:
                raise ValueError(
                    f"host_index {host_index} not in [0, {num_hosts})"
                )
            self.files = unique
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.bytes_read = 0  # cumulative payload bytes (input-rate metric)
        self._shards = [RecordFile(p) for p in self.files]
        # global record addressing: (shard_idx, record_idx) pairs
        self._addr: List[Tuple[int, int]] = [
            (si, ri)
            for si, sh in enumerate(self._shards)
            for ri in range(len(sh))
        ]
        if shard_by == "records":
            # deterministic disjoint stripe per host over the full
            # record sequence (file order then record order)
            total = len(self._addr)
            self._addr = self._addr[host_index::num_hosts]
            if not self._addr:
                raise ValueError(
                    f"host {host_index}'s record stripe is empty: "
                    f"{total} records across {self.files} cannot feed "
                    f"{num_hosts} hosts"
                )
        if not self._addr:
            raise ValueError(f"no records in shard set {self.files}")
        if len(self._addr) < batch_size:
            fix = (
                "write more records or use fewer hosts"
                if shard_by == "records"  # stripe size is total/hosts
                else "write more records or rebalance files across hosts"
            )
            raise ValueError(
                f"shard set {self.files} holds {len(self._addr)} records "
                f"for this host — fewer than one batch of {batch_size} — {fix}"
            )

    def __len__(self) -> int:
        return len(self._addr)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self._addr))
        if self.shuffle:
            np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch])
            ).shuffle(idx)
        return idx

    def batches_per_epoch(self) -> int:
        return len(self._addr) // self.batch_size

    def batches(self, epoch: int, start_batch: int = 0):
        """Yield stacked host batches for one epoch, in the seeded order,
        starting at batch ``start_batch`` (skipped batches are index
        arithmetic — no file reads). Reads are grouped per shard file
        within each batch (one native bulk read per file touched)."""
        order = self._epoch_order(epoch)
        stop = self.batches_per_epoch() * self.batch_size
        for lo in range(start_batch * self.batch_size, stop, self.batch_size):
            take = order[lo : lo + self.batch_size]
            yield self._load(take, epoch)

    def _load(self, take: np.ndarray, epoch: int) -> Dict[str, np.ndarray]:
        # group indices by shard, bulk-read each, then restore batch order
        by_shard: Dict[int, List[int]] = {}
        slots: List[Tuple[int, int]] = []  # (shard, position-in-group)
        for g in take:
            si, ri = self._addr[int(g)]
            grp = by_shard.setdefault(si, [])
            slots.append((si, len(grp)))
            grp.append(ri)
        raw: Dict[int, List[bytes]] = {
            si: self._shards[si].read(ris)
            for si, ris in by_shard.items()
        }
        # input-bandwidth accounting: consumers (the trainer's windowed
        # progress report) difference this to surface read MB/s — an
        # operator alert can then SEE input starvation (e.g. the ~120x
        # pure-Python codec fallback) instead of inferring it from step
        # time
        self.bytes_read += sum(sum(len(r) for r in rs) for rs in raw.values())
        examples = self._decode_records(
            [raw[si][pos] for si, pos in slots], [int(g) for g in take], epoch)
        if isinstance(examples, dict):
            # the decode stage assembled the batch itself (the image
            # pipeline's workers write a preallocated [B, ...] batch in
            # place; stacking again would copy the whole batch)
            return examples
        keys = examples[0].keys()
        for ex in examples[1:]:
            if ex.keys() != keys:
                raise ValueError(
                    f"inconsistent example keys: {sorted(keys)} vs "
                    f"{sorted(ex.keys())}"
                )
        out = {}
        for k in keys:
            vals = [ex[k] for ex in examples]
            shapes = {np.shape(v) for v in vals}
            if len(shapes) > 1:
                hint = (
                    " — these look like IMAGE records (data/images); set "
                    "input_format='image' (TFK8S_INPUT_FORMAT=image) so "
                    "they decode instead of batching raw bytes"
                    if k.startswith("image/")
                    else ""
                )
                raise ValueError(
                    f"records disagree on {k!r} shape ({sorted(shapes)[:4]}"
                    f"...): ragged examples cannot stack into a batch{hint}"
                )
            out[k] = np.stack(vals)
        return out

    def _decode_records(self, records: List[bytes], record_ids: List[int], epoch: int
                        ) -> List[Dict[str, np.ndarray]]:
        """Record payloads -> example dicts, in batch order: the decode
        stage, which a dataset whose decode is expensive overrides
        (``images.ImageDataset`` runs it on a worker pool). ``record_ids``
        (the dataset's record indices) and ``epoch`` identify each record
        whatever its batch position, so a subclass can seed per-record
        augmentation that a resume replays. A subclass may instead return
        the assembled batch, a dict of stacked arrays, which ``_load``
        passes on untouched."""
        return [example_codec.decode(r) for r in records]

    def close(self) -> None:
        """Release any decode resources (a subclass's worker pool). The base
        dataset holds none: a no-op, so every consumer can close
        unconditionally."""

    def iterator(self, prefetch: int = 2, start_batch: int = 0):
        """An endless batch iterator cycling epochs. ``prefetch > 0``
        runs a background producer thread keeping that many decoded
        batches staged; ``prefetch=0`` is synchronous (for consumers
        that bring their own overlap). ``start_batch`` fast-forwards to
        that global batch index (epoch = index // batches_per_epoch)
        without reading the skipped records — checkpoint resume lands on
        the exact batch the restarted step would have seen. ``.close()``
        it (or let it be GC'd) to stop any producer."""
        if prefetch <= 0:
            return _SyncIterator(self, start_batch)
        return _PrefetchIterator(self, prefetch, start_batch)

    def as_batch_fn(self, prefetch: int = 0):
        """Adapter to ``TrainTask.make_batch(np_rng, batch_size)``: the
        rng argument is ignored — order comes from the dataset's own
        seeded epoch permutation (restart-reproducible, unlike consuming
        a shared rng whose position depends on call history).

        Default is the SYNCHRONOUS iterator: ``Trainer.fit`` already
        wraps ``make_batch`` in its background ``_BatchPrefetcher``
        (runtime/train.py), and stacking a second producer thread under
        it would double-buffer the same batches and leak a thread after
        fit returns. Pass ``prefetch>0`` only for consumers with no
        prefetcher of their own."""
        it = self.iterator(prefetch)

        def make_batch(_rng, batch_size: int) -> Dict[str, np.ndarray]:
            if batch_size != self.batch_size:
                raise ValueError(
                    f"dataset built for batch_size={self.batch_size}, "
                    f"asked for {batch_size}"
                )
            return next(it)

        make_batch.close = it.close  # type: ignore[attr-defined]
        return make_batch


class _SyncIterator:
    """Endless epoch-cycling batch iterator, no threads."""

    def __init__(self, ds: RecordDataset, start_batch: int = 0):
        self._ds = ds
        bpe = ds.batches_per_epoch()
        self._epoch = start_batch // bpe
        self._gen = ds.batches(self._epoch, start_batch % bpe)
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        try:
            return next(self._gen)
        except StopIteration:
            self._epoch += 1
            self._gen = self._ds.batches(self._epoch)
            return next(self._gen)

    def close(self) -> None:
        self._closed = True


class _PrefetchIterator:
    def __init__(self, ds: RecordDataset, prefetch: int, start_batch: int = 0):
        self._ds = ds
        self._start_batch = start_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._produce, name="record-prefetch", daemon=True
        )
        self._thread.start()

    def _produce(self) -> None:
        bpe = self._ds.batches_per_epoch()
        epoch, within = self._start_batch // bpe, self._start_batch % bpe
        try:
            while not self._stop.is_set():
                for batch in self._ds.batches(epoch, within):
                    while not self._stop.is_set():
                        try:
                            self._q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
                epoch += 1
                within = 0
        except BaseException as exc:  # surface IO/decode errors to consumer
            self._exc = exc
            self._stop.set()

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        while True:
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if self._exc is not None:
                    raise self._exc
                if self._stop.is_set():
                    raise StopIteration
                if not self._thread.is_alive():
                    raise RuntimeError("record-prefetch thread died silently")

    def close(self) -> None:
        self._stop.set()

    def __del__(self):  # best-effort producer shutdown
        self._stop.set()
