"""Fixed-shape host batches, and their prefetch to the device.

Copy of ``vqa_project_tpu/data/loader.py``: each batch is a handful of
vectorized numpy gathers from the dataset's tables; the final partial
batch is padded to the fixed shape with rows whose mask is 0. Host mode
(``materialize=True``) carries dense images, answers and votes; index
mode (``materialize=False``) carries the image row and the sparse label
entries for a device feature cache, a few KB per batch.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from vqa_project_tpu_torch.data.datasets import GraphVQADataset
from vqa_project_tpu_torch.parallel.multihost import local_batch_rows

# the fields a host-mode step reads on the device
DENSE_KEYS = ("question", "image", "qlen", "answers", "votes", "mask")


class Batcher:
    """Iterable over fixed-shape numpy batches.

    Yields dicts with:
      question (B, T) int32 | qlen (B,) int32 | qid (B,) int64 |
      mask (B,) f32 (0 for padding rows of the final batch) |
      index (B,) int64 (row into dataset.vqa, for result emission)
    and in host mode answers (B, C) f32 | votes (B, C) f32 |
    image (B, K, F) f32, in index mode image_row (B,) int32 |
    ans_idx, vote_idx (B, S) int32 | ans_score, vote_val (B, S) f32.

    Epoch e's order is a pure function of (seed, e), shuffled by
    ``default_rng([seed, e])``: a run resumed at epoch e sees the batches
    the uninterrupted run would have seen, and every rank of a
    data-parallel run builds the same global batch.

    ``partitions`` (n_questions,) gives the rank that owns each
    question's image in a sharded feature cache
    (``parallel.ShardedFeatureCache``); every batch is then built so
    that its i-th equal slice holds only rank i's questions: each epoch
    shuffles every rank's pool and takes B / n_partitions from each, a
    short pool padded with repeats of its head under mask 0, so
    ``drop_last`` is ignored and ``len`` is the longest pool's. JAX's
    ``_iter_partitioned``, in the same order.

    ``shard=(rank, world)`` in host mode makes the dense fields (image,
    answers, votes) for rank's rows of each global batch only
    (``parallel.multihost.local_batch_rows``); the other fields and the
    batch's order stay global.
    """

    def __init__(self, dataset: GraphVQADataset, batch_size: int,
                 shuffle: bool = False, seed: int = 1000,
                 drop_last: bool = False, materialize: bool = True,
                 partitions: Optional[np.ndarray] = None,
                 n_partitions: Optional[int] = None,
                 shard: Optional[Tuple[int, int]] = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.materialize = materialize
        self.partitions = partitions
        if partitions is not None:
            # n_partitions is the world even where some ranks' images
            # back no questions (their pools stay empty)
            self.n_parts = n_partitions or int(partitions.max()) + 1
            if batch_size % self.n_parts:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by "
                    f"{self.n_parts} cache shards")
            self._pools = [np.flatnonzero(partitions == c)
                           for c in range(self.n_parts)]
        self.dense_rows = slice(None)
        if shard is not None and shard[1] > 1:
            self.dense_rows = local_batch_rows(batch_size, *shard)
        self.seed = seed
        self._epoch = 0
        self._skip_next = 0

    def set_epoch(self, epoch: int, skip: int = 0) -> None:
        """Make the next iteration epoch ``epoch + 1`` and drop its first
        ``skip`` batches (resume after a checkpoint)."""
        self._epoch = int(epoch)
        self._skip_next = int(skip)

    def __len__(self) -> int:
        n = self.ds.n_questions
        if self.partitions is not None:
            per = self.batch_size // self.n_parts
            return max(-(-len(p) // per) for p in self._pools)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._epoch += 1
        skip, self._skip_next = self._skip_next, 0  # one-shot
        if self.partitions is not None:
            yield from self._iter_partitioned(skip)
            return
        n = self.ds.n_questions
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng([self.seed, self._epoch]).shuffle(order)
        bs = self.batch_size
        stop = (n // bs) * bs if self.drop_last else n
        for start in range(skip * bs, stop, bs):
            yield self._make_batch(order[start:start + bs])

    def _iter_partitioned(self, skip: int
                          ) -> Iterator[Dict[str, np.ndarray]]:
        per = self.batch_size // self.n_parts
        pools = [p.copy() for p in self._pools]
        if self.shuffle:
            rng = np.random.default_rng([self.seed, self._epoch])
            for p in pools:
                rng.shuffle(p)
        for b in range(skip, len(self)):
            rows, valid = [], []
            for p in pools:
                seg = p[b * per:(b + 1) * per]
                nv = len(seg)
                if nv < per:  # pad with repeats of the pool head, mask 0
                    filler = (p[np.arange(per - nv) % max(len(p), 1)]
                              if len(p) else np.zeros(per - nv, np.int64))
                    seg = np.concatenate([seg, filler])
                rows.append(seg)
                valid.append(nv)
            batch = self._make_batch(np.concatenate(rows))
            mask = np.zeros((self.batch_size,), np.float32)
            for c, nv in enumerate(valid):
                mask[c * per:c * per + nv] = 1.0
            batch["mask"] = mask
            yield batch

    def _make_batch(self, rows: np.ndarray) -> Dict[str, np.ndarray]:
        ds, bs = self.ds, self.batch_size
        valid = len(rows)
        if valid < bs:  # pad the final batch to the fixed shape
            rows = np.concatenate(
                [rows, np.zeros(bs - valid, dtype=rows.dtype)])
        t = ds.table
        mask = np.zeros((bs,), dtype=np.float32)
        mask[:valid] = 1.0
        batch = {
            "question": t.tokens[rows],
            "qlen": t.qlen[rows],
            "qid": t.qid[rows],
            "mask": mask,
            "index": rows.astype(np.int64),
        }
        if self.materialize:
            mine = rows[self.dense_rows]
            answers, votes = t.dense_answers(mine)
            batch.update(answers=answers, votes=votes,
                         image=ds.store.batch(t.image_row[mine]))
        else:
            batch.update(
                image_row=t.image_row[rows],
                ans_idx=t.ans_idx[rows], ans_score=t.ans_score[rows],
                vote_idx=t.vote_idx[rows], vote_val=t.vote_val[rows])
        return batch


def pack_index_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """An index batch's device-bound fields as TWO arrays (S = answer-slot
    capacity, T = max_qlen):
      ints   (B, T+2+2S) int32:  [question | qlen | image_row | ans_idx
                                  | vote_idx]
      floats (B, 2S+1)  float32: [ans_score | vote_val | mask]
    Host-only fields (qid, index) stay on the host. The step unpacks them
    with ``train.steps.unpack_index_batch``."""
    return {
        "ints": np.concatenate([
            batch["question"].astype(np.int32),
            batch["qlen"][:, None].astype(np.int32),
            batch["image_row"][:, None].astype(np.int32),
            batch["ans_idx"].astype(np.int32),
            batch["vote_idx"].astype(np.int32),
        ], axis=1),
        "floats": np.concatenate([
            batch["ans_score"].astype(np.float32),
            batch["vote_val"].astype(np.float32),
            batch["mask"][:, None].astype(np.float32),
        ], axis=1),
    }


def _host_tensors(batch: Dict[str, np.ndarray],
                  pin: bool) -> Dict[str, torch.Tensor]:
    """The device-bound fields of a host or index batch as CPU tensors,
    in pinned memory when ``pin``."""
    arrays = (pack_index_batch(batch) if "image_row" in batch
              else {k: batch[k] for k in DENSE_KEYS})
    out = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in arrays.items()}
    return {k: v.pin_memory() for k, v in out.items()} if pin else out


def prefetch_to_device(iterator, device, depth: int = 2,
                       part: Optional[Callable] = None):
    """Yield ``(host_batch, device_batch)`` for each batch of
    ``iterator``, up to ``depth`` batches ahead; with ``part``, the
    device batch holds ``part(host_batch)`` (a data-parallel rank's rows,
    ``train.loop``) and the host batch stays the global one.

    A worker thread assembles the host batches and packs their
    device-bound fields (``pack_index_batch`` for index batches, the
    dense fields otherwise) into pinned memory. This thread issues the
    non-blocking copies on a stream of its own; the current stream waits
    for a batch's copies before the batch is yielded, and each pinned
    buffer is held until its copy has completed. On the CPU the tensors
    share the numpy batch's memory and nothing is copied.
    """
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    depth = max(1, int(depth))
    ready: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    sentinel = object()
    errors: list = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                ready.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in iterator:
                sent = batch if part is None else part(batch)
                if not put((batch, _host_tensors(sent, cuda))):
                    return
        except BaseException as e:  # raised again in the consumer
            errors.append(e)
        finally:
            put(sentinel)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    copy_stream = torch.cuda.Stream(dev) if cuda else None
    staged = collections.deque()     # (host, device tensors, copy event)
    in_flight = collections.deque()  # (copy event, pinned buffers)

    def stage(item):
        host, pinned = item
        if not cuda:
            return host, pinned, None
        with torch.cuda.stream(copy_stream):
            tensors = {k: v.to(dev, non_blocking=True)
                       for k, v in pinned.items()}
            event = torch.cuda.Event()
            event.record(copy_stream)
        in_flight.append((event, pinned))
        return host, tensors, event

    try:
        done = False
        while True:
            while not done and len(staged) < depth:
                try:
                    item = ready.get(block=not staged)
                except queue.Empty:
                    break
                if item is sentinel:
                    done = True
                else:
                    staged.append(stage(item))
            if not staged:
                break
            host, tensors, event = staged.popleft()
            if event is not None:
                current = torch.cuda.current_stream(dev)
                current.wait_event(event)
                for t in tensors.values():
                    t.record_stream(current)
            while in_flight and in_flight[0][0].query():
                in_flight.popleft()
            yield host, tensors
        if errors:
            raise errors[0]
    finally:
        stop.set()
        for event, _ in in_flight:
            event.synchronize()
        in_flight.clear()
        thread.join(timeout=10)
