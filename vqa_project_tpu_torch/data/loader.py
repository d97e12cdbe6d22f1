"""Fixed-shape host batches.

Copy of the host mode of ``vqa_project_tpu/data/loader.py::Batcher``:
each batch is a handful of vectorized numpy gathers from the dataset's
tables, with dense images, answers and votes; the final partial batch is
padded to the fixed shape with rows whose mask is 0.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from vqa_project_tpu_torch.data.datasets import GraphVQADataset


class Batcher:
    """Iterable over fixed-shape numpy batches.

    Yields dicts with:
      question (B, T) int32 | answers (B, C) f32 | votes (B, C) f32 |
      image (B, K, F) f32 | qlen (B,) int32 | qid (B,) int64 |
      mask (B,) f32 (0 for padding rows of the final batch) |
      index (B,) int64 (row into dataset.vqa, for result emission)

    Epoch e's order is a pure function of (seed, e), shuffled by
    ``default_rng([seed, e])``: a run resumed at epoch e sees the batches
    the uninterrupted run would have seen.
    """

    def __init__(self, dataset: GraphVQADataset, batch_size: int,
                 shuffle: bool = False, seed: int = 1000,
                 drop_last: bool = False):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
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
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._epoch += 1
        skip, self._skip_next = self._skip_next, 0  # one-shot
        n = self.ds.n_questions
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng([self.seed, self._epoch]).shuffle(order)
        bs = self.batch_size
        stop = (n // bs) * bs if self.drop_last else n
        for start in range(skip * bs, stop, bs):
            yield self._make_batch(order[start:start + bs])

    def _make_batch(self, rows: np.ndarray) -> Dict[str, np.ndarray]:
        ds, bs = self.ds, self.batch_size
        valid = len(rows)
        if valid < bs:  # pad the final batch to the fixed shape
            rows = np.concatenate(
                [rows, np.zeros(bs - valid, dtype=rows.dtype)])
        t = ds.table
        mask = np.zeros((bs,), dtype=np.float32)
        mask[:valid] = 1.0
        answers, votes = t.dense_answers(rows)
        return {
            "question": t.tokens[rows],
            "qlen": t.qlen[rows],
            "qid": t.qid[rows],
            "mask": mask,
            "index": rows.astype(np.int64),
            "answers": answers,
            "votes": votes,
            "image": ds.store.batch(t.image_row[rows]),
        }
