"""Inputs of a cell, made from its seed: the region-feature table, the
question table and the vocabularies.

Everything here is the benchmark's input, handed alike to the program
and to the plain reference. Tables that live on the card are drawn there
with a ``torch.Generator`` on the card, in a few large calls; question
tables are drawn on the host with numpy. The sizes of the work (question
lengths, arrival gaps) come from fixed multisets that the seed only
permutes, so every seed runs the same amount of work in another order.
"""

from __future__ import annotations

import types
from typing import Dict

import numpy as np
import torch

def rng(seed: int, stream: str) -> np.random.Generator:
    """The numpy generator of the named stream of a run's seed (a whole
    number of any size): the streams are independent."""
    tag = [ord(c) for c in stream]
    return np.random.default_rng(np.random.SeedSequence([int(seed)] + tag))


def torch_seed(seed: int, stream: str) -> int:
    return int(rng(seed, stream).integers(0, 2 ** 62))


def feature_table(n_images: int, n_obj: int, n_feat: int, seed: int,
                  device, dtype=torch.bfloat16):
    """(features (N, K, n_feat) in ``dtype``, boxes (N, K, 4) float32 xyxy
    normalized to the image) on ``device``. Features are uniform in
    [0, 1) (non-negative, as pooled detector features are); box corners
    as the synthetic VQA data draws them: top-left in [0, 0.5), size in
    [0.05, 0.5)."""
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, "feat"))
    feats = torch.rand((n_images, n_obj, n_feat), generator=g,
                       device=device, dtype=dtype)
    corner = torch.rand((n_images, n_obj, 4), generator=g, device=device)
    xy1 = corner[..., :2] * 0.5
    wh = 0.05 + corner[..., 2:] * 0.4
    boxes = torch.cat([xy1, xy1 + wh], dim=-1).contiguous()
    return feats, boxes


def qlen_multiset(n: int, pmf: Dict[str, float], max_qlen: int) -> np.ndarray:
    """n question lengths in the proportions of ``pmf`` (length -> share),
    as a sorted array: the same multiset for every seed."""
    lens = np.array(sorted(int(k) for k in pmf), dtype=np.int64)
    share = np.array([pmf[str(k)] for k in lens], dtype=np.float64)
    share = share / share.sum()
    counts = np.floor(share * n).astype(np.int64)
    counts[np.argmax(share)] += n - counts.sum()
    out = np.repeat(lens, counts)
    return np.minimum(out, max_qlen).astype(np.int32)


def question_table(n_questions: int, n_images: int, vocab_size: int,
                   n_answers: int, max_qlen: int, qlen_pmf: Dict[str, float],
                   seed: int, slots: int = 16):
    """The per-question arrays the program's loader reads (token ids,
    lengths, image rows and sparse answer and vote entries), drawn from
    ``seed``. Answers follow VQA v2's shape: 10 votes spread over 1-4
    distinct answers, the popular answers far more often (Zipf), soft
    score min(1, 0.3 votes); no question lists an answer twice.
    ``n_answers`` counts the answer words (the model has one more output,
    the pad slot, which no entry names)."""
    r = rng(seed, "questions")
    qlen = qlen_multiset(n_questions, qlen_pmf, max_qlen)
    r.shuffle(qlen)
    pos = np.arange(max_qlen)[None, :]
    tokens = r.integers(1, vocab_size, size=(n_questions, max_qlen),
                        dtype=np.int32)
    tokens[pos >= qlen[:, None]] = 0
    image_row = r.integers(0, n_images, size=n_questions, dtype=np.int32)
    pad = n_answers                       # the model's last output
    n_distinct = r.choice(4, size=n_questions, p=[0.45, 0.3, 0.15, 0.1]) + 1
    base = np.minimum(r.zipf(1.4, size=n_questions) - 1, n_answers - 1)
    steps = r.integers(1, max(2, (n_answers - 1) // 4),
                       size=(n_questions, 4))
    steps[:, 0] = 0
    ids = (base[:, None] + np.cumsum(steps, axis=1)) % n_answers
    # 10 votes split over the live answers
    cut = np.sort(r.integers(1, 10, size=(n_questions, 3)), axis=1)
    edges = np.concatenate([np.zeros((n_questions, 1), np.int64), cut,
                            np.full((n_questions, 1), 10)], axis=1)
    votes = np.diff(edges, axis=1)[:, ::-1].astype(np.float32)
    live = np.arange(4)[None, :] < n_distinct[:, None]
    votes = np.where(live, votes, 0.0)
    # the votes of the dropped answers go to the first
    votes[:, 0] += 10.0 - votes.sum(axis=1)
    ans_idx = np.full((n_questions, slots), pad, np.int32)
    ans_score = np.zeros((n_questions, slots), np.float32)
    ans_idx[:, :4] = np.where(live, ids, pad)
    ans_score[:, :4] = np.where(live, np.minimum(1.0, 0.3 * votes), 0.0)
    return types.SimpleNamespace(
        n_questions=n_questions, n_answers=n_answers + 1,
        max_qlen=max_qlen, tokens=tokens, qlen=qlen,
        qid=np.arange(n_questions, dtype=np.int64) + 1_000_000,
        image_row=image_row, ans_idx=ans_idx, ans_score=ans_score,
        vote_idx=ans_idx.copy(), vote_val=np.where(
            ans_idx != pad, np.pad(votes, ((0, 0), (0, slots - 4))),
            0.0).astype(np.float32))


def shuffled_rows(n: int, seed: int, epoch: int) -> np.ndarray:
    """The question order of a shuffled epoch, by the loader's stated
    rule: a permutation of range(n) by ``default_rng([seed, epoch])``."""
    order = np.arange(n)
    np.random.default_rng([int(seed), int(epoch)]).shuffle(order)
    return order


def vocabularies(vocab_size: int, n_answers: int):
    """(q_itow, q_wtoi, a_itow, a_wtoi): question word i is "w<i>" for
    i in 1..vocab_size-1 (0 is the pad id), answer j is "a<j>"."""
    q_itow = {i: f"w{i}" for i in range(1, vocab_size)}
    a_itow = {j: f"a{j}" for j in range(n_answers)}
    return (q_itow, {w: i for i, w in q_itow.items()},
            a_itow, {w: j for j, w in a_itow.items()})


def dataset(table, n_images: int, n_obj: int, feat_dim: int, vocab_size: int,
            emb_dim: int):
    """The program's ``GraphVQADataset`` over ``table`` (``feat_dim``
    the model's node width: features and a box). The store holds shapes
    only (the device table serves the rows): a zero-stride array that
    takes no memory."""
    from vqa_project_tpu_torch.data.datasets import GraphVQADataset
    from vqa_project_tpu_torch.data.store import FeatureStore
    features = np.broadcast_to(np.zeros((1, 1, 1), np.float32),
                               (n_images, n_obj, feat_dim - 4))
    boxes = np.broadcast_to(np.zeros((1, 1, 1), np.float32),
                            (n_images, n_obj, 4))
    store = FeatureStore(features, boxes,
                         {str(100 + i): i for i in range(n_images)})
    q_itow, q_wtoi, a_itow, a_wtoi = vocabularies(vocab_size,
                                                  table.n_answers - 1)
    return GraphVQADataset(store, table, q_itow, q_wtoi, a_itow, a_wtoi,
                           np.zeros((1, emb_dim), np.float32), [])
