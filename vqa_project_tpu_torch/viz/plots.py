"""Interpretability plots of the learned graph structure.

Counterpart of ``vqa_project_tpu/viz/plots.py`` (the reference's
plot.py and plot_mpl.py): the top-N nodes by adjacency mass drawn as
boxes with linewidth and alpha proportional to node weight, and the
edges between their centres with linewidth and alpha proportional to
A[i, j] / max, over the raw image or a blank canvas; the predictions
CSV and the adjacency npz.

Each of the two entry points is split in two so that the device work
never needs the plotting stack:

- ``visualize_checkpoint`` = ``collect_graphs`` (the model over
  ``n_batches`` batches on its device, then ``infer_predictions.csv``,
  ``adjacencies.npz`` and ``summary.json``) + ``render_graphs`` (one
  ``adj_{question_id}.jpg`` per row, on the host);
- ``plot_given_question`` = ``given_question_graph`` (one forward at
  B = 1 from the host store) + ``plot_adjacency_graph``.

matplotlib is imported by the functions that draw or read images, with
the Agg backend, never when this module is imported.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


def _pyplot():
    """matplotlib.pyplot on the Agg backend (no display needed)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def make_segments(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Line -> segment array for LineCollection (plot_mpl.py helper)."""
    points = np.array([x, y]).T.reshape(-1, 1, 2)
    return np.concatenate([points[:-1], points[1:]], axis=1)


def colorline(ax, x, y, z=None, cmap="copper", linewidth=3, alpha=1.0):
    """Gradient-coloured line (plot_mpl.py colorline equivalent)."""
    plt = _pyplot()
    import matplotlib.collections as mcoll

    x, y = np.asarray(x), np.asarray(y)
    if z is None:
        z = np.linspace(0.0, 1.0, len(x))
    z = np.asarray(z, dtype=float)
    segs = make_segments(x, y)
    lc = mcoll.LineCollection(segs, array=z, cmap=plt.get_cmap(cmap),
                              linewidth=linewidth, alpha=alpha)
    ax.add_collection(lc)
    return lc


def node_weights_from_adjacency(adjacency: np.ndarray) -> np.ndarray:
    """Per-node importance = row-sum of the learned adjacency
    (plot.py sort_boxes: nodes ranked by adjacency mass)."""
    return np.asarray(adjacency).sum(axis=-1)


def plot_adjacency_graph(
    boxes: np.ndarray,
    adjacency: np.ndarray,
    *,
    image: Optional[np.ndarray] = None,
    image_size: Tuple[int, int] = (640, 480),
    top_nodes: int = 7,
    question: str = "",
    prediction: str = "",
    answer: str = "",
    path: Optional[str] = None,
    cmap: str = "viridis",
):
    """Render top-N boxes + pairwise adjacency edges.

    Args:
      boxes: (K, 4) normalized xyxy boxes.
      adjacency: (K, K) learned adjacency for this sample.
      image: optional HxWx3 uint8 background.
      image_size: (W, H) canvas when image is None.
    Returns the matplotlib figure (saved+closed if path given).
    """
    plt = _pyplot()
    boxes = np.asarray(boxes, dtype=np.float64)
    adjacency = np.asarray(adjacency, dtype=np.float64)
    k = boxes.shape[0]
    w, h = image_size if image is None else (image.shape[1], image.shape[0])

    fig, ax = plt.subplots(figsize=(8, 6))
    if image is not None:
        ax.imshow(image)
    else:
        ax.set_xlim(0, w)
        ax.set_ylim(h, 0)  # image coordinates
        ax.set_facecolor("#202020")

    weights = node_weights_from_adjacency(adjacency)
    # the JAX renderer's order, ties included (argsort is not stable)
    order = np.argsort(weights)[::-1][: min(top_nodes, k)]
    wmax = max(weights[order].max(), 1e-12)
    amax = max(np.abs(adjacency).max(), 1e-12)
    colors = plt.get_cmap(cmap)(np.linspace(0.2, 0.95, len(order)))

    px = boxes.copy()
    px[:, [0, 2]] *= w
    px[:, [1, 3]] *= h
    centres = np.stack([(px[:, 0] + px[:, 2]) / 2,
                        (px[:, 1] + px[:, 3]) / 2], axis=1)

    # boxes: linewidth/alpha proportional to node weight (plot.py:552-560)
    for rank, i in enumerate(order):
        rel = max(weights[i] / wmax, 0.0)
        rect = plt.Rectangle(
            (px[i, 0], px[i, 1]), px[i, 2] - px[i, 0], px[i, 3] - px[i, 1],
            fill=False, edgecolor=colors[rank],
            linewidth=0.5 + 2.5 * rel, alpha=0.35 + 0.65 * rel)
        ax.add_patch(rect)

    # pairwise edges between the selected nodes (plot.py:566-585)
    for a_i, i in enumerate(order):
        for j in order[a_i + 1:]:
            rel = abs(adjacency[i, j]) / amax
            if rel <= 1e-6:
                continue
            ax.plot([centres[i, 0], centres[j, 0]],
                    [centres[i, 1], centres[j, 1]],
                    color="orange", linewidth=0.5 + 3.0 * rel,
                    alpha=min(1.0, 0.15 + 0.85 * rel))

    caption = question
    if prediction or answer:
        caption += f"\npred: {prediction}   answer: {answer}"
    if caption:
        ax.set_title(caption, fontsize=10)
    ax.set_xticks([])
    ax.set_yticks([])
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


def save_predictions_csv(rows: Sequence[Dict[str, str]], path: str):
    """image_id,question,prediction,answer CSV
    (plot.py:282-286 / run_imageclef.py:235-239 schema)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        wr = csv.DictWriter(
            f, fieldnames=["image_id", "question", "prediction", "answer"])
        wr.writeheader()
        for r in rows:
            wr.writerow(r)


def read_adj(path: str) -> Dict[str, np.ndarray]:
    """Inspect a saved adjacency npz (plot_mpl.py read_adj)."""
    with np.load(path, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


def resolve_image_path(image_dir: Optional[str], image_id,
                       tasks: Sequence[str] = ("val2014", "train2014",
                                               "test2015")) -> Optional[str]:
    """Locate the raw image file for a dataset image_id.

    COCO ids resolve to COCO_{task}_{id:012d}.jpg (plot.py:448-453,
    337), medical ids are already '<name>.jpg' keys
    (torch_dataset.py:269). Returns None when nothing matches (the
    caller then draws on the blank canvas).
    """
    if not image_dir:
        return None
    sid = str(image_id)
    candidates = [sid, sid + ".jpg", sid + ".png"]
    try:
        iid = int(image_id)
        candidates += [f"COCO_{t}_{iid:012d}.jpg" for t in tasks]
    except (TypeError, ValueError):
        pass
    for name in candidates:
        p = os.path.join(image_dir, name)
        if os.path.isfile(p):
            return p
    return None


def load_image(path: Optional[str]) -> Optional[np.ndarray]:
    """Read an image file to an RGB array (None-propagating)."""
    if path is None:
        return None
    return _pyplot().imread(path)


def find_question(vqa_rows: List[dict], question: str,
                  image_id: Optional[str] = None) -> Optional[int]:
    """Row index of a (question, image_id) pair (plot_mpl find_question /
    plot.py get_iid_from_question)."""
    q = question.strip().lower().rstrip("?")
    for i, row in enumerate(vqa_rows):
        if row["question"].strip().lower().rstrip("?") == q:
            if image_id is None or str(row["image_id"]) == str(image_id):
                return i
    return None


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


class QuestionGraph(NamedTuple):
    """One question's learned graph: its dataset row, the image's
    normalized xyxy boxes (K, 4), the adjacency (K, K) f32 and the
    predicted answer."""
    index: int
    boxes: np.ndarray
    adjacency: np.ndarray
    prediction: str


def given_question_graph(model, ds, question: str,
                         image_id: Optional[str] = None) -> QuestionGraph:
    """The device half of ``plot_given_question``: look the question up
    (KeyError when absent) and run one forward at B = 1 on the model's
    device from the host store's feature||bbox rows, as the JAX
    function does (no feature cache); the answer vocabulary's pad
    column (the last logit) is excluded before the argmax."""
    idx = find_question(ds.vqa, question, image_id)
    if idx is None:
        raise KeyError(f"question not found: {question!r}")
    dev = _model_device(model)
    t = ds.table
    rows = t.image_row[idx:idx + 1]
    q = torch.from_numpy(t.tokens[idx:idx + 1]).to(dev)
    image = torch.from_numpy(ds.store.batch(rows)).to(dev)
    qlen = torch.from_numpy(t.qlen[idx:idx + 1]).to(dev)
    logits, adjacency, _ = model(q, image, qlen)
    pred = ds.a_itow[int(torch.argmax(logits[0][:-1]))]
    return QuestionGraph(idx, np.asarray(ds.store.boxes[rows[0]]),
                         adjacency[0].float().cpu().numpy(), pred)


def plot_given_question(model, ds, question: str,
                        image_id: Optional[str] = None,
                        path: Optional[str] = None, top_nodes: int = 7,
                        image_dir: Optional[str] = None):
    """Render the learned graph for one (question, image_id) pair — the
    plot_given_fig capability (plot.py:406-453). With image_dir the
    boxes and edges are drawn over the raw photograph (plot.py:448-453).
    Returns the figure (saved and closed when ``path`` is given)."""
    g = given_question_graph(model, ds, question, image_id)
    row = ds.vqa[g.index]
    raster = load_image(resolve_image_path(image_dir, row["image_id"]))
    return plot_adjacency_graph(
        g.boxes, g.adjacency, top_nodes=top_nodes, image=raster,
        question=row["question"], prediction=g.prediction,
        answer=row.get("answer", ""), path=path)


class Graphs(NamedTuple):
    """A sweep's learned graphs, in dataset-row order: the accuracy over
    the batches evaluated, the CSV rows (image_id, question, prediction,
    answer), the dataset rows and their adjacencies (N, K, K) f32."""
    accuracy: float
    rows: List[Dict[str, str]]
    index: np.ndarray
    adjacency: np.ndarray


def collect_graphs(model, ds, out_dir: str, *, batch_size: int = 32,
                   n_batches: int = 4, save_npz: bool = True) -> Graphs:
    """The device half of ``visualize_checkpoint``: ``evaluate`` over
    the first ``n_batches`` batches on the model's device with the
    adjacencies collected (the reference also stops after the batches
    it plots, plot.py:230), then ``infer_predictions.csv``,
    ``adjacencies.npz`` (``adjacency`` (N, K, K), ``index``) and
    ``summary.json`` (the accuracy over those batches, the figures
    ``render_graphs`` draws from them, the batches) in ``out_dir``:
    JAX's files, keys and row order."""
    from vqa_project_tpu_torch.train.loop import evaluate

    os.makedirs(out_dir, exist_ok=True)
    acc, result, adjacencies = evaluate(
        model, ds, batch_size, result_path=None, collect_adjacency=True,
        max_batches=n_batches, device=_model_device(model))

    pred_by_qid = {r["question_id"]: r["answer"] for r in result}
    limit = min(n_batches * batch_size, ds.n_questions)
    indices = sorted(adjacencies)[:limit]
    rows = []
    for i in indices:
        row = ds.vqa[i]
        rows.append({
            "image_id": row["image_id"],
            "question": row["question"],
            "prediction": pred_by_qid.get(int(row["question_id"]), ""),
            "answer": row.get("answer", ""),
        })
    adjacency = np.stack([adjacencies[i] for i in indices])
    index = np.asarray(indices)

    save_predictions_csv(rows, os.path.join(out_dir, "infer_predictions.csv"))
    if save_npz:
        np.savez_compressed(os.path.join(out_dir, "adjacencies.npz"),
                            adjacency=adjacency, index=index)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump({"accuracy": acc, "figures": len(rows),
                   "eval_batches": n_batches}, f)
    return Graphs(acc, rows, index, adjacency)


def render_graphs(ds, graphs: Graphs, out_dir: str, *, top_nodes: int = 7,
                  image_dir: Optional[str] = None) -> int:
    """The host half of ``visualize_checkpoint``: one
    ``adj_{question_id}.jpg`` per row of ``graphs`` in ``out_dir``, over
    the raw image where ``image_dir`` holds it. Returns the count."""
    os.makedirs(out_dir, exist_ok=True)
    for i, row, adj in zip(graphs.index, graphs.rows, graphs.adjacency):
        vqa = ds.vqa[i]
        raster = load_image(resolve_image_path(image_dir, vqa["image_id"]))
        plot_adjacency_graph(
            np.asarray(ds.store.boxes[ds.table.image_row[i]]), adj,
            top_nodes=top_nodes, image=raster, question=row["question"],
            prediction=row["prediction"], answer=row["answer"],
            path=os.path.join(out_dir, f"adj_{vqa['question_id']}.jpg"))
    return len(graphs.rows)


def visualize_checkpoint(model, ds, out_dir: str, *, batch_size: int = 32,
                         n_batches: int = 4, top_nodes: int = 7,
                         save_npz: bool = True,
                         image_dir: Optional[str] = None) -> str:
    """Run inference, render per-sample adjacency figures and write the
    predictions CSV (the reference plot.py's save_plot_nodes / plot_by_mpl):
    ``collect_graphs`` then ``render_graphs``. Returns ``out_dir``."""
    graphs = collect_graphs(model, ds, out_dir, batch_size=batch_size,
                            n_batches=n_batches, save_npz=save_npz)
    render_graphs(ds, graphs, out_dir, top_nodes=top_nodes,
                  image_dir=image_dir)
    return out_dir
