"""cv2-based graph renderer (the reference's first visualizer).

Counterpart of ``vqa_project_tpu/viz/cv2_plots.py`` (the reference's
plot_boxes / plot_one_box / plot_connect_lines, plot.py:37-170): boxes
ranked by adjacency mass, the strongest edges colour-graded by weight,
JPEG output. cv2 is imported by the functions that draw, so the module
imports without it.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from vqa_project_tpu_torch.viz.plots import node_weights_from_adjacency


def plot_one_box(img: np.ndarray, box_xyxy: Sequence[float],
                 color: Tuple[int, int, int], label: Optional[str] = None,
                 thickness: int = 2) -> None:
    """Draw one labelled box in place (plot.py plot_one_box)."""
    import cv2

    p1 = (int(box_xyxy[0]), int(box_xyxy[1]))
    p2 = (int(box_xyxy[2]), int(box_xyxy[3]))
    cv2.rectangle(img, p1, p2, color, thickness, lineType=cv2.LINE_AA)
    if label:
        tf = max(thickness - 1, 1)
        ts = cv2.getTextSize(label, 0, fontScale=thickness / 3,
                             thickness=tf)[0]
        p2t = (p1[0] + ts[0], p1[1] - ts[1] - 3)
        cv2.rectangle(img, p1, p2t, color, -1, cv2.LINE_AA)
        cv2.putText(img, label, (p1[0], p1[1] - 2), 0, thickness / 3,
                    (255, 255, 255), thickness=tf, lineType=cv2.LINE_AA)


def plot_connect_lines(img: np.ndarray, boxes_px: np.ndarray,
                       adjacency: np.ndarray, top_edges: int = 60) -> None:
    """Draw the strongest edges between box centres, colour graded by
    weight (plot.py plot_connect_lines/plot_connect_lines2)."""
    import cv2

    k = boxes_px.shape[0]
    centres = np.stack([(boxes_px[:, 0] + boxes_px[:, 2]) / 2,
                        (boxes_px[:, 1] + boxes_px[:, 3]) / 2], axis=1)
    iu = np.triu_indices(k, 1)
    weights = np.abs(adjacency[iu])
    order = np.argsort(weights)[::-1][:top_edges]
    wmax = max(weights[order[0]] if len(order) else 1.0, 1e-12)
    for e in order:
        i, j = iu[0][e], iu[1][e]
        rel = float(weights[e] / wmax)
        # green (weak) -> red (strong) gradient
        color = (0, int(255 * (1 - rel)), int(255 * rel))
        cv2.line(img, tuple(centres[i].astype(int)),
                 tuple(centres[j].astype(int)), color,
                 max(1, int(1 + 2 * rel)), lineType=cv2.LINE_AA)


def plot_boxes(boxes_norm: np.ndarray, adjacency: np.ndarray,
               image: Optional[np.ndarray] = None,
               image_size: Tuple[int, int] = (640, 480),
               top_nodes: int = 7, top_edges: int = 60,
               caption: str = "", path: Optional[str] = None) -> np.ndarray:
    """Render boxes (ranked by adjacency mass) + edges on the image or a
    dark canvas; returns the BGR array (written as JPEG if path given)."""
    import cv2

    if image is None:
        w, h = image_size
        img = np.full((h, w, 3), 32, np.uint8)
    else:
        img = image.copy()
        h, w = img.shape[:2]

    px = boxes_norm.copy().astype(np.float64)
    px[:, [0, 2]] *= w
    px[:, [1, 3]] *= h

    weights = node_weights_from_adjacency(adjacency)
    order = np.argsort(weights)[::-1][:top_nodes]
    plot_connect_lines(img, px[order], adjacency[np.ix_(order, order)],
                       top_edges)
    wmax = max(float(weights[order[0]]) if len(order) else 1.0, 1e-12)
    for rank, i in enumerate(order):
        rel = float(weights[i] / wmax)
        color = (int(255 * (1 - rel)), 128, int(255 * rel))
        plot_one_box(img, px[i], color, label=str(rank),
                     thickness=max(1, int(1 + 2 * rel)))
    if caption:
        cv2.putText(img, caption[:80], (8, h - 10), 0, 0.5,
                    (255, 255, 255), 1, cv2.LINE_AA)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        cv2.imwrite(path, img)
    return img
