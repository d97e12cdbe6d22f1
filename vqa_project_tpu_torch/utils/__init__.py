"""Small host-side utilities (numpy only).

Copy of ``vqa_project_tpu/utils/__init__.py``'s box converters and
string cleaning (the reference's utils.py:58-80). JAX's
``enable_compilation_cache`` has no counterpart: ``ops/_build.py``'s
per-hash build directory caches the port's compiled kernels.
"""

from __future__ import annotations

import re

import numpy as np


def xyxy2xywh(x: np.ndarray) -> np.ndarray:
    """[x1,y1,x2,y2] -> [cx,cy,w,h] (utils.py:58-65)."""
    y = np.copy(x)
    y[:, 0] = (x[:, 0] + x[:, 2]) / 2
    y[:, 1] = (x[:, 1] + x[:, 3]) / 2
    y[:, 2] = x[:, 2] - x[:, 0]
    y[:, 3] = x[:, 3] - x[:, 1]
    return y


def xywh2xyxy(x: np.ndarray) -> np.ndarray:
    """[cx,cy,w,h] -> [x1,y1,x2,y2] (utils.py:68-75)."""
    y = np.copy(x)
    y[:, 0] = x[:, 0] - x[:, 2] / 2
    y[:, 1] = x[:, 1] - x[:, 3] / 2
    y[:, 2] = x[:, 0] + x[:, 2] / 2
    y[:, 3] = x[:, 1] + x[:, 3] / 2
    return y


def clean_str(s: str) -> str:
    """Replace special characters with underscores (utils.py:78-80)."""
    return re.sub(pattern="[|@#!¡·$€%&()=?¿^*;:,¨´><+]", repl="_", string=s)
