"""Procedural digit / fashion datasets (MNIST / F-MNIST stand-ins).

Offline-deterministic replacements with matched shapes (28x28x1, 10
classes).  Digits are stroke polylines rendered as distance fields; the
fashion set uses per-class silhouette primitives.  Per-sample augmentation
(rotation, translation, scale, noise) is seeded, so the prune->finetune->
eval pipeline is end-to-end reproducible.  Error rates on these sets are
compared *relatively* (LAKP vs KP at matched sparsity), mirroring the
paper's claim structure (DESIGN.md §7.6).

The port's own copy of ``repro.data.synthetic_digits`` (numpy only): the
same seed gives bit-identical arrays and the same batch order in both
packages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np

HW = 28

# Stroke polylines per digit class in a unit box [0,1]^2 (x, y), y down.
_DIGIT_STROKES: Dict[int, List[List[Tuple[float, float]]]] = {
    0: [[(0.3, 0.2), (0.7, 0.2), (0.8, 0.5), (0.7, 0.8), (0.3, 0.8),
         (0.2, 0.5), (0.3, 0.2)]],
    1: [[(0.5, 0.15), (0.5, 0.85)], [(0.35, 0.3), (0.5, 0.15)]],
    2: [[(0.25, 0.3), (0.5, 0.15), (0.75, 0.3), (0.3, 0.8), (0.75, 0.8)]],
    3: [[(0.25, 0.2), (0.7, 0.25), (0.45, 0.5), (0.7, 0.7), (0.25, 0.82)]],
    4: [[(0.65, 0.85), (0.65, 0.15), (0.25, 0.6), (0.8, 0.6)]],
    5: [[(0.75, 0.15), (0.3, 0.15), (0.28, 0.45), (0.65, 0.45),
         (0.72, 0.68), (0.3, 0.82)]],
    6: [[(0.65, 0.15), (0.35, 0.45), (0.3, 0.7), (0.55, 0.82),
         (0.7, 0.62), (0.35, 0.55)]],
    7: [[(0.25, 0.18), (0.75, 0.18), (0.45, 0.85)]],
    8: [[(0.5, 0.15), (0.7, 0.3), (0.3, 0.6), (0.5, 0.82), (0.7, 0.6),
         (0.3, 0.3), (0.5, 0.15)]],
    9: [[(0.7, 0.4), (0.45, 0.5), (0.35, 0.3), (0.6, 0.18), (0.7, 0.4),
         (0.6, 0.85)]],
}

# Fashion-ish silhhouettes: each class = list of (kind, params) primitives;
# kind: "rect" (x0,y0,x1,y1) or "line" polyline.
_FASHION_PRIMS: Dict[int, List] = {
    0: [("rect", (0.3, 0.25, 0.7, 0.8))],                       # tshirt body
    1: [("rect", (0.38, 0.2, 0.62, 0.85))],                     # trouser
    2: [("rect", (0.28, 0.25, 0.72, 0.75)),
        ("line", [(0.28, 0.3), (0.15, 0.55)]),
        ("line", [(0.72, 0.3), (0.85, 0.55)])],                 # pullover
    3: [("rect", (0.35, 0.2, 0.65, 0.55)),
        ("rect", (0.3, 0.55, 0.7, 0.85))],                      # dress
    4: [("rect", (0.27, 0.25, 0.73, 0.8)),
        ("line", [(0.5, 0.25), (0.5, 0.8)])],                   # coat
    5: [("line", [(0.3, 0.6), (0.7, 0.55), (0.75, 0.7), (0.3, 0.75),
                  (0.3, 0.6)])],                                # sandal
    6: [("rect", (0.32, 0.22, 0.68, 0.78)),
        ("line", [(0.32, 0.22), (0.68, 0.78)])],                # shirt
    7: [("line", [(0.25, 0.65), (0.6, 0.6), (0.78, 0.68), (0.75, 0.78),
                  (0.25, 0.78), (0.25, 0.65)])],                # sneaker
    8: [("rect", (0.3, 0.35, 0.7, 0.75)),
        ("line", [(0.35, 0.35), (0.4, 0.2), (0.6, 0.2), (0.65, 0.35)])],
    9: [("line", [(0.3, 0.25), (0.35, 0.7), (0.5, 0.8), (0.75, 0.75),
                  (0.72, 0.6), (0.45, 0.6), (0.42, 0.25), (0.3, 0.25)])],
}


def _dist_to_segment(px, py, ax, ay, bx, by):
    vx, vy = bx - ax, by - ay
    wx, wy = px - ax, py - ay
    denom = max(vx * vx + vy * vy, 1e-9)
    t = np.clip((wx * vx + wy * vy) / denom, 0.0, 1.0)
    dx, dy = wx - t * vx, wy - t * vy
    return np.sqrt(dx * dx + dy * dy)


def _render(prims, angle: float, dx: float, dy: float, scale: float,
            sigma: float) -> np.ndarray:
    ys, xs = np.mgrid[0:HW, 0:HW]
    px = xs / (HW - 1.0)
    py = ys / (HW - 1.0)
    # inverse-transform pixel coords into the canonical frame
    cx = px - 0.5 - dx
    cy = py - 0.5 - dy
    ca, sa = np.cos(-angle), np.sin(-angle)
    rx = (ca * cx - sa * cy) / scale + 0.5
    ry = (sa * cx + ca * cy) / scale + 0.5
    dist = np.full((HW, HW), 1e9)
    for prim in prims:
        if prim[0] == "rect":
            x0, y0, x1, y1 = prim[1]
            segs = [((x0, y0), (x1, y0)), ((x1, y0), (x1, y1)),
                    ((x1, y1), (x0, y1)), ((x0, y1), (x0, y0))]
            for (a, b) in segs:
                dist = np.minimum(dist, _dist_to_segment(
                    rx, ry, a[0], a[1], b[0], b[1]))
        else:
            pts = prim[1]
            for a, b in zip(pts[:-1], pts[1:]):
                dist = np.minimum(dist, _dist_to_segment(
                    rx, ry, a[0], a[1], b[0], b[1]))
    return np.exp(-0.5 * (dist / sigma) ** 2).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class DigitsConfig:
    variant: str = "digits"       # digits | fashion
    n_train: int = 2048
    n_test: int = 512
    seed: int = 0
    noise: float = 0.05
    sigma: float = 0.05


def _make_split(cfg: DigitsConfig, n: int, seed: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n)
    images = np.zeros((n, HW, HW, 1), np.float32)
    for i in range(n):
        cls = int(labels[i])
        if cfg.variant == "digits":
            prims = [("line", s) for s in _DIGIT_STROKES[cls]]
        else:
            prims = _FASHION_PRIMS[cls]
        angle = rng.uniform(-0.25, 0.25)
        dx, dy = rng.uniform(-0.08, 0.08, size=2)
        scale = rng.uniform(0.85, 1.15)
        img = _render(prims, angle, dx, dy, scale, cfg.sigma)
        img += rng.randn(HW, HW).astype(np.float32) * cfg.noise
        images[i, :, :, 0] = np.clip(img, 0.0, 1.0)
    return images, labels.astype(np.int32)


def load(cfg: DigitsConfig):
    """Returns dict with train/test images (N,28,28,1) in [0,1] and labels."""
    tr_x, tr_y = _make_split(cfg, cfg.n_train, cfg.seed)
    te_x, te_y = _make_split(cfg, cfg.n_test, cfg.seed + 10_000)
    return {"train": (tr_x, tr_y), "test": (te_x, te_y)}


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, seed: int,
            epochs: int = 1) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.RandomState(seed)
    n = x.shape[0]
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            yield x[idx], y[idx]
