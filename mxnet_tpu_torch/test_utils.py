"""Test and benchmark data of the port: the port's own copy of
``get_shapes_detection`` from ``mxnet_tpu/test_utils.py`` (the port never
imports the JAX package). For the same arguments it makes the same arrays,
drawing in the same order from ``numpy.random.RandomState(seed)``."""
from __future__ import annotations

import numpy as np

__all__ = ["get_shapes_detection"]


def get_shapes_detection(num_images, size=96, max_objects=3, num_classes=3,
                         seed=0, min_frac=4):
    """Synthetic detection data: solid shapes on a noise background, told
    apart by geometry alone (0 = filled square, 1 = disc, 2 = cross; the
    color is random). Returns

        images : (N, 3, size, size) float32 in [0, 1]
        labels : (N, max_objects, 5) float32 rows [cls, x1, y1, x2, y2]
                 (corners normalized to [0, 1]; -1 rows are padding)

    Placements are rejection-sampled so that boxes barely overlap (IoU <=
    0.2): every labelled object stays visible and a perfect detector
    reaches mAP ~1.0."""
    rng = np.random.RandomState(seed)
    imgs = np.empty((num_images, 3, size, size), np.float32)
    labels = -np.ones((num_images, max_objects, 5), np.float32)

    def _iou(a, b):
        ix = max(0, min(a[2], b[2]) - max(a[0], b[0]))
        iy = max(0, min(a[3], b[3]) - max(a[1], b[1]))
        inter = ix * iy
        ua = ((a[2] - a[0]) * (a[3] - a[1])
              + (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / max(ua, 1)

    for i in range(num_images):
        img = rng.uniform(0.0, 0.25, (3, size, size)).astype(np.float32)
        placed = []
        j = 0
        for _ in range(rng.randint(1, max_objects + 1)):
            cls = rng.randint(num_classes)
            for _try in range(20):
                s = rng.randint(size // min_frac, size // 2)
                x1 = rng.randint(0, size - s)
                y1 = rng.randint(0, size - s)
                box = (x1, y1, x1 + s, y1 + s)
                if all(_iou(box, p) <= 0.2 for p in placed):
                    break
            else:
                continue
            placed.append(box)
            color = rng.uniform(0.6, 1.0, 3).astype(np.float32)
            yy, xx = np.mgrid[0:s, 0:s]
            c = (s - 1) / 2.0
            if cls == 0:
                mask = np.ones((s, s), bool)
            elif cls == 1:
                mask = (yy - c) ** 2 + (xx - c) ** 2 <= (s / 2.0) ** 2
            else:
                t = max(s // 4, 1)
                mask = (np.abs(xx - c) <= t / 2.0) | \
                    (np.abs(yy - c) <= t / 2.0)
            region = img[:, y1:y1 + s, x1:x1 + s]
            img[:, y1:y1 + s, x1:x1 + s] = np.where(
                mask[None], color[:, None, None], region)
            labels[i, j] = [cls, x1 / size, y1 / size,
                            (x1 + s) / size, (y1 + s) / size]
            j += 1
        imgs[i] = img
    return imgs, labels
