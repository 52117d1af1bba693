"""Image decode + preprocess and the decoded-sample cache.

Counterpart of the serving half of ``distributedpytorch_tpu/data/dataset.py``:
``BasicDataset.load`` / ``preprocess`` (reference preprocess parity:
BICUBIC resize to ``(W, H)``, /255, NHWC float32) and ``SampleCache``.
PIL is imported inside the functions that decode, so nothing that serves
arrays needs it.
"""

from __future__ import annotations

import logging
import threading
from os.path import splitext
from typing import Dict, Hashable, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

Item = Dict[str, np.ndarray]
Key = Hashable


class SampleCache:
    """Memory-budgeted cache of decoded samples, no eviction: whatever
    fits stays, the rest decodes on every use. Thread-safe; stored arrays
    are shared, so callers treat items as read-only. The serve engine
    keys it by ``(path, size)``."""

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self._items: Dict[Key, Item] = {}
        self._lock = threading.Lock()
        self.used_bytes = 0
        self.hits = 0
        self.misses = 0
        self._full_logged = False

    @staticmethod
    def _nbytes(item: Item) -> int:
        return sum(int(np.asarray(v).nbytes) for v in item.values())

    def get(self, idx: Key) -> Optional[Item]:
        with self._lock:
            item = self._items.get(idx)
            if item is None:
                self.misses += 1
            else:
                self.hits += 1
            return item

    def put(self, idx: Key, item: Item) -> bool:
        """Store if the budget allows; returns whether it was stored."""
        size = self._nbytes(item)
        with self._lock:
            if idx in self._items:
                return True
            if self.used_bytes + size > self.budget_bytes:
                if not self._full_logged:
                    self._full_logged = True
                    logger.info(
                        "sample cache full at %d items / %.1f MiB (budget "
                        "%.1f MiB)", len(self._items),
                        self.used_bytes / 2**20, self.budget_bytes / 2**20,
                    )
                return False
            # copy: a row view would pin its whole parent batch
            self._items[idx] = {
                k: np.array(v, copy=True) for k, v in item.items()
            }
            self.used_bytes += size
            return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


class BasicDataset:
    """The decode/preprocess rules of the reference dataset."""

    @classmethod
    def load(cls, filename):
        """PIL / ``.npy`` / ``.pt`` loading → a PIL image."""
        from PIL import Image

        ext = splitext(str(filename))[1]
        if ext in (".npz", ".npy"):
            return Image.fromarray(np.load(filename))
        if ext in (".pt", ".pth"):
            import torch

            return Image.fromarray(
                torch.load(filename, weights_only=True).numpy()
            )
        return Image.open(filename)

    @classmethod
    def preprocess(cls, pil_img, newsize: Sequence[int],
                   is_mask: bool) -> np.ndarray:
        """Resize to ``newsize = (W, H)`` (NEAREST for masks, BICUBIC for
        images) and normalize: masks as int32 labels, images /255 as
        ``(H, W, C)`` float32."""
        from PIL import Image

        new_w, new_h = int(newsize[0]), int(newsize[1])
        if new_w <= 0 or new_h <= 0:
            raise ValueError(
                "Scale is too small, resized images would have no pixel"
            )
        pil_img = pil_img.resize(
            (new_w, new_h),
            resample=Image.NEAREST if is_mask else Image.BICUBIC,
        )
        arr = np.asarray(pil_img)
        if is_mask:
            return arr.astype(np.int32)
        if arr.ndim == 2:  # grayscale → one channel, channels-last
            arr = arr[..., np.newaxis]
        return (arr / 255.0).astype(np.float32)
