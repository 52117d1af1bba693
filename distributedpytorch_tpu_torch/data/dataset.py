"""Datasets, image decode + preprocess, and the decoded-sample cache.

Counterpart of ``distributedpytorch_tpu/data/dataset.py`` without its
native C++ decode path: ``BasicDataset`` (images and masks paired by
filename stem; reference preprocess: BICUBIC resize to ``(W, H)``, /255,
NHWC float32, NEAREST int32 masks), ``CarvanaDataset``,
``build_dataset``, ``SyntheticSegmentationDataset`` (the same numpy code,
so bit-identical items) and ``SampleCache``. PIL is imported inside the
functions that decode, so nothing that serves or trains on arrays needs
it.
"""

from __future__ import annotations

import logging
import os
import threading
from os.path import splitext
from pathlib import Path
from typing import Dict, Hashable, Optional, Sequence, Tuple

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
    """Images dir + masks dir paired by filename stem, with the decode and
    preprocess rules of the reference dataset."""

    def __init__(self, images_dir: str, masks_dir: str,
                 newsize: Sequence[int] = (960, 640), mask_suffix: str = ""):
        self.images_dir = Path(images_dir)
        self.masks_dir = Path(masks_dir)
        self.newsize = tuple(int(v) for v in newsize)
        self.mask_suffix = mask_suffix
        self.ids = sorted(  # listdir order is fs-dependent
            splitext(f)[0] for f in os.listdir(images_dir)
            if not f.startswith(".")
        )
        if not self.ids:
            raise RuntimeError(
                f"No input file found in {images_dir}, make sure you put "
                f"your images there"
            )
        logger.info("Creating dataset with %d examples", len(self.ids))

    def __len__(self) -> int:
        return len(self.ids)

    def resolve_paths(self, idx: int) -> Tuple[str, str]:
        """(image path, mask path) of one sample: exactly one file each
        must match its stem, or RuntimeError."""
        name = self.ids[idx]
        mask_files = list(self.masks_dir.glob(name + self.mask_suffix + ".*"))
        img_files = list(self.images_dir.glob(name + ".*"))
        if len(mask_files) != 1:
            raise RuntimeError(
                f"Either no mask or multiple masks found for the ID {name}: "
                f"{mask_files}"
            )
        if len(img_files) != 1:
            raise RuntimeError(
                f"Either no image or multiple images found for the ID "
                f"{name}: {img_files}"
            )
        return str(img_files[0]), str(mask_files[0])

    def __getitem__(self, idx: int) -> Item:
        img_path, mask_path = self.resolve_paths(idx)
        mask = self.load(mask_path)
        img = self.load(img_path)
        if img.size != mask.size:
            raise RuntimeError(
                f"Image and mask should be the same size, but are "
                f"{img.size} and {mask.size}"
            )
        return {
            "image": self.preprocess(img, self.newsize, is_mask=False),
            "mask": self.preprocess(mask, self.newsize, is_mask=True),
        }

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


class CarvanaDataset(BasicDataset):
    """Carvana naming: masks end in ``_mask``."""

    def __init__(self, images_dir, masks_dir,
                 newsize: Sequence[int] = (960, 640)):
        super().__init__(images_dir, masks_dir, newsize, mask_suffix="_mask")


def build_dataset(images_dir: str, masks_dir: str,
                  newsize: Sequence[int] = (960, 640)) -> BasicDataset:
    """Carvana first, the basic dataset otherwise. The Carvana attempt
    decodes one item, since mask pairing fails only when a mask is looked
    up."""
    try:
        ds = CarvanaDataset(images_dir, masks_dir, newsize)
        ds[0]
        logger.info("Carvana dataset detected")
        return ds
    except RuntimeError:
        logger.info("Falling back to basic dataset")
        return BasicDataset(images_dir, masks_dir, newsize)


class SyntheticSegmentationDataset:
    """In-memory procedural "car" ellipses with the item contract of
    ``BasicDataset``: no disk and no PIL. Items are bit-identical to the
    JAX package's for the same ``(length, newsize, seed)``."""

    def __init__(self, length: int = 64, newsize: Sequence[int] = (960, 640),
                 seed: int = 0):
        self.length = length
        self.newsize = tuple(int(v) for v in newsize)
        self.seed = seed
        self.ids = [f"synthetic_{i:04d}" for i in range(length)]

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Item:
        if not 0 <= idx < self.length:
            raise IndexError(idx)
        w, h = self.newsize
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        image = rng.random((h, w, 3), dtype=np.float32)
        cy = rng.integers(h // 4, 3 * h // 4)
        cx = rng.integers(w // 4, 3 * w // 4)
        ry, rx = rng.integers(h // 8, h // 4), rng.integers(w // 8, w // 4)
        yy, xx = np.ogrid[:h, :w]
        mask = (
            ((yy - cy) / max(ry, 1)) ** 2 + ((xx - cx) / max(rx, 1)) ** 2
            <= 1.0
        ).astype(np.int32)
        image[..., 0] = np.where(mask, 0.25 + 0.5 * image[..., 0],
                                 image[..., 0])
        return {"image": image, "mask": mask}
