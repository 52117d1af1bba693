"""Image/mask panels: the reference's ``plot_img_and_mask`` (reference
utils/utils.py:38-51), the port's own copy of
``distributedpytorch_tpu/utils/plotting.py``.

matplotlib loads inside the function, so only ``predict --viz`` needs it.
Multi-class masks are channels-last ``(H, W, C)``, as everything else in
the package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def plot_img_and_mask(img, mask, out_path: Optional[str] = None):
    """One row of panels: the input image, then one panel per mask class.

    ``img`` is ``(H, W, 3)`` in [0, 1] (float) or uint8; ``mask`` is
    ``(H, W)`` or ``(H, W, C)``. Saves a PNG to ``out_path`` when given
    (headless), else ``plt.show()``. Returns the matplotlib figure."""
    import matplotlib

    if out_path is not None:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    img = np.asarray(img)
    mask = np.asarray(mask)
    classes = mask.shape[-1] if mask.ndim > 2 else 1
    fig, ax = plt.subplots(1, classes + 1)
    ax[0].set_title("Input image")
    ax[0].imshow(img)
    if classes > 1:
        for i in range(classes):
            ax[i + 1].set_title(f"Output mask (class {i + 1})")
            ax[i + 1].imshow(mask[:, :, i])
    else:
        ax[1].set_title("Output mask")
        ax[1].imshow(mask)
    plt.xticks([])
    plt.yticks([])
    if out_path is not None:
        fig.savefig(out_path, bbox_inches="tight")
        plt.close(fig)
    else:  # pragma: no cover - needs a display
        plt.show()
    return fig
