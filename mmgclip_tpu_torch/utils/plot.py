"""Plot utilities (port of mmgclip_tpu/utils/plot.py; reference:
mmgclip/utils/plot.py:1-58, logger.py:24-87).

matplotlib is imported inside each helper, never at import time: where it
does not import, the helper logs a warning and returns None without
writing anything, as the evaluator's plots do.  Inputs may be numpy arrays
or tensors (on any device)."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .logging import logger


def _plt(what: str):
    """pyplot on the Agg backend, or None (with a warning) without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception as exc:  # plotting is optional
        logger.warning(f"{what} skipped (matplotlib unavailable: {exc})")
        return None
    return plt


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x)


def plot_dataloader_batch(batch, n: int = 8, save_path: Optional[str] = None):
    """Grid of images with caption titles (reference: plot.py:29-57).

    Works on batches whose ``image_features`` are raw images [n, H, W(, C)];
    feature-vector batches plot the vectors as barcodes instead.
    """
    plt = _plt("plot_dataloader_batch")
    if plt is None:
        return None
    images = _host(batch["image_features"])
    captions = batch.get("image_description", [""] * len(images))
    n = min(n, len(images))
    cols = min(4, n)
    rows = math.ceil(n / cols)
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 4 * rows), squeeze=False)
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        ax.axis("off")
        if i >= n:
            continue
        img = images[i]
        if img.ndim >= 2 and min(img.shape[:2]) > 4:
            ax.imshow(img.squeeze(), cmap="gray")
        else:
            ax.imshow(img.reshape(1, -1), aspect="auto", cmap="viridis")
        ax.set_title(str(captions[i])[:60], fontsize=7)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path)
    plt.close(fig)
    return fig


def plot_cv2_image(image, save_path: Optional[str] = None):
    """Single grayscale image display (reference: plot.py:1-27)."""
    plt = _plt("plot_cv2_image")
    if plt is None:
        return None
    fig, ax = plt.subplots()
    ax.imshow(_host(image).squeeze(), cmap="gray")
    ax.axis("off")
    if save_path:
        fig.savefig(save_path)
    plt.close(fig)
    return fig


def plot_logits_tensorboard(logits_per_image, logits_per_text, writer=None, global_step: int = 0,
                            suptitle: str = "", max_n: int = 8, save_path: Optional[str] = None):
    """Softmaxed logit heatmaps, logged as a TensorBoard image when the
    writer has an event writer (``utils.tb.ScalarWriter._tb``) and written to
    ``save_path`` when given (reference: logger.py:24-87)."""
    plt = _plt("plot_logits_tensorboard")
    if plt is None:
        return None
    lpi = _host(logits_per_image)[:max_n, :max_n]
    lpt = _host(logits_per_text)[:max_n, :max_n]

    def softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    for ax, mat, title in ((axes[0], softmax(lpi), "logits_per_image"),
                           (axes[1], softmax(lpt), "logits_per_text")):
        im = ax.imshow(mat, cmap="viridis", vmin=0, vmax=1)
        ax.set_title(title)
        fig.colorbar(im, ax=ax)
    if suptitle:
        fig.suptitle(suptitle)
    fig.tight_layout()

    if writer is not None and getattr(writer, "_tb", None) is not None:
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        writer._tb.add_image("logits", buf.transpose(2, 0, 1), global_step)
    if save_path:
        fig.savefig(save_path)
    plt.close(fig)
    return fig


def pprint(obj) -> None:
    """Pretty-print helper (reference: logger.py pprint export)."""
    import pprint as _pp

    _pp.PrettyPrinter(indent=2).pprint(obj)
