"""Plots of a mel spectrogram and an alignment, for the CLI and training
logs.

Matplotlib is optional (the card's machine has none): without it each
function saves the array as `<path>.npy` and returns None.
"""

from __future__ import annotations

import numpy as np


def _get_plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def plot_spectrogram(spectrogram: np.ndarray, path=None):
    """Heatmap of a (channels, frames) mel spectrogram; the figure (saved to
    `path` and closed when given), or None without matplotlib."""
    plt = _get_plt()
    if plt is None:
        if path:
            np.save(str(path) + ".npy", spectrogram)
        return None
    fig, ax = plt.subplots(figsize=(10, 2))
    im = ax.imshow(spectrogram, aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(im, ax=ax)
    plt.xlabel("Frames")
    plt.ylabel("Channels")
    plt.tight_layout()
    if path:
        fig.savefig(path)
        plt.close(fig)
    return fig


def plot_alignment(attn: np.ndarray, path=None):
    """Heatmap of a (tokens, frames) alignment; as `plot_spectrogram`."""
    plt = _get_plt()
    if plt is None:
        if path:
            np.save(str(path) + ".npy", attn)
        return None
    fig = plt.figure(figsize=(10, 4))
    plt.imshow(attn, origin="lower", aspect="auto")
    plt.colorbar()
    plt.title("Alignment (Attention)")
    plt.xlabel("Mel Frames")
    plt.ylabel("Text Tokens")
    if path:
        fig.savefig(path)
        plt.close(fig)
    return fig
