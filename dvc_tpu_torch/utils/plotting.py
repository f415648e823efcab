"""Spectrogram / latent plotting (a copy of dvc_tpu/utils/plotting.py:
reference model/plot.py and the png dumps in
variational_base_vae.py:205-239,302-318).  matplotlib is optional; every
function degrades to a no-op (returning False) when it is unavailable, and
plot_latent_analysis still writes its npz."""

from __future__ import annotations

import numpy as np


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except Exception:
        return None


def save_mel_png(mel: np.ndarray, path: str, title: str = "") -> bool:
    """Mel (80, T) -> png heatmap (replaces librosa.display.specshow)."""
    plt = _plt()
    if plt is None:
        return False
    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(np.asarray(mel), aspect="auto", origin="lower",
                   interpolation="none", cmap="magma")
    ax.set_title(title)
    ax.set_xlabel("frames")
    ax.set_ylabel("mel bin")
    fig.colorbar(im, ax=ax, format="%f")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return True


def encoding_visualization(latent: np.ndarray, path: str, sample_id: str = "") -> bool:
    """Stem plot of one latent code (reference model/plot.py:7-20)."""
    plt = _plt()
    if plt is None:
        return False
    fig, ax = plt.subplots()
    ax.stem(np.asarray(latent).ravel())
    ax.set_title(f"latent code {sample_id}")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return True


def projection_plot(embeds: np.ndarray, labels, path: str,
                    title: str = "embedding projection") -> bool:
    """2-D PCA scatter of speaker embeddings colored by speaker — the role of
    the reference's periodic UMAP projections
    (preprocessing/encoder/visualizations.py:155-173; UMAP itself is not a
    dependency here, PCA is the deterministic stand-in)."""
    plt = _plt()
    if plt is None:
        return False
    x = np.asarray(embeds, np.float64)
    x = x - x.mean(axis=0)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    proj = x @ vt[:2].T
    labels = np.asarray(labels)
    fig, ax = plt.subplots(figsize=(6, 6))
    for lab in np.unique(labels):
        pts = proj[labels == lab]
        ax.scatter(pts[:, 0], pts[:, 1], s=12, label=str(lab), alpha=0.7)
    ax.set_title(title)
    ax.legend(fontsize=6, ncol=2)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return True


def plot_fs_mask(mask: np.ndarray, out_png: str,
                 threshold: float = 0.5, speaker_size: int = 4) -> bool:
    """FeatureSelection sigmoid-mask bar plot: which latent dims carry
    speaker identity (train-fs output; dims above the threshold are the
    ones convert --fs_mask swaps, plus the first speaker_size style dims)."""
    plt = _plt()
    if plt is None:
        return False
    mask = np.asarray(mask)
    fig, ax = plt.subplots(figsize=(10, 3))
    colors = ["tab:red" if (i < speaker_size or v > threshold)
              else "tab:gray" for i, v in enumerate(mask)]
    ax.bar(np.arange(len(mask)), mask, color=colors)
    ax.axhline(threshold, color="k", lw=0.8, ls="--")
    ax.set_xlabel("latent dim")
    ax.set_ylabel("speaker-discriminative (sigmoid)")
    ax.set_title("FeatureSelection mask (red = swapped at conversion)")
    fig.savefig(out_png, bbox_inches="tight")
    plt.close(fig)
    return True


def plot_latent_analysis(mus: np.ndarray, stds: np.ndarray, speaker_ids,
                         out_png: str, out_npz: str | None = None) -> bool:
    """Per-speaker latent mean/std errorbar plot + npz dump (reference
    model/plot.py:23-55)."""
    if out_npz:
        np.savez(out_npz, mus=mus, stds=stds, speakers=np.array(speaker_ids))
    plt = _plt()
    if plt is None:
        return False
    fig, ax = plt.subplots(figsize=(12, 5))
    for mu, std, spk in zip(mus, stds, speaker_ids):
        ax.errorbar(np.arange(len(mu)), mu, yerr=std, label=str(spk), alpha=0.6)
    ax.set_xlabel("latent dim")
    ax.legend(fontsize=6, ncol=4)
    fig.savefig(out_png, bbox_inches="tight")
    plt.close(fig)
    return True
