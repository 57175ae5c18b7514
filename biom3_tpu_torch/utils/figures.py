"""Figure logging: singular-value spectrum PNGs for collapse tracking.

Port of ``biom3_tpu/utils/figures.py`` (the reference's TensorBoard figure
path, ``Stage1_source/PL_wrapper.py:183-214,302-372``): log-singular-value
spectra of the joint embeddings plus the RankMe effective rank, through the
port's ``training/metrics``.  Matplotlib is optional; the numeric spectra
always land in the metric logger.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from biom3_tpu_torch.training.metrics import rankme, singular_spectrum


def embedding_spectrum_report(z: np.ndarray, *, quirk_q9: bool = False) -> dict:
    """→ {"log_sigma": sorted log singular values, "erank": RankMe}."""
    s = singular_spectrum(torch.as_tensor(np.asarray(z)), quirk_q9=quirk_q9)
    return {
        "log_sigma": np.sort(np.log(np.maximum(s.numpy(), 1e-30)))[::-1],
        "erank": float(rankme(s)),
    }


def save_spectrum_png(
    log_sigma: np.ndarray, title: str, out_dir: str
) -> str | None:
    """Write the spectrum plot; returns the path or None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    os.makedirs(out_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(np.arange(len(log_sigma)), log_sigma)
    ax.set_xlabel("singular value index")
    ax.set_ylabel("log σ_k")
    ax.set_title(f"{title} embedding spectrum")
    path = os.path.join(out_dir, f"spectrum_{title}.png")
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path
