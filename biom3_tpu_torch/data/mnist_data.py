"""MNIST loader (legacy of the reference's image-diffusion lineage).

Port of ``get_mnist_dataset`` (``Stage3_source/preprocess.py:16-50``): the
original OA-ARDM codebase trained on binarized MNIST before the protein
adaptation, and the reference still ships the loader.  Provided for
capability parity; requires torchvision with a *local* MNIST copy
(``download=False`` by default — this environment has no network egress).

Returns numpy batches shaped like the protein pipeline: "sequence" mode
flattens each binarized image to (image_size²,) token ids {1, 2} matching
the reference's MNIST labeling (``create_token_labels``: background→1,
foreground→2, absorbing→0).
"""

from __future__ import annotations

import numpy as np


def get_mnist_arrays(
    data_root: str,
    image_size: int = 32,
    *,
    train: bool = True,
    download: bool = False,
    mode: str = "sequence",
) -> tuple[np.ndarray, np.ndarray]:
    """→ (data, labels).  sequence mode: (N, image_size²) int32 in {1, 2}."""
    try:
        from torchvision.datasets import MNIST
        from torchvision.transforms import Compose, Resize, ToTensor
    except ImportError as e:
        raise ImportError(
            "MNIST loading needs torchvision (optional dependency)"
        ) from e

    import torch

    transform = Compose([ToTensor(), Resize(image_size)])
    ds = MNIST(root=data_root, download=download, transform=transform, train=train)
    images, labels = [], []
    for img, label in ds:
        binary = (img > 0.5).to(torch.int32) + 1  # background 1, foreground 2
        if mode == "sequence":
            images.append(binary.flatten().numpy())
        elif mode == "normal":
            images.append(binary.squeeze(0).numpy())
        else:
            raise ValueError("mode must be 'sequence' or 'normal'")
        labels.append(int(label))
    return np.stack(images).astype(np.int32), np.asarray(labels, np.int64)
