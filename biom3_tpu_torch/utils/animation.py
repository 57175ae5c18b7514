"""Denoising-trajectory visualization (ref Stage3_source/animation_tools.py).

Port of ``biom3_tpu/utils/animation.py`` on the port's ``tokenizers`` copy.

``decode_trajectory`` turns a sampler trajectory (T, B, L) into per-step
strings (the reference's ``convert_num_to_char`` applied along the
trajectory); ``generate_text_animation`` writes the GIF when PIL/imageio are
available (gated — they are optional in this environment).
"""

from __future__ import annotations

import numpy as np

from biom3_tpu_torch.tokenizers.stage3_vocab import Stage3Vocab


def decode_trajectory(
    trajectory: np.ndarray, sample_idx: int = 0, *, every: int = 1
) -> list[str]:
    """(T, B, L) trajectory → list of decoded strings for one sample."""
    vocab = Stage3Vocab()
    traj = np.asarray(trajectory)[::every, sample_idx]
    return [vocab.decode_ids(step) for step in traj]


def generate_text_animation(
    text_list: list[str],
    text_animation_path: str,
    output_temp_path: str = "./outputs/temp_files",
) -> None:
    """Render decoded steps as a GIF (ref animation_tools.py:31-65)."""
    try:
        import imageio
        from PIL import Image, ImageDraw, ImageFont
    except ImportError as e:
        raise ImportError(
            "GIF animation needs pillow + imageio (optional deps)"
        ) from e

    import os
    import textwrap

    os.makedirs(output_temp_path, exist_ok=True)
    files = []
    font = ImageFont.load_default()
    for index, text in enumerate(text_list):
        img = Image.new("RGB", (600, 159), color=(255, 255, 255))
        draw = ImageDraw.Draw(img)
        draw.multiline_text(
            (10, 10), textwrap.fill(text, width=80), font=font, fill=(0, 0, 0)
        )
        path = os.path.join(output_temp_path, f"temp_image_{index}.png")
        img.save(path)
        files.append(path)
    imageio.mimsave(
        text_animation_path,
        [imageio.imread(f) for f in files],
        format="GIF",
        duration=0.2,
    )
    for f in files:
        os.remove(f)
