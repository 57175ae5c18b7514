"""Stage-2 (Facilitator) data pipeline: (z_t, z_p) embedding pairs.

The port's copy of ``biom3_tpu/data/stage2_data.py`` (numpy only; the split
indices come from the same ``np.random.default_rng(seed)`` draws), loading
with the port's own ``io/torch_io.load_torch_file``.  The original is a
port of ``Facilitator_Dataset`` / ``Facilitator_DataModule``
(``Stage1_source/preprocess.py:194-409``): loads Stage-1 embedding dicts
(SwissProt and/or Pfam), splits train/val, and carries the reference's
out-of-distribution Pfam holdout list (``:250-261``).
"""

from __future__ import annotations

import numpy as np

# ref Stage1_source/preprocess.py:250-261
OOD_PFAM_LABELS = [
    "PF18369", "PF04680", "PF17988", "PF12325", "PF03272",
    "PF03938", "PF17724", "PF10696", "PF11968", "PF04153",
]


class FacilitatorDataset:
    def __init__(
        self,
        dataset: dict,
        *,
        valid_size: float = 0.2,
        seed: int = 42,
    ):
        def stack(value):
            if isinstance(value, list):
                return np.stack([np.asarray(v, np.float32) for v in value])
            return np.asarray(value, np.float32)

        self.z_t = stack(dataset["text_embedding"])
        self.z_p = stack(dataset["protein_embedding"])
        assert len(self.z_t) == len(self.z_p)

        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(self.z_t))
        n_val = int(round(len(self.z_t) * valid_size))
        self.val_idx = perm[:n_val]
        self.train_idx = perm[n_val:]

    @classmethod
    def from_paths(
        cls,
        swissprot_path: str | None,
        pfam_path: str | None,
        **kwargs,
    ) -> "FacilitatorDataset":
        """Load SwissProt and/or Pfam embedding dicts (the DataModule's three
        branches, ref preprocess.py:292-307)."""
        from biom3_tpu_torch.io.torch_io import load_torch_file

        dicts = []
        for path in (swissprot_path, pfam_path):
            if path is not None and path != "None":
                dicts.append(load_torch_file(path))
        if not dicts:
            raise ValueError("both SwissProt and Pfam paths are unset")
        if len(dicts) == 1:
            data = dicts[0]
        else:
            data = {
                "text_embedding": _concat_field(dicts, "text_embedding"),
                "protein_embedding": _concat_field(dicts, "protein_embedding"),
            }
        return cls(data, **kwargs)

    def split(self, which: str) -> tuple[np.ndarray, np.ndarray]:
        idx = self.train_idx if which == "train" else self.val_idx
        return self.z_t[idx], self.z_p[idx]

    def __len__(self) -> int:
        return len(self.z_t)


def _concat_field(dicts: list[dict], key: str) -> np.ndarray:
    parts = []
    for d in dicts:
        v = d[key]
        parts.append(
            np.stack([np.asarray(x, np.float32) for x in v])
            if isinstance(v, list)
            else np.asarray(v, np.float32)
        )
    return np.concatenate(parts)
