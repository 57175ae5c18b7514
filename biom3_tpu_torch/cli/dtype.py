"""``--dtype auto|bf16|f32`` of the inference CLIs, the flag of the JAX
``run_proteoscribe_sample.py`` (:34-37, :73-77): ``auto`` is bf16 on cuda,
where the engines run the port's kernels, and f32 on the CPU."""

from __future__ import annotations

CHOICES = ("auto", "bf16", "f32")
HELP = ("engine precision: bf16 on cuda runs the port's kernels (tanh GELU, int8 by "
        "default); f32 runs the PyTorch modules (erf GELU, no int8) on any device; "
        "auto = bf16 on cuda, f32 on cpu")


def add_dtype_argument(parser) -> None:
    parser.add_argument("--dtype", choices=CHOICES, default="auto", help=HELP)


def resolve_dtype(flag: str, device):
    """``--dtype`` and ``--device`` → the engines' torch dtype."""
    import torch

    if flag not in CHOICES:
        raise ValueError(f"--dtype must be one of {CHOICES}, got {flag!r}")
    if flag == "auto":
        return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    return torch.bfloat16 if flag == "bf16" else torch.float32
