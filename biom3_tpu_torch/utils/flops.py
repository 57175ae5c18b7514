"""Analytic FLOP accounting + device peak lookup for MFU reporting.

Port of ``biom3_tpu/utils/flops.py``: the same formulas on the port's
configs.  Counts matmul FLOPs only (2·M·K·N per GEMM) — the convention of
the public MFU literature; elementwise/softmax work is excluded.  The peaks
are the card's (``device_peak_flops``, and ``PEAK_BF16``, ``PEAK_INT8``,
``PEAK_BYTES`` for the H100 SXM the measurement scripts bound against),
from NVIDIA's data sheet: dense rates, no sparsity, at the 700 W limit.
"""

from __future__ import annotations

import torch


def transformer_forward_flops(
    *,
    batch: int,
    seq_len: int,
    dim: int,
    depth: int,
    ff_dim: int,
    attn_flops_per_layer: float,
    vocab_out: int = 0,
    qkvo_mult: int = 4,
) -> float:
    """Matmul FLOPs of one encoder forward (no embedding gathers)."""
    per_layer = (
        qkvo_mult * 2 * seq_len * dim * dim          # q, k, v, out projections
        + 2 * 2 * seq_len * dim * ff_dim             # FF in + out
        + attn_flops_per_layer
    )
    head = 2 * seq_len * dim * vocab_out if vocab_out else 0
    return float(batch) * (depth * per_layer + head)


def full_attention_flops(seq_len: int, dim: int) -> float:
    """QK^T + AV for full softmax attention (all heads together)."""
    return 2 * 2 * seq_len * seq_len * dim


def proteoscribe_forward_flops(cfg, batch: int) -> float:
    """Stage-3 forward: 8 local heads (window W, 3W keys) + 8 linear heads."""
    L, Dh = cfg.max_seq_len, cfg.head_dim
    local = cfg.local_heads * 2 * 2 * L * (3 * cfg.local_window) * Dh
    linear = cfg.global_heads * 2 * 2 * L * Dh * Dh
    return transformer_forward_flops(
        batch=batch, seq_len=L, dim=cfg.dim, depth=cfg.depth * cfg.n_blocks,
        ff_dim=cfg.dim * cfg.ff_mult, attn_flops_per_layer=local + linear,
        vocab_out=cfg.num_classes,
    )


def esm2_forward_flops(cfg, batch: int) -> float:
    """ESM2 tower forward (rotary permutation matmuls excluded — they are
    relayout tricks, not model FLOPs)."""
    return transformer_forward_flops(
        batch=batch, seq_len=cfg.max_len, dim=cfg.embed_dim,
        depth=cfg.num_layers, ff_dim=cfg.ffn_dim,
        attn_flops_per_layer=full_attention_flops(cfg.max_len, cfg.embed_dim),
    )


def pencl_pair_forward_flops(cfg) -> float:
    """One (text, protein) pair through both towers + projection heads."""
    esm = transformer_forward_flops(
        batch=1, seq_len=cfg.seq_max_length, dim=cfg.esm.embed_dim,
        depth=cfg.esm.num_layers, ff_dim=4 * cfg.esm.embed_dim,
        attn_flops_per_layer=full_attention_flops(
            cfg.seq_max_length, cfg.esm.embed_dim
        ),
    )
    bert = transformer_forward_flops(
        batch=1, seq_len=cfg.text_max_length, dim=cfg.bert.hidden_size,
        depth=cfg.bert.num_layers, ff_dim=cfg.bert.intermediate_size,
        attn_flops_per_layer=full_attention_flops(
            cfg.text_max_length, cfg.bert.hidden_size
        ),
    )
    heads = 2 * 2 * (
        cfg.protein_embedding * cfg.proj_dim + cfg.proj_dim * cfg.proj_dim
    )
    return esm + bert + heads


def pencl_esm_ff_flops_fraction(cfg) -> float:
    """Fraction of the pair's matmul FLOPs in the ESM2 FF matmuls — the
    part the int8 serving mode runs on the int8 tensor-core path (2× the
    bf16 rate on the H100, ``PEAK_INT8 / PEAK_BF16``).  The basis of a
    mixed-precision MFU: with f the int8-covered fraction, the
    bf16-equivalent ceiling is ``peak_bf16 / (1 − f/2)``."""
    return pencl_int8_flops_fraction(cfg, esm_ff=True)


def pencl_int8_flops_fraction(cfg, *, esm_ff: bool = True,
                              esm_proj: bool = False,
                              bert_ff: bool = False) -> float:
    """Fraction of the pair's matmul FLOPs covered by the Stage-1 int8
    serving modes: ``esm_ff`` → the ESM2 FF matmuls, ``esm_proj`` → the
    ESM2 q/k/v/out projections, ``bert_ff`` → the BERT FF matmuls.  Same
    blended-ceiling use as :func:`pencl_esm_ff_flops_fraction`."""
    E, Lp = cfg.esm.embed_dim, cfg.seq_max_length
    covered = 0.0
    if esm_ff:
        covered += cfg.esm.num_layers * 2 * 2 * Lp * E * (4 * E)
    if esm_proj:
        covered += cfg.esm.num_layers * 4 * 2 * Lp * E * E
    if bert_ff:
        covered += (cfg.bert.num_layers * 2 * 2 * cfg.text_max_length
                    * cfg.bert.hidden_size * cfg.bert.intermediate_size)
    return covered / pencl_pair_forward_flops(cfg)


def proteoscribe_int8_flops_fraction(cfg, *, ff: bool = True,
                                     proj: bool = False) -> float:
    """Fraction of the Stage-3 forward's matmul FLOPs covered by the int8
    serving modes (``ff_quant`` → the two FF matmuls, ``proj_quant`` → the
    q/k/v/out projections).  Same blended-ceiling use as
    :func:`pencl_esm_ff_flops_fraction`."""
    L, d = cfg.max_seq_len, cfg.dim
    depth = cfg.depth * cfg.n_blocks
    covered = 0.0
    if ff:
        covered += depth * 2 * 2 * L * d * (d * cfg.ff_mult)
    if proj:
        covered += depth * 4 * 2 * L * d * d
    return covered / proteoscribe_forward_flops(cfg, 1)


# card name prefix → dense (bf16 FLOP/s, int8 OP/s, HBM bytes/s)
_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 1979e12, 3.35e12),   # H100 SXM
}
PEAK_BF16, PEAK_INT8, PEAK_BYTES = _PEAKS["NVIDIA H100 80GB HBM3"]


def device_peak_flops() -> float | None:
    """The current card's dense bf16 peak in FLOP/s, or None for a card the
    table lacks or no card."""
    if not torch.cuda.is_available():
        return None
    kind = torch.cuda.get_device_name()
    for prefix, peaks in _PEAKS.items():
        if kind.startswith(prefix):
            return peaks[0]
    return None
