"""QC / evaluation CLI: score generated sequences against references.

Port of ``biom3_tpu/cli/run_eval.py``: its flags (and ``--device``), the same JSON report
(sequence statistics; with ``--reference_path``, per replica, BLOSUM62 soft
accuracy and PAD-excluded hard accuracy) and the same skipping of pairs
with characters outside the 28-token training vocab.  The scores are the
port's ``training/metrics.py`` on ``--device`` (default ``cuda``, as the JAX
CLI computes on its default device; ``cpu`` on request), and the run stops
when ``cuda`` is asked for and no card is found.

  python -m biom3_tpu_torch.cli.run_eval --designs_path designs.pt \\
      --reference_path refs.pt --output_path report.pt [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from biom3_tpu_torch.io.torch_io import load_torch_file, save_torch_file
from biom3_tpu_torch.tokenizers import Stage3Vocab
from biom3_tpu_torch.training.metrics import blosum_soft_accuracy, hard_accuracy


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(description="BioM3 generation QC")
    p.add_argument("--designs_path", type=str, required=True,
                   help="designs .pt (replica dict or e2e output)")
    p.add_argument("--reference_path", type=str, default=None,
                   help="optional .pt with 'sequence' list to score against")
    p.add_argument("--output_path", type=str, default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def sequence_stats(seqs: list[str]) -> dict:
    lengths = [len(s) for s in seqs]
    aa_counts: dict = {}
    for s in seqs:
        for ch in s:
            aa_counts[ch] = aa_counts.get(ch, 0) + 1
    total = max(1, sum(aa_counts.values()))
    return {
        "n": len(seqs),
        "len_mean": float(np.mean(lengths)) if lengths else 0.0,
        "len_std": float(np.std(lengths)) if lengths else 0.0,
        "aa_frequencies": {k: v / total for k, v in sorted(aa_counts.items())},
        "unique_fraction": len(set(seqs)) / max(1, len(seqs)),
    }


def score_against_reference(designs: list[str], references: list[str],
                            device: str | torch.device = "cpu") -> dict:
    vocab = Stage3Vocab()
    # skip pairs with characters outside the 28-token training vocab instead
    # of aborting the whole evaluation
    keep_d, keep_r, skipped = [], [], 0
    for d, r in zip(designs, references):
        if all(ch in vocab.train_tok_to_id for ch in d + r):
            keep_d.append(d)
            keep_r.append(r)
        else:
            skipped += 1
    if not keep_d:
        return {"skipped_out_of_vocab": skipped}
    pad_to = max(max(len(d) for d in keep_d), max(len(r) for r in keep_r)) + 2
    d_ids, r_ids = (torch.as_tensor(vocab.shift_for_model(vocab.batch_encode(seqs, pad_to)),
                                    device=device) for seqs in (keep_d, keep_r))
    out = {
        "blosum_soft_acc": float(blosum_soft_accuracy(d_ids, r_ids)),
        "hard_acc": float(hard_accuracy(d_ids, r_ids)),
    }
    if skipped:
        out["skipped_out_of_vocab"] = skipped
    return out


def main(argv=None) -> None:
    args = parse_arguments(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu to run on the CPU)")
    data = load_torch_file(args.designs_path)
    if "sequences" in data:  # e2e output format
        replica_dict = data["sequences"]
    else:
        replica_dict = {k: v for k, v in data.items() if k.startswith("replica_")}

    all_seqs = [s for seqs in replica_dict.values() for s in seqs]
    report = {"stats": sequence_stats(all_seqs)}

    if args.reference_path:
        ref = load_torch_file(args.reference_path)
        references = list(ref["sequence"])
        per_replica = {}
        for name, seqs in replica_dict.items():
            n = min(len(seqs), len(references))
            per_replica[name] = score_against_reference(seqs[:n], references[:n],
                                                     args.device)
        report["vs_reference"] = per_replica

    print(json.dumps(report, indent=2))
    if args.output_path:
        save_torch_file(report, args.output_path)


if __name__ == "__main__":
    main()
