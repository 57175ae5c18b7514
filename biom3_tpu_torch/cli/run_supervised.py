"""Failure-tolerant training supervisor: relaunch-with-resume on crashes.

The reference has no failure detection or elastic recovery (SURVEY.md §5 —
restarts rely on manually pointing Lightning at a .ckpt).  Here, training
CLIs checkpoint via orbax on a cadence and accept ``--resume``; this
supervisor watches the child process and relaunches it with ``--resume``
after faults (TPU worker crashes, preemptions, OOM-kills), with bounded
restarts and exponential backoff.

  python -m biom3_tpu_torch.cli.run_supervised --max_restarts 5 -- \
      python -m biom3_tpu_torch.cli.run_train_stage3 --json_path ... --output_dir ...
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time


def parse_arguments():
    p = argparse.ArgumentParser(description="BioM3 training supervisor")
    p.add_argument("--max_restarts", type=int, default=5)
    p.add_argument("--backoff_s", type=float, default=10.0)
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="training command after '--'")
    return p.parse_args()


def main() -> None:
    args = parse_arguments()
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        raise SystemExit("no training command given (use: ... -- <command>)")

    attempt = 0
    while True:
        run_cmd = list(cmd)
        if attempt > 0 and "--resume" not in run_cmd:
            run_cmd.append("--resume")
        print(f"[supervisor] attempt {attempt}: {' '.join(run_cmd)}", flush=True)
        proc = subprocess.run(run_cmd)
        if proc.returncode == 0:
            print("[supervisor] training finished cleanly", flush=True)
            return
        attempt += 1
        if attempt > args.max_restarts:
            print(
                f"[supervisor] giving up after {args.max_restarts} restarts "
                f"(last exit code {proc.returncode})",
                flush=True,
            )
            sys.exit(proc.returncode)
        delay = args.backoff_s * (2 ** (attempt - 1))
        print(
            f"[supervisor] child exited {proc.returncode}; restarting with "
            f"--resume in {delay:.0f}s",
            flush=True,
        )
        time.sleep(delay)


if __name__ == "__main__":
    main()
