"""Training checkpoints: save, restore and resume.

Port of ``biom3_tpu/io/orbax_io.py:17-45`` on ``torch.save`` files: one
``step_<n>.pt`` per saved step under the manager's directory, the newest
``max_to_keep`` kept.  A checkpoint holds what ``TrainState.state_dict``
returns (parameters, optimizer and schedule state, EMA copies, step),
whole also for a sharded state: in a process group every rank gathers it,
rank 0 writes it, and ``restore`` lays it out again as each rank's shards
(``TrainState.load_state_dict``).  A file is written under a temporary
name and renamed, so a reader never sees a half-written one.
"""

from __future__ import annotations

import os
import pathlib
import re

import torch
import torch.distributed as dist

_NAME = re.compile(r"step_(\d+)\.pt")


class CheckpointManager:
    def __init__(self, directory: str, *, max_to_keep: int = 3):
        self.directory = pathlib.Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _NAME.fullmatch(p.name)))

    def save(self, step: int, state) -> None:
        """Write ``state.state_dict()`` as the checkpoint of ``step``
        (synchronously) and drop all but the newest ``max_to_keep``.  In a
        process group every rank calls it; rank 0 writes, and no rank
        returns before the file is in place."""
        sd = state.state_dict()
        if not dist.is_initialized() or dist.get_rank() == 0:
            path = self.directory / f"step_{step}.pt"
            tmp = path.with_suffix(".pt.tmp")
            torch.save(sd, tmp)
            os.replace(tmp, path)
            for old in self.steps()[:-self.max_to_keep]:
                (self.directory / f"step_{old}.pt").unlink()
        if dist.is_initialized():
            dist.barrier()

    def restore(self, state, step: int | None = None):
        """Load the checkpoint of ``step`` (default the latest) into
        ``state`` in place; returns it."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        sd = torch.load(self.directory / f"step_{step}.pt", map_location="cpu",
                        weights_only=True)
        state.load_state_dict(sd)
        return state

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        """Nothing is pending: saves are synchronous."""
