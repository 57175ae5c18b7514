"""The benchmark's own CPU tests (``python -m pytest benchmark -q``): the
harness and the references on the CPU at tiny sizes.  Tests marked ``card``
need an NVIDIA card; each decides inside the test and skips without one."""

import pathlib
import sys

import torch

# The tiny sizes run faster on two threads than on every core, and several
# test workers then do not crowd each other: a window of a second then holds
# whole batches, which some checks need.
torch.set_num_threads(2)

HERE = pathlib.Path(__file__).resolve().parent
for path in (str(HERE.parent), str(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")
