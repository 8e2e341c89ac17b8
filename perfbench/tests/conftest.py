"""CPU tests of the benchmark: the harness at a tiny size on the CPU, and
its parts on synthetic inputs.  Run from the repository's root:

    python -m pytest perfbench/tests -q
"""

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.harness import manifest  # noqa: E402

CPU = torch.device("cpu")


def tiny_cell(name: str, img: int = 64, batch: int = 2,
              compute_dtype: str = None) -> dict:
    """The cell ``name`` of BENCHMARK.json cut to a CPU test's size: its
    configuration at ``img`` px, ``batch`` images, a pool of 3 batches."""
    cell = copy.deepcopy(manifest.cell(name))
    cell["config"]["model"]["img_size"] = img
    if compute_dtype:
        cell["config"]["compute_dtype"] = compute_dtype
    tr = cell["traffic"]
    tr["batch"], tr["pool_batches"] = batch, 3
    if tr["kind"] == "serve":
        tr["warmup_batches"] = 1
        tr["profile_batches"] = 2
        tr["check"] = {"batches": 1, "from_first": 2, "reference_rows": 2}
    return cell


@pytest.fixture
def tiny():
    torch.manual_seed(0)
    return tiny_cell
