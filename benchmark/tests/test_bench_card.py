"""run.py without a card, and each cell's run on the card."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_cells import CELLS, ROOT


def _run(cwd, cell, seconds="1", trace="0", timeout=900):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                           "2147483661", "--seconds", seconds, "--trace", trace],
                          cwd=cwd, capture_output=True, text=True, timeout=timeout)


def test_no_card_no_result():
    """Without a card (or with the program absent) a run fails and prints
    no result; it never falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(ROOT, CELLS[0])
    assert out.returncode == 3 and out.stdout.strip() == "", out.stderr
    assert "CUDA card" in out.stderr


def test_needs_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails and prints no result."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = _run(str(tmp_path), CELLS[0])
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    out = _run(ROOT, name, seconds="2")
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["compared"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
