"""``run.py`` as a command: it refuses to run without a card, and on a
card (tests marked ``gpu``) runs a cell to a correct result line."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

CELL = "grid1m-4k.agg-classimg"


def _run(*args, cwd=ROOT):
    return subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), *args],
                          capture_output=True, text=True, cwd=cwd, timeout=600)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine without one")
    out = _run("--workload", CELL, "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode == 2
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_unknown_workload_fails():
    out = _run("--workload", "no-such-cell", "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.gpu
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run("--workload", CELL, "--seed", "4000000001", "--seconds", "3",
               "--trace", "0")
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"agg_views_per_s", "setup_s"}
