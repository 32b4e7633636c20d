"""The command's refusals: no result line and a non-zero exit without the
program under test, and without a CUDA card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "granite-34b.train.8k", "--seed", str(2**31 + 7),
        "--seconds", "1", "--trace", "0"]


def _run(root: Path):
    env = dict(os.environ, BENCH_RUN="1")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=root,
                          capture_output=True, text=True, timeout=300, env=env)


def test_only_the_benchmark_files_give_no_result(tmp_path):
    shutil.copytree(CHECKOUT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = _run(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_no_card_gives_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    p = _run(CHECKOUT)
    assert p.returncode != 0
    assert p.stdout.strip() == "", p.stdout
    assert "CUDA" in p.stderr
    with pytest.raises(json.JSONDecodeError):
        json.loads(p.stdout or "x")
