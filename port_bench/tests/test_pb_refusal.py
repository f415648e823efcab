"""run.py refuses to run, and prints no result, without a card or without
the program."""

import os
import shutil
import subprocess
import sys

from port_bench import common

ARGS = ["--workload", "serve-wavenet-c1", "--seed", str(2 ** 31 + 5), "--seconds", "1",
        "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "port_bench/run.py", *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card():
    p = _run(common.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(common.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
