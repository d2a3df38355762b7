"""The port's example scripts run end to end on the CPU at a small size
(``--device cpu``), each asserting its own answers: the quickstart's Π₁
against the synthesized Π₂, and the graph-analytics suite's CEGIS
programs, BC against Brandes and the served batch against the
per-source loop."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

EXAMPLES = {
    "quickstart_torch": (["--n", "200"], "answers equal: True"),
    "graph_analytics_torch": (["--n", "48", "--serve-n", "400",
                               "--requests", "16"], "tree depth"),
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_cpu(name):
    args, expect = EXAMPLES[name]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"),
         "--device", "cpu", *args], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert expect in out.stdout
    assert "equal=False" not in out.stdout
