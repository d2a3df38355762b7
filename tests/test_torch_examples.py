"""The port's example scripts run end to end on the CPU at a small size
(``--device cpu``), each asserting its own answers: the quickstart's Π₁
against the synthesized Π₂, and the graph-analytics suite's CEGIS
programs, BC against Brandes and the served batch against the
per-source loop; the LM server's greedy decode of four requests against
a full forward with no cache."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]

EXAMPLES = {
    "quickstart_torch": (["--n", "200"], "answers equal: True"),
    "graph_analytics_torch": (["--n", "48", "--serve-n", "400",
                               "--requests", "16"], "tree depth"),
    "serve_lm_torch": (["--max-new", "6"], "req3: ["),
}


def greedy_by_full_forward(stdout):
    """``serve_lm_torch``'s defaults (Zamba2's smoke config, seed 0, four
    prompts of 24 from ``default_rng(0)``): each request printed 6
    tokens, each the argmax of a full forward (no cache) over its prompt
    and the tokens before it, checked while the top two logits are more
    than 1e-3 apart (a closer call may round either way)."""
    outs = [json.loads(line.split(":", 1)[1]) for line in stdout.splitlines()
            if line.strip().startswith("req")]
    assert len(outs) == 4 and all(len(o) == 6 for o in outs), outs
    cfg = configs.get("zamba2-2.7b", smoke=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 24, dtype=np.int32)
               for _ in outs]
    params = T.init_params(cfg, 0, torch.float32, "cpu")
    tokens = torch.from_numpy(np.stack(prompts).astype(np.int64))
    live = [True] * len(outs)
    with torch.no_grad():
        for j in range(6):
            logits, _ = T.forward(params, cfg, tokens)
            last = logits[:, -1]
            want = L.vocab_argmax(last).tolist()
            top2 = last.topk(2).values
            for i, o in enumerate(outs):
                if live[i]:
                    assert o[j] == want[i], (i, j, o, want[i])
                    live[i] = float(top2[i, 0] - top2[i, 1]) > 1e-3
            tokens = torch.cat([tokens, torch.tensor(
                [[o[j]] for o in outs])], 1)
    assert all(live), "a close call left a request unchecked"


CHECKS = {"serve_lm_torch": greedy_by_full_forward}


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
    if name in CHECKS:
        CHECKS[name](out.stdout)
