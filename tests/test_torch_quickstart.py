"""repro_torch.quickstart at a reduced N prints the same fully=/partly=
line counts as examples/quickstart.py run at the same N."""
import importlib.util
import re
from pathlib import Path

import numpy as np

from repro_torch import quickstart

N = 3000
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "quickstart.py"


def _counts(text):
    return re.findall(r"^(\w+)\s+fully=\s*(\d+) lines\s+partly=\s*(\d+)",
                      text, re.M)


def test_quickstart_line_counts_match_reference(capsys, monkeypatch):
    quickstart.main(["--n", str(N), "--device", "cpu"])
    port = _counts(capsys.readouterr().out)
    # the line counts exclude snapshot and sidecar lines, so the
    # reference's env-default axes cannot move them; off is just faster
    monkeypatch.setenv("REPRO_SNAPSHOT", "0")
    monkeypatch.setenv("REPRO_INTEGRITY", "0")
    spec = importlib.util.spec_from_file_location("quickstart_ref", EXAMPLE)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    ref.N = N
    ref.rng = np.random.default_rng(0)
    for kind in ("dll", "bptree", "hashmap"):
        ref.demo(kind)
    want = _counts(capsys.readouterr().out)
    assert [k for k, _, _ in port] == ["dll", "bptree", "hashmap"]
    assert port == want
