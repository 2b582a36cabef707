"""The port stands alone: it imports neither jax nor any module of the
reference package, so it runs where jax is not installed."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

# `import jax`, `from jax...`, `import repro`, `from repro...` — but not
# the port's own `repro_torch`
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?![A-Za-z0-9_])", re.M)

_MINE = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
from repro_torch.data.baskets import BasketConfig, generate_baskets
from repro_torch.pipeline import MarketBasketPipeline, PipelineConfig
T = generate_baskets(BasketConfig(n_tx=300, n_items=24, seed=5))
res = MarketBasketPipeline(config=PipelineConfig(
    min_support=0.05, n_tiles=4, device="cpu")).run(T)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro")
             and sys.modules[m] is not None)
assert not bad, bad
print("MINED", len(res.supports), len(res.rules), res.report.backend)
"""


def test_port_mines_with_jax_and_reference_blocked():
    out = subprocess.run([sys.executable, "-c", _MINE], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    tag, n_sup, n_rules, backend = out.stdout.split()[-4:]
    assert tag == "MINED" and int(n_sup) > 0 and backend == "ref"


def test_no_source_imports_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = {str(f.relative_to(ROOT)): _FORBIDDEN.findall(f.read_text())
                 for f in files}
    assert not {f: m for f, m in offenders.items() if m}
