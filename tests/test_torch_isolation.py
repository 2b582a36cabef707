"""The port stands alone: it imports neither jax nor any module of the
reference package (nor msgpack, which the card's machine lacks), so it
runs where they are not installed."""
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

# the port writes its checkpoints with its own msgpack codec
_NO_MSGPACK = re.compile(r"^\s*(?:import|from)\s+msgpack(?![A-Za-z0-9_])",
                         re.M)

_MINE = r"""
import sys
import tempfile
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
sys.modules["msgpack"] = None
from repro_torch.data.baskets import BasketConfig, generate_baskets
from repro_torch.mining import make_miner
from repro_torch.pipeline import MarketBasketPipeline, PipelineConfig
from repro_torch.serving import (Query, RecommendationEngine, RuleIndex,
                                 ServingConfig)
T = generate_baskets(BasketConfig(n_tx=300, n_items=24, seed=5))
res = MarketBasketPipeline(config=PipelineConfig(
    min_support=0.05, n_tiles=4, device="cpu")).run(T)
engine = RecommendationEngine(RuleIndex.build(res.rules, T.shape[1]),
                              config=ServingConfig(device="cpu"))
recs, rep = engine.serve([Query.of(row) for row in T[:16]])
for algorithm in ("eclat", "auto"):
    miner, choice = make_miner(T, config=PipelineConfig(
        min_support=0.05, n_tiles=4, device="cpu", algorithm=algorithm))
    mined = miner.run(T)
    assert mined.supports == res.supports and mined.rules == res.rules
    assert (choice is None) == (algorithm == "eclat")
    print("ALGORITHM", algorithm, mined.report.algorithm)
from repro_torch.mining import SONConfig
with tempfile.TemporaryDirectory() as wd:
    son, _ = make_miner(T, config=PipelineConfig(
        min_support=0.05, n_tiles=4, device="cpu"),
        son=SONConfig(workdir=wd + "/son", partition_rows=100))
    mined = son.run(T)
    assert mined.supports == res.supports and mined.rules == res.rules
    index = RuleIndex.build(res.rules, T.shape[1])
    index.save(wd + "/index")
    assert RuleIndex.load(wd + "/index").same_arrays(index)
    print("SON", mined.report.n_partitions, mined.report.checkpoint_saves)
import datetime
import torch.distributed as dist
from repro_torch.distributed.fault import FaultEvent, FaultPlan
from repro_torch.distributed.mining import ShardedMiner, make_shard_mesh
from repro_torch.mining import SONMiner
with tempfile.TemporaryDirectory() as wd:
    dist.init_process_group("gloo", init_method=f"file://{wd}/store", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_shard_mesh()
        cfg = PipelineConfig(min_support=0.05, n_tiles=4, device="cpu")
        sharded = ShardedMiner(mesh=mesh, config=cfg).run(
            T, FaultPlan([FaultEvent(2, "straggler", 0, 2.0)]))
        assert sharded.supports == res.supports
        assert sharded.rules == res.rules
        son = SONMiner(config=cfg, mesh=mesh, son=SONConfig(
            workdir=wd + "/son", partition_rows=100)).run(T)
        assert son.supports == res.supports and son.rules == res.rules
        print("SHARDED", sharded.report.n_shards, sharded.report.replans,
              son.report.n_partitions)
    finally:
        dist.destroy_process_group()
from repro_torch.data.baskets import stationary_baskets
from repro_torch.launch.stream import stream
from repro_torch.streaming import (StreamingConfig, StreamingMiner,
                                   TransactionStream)
S = stationary_baskets(768, 32, n_patterns=4, seed=5)
cfg = StreamingConfig(window=256, batch_size=64, min_support=0.15,
                      n_tiles=4, device="cpu")
engine = RecommendationEngine(RuleIndex.build([], 32),
                              config=ServingConfig(k=3, device="cpu"))
streamer = StreamingMiner(32, config=cfg, engine=engine)
srep = streamer.run(TransactionStream(S, 64), max_batches=6)
once = MarketBasketPipeline(config=cfg.pipeline_config()).run(
    streamer.window.rows_raw())
assert streamer.supports == once.supports and streamer.rules == once.rules
assert engine.index is streamer.index
print("STREAM", srep.n_batches, srep.backend, streamer.index.version > 0)
miner, _ = stream(n_tx=512, n_items=24, window=128, batch=64, batches=4,
                  device="cpu")
print("STREAM CLI", miner.window.n)
from repro_torch.launch.autotune import autotune
with tempfile.TemporaryDirectory() as wd:
    tuned = autotune(out=wd + "/tune.json", smoke=True, device="cpu",
                     log=lambda line: None)
cm = MarketBasketPipeline(config=PipelineConfig(
    min_support=0.05, n_tiles=4, device="cpu", policy="costmodel")).run(T)
assert cm.supports == res.supports and cm.rules == res.rules
print("AUTOTUNE", len(tuned), sorted({p.cost_source
                                      for p in cm.report.ledger.phases}))
from repro_torch.core.itemsets import apriori
from repro_torch.launch.mine import mine
from repro_torch.launch.recommend import recommend
ap = apriori(T, 15, n_tiles=4, device="cpu", use_kernel=True)
assert ap.supports == res.supports
cli = mine(n_tx=300, n_items=24, min_support=0.05, n_tiles=4, seed=5, top=0,
           algorithm="auto", device="cpu")
assert cli.supports == res.supports and cli.rules == res.rules
served, srep = recommend(n_tx=300, n_items=24, min_support=0.05, seed=5,
                         n_queries=64, use_async=True, device="cpu")
print("CLIS", ap.levels, len(served), srep.n_completed)
import numpy as np
import torch
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import serve_demo
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import transformer as T
cfg = get_config("gemma3-1b", smoke=True)
params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 24)))
logits = make_prefill_step(cfg)(params, {"tokens": toks})
assert logits.shape == (2, cfg.vocab_size) and bool(logits.isfinite().all())
out = serve_demo("gemma3-1b", batch=2, prompt_len=8, new_tokens=4,
                 device="cpu")
print("SERVED", out["tokens"].shape)
cfg = get_config("hymba-1.5b", smoke=True)
params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
logits = make_prefill_step(cfg)(params, {"tokens": toks})
assert logits.shape == (2, cfg.vocab_size) and bool(logits.isfinite().all())
print("HYBRID", tuple(logits.shape))
cfg = get_config("rwkv6-7b", smoke=True)
params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
logits = make_prefill_step(cfg)(params, {"tokens": toks})
assert logits.shape == (2, cfg.vocab_size) and bool(logits.isfinite().all())
print("RWKV", tuple(logits.shape))
for arch in ("granite-3-8b", "dbrx-132b", "deepseek-v2-236b",
             "internvl2-26b", "musicgen-large"):
    cfg = get_config(arch, smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": toks % cfg.vocab_size}
    if cfg.frontend == "vision":
        batch["vision_embeds"] = torch.randn(2, cfg.n_vision_tokens,
                                             cfg.d_model)
    if cfg.frontend == "audio":
        batch = {"frames": torch.randn(2, 24, cfg.d_model)}
    logits = make_prefill_step(cfg)(params, batch)
    assert bool(logits.isfinite().all())
    out = serve_demo(arch, batch=2, prompt_len=4, new_tokens=2, device="cpu")
    print("FAMILY", arch, tuple(logits.shape), out["tokens"].shape)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack")
             and sys.modules[m] is not None)
assert not bad, bad
print("MINED", len(res.supports), len(res.rules), res.report.backend,
      sum(map(len, recs)), rep.backend)
"""


def test_port_mines_with_jax_and_reference_blocked():
    out = subprocess.run([sys.executable, "-c", _MINE], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    algos = [ln.split()[1:] for ln in out.stdout.splitlines()
             if ln.startswith("ALGORITHM")]
    assert algos[0] == ["eclat", "eclat"] and algos[1][0] == "auto"
    assert "SERVED (2, 4)" in out.stdout
    assert "HYBRID (2, 512)" in out.stdout
    assert "RWKV (2, 512)" in out.stdout
    for line in ("granite-3-8b (2, 256) (2, 2)", "dbrx-132b (2, 512) (2, 2)",
                 "deepseek-v2-236b (2, 512) (2, 2)",
                 "internvl2-26b (2, 512) (2, 2)",
                 "musicgen-large (2, 2, 64) (2, 2, 2)"):
        assert f"FAMILY {line}" in out.stdout
    assert "SON 3 6" in out.stdout
    assert "SHARDED 1 1 3" in out.stdout
    assert "STREAM 6 ref True" in out.stdout
    assert "STREAM CLI 128" in out.stdout
    assert "AUTOTUNE 3 ['roofline']" in out.stdout
    assert "CLIS 3 64 64" in out.stdout
    tag, n_sup, n_rules, backend, n_recs, serving = out.stdout.split()[-6:]
    assert tag == "MINED" and int(n_sup) > 0 and backend == "ref"
    assert int(n_recs) > 0 and serving == "ref"


def test_no_source_imports_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py"]
    assert len(files) > 20
    for part in ("models", "configs", "launch", "kernels/flash_attention",
                 "kernels/selective_scan", "kernels/rwkv6_wkv", "checkpoint",
                 "mining", "streaming", "kernels/autotune", "distributed"):
        assert PORT / part / "__init__.py" in files
    for module in ("checkpoint/store.py", "mining/son.py",
                   "streaming/source.py", "streaming/miner.py",
                   "launch/common.py", "launch/stream.py",
                   "data/sharding.py", "distributed/fault.py",
                   "distributed/mining.py", "distributed/ranks.py",
                   "launch/mine.py", "launch/recommend.py",
                   "models/moe.py", "models/stubs.py",
                   "configs/deepseek_v2_236b.py"):
        assert PORT / module in files
    offenders = {str(f.relative_to(ROOT)): _FORBIDDEN.findall(f.read_text())
                 + _NO_MSGPACK.findall(f.read_text()) for f in files}
    assert not {f: m for f, m in offenders.items() if m}
