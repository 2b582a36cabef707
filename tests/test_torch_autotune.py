"""The port's autotune plane and cost-model policy, held against the
reference's (the mirror of ``tests/test_autotune.py`` and of
``tests/test_runtime.py``'s costmodel cases):

* the cache round-trips byte for byte, both packages save the same
  entries to the same JSON (bar the refresh command each names) and each
  loads the other's file; buckets and exact-then-nearest lookups agree;
* a cold/corrupt cache degrades to the roofline-seeded default
  (``packed`` at every lattice shape) without raising;
* the sweep verifies every candidate bit-identical to the plain oracle and
  picks the argmin of the *measured* costs (a scripted timer here: the
  card's sweep runs in ``test_torch_autotune_card.py`` and
  ``chip_smoke.py``); ``make_inputs`` draws the reference's bytes and the
  oracles agree;
* ``CostModelPolicy.from_autotune`` gives exactly the reference's rates
  and ``tile_costs`` its arrays; the autotune-fed plan differs from the
  constants' plan; every ``PhaseRecord`` says where its costs came from;
  every plane takes ``policy="costmodel"`` by name (autotune-fed under a
  patched default cache, the constants with ``autotune=False``) and as an
  instance.

Cross-package comparisons under ``costmodel`` hand both packages policies
built from equal inputs (:func:`costmodel_pair`): by name, the reference
on the CPU reads its own ``|cpu`` cache entries and the data-sheet
constants of a TPU, the port the H100's.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.hetero import HeterogeneityProfile as RefProfile  # noqa: E402
from repro.core.scheduler import TaskSpec as RefTaskSpec  # noqa: E402
from repro.data.baskets import BasketConfig as RefBasketConfig  # noqa: E402
from repro.data.baskets import generate_baskets as ref_generate  # noqa: E402
from repro.kernels.autotune.cache import (  # noqa: E402
    AutotuneCache as RefCache)
from repro.kernels.autotune.cache import (  # noqa: E402
    shape_bucket as ref_shape_bucket)
from repro.kernels.autotune.tuner import (  # noqa: E402
    make_inputs as ref_make_inputs)
from repro.kernels.autotune.tuner import oracle as ref_oracle  # noqa: E402
from repro.mining import AlgorithmCostModel as RefCostModel  # noqa: E402
from repro.mining import select_algorithm as ref_select  # noqa: E402
from repro.runtime import CostModelPolicy as RefPolicy  # noqa: E402
from repro.runtime import Runtime as RefRuntime  # noqa: E402
from repro_torch.core.hetero import HeterogeneityProfile  # noqa: E402
from repro_torch.core.scheduler import TaskSpec  # noqa: E402
from repro_torch.data.baskets import BasketConfig, generate_baskets  # noqa: E402
from repro_torch.kernels.autotune import cache as cache_mod  # noqa: E402
from repro_torch.kernels.autotune.cache import (  # noqa: E402
    AutotuneCache, default_cache, device_kind, resolve_config, shape_bucket)
from repro_torch.kernels.autotune.tuner import (  # noqa: E402
    make_inputs, oracle, run_config, standard_shapes, tune, tune_into)
from repro_torch.kernels.rule_match import ops as rm_ops  # noqa: E402
from repro_torch.kernels.support_count import ops  # noqa: E402
from repro_torch.kernels.support_count.ref import (  # noqa: E402
    support_count_ref)
from repro_torch.launch.tuning import (TUNABLE_KERNELS,  # noqa: E402
                                       default_config, estimate_cost_us,
                                       kernel_candidates, seed_order,
                                       shape_flops_bytes)
from repro_torch.mining import (AlgorithmCostModel, EclatMiner,  # noqa: E402
                                SONConfig, SONMiner, select_algorithm)
from repro_torch.pipeline import (MarketBasketPipeline,  # noqa: E402
                                  PipelineConfig)
from repro_torch.runtime import (CostModelPolicy, MeasuredPhase,  # noqa: E402
                                 Runtime, StaticPolicy, autotuned_costmodel,
                                 resolve_policy)
from repro_torch.serving import (RecommendationEngine,  # noqa: E402
                                 RuleIndex, ServingConfig)
from repro_torch.streaming import StreamingConfig, StreamingMiner  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SC_SMOKE = (64, 128, 128)       # 2 candidates at this shape: one per variant
SMOKE = {"support_count": SC_SMOKE, "intersect_count": (128, 128),
         "rule_match": (8, 128, 128)}
# one measured entry per kernel, the walls the planes' policies are fed
MEASURED = {"support_count": ((1024, 2048, 128), 4000.0),
            "intersect_count": ((512, 128), 30.0),
            "rule_match": ((64, 512, 128), 50.0)}


def measured_caches(kernels=TUNABLE_KERNELS, device="cpu"):
    """(reference cache, port cache) holding the same measured entries."""
    ref, port = RefCache(), AutotuneCache()
    for kernel in kernels:
        shape, wall_us = MEASURED[kernel]
        for c in (ref, port):
            c.put(kernel, shape, {"variant": "packed"}, wall_us,
                  device=device)
    return ref, port


def costmodel_pair(kernel):
    """Equal cost-model policies for the two packages: each built by its
    own ``from_autotune`` on caches with the same measured entry."""
    ref, port = measured_caches((kernel,))
    return (RefPolicy.from_autotune(ref, kernel, device="cpu"),
            CostModelPolicy.from_autotune(port, kernel, device="cpu"))


# ---------------------------------------------------------------------------
# cache round-trip + lookup
# ---------------------------------------------------------------------------

def test_cache_roundtrip_byte_identical_across_packages(tmp_path):
    files = {}
    for name, cache in zip(("ref", "port"), (RefCache(), AutotuneCache())):
        cfg = {"variant": "packed"}
        cache.put("support_count", SC_SMOKE, cfg, 123.456,
                  swept=[{"config": cfg, "cost_us": 123.456,
                          "matched": True}], device="cpu")
        cache.put("rule_match", (8, 128, 128), {"variant": "mxu"}, 55.5,
                  device="cpu")
        cache.put("intersect_count", (300, 100), cfg, 7.25, device="cpu")
        files[name] = str(tmp_path / f"{name}.json")
        cache.save(files[name])
        resave = str(tmp_path / f"{name}_resave.json")
        type(cache).load(files[name]).save(resave)
        with open(files[name]) as a, open(resave) as b:
            assert a.read() == b.read()         # byte-identical re-save
    with open(files["ref"]) as a, open(files["port"]) as b:
        ref_text, port_text = a.read(), b.read()
    # the same bytes but for the refresh command each package names
    assert "python -m repro_torch.launch.autotune" in port_text
    assert port_text.replace("repro_torch.launch", "repro.launch") \
        == ref_text
    # each package loads the other's file
    assert AutotuneCache.load(files["ref"]).entries == \
        RefCache.load(files["port"]).entries == \
        RefCache.load(files["ref"]).entries


def test_bucket_and_lookup_agree_with_reference():
    rng = np.random.default_rng(7)
    ref, port = RefCache(), AutotuneCache()
    for kernel, ndim in (("support_count", 3), ("intersect_count", 2),
                         ("rule_match", 3)):
        for _ in range(5):
            shape = tuple(int(d) for d in rng.integers(1, 5000, ndim))
            cfg = {"variant": "packed" if rng.random() < 0.5 else "mxu"}
            cost = float(rng.random() * 100)
            ref.put(kernel, shape, cfg, cost, device="cpu")
            port.put(kernel, shape, cfg, cost, device="cpu")
        for _ in range(40):
            shape = tuple(int(d) for d in rng.integers(1, 20000, ndim))
            assert shape_bucket(kernel, shape) == \
                ref_shape_bucket(kernel, shape)
            assert port.lookup(kernel, shape, "cpu") == \
                ref.lookup(kernel, shape, "cpu")
    assert port.entries == ref.entries


def test_lookup_exact_then_nearest_bucket():
    cache = AutotuneCache()
    cfg = {"variant": "mxu"}
    cache.put("support_count", SC_SMOKE, cfg, 10.0, device="cpu")
    # exact bucket, and a different shape rounding into the same bucket
    assert cache.lookup("support_count", SC_SMOKE, "cpu")["config"] == cfg
    assert shape_bucket("support_count", (50, 100, 100)) \
        == shape_bucket("support_count", SC_SMOKE)
    assert cache.lookup("support_count", (50, 100, 100), "cpu")["config"] \
        == cfg
    # far-away shape: nearest-bucket fallback still serves the one entry
    assert cache.lookup("support_count", (4096, 8192, 256),
                        torch.device("cpu"))["config"] == cfg
    # but never across device kinds or kernels
    assert cache.lookup("support_count", SC_SMOKE,
                        "NVIDIA_H100_80GB_HBM3") is None
    assert cache.lookup("rule_match", (8, 128, 128), "cpu") is None


def test_device_kind_tokens():
    assert device_kind("cpu") == device_kind(torch.device("cpu")) == "cpu"
    assert device_kind("NVIDIA_H100_80GB_HBM3") == "NVIDIA_H100_80GB_HBM3"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_kind("cuda:0")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_kind(None)                # the card is the default


# ---------------------------------------------------------------------------
# degradation: cold / corrupt caches fall back to roofline defaults
# ---------------------------------------------------------------------------

def test_cold_and_corrupt_cache_degrade(tmp_path):
    missing = AutotuneCache.load(str(tmp_path / "absent.json"))
    assert missing.load_error is not None and len(missing) == 0

    bad = tmp_path / "bad.json"
    bad.write_text("{this is not json")
    corrupt = AutotuneCache.load(str(bad))
    assert corrupt.load_error is not None and "corrupt" in corrupt.load_error
    assert len(corrupt) == 0

    schema = tmp_path / "schema.json"
    schema.write_text(json.dumps({"entries": {"k": {"shape": [1, 2, 3]}}}))
    assert AutotuneCache.load(str(schema)).load_error is not None

    # the resolver degrades to the roofline-seeded default, never raises
    want = default_config("support_count", SC_SMOKE)
    assert want == {"variant": "packed"}
    assert resolve_config("support_count", SC_SMOKE, corrupt, "cpu") == want
    assert resolve_config("support_count", SC_SMOKE, False, "cpu") == want
    pin = {"variant": "mxu"}
    got = resolve_config("support_count", SC_SMOKE, pin, "cpu")
    assert got == pin and got is not pin     # pinned dicts pass through, copied

    # and the wrapper itself still counts (correctly) off a cold cache
    rng = np.random.default_rng(3)
    T = (rng.random((32, 64)) < 0.3).astype(np.uint8)
    C = (rng.random((8, 64)) < 0.1).astype(np.uint8)
    np.testing.assert_array_equal(
        ops.support_count(torch.from_numpy(T), torch.from_numpy(C),
                          tuning=corrupt).numpy(),
        support_count_ref(torch.from_numpy(T), torch.from_numpy(C)).numpy())


def test_autotuned_costmodel_degrades_to_roofline():
    pol = autotuned_costmodel("support_count", cache=AutotuneCache(),
                              device="cpu")
    assert isinstance(pol, CostModelPolicy)
    assert pol.cost_source == "roofline"     # constants, not measurements
    # without a card (or with one the cache has no entries for) as well
    assert autotuned_costmodel("rule_match", cache=AutotuneCache(),
                               device="cuda").cost_source == "roofline"
    with pytest.raises(ValueError):
        CostModelPolicy.from_autotune(AutotuneCache(), "support_count",
                                      device="cpu")
    model = AlgorithmCostModel.from_autotune(AutotuneCache(), device="cpu")
    assert model.kernel_rates == {} and set(model.cost_source.values()) \
        == {"roofline"}


# ---------------------------------------------------------------------------
# the sweep: bit-identical configs only, argmin of measured cost
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", TUNABLE_KERNELS)
def test_sweep_over_plain_versions_matches_oracle(kernel):
    res = tune(kernel, SMOKE[kernel], reps=3, device="cpu")
    assert res.device == "cpu" and res.swept
    assert all(s.matched for s in res.swept), \
        [s.config for s in res.swept if not s.matched]
    best = min((s for s in res.swept if s.matched), key=lambda s: s.cost_us)
    assert res.best == best.config and res.cost_us == best.cost_us
    variants = {s.config["variant"] for s in res.swept}
    assert variants == ({"packed"} if kernel == "intersect_count"
                        else {"mxu", "packed"})   # every variant swept


def test_tune_picks_argmin_of_measured_cost():
    """Scripted timer: the sweep must pick whichever config *measures*
    cheapest, not the roofline favourite (candidate order)."""
    cands = seed_order("support_count", SC_SMOKE,
                       kernel_candidates("support_count", SC_SMOKE))
    assert [c["variant"] for c in cands] == ["packed", "mxu"]
    walls = [10.0, 1.0]                      # seconds per rep, per config
    ticks = []
    for ci, wall in enumerate(walls):        # 3 reps x 2 timer calls each
        t = 1e6 * ci
        for _ in range(3):
            ticks.extend([t, t + wall])
            t += wall
    it = iter(ticks)
    res = tune("support_count", SC_SMOKE, configs=cands, reps=3,
               timer=lambda: next(it), device="cpu")
    assert res.best == cands[1]
    assert res.cost_us == pytest.approx(1.0e6)       # 1 s in us
    assert [s.cost_us for s in res.swept] \
        == [pytest.approx(10.0e6), pytest.approx(1.0e6)]


def test_tune_raises_when_no_config_matches(monkeypatch):
    from repro_torch.kernels.autotune import tuner
    monkeypatch.setattr(tuner, "run_config",
                        lambda kernel, cfg, inputs: torch.zeros((1, 1)))
    with pytest.raises(RuntimeError, match="no candidate matched"):
        tune("support_count", SC_SMOKE, device="cpu")


def test_tune_into_writes_audited_entries():
    cache = AutotuneCache()
    results = tune_into(cache, "support_count", shapes=[SC_SMOKE], reps=3,
                        device="cpu")
    assert len(results) == 1 and len(cache) == 1
    ent = cache.lookup("support_count", SC_SMOKE, "cpu")
    assert ent["config"] == results[0].best
    assert ent["source"] == "measured" and ent["shape"] == list(SC_SMOKE)
    assert [s["config"]["variant"] for s in ent["swept"]] == \
        ["packed", "mxu"]
    assert all(s["matched"] for s in ent["swept"])   # full sweep audited
    # the resolver serves this cache's winner when handed the cache
    assert resolve_config("support_count", SC_SMOKE, cache, "cpu") \
        == ent["config"]


def test_standard_shapes_smoke_is_tiny():
    for kernel in TUNABLE_KERNELS:
        full = standard_shapes(kernel)
        assert standard_shapes(kernel, smoke=True) == [SMOKE[kernel]]
        assert len(full) > 1
        assert len({shape_bucket(kernel, s) for s in full}) == len(full)


@pytest.mark.parametrize("kernel", TUNABLE_KERNELS)
@pytest.mark.parametrize("seed", [0, 5])
def test_make_inputs_and_oracle_are_the_references(kernel, seed):
    shape = SMOKE[kernel]
    got = make_inputs(kernel, shape, seed=seed)
    want = ref_make_inputs(kernel, shape, seed=seed)
    assert sorted(got) == sorted(want)
    for name, x in got.items():
        w = np.asarray(want[name])
        assert tuple(x.shape) == w.shape and x.numpy().tobytes() \
            == w.tobytes(), name
    ref_out = np.asarray(ref_oracle(kernel, want))
    out = oracle(kernel, got)
    assert out.numpy().dtype == ref_out.dtype
    np.testing.assert_array_equal(out.numpy(), ref_out)
    for cfg in kernel_candidates(kernel, shape):
        np.testing.assert_array_equal(run_config(kernel, cfg, got).numpy(),
                                      ref_out)


def test_default_config_is_packed_on_every_lattice_shape():
    shapes = {k: standard_shapes(k) + standard_shapes(k, smoke=True)
              for k in TUNABLE_KERNELS}
    # the shapes PERF's kernel table times (a [3,128]-row tile at each
    # round's candidates; the rule-match buckets against the mined index
    # and the wide one; the Eclat tiles)
    shapes["support_count"] += [(3128, 2176, 1024), (3128, 256, 1024),
                                (3128, 128, 1024), (1000, 2432, 1024),
                                (8, 256, 1024)]
    shapes["rule_match"] += [(64, 896, 1024), (8, 896, 1024),
                             (64, 16384, 1024)]
    shapes["intersect_count"] += [(128, 3200), (2176, 3200), (640, 2816)]
    for kernel, lattice in shapes.items():
        for shape in lattice:
            assert default_config(kernel, shape) == {"variant": "packed"}, \
                (kernel, shape)
            costs = {c["variant"]: estimate_cost_us(kernel, shape, c)
                     for c in kernel_candidates(kernel, shape)}
            assert all(c > 1.9 for c in costs.values())   # the launch floor
    with pytest.raises(ValueError, match="unknown tunable kernel"):
        kernel_candidates("flash_attention", (1, 1, 1))


# ---------------------------------------------------------------------------
# the ops wrappers dispatch on what the cache says
# ---------------------------------------------------------------------------

def _recording(monkeypatch, module, names):
    calls = []
    for name in names:
        real = getattr(module, name)

        def fake(*args, _real=real, _name=name):
            calls.append(_name)
            return _real(*args)
        monkeypatch.setattr(module, name, fake)
    return calls


def test_support_count_dispatch_follows_the_cache(monkeypatch):
    calls = _recording(monkeypatch, ops, ("support_count_packed",
                                          "support_count_int8"))
    rng = np.random.default_rng(1)
    T = torch.from_numpy((rng.random((50, 100)) < 0.3).astype(np.uint8))
    C = torch.from_numpy((rng.random((9, 100)) < 0.05).astype(np.uint8))
    want = support_count_ref(T, C)
    mxu = AutotuneCache()
    mxu.put("support_count", (56, 128, 128), {"variant": "mxu"}, 1.0,
            device="cpu")
    for tuning, variant in ((None, "support_count_packed"),
                            (False, "support_count_packed"),
                            (mxu, "support_count_int8"),
                            ({"variant": "mxu"}, "support_count_int8"),
                            ({"variant": "packed"}, "support_count_packed")):
        calls.clear()
        assert torch.equal(ops.support_count(T, C, tuning=tuning), want)
        assert calls == [variant], tuning
    for bad in ({"variant": "bogus"}, {"bn": 256}, "packed", True):
        with pytest.raises(ValueError):
            ops.support_count(T, C, tuning=bad)
    with pytest.raises(ValueError):
        ops.intersect_count(T[:, :4].to(torch.int32),
                            T[:, :4].to(torch.int32),
                            tuning={"variant": "mxu"})


def test_rule_topk_dispatch_follows_the_cache(monkeypatch):
    calls = _recording(monkeypatch, rm_ops, ("rule_scores_fused",
                                             "rule_scores_int8"))
    rng = np.random.default_rng(2)
    Q = torch.from_numpy((rng.random((5, 64)) < 0.3).astype(np.uint8))
    A = torch.from_numpy((rng.random((20, 64)) < 0.05).astype(np.uint8))
    sizes = A.sum(dim=1).to(torch.float32)
    conf = torch.from_numpy(rng.random(20).astype(np.float32))
    cons = torch.from_numpy(rng.integers(0, 64, 20).astype(np.int32))
    mxu = AutotuneCache()
    mxu.put("rule_match", (8, 128, 128), {"variant": "mxu"}, 1.0,
            device="cpu")
    want = rm_ops.rule_topk(Q, A, sizes, conf, cons, k=3, n_items=64,
                            backend="ref")
    assert calls == []                       # the plain oracle
    for tuning, variant in ((None, "rule_scores_fused"),
                            (False, "rule_scores_fused"),
                            (mxu, "rule_scores_int8"),
                            ({"variant": "mxu"}, "rule_scores_int8")):
        calls.clear()
        got = rm_ops.rule_topk(Q, A, sizes, conf, cons, k=3, n_items=64,
                               backend="cuda", tuning=tuning)
        assert calls == [variant], tuning
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        rm_ops.rule_topk(Q, A, sizes, conf, cons, k=3, n_items=64,
                         tuning={"variant": "bogus"})


# ---------------------------------------------------------------------------
# the feedback loop: measured costs reach the scheduler + the ledger
# ---------------------------------------------------------------------------

def test_from_autotune_rates_are_the_references():
    rng = np.random.default_rng(4)
    ref, port = RefCache(), AutotuneCache()
    for n in (64, 256, 1024):
        for m in (128, 512, 2048):
            wall = float(rng.random() * 5000 + 1)
            for c in (ref, port):
                c.put("support_count", (n, m, 128), {"variant": "packed"},
                      wall, device="cpu")
    got = CostModelPolicy.from_autotune(port, "support_count", device="cpu")
    want = RefPolicy.from_autotune(ref, "support_count", device="cpu")
    assert got.cost_source == want.cost_source == "autotune"
    assert (got.peak_flops, got.hbm_bw, got.flops_per_byte) == \
        (want.peak_flops, want.hbm_bw, want.flops_per_byte)
    flops, bytes_ = shape_flops_bytes("support_count", (1024, 2048, 128))
    one = CostModelPolicy.from_autotune(
        measured_caches(("support_count",))[1], "support_count",
        device="cpu")
    assert one.peak_flops == pytest.approx(flops / 4000e-6)
    assert one.hbm_bw == pytest.approx(bytes_ / 4000e-6)
    assert one.flops_per_byte == pytest.approx(flops / bytes_)


def test_algorithm_model_from_autotune_is_the_references():
    ref, port = measured_caches()
    got = AlgorithmCostModel.from_autotune(port, device="cpu")
    want = RefCostModel.from_autotune(ref)   # the reference's device: cpu
    assert got.kernel_rates == want.kernel_rates
    assert got.cost_source == want.cost_source
    assert set(got.cost_source.values()) == {"autotune"}
    kw = dict(n_tx=2048, n_items=64, seed=1)
    T = generate_baskets(BasketConfig(**kw))
    assert T.tobytes() == ref_generate(RefBasketConfig(**kw)).tobytes()
    a = select_algorithm(T, 40, model=got)
    b = ref_select(T, 40, model=want)
    assert (a.algorithm, a.est_cost_s, a.cost_source) == \
        (b.algorithm, b.est_cost_s, b.cost_source)
    # the default model on the CPU: the port's cache holds no cpu entries
    assert set(select_algorithm(T, 40, device="cpu").cost_source.values()) \
        == {"roofline"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_costs_are_the_references(seed):
    rng = np.random.default_rng(seed)
    kw = dict(peak_flops=float(rng.random() * 1e13 + 1e9),
              hbm_bw=float(rng.random() * 1e11 + 1e8),
              flops_per_byte=float(rng.random() * 50))
    port, ref = CostModelPolicy(**kw), RefPolicy(**kw)
    tiles = rng.random(16) * 1e6
    flops = rng.random(16) * 1e9
    for args in ((tiles, flops), (tiles, None), (np.zeros(4), None)):
        got = port.tile_costs(None, None, *args)
        want = ref.tile_costs(None, None, *args)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_costmodel_seeds_from_tile_flops():
    profile = HeterogeneityProfile.paper()
    policy = CostModelPolicy(peak_flops=1e12, hbm_bw=1e9)
    rt = Runtime(profile, policy=policy, power="none")
    bytes_ = np.full(8, 1e6)
    # tile 0 is violently compute-bound; the rest are memory-bound
    flops = np.array([1e12] + [1.0] * 7)
    seeded = policy.tile_costs(rt, None, bytes_, flops)
    assert seeded.sum() == pytest.approx(bytes_.sum())   # same work total
    assert seeded[0] > seeded[1] * 100                   # intensity skew
    # uniform intensity degenerates to the byte seeding
    flat = policy.tile_costs(rt, None, bytes_, bytes_ * 2.0)
    np.testing.assert_allclose(flat, bytes_)


def test_costmodel_phase_assignment_is_the_references():
    bytes_ = np.full(8, 1e6)
    flops = np.array([1e12] + [1.0] * 7)
    plans = {}
    for name, rt, task in (
            ("port", Runtime(HeterogeneityProfile.paper(),
                             policy=CostModelPolicy(peak_flops=1e12,
                                                    hbm_bw=1e9),
                             power="none"),
             TaskSpec("t", float(bytes_.sum()), parallel=True, n_tiles=8)),
            ("ref", RefRuntime(RefProfile.paper(),
                               policy=RefPolicy(peak_flops=1e12, hbm_bw=1e9),
                               power="none"),
             RefTaskSpec("t", float(bytes_.sum()), parallel=True,
                         n_tiles=8))):
        asg, rec = rt.run_phase(task, lambda a, c: MeasuredPhase(result=a),
                                tile_costs=bytes_, tile_flops=flops)
        plans[name] = (asg.tiles_of, rec.policy, rec.cost_source)
    assert plans["port"] == plans["ref"]
    # the compute-bound tile lands alone on the fastest core
    assert plans["port"][0][3] == [0]


def test_from_hlo_is_not_ported_and_names_resolve():
    with pytest.raises(NotImplementedError, match="HLO"):
        CostModelPolicy.from_hlo("HloModule m")
    assert isinstance(resolve_policy("costmodel"), CostModelPolicy)
    assert resolve_policy("costmodel").cost_source == "roofline"
    with pytest.raises(ValueError, match="unknown"):
        resolve_policy("nope")


def test_autotune_fed_costs_change_the_plan():
    """Same tiles, same byte estimates: the autotune-seeded policy must
    produce a different cost distribution — and a different LPT plan on
    the paper's heterogeneous profile — than the data-sheet constants."""
    profile = HeterogeneityProfile.paper()
    const = CostModelPolicy()
    tuned = CostModelPolicy.from_autotune(
        measured_caches(("support_count",))[1], "support_count",
        device="cpu")
    ridge_c = const.peak_flops / const.hbm_bw
    ridge_t = tuned.peak_flops / tuned.hbm_bw
    assert ridge_c != pytest.approx(ridge_t)
    mid = float(np.sqrt(ridge_c * ridge_t))
    tile_bytes = np.array([1e6, 0.9e6, 0.8e6, 0.7e6])
    tile_flops = np.array([mid * 1e6, 0.0, 0.0, 0.0])
    task = TaskSpec("count_tiles", cost=float(tile_bytes.sum()), n_tiles=4)

    plans = {}
    for name, pol in (("const", const), ("tuned", tuned)):
        rt = Runtime(profile, policy=pol)
        costs = pol.tile_costs(rt, task, tile_bytes, tile_flops)
        assert costs.sum() == pytest.approx(tile_bytes.sum())  # renormalized
        asg, _, _ = pol.plan(rt, task, costs)
        plans[name] = (costs, asg.tiles_of)
    rel_c = plans["const"][0] / plans["const"][0].sum()
    rel_t = plans["tuned"][0] / plans["tuned"][0].sum()
    assert not np.allclose(rel_c, rel_t)
    assert plans["const"][1] != plans["tuned"][1]


def test_phase_records_note_cost_source():
    profile = HeterogeneityProfile.paper()
    task = TaskSpec("count_tiles", cost=4.0, n_tiles=4)
    execute = lambda asg, costs: MeasuredPhase(result="ok")  # noqa: E731
    for policy, want in (("static", "bytes"), ("dynamic", "bytes"),
                         ("costmodel", "roofline")):
        rt = Runtime(profile, policy=policy)
        _, rec = rt.run_phase(task, execute)
        assert rec.cost_source == want, policy
    rt = Runtime(profile, policy=costmodel_pair("support_count")[1])
    _, rec = rt.run_phase(task, execute)
    assert rec.cost_source == "autotune"
    _, ser = rt.run_serial("load", 1.0)      # serial phases stamped too
    assert ser.cost_source == "autotune"


def _plane(kind, tmp_path, **kw):
    """One of the five planes on the CPU; returns (its runtime, the kernel
    its cost model is fed from)."""
    if kind == "apriori":
        return MarketBasketPipeline(config=PipelineConfig(
            device="cpu", **kw)).runtime, "support_count"
    if kind == "eclat":
        return EclatMiner(config=PipelineConfig(
            device="cpu", **kw)).runtime, "intersect_count"
    if kind == "son":
        return SONMiner(config=PipelineConfig(device="cpu", **kw),
                        son=SONConfig(workdir=str(tmp_path),
                                      partition_rows=64)).runtime, \
            "support_count"
    if kind == "stream":
        return StreamingMiner(16, config=StreamingConfig(
            device="cpu", **kw)).runtime, "support_count"
    return RecommendationEngine(RuleIndex.build([], 16), config=ServingConfig(
        device="cpu", **kw)).runtime, "rule_match"


@pytest.mark.parametrize("kind", ["apriori", "eclat", "son", "stream",
                                  "serve"])
def test_planes_take_costmodel_by_name_and_instance(kind, tmp_path,
                                                    monkeypatch):
    """policy="costmodel" + autotune on (the default) seeds planning from
    the default cache's entries for the plane's device and kernel;
    autotune=False pins the data-sheet constants; an instance is used as
    it is."""
    _, port = measured_caches()
    monkeypatch.setattr(cache_mod, "_default", port)
    rt, kernel = _plane(kind, tmp_path, policy="costmodel")
    want = CostModelPolicy.from_autotune(port, kernel, device="cpu")
    assert rt.policy.cost_source == "autotune"
    assert (rt.policy.peak_flops, rt.policy.hbm_bw) == \
        (want.peak_flops, want.hbm_bw)
    rt, _ = _plane(kind, tmp_path, policy="costmodel", autotune=False)
    assert type(rt.policy) is CostModelPolicy
    assert rt.policy.cost_source == "roofline"
    assert rt.policy.peak_flops == CostModelPolicy().peak_flops
    # a cache without this device's entries degrades to the constants
    monkeypatch.setattr(cache_mod, "_default", measured_caches(
        device="NVIDIA_H100_80GB_HBM3")[1])
    rt, _ = _plane(kind, tmp_path, policy="costmodel")
    assert rt.policy.cost_source == "roofline"
    rt, _ = _plane(kind, tmp_path, policy="static")
    assert type(rt.policy) is StaticPolicy


def test_pipeline_costmodel_mine_ledger_says_autotune(monkeypatch):
    monkeypatch.setattr(cache_mod, "_default", measured_caches()[1])
    T = generate_baskets(BasketConfig(n_tx=300, n_items=24, seed=5))
    res = {at: MarketBasketPipeline(config=PipelineConfig(
        device="cpu", policy="costmodel", autotune=at, min_support=0.05,
        n_tiles=4)).run(T) for at in (True, False)}
    assert res[True].supports == res[False].supports
    assert {p.cost_source for p in res[True].report.ledger.phases} \
        == {"autotune"}
    assert {p.cost_source for p in res[False].report.ledger.phases} \
        == {"roofline"}
    assert res[True].report.policy == "costmodel"


# ---------------------------------------------------------------------------
# the checked-in cache and the refresh CLI
# ---------------------------------------------------------------------------

def test_checked_in_cache_holds_the_cards_lattice():
    cache = default_cache(reload=True)
    assert cache.load_error is None
    kinds = {key.split("|")[2] for key in cache.entries}
    assert len(kinds) == 1 and "cpu" not in kinds, kinds
    kind = kinds.pop()
    for kernel in TUNABLE_KERNELS:
        entries = cache.entries_for(kernel, kind)
        buckets = {shape_bucket(kernel, s) for s in standard_shapes(kernel)}
        assert {shape_bucket(kernel, tuple(e["shape"])) for e in entries} \
            == buckets
        assert len(entries) == len(buckets)
        for ent in entries:
            assert ent["cost_us"] > 0 and ent["source"] == "measured"
            assert ent["config"]["variant"] in ("packed", "mxu")
            assert ent["swept"] and all(s["matched"] for s in ent["swept"])
            assert {s["config"]["variant"] for s in ent["swept"]} == (
                {"packed"} if kernel == "intersect_count"
                else {"packed", "mxu"})
    with open(cache.path) as f:
        assert json.load(f)["meta"]["refresh"] == \
            "python -m repro_torch.launch.autotune"


def test_autotune_cli_smoke_on_the_cpu(tmp_path):
    out = tmp_path / "tune.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.autotune", "--smoke",
         "--device", "cpu", "--out", str(out)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    cache = AutotuneCache.load(str(out))
    assert cache.load_error is None
    assert sorted(cache.entries) == sorted(
        f"{k}|{shape_bucket(k, SMOKE[k])}|cpu" for k in TUNABLE_KERNELS)
    for ent in cache.entries.values():
        assert ent["swept"] and all(s["matched"] for s in ent["swept"])
    assert "wrote 3 entries" in run.stdout
