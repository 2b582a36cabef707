"""The paper's job, end to end: mine association rules from a transactional
database through :class:`repro_torch.pipeline.MarketBasketPipeline`
(MapReduce Apriori under the MB Scheduler on a heterogeneous core profile).

  PYTHONPATH=src python -m repro_torch.launch.mine --n-tx 8192 \
      --n-items 128 --min-support 0.02 --min-confidence 0.6 \
      --profile paper --policy dynamic --split lpt [--device cpu]

Counting runs on the card unless ``--device cpu`` asks for the CPU.

`--policy` selects the switching policy (paper §VI): ``static`` plans each
phase once, ``dynamic`` closes the loop (EWMA speed feedback, straggler
speculation), ``costmodel`` seeds tile costs from roofline estimates.
`--split` selects the tile split (``lpt`` | ``proportional`` | ``equal``).

`--algorithm` selects the mining formulation: ``apriori`` (horizontal
bitmap rounds), ``eclat`` (vertical tid-list AND-popcount rounds), or
``auto`` (the algorithm cost model prices both on measured density
features and picks one).  `--dataset sparse` generates a wide-universe
low-frequency corpus consumed through the sparse CSR slab — the Eclat
path then never materializes the dense bitmap.

`--sharded` executes the distributed mining plane: one process a rank of a
``torch.distributed`` group.  A process that already belongs to a group
(started by ``torchrun --nproc-per-node N``, one card a rank under NCCL)
joins the mesh in place; otherwise the CLI spawns `--n-shards` gloo ranks
itself (default 8), which share the one card or the CPU.  Every rank runs
the same mine; rank 0 prints, and every rank's answer must equal rank
0's.  `--smoke` additionally runs the single-device pipeline on the same
data and asserts bit-identical itemsets and rules (run under both
``--policy static`` and ``--policy dynamic``: results must not depend on
the switching policy, and with ``--algorithm eclat|auto`` the reference
pipeline is the Apriori oracle, so the cross-algorithm parity is asserted
too).

`--out-of-core` runs the SON two-pass plane: the corpus is spilled to
disk-resident chunks of `--partition-rows` transactions under `--son-dir`,
mined partition-locally, then globally re-counted — with a resumable
checkpoint at every partition boundary.  A killed mine (`--kill-after N`
simulates one, exiting 3) restarts with `--resume` from the last completed
partition and finishes bit-identical to an uninterrupted run.

`--profile-dir` writes a ``torch.profiler`` trace of the mine there (CPU
and, on the card, CUDA activities) as ``*.pt.trace.json``, for Perfetto or
``chrome://tracing``; the mine itself is the ``repro_torch.mine`` range.
"""
from __future__ import annotations

import contextlib
import io
import os
import pickle
import tempfile
from pathlib import Path

import torch

from repro_torch.data.baskets import (BasketConfig, generate_baskets,
                                      sparse_baskets)
from repro_torch.data.sparse import SparseSlab
from repro_torch.launch.common import PROFILES, standard_parser
from repro_torch.pipeline import MarketBasketPipeline, PipelineConfig

# ranks the CLI spawns for --sharded when no group is running (the
# reference CLI's forced host mesh has 8)
DEFAULT_SHARDS = 8
# the profiler range that brackets the mine in a --profile-dir trace
TRACE_RANGE = "repro_torch.mine"


def _make_dataset(dataset: str, n_tx: int, n_items: int, seed: int):
    """dense → 0/1 bitmap; sparse → CSR slab (never densified here)."""
    if dataset == "sparse":
        baskets = sparse_baskets(n_tx, max(n_items, 256), seed=seed,
                                 max_item_freq=0.05)
        return SparseSlab.from_baskets(baskets, n_items=max(n_items, 256))
    return generate_baskets(BasketConfig(n_tx=n_tx, n_items=n_items,
                                         seed=seed))


@contextlib.contextmanager
def _trace(profile_dir: str, device: str):
    """Profile the body into one ``*.pt.trace.json`` under ``profile_dir``,
    inside a ``TRACE_RANGE`` range (nothing without a directory)."""
    if not profile_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(profile_dir)), \
            record_function(TRACE_RANGE):
        yield


@contextlib.contextmanager
def _torchrun_group(device: str):
    """Join the process group a launcher such as ``torchrun`` describes
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` in the environment): NCCL
    with one card a rank, gloo on the CPU.  Yields this process's rank,
    then leaves the group."""
    import torch.distributed as dist

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if cuda else "gloo")
    try:
        yield dist.get_rank()
    finally:
        dist.destroy_process_group()


def _quiet(rank: int):
    """Rank 0 prints; the other ranks' output is dropped."""
    return (contextlib.redirect_stdout(io.StringIO()) if rank
            else contextlib.nullcontext())


def _in_group() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _mine_rank(rank: int, out: str, kwargs: dict) -> None:
    """One spawned rank of ``mine(sharded=True)``: the same mine as every
    other rank, quiet except on rank 0; writes ``rank<r>.pkl`` (its
    answer, or the exit code of a killed mine) under ``out``."""
    try:
        with _quiet(rank):
            result = mine(**kwargs)
        got = {"result": result}
    except SystemExit as e:                 # a --kill-after boundary
        got = {"exit": e.code}
    Path(out, f"rank{rank}.pkl").write_bytes(pickle.dumps(got))


def _spawn_sharded(n_shards: int, kwargs: dict):
    """``mine(**kwargs)`` on ``n_shards`` spawned gloo ranks; rank 0's
    result, once every rank's supports and rules equal it."""
    from repro_torch.distributed.ranks import spawn_ranks

    with tempfile.TemporaryDirectory() as wd:
        spawn_ranks(_mine_rank, n_shards, args=(wd, kwargs),
                    store=os.path.join(wd, "store"))
        got = [pickle.loads(Path(wd, f"rank{r}.pkl").read_bytes())
               for r in range(n_shards)]
    codes = {g.get("exit") for g in got}
    if codes != {None}:
        if len(codes) > 1:
            raise RuntimeError(f"ranks disagree on their exit: {codes}")
        raise SystemExit(codes.pop())
    first = got[0]["result"]
    for r, g in enumerate(got[1:], 1):
        if (g["result"].supports != first.supports
                or g["result"].rules != first.rules):
            raise RuntimeError(f"rank {r} mined another answer than rank 0")
    return first


def mine(n_tx: int = 8192, n_items: int = 128, min_support: float = 0.02,
         min_confidence: float = 0.6, profile_name: str = "paper",
         split: str = "lpt", n_tiles: int = 32, data_plane: str = "auto",
         seed: int = 0, top: int = 15, sharded: bool = False,
         n_shards: int = 0, smoke: bool = False, policy: str = "static",
         autotune: bool = True, algorithm: str = "apriori",
         dataset: str = "dense", round_execution: str = "pipelined",
         profile_dir: str = "", out_of_core: bool = False,
         partition_rows: int = 4096, son_dir: str = "", resume: bool = False,
         kill_after: int = 0, device: str = "cuda"):
    """One mine as the CLI runs it (the flags of :func:`main`), counting
    on ``device``; returns the :class:`PipelineResult`.  Raises
    ``SystemExit(3)`` where ``kill_after`` stops an out-of-core mine."""
    kwargs = dict(locals())
    if sharded and not _in_group():
        if "WORLD_SIZE" in os.environ:      # started by torchrun: join
            with _torchrun_group(device) as rank, _quiet(rank):
                return mine(**kwargs)
        return _spawn_sharded(n_shards or DEFAULT_SHARDS, kwargs)

    if smoke:                       # CI-sized: parity is the point, not scale
        n_tx, n_items = min(n_tx, 2048), min(n_items, 64)
        if out_of_core:             # at least 4 partitions, so the two-pass
            partition_rows = min(partition_rows, max(256, n_tx // 4))

    T = _make_dataset(dataset, n_tx, n_items, seed)
    config = PipelineConfig(min_support=min_support,
                            min_confidence=min_confidence,
                            n_tiles=n_tiles, policy=policy, split=split,
                            data_plane=data_plane, autotune=autotune,
                            algorithm=algorithm,
                            round_execution=round_execution, device=device)

    if out_of_core:
        from repro_torch.mining import (SONConfig, SONKilled, SONMiner,
                                        make_miner)
        workdir = son_dir or os.path.join(tempfile.gettempdir(),
                                          f"repro-torch-son-{seed}")
        son = SONConfig(workdir=workdir, partition_rows=partition_rows,
                        resume=resume, abort_after=kill_after or None)
        profile = PROFILES[profile_name]()
        print(f"[mine] out-of-core: {partition_rows} rows/partition "
              f"workdir={workdir} resume={resume} policy={policy} "
              f"algorithm={algorithm}" + (" sharded" if sharded else ""))
        if sharded:
            # per-partition local pass on the ranks' mesh
            from repro_torch.distributed.mining import make_shard_mesh
            miner = SONMiner(profile=profile, config=config, son=son,
                             mesh=make_shard_mesh(n_shards or None))
        else:
            miner, _ = make_miner(T, profile=profile, config=config, son=son)
        try:
            with _trace(profile_dir, device):
                result = miner.run(T)
        except SONKilled as e:
            print(f"[mine] killed at partition boundary {e.boundary} "
                  f"(checkpoint saved under {workdir}) — rerun with "
                  "--resume to finish")
            raise SystemExit(3)
        choice = miner.algorithm_choice
    elif sharded:
        from repro_torch.distributed.mining import (ShardedMiner,
                                                    make_shard_mesh,
                                                    mesh_profile)
        mesh = make_shard_mesh(n_shards or None)
        n = mesh.size(0)
        profile = mesh_profile(n, PROFILES[profile_name]())
        print(f"[mine] sharded mesh={n} ranks "
              f"speeds={profile.speeds.tolist()} policy={policy} "
              f"split={split} algorithm={algorithm}")
        miner = ShardedMiner(mesh=mesh, profile=profile, config=config,
                             verify_rounds=smoke)
        with _trace(profile_dir, device):
            result = miner.run(T)
        choice = miner.algorithm_choice
    else:
        from repro_torch.mining import make_miner
        profile = PROFILES[profile_name]()
        print(f"[mine] profile={profile_name} speeds={profile.speeds.tolist()} "
              f"policy={policy} split={split} algorithm={algorithm}")
        miner, choice = make_miner(T, profile=profile, config=config)
        with _trace(profile_dir, device):
            result = miner.run(T)

    if choice is not None:
        print(f"[mine] {choice.summary()}")
    print(result.report.summary())
    print(f"[mine] top rules (min_conf={min_confidence}):")
    for r in result.rules[:top]:
        print("   ", r)

    if smoke and (sharded or out_of_core or algorithm != "apriori"):
        # end-to-end cross-plane AND cross-algorithm check: whatever ran
        # (sharded, out-of-core, eclat, auto) must equal the single-device
        # Apriori oracle bit for bit — scheduling, partitioning and
        # formulation must never change what gets mined, only
        # when/where/how it runs
        oracle_cfg = PipelineConfig(
            min_support=min_support, min_confidence=min_confidence,
            n_tiles=n_tiles, policy=policy, split=split,
            data_plane=data_plane, autotune=autotune, device=device)
        single = MarketBasketPipeline(PROFILES[profile_name](),
                                      oracle_cfg).run(T)
        assert result.supports == single.supports, \
            "mined itemsets differ from the single-device Apriori oracle"
        assert result.rules == single.rules, \
            "mined rules differ from the single-device Apriori oracle"
        ran = result.report.algorithm + (" sharded" if sharded else "") \
            + (" out-of-core" if out_of_core else "") \
            + (" resumed" if resume else "")
        print(f"[mine] smoke OK: {ran} == single-device apriori "
              f"({len(result.supports)} itemsets, {len(result.rules)} rules, "
              f"policy={policy})")
    return result


def main():
    ap = standard_parser()          # corpus / runtime / data-plane / seed
    ap.add_argument("--algorithm", default="apriori",
                    choices=["apriori", "eclat", "auto"],
                    help="mining formulation: horizontal bitmap (apriori), "
                         "vertical tid-lists (eclat), or cost-model "
                         "selection on measured density features (auto)")
    ap.add_argument("--dataset", default="dense",
                    choices=["dense", "sparse"],
                    help="dense = IBM-Quest bitmap; sparse = wide-universe "
                         "low-frequency corpus via the CSR slab (the Eclat "
                         "path never builds the dense bitmap)")
    ap.add_argument("--n-tiles", type=int, default=32)
    ap.add_argument("--round-execution", default="pipelined",
                    choices=["pipelined", "per_tile"],
                    help="pipelined = async tile dispatch, donated slabs, "
                         "one d2h per counting round; per_tile = legacy "
                         "host readback per tile")
    ap.add_argument("--profile-dir", default="",
                    help="write a torch.profiler trace of the mine here "
                         "(*.pt.trace.json, for Perfetto)")
    ap.add_argument("--sharded", action="store_true",
                    help="execute on the distributed mining plane (joins a "
                         "torchrun group, else spawns gloo ranks)")
    ap.add_argument("--n-shards", type=int, default=0,
                    help="mesh ranks (default: the group's size, or "
                         f"{DEFAULT_SHARDS} spawned ranks)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI smoke: small data, per-round invariant checks, "
                         "and (with --sharded / --out-of-core / "
                         "--algorithm eclat|auto) single-device Apriori "
                         "parity assert")
    ap.add_argument("--out-of-core", action="store_true",
                    help="SON two-pass plane: spill the corpus to disk "
                         "chunks, mine partition-locally, re-count "
                         "globally — checkpointed at every boundary")
    ap.add_argument("--partition-rows", type=int, default=4096,
                    help="transactions per disk-resident SON chunk (the "
                         "device-memory budget)")
    ap.add_argument("--son-dir", default="",
                    help="SON workdir for spill chunks + checkpoints "
                         "(default: a per-seed dir under the system tmp)")
    ap.add_argument("--resume", action="store_true",
                    help="resume a killed out-of-core mine from its last "
                         "completed partition boundary (bit-identical to "
                         "an uninterrupted run)")
    ap.add_argument("--kill-after", type=int, default=0,
                    help="test hook: abort the out-of-core mine after N "
                         "partition boundaries (exit code 3, checkpoint "
                         "kept — the CI kill-and-resume smoke)")
    args = ap.parse_args()
    mine(args.n_tx, args.n_items, args.min_support, args.min_confidence,
         args.profile, args.split, args.n_tiles, args.data_plane, args.seed,
         sharded=args.sharded, n_shards=args.n_shards, smoke=args.smoke,
         policy=args.policy, autotune=args.autotune,
         algorithm=args.algorithm, dataset=args.dataset,
         round_execution=args.round_execution,
         profile_dir=args.profile_dir, out_of_core=args.out_of_core,
         partition_rows=args.partition_rows, son_dir=args.son_dir,
         resume=args.resume, kill_after=args.kill_after, device=args.device)


if __name__ == "__main__":
    main()
