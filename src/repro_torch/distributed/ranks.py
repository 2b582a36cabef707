"""Start a mesh's ranks on one host: one spawned process a rank, each a
member of a gloo process group that meets through a file store.

``spawn_ranks(fn, n, args, store=path)`` runs ``fn(rank, *args)`` on ``n``
ranks and returns when all have returned.  ``fn`` must be importable by
its module path (a module-level function), since each rank starts from a
fresh interpreter (the ``spawn`` start method: CUDA cannot be forked).
Results travel back through files ``fn`` writes.
"""
from __future__ import annotations

import datetime
from typing import Any, Callable, Tuple

import torch


def _rank_main(rank: int, fn: Callable, world_size: int, store: str,
               timeout_s: float, args: Tuple[Any, ...]) -> None:
    import torch.distributed as dist

    # ranks share the host's cores: one intra-op thread each
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, args: Tuple[Any, ...] = (),
                *, store: str, timeout_s: float = 300.0) -> None:
    """Run ``fn(rank, *args)`` on ``world_size`` spawned ranks of one gloo
    process group whose file store is ``store`` (a path not yet in use).

    ``timeout_s`` bounds every collective: a rank that skips one, or dies,
    fails the others instead of hanging them.  The first rank to raise
    ends the run: the others are terminated and its exception is raised
    here with the rank's traceback (``torch.multiprocessing``'s
    ``ProcessRaisedException``).  Gloo reduces CPU and CUDA tensors, so
    the ranks may share one card; NCCL takes one card a rank, and such
    ranks are started one a card (e.g. by ``torchrun``).
    """
    import torch.multiprocessing as mp

    mp.spawn(_rank_main, nprocs=world_size, join=True,
             args=(fn, world_size, store, timeout_s, args))
