"""Multi-node dry run: one step of every (arch × shape × mesh) cell on a
fake process group, under ``FakeTensorMode``, with no device and no
weights.

The reference lowers and compiles each cell for 512 placeholder host
devices and reads the compiled SPMD artifact.  Here each cell's inputs
are DTensors over a ``fake`` process group of the mesh's size, whose
collectives move nothing, and whose local shards are fake tensors with
no storage: the step runs its eager program on rank 0's shards, and the
dry run counts what that program dispatches.  It proves the same things
without hardware: that DTensor shards every op of the step, which
collectives it schedules, and what a device holds.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --profile tuned --out results/dryrun_torch

The record has the reference's schema.  What it counts, per device
(rank 0's local shards, as the reference's SPMD counts are):

* ``cost.flops``: ``torch.utils.flop_counter``'s formula (the one
  ``FlopCounterMode`` applies) for every op on the local shards.  The
  fake shards live on device type ``cpu``, so every kernel dispatch takes
  its plain route (attention's ``attention_full``, the selective scan,
  the WKV): the FLOPs and bytes are those of the plain forms.  For
  attention these are the same products as the flash kernel's.
* ``cost.bytes_accessed``: the sum over every dispatched op of its
  operand and result bytes, views excluded: the eager program's traffic,
  with no fusion.
* ``collectives``: wire bytes by op from the functional collectives
  DTensor dispatches, under the reference's rules
  (:mod:`repro_torch.launch.roofline`), and ``count_by_op`` from
  ``CommDebugMode``.
* ``memory``: ``argument_bytes`` are the inputs' local shards,
  ``alias_bytes`` the inputs the step updates in place (the optimizer's
  moments, the decode cache), ``peak_estimate_bytes`` the arguments plus
  the most bytes the step's own storages held at once (counted as they
  are made and freed), ``output_bytes`` the outputs' new storages and
  ``temp_bytes`` the rest of that peak.  An in-place update allocates
  nothing, so the peak has no alias term to subtract.
* ``compile_s``, ``cost.xla_flops_raw``, ``cost.xla_bytes_raw`` and
  ``cost.unknown_trip_loops`` are ``None``: an eager step compiles
  nothing and has no XLA cost analysis.  ``lower_s`` is the fake step's
  wall time.
* loops of the step (the grad-accum microbatches) are counted once and
  multiplied by their trips, as the reference's ``hlo_cost`` multiplies
  a scan body by its known trip count: the loop dispatches its first
  trip only (``steps.counting_trips``), whose FLOPs, op bytes,
  collective bytes and counts by op are taken ``trips`` times, and the
  work done once a step (AdamW, the final divide) once.  Every trip has
  the same shapes and placements, so the counts are those of running
  every trip; the peak is the counted trip's, the gradient sums live, as
  in every trip.

Where the step meets DTensor, the model places what DTensor cannot (each
a plain op on plain tensors, so the CPU and card paths are unchanged):

* tensors the model makes itself (positions, RoPE's angles, masks,
  initial states) are replicated, under ``implicit_replication``;
* the cross-entropy's label gather (``models/layers.softmax_xent`` and
  the chunked loss) has no strategy along a sharded or partial vocab
  dim: the logits are gathered whole first (``meshes.replicate_dim``, an
  all-gather or all-reduce in the record);
* the decode step's argmax over a vocab that two mesh axes shard
  returns wrong-shaped indices in DTensor: the logits are gathered whole
  first (``launch/steps.make_decode_step``);
* an embedding lookup from a vocab-sharded table is a masked partial that
  DTensor reduces once only, and the residual reads it twice: it is
  reduced where it is made (``meshes.resolve_partial``);
* a head split or merge whose heads do not fall whole on the shards (8
  KV heads over 16, 25 heads over any even axis) is refused by DTensor's
  views: the dim is gathered first, in both directions of autograd
  (``meshes.split_dim``, ``merge_dims``; GQA's and MLA's splits alike);
* a decode step's new key and value are written into the one shard of a
  sequence-sharded cache that holds the position (``meshes.write_at``);
  DTensor would write into a gathered copy.  The step decodes position
  0, which rank 0's shard holds, so the rank counted is one that writes;
* under sequence parallelism a block's norm output (and GQA's output
  before ``wo``) is gathered over the sequence before the projections
  (``layers.sequence_gather``), as Megatron's sequence parallelism does:
  a matmul would otherwise fold a sharded sequence into its rows, which
  torch 2.11 refuses and torch 2.13 plans slowly;
* the WKV and selective-scan recurrences are separable over (batch,
  head) and (batch, channel): they run on each rank's local shards
  (``meshes.map_shards``), since their steps' products fold a sharded
  batch and head into one dim;
* the token shift's and causal conv's pad is a concatenation of zeros
  on DTensors (``meshes.pad_front``), which torch 2.11 cannot shard;
* the MoE dispatch scatters out of place into fresh zeros, which take
  the routing's placement (an in-place scatter into a plain buffer from
  DTensors is refused);
* the grad-accum microbatches are selected through a reshape of the
  batch's leading dim (rows j, j + accum, ..., as the reference's
  reshape-and-swap selects them; ``meshes.split_dim``, which gathers the
  batch first where its shards do not hold whole microbatch rows), which
  keeps them sharded where a strided slice of a sharded dim would gather
  the batch, and the gradient sums start from zeros placed like each
  parameter;
* a microbatch whose rows fall whole on "data" but not on "pod" × "data"
  (16 rows over the 2 × 16 × 16 mesh's 32 batch shards, the MoE archs'
  ``train_4k`` at grad-accum 16) runs on the mesh without "pod", its
  rows over "data" and every pod the same rows, its parameters and
  gradients moved on and off that sub-mesh with their local shards
  (``meshes.microbatch_mesh``, ``to_submesh``, ``from_submesh``): on the
  whole mesh DTensor gives the idle "pod" axis to other dims, in
  shardings its planner searches for minutes and its views get wrong
  (MLA's query split, a matmul's fold of rows).

Windows stay Python ints (``attention.layer_windows``), so no mask reads
a tensor on the host.  A fake tensor never reaches a kernel wrapper: the
wrappers take their plain route for any tensor on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import SHAPES, get_config, list_archs
from repro_torch.core.compat import axis_sizes, mesh_context
from repro_torch.distributed import meshes as M
from repro_torch.launch import hlo_cost as H
from repro_torch.launch import roofline as R
from repro_torch.launch import steps as S
from repro_torch.launch.tuning import cell_config
from repro_torch.optim.adamw import (AdamWConfig, OptState, tree_leaves,
                                     tree_map)

# never the reference's results/dryrun, whose artifact test reads every
# record there as the reference's
DEFAULT_OUT = "results/dryrun_torch"

# functional collective -> the reference's HLO op name
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _flatten_with_path(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten_with_path(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_path(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _active_params(cfg, params_spec) -> int:
    """Active (per-token) parameter count from the abstract tree."""
    total = 0
    routed = 0
    for key, leaf in _flatten_with_path(params_spec):
        n = math.prod(leaf.shape)
        total += n
        if "/moe/" in key and "/shared/" not in key and "router" not in key:
            routed += n
    if cfg.moe is not None and cfg.moe.n_experts:
        return total - routed + int(routed * cfg.moe.top_k
                                    / cfg.moe.n_experts)
    return total


def _params_total(params_spec) -> int:
    return sum(math.prod(leaf.shape)
               for _, leaf in _flatten_with_path(params_spec))


class _Bookkeeping:
    """Entered around DTensor's own bookkeeping ops: while it is held,
    :class:`_Counter` counts nothing, since those ops are no part of the
    rank's program."""

    def __init__(self):
        self.depth = 0

    def __enter__(self):
        self.depth += 1

    def __exit__(self, *exc):
        self.depth -= 1


def _memo_key(args, kwargs):
    key = (args, tuple(sorted(kwargs.items())))
    try:
        hash(key)
    except TypeError:
        return None
    return key


@contextlib.contextmanager
def _dtensor_bookkeeping(prop: _Bookkeeping):
    """Adapts DTensor's bookkeeping to an ambient ``FakeTensorMode`` for
    the block, and restores it after.

    * Sharding propagation runs each op once more on global-shape fake
      tensors to learn its output's shape
      (``ShardingPropagator._propagate_tensor_meta_non_cached``): it runs
      under ``prop``, so that :class:`_Counter` leaves it out.
    * Two helpers compute a shard's offsets with small index tensors that
      they read on the host, which a fake tensor refuses:
      ``_StridedShard.local_shard_size_and_offset`` (a dim flattened from
      two sharded dims) and ``_utils._compute_local_shape_and_global_offset``
      (argmax's global indices, among others).  They run with every
      dispatch mode unset, on real index tensors, once for each set of
      their arguments.
    * Under a fake mode DTensor takes itself to be tracing, where shapes
      may be symbolic, and propagates every op's sharding
      (``ShardingPropagator.propagate_op_sharding_non_cached``) and plans
      every redistribution (``_gen_transform_infos_non_cached``) anew,
      which on a 3-D mesh costs milliseconds an op.  The shapes here are
      concrete: both are kept for the block, keyed as DTensor keys them
      when it is not tracing.
    """
    from torch.distributed.tensor import _redistribute, _utils
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.utils._python_dispatch import _disable_current_modes

    def marked(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with prop:
                return fn(*args, **kwargs)
        return run

    def kept(fn, outside_modes: bool):
        memo: Dict[Any, Any] = {}

        @functools.wraps(fn)
        def run(*args, **kwargs):
            key = _memo_key(args, kwargs)
            if key is None or key not in memo:
                with (_disable_current_modes() if outside_modes
                      else contextlib.nullcontext()):
                    out = fn(*args, **kwargs)
                if key is None:
                    return out
                memo[key] = out
            return memo[key]
        return run

    patches = [
        (ShardingPropagator, "_propagate_tensor_meta_non_cached", marked),
        (ShardingPropagator, "propagate_op_sharding_non_cached",
         lambda fn: kept(fn, outside_modes=False)),
        (_StridedShard, "local_shard_size_and_offset",
         lambda fn: kept(fn, outside_modes=True)),
        (_utils, "_compute_local_shape_and_global_offset",
         lambda fn: kept(fn, outside_modes=True)),
        (_redistribute, "_gen_transform_infos_non_cached",
         lambda fn: kept(fn, outside_modes=False)),
    ]
    saved = [(owner, name, getattr(owner, name))
             for owner, name, _ in patches]
    try:
        for owner, name, wrap in patches:
            setattr(owner, name, wrap(getattr(owner, name)))
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


class _Counter(TorchDispatchMode):
    """One rank's local program, as it dispatches: FLOPs
    (``torch.utils.flop_counter``'s formula for each op), operand and
    result bytes (views excluded), collective wire bytes, the bytes of the
    storages it holds at once, and its in-place writes to the inputs.
    Ops on DTensors pass through to DTensor, whose local ops come back
    here; ops DTensor runs for its bookkeeping (``prop`` held) are not
    counted."""

    def __init__(self, inputs, prop: _Bookkeeping, comm):
        super().__init__()
        self.prop = prop
        self.comm = comm                   # CommDebugMode, scaled by repeat
        self.flops = 0
        self.bytes = 0
        self.coll: Dict[str, int] = {}
        self.inputs = {}                   # storage key -> bytes
        for t in inputs:
            st = t.untyped_storage()
            self.inputs[st._cdata] = st.nbytes()
        self.written = set()
        self.live = 0
        self.peak = 0
        self.owned = {}                    # storage key -> bytes

    def _free(self, key):
        self.live -= self.owned.pop(key, 0)

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key in self.inputs or key in self.owned:
            return
        self.owned[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.prop.depth:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        name = _COLLECTIVE_OPS.get(packet.__name__)
        if name is not None and func.namespace == "_c10d_functional":
            wire = sum(_nbytes(t) for t in outs)
            if name == "all-reduce":
                wire *= 2
            elif name == "reduce-scatter":
                wire *= int(args[2])       # group size
            self.coll[name] = self.coll.get(name, 0) + wire
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is not None and arg.alias_info.is_write:
                t = args[i] if i < len(args) else kwargs.get(arg.name)
                for x in _tensors(t):
                    key = x.untyped_storage()._cdata
                    if key in self.inputs:
                        self.written.add(key)
        for t in outs:
            self._track(t)
        return out

    def alias_bytes(self) -> int:
        return sum(self.inputs[k] for k in self.written)

    @contextlib.contextmanager
    def repeat(self, trips: int):
        """What the block dispatches (FLOPs, op bytes, collective wire
        bytes and ``CommDebugMode``'s counts by op) counted ``trips``
        times: the block is one trip of a loop whose trips are alike.
        The peak is the block's own: every trip holds the same."""
        flops, nbytes, coll = self.flops, self.bytes, dict(self.coll)
        counts = dict(self.comm.comm_counts)
        yield
        k = trips - 1
        self.flops += k * (self.flops - flops)
        self.bytes += k * (self.bytes - nbytes)
        for op, v in list(self.coll.items()):
            self.coll[op] = v + k * (v - coll.get(op, 0))
        for op, v in list(self.comm.comm_counts.items()):
            self.comm.comm_counts[op] = v + k * (v - counts.get(op, 0))


def _place(tree, specs, mesh):
    """The full fake tree as DTensors on ``mesh``, each rank 0's block."""
    return tree_map(lambda x, s: s.distribute(x), tree, M.named(specs, mesh))


def lower_cell(arch: str, shape_name: str, mesh, profile: str = "tuned",
               overrides: Optional[Dict[str, Any]] = None,
               opt_overrides: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
    """Run one cell's step on fake shards over ``mesh`` (any mesh over
    the process group that is up); returns the artifact record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    shape = SHAPES[shape_name]
    cfg0 = get_config(arch)
    if overrides:                      # before tuning so vocab/dims are real
        cfg0 = cfg0.replace(**overrides)
    cfg, opts = cell_config(cfg0, shape_name, profile)
    if overrides:                      # and after, so explicit overrides win
        cfg = cfg.replace(**overrides)
    if opt_overrides:
        opts.update(opt_overrides)
    sizes = axis_sizes(mesh)
    chips = math.prod(sizes.values())
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": sizes,
        "profile": profile, "chips": chips, "kind": shape.kind,
        "config": {"attention_impl": cfg.attention_impl,
                   "attention_chunk": cfg.attention_chunk,
                   "vocab_loss_chunk": cfg.vocab_loss_chunk,
                   "remat_policy": cfg.remat_policy,
                   "sequence_parallel": cfg.sequence_parallel,
                   "grad_accum": opts.get("grad_accum", 1)},
    }

    fake = FakeTensorMode(allow_non_fake_inputs=True)
    params_full = S.param_specs(cfg, fake_mode=fake)
    n_active = _active_params(cfg, params_full)
    n_total = _params_total(params_full)
    p_pspec = M.param_pspecs(cfg, params_full, mesh)
    with fake:
        params = _place(params_full, p_pspec, mesh)
        if shape.kind == "train":
            step_fn = S.make_train_step(cfg, AdamWConfig(),
                                        opts.get("grad_accum", 1))
            opt_full = S.abstract_opt_state(params_full, fake)
            o_pspec = M.opt_pspecs(cfg, params_full, mesh)
            opt = OptState(mu=_place(opt_full.mu, o_pspec, mesh),
                           nu=_place(opt_full.nu, o_pspec, mesh),
                           step=M.NamedSharding(mesh, M.P()).distribute(
                               opt_full.step))
            batch_full = S.batch_specs(cfg, shape, fake)
            batch = _place(batch_full, M.batch_pspecs(batch_full, mesh),
                           mesh)
            args = (params, opt, batch)
        elif shape.kind == "prefill":
            step_fn = S.make_prefill_step(cfg)
            batch_full = S.batch_specs(cfg, shape, fake)
            batch = _place(batch_full, M.batch_pspecs(batch_full, mesh),
                           mesh)
            args = (params, batch)
        else:  # decode
            step_fn = S.make_decode_step(cfg)
            d = S.decode_specs(cfg, shape, fake)
            cache = _place(d["cache"],
                           M.cache_pspecs(cfg, d["cache"], mesh,
                                          shape.seq_len), mesh)
            tok_spec = M.batch_pspecs({"t": d["tokens"]}, mesh)["t"]
            tokens = M.NamedSharding(mesh, tok_spec).distribute(d["tokens"])
            # the reference traces ``pos`` as a scalar; the port's decode
            # indexes the cache with a Python int.  Position 0 lies in rank
            # 0's shard of a sequence-sharded cache, so the rank counted is
            # one that writes the new key and value.
            args = (params, cache, tokens, 0)
        del params_full
    inputs = [_local(t) for t in _tensors(args)]

    prop = _Bookkeeping()
    comm = CommDebugMode()
    counter = _Counter(inputs, prop, comm)
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_dtensor_bookkeeping(prop))
        stack.enter_context(fake)
        stack.enter_context(mesh_context(mesh))
        stack.enter_context(implicit_replication())
        stack.enter_context(comm)
        stack.enter_context(counter)
        stack.enter_context(S.counting_trips(counter.repeat))
        out = step_fn(*args)
    t_lower = time.time() - t0
    outs = {_local(t).untyped_storage()._cdata: _local(t).untyped_storage()
            .nbytes() for t in _tensors(out)}
    output_bytes = sum(n for k, n in outs.items() if k not in counter.inputs)
    arg_bytes = sum(counter.inputs.values())
    del out, args, params, inputs

    hc = H.HloCost(flops=float(counter.flops),
                   traffic_bytes=float(counter.bytes),
                   collective_bytes=float(sum(counter.coll.values())),
                   collective_by_op=dict(counter.coll))
    mf = R.model_flops_for(cfg, shape, n_active, shape.kind)
    coll = R.CollectiveStats(
        bytes_by_op={k: int(v) for k, v in hc.collective_by_op.items()},
        count_by_op={str(k).split(".")[-1]: int(v)
                     for k, v in comm.get_comm_counts().items()})
    terms = R.derive_terms({"flops": hc.flops,
                            "bytes accessed": hc.traffic_bytes},
                           coll, chips, mf)
    rec.update({
        "ok": True,
        "lower_s": round(t_lower, 2), "compile_s": None,
        "params_total": n_total, "params_active": n_active,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": output_bytes,
            "temp_bytes": max(counter.peak - output_bytes, 0),
            "alias_bytes": counter.alias_bytes(),
            "peak_estimate_bytes": arg_bytes + counter.peak,
        },
        "cost": {"flops": hc.flops,
                 "bytes_accessed": hc.traffic_bytes,
                 "xla_flops_raw": None,
                 "xla_bytes_raw": None,
                 "unknown_trip_loops": None},
        "collectives": {"bytes_by_op": coll.bytes_by_op,
                        "count_by_op": coll.count_by_op,
                        "total_bytes": coll.total_bytes},
        "roofline": {
            "compute_s": terms.compute_s, "memory_s": terms.memory_s,
            "collective_s": terms.collective_s, "dominant": terms.dominant,
            "model_flops_global": mf, "useful_ratio": terms.useful_ratio,
            "roofline_fraction": terms.roofline_fraction,
        },
    })
    return rec


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks, this process rank
    0, for the block; a group that is already up of that size is used as
    it is."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is up; "
                f"this mesh needs {world_size}")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cells(archs, shapes, mesh_modes, profile: str, out_dir: str,
              stop_on_error: bool = False):
    from repro_torch.launch.mesh import make_production_mesh

    os.makedirs(out_dir, exist_ok=True)
    results = []
    for mesh_mode in mesh_modes:
        multi_pod = mesh_mode == "multipod"
        with fake_process_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod)
            for arch in archs:
                cfg = get_config(arch)
                for shape_name in shapes:
                    tag = f"{arch}__{shape_name}__{mesh_mode}__{profile}"
                    path = os.path.join(out_dir, tag + ".json")
                    if shape_name not in cfg.shapes():
                        rec = {"arch": arch, "shape": shape_name,
                               "mesh_mode": mesh_mode, "ok": False,
                               "skipped": True,
                               "reason": "pure full-attention arch; "
                                         "long-context decode requires "
                                         "sub-quadratic mixer"}
                        with open(path, "w") as f:
                            json.dump(rec, f, indent=1)
                        print(f"[skip] {tag}: inapplicable shape")
                        continue
                    if os.path.exists(path):
                        with open(path) as f:
                            old = json.load(f)
                        if old.get("ok"):
                            print(f"[cached] {tag}")
                            results.append(old)
                            continue
                    print(f"[fake step] {tag} ...", flush=True)
                    try:
                        rec = lower_cell(arch, shape_name, mesh, profile)
                        rec["mesh_mode"] = mesh_mode
                        rl = rec["roofline"]
                        print(f"    ok: lower={rec['lower_s']}s "
                              f"dominant={rl['dominant']} "
                              f"compute={rl['compute_s']:.4f}s "
                              f"memory={rl['memory_s']:.4f}s "
                              f"coll={rl['collective_s']:.4f}s "
                              f"frac={rl['roofline_fraction']:.3f}",
                              flush=True)
                    except Exception as e:  # noqa: BLE001 — record, go on
                        rec = {"arch": arch, "shape": shape_name,
                               "mesh_mode": mesh_mode, "profile": profile,
                               "ok": False, "error": str(e)[-2000:],
                               "traceback": traceback.format_exc()[-4000:]}
                        print(f"    FAILED: {str(e)[:300]}", flush=True)
                        if stop_on_error:
                            raise
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    results.append(rec)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--profile", default="tuned",
                    choices=["baseline", "tuned"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--stop-on-error", action="store_true")
    args = ap.parse_args()

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    mesh_modes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    results = run_cells(archs, shapes, mesh_modes, args.profile, args.out,
                        stop_on_error=args.stop_on_error)
    ok = sum(1 for r in results if r.get("ok"))
    print(f"\n{ok}/{len(results)} cells ran OK")


if __name__ == "__main__":
    main()
