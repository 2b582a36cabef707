"""Meshes and named-sharding rules for every arch and tree, the reference's
``repro/distributed/meshes.py`` on ``torch.distributed``.

The rules are the reference's table, branch for branch: by name and path
over the parameter tree (the leading layer-stack dim is handled by right
alignment), each divisibility-checked against the mesh.  An axis that
does not divide its dim is dropped (replicated) rather than raising, so one
table serves vocab sizes like 49,155 and head counts like 25.

Sharding scheme:
  embeddings   vocab on "model" (fallback d_model)
  attention    col-sharded qkv, row-sharded o ("model" = TP axis)
  MLP          megatron col→row
  MoE          experts on "data" (EP); fsdp adds "data" on d_ff/d_model
  SSM/RWKV     channel/head-sharded on "model" (state stays rank-local)
  batch        ("pod", "data")
  optimizer    param spec + ZeRO-1 over "data" on the first free dim
  KV caches    batch on ("pod","data"), sequence on "model"

A spec is a :class:`PartitionSpec`: one entry a tensor dim, each ``None``,
an axis name or a tuple of axis names (the dim split over their product,
the first axis major).  :func:`named` pairs specs with a mesh as
:class:`NamedSharding` objects, which give DTensor placements and place a
full tensor on the mesh.  The rules take a ``DeviceMesh`` or a device-free
:class:`repro_torch.core.compat.AbstractMesh`.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compat import axis_names, axis_sizes
from repro_torch.core.compat import make_mesh as _compat_make_mesh
from repro_torch.optim.adamw import tree_map

# archs whose dense weights exceed one chip's memory under pure TP shard
# their weights over "data" too (FSDP / ZeRO-3 style).  MoE archs use
# expert parallelism over "data" instead, so none needs FSDP today.
FSDP_ARCHS: tuple = ()


class PartitionSpec:
    """Per-dimension axis assignment: ``PartitionSpec("data", None)``.
    Iterates, indexes and compares like the tuple of its entries.  An
    entry that names one axis in a tuple, ``("data",)``, is kept as the
    bare name, as jax's ``PartitionSpec`` keeps it."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = tuple(_entry(p) for p in parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self._parts == other._parts
        return isinstance(other, tuple) and self._parts == other

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._parts!r}"


P = PartitionSpec


def _entry(p):
    if isinstance(p, (list, tuple)):
        p = tuple(p)
        return p[0] if len(p) == 1 else p
    return p


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class NamedSharding:
    """A mesh and a :class:`PartitionSpec` (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def placements(self) -> tuple:
        """DTensor placements, one a mesh dimension: ``Shard(d)`` on each
        axis that the spec puts on tensor dim d, ``Replicate()`` on the
        rest.  A tuple entry must list its axes in mesh order, the order in
        which DTensor nests shards of one dim, so that the first axis is
        major as in the reference."""
        from torch.distributed.tensor import Replicate, Shard

        names = axis_names(self.mesh)
        where = {}
        for d, entry in enumerate(self.spec):
            axes = _axes_of(entry)
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise NotImplementedError(
                    f"spec entry {entry!r} lists its axes out of the mesh's "
                    f"order {names}")
            for a in axes:
                where[a] = d
        return tuple(Shard(where[a]) if a in where else Replicate()
                     for a in names)

    def slices(self, shape: Sequence[int], coord: Sequence[int]
               ) -> Tuple[slice, ...]:
        """The block of a ``shape`` array that the rank at mesh coordinate
        ``coord`` holds (the reference's ``devices_indices_map``)."""
        sizes = axis_sizes(self.mesh)
        at = dict(zip(axis_names(self.mesh), coord))
        out = []
        for d, n in enumerate(shape):
            entry = self.spec[d] if d < len(self.spec) else None
            idx, parts = 0, 1
            for a in _axes_of(entry):
                idx, parts = idx * sizes[a] + at[a], parts * sizes[a]
            step = n // parts
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def distribute(self, full: torch.Tensor):
        """``full`` (the whole array, on every rank of the mesh) as a
        DTensor on the mesh: each rank keeps its own block, copied to the
        mesh's device type; no collective runs."""
        from torch.distributed.tensor import DTensor

        coord = self.mesh.get_coordinate()
        if coord is None:
            raise RuntimeError("this rank is not in the sharding's mesh")
        device = (torch.device("cuda", torch.cuda.current_device())
                  if self.mesh.device_type == "cuda"
                  else torch.device(self.mesh.device_type))
        local = full[self.slices(full.shape, coord)].to(device).contiguous()
        return DTensor.from_local(local, self.mesh, self.placements(),
                                  run_check=False, shape=full.shape,
                                  stride=full.contiguous().stride())


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    return _compat_make_mesh(tuple(shape), tuple(axes))


def batch_axes(mesh) -> Tuple[str, ...]:
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _fits(dim: int, mesh, axis) -> bool:
    if axis is None:
        return True
    sizes = axis_sizes(mesh)
    return dim % int(np.prod([sizes[a] for a in _axes_of(axis)])) == 0


def _checked(spec_tail, shape, mesh) -> PartitionSpec:
    """Right-align spec_tail on shape; drop non-dividing axes; pad with
    None."""
    n = len(shape)
    tail = list(spec_tail)[-n:] if n else []
    full = [None] * (n - len(tail)) + tail
    out = []
    for dim, ax in zip(shape, full):
        out.append(ax if (ax is not None and _fits(dim, mesh, ax)) else None)
    return P(*out)


def _map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn("/"-joined path, leaf)`` over a tree of dicts, lists and tuples,
    keeping its structure: dict keys and sequence indices, as the
    reference's ``_path_str`` joins jax's key paths."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, v, path + (str(i),))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(type(tree), "_fields") \
            else type(tree)(out)
    return fn("/".join(path), tree)


_COL = ("wq", "wk", "wv", "wg", "w_gate", "w_up", "in_proj", "dt_proj",
        "wq_a", "wq_b", "wkv_b", "wr", "proj")
_ROW = ("wo", "w_down", "out_proj", "x_proj")
_REP = ("wkv_a", "router", "mix_w1", "mix_w2", "w_lora1", "w_lora2",
        "mu_base", "mu_k", "mu_r", "w_base", "ln_scale", "scale", "dt_bias")


def param_spec(path: str, shape: Tuple[int, ...], mesh,
               fsdp: bool, tied: bool = False) -> PartitionSpec:
    """FSDP note: "data" is stacked on the SAME dim as "model" (a
    ("data","model") tuple: pure N-way weight sharding, gathered per layer).
    Sharding "data" on the *opposite* dim would conflict with the batch's
    data sharding and replicate activations."""
    name = path.split("/")[-1]
    in_moe = "/moe/" in path and "/shared/" not in path
    shape = tuple(shape)

    def tp(dim_idx_from_right: int, spec_tail):
        """spec_tail with ("data","model") fused on the model dim if
        fsdp."""
        if not fsdp or "data" not in axis_names(mesh):
            return _checked(spec_tail, shape, mesh)
        fused = tuple(("data", "model") if ax == "model" else ax
                      for ax in spec_tail)
        cand = _checked(fused, shape, mesh)
        # if the fused axis didn't divide, fall back to model-only
        if any(isinstance(ax, tuple) for ax in cand):
            return cand
        return _checked(spec_tail, shape, mesh)

    if name in ("embed", "lm_head"):
        V, d = shape[-2], shape[-1]
        # lm_head (and tied embeddings): vocab on "model" -> [T@data,
        # V@model] logits.  Untied input embed: d on "model".
        if name == "lm_head":
            if _fits(V, mesh, "model"):
                return _checked((None, "model", None), shape, mesh)
            return _checked((None, None, "model"), shape, mesh)
        # input embed: prefer d-shard, except tied archs, whose logits
        # come from the same table (vocab-shard wins there)
        if tied and _fits(V, mesh, "model"):
            return _checked((None, "model", None), shape, mesh)
        if _fits(d, mesh, "model"):
            return _checked((None, None, "model"), shape, mesh)
        if _fits(V, mesh, "model"):
            return _checked((None, "model", None), shape, mesh)
        return P(*([None] * len(shape)))
    if name in ("codebook_embed", "codebook_head"):
        # EnCodec codebooks are tiny (2048×d): replicate
        return P(*([None] * len(shape)))
    if name == "u":                                   # rwkv bonus [L,H,n]
        return _checked((None, "model", None), shape, mesh)
    if name in ("A_log", "conv_w"):                   # [..., di, N] / [...,K,di]
        if name == "A_log":
            return _checked((None, "model", None), shape, mesh)
        return _checked((None, None, "model"), shape, mesh)
    if name == "D":
        return _checked((None, "model"), shape, mesh)
    if in_moe and name in ("w_gate", "w_up", "w_down"):  # [L,E,d,ff]/[L,E,ff,d]
        # expert-parallel over "data" + megatron TP over "model" inside
        # each expert; d_model stays unsharded
        E = shape[1]
        e_ax = "data" if ("data" in axis_names(mesh)
                          and _fits(E, mesh, "data")) \
            else ("model" if _fits(E, mesh, "model") else None)
        tp_ax = "model" if e_ax != "model" else None
        if name == "w_down":                          # [L,E,ff,d]
            return _checked((None, e_ax, tp_ax, None), shape, mesh)
        return _checked((None, e_ax, None, tp_ax), shape, mesh)
    if "/channel/" in path and name == "wv":          # rwkv channel [L,ff,d]
        return tp(1, (None, "model", None))
    if name in _ROW:
        return tp(1, (None, "model", None))
    if name in _COL:
        return tp(0, (None, None, "model"))
    if name in _REP or shape == () or len(shape) <= 2:
        return P(*([None] * len(shape)))
    return P(*([None] * len(shape)))


def param_pspecs(cfg: ModelConfig, params: Any, mesh) -> Any:
    fsdp = cfg.arch_id in FSDP_ARCHS or cfg.parallel_strategy == "fsdp"
    return _map_with_path(
        lambda path, x: param_spec(path, tuple(x.shape), mesh, fsdp,
                                   tied=cfg.tie_embeddings), params)


def zero1_spec(spec: PartitionSpec, shape: Tuple[int, ...],
               mesh) -> PartitionSpec:
    """Add "data" sharding to the first replicated, divisible dim
    (ZeRO-1)."""
    if "data" not in axis_names(mesh):
        return spec
    used = set()
    for s in spec:
        used.update(_axes_of(s))
    if "data" in used:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, s) in enumerate(zip(shape, parts)):
        if s is None and _fits(dim, mesh, "data"):
            parts[i] = "data"
            return P(*parts)
    return spec


def opt_pspecs(cfg: ModelConfig, params: Any, mesh) -> Any:
    """The AdamW moments' specs: each parameter's, plus ZeRO-1 over
    "data"."""
    base = param_pspecs(cfg, params, mesh)
    return tree_map(lambda x, s: zero1_spec(s, tuple(x.shape), mesh),
                    params, base)


def batch_pspecs(batch: Dict[str, Any], mesh) -> Dict[str, PartitionSpec]:
    ba = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    out = {}
    for k, v in batch.items():
        dims = len(v.shape)
        b = v.shape[0]
        ax = ba if (ba and b % int(np.prod([sizes[a] for a in ba])) == 0) \
            else None
        out[k] = P(*((ax,) + (None,) * (dims - 1)))
    return out


def cache_pspecs(cfg: ModelConfig, cache: Any, mesh, seq_len: int) -> Any:
    """KV cache: [L, B, S, ...] -> B on ("pod","data"), S on "model";
    recurrent states: channel/head dims on "model"."""
    ba = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    nb = int(np.prod([sizes[a] for a in ba])) if ba else 1

    def spec(path, x):
        name = path.split("/")[-1]
        shape = tuple(x.shape)
        b_ax = ba if (len(shape) > 1 and shape[1] % max(nb, 1) == 0
                      and ba) else None
        if name in ("k", "v"):            # [L,B,S,KV,hd]
            s_ax = "model" if _fits(shape[2], mesh, "model") else None
            return P(None, b_ax, s_ax, None, None)
        if name in ("c_kv", "k_rope"):    # [L,B,S,r]
            s_ax = "model" if _fits(shape[2], mesh, "model") else None
            return P(None, b_ax, s_ax, None)
        if name == "wkv":                 # [L,B,H,n,n]
            h_ax = "model" if _fits(shape[2], mesh, "model") else None
            return P(None, b_ax, h_ax, None, None)
        if name == "h":                   # [L,B,di,N]
            d_ax = "model" if _fits(shape[2], mesh, "model") else None
            return P(None, b_ax, d_ax, None)
        if name == "conv":                # [L,B,K,di]
            d_ax = "model" if _fits(shape[3], mesh, "model") else None
            return P(None, b_ax, None, d_ax)
        if name in ("tm_x", "cm_x"):      # [L,B,d]
            d_ax = "model" if _fits(shape[2], mesh, "model") else None
            return P(None, b_ax, d_ax)
        return P(*([None] * len(shape)))

    return _map_with_path(spec, cache)


def named(tree_specs: Any, mesh) -> Any:
    """A :class:`NamedSharding` for each spec of the tree; place a tree on
    the mesh with ``tree_map(lambda x, s: s.distribute(x), tree,
    named(specs, mesh))``."""
    return tree_map(lambda s: NamedSharding(mesh, s), tree_specs)


def constrain(x, spec: PartitionSpec):
    """The reference's ``with_sharding_constraint`` on the ambient mesh: a
    DTensor on that mesh is redistributed to ``spec``; anything else (a
    plain tensor, another mesh, no ambient mesh) comes back as it is."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.compat import get_abstract_mesh

    mesh = get_abstract_mesh()
    if mesh is None or not isinstance(x, DTensor) or x.device_mesh != mesh:
        return x
    want = NamedSharding(mesh, spec).placements()
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def replicate_dim(x, dim: int):
    """``x`` with tensor dim ``dim`` whole on every rank: a DTensor that
    shards that dim is all-gathered over those mesh axes, and one that
    holds partial sums is reduced, its other placements kept; anything
    else comes back as it is.  For an op that has no DTensor strategy on
    a sharded dim (a gather along it)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(x, DTensor):
        return x
    dim = dim % x.dim()
    want = tuple(Replicate() if (getattr(p, "dim", None) == dim
                                 or isinstance(p, Partial)) else p
                 for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def _whole_groups(x, dims: Sequence[int], group: int):
    """``x`` with each of ``dims`` gathered whole where a DTensor's shards
    of it do not fall on whole groups of ``group`` elements (8 KV heads
    over a 16-way axis, 25 heads over any even one), which DTensor's views
    refuse to regroup themselves; other placements are kept."""
    from torch.distributed.tensor import Replicate

    ways = {}
    for i, p in enumerate(x.placements):
        if getattr(p, "dim", None) in dims:
            ways[p.dim] = ways.get(p.dim, 1) * x.device_mesh.size(i)
    bad = {d for d, w in ways.items() if (x.shape[d] // group) % w
           or x.shape[d] % w}
    if not bad:
        return x
    want = tuple(Replicate() if getattr(p, "dim", None) in bad else p
                 for p in x.placements)
    return x.redistribute(x.device_mesh, want)


def _split(x, dim: int, n: int):
    x = _whole_groups(x, (dim,), x.shape[dim] // n)
    return x.reshape(tuple(x.shape[:dim]) + (n, x.shape[dim] // n)
                     + tuple(x.shape[dim + 1:]))


def _merge(x, dim: int):
    x = _whole_groups(x, (dim, dim + 1), 1)
    return x.reshape(tuple(x.shape[:dim]) + (x.shape[dim] * x.shape[dim + 1],)
                     + tuple(x.shape[dim + 2:]))


class _SplitDim(torch.autograd.Function):
    """[..., n·m, ...] -> [..., n, m, ...] on DTensors, regrouping shards
    in both directions (its backward merges the two dims back)."""

    @staticmethod
    def forward(ctx, x, dim, n):
        ctx.dim = dim
        return _split(x, dim, n)

    @staticmethod
    def backward(ctx, g):
        return _merge(g, ctx.dim), None, None


class _MergeDims(torch.autograd.Function):
    """[..., n, m, ...] -> [..., n·m, ...] on DTensors (the inverse of
    :class:`_SplitDim`)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        return _merge(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _split(g, ctx.dim, ctx.n), None


def split_dim(x, dim: int, n: int):
    """``x`` with dim ``dim`` (n·m long) as two dims [n, m]: a reshape, and
    on a DTensor one whose shards of that dim are gathered first where
    they do not fall on whole groups of m (and whose gradient is
    regrouped likewise)."""
    dim %= x.dim()
    if isinstance(x, _dtensor()):
        return _SplitDim.apply(x, dim, n)
    return x.reshape(tuple(x.shape[:dim]) + (n, x.shape[dim] // n)
                     + tuple(x.shape[dim + 1:]))


def merge_dims(x, dim: int):
    """``x`` with dims ``dim`` and ``dim + 1`` as one: a reshape, and on a
    DTensor one whose unevenly sharded dims are gathered first (and whose
    gradient is regrouped as :func:`split_dim` regroups)."""
    dim %= x.dim()
    if isinstance(x, _dtensor()):
        return _MergeDims.apply(x, dim)
    return x.reshape(tuple(x.shape[:dim]) + (x.shape[dim] * x.shape[dim + 1],)
                     + tuple(x.shape[dim + 2:]))


def split_last(x, n: int):
    """``x`` [..., n·m] as [..., n, m] (:func:`split_dim` on the last)."""
    return split_dim(x, -1, n)


def merge_last(x):
    """``x`` [..., n, m] as [..., n·m] (:func:`merge_dims` on the last
    two)."""
    return merge_dims(x, -2)


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def write_at(buf, dim: int, pos: int, value) -> None:
    """``buf[(:,) * dim, pos] = value``, in place.  For a DTensor that
    shards ``dim``, the write lands in the one shard that holds ``pos``,
    at its local offset (DTensor would select ``pos`` from a gathered
    copy and write into that); ``value`` is first placed as ``buf``'s
    other dims are.  Shards of ``dim`` must be even."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    index = (slice(None),) * dim
    if not isinstance(buf, DTensor):
        buf[index + (pos,)] = value
        return
    mesh = buf.device_mesh
    coord = mesh.get_coordinate()
    lo, parts = 0, 1
    want = []
    for i, p in enumerate(buf.placements):
        if isinstance(p, Shard) and p.dim == dim:
            lo, parts = lo * mesh.size(i) + coord[i], parts * mesh.size(i)
            want.append(Replicate())
        elif isinstance(p, Shard):
            want.append(Shard(p.dim - (p.dim > dim)))
        else:
            want.append(p)
    if buf.shape[dim] % parts:
        raise NotImplementedError(
            f"write_at: dim {dim} of {tuple(buf.shape)} is split unevenly "
            f"over {parts} shards")
    step = buf.shape[dim] // parts
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    local = value.redistribute(mesh, want).to_local()
    if lo * step <= pos < (lo + 1) * step:
        buf.to_local()[index + (pos - lo * step,)] = local


def resolve_partial(x):
    """A DTensor's pending partial sums reduced (``Partial`` placements
    made ``Replicate``), its shards kept; anything else comes back as it
    is.  DTensor reduces an embedding lookup from a vocab-sharded table
    (a masked partial) once only, so a lookup that feeds both a block and
    the residual is reduced where it is made."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(x, DTensor):
        return x
    want = tuple(Replicate() if isinstance(p, Partial) else p
                 for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def pad_front(x, n: int):
    """``x`` [B, S, ...] with ``n`` zero rows before its dim 1
    (``F.pad(x, (0, 0, n, 0))`` for a [B, S, d] tensor).  On a DTensor the
    zeros are concatenated, since DTensor has no sharding strategy for a
    pad on every torch version; the values are the same."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        zeros = torch.zeros_like(x.narrow(1, 0, 1)).expand(
            (x.shape[0], n) + tuple(x.shape[2:]))
        return torch.cat([zeros, x], dim=1)
    return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 2) + (n, 0))


def map_shards(fn, args: Sequence, roles: Sequence[Dict[str, int]],
               out_roles: Sequence[Dict[str, int]]):
    """``fn(*args)`` for a function that is separable along some named
    dims (each (batch, head) pair of a recurrence on its own): ``roles[j]``
    names the tensor dims of ``args[j]`` (``{"b": 0, "h": 2}``), and
    ``out_roles[k]`` those of ``fn``'s k-th output.

    With plain tensors this is ``fn(*args)``.  Where ``args[0]`` is a
    DTensor, each mesh axis that shards one of its named dims evenly
    shards that dim of every argument that has it, and every other axis
    replicates; ``fn`` then runs on each rank's local blocks, which hold
    whole slices of the separable dims, and its outputs come back as
    DTensors placed by ``out_roles``.  DTensor has no sharding strategy
    for such a recurrence (its steps' products fold a sharded batch and
    head into one dim, which DTensor refuses or plans slowly)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    lead = args[0]
    if not isinstance(lead, DTensor):
        return fn(*args)
    mesh = lead.device_mesh
    role_of = []                       # mesh axis -> role or None
    ways: Dict[str, int] = {}
    for i, p in enumerate(lead.placements):
        role = next((r for r, d in roles[0].items()
                     if isinstance(p, Shard) and p.dim == d), None)
        if role is not None:
            n = ways.get(role, 1) * mesh.size(i)
            if all(a.shape[rl[role]] % n == 0
                   for a, rl in zip(args, roles) if role in rl):
                ways[role] = n
            else:
                role = None
        role_of.append(role)

    def place(rl):
        return [Shard(rl[r]) if r in rl else Replicate() for r in role_of]

    local = []
    for a, rl in zip(args, roles):
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        local.append(a.redistribute(mesh, place(rl)).to_local())
    outs = fn(*local)
    wrapped = []
    for o, rl in zip(outs, out_roles):
        shape = [n * (ways.get(next((r for r, d in rl.items() if d == i),
                                    None), 1))
                 for i, n in enumerate(o.shape)]
        wrapped.append(DTensor.from_local(
            o, mesh, place(rl), run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride()))
    return tuple(wrapped)


def microbatch_mesh(x, rows: int):
    """The mesh a microbatch of ``rows`` rows of the batch ``x`` runs on,
    where that is not ``x``'s own: a DTensor batch on a mesh with "pod"
    and "data" whose ``rows`` fall whole on "data" but not on "pod" ×
    "data" (16 rows over 2 × 16 batch shards) runs on its mesh without
    "pod", its rows over "data", every pod the same rows; else ``None``.
    On the whole mesh DTensor would give the axis the rows leave idle to
    the ops' other dims, in shardings its planner searches for minutes
    and its views get wrong; no parameter is sharded over "pod"."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return None
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    if "pod" not in names or "data" not in names:
        return None
    sizes = axis_sizes(mesh)
    if rows % (sizes["pod"] * sizes["data"]) == 0 or rows % sizes["data"]:
        return None
    return mesh[tuple(n for n in names if n != "pod")]


def to_submesh(tree, sub):
    """Each DTensor of ``tree`` as a DTensor on ``sub``, a sub-mesh of its
    own mesh, with the same local shard: it is first replicated over the
    axes ``sub`` lacks (a no-op for the parameters, which "pod" never
    shards)."""
    from torch.distributed.tensor import DTensor, Replicate

    def move(x):
        if not isinstance(x, DTensor):
            return x
        names = x.device_mesh.mesh_dim_names
        keep = [names.index(n) for n in sub.mesh_dim_names]
        want = tuple(p if i in keep else Replicate()
                     for i, p in enumerate(x.placements))
        if want != tuple(x.placements):
            x = x.redistribute(x.device_mesh, want)
        return DTensor.from_local(x.to_local(), sub,
                                  [x.placements[i] for i in keep],
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())
    return tree_map(move, tree)


def from_submesh(tree, mesh):
    """The inverse of :func:`to_submesh`: each DTensor of ``tree`` (on a
    sub-mesh of ``mesh``) on ``mesh``, with the same local shard,
    replicated over the axes the sub-mesh lacks (which held the same
    rows)."""
    from torch.distributed.tensor import DTensor, Replicate

    names = mesh.mesh_dim_names

    def move(x):
        if not isinstance(x, DTensor):
            return x
        want = [Replicate()] * mesh.ndim
        for n, p in zip(x.device_mesh.mesh_dim_names, x.placements):
            want[names.index(n)] = p
        return DTensor.from_local(x.to_local(), mesh, want, run_check=False,
                                  shape=x.shape, stride=x.stride())
    return tree_map(move, tree)
