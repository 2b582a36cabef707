"""Checkpoint store: atomic, manifest-driven msgpack, zstd-compressed when
``zstandard`` is installed (raw msgpack otherwise — the codec is recorded in
the manifest, so mixed environments restore each other's checkpoints as long
as the reader has the writer's codec).

Layout (byte-identical to the reference package's, so each package reads
the other's checkpoints):
  <dir>/step_000123/
    manifest.json            # tree structure, shapes, dtypes, step, codec
    arrays.msgpack.zst       # flat {key: bytes} (or arrays.msgpack, raw)
  <dir>/LATEST               # atomically-updated pointer (two-phase commit)

Crash-safety contract (what the SON resume path leans on): at every point
during ``save`` there is a complete checkpoint on disk that ``restore``
can open.  The commit sequence is write-to-``.tmp`` → rename the old step
aside to ``.old`` → rename ``.tmp`` into place → flip LATEST → delete
``.old``; a crash in any window leaves either the old step (possibly under
its ``.old`` name, recovered transparently on read) or the new one.  Stale
``.tmp``/``.old`` dirs from a crashed save are wiped on the next write,
never reused.

Trees are nested dicts, lists, tuples and ``NamedTuple`` s.  A key is the
path of its leaf joined by ``/`` — dict keys sorted, a ``NamedTuple`` 's
fields as ``.<field>``, other sequence entries by index, ``None`` leaves
dropped — the keys the reference derives from jax's
``tree_flatten_with_path`` (so a ``(params, OptState)`` tree keys its
moments ``1/.mu/...``, as the reference's does).  Leaves are numpy arrays, Python scalars or
``torch.Tensor`` s on any device; ``restore`` returns tensors.  The
payload map is written and read by this module's own msgpack codec, which
knows exactly one shape: a map of str → bin.

Sharded state: ``save`` takes DTensor leaves and writes their whole
logical arrays, as the reference's store keeps unsharded arrays;
``restore(..., shardings=)`` places each array back on a mesh as a DTensor
(the elastic re-shard, ``checkpoint/elastic.py``).
"""
from __future__ import annotations

import json
import os
import shutil
import struct
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

try:
    import zstandard as zstd
    HAVE_ZSTD = True
except ImportError:          # optional dependency — fall back to raw msgpack
    zstd = None
    HAVE_ZSTD = False

_CODEC_FILES = {"zstd": "arrays.msgpack.zst", "raw": "arrays.msgpack"}


def _encode(blob: bytes, codec: str) -> bytes:
    if codec == "zstd":
        return zstd.ZstdCompressor(level=3).compress(blob)
    return blob


def _decode(blob: bytes, codec: str) -> bytes:
    if codec == "zstd":
        if not HAVE_ZSTD:
            raise ImportError(
                "checkpoint was written with the zstd codec but the "
                "'zstandard' package is not installed")
        return zstd.ZstdDecompressor().decompress(blob)
    return blob


# ---------------------------------------------------------------------------
# msgpack: a map of str -> bin, nothing else
# ---------------------------------------------------------------------------

def _header(n: int, fix: Optional[Tuple[int, int]],
            wide: Tuple[Tuple[int, int, str], ...]) -> bytes:
    """The shortest msgpack header for length ``n``: a fix form
    ``(tag, max)`` when given, else the first ``(tag, max, struct fmt)``."""
    if fix is not None and n <= fix[1]:
        return bytes([fix[0] | n])
    for tag, top, fmt in wide:
        if n <= top:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} exceeds 2**32 - 1")


_U8, _U16, _U32 = 0xFF, 0xFFFF, 0xFFFFFFFF
_MAP = ((0x80, 15), ((0xDE, _U16, ">H"), (0xDF, _U32, ">I")))
_STR = ((0xA0, 31), ((0xD9, _U8, ">B"), (0xDA, _U16, ">H"),
                     (0xDB, _U32, ">I")))
_BIN = (None, ((0xC4, _U8, ">B"), (0xC5, _U16, ">H"), (0xC6, _U32, ">I")))


def msgpack_pack(payload: Dict[str, bytes]) -> bytes:
    """``payload`` as msgpack: the bytes ``msgpack.packb`` gives for a
    dict of str → bytes."""
    parts = [_header(len(payload), *_MAP)]
    for key, value in payload.items():
        k = key.encode("utf-8")
        v = bytes(value)
        parts += [_header(len(k), *_STR), k, _header(len(v), *_BIN), v]
    return b"".join(parts)


def _read_len(blob: bytes, pos: int, fix: Optional[Tuple[int, int]],
              wide: Tuple[Tuple[int, int, str], ...], what: str
              ) -> Tuple[int, int]:
    """(length, position after the header) of a ``what`` header at pos."""
    if pos >= len(blob):
        raise ValueError(f"msgpack payload truncated before a {what}")
    tag = blob[pos]
    if fix is not None and tag & ~fix[1] & 0xFF == fix[0]:
        return tag & fix[1], pos + 1
    for wtag, _, fmt in wide:
        if tag == wtag:
            end = pos + 1 + struct.calcsize(fmt)
            if end > len(blob):
                raise ValueError(f"msgpack payload truncated in a {what} "
                                 "header")
            return struct.unpack_from(fmt, blob, pos + 1)[0], end
    raise ValueError(f"msgpack type byte 0x{tag:02x} at offset {pos} is not "
                     f"a {what} (this store reads a map of str -> bin only)")


def _take(blob: bytes, pos: int, n: int, what: str) -> bytes:
    if pos + n > len(blob):
        raise ValueError(f"msgpack payload truncated in a {what}")
    return blob[pos:pos + n]


def msgpack_unpack(blob: bytes) -> Dict[str, bytes]:
    """Inverse of :func:`msgpack_pack`: ``ValueError`` on any other type."""
    n, pos = _read_len(blob, 0, *_MAP, "map")
    out: Dict[str, bytes] = {}
    for _ in range(n):
        klen, pos = _read_len(blob, pos, *_STR, "str")
        key = _take(blob, pos, klen, "str").decode("utf-8")
        vlen, pos = _read_len(blob, pos + klen, *_BIN, "bin")
        out[key] = _take(blob, pos, vlen, "bin")
        pos += vlen
    if pos != len(blob):
        raise ValueError(f"{len(blob) - pos} bytes after the msgpack map")
    return out


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(type(tree), "_fields")


def _children(tree: Any):
    """(key, child) pairs of a dict (sorted keys), a ``NamedTuple`` (its
    fields as ``.<field>``, jax's ``GetAttrKey``) or a list or tuple (its
    indices)."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", v) for f, v in zip(type(tree)._fields, tree)]
    return [(str(i), v) for i, v in enumerate(tree)]


def _paths(tree: Any, prefix: Tuple[str, ...] = ()):
    """(path, leaf) pairs in the reference's leaf order."""
    if tree is None:
        return
    if isinstance(tree, (dict, list, tuple)):
        for key, child in _children(tree):
            yield from _paths(child, prefix + (key,))
    else:
        yield prefix, tree


def _flatten(tree: Any) -> Dict[str, Any]:
    return {"/".join(path): leaf for path, leaf in _paths(tree)}


def _unflatten(like: Any, flat: Dict[str, Any],
               prefix: Tuple[str, ...] = ()) -> Any:
    """``like``'s structure with each leaf replaced by ``flat[key]``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        fields = [_unflatten(v, flat, prefix + (key,))
                  for key, v in _children(like)]
        return type(like)(*fields) if _is_namedtuple(like) \
            else type(like)(fields)
    return flat["/".join(prefix)]


def _is_dtensor(leaf: Any) -> bool:
    if not isinstance(leaf, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """(wire array, original dtype tag): bfloat16 travels as its uint16
    view, since numpy has no bfloat16."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    tag = str(arr.dtype)
    if tag == "bfloat16":        # a numpy array of ml_dtypes' bfloat16
        arr = arr.view(np.uint16)
    return arr, tag


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:09d}")


def _is_complete(step_dir: str) -> bool:
    """The manifest is written last inside the tmp dir, so its presence
    marks a fully-written checkpoint."""
    return os.path.isfile(os.path.join(step_dir, "manifest.json"))


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[Dict] = None,
         codec: Optional[str] = None, keep_last: Optional[int] = None) -> str:
    """Write one checkpoint; some complete checkpoint survives a crash at
    any point.  ``keep_last=N`` prunes all but the newest N steps after the
    commit (the step LATEST points at is never pruned).

    A tree with DTensor leaves is saved SPMD: every rank of their meshes
    calls ``save`` with its shards, each leaf is gathered whole on every
    rank (``full_tensor``, a collective), rank 0 of the default process
    group alone writes the step, and every rank waits at a barrier until
    it is committed, so that a ``restore`` that follows on any rank reads
    it.  Other trees are written by whichever process calls ``save``."""
    if codec is None:
        codec = "zstd" if HAVE_ZSTD else "raw"
    if codec not in _CODEC_FILES:
        raise ValueError(f"unknown codec {codec!r}")
    if codec == "zstd" and not HAVE_ZSTD:
        raise ImportError("codec='zstd' requires the 'zstandard' package")
    flat = _flatten(tree)
    step_dir = _step_dir(ckpt_dir, step)
    if any(_is_dtensor(leaf) for leaf in flat.values()):
        import torch.distributed as dist

        flat = {k: v.full_tensor() if _is_dtensor(v) else v
                for k, v in flat.items()}
        if dist.get_rank() == 0:
            _write(ckpt_dir, step_dir, step, flat, extra, codec, keep_last)
        dist.barrier()
        return step_dir
    _write(ckpt_dir, step_dir, step, flat, extra, codec, keep_last)
    return step_dir


def _write(ckpt_dir: str, step_dir: str, step: int, flat: Dict[str, Any],
           extra: Optional[Dict], codec: str,
           keep_last: Optional[int]) -> None:
    """Write and commit one step of whole arrays."""
    tmp = step_dir + ".tmp"
    old = step_dir + ".old"
    # a crashed save may have left a stale .tmp (half-written payloads —
    # reusing it mixes files across codecs) or a stale .old (already
    # superseded, or about to be recovered by the read below); at the start
    # of a new save neither is load-bearing, so wipe both
    if os.path.isdir(step_dir) and not _is_complete(step_dir):
        # crashed mid-commit: the half-renamed dir is garbage, the intact
        # old step (if any) is still under .old — put it back first
        shutil.rmtree(step_dir)
        if _is_complete(old):
            os.rename(old, step_dir)
    for stale in (tmp, old):
        if os.path.exists(stale):
            shutil.rmtree(stale)
    os.makedirs(tmp)

    manifest = {"step": step, "extra": extra or {}, "codec": codec,
                "arrays": {}}
    payload: Dict[str, bytes] = {}
    for key in sorted(flat):
        arr, tag = _to_numpy(flat[key])
        manifest["arrays"][key] = {"shape": list(arr.shape),
                                   "dtype": str(arr.dtype),
                                   "orig_dtype": tag}
        payload[key] = arr.tobytes()

    with open(os.path.join(tmp, _CODEC_FILES[codec]), "wb") as f:
        f.write(_encode(msgpack_pack(payload), codec))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)

    # commit: rename the old step ASIDE (never delete-then-rename — a crash
    # in that window would leave LATEST pointing at nothing), move the new
    # dir into place, flip LATEST, and only then drop the old step
    have_old = os.path.exists(step_dir)
    if have_old:
        os.rename(step_dir, old)
    os.rename(tmp, step_dir)
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(step_dir))
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    if have_old:
        shutil.rmtree(old)
    if keep_last is not None:
        _prune(ckpt_dir, keep_last)


def _prune(ckpt_dir: str, keep_last: int) -> None:
    keep_last = max(1, int(keep_last))
    present = steps_present(ckpt_dir)
    latest = latest_step(ckpt_dir)
    for s in present[:-keep_last]:
        if s == latest:          # never prune the committed pointer target
            continue
        for suffix in ("", ".old"):
            d = _step_dir(ckpt_dir, s) + suffix
            if os.path.exists(d):
                shutil.rmtree(d)


def steps_present(ckpt_dir: str) -> List[int]:
    """Steps with a complete checkpoint on disk — including steps only
    reachable through a crashed save's ``.old`` dir (recovered on read)."""
    steps = set()
    if not os.path.isdir(ckpt_dir):
        return []
    for name in os.listdir(ckpt_dir):
        stem = name[:-4] if name.endswith(".old") else name
        if not (stem.startswith("step_") and stem[5:].isdigit()):
            continue
        if _is_complete(os.path.join(ckpt_dir, name)):
            steps.add(int(stem[5:]))
    return sorted(steps)


def _resolve_step_dir(ckpt_dir: str, step: int) -> Optional[str]:
    """Directory of a complete checkpoint for ``step``, recovering from a
    save that crashed between rename-aside and commit; None if absent."""
    d = _step_dir(ckpt_dir, step)
    if _is_complete(d):
        return d
    old = d + ".old"
    if _is_complete(old):
        # crash window: the new dir never landed (or landed half-written)
        # but the previous checkpoint is intact under .old — restore it to
        # its real name so LATEST and future saves see a normal store
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(old, d)
        return d
    return None


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest restorable step.  A LATEST pointer whose directory was
    deleted (or never committed) is not trusted — fall back to the newest
    complete checkpoint actually on disk."""
    p = os.path.join(ckpt_dir, "LATEST")
    present = steps_present(ckpt_dir)
    if os.path.exists(p):
        with open(p) as f:
            step = int(f.read().strip().split("_")[-1])
        if step in present:
            return step
    return present[-1] if present else None


def _missing_step_error(ckpt_dir: str, step: Optional[int]) -> FileNotFoundError:
    present = steps_present(ckpt_dir)
    have = ", ".join(str(s) for s in present) if present else "none"
    what = "no checkpoint" if step is None else f"checkpoint step {step} not"
    return FileNotFoundError(
        f"{what} found under {ckpt_dir} (steps present: {have})")


def _read_payload(ckpt_dir: str, step: Optional[int]
                  ) -> Tuple[Dict, Dict[str, bytes], int]:
    """Resolve + validate a step, returning (manifest, payload, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise _missing_step_error(ckpt_dir, None)
    step_dir = _resolve_step_dir(ckpt_dir, step)
    if step_dir is None:
        raise _missing_step_error(ckpt_dir, step)
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    codec = manifest.get("codec", "zstd")   # pre-codec checkpoints were zstd
    if codec not in _CODEC_FILES:
        raise ValueError(f"checkpoint {step_dir} uses unknown codec {codec!r}")
    with open(os.path.join(step_dir, _CODEC_FILES[codec]), "rb") as f:
        payload = msgpack_unpack(_decode(f.read(), codec))
    return manifest, payload, step


def _as_array(meta: Dict, raw: bytes) -> np.ndarray:
    """The stored array, writable (bfloat16 stays its uint16 view)."""
    return np.frombuffer(raw, dtype=meta["dtype"]).reshape(
        meta["shape"]).copy()


def _as_tensor(meta: Dict, raw: bytes,
               device: Union[str, torch.device, None]) -> torch.Tensor:
    arr = _as_array(meta, raw)
    if meta["orig_dtype"] == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t if device is None else t.to(device)


def load_arrays(ckpt_dir: str, step: Optional[int] = None
                ) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Restore a checkpoint as a flat ``{key: writable numpy array}`` plus
    its extra dict, with no ``like`` tree — the resume path for state whose
    shapes are only known from the checkpoint itself (SON's per-level
    candidate arrays grow between boundaries).  A bfloat16 array comes
    back as its uint16 view (numpy has no bfloat16); its manifest entry's
    ``orig_dtype`` says so."""
    manifest, payload, _ = _read_payload(ckpt_dir, step)
    out = {}
    for key, meta in manifest["arrays"].items():
        out[key] = _as_array(meta, payload[key])
    return out, manifest["extra"]


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None,
            shardings: Any = None,
            device: Union[str, torch.device, None] = None
            ) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (shapes validated) as torch
    tensors on ``device`` (the CPU when None), bfloat16 leaves as
    ``torch.bfloat16``.

    ``shardings`` (a tree matching ``like`` of
    :class:`repro_torch.distributed.meshes.NamedSharding`, as
    ``meshes.named`` builds it) places each array it names on its mesh as
    a DTensor: every rank of the mesh reads the step and keeps its own
    block on the mesh's device type; ``device`` is then unused for those
    leaves.  This is the elastic re-shard path."""
    manifest, payload, _ = _read_payload(ckpt_dir, step)
    flat_shard = _flatten(shardings) if shardings is not None else {}
    out = {}
    for key, leaf in _flatten(like).items():
        meta = manifest["arrays"][key]
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if tuple(meta["shape"]) != want:
            raise AssertionError((key, tuple(meta["shape"]), want))
        if key in flat_shard:
            out[key] = flat_shard[key].distribute(
                _as_tensor(meta, payload[key], None))
        else:
            out[key] = _as_tensor(meta, payload[key], device)
    return _unflatten(like, out), manifest["extra"]
