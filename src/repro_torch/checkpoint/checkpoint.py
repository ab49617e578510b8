"""Checkpointing: atomic, manifest-driven, async-capable, integrity-checked
-- the JAX package's ``checkpoint/checkpoint.py`` on torch trees.

Layout:  <dir>/step_<N>/manifest.json + arrays.npz  (the JAX package's: a
checkpoint written by either package verifies under the other)
  * save writes to a unique ``step_<N>.tmp-*`` then os.rename's -- a crashed
    save can never shadow a good checkpoint (fault-tolerance invariant #1).
  * a tree is NamedTuples, tuples, lists, dicts, tensors, numpy arrays,
    Python ints and floats and ``torch.Generator``s; every leaf is keyed by
    its field path, ``"/"``-joined as the JAX package keys the same
    structure (``None`` subtrees vanish).  A generator is stored as its
    ``get_state()`` (a uint8 array) and restored into the template's
    generator with ``set_state`` -- the port's states own their
    generators, so this is what makes a resume bit-exact.  An int is a 0-d
    int64 array, a float a 0-d float64 array, restored as int / float.
  * ``async_save`` copies every leaf to host memory on the caller's thread
    (at a boundary where the caller has synced already: the supervisor
    calls it right after its one health read) and hands only numpy arrays
    to a writer thread.  Both paths route through one ``_write``;
    concurrent saves of the same step are serialized by a per-directory
    lock (last writer wins, no torn dir); at most 4 writer threads are in
    flight.
  * the manifest carries a crc32 **checksum per array** (and the key set),
    so ``verify`` detects bit-rot / truncation without a restore and
    ``latest_good_step`` can pick the newest checkpoint that actually
    loads -- quarantining corrupt step dirs instead of handing them to the
    resume path (fault-tolerance invariant #2: never resume from a
    checkpoint that fails verification).

Arrays are written whole (global shapes): the dist supervisor gathers its
ranks' parts on rank 0 before it saves, and each rank restores its own
slice, so a checkpoint restores onto any mesh.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import uuid
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["save", "async_save", "restore", "latest_step",
           "latest_good_step", "verify", "read_manifest", "wait_pending",
           "flatten", "map_leaves", "to_host"]

_PENDING: List[threading.Thread] = []
_MAX_PENDING = 4                       # writer threads in flight, bounded

_DIR_LOCKS: Dict[str, threading.Lock] = {}
_DIR_LOCKS_GUARD = threading.Lock()


def _dir_lock(directory: str) -> threading.Lock:
    key = os.path.abspath(directory)
    with _DIR_LOCKS_GUARD:
        return _DIR_LOCKS.setdefault(key, threading.Lock())


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(node):
    """``(key, child)`` pairs of an inner node in the JAX package's
    flattening order (dict keys sorted), or None for a leaf."""
    if _is_namedtuple(node):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(node)]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    return None


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{"a/b/...": leaf}`` for every non-None leaf of ``tree``."""
    items = _items(tree)
    if items is None:
        return {} if tree is None else {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def map_leaves(fn, tree, prefix: str = ""):
    """``tree`` with every non-None leaf replaced by ``fn(path, leaf)``
    (``path`` as :func:`flatten` keys it)."""
    path = lambda k: f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, path(k)) for k, v in tree.items()}
    items = _items(tree)
    if items is None:
        return None if tree is None else fn(prefix, tree)
    vals = [map_leaves(fn, v, path(k)) for k, v in items]
    if _is_namedtuple(tree):
        return type(tree)(*vals)
    return tuple(vals) if isinstance(tree, tuple) else vals


def _leaf_to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy().copy()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        # a CPU tensor's numpy view shares its buffer: copy, since the
        # caller keeps updating its state in place
        return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, np.int64)
    if isinstance(leaf, (float, np.floating)):
        return np.asarray(leaf, np.float64)
    return np.array(leaf, copy=True)


def to_host(tree) -> Dict[str, np.ndarray]:
    """Every leaf of ``tree`` as a numpy array (a copy), keyed by path.  A
    tensor on the card is copied to the host here, which waits for the
    device: call it at a boundary that has synced already."""
    return {k: _leaf_to_host(v) for k, v in flatten(tree).items()}


def _checksum(arr: np.ndarray) -> int:
    """crc32 over the array bytes (C-contiguous, shape/dtype pinned by the
    manifest fields next to it)."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _write(directory: str, step: int, host: Dict[str, np.ndarray],
           extra: Optional[dict]) -> str:
    """The ONE checkpoint writer: tmp dir -> arrays.npz + manifest.json ->
    atomic rename.  Serialized per directory so concurrent saves of the
    same step can't interleave their rm/rename (last writer wins)."""
    from ..obs import get_recorder
    rec = get_recorder()
    nbytes = sum(int(v.nbytes) for v in host.values())
    with rec.span("checkpoint/save", step=step, bytes=nbytes):
        out = _write_locked(directory, step, host, extra)
    rec.count("checkpoint_saves_total", 1)
    rec.count("checkpoint_bytes_total", nbytes)
    return out


def _write_locked(directory: str, step: int, host: Dict[str, np.ndarray],
                  extra: Optional[dict]) -> str:
    with _dir_lock(directory):
        os.makedirs(directory, exist_ok=True)
        final = os.path.join(directory, f"step_{step:08d}")
        # unique suffix: a crashed writer's leftover tmp never collides
        tmp = f"{final}.tmp-{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp)
        try:
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{k.replace("/", "::"): v for k, v in host.items()})
            manifest = {
                "step": step,
                "keys": sorted(host.keys()),
                "shapes": {k: list(v.shape) for k, v in host.items()},
                "dtypes": {k: str(v.dtype) for k, v in host.items()},
                "checksums": {k: _checksum(v) for k, v in host.items()},
                "extra": extra or {},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
    return final


def save(directory: str, step: int, tree, extra: Optional[dict] = None
         ) -> str:
    return _write(directory, step, to_host(tree), extra)


def async_save(directory: str, step: int, tree,
               extra: Optional[dict] = None) -> threading.Thread:
    """Snapshot to host memory now; write files on a background thread.

    At most ``_MAX_PENDING`` writer threads are tracked in flight -- the
    caller blocks on the oldest when the bound is hit, so a slow disk
    backpressures instead of accumulating unbounded snapshots."""
    host = to_host(tree)
    while len(_PENDING) >= _MAX_PENDING:
        _PENDING.pop(0).join()
    t = threading.Thread(target=_write, args=(directory, step, host, extra),
                         daemon=True)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending():
    while _PENDING:
        _PENDING.pop().join()


def _step_dirs(directory: str) -> Dict[int, str]:
    if not os.path.isdir(directory):
        return {}
    out = {}
    for d in os.listdir(directory):
        if (m := re.fullmatch(r"step_(\d+)", d)):
            out[int(m.group(1))] = os.path.join(directory, d)
    return out


def verify(directory: str, step: int) -> List[str]:
    """Integrity-check one checkpoint; returns a list of problems ([] = ok).

    Checks: manifest present and parseable, arrays.npz present and
    loadable, key sets match, per-array shape/dtype match the manifest,
    and (when the manifest carries them) per-array crc32 checksums."""
    from ..obs import get_recorder
    with get_recorder().span("checkpoint/verify", step=step):
        return _verify_inner(directory, step)


def _verify_inner(directory: str, step: int) -> List[str]:
    path = os.path.join(directory, f"step_{step:08d}")
    problems: List[str] = []
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return [f"manifest unreadable: {e}"]
    try:
        with np.load(os.path.join(path, "arrays.npz")) as data:
            host = {k.replace("::", "/"): data[k] for k in data.files}
    except Exception as e:  # noqa: BLE001 -- np.load raises many types
        return [f"arrays unreadable: {e}"]
    keys = set(manifest.get("keys", []))
    if keys != set(host):
        problems.append(f"key mismatch: manifest {sorted(keys)[:3]}... vs "
                        f"arrays {sorted(host)[:3]}...")
        return problems
    sums = manifest.get("checksums", {})
    for k, v in host.items():
        if list(v.shape) != manifest["shapes"].get(k):
            problems.append(f"shape mismatch at {k!r}")
        elif str(v.dtype) != manifest["dtypes"].get(k):
            problems.append(f"dtype mismatch at {k!r}")
        elif k in sums and _checksum(v) != sums[k]:
            problems.append(f"checksum mismatch at {k!r}")
    return problems


def _quarantine(path: str):
    dst = path + ".corrupt"
    if os.path.exists(dst):
        shutil.rmtree(dst)
    os.rename(path, dst)


def latest_step(directory: str) -> Optional[int]:
    """Newest step whose dir has a parseable manifest and an arrays file.

    A partially written / damaged step dir (missing or unloadable
    ``manifest.json``, missing ``arrays.npz``) is skipped, never returned
    as a restore target.  For full content verification (checksums) use
    :func:`latest_good_step`."""
    for step, path in sorted(_step_dirs(directory).items(), reverse=True):
        if not os.path.exists(os.path.join(path, "arrays.npz")):
            continue
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                json.load(f)
        except (OSError, ValueError):
            continue
        return step
    return None


def latest_good_step(directory: str, *, quarantine: bool = False
                     ) -> Optional[int]:
    """Newest step that passes :func:`verify`, scanning backwards.

    ``quarantine=True`` renames failing step dirs to ``*.corrupt`` so they
    are never rescanned (and a post-mortem can still inspect them)."""
    for step, path in sorted(_step_dirs(directory).items(), reverse=True):
        if not verify(directory, step):
            return step
        if quarantine:
            _quarantine(path)
    return None


def read_manifest(directory: str, step: int) -> dict:
    """The manifest of one checkpoint (carries the caller's ``extra`` -- the
    supervisor records its engine name / outer step there, so a fresh
    process can resume the right engine)."""
    path = os.path.join(directory, f"step_{step:08d}", "manifest.json")
    with open(path) as f:
        return json.load(f)


def restore(directory: str, step: int, like) -> Any:
    """Rebuild the tree ``like`` (structure donor) from a checkpoint.

    Each tensor leaf comes back with the template's dtype and device and
    the STORED shape (the supervisor's ``reshard_dp`` re-bins a changed
    data-parallel axis); numpy leaves come back as numpy arrays the same
    way; a generator leaf is the template's own generator, its state set
    from the checkpoint; int / float leaves as Python numbers."""
    from ..obs import get_recorder
    with get_recorder().span("checkpoint/restore", step=step):
        return _restore_inner(directory, step, like)


def _restore_inner(directory: str, step: int, like) -> Any:
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        host = {k.replace("::", "/"): data[k] for k in data.files}
    missing = [k for k in flatten(like) if k not in host]
    if missing:
        raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
    return map_leaves(lambda k, leaf: _leaf_from_host(leaf, host[k]), like)


def _leaf_from_host(leaf, arr: np.ndarray):
    if isinstance(leaf, torch.Generator):
        leaf.set_state(torch.from_numpy(np.ascontiguousarray(arr, np.uint8)))
        return leaf
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, (int, np.integer)):
        return int(arr)
    if isinstance(leaf, (float, np.floating)):
        return float(arr)
    return np.asarray(arr).astype(np.asarray(leaf).dtype)
