"""Fault-tolerant checkpointing in the reference's on-disk format.

Counterpart of ``repro/train/checkpoint.py``: atomic and durable saves,
incremental delta chains, retention, validated restore.  The files are
the reference's, so a checkpoint written by either package restores in
the other:

* ``save_incremental`` (and ``CheckpointManager.save``) writes one
  ``step_<n>.ckpt`` npz holding the arrays ``d{i}`` and the JSON
  manifest as the uint8 array ``__manifest__``: leaf ``names``,
  ``dtypes``, ``shapes``, the per-leaf ``delta`` spec, ``base_step`` for
  a delta, and the caller's ``meta``.  ``save`` writes the legacy
  ``step_<n>/`` directory (``arrays.npz`` with ``a{i}`` and
  ``manifest.json``); ``restore`` reads both and replays delta chains.
* Leaf names and order are those of ``jax.tree_util.
  tree_flatten_with_path`` on the reference's state: NamedTuple fields
  in field order, dict keys sorted, list items by index, ``None`` no
  leaf, the path components joined with ``/``.  The port's state types
  keep the reference's field order, so a port state and a reference
  state of one configuration flatten to the same names.
* Python ints, floats and bools (the port's host counters: ``step``,
  ``pos``, ``size``, ``total_adds``, ...) are stored as 0-d int32,
  float32 and bool arrays, the dtypes jax gives them, and restored as
  Python scalars of their target.
* bfloat16 (and the float8 kinds) are stored as a same-width unsigned
  integer view with the true dtype name in the manifest, and read back
  through ``torch.Tensor.view``; numpy alone writes and reads them.
* Every payload file is fsync'd before its atomic rename, and the
  directory after it, so a checkpoint survives power loss; ``*.tmp``
  litter from a crashed save is never the latest checkpoint.

``restore`` validates the manifest's leaf names and dtypes against the
target and fails with a readable diff, and puts each leaf on the device
of its target leaf (or on ``device``), the counterpart of the
reference's ``shardings``.  ``CheckpointManager`` keeps the newest
``keep`` checkpoints plus the bases their delta chains need, compacts a
chain with a full save every ``full_every`` saves, and exposes the
preemption flag (SIGTERM hook on the main thread, ``request_preemption``
from any thread, or the one-shot ``PREEMPT`` sentinel file).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import signal
import threading
from typing import Any, Optional

import numpy as np
import torch

# dtypes numpy's npz format cannot store natively -> saved as a same-width
# unsigned integer view, with the true dtype recorded in the manifest.
_VIEW_DTYPES = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8),
}
_TORCH_BY_NAME = {name: t for name, (t, _, _) in _VIEW_DTYPES.items()}

PREEMPT_SENTINEL = "PREEMPT"

# The dtypes jax (without x64) gives Python scalars.
_SCALAR_DTYPES = ((bool, np.bool_), (int, np.int32), (float, np.float32))


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(node: Any):
    """(name, child) pairs of a container node in jax's flatten order, or
    None for a leaf.  ``None`` children are empty subtrees."""
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten_with_names(tree: Any):
    """``(names, leaves)`` of ``tree`` in the reference's order."""
    names, leaves = [], []

    def walk(node, path):
        if node is None:
            return
        items = _items(node)
        if items is None:
            names.append("/".join(path))
            leaves.append(node)
            return
        for name, child in items:
            walk(child, path + (name,))

    walk(tree, ())
    return names, leaves


def _unflatten(tree: Any, leaves) -> Any:
    """``tree``'s structure with its leaves replaced, in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(tree)


class Rows:
    """Dirty spec for one leaf: the leading-dim row ranges that changed.

    ``ranges`` is a list of half-open ``(start, stop)`` pairs; a ring arc
    that wraps the capacity boundary is two ranges.  Used as a leaf value
    inside a dirty tree (see :func:`save_incremental`); the other two
    spec values are plain bools (True = whole leaf, False = skip).
    """

    __slots__ = ("ranges",)

    def __init__(self, ranges):
        self.ranges = [(int(s), int(e)) for s, e in ranges]

    def __repr__(self):
        return f"Rows({self.ranges!r})"


def dirty_like(tree: Any, flag: Any = True) -> Any:
    """A dirty tree marking every leaf of ``tree`` with ``flag``."""
    return _unflatten(tree, [flag] * len(_flatten_with_names(tree)[1]))


def _normalize_ranges(ranges, n_rows: int):
    """Sorted, merged, bounds-checked half-open ranges over [0, n_rows)."""
    out = []
    for s, e in sorted((int(s), int(e)) for s, e in ranges):
        if s < 0 or e > n_rows:
            raise ValueError(
                f"dirty range ({s}, {e}) outside leading dim {n_rows}")
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _scalar_dtype(leaf: Any):
    for kind, dtype in _SCALAR_DTYPES:
        if type(leaf) is kind:
            return np.dtype(dtype)
    return None


def _leaf_dtype_name(leaf: Any) -> str:
    """The manifest's dtype name of a leaf (tensor, array or scalar)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    scalar = _scalar_dtype(leaf)
    if scalar is not None:
        return scalar.name
    return np.dtype(leaf.dtype).name


def _leaf_shape(leaf: Any) -> list[int]:
    return list(leaf.shape) if hasattr(leaf, "shape") else []


def _leaf_storable(leaf: Any) -> np.ndarray:
    """A leaf as the numpy array the npz stores (views for bfloat16 and
    float8; Python scalars at the dtype jax gives them)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = _leaf_dtype_name(t)
        if name in _VIEW_DTYPES:
            _, as_int, np_view = _VIEW_DTYPES[name]
            return t.view(as_int).cpu().numpy().view(np_view)
        return t.cpu().numpy()
    scalar = _scalar_dtype(leaf)
    if scalar is not None:
        return np.asarray(leaf, dtype=scalar)
    return np.asarray(leaf)


def _rows_storable(leaf: Any, ranges) -> np.ndarray:
    """The stored form of a leaf's leading-dim ``ranges`` only: a tensor
    is gathered on its device in one indexing op, so only those rows
    cross to the host."""
    rows = np.concatenate([np.arange(s, e) for s, e in ranges])
    if isinstance(leaf, torch.Tensor):
        return _leaf_storable(leaf[torch.from_numpy(rows).to(leaf.device)])
    return _leaf_storable(leaf)[rows]


def _from_storable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored array as a tensor of its true dtype (CPU, shares memory)."""
    arr = np.require(arr, requirements="C")  # keeps a 0-d array 0-d
    if dtype_name in _VIEW_DTYPES:
        _, as_int, _ = _VIEW_DTYPES[dtype_name]
        signed = np.dtype(str(as_int).removeprefix("torch."))
        return torch.from_numpy(arr.view(signed)).view(
            _TORCH_BY_NAME[dtype_name])
    return torch.from_numpy(arr)


def save(directory: str, step: int, tree: Any,
         meta: dict | None = None) -> str:
    """Atomic, durable checkpoint write in the directory layout
    (``step_<n>/arrays.npz`` + ``manifest.json``).  Returns the final
    path.  ``meta``: an optional JSON-able dict stored in the manifest,
    read back cheaply with :func:`load_meta`."""
    os.makedirs(directory, exist_ok=True)
    final = _dir_path(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    names, leaves = _flatten_with_names(tree)
    raw = [_leaf_storable(leaf) for leaf in leaves]
    arrays_path = os.path.join(tmp, "arrays.npz")
    with open(arrays_path, "wb") as f:
        np.savez(f, **{f"a{i}": a for i, a in enumerate(raw)})
        f.flush()
        os.fsync(f.fileno())
    manifest = {
        "step": step,
        "names": names,
        "dtypes": [_leaf_dtype_name(leaf) for leaf in leaves],
        "shapes": [list(a.shape) for a in raw],
    }
    if meta is not None:
        manifest["meta"] = meta
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    # The rename is only durable once the directory entries themselves
    # are on disk: fsync the tmp dir (its two new files), then the parent.
    _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_dir(directory)
    return final


def _file_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}.ckpt")


def _dir_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}")


def checkpoint_exists(directory: str, step: int) -> bool:
    return (os.path.exists(_file_path(directory, step))
            or os.path.exists(os.path.join(_dir_path(directory, step),
                                           "manifest.json")))


def save_incremental(directory: str, step: int, tree: Any,
                     base_step: int | None = None, dirty: Any = None,
                     meta: dict | None = None) -> str:
    """Single-file durable save of the leaves changed since ``base_step``.

    ``dirty`` has the structure of ``tree``, with the leaves ``True``
    (save the whole leaf), ``False`` (unchanged since the base: skip) or
    a :class:`Rows` of leading-dim row ranges (only those rows are
    written; a tensor is sliced on its device).  Build it with
    :func:`dirty_like` and ``Rows``.  With ``base_step=None`` and no
    ``dirty`` every leaf is saved: a self-contained full checkpoint.

    The whole checkpoint, manifest included, is ONE ``step_<n>.ckpt``
    npz, fsync'd and atomically renamed; :func:`restore` replays the
    chain.
    """
    os.makedirs(directory, exist_ok=True)
    if base_step is None and dirty is not None:
        raise ValueError("dirty spec without a base_step: an incremental "
                         "save needs the base it is relative to")
    if base_step is not None:
        if base_step >= step:
            raise ValueError(f"base_step {base_step} must precede step {step}")
        if not checkpoint_exists(directory, base_step):
            raise ValueError(f"incremental save at step {step}: base step "
                             f"{base_step} not found in {directory}")
    names, leaves = _flatten_with_names(tree)
    if dirty is None:
        dleaves = [True] * len(leaves)
    else:
        dleaves = _flatten_with_names(dirty)[1]
        if len(dleaves) != len(leaves):
            raise ValueError(
                f"dirty tree has {len(dleaves)} leaves, tree has "
                f"{len(leaves)}; build it with dirty_like(subtree, flag) "
                f"so the structures align")
    arrays, spec, dtypes, shapes = {}, [], [], []
    for i, (leaf, d) in enumerate(zip(leaves, dleaves)):
        # The manifest's dtype and shape come from metadata alone: a
        # skipped leaf costs no device-to-host copy.
        dtypes.append(_leaf_dtype_name(leaf))
        shape = _leaf_shape(leaf)
        shapes.append(shape)
        if d is False:
            spec.append(None)
            continue
        if d is True:
            spec.append(True)
            arrays[f"d{i}"] = _leaf_storable(leaf)
            continue
        if not isinstance(d, Rows):
            raise ValueError(f"dirty leaf {names[i]}: expected bool or "
                             f"Rows, got {type(d).__name__}")
        if not shape:
            raise ValueError(f"dirty leaf {names[i]}: Rows spec on a "
                             f"rank-0 leaf")
        ranges = _normalize_ranges(d.ranges, shape[0])
        if not ranges:
            spec.append(None)
            continue
        spec.append([[s, e] for s, e in ranges])
        arrays[f"d{i}"] = _rows_storable(leaf, ranges)
    manifest = {"step": step, "names": names, "dtypes": dtypes,
                "shapes": shapes, "delta": spec}
    if base_step is not None:
        manifest["base_step"] = base_step
    if meta is not None:
        manifest["meta"] = meta
    arrays["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode("utf-8"), np.uint8)
    final = _file_path(directory, step)
    if os.path.exists(_dir_path(directory, step)):
        raise ValueError(f"step {step} already exists as a directory "
                         f"checkpoint; refusing to shadow it with a file")
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    _fsync_dir(directory)
    return final


def available_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(directory, d, "manifest.json")):
            out.append(int(m.group(1)))
            continue
        m = re.fullmatch(r"step_(\d+)\.ckpt", d)
        if m:
            out.append(int(m.group(1)))
    return sorted(set(out))


def gc_stale_tmp(directory: str) -> list[str]:
    """Remove ``step_*.tmp`` litter left behind by crashed saves (both
    layouts).  Only call when no save is in flight in this directory.
    Returns the removed paths."""
    if not os.path.isdir(directory):
        return []
    removed = []
    for d in os.listdir(directory):
        path = os.path.join(directory, d)
        if re.fullmatch(r"step_\d+\.tmp", d):
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
        elif re.fullmatch(r"step_\d+\.ckpt\.tmp", d):
            try:
                os.unlink(path)
                removed.append(path)
            except OSError:
                pass
    return removed


def load_manifest(directory: str, step: int) -> dict:
    file_path = _file_path(directory, step)
    if os.path.exists(file_path):
        with np.load(file_path) as data:
            return json.loads(data["__manifest__"].tobytes().decode("utf-8"))
    path = os.path.join(_dir_path(directory, step), "manifest.json")
    with open(path) as f:
        return json.load(f)


def load_meta(directory: str, step: int) -> dict:
    """The ``meta`` dict stored at save time ({} if none was)."""
    return load_manifest(directory, step).get("meta", {})


def _validate_manifest(manifest: dict, names: list[str],
                       leaves: list[Any], path: str) -> None:
    """Leaf-name and dtype agreement between checkpoint and target: a
    checkpoint of one sampler kind restored into another with the same
    leaf count fails with a diff of the first mismatches."""
    saved_names = manifest.get("names")
    if saved_names is not None and saved_names != names:
        diffs = []
        for i in range(max(len(saved_names), len(names))):
            s = saved_names[i] if i < len(saved_names) else "<absent>"
            t = names[i] if i < len(names) else "<absent>"
            if s != t:
                diffs.append(f"  leaf {i}: checkpoint={s!r} target={t!r}")
            if len(diffs) >= 10:
                diffs.append("  ...")
                break
        raise ValueError(
            f"checkpoint {path} does not match the target tree structure "
            f"({len(saved_names)} vs {len(names)} leaves):\n"
            + "\n".join(diffs))
    saved_dtypes = manifest.get("dtypes", [])
    mismatches = []
    for i, (name, leaf) in enumerate(zip(names, leaves)):
        want = _leaf_dtype_name(leaf)
        got = saved_dtypes[i] if i < len(saved_dtypes) else "<absent>"
        if got != want:
            mismatches.append(f"  {name}: checkpoint={got} target={want}")
        if len(mismatches) >= 10:
            mismatches.append("  ...")
            break
    if mismatches:
        raise ValueError(
            f"checkpoint {path} dtype mismatch against target tree:\n"
            + "\n".join(mismatches))


def _read_arrays(directory: str, step: int):
    """(manifest, {array_key: ndarray}) for either on-disk layout."""
    file_path = _file_path(directory, step)
    if os.path.exists(file_path):
        with np.load(file_path) as data:
            manifest = json.loads(
                data["__manifest__"].tobytes().decode("utf-8"))
            arrays = {k: data[k] for k in data.files if k != "__manifest__"}
        return manifest, arrays
    path = _dir_path(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    return manifest, arrays


def _materialize(directory: str, step: int):
    """Replay the delta chain ending at ``step``: ``(final_manifest,
    leaves)`` in stored form.  Walks ``base_step`` links back to a full
    checkpoint, then applies each delta oldest to newest (``True``
    replaces the leaf, ranges overwrite those rows, ``None`` keeps it)."""
    chain = []
    seen: set[int] = set()
    s = step
    while True:
        if s in seen:
            raise ValueError(f"delta chain at step {step} cycles on "
                             f"step {s} in {directory}")
        seen.add(s)
        manifest, arrays = _read_arrays(directory, s)
        chain.append((s, manifest, arrays))
        base = manifest.get("base_step")
        if base is None:
            break
        s = base
    chain.reverse()
    leaves = None
    names = None
    for s, manifest, arrays in chain:
        spec = manifest.get("delta")
        if leaves is None:
            if spec is None:  # legacy dir layout: full a{i} arrays
                leaves = [arrays[f"a{i}"]
                          for i in range(len(manifest["names"]))]
            else:
                if any(sp is not True for sp in spec):
                    raise ValueError(
                        f"delta chain root at step {s} is itself "
                        f"incremental — the chain has no full base")
                leaves = [arrays[f"d{i}"] for i in range(len(spec))]
            names = manifest["names"]
            continue
        if manifest["names"] != names:
            raise ValueError(
                f"delta at step {s} was saved against a different tree "
                f"structure than its chain base (leaf names differ)")
        for i, sp in enumerate(spec):
            if sp is None:
                continue
            if sp is True:
                leaves[i] = arrays[f"d{i}"]
                continue
            dst = np.array(leaves[i])
            src = arrays[f"d{i}"]
            off = 0
            for rs, rng_e in sp:
                n = rng_e - rs
                dst[rs:rng_e] = src[off:off + n]
                off += n
            leaves[i] = dst
    return chain[-1][1], leaves


def _leaf_devices(target: Any, device: Any, n: int) -> list:
    """One device (or None) per target leaf: ``device`` itself, its
    per-leaf tree, or None (each target leaf's own device)."""
    if device is None or isinstance(device, (str, torch.device)):
        return [device] * n
    devices = _flatten_with_names(device)[1]
    if len(devices) != n:
        raise ValueError(f"device tree has {len(devices)} leaves, target "
                         f"has {n}")
    return devices


def _restored_leaf(arr: np.ndarray, dtype_name: str, tgt: Any, dev: Any):
    """A stored array in the form of its target leaf: a tensor on ``dev``
    (or the target's device), a Python scalar, or a numpy array."""
    if isinstance(tgt, torch.Tensor):
        dev = tgt.device if dev is None else torch.device(dev)
        if dev.type == "meta":
            raise ValueError("target leaf on the meta device: pass "
                             "restore(..., device=...)")
        return _from_storable(arr, dtype_name).to(dev)
    scalar = _scalar_dtype(tgt)
    if scalar is not None:
        return type(tgt)(arr.item())
    return arr


def restore(directory: str, step: int, target: Any, device: Any = None
            ) -> Any:
    """Load into the structure of ``target``.

    ``target`` is a tree of tensors (the meta device will do: only names,
    shapes and dtypes are read) and Python scalars; each tensor leaf is
    restored as a tensor of its dtype, each scalar as a Python scalar of
    its type.  Both on-disk layouts load, and a delta checkpoint has its
    chain replayed to the nearest full save first.  The manifest's leaf
    names and dtypes are validated against ``target`` first: a
    structural mismatch raises with a readable diff.

    ``device``: None puts each leaf on its target leaf's device; a device
    puts every leaf there; a tree of devices with ``target``'s structure
    gives one per leaf.  A target leaf on the meta device needs one.
    """
    path = _file_path(directory, step)
    if not os.path.exists(path):
        path = _dir_path(directory, step)
    manifest, raw = _materialize(directory, step)
    names, leaves = _flatten_with_names(target)
    if len(raw) != len(leaves):
        raise ValueError(f"checkpoint has {len(raw)} leaves, "
                         f"target expects {len(leaves)}")
    _validate_manifest(manifest, names, leaves, path)
    out = []
    for arr, dtype_name, tgt, dev in zip(
            raw, manifest["dtypes"], leaves,
            _leaf_devices(target, device, len(leaves))):
        if tuple(arr.shape) != tuple(_leaf_shape(tgt)):
            raise ValueError(f"shape mismatch {arr.shape} vs "
                             f"{tuple(_leaf_shape(tgt))} at "
                             f"{names[len(out)]}")
        out.append(_restored_leaf(arr, dtype_name, tgt, dev))
    return _unflatten(target, out)


class CheckpointManager:
    """Retention, resume and preemption plumbing around the saves.

    The preemption flag has three writers, so it works from any thread:

    * ``install_preemption_hook()`` — SIGTERM handler; only installable
      on the main thread, so elsewhere it returns False and the polled
      mechanisms below still work.
    * ``request_preemption()`` — direct flag set, for same-process
      callers (a watchdog thread or a test).
    * a ``PREEMPT`` sentinel file in the checkpoint directory, checked
      when ``preempted`` is read.  It is one-shot: a freshly constructed
      manager consumes (deletes) it, so the relaunch after a
      sentinel-triggered exit resumes instead of preempting itself.
    """

    def __init__(self, directory: str, keep: int = 3,
                 save_interval: int = 100, full_every: int = 8):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep} (keep=0 would "
                             f"leave nothing to resume from)")
        if save_interval < 1:
            raise ValueError(f"save_interval must be >= 1, got "
                             f"{save_interval}")
        if full_every < 1:
            raise ValueError(f"full_every must be >= 1, got {full_every}")
        self.directory = directory
        self.keep = keep
        self.save_interval = save_interval
        self.full_every = full_every
        self._preempted = False
        # step -> base_step links, so the per-save GC's chain walk does
        # not re-open on-disk manifests; misses fall back to load_manifest.
        self._bases: dict[int, Optional[int]] = {}
        gc_stale_tmp(directory)
        # Resume the delta chain: the next dirty-aware save extends from
        # the latest on-disk step unless the chain is full_every deep.
        steps = available_steps(directory)
        self._last_step: Optional[int] = steps[-1] if steps else None
        self._chain_len = (self._chain_len_of(self._last_step)
                           if self._last_step is not None else 0)
        try:
            os.unlink(self._sentinel_path)  # consume a stale sentinel
        except OSError:
            pass

    def _base_of(self, step: int) -> Optional[int]:
        if step in self._bases:
            return self._bases[step]
        try:
            base = load_manifest(self.directory, step).get("base_step")
        except (OSError, KeyError, ValueError):
            base = None
        self._bases[step] = base
        return base

    def _chain_len_of(self, step: int) -> int:
        n, s, seen = 0, step, set()
        while s is not None and s not in seen:
            seen.add(s)
            base = self._base_of(s)
            if base is None:
                break
            n += 1
            s = base
        return n

    def install_preemption_hook(self, signum: int = signal.SIGTERM) -> bool:
        """Install the SIGTERM handler if possible; returns whether it was
        (``signal.signal`` raises ``ValueError`` off the main thread)."""
        def handler(signum, frame):
            self._preempted = True

        if threading.current_thread() is not threading.main_thread():
            return False
        try:
            signal.signal(signum, handler)
        except ValueError:
            return False
        return True

    def request_preemption(self) -> None:
        """Thread-safe direct preemption request (no signal needed)."""
        self._preempted = True

    @property
    def _sentinel_path(self) -> str:
        return os.path.join(self.directory, PREEMPT_SENTINEL)

    @property
    def preempted(self) -> bool:
        if not self._preempted and os.path.exists(self._sentinel_path):
            self._preempted = True
        return self._preempted

    def should_save(self, step: int) -> bool:
        return self.preempted or (step > 0 and step % self.save_interval == 0)

    def save(self, step: int, tree: Any, meta: dict | None = None,
             dirty: Any = None, force_full: bool = False) -> str:
        """Single-file save; incremental when a dirty spec is given.

        With ``dirty=None`` (or no usable base) this writes a full
        self-contained ``step_<n>.ckpt``; with a dirty tree a delta
        against the previous save, compacted by a full save every
        ``full_every`` saves so restore never replays an unbounded chain.
        """
        from repro_torch import obs

        base = self._last_step
        full = (force_full or dirty is None or base is None
                or base >= step
                or self._chain_len >= self.full_every - 1
                or not checkpoint_exists(self.directory, base))
        with obs.span("checkpoint_save"):
            if full:
                path = save_incremental(self.directory, step, tree, meta=meta)
                self._chain_len = 0
                self._bases[step] = None
            else:
                path = save_incremental(self.directory, step, tree,
                                        base_step=base, dirty=dirty, meta=meta)
                self._chain_len += 1
                self._bases[step] = base
        self._last_step = step
        reg = obs.get_registry()
        if reg.enabled:
            try:
                nbytes = os.path.getsize(path)
            except OSError:
                nbytes = 0
            reg.counter(
                "checkpoint_full_bytes" if full else "checkpoint_delta_bytes",
                help="bytes written by full/delta checkpoint saves",
            ).add(nbytes)
            reg.gauge("checkpoint_chain_len",
                      help="delta-chain length since the last full save"
                      ).set(self._chain_len)
        self._gc()
        return path

    def latest_step(self) -> Optional[int]:
        steps = available_steps(self.directory)
        return steps[-1] if steps else None

    def restore_latest(self, target: Any, device: Any = None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, restore(self.directory, step, target, device)

    def latest_meta(self) -> dict:
        step = self.latest_step()
        return load_meta(self.directory, step) if step is not None else {}

    def _gc(self):
        gc_stale_tmp(self.directory)
        steps = available_steps(self.directory)
        retained = set(steps[max(len(steps) - self.keep, 0):])
        # A retained delta is useless without its chain: retain every
        # transitive base too.
        frontier = list(retained)
        while frontier:
            s = frontier.pop()
            base = self._base_of(s)
            if base is not None and base not in retained:
                retained.add(base)
                frontier.append(base)
        for s in steps:
            if s in retained:
                continue
            shutil.rmtree(_dir_path(self.directory, s), ignore_errors=True)
            try:
                os.unlink(_file_path(self.directory, s))
            except OSError:
                pass
            self._bases.pop(s, None)
