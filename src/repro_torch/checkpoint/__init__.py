"""Checkpoints of training states in the JAX package's v2 file format (port of
``repro/checkpoint/__init__.py``), written and read by the port's own msgpack
codec (``checkpoint.codec``).

One msgpack map per file ``ckpt_{step:08d}.msgpack``::

    {"version": 2,
     "step":    <int>,
     "treedef": <str: the port's description of the tree>,
     "leaves":  [<raw little-endian bytes>, ...],      # bin32 each
     "manifest": [{"dtype": "float32", "shape": [4, 8], "crc32": <uint32>},
                  ...]}                                 # one entry a leaf

The writer streams the file: the map header, ``version``, ``step``,
``treedef``, the leaves (an array32 header, then each leaf's bin32 header
and bytes, its CRC32 computed as it goes out) and the manifest last.  A map
reader does not care about key order, so the JAX package's
``restore_checkpoint`` reads these files as it reads its own, and the port
reads the JAX package's (v2, and v1 with its ``{"dtype", "shape", "data"}``
leaves and no CRC).  A sync save holds one leaf at a time on the host.  A
bin32 holds at most 2**32 - 1 bytes, the limit JAX's msgpack has; a larger
leaf raises ValueError naming it.

Leaves go in ``tree.tree_leaves`` order (dict keys sorted, sequences in
order); a training state (anything with ``params``, ``opt_state`` and
``step``) is params, then opt_state, then ``step`` as an int32 0-d leaf --
the flatten order of JAX's ``TrainState``, so the files hold the same leaves
in the same order.  Dtype names are numpy's (``bfloat16`` as ml_dtypes
spells it); the bytes are taken through torch, which has bf16 where numpy
may not.

Failures are typed as in JAX: a damaged file (truncated, garbage, a CRC or
byte-count mismatch) raises ``CheckpointCorruptionError``; an intact file
that does not match the ``like`` tree raises ValueError naming the leaf.
``restore_latest_valid`` walks the files newest first, warning about each it
skips, and raises when every file fails rather than starting afresh.

Writes are crash-safe: a ``*.tmp-<pid>`` sibling, fsync'd, then
``os.replace``'d into place; orphaned ``.tmp`` files are swept on the next
save, and ``keep_last=N`` keeps the N newest files.  ``background=True``
copies every leaf to the host before it returns (the optimizer updates the
state in place, so nothing on the card may be read after the call returns),
then streams the file from a writer thread; ``wait_for_saves()`` joins the
writers and re-raises their first error.

``restore_checkpoint(fname, like, place)`` takes the leaves out of an
``mmap`` of the file, one copy each into host tensors, checks them, and
hands the global tree to ``place`` (this process's part of it on its device,
``train.steps.place_state``); without ``place`` the tensors stay on the
host.
"""
from __future__ import annotations

import dataclasses
import mmap
import os
import threading
import time
import warnings
import zlib
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import codec
from repro_torch.tree import tree_leaves, tree_unflatten

FORMAT_VERSION = 2

_NAMES = {torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
          torch.bfloat16: "bfloat16", torch.int8: "int8", torch.int16: "int16",
          torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8",
          torch.bool: "bool"}
_DTYPES = {name: dt for dt, name in _NAMES.items()}


class CheckpointError(Exception):
    """Base class for checkpoint failures."""


class CheckpointCorruptionError(CheckpointError):
    """The file on disk is damaged (truncation, bit rot, partial write)."""


# -- trees -------------------------------------------------------------------

def _is_state(x) -> bool:
    return (dataclasses.is_dataclass(x) and not isinstance(x, type)
            and all(hasattr(x, f) for f in ("params", "opt_state", "step")))


def _file_tree(tree):
    """The tree whose ``tree_leaves`` are the file's leaves: a training state
    becomes (params, opt_state, step), its step an int32 0-d leaf."""
    if not _is_state(tree):
        return tree
    step = tree.step
    return (tree.params, tree.opt_state,
            torch.as_tensor(step, dtype=torch.int32) if isinstance(step, int) else step)


def _leaves(tree) -> List[Any]:
    """The leaves of a tree or a training state, in the files' order."""
    return tree_leaves(_file_tree(tree))


def _rebuild(like, leaves: List[Any]):
    """``like``'s structure (a tree or a training state) holding ``leaves``."""
    tree = tree_unflatten(_file_tree(like), leaves)
    if not _is_state(like):
        return tree
    params, opt_state, step = tree
    return dataclasses.replace(like, params=params, opt_state=opt_state,
                               step=int(step) if isinstance(like.step, int) else step)


def _paths(tree, path: Tuple[str, ...] = ()) -> List[str]:
    """The path of each of ``_leaves(tree)``, for error messages."""
    if _is_state(tree):
        return (_paths(tree.params, path + ("params",))
                + _paths(tree.opt_state, path + ("opt_state",))
                + ["/".join(path + ("step",))])
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree) for p in _paths(t, path + (str(i),))]
    return ["/".join(path) or "<root>"]


def _describe(tree) -> str:
    if _is_state(tree):
        return (f"{type(tree).__name__}(params={_describe(tree.params)}, "
                f"opt_state={_describe(tree.opt_state)}, step=*)")
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_describe(t) for t in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ", ".join(_describe(t) for t in tree) + ")"
    return "*"


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(leaf)
    return torch.as_tensor(leaf)


def _spec(leaf) -> Tuple[str, Tuple[int, ...]]:
    """(numpy dtype name, shape) of a leaf of a tree or of a ``like`` tree
    (tensors, meta tensors included, or numpy arrays)."""
    if isinstance(leaf, np.ndarray):
        return str(leaf.dtype), tuple(leaf.shape)
    t = _as_tensor(leaf)
    if t.dtype not in _NAMES:
        raise ValueError(f"a checkpoint cannot hold a {t.dtype} leaf")
    return _NAMES[t.dtype], tuple(t.shape)


def _nbytes(name: str, shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) * _DTYPES[name].itemsize


def _leaf_bytes(t: torch.Tensor) -> np.ndarray:
    """The raw little-endian bytes of a host tensor, without a copy where it
    is contiguous."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


# -- background writer -------------------------------------------------------

_IO_LOCK = threading.Lock()          # serializes finalize (rename + cleanup)
_PENDING: List[threading.Thread] = []
_PENDING_TMP: set = set()            # tmp paths owned by in-flight writers
_BG_ERRORS: List[BaseException] = []


def wait_for_saves() -> None:
    """Join every pending background save; re-raise the first failure."""
    while True:
        with _IO_LOCK:
            if not _PENDING:
                break
            t = _PENDING[0]
        t.join()
        with _IO_LOCK:
            if t in _PENDING:
                _PENDING.remove(t)
    with _IO_LOCK:
        if _BG_ERRORS:
            err = _BG_ERRORS[0]
            _BG_ERRORS.clear()
            raise CheckpointError("background checkpoint save failed") from err


def _sweep_orphan_tmps(path: str) -> None:
    """Remove ``.tmp`` droppings from crashed runs (not in-flight writes)."""
    try:
        names = os.listdir(path)
    except OSError:
        return
    for n in names:
        if ".tmp" not in n:
            continue
        full = os.path.join(path, n)
        with _IO_LOCK:
            if full in _PENDING_TMP:
                continue
        try:
            os.remove(full)
        except OSError:
            pass


def _apply_retention(path: str, keep_last: int) -> None:
    if keep_last <= 0:
        return
    for old in list_checkpoints(path)[:-keep_last]:
        try:
            os.remove(old)
        except OSError:
            pass


# -- save --------------------------------------------------------------------

def checkpoint_path(path: str, step: int) -> str:
    """The file ``save_checkpoint(path, ..., step)`` writes."""
    return os.path.join(path, f"ckpt_{int(step):08d}.msgpack")


def _write(tmp: str, step: int, treedef: str, specs, host: Iterable[torch.Tensor],
           timings: Optional[Dict[str, float]]) -> None:
    """Stream the file to ``tmp``: ``host`` yields each leaf on the host."""
    clock = {"host_s": 0.0, "write_s": 0.0, "fsync_s": 0.0}
    manifest = []
    t0 = time.perf_counter()
    with open(tmp, "wb") as f:
        f.write(codec.map_header(5) + codec.pack("version") + codec.pack(FORMAT_VERSION)
                + codec.pack("step") + codec.pack(step) + codec.pack("treedef")
                + codec.pack(treedef) + codec.pack("leaves")
                + codec.array_header(len(specs)))
        it = iter(host)
        for (path, name, shape) in specs:
            t1 = time.perf_counter()
            clock["write_s"] += t1 - t0
            leaf = next(it)
            t0 = time.perf_counter()
            clock["host_s"] += t0 - t1
            buf = _leaf_bytes(leaf)
            f.write(codec.bin_header(buf.nbytes))
            f.write(buf)
            manifest.append({"dtype": name, "shape": list(shape),
                             "crc32": zlib.crc32(buf) & 0xFFFFFFFF})
            del leaf, buf
        f.write(codec.pack("manifest") + codec.pack(manifest))
        f.flush()
        t1 = time.perf_counter()
        clock["write_s"] += t1 - t0
        os.fsync(f.fileno())
        clock["fsync_s"] = time.perf_counter() - t1
    if timings is not None:
        timings.update(clock)


def save_checkpoint(path: str, state: Any, step: Optional[int] = None, *,
                    keep_last: int = 0, background: bool = False,
                    timings: Optional[Dict[str, float]] = None) -> str:
    """Write a tree (a training state or parameters) to
    ``path``/ckpt_{step}.msgpack and return the file name.

    ``keep_last=N`` (N > 0) deletes all but the N newest checkpoints after
    a successful write.  ``background=True`` copies every leaf to the host
    before it returns, then streams the file from a writer thread; call
    ``wait_for_saves()`` to flush.  A sync save copies and writes one leaf
    at a time.  ``timings``, where given, receives the seconds of the
    device-to-host copies (``host_s``), of the CRC and the writes
    (``write_s``) and of the fsync (``fsync_s``)."""
    os.makedirs(path, exist_ok=True)
    flat = _leaves(state)
    specs = []
    for leaf_path, leaf in zip(_paths(state), flat):
        name, shape = _spec(leaf)
        n = _nbytes(name, shape)
        if n > codec.BIN32_MAX:
            raise ValueError(f"leaf {leaf_path} ({name}{list(shape)}) holds {n} bytes; "
                             f"a msgpack bin32 holds at most {codec.BIN32_MAX}")
        specs.append((leaf_path, name, shape))
    step = int(step if step is not None else getattr(state, "step", 0) or 0)
    fname = checkpoint_path(path, step)
    tmp = f"{fname}.tmp-{os.getpid()}"
    treedef = _describe(state)

    def finish():
        with _IO_LOCK:
            os.replace(tmp, fname)
            _PENDING_TMP.discard(tmp)
        _apply_retention(path, keep_last)
        _sweep_orphan_tmps(path)

    if not background:
        def stream():
            for leaf in flat:
                t = _as_tensor(leaf)
                yield t if t.device.type == "cpu" else t.to("cpu")
        # registered as in flight: a background writer that finishes
        # meanwhile sweeps every other .tmp in the directory
        with _IO_LOCK:
            _PENDING_TMP.add(tmp)
        try:
            _write(tmp, step, treedef, specs, stream(), timings)
            finish()
        finally:
            with _IO_LOCK:
                _PENDING_TMP.discard(tmp)
        return fname

    # every leaf on the host before returning: the next step updates the
    # state's tensors in place (a CPU leaf is copied for the same reason)
    host = []
    for leaf in flat:
        t = _as_tensor(leaf)
        host.append(t.clone() if t.device.type == "cpu" else t.to("cpu"))
    del flat
    with _IO_LOCK:
        _PENDING_TMP.add(tmp)

    def guarded():
        try:
            _write(tmp, step, treedef, specs, host, timings)
            finish()
        except BaseException as e:                 # surfaced by wait_for_saves
            with _IO_LOCK:
                _BG_ERRORS.append(e)
                _PENDING_TMP.discard(tmp)

    t = threading.Thread(target=guarded, name=f"ckpt-save-{step}", daemon=True)
    with _IO_LOCK:
        _PENDING.append(t)
    t.start()
    return fname


# -- directory queries -------------------------------------------------------

def list_checkpoints(path: str) -> List[str]:
    """All checkpoint files under ``path``, oldest first."""
    if not os.path.isdir(path):
        return []
    return [os.path.join(path, f) for f in sorted(os.listdir(path))
            if f.startswith("ckpt_") and f.endswith(".msgpack")]


def latest_checkpoint(path: str) -> Optional[str]:
    cands = list_checkpoints(path)
    return cands[-1] if cands else None


def checkpoint_step(fname: str) -> int:
    """Step number encoded in a checkpoint filename."""
    base = os.path.basename(fname)
    try:
        return int(base[len("ckpt_"):].split(".")[0])
    except ValueError:
        raise ValueError(f"not a checkpoint filename: {fname!r}") from None


# -- load / verify -----------------------------------------------------------

def load_payload(fname: str) -> dict:
    """The file's map, its bins memoryviews of a read-only ``mmap``."""
    with open(fname, "rb") as f:
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError as e:             # an empty file cannot be mapped
            raise CheckpointCorruptionError(f"{fname}: unreadable msgpack payload "
                                            f"(empty file: {e})") from e
    try:
        payload = codec.unpack(mm)
    except Exception as e:                  # truncation, garbage, bad msgpack
        raise CheckpointCorruptionError(
            f"{fname}: unreadable msgpack payload ({type(e).__name__}: {e})") from e
    if not isinstance(payload, dict) or "leaves" not in payload:
        raise CheckpointCorruptionError(f"{fname}: payload is not a checkpoint map")
    return payload


def _normalize(payload: dict, fname: str) -> Tuple[List[dict], List[Any]]:
    """-> (manifest, raw buffers) for both v1 and v2 payloads."""
    leaves = payload["leaves"]
    version = payload.get("version", 1)
    if not isinstance(leaves, list) or not isinstance(version, int):
        raise CheckpointCorruptionError(f"{fname}: leaves or version of the wrong type")
    if version >= 2:
        manifest = payload.get("manifest")
        if not isinstance(manifest, list) or len(manifest) != len(leaves):
            raise CheckpointCorruptionError(
                f"{fname}: manifest/leaves length mismatch "
                f"({'missing' if manifest is None else len(manifest)} vs "
                f"{len(leaves)})")
        return manifest, leaves
    try:
        manifest = [{"dtype": d["dtype"], "shape": d["shape"], "crc32": None}
                    for d in leaves]
        return manifest, [d["data"] for d in leaves]
    except (TypeError, KeyError) as e:
        raise CheckpointCorruptionError(f"{fname}: malformed v1 leaf ({e})") from e


def _entry(entry, buf, fname: str, what: str) -> Tuple[str, Tuple[int, ...]]:
    """The (dtype name, shape) of a manifest entry, checked against its
    buffer's size and CRC32."""
    try:
        name, shape, crc = entry["dtype"], tuple(entry["shape"]), entry.get("crc32")
        ok = (isinstance(name, str) and isinstance(buf, memoryview)
              and all(isinstance(s, int) and s >= 0 for s in shape)
              and (crc is None or isinstance(crc, int)))
    except (TypeError, KeyError, AttributeError):
        ok = False
    if not ok:
        raise CheckpointCorruptionError(f"{fname}: {what}: malformed manifest entry")
    if name not in _DTYPES:
        try:
            np.dtype(name)
        except TypeError:
            raise CheckpointCorruptionError(f"{fname}: {what}: unknown dtype "
                                            f"{name!r}") from None
        raise ValueError(f"{fname}: {what}: dtype {name} has no torch counterpart")
    want = _nbytes(name, shape)
    if len(buf) != want:
        raise CheckpointCorruptionError(
            f"{fname}: {what}: buffer holds {len(buf)} bytes, manifest "
            f"{name}{list(shape)} needs {want}")
    if crc is not None and (zlib.crc32(buf) & 0xFFFFFFFF) != crc:
        raise CheckpointCorruptionError(
            f"{fname}: {what}: CRC32 mismatch (stored {crc:#010x}, "
            f"computed {zlib.crc32(buf) & 0xFFFFFFFF:#010x}) — the leaf's "
            f"bytes were corrupted on disk")
    return name, shape


def _to_tensor(name: str, shape, buf) -> torch.Tensor:
    """A host tensor holding a copy of ``buf``'s bytes."""
    t = torch.empty(shape, dtype=_DTYPES[name])
    if t.numel():
        t.reshape(-1).view(torch.uint8).numpy()[:] = np.frombuffer(buf, np.uint8)
    return t


def read_leaves(fname: str) -> List[torch.Tensor]:
    """Every leaf of a file as a host tensor, integrity-checked, in order."""
    payload = load_payload(fname)
    manifest, bufs = _normalize(payload, fname)
    return [_to_tensor(*_entry(e, b, fname, f"leaf {i}"), b)
            for i, (e, b) in enumerate(zip(manifest, bufs))]


def verify_checkpoint(fname: str) -> dict:
    """Integrity-check every leaf (no ``like`` needed).  Returns
    ``{"step", "n_leaves", "bytes", "version"}``; raises
    ``CheckpointCorruptionError`` on damage."""
    payload = load_payload(fname)
    manifest, bufs = _normalize(payload, fname)
    total = 0
    for i, (entry, buf) in enumerate(zip(manifest, bufs)):
        _entry(entry, buf, fname, f"leaf {i}")
        total += len(buf)
    return {"step": payload.get("step", checkpoint_step(fname)),
            "n_leaves": len(bufs), "bytes": total,
            "version": payload.get("version", 1)}


def restore_checkpoint(fname: str, like: Any,
                       place: Optional[Callable[[Any], Any]] = None) -> Any:
    """Restore into the structure of ``like`` (tensors, meta tensors or
    numpy arrays at the leaves), checking every leaf's CRC32 and its dtype
    and shape against ``like``; ``place(tree)`` then maps the global tree to
    this process's part on its device (the elastic path: the file holds
    every leaf's global value).  See the module docstring for the error
    taxonomy."""
    payload = load_payload(fname)
    manifest, bufs = _normalize(payload, fname)
    flat_like = _leaves(like)
    if len(bufs) != len(flat_like):
        raise ValueError(
            f"{fname}: checkpoint has {len(bufs)} leaves but the restore "
            f"target has {len(flat_like)} — the checkpoint was written for a "
            f"different model/optimizer structure")
    out = []
    for i, (entry, buf, path, want) in enumerate(zip(manifest, bufs, _paths(like),
                                                      flat_like)):
        what = f"leaf {i} ({path})"
        name, shape = _entry(entry, buf, fname, what)
        want_name, want_shape = _spec(want)
        if (name, shape) != (want_name, want_shape):
            raise ValueError(
                f"{fname}: {what}: checkpoint holds {name}{list(shape)} but the "
                f"restore target expects {want_name}{list(want_shape)}")
        out.append(_to_tensor(name, shape, buf))
    del payload, bufs
    tree = _rebuild(like, out)
    return place(tree) if place is not None else tree


def restore_latest_valid(path: str, like: Any,
                         place: Optional[Callable[[Any], Any]] = None
                         ) -> Tuple[Optional[Any], Optional[str]]:
    """Restore the newest checkpoint under ``path`` that passes integrity and
    structure validation, falling back over corrupt or mismatched files
    newest first (each skip warns).  Returns ``(state, fname)``, or
    ``(None, None)`` when the directory holds no checkpoints at all.

    When checkpoints exist but every one fails, raises
    ``CheckpointCorruptionError``: returning ``(None, None)`` would make the
    supervisor start afresh at step 0 over a run that needs attention."""
    candidates = list(list_checkpoints(path))
    for fname in reversed(candidates):
        try:
            return restore_checkpoint(fname, like, place), fname
        except (CheckpointError, ValueError, OSError) as e:
            warnings.warn(f"[checkpoint] skipping {os.path.basename(fname)}: "
                          f"{e}", stacklevel=2)
    if candidates:
        raise CheckpointCorruptionError(
            f"all {len(candidates)} checkpoint(s) under {path} failed "
            f"validation — refusing to silently fresh-init over an "
            f"existing run")
    return None, None
