"""Fast single-blob checkpointing for trees of tensors (counterpart of
:mod:`apex_tpu.io.checkpoint`, its single-file part).

The byte layout is the JAX package's, so either side reads the other's
files::

    b"APEXTPU1" | <QQ> header length, structure length | header JSON
    | structure bytes | blob

- the header JSON holds ``treedef`` (a description), ``leaves`` (each
  leaf's ``shape`` and numpy ``dtype`` string) and the blob's
  ``crc32``;
- the blob is every leaf's bytes back to back (the native multithreaded
  :func:`~apex_tpu_torch.io.native.flatten`), in ``jax.tree_util`` leaf
  order: dicts by sorted key, NamedTuple fields in order, ``None`` an
  empty subtree (:func:`apex_tpu_torch.optimizers.tree.tree_leaves`);
- the structure bytes: the JAX package pickles its ``PyTreeDef`` there,
  which only jaxlib can unpickle.  The port writes a pickle of plain
  Python structure (dicts, lists, strings, None: no class of torch or
  jax), so any reader can unpickle it and the JAX package's
  ``validate_checkpoint`` / ``probe_checkpoint`` accept the port's
  files.  Reading a file the JAX package wrote, the port skips those
  bytes unread and rebuilds the tree from a ``template`` in the
  reference's leaf order.

Leaves are read back as CPU tensors.  bf16 (and fp8) leaves need no
``ml_dtypes``: they are written and read as raw 16-bit (8-bit) words
(``tensor.view(torch.int16)``) under the reference's dtype name
(``"bfloat16"``).

The sharded checkpoints (one file a rank under a directory with an
``index.json``, the JAX module's ``apex_tpu_sharded_v1`` layout) are
here too: :func:`save_sharded_checkpoint` writes this rank's piece (rank
0 the index), :func:`load_sharded_checkpoint` reads one rank's or all,
:func:`latest_distributed_step` finds the newest complete ``step_*``
directory.  A JAX-written shard file needs a ``template`` as any JAX
file does.  :func:`save_distributed_checkpoint` /
:func:`load_distributed_checkpoint` keep the JAX module's per-leaf
``{"start", "stop", "data"}`` pieces: rank 0 writes every leaf whole,
and a leaf that is a :class:`LocalShard` is written by each rank as its
own slice, so a reader assembles the global tree from all the files.
The JAX package's distributed files hold its leaves' pieces under keys
only its pickled tree structure names, so the port reads its own.

Leaves of a dtype torch lacks (a string, as the ZeRO shard dicts hold)
load back as numpy arrays.
"""

import io as _stdio
import json
import logging
import os
import pickle
import random
import re
import struct
import time
import zlib
from collections import namedtuple
from pathlib import Path
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from apex_tpu_torch.io import native
from apex_tpu_torch.observability import metrics as _metrics
from apex_tpu_torch.optimizers import tree as _tree
from apex_tpu_torch.utils.logging import get_logger, log_structured

__all__ = [
    "AllCheckpointsTornError", "CorruptCheckpoint", "LocalShard", "checkpoint_step",
    "latest_checkpoint", "latest_distributed_step", "load_checkpoint",
    "load_distributed_checkpoint", "load_sharded_checkpoint", "open_checkpoint_lazy",
    "probe_checkpoint", "probe_checkpoint_dir", "quarantine_checkpoint", "read_index",
    "save_checkpoint", "save_distributed_checkpoint", "save_sharded_checkpoint",
    "validate_checkpoint",
]

_MAGIC = b"APEXTPU1"
#: the ``treedef`` field of a file this module wrote; its structure
#: bytes are then a plain pickle this module reads back
_TREE_TAG = "apex_tpu_torch.tree_v1"

_logger = get_logger("apex_tpu_torch.io")

#: Bounded retry budget for one checkpoint read/write against transient
#: filesystem errors (NFS hiccups, fuse EIO); delays are jittered.
_IO_RETRIES = 3
_IO_BACKOFF_BASE = 0.05
_IO_BACKOFF_CAP = 2.0

#: OSError subclasses that are DETERMINISTIC, not transient: retrying
#: only adds sleeps in front of the real error.
_IO_NO_RETRY = (FileNotFoundError, PermissionError, IsADirectoryError,
                NotADirectoryError)

#: dtype names numpy knows only through ml_dtypes: the raw word each is
#: stored as, and the torch dtype it is viewed as
_RAW_DTYPES = {
    "bfloat16": (np.dtype(np.int16), torch.bfloat16),
    "float8_e4m3fn": (np.dtype(np.uint8), torch.float8_e4m3fn),
    "float8_e5m2": (np.dtype(np.uint8), torch.float8_e5m2),
}
#: torch dtype -> (its name, the torch dtype of its raw words)
_RAW_NAMES = {torch.bfloat16: ("bfloat16", torch.int16),
              torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8),
              torch.float8_e5m2: ("float8_e5m2", torch.uint8)}


def _chaos_io(site: str) -> None:
    """The fault-injection seam for slow or failing checkpoint I/O
    (:func:`apex_tpu_torch.resilience.chaos.check_io`, the JAX module's
    :51-59).  It runs inside each retried attempt, so an injected
    failure budget burns down across attempts as a recovering
    filesystem would."""
    from apex_tpu_torch.resilience.chaos import check_io

    check_io(site)


def _with_io_retries(fn, op: str, path, retries=None):
    """Run one checkpoint I/O operation with bounded, jittered,
    structured-logged retry-with-backoff on transient ``OSError``s.
    Each attempt first passes the chaos seam ``ckpt.<op>``
    (:func:`_chaos_io`).  Never retried: deterministic OSErrors
    (``_IO_NO_RETRY``) and ``ValueError`` (short reads / bad headers —
    corrupt bytes don't heal).  The final attempt's error propagates
    unwrapped."""
    n = _IO_RETRIES if retries is None else int(retries)
    for attempt in range(n + 1):
        try:
            _chaos_io(f"ckpt.{op}")
            return fn()
        except OSError as e:
            if isinstance(e, _IO_NO_RETRY) or attempt >= n:
                raise
            delay = min(_IO_BACKOFF_CAP, _IO_BACKOFF_BASE * (2 ** attempt))
            delay *= random.uniform(0.5, 1.5)
            log_structured(
                _logger, logging.WARNING, "checkpoint.io_retry", op=op, path=str(path),
                attempt=attempt + 1, retries=n, delay_s=round(delay, 4),
                error=f"{type(e).__name__}: {e}")
            _metrics.inc("apex_checkpoint_io_retries_total",
                         help="transient checkpoint I/O errors retried", op=op)
            time.sleep(delay)


# ------------------------------------------------------------------ leaves
def _leaf_array(leaf):
    """``(numpy array of the leaf's bytes, dtype string)``: numpy's dtype
    string (``'<f4'``), or for a bf16/fp8 tensor the reference's name
    over its raw words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            raise ValueError("save_checkpoint takes host leaves: snapshot device tensors "
                             "first (AsyncCheckpointer.save does)")
        t = t.contiguous()
        if t.dtype in _RAW_NAMES:
            name, raw = _RAW_NAMES[t.dtype]
            return t.view(raw).numpy(), name
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, a.dtype.str


def _resolve_dtype(s):
    """``(numpy dtype the bytes are read as, torch dtype to view them as
    or None)`` for a header dtype string."""
    if s in _RAW_DTYPES:
        return _RAW_DTYPES[s]
    return np.dtype(s), None


def _to_tensor(a: np.ndarray, view):
    """The leaf as a tensor, or as the numpy array itself when torch has
    no dtype for it (strings)."""
    if a.dtype.kind in "USO":
        return a
    t = torch.from_numpy(a)
    return t.view(view) if view is not None else t


# --------------------------------------------------------------- structure
def _structure(x):
    """The plain-Python description of ``x``'s tree structure, in the
    order :func:`~apex_tpu_torch.optimizers.tree.tree_leaves` walks it."""
    if x is None:
        return None
    if isinstance(x, dict) and not getattr(x, "tree_leaf", False):
        return {"dict": [[k, _structure(x[k])] for k in sorted(x)]}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {"namedtuple": type(x).__name__,
                "fields": [[f, _structure(v)] for f, v in zip(x._fields, x)]}
    if isinstance(x, (list, tuple)):
        return {type(x).__name__: [_structure(v) for v in x]}
    if type(x) in _tree._NODES:
        raise ValueError(f"save_checkpoint takes per-leaf trees, not {type(x).__name__}: "
                         "unpack bucket-resident state first")
    return "*"


def _rebuild(s, it):
    if s is None:
        return None
    if s == "*":
        return next(it)
    if "dict" in s:
        return {k: _rebuild(v, it) for k, v in s["dict"]}
    if "namedtuple" in s:
        cls = namedtuple(s["namedtuple"], [f for f, _ in s["fields"]])
        return cls(*(_rebuild(v, it) for _, v in s["fields"]))
    if "list" in s:
        return [_rebuild(v, it) for v in s["list"]]
    return tuple(_rebuild(v, it) for v in s["tuple"])


class _PlainUnpickler(pickle.Unpickler):
    """Unpickles plain data only: a structure pickle that names any class
    is not one this module wrote."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"checkpoint structure names {module}.{name}")


# -------------------------------------------------------------------- save
def save_checkpoint(path, tree: Any) -> None:
    """Serialize a tree of host tensors / arrays (+ scalars, None) to
    ``path``.  The publish is ATOMIC and durable
    (:func:`~apex_tpu_torch.io.native.atomic_output`: tmp + fsync +
    rename + dir-fsync) and retried with backoff on transient FS errors
    — a crash mid-save never leaves a truncated file under the final
    name."""
    structure = _structure(tree)
    arrays, meta = [], []
    for leaf in _tree.tree_leaves(tree):
        a, dt = _leaf_array(leaf)
        arrays.append(a)
        meta.append({"shape": list(a.shape), "dtype": dt})
    blob = native.flatten(arrays) if arrays else np.empty(0, np.uint8)
    header = json.dumps({"treedef": _TREE_TAG, "leaves": meta,
                         "crc32": zlib.crc32(memoryview(blob))}).encode()
    structure_bytes = pickle.dumps(structure, protocol=4)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)

    def write():
        with native.atomic_output(p) as f:
            f.write(_MAGIC)
            f.write(struct.pack("<QQ", len(header), len(structure_bytes)))
            f.write(header)
            f.write(structure_bytes)
            f.write(memoryview(blob))

    _with_io_retries(write, "write", p)


# -------------------------------------------------------------------- load
def _read_header(f, path):
    """Parse the preamble from an open file: returns ``(header,
    structure)`` — ``structure`` None for a file the JAX package wrote,
    whose pickled ``PyTreeDef`` is skipped unread — and leaves ``f`` at
    the first blob byte.  The ONE definition of the byte layout."""
    magic = f.read(8)
    if magic != _MAGIC:
        raise ValueError(f"{path} is not an apex_tpu checkpoint")
    hlen, tlen = struct.unpack("<QQ", f.read(16))
    header = json.loads(f.read(hlen))
    structure = None
    if header.get("treedef") == _TREE_TAG:
        raw = f.read(tlen)
        if len(raw) != tlen:
            raise ValueError(f"{path} is torn: short structure field")
        structure = _PlainUnpickler(_stdio.BytesIO(raw)).load()
    else:
        f.seek(tlen, 1)
    return header, structure


def _leaf_specs(header):
    out = []
    for m in header["leaves"]:
        raw, view = _resolve_dtype(m["dtype"])
        out.append((tuple(m["shape"]), raw, view))
    return out


def _blob_bytes(specs) -> int:
    return sum(int(np.prod(s, dtype=np.int64)) * raw.itemsize for s, raw, _ in specs)


def _assemble(path, structure, leaves, template):
    """The loaded tree: ``template``'s structure when given (its leaf
    shapes checked), else the file's own."""
    if template is not None:
        want = _tree.tree_leaves(template)
        if len(want) != len(leaves):
            raise ValueError(f"{path} holds {len(leaves)} leaves; the template "
                             f"{len(want)}")
        for i, (w, g) in enumerate(zip(want, leaves)):
            shape = getattr(w, "shape", None)
            if shape is not None and tuple(shape) != tuple(g.shape):
                raise ValueError(f"{path}: leaf {i} has shape {tuple(g.shape)}; the "
                                 f"template's is {tuple(shape)}")
        return _tree.tree_unflatten(template, leaves)
    if structure is None:
        raise ValueError(f"{path} was written by the JAX package (its tree structure is "
                         "a jax PyTreeDef): pass template= to load it")
    return _rebuild(structure, iter(leaves))


def load_checkpoint(path, template: Any = None) -> Any:
    """Load a tree saved by :func:`save_checkpoint` (or by the JAX
    package's) as CPU tensors.  ``template``: a tree of the saved
    structure (its leaves' shapes are checked); required for a file the
    JAX package wrote.  Raises ``ValueError`` on a torn or corrupt
    file; transient FS errors are retried with backoff."""
    def read():
        with open(path, "rb") as f:
            header, structure = _read_header(f, path)
            blob = np.frombuffer(f.read(), np.uint8)
        return header, structure, blob

    header, structure, blob = _with_io_retries(read, "read", path)
    specs = _leaf_specs(header)
    need = _blob_bytes(specs)
    if blob.size != need:
        raise ValueError(
            f"{path} is torn: header promises a {need}-byte blob, file "
            f"holds {blob.size} (interrupted write?)")
    crc = header.get("crc32")
    if crc is not None and zlib.crc32(memoryview(blob)) != int(crc):
        raise ValueError(
            f"{path} is corrupt: blob crc32 does not match the header "
            "(size-preserving corruption — bit flips, not a torn write)")
    arrays = native.unflatten(blob, [s for s, _, _ in specs], [r for _, r, _ in specs])
    leaves = [_to_tensor(a, v) for a, (_, _, v) in zip(arrays, specs)]
    return _assemble(path, structure, leaves, template)


class _LazyLeaf:
    """Handle to one leaf's bytes inside a checkpoint file: materializing
    it is a seek + read of exactly its bytes (:meth:`load`)."""

    __slots__ = ("path", "offset", "shape", "raw", "view")

    def __init__(self, path, offset, shape, raw, view):
        self.path = path
        self.offset = offset
        self.shape = shape
        self.raw = raw
        self.view = view

    def read_from(self, f) -> torch.Tensor:
        """Read this leaf's bytes from an already-open file object."""
        n = int(np.prod(self.shape, dtype=np.int64)) * self.raw.itemsize
        f.seek(self.offset)
        buf = f.read(n)
        if len(buf) != n:
            raise ValueError(
                f"checkpoint {self.path} truncated: leaf at offset "
                f"{self.offset} wants {n} bytes, got {len(buf)}")
        return _to_tensor(np.frombuffer(buf, self.raw).reshape(self.shape).copy(), self.view)

    def load(self) -> torch.Tensor:
        def read():
            with open(self.path, "rb") as f:
                return self.read_from(f)

        return _with_io_retries(read, "read", self.path)


def open_checkpoint_lazy(path, template: Any = None) -> Any:
    """Like :func:`load_checkpoint`, but leaves are :class:`_LazyLeaf`
    handles — only the preamble is read now; each leaf's bytes are read
    by its ``load()``."""
    def read():
        with open(path, "rb") as f:
            h, s = _read_header(f, path)
            return h, s, f.tell()

    header, structure, base = _with_io_retries(read, "read", path)
    leaves, off = [], base
    for shape, raw, view in _leaf_specs(header):
        leaves.append(_LazyLeaf(str(path), off, shape, raw, view))
        off += int(np.prod(shape, dtype=np.int64)) * raw.itemsize
    return _assemble(path, structure, leaves, template)


def written_by_jax(path) -> bool:
    """True for a file the JAX package's ``save_checkpoint`` wrote (its
    structure a jax ``PyTreeDef``, so loading it takes a template), False
    for the port's own (its structure inside)."""
    with open(path, "rb") as f:
        header, _ = _read_header(f, path)
    return header.get("treedef") != _TREE_TAG


# --------------------------------------------------------------- integrity
def validate_checkpoint(path) -> dict:
    """Cheap integrity check of a single-blob checkpoint: magic, header
    JSON, structure field, and — the torn-write case an interrupted
    writer or dying filesystem produces — that the blob holds EXACTLY
    the bytes the header promises.  Raises ``ValueError`` with the
    reason on any mismatch; returns the parsed header.  Reads only the
    preamble + ``stat``, never the blob."""
    p = Path(path)
    try:
        size = p.stat().st_size
        with open(p, "rb") as f:
            header, _ = _read_header(f, path)
            base = f.tell()
        # inside the try: a header whose JSON parses but holds garbage
        # leaf metadata is just as torn as a short preamble
        need = _blob_bytes(_leaf_specs(header))
    except Exception as e:  # noqa: BLE001 — every failure means torn/corrupt
        if type(e) is ValueError and str(path) in str(e):
            raise
        raise ValueError(f"{path} is torn or corrupt: "
                         f"{type(e).__name__}: {e}") from e
    got = size - base
    if got != need:
        raise ValueError(
            f"{path} is torn: header promises a {need}-byte blob, file "
            f"holds {got} (interrupted write?)")
    return header


def probe_checkpoint(path) -> dict:
    """Deep integrity probe of one checkpoint file: everything
    :func:`validate_checkpoint` checks PLUS the blob crc when the header
    carries one, so size-preserving corruption (bit flips) is caught
    here instead of deep inside a restore.  Reads the whole blob;
    raises ``ValueError`` with the reason, returns the parsed header."""
    header = validate_checkpoint(path)
    crc = header.get("crc32")
    if crc is None:
        return header

    def read():
        got = 0
        with open(path, "rb") as f:
            _read_header(f, path)
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    return got
                got = zlib.crc32(chunk, got)

    if _with_io_retries(read, "read", path) != int(crc):
        raise ValueError(
            f"{path} is corrupt: blob crc32 does not match the header "
            "(size-preserving corruption — bit flips, not a torn write)")
    return header


class CorruptCheckpoint(NamedTuple):
    """What :func:`probe_checkpoint_dir` reports: the newest restore
    candidate failed its deep probe."""

    path: str      # the checkpoint file at fault
    reason: str    # the probe's ValueError text


def checkpoint_step(path) -> int:
    """Step number encoded in a ``step_<N>*`` file/dir name, or -1."""
    m = re.match(r"step_(\d+)", Path(path).name)
    return int(m.group(1)) if m else -1


def _mtime(p: Path) -> float:
    try:
        return p.stat().st_mtime
    except OSError:
        # pruned by a concurrent writer between listing and sort: sort
        # last, validation skips it
        return 0.0


def _candidates(d: Path, suffixes):
    cands = [p for p in d.iterdir() if p.is_file() and p.suffix in suffixes]
    cands.sort(key=lambda p: (checkpoint_step(p), _mtime(p)), reverse=True)
    return cands


def probe_checkpoint_dir(dir_path) -> Optional[CorruptCheckpoint]:
    """Deep-probe what the NEXT restore would load (the JAX module's
    decisions): the newest complete ``step_*`` directory (every shard
    through :func:`probe_checkpoint`) or, in the single-file layout, the
    newest validating ``.ckpt``/``.apex`` file.  Returns ``None`` when
    it is healthy or there is nothing to probe, and a
    :class:`CorruptCheckpoint` naming it when its bytes are corrupt
    beyond what the torn-size check sees — or when step directories
    exist and none is complete (a hard-killed first publish), which the
    resume side can only refuse: the supervisor's quarantine trigger, so
    an interrupted save costs one save interval and never a crash loop."""
    d = Path(dir_path)
    if not d.is_dir():
        return None
    if any(p.is_dir() for p in d.glob("step_*")):
        try:
            step = latest_distributed_step(d)
        except AllCheckpointsTornError as e:
            # none complete: report the newest for quarantine (its bytes
            # kept for the postmortem); the relaunch then resumes from an
            # older directory or starts fresh
            dirs = sorted((p for p in d.glob("step_*") if p.is_dir()), key=checkpoint_step)
            return CorruptCheckpoint(str(dirs[-1]),
                                     f"incomplete publish (hard-killed writer?): {e}")
        if step < 0:
            return None
        sd = d / f"step_{step:08d}"
        try:
            world = int(read_index(sd)["world_size"])
            for r in range(world):
                probe_checkpoint(sd / _shard_name(r, world))
        except (OSError, ValueError, KeyError, TypeError) as e:
            return CorruptCheckpoint(str(sd), f"{type(e).__name__}: {e}")
        return None
    for p in _candidates(d, (".ckpt", ".apex")):
        try:
            validate_checkpoint(p)
        except ValueError:
            continue  # torn: latest_checkpoint already skips it
        try:
            probe_checkpoint(p)
        except (OSError, ValueError) as e:
            return CorruptCheckpoint(str(p), f"{type(e).__name__}: {e}")
        return None  # the file the next restore loads is healthy
    return None


def quarantine_checkpoint(dir_path, target, reason: str) -> str:
    """Atomically move a corrupt checkpoint (a ``step_*`` directory or a
    single file) into a ``quarantine/`` sibling with a reason file, so
    the next restore resumes from the previous step and the bad bytes
    stay available for the postmortem.  One same-filesystem
    ``os.replace``; a same-named earlier quarantine entry is replaced.
    Returns the quarantined path."""
    t = Path(target)
    q = Path(dir_path) / "quarantine"
    q.mkdir(parents=True, exist_ok=True)
    dest = q / t.name
    if dest.is_dir():
        import shutil

        shutil.rmtree(dest, ignore_errors=True)
    os.replace(str(t), str(dest))
    payload = json.dumps({
        "path": str(t), "quarantined_to": str(dest),
        "reason": str(reason), "time": time.time(),
    }, sort_keys=True).encode()
    with native.atomic_output(q / f"{t.name}.reason.json") as f:
        f.write(payload)
    log_structured(_logger, logging.ERROR, "checkpoint.quarantined", path=str(t),
                   quarantined_to=str(dest), reason=str(reason))
    _metrics.inc("apex_checkpoint_quarantines_total",
                 help="corrupt checkpoints moved aside by the supervisor")
    return str(dest)


class AllCheckpointsTornError(FileNotFoundError):
    """Every candidate file in the directory failed validation.

    Distinct from the plain ``FileNotFoundError`` of a missing/empty
    directory: prior progress EXISTED here, so treating this like a
    first launch would silently discard it — even an auto-resuming
    caller must fail loudly on this."""


def latest_checkpoint(dir_path, suffixes=(".ckpt", ".apex")) -> str:
    """Newest VALID single-file checkpoint under ``dir_path`` — the
    restart side of preemption safety.

    Candidates are ``*.ckpt``/``*.apex`` files (``.tmp`` leftovers of an
    interrupted publish never are), newest first by the ``step_<N>``
    number in the name, then by mtime.  Each is validated; torn files
    are SKIPPED with a structured warning.  Raises ``FileNotFoundError``
    when the directory is missing or empty, and its subclass
    :class:`AllCheckpointsTornError` when candidates exist but ALL fail
    validation."""
    d = Path(dir_path)
    if not d.is_dir():
        raise FileNotFoundError(f"checkpoint dir {dir_path} does not exist")
    cands = _candidates(d, suffixes)
    if not cands:
        raise FileNotFoundError(
            f"no checkpoint files ({'/'.join(suffixes)}) under {dir_path}"
            " — empty or not a checkpoint directory")
    skipped = []
    for p in cands:
        try:
            validate_checkpoint(p)
        except ValueError as e:
            skipped.append((str(p), str(e)))
            log_structured(_logger, logging.WARNING, "checkpoint.torn_file_skipped",
                           path=str(p), error=str(e))
            continue
        return str(p)
    raise AllCheckpointsTornError(
        f"no valid checkpoint under {dir_path}: all {len(skipped)} "
        f"candidate(s) torn/corrupt — " +
        "; ".join(f"{p}: {e}" for p, e in skipped))


# ------------------------------------------------------- sharded checkpoints
def _shard_name(rank: int, world: int) -> str:
    return f"shard_{rank:05d}-of-{world:05d}.ckpt"


def read_index(dir_path) -> dict:
    """Parse and format-check a sharded checkpoint directory's
    ``index.json`` (its world size and any ``index_extra`` metadata)."""
    path = Path(dir_path) / "index.json"
    index = json.loads(_with_io_retries(lambda: path.read_text(), "read", path))
    if index.get("format") != "apex_tpu_sharded_v1":
        raise ValueError(f"{dir_path} is not a sharded apex_tpu checkpoint")
    return index


def _write_index(dir_path, world_size: int, extra: Optional[dict] = None) -> None:
    """Publish ``index.json`` atomically and durably; ``extra`` merges
    more metadata in (``format`` and ``world_size`` win)."""
    d = Path(dir_path)
    d.mkdir(parents=True, exist_ok=True)
    payload = dict(extra or {})
    payload.update({"format": "apex_tpu_sharded_v1", "world_size": int(world_size)})

    def write():
        with native.atomic_output(d / "index.json") as f:
            f.write(json.dumps(payload).encode())

    _with_io_retries(write, "write", d / "index.json")


def save_sharded_checkpoint(dir_path, tree: Any, rank: int, world_size: int,
                            index_extra: Optional[dict] = None) -> str:
    """Save this rank's piece of a sharded checkpoint (host leaves), one
    file a rank; rank 0 also writes the index.  Returns the file."""
    d = Path(dir_path)
    d.mkdir(parents=True, exist_ok=True)
    if rank == 0:
        _write_index(d, world_size, extra=index_extra)
    path = d / _shard_name(rank, world_size)
    save_checkpoint(path, tree)
    return str(path)


def load_sharded_checkpoint(dir_path, rank=None, lazy: bool = False, template=None) -> Any:
    """One rank's shard tree (``rank=``) or every rank's (a list) from a
    :func:`save_sharded_checkpoint` directory, checked complete against
    the index.  ``template(rank)`` (or one tree) gives the structure of
    a JAX-written file."""
    d = Path(dir_path)
    world = read_index(d)["world_size"]
    reader = open_checkpoint_lazy if lazy else load_checkpoint

    def one(r):
        p = d / _shard_name(r, world)
        if not p.exists():
            raise FileNotFoundError(f"missing shard {r} of {world}: {p}")
        t = template(r) if callable(template) else template
        return reader(p, template=t)

    if rank is not None:
        return one(rank)
    return [one(r) for r in range(world)]


def latest_distributed_step(dir_path) -> int:
    """The newest COMPLETE ``step_*`` directory's step under
    ``dir_path``: one with an ``index.json`` and every one of its
    world's named shard files.  Incomplete directories are skipped with
    a warning; ``-1`` when no ``step_*`` directory exists; raises
    :class:`AllCheckpointsTornError` when some exist but none is
    complete."""
    d = Path(dir_path)
    dirs = sorted(d.glob("step_*"), reverse=True) if d.is_dir() else []
    for sd in dirs:
        if not (sd / "index.json").exists():
            continue
        try:
            world = read_index(sd)["world_size"]
        except (OSError, ValueError):
            continue
        missing = [r for r in range(world) if not (sd / _shard_name(r, world)).exists()]
        if not missing:
            return checkpoint_step(sd)
        log_structured(_logger, logging.WARNING, "checkpoint.incomplete_step_dir_skipped",
                       path=str(sd), world_size=world, missing_ranks=missing[:8],
                       missing=len(missing))
    if dirs:
        raise AllCheckpointsTornError(
            f"no complete checkpoint under {dir_path}: {len(dirs)} step_* dir(s) exist but "
            "none is fully published (interrupted save?)")
    return -1


class LocalShard(NamedTuple):
    """This rank's slice of a larger tensor, for
    :func:`save_distributed_checkpoint`: ``data`` lies at ``start`` (one
    offset a dimension) of a global tensor the template gives."""

    data: Any
    start: tuple


def _distributed_payload(tree: Any, rank: int) -> dict:
    """``{keystr: [{"start", "stop", "data"}]}``: this rank's pieces."""
    payload = {}

    def walk(x, prefix):
        if isinstance(x, LocalShard):
            start = np.asarray(x.start, np.int64)
            payload[prefix] = [{"start": start, "data": x.data,
                                "stop": start + np.asarray(tuple(x.data.shape), np.int64)}]
            return
        node = _tree._children(x)
        if node is None:
            shape = tuple(getattr(x, "shape", np.shape(x)))
            payload[prefix] = [] if rank != 0 else [{
                "start": np.zeros(len(shape), np.int64), "stop": np.asarray(shape, np.int64),
                "data": x}]
            return
        kind, keys, kids = node
        names = (keys if kind == "dict" else keys._fields if kind == "namedtuple"
                 else range(len(kids)))
        for name, kid in zip(names, kids):
            walk(kid, prefix + _tree._key_entry(kind, name))

    walk(tree, "")
    return payload


def save_distributed_checkpoint(dir_path, tree: Any, rank: Optional[int] = None,
                                world_size: Optional[int] = None) -> str:
    """Each process writes only its own pieces of ``tree`` (host leaves):
    rank 0 every replicated leaf whole, every rank its
    :class:`LocalShard` slices.  Call from every rank (``rank`` /
    ``world_size`` default to the default process group's); reassemble
    with :func:`load_distributed_checkpoint`."""
    if rank is None or world_size is None:
        import torch.distributed as dist

        rank, world_size = dist.get_rank(), dist.get_world_size()
    return save_sharded_checkpoint(dir_path, _distributed_payload(tree, rank), rank,
                                   world_size)


def _assemble_slice(pieces, shape, key):
    """The global leaf of ``shape`` from saved ``pieces``; raises unless
    they cover every element."""
    out, covered = None, 0
    for s in pieces:
        data = s["data"]
        start = [int(a) for a in np.asarray(s["start"]).reshape(-1)]
        stop = [int(b) for b in np.asarray(s["stop"]).reshape(-1)]
        if out is None:
            out = (torch.zeros(shape, dtype=data.dtype) if isinstance(data, torch.Tensor)
                   else np.zeros(shape, np.asarray(data).dtype))
        idx = tuple(slice(a, b) for a, b in zip(start, stop))
        out[idx] = data
        covered += int(np.prod([b - a for a, b in zip(start, stop)], dtype=np.int64))
    want = int(np.prod(shape, dtype=np.int64))
    if out is None or covered != want:
        raise ValueError(f"checkpoint shards cover {covered}/{want} elements of leaf {key} "
                         "— shape mismatch between the saved state and the template")
    return out


def load_distributed_checkpoint(dir_path, template: Any) -> Any:
    """Reassemble a :func:`save_distributed_checkpoint` directory into
    the structure of ``template`` (its leaves' shapes are the global
    shapes), as host tensors."""
    payloads = load_sharded_checkpoint(dir_path)
    leaves = []
    for path, leaf in _tree.leaves_with_path(template):
        pieces = [s for p in payloads for s in p.get(path, ())]
        if not pieces:
            raise KeyError(f"checkpoint has no shards for leaf {path}")
        shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
        leaves.append(_assemble_slice(pieces, shape, path))
    return _tree.tree_unflatten(template, leaves)
