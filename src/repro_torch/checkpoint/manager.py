"""Atomic, durable, asynchronous checkpoints on one device (the counterpart
of the reference's ``checkpoint/manager.py``), in the reference's on-disk
format, so that either package restores what the other wrote.

Layout per step::

    <dir>/step_00000123.tmp/ ... -> renamed to <dir>/step_00000123/
        manifest.json   {"step", "treedef", "leaves": [{"file", "param",
                         "shape", "dtype", "crc32"}, ...]}
        arr_<n>.npy     one file per leaf, in the reference's flatten order
                        (nested dicts by sorted key), ``param`` its path
                        (``jax.tree_util.keystr``: ``['groups']['b0']...``)

  * Atomic and durable: every leaf and the manifest are fsync'd, then the
    tmp directory, then it is renamed and its parent fsync'd.  A crash
    mid-write leaves only a ``.tmp`` directory; restore lists complete
    steps only.
  * Asynchronous, with loud failures: the leaves are copied to the host on
    the caller's thread (the writer thread never reads a CUDA tensor), a
    background thread serializes them (IO_THREADS leaves at a time, as
    restore reads them), and its failure is raised again at the next
    ``wait()`` or ``save()``.
  * Integrity: a crc32 of each leaf's bytes, its shape and dtype in the
    manifest, checked at restore; a mismatch raises
    ``CheckpointCorruptionError`` naming the parameter.  ``restore(...,
    fallback=True)`` reports a corrupted step and restores the newest
    earlier intact one.
  * Retention (``keep``) never deletes a step whose save is in flight.
  * Legacy migration: ``export_legacy`` writes the packed ``wqkv`` as
    separate ``wq``/``wk``/``wv`` leaves, and ``restore(..., cfg=...)``
    packs such a checkpoint back.

bf16 leaves: numpy has no bf16 without ``ml_dtypes``, so the port holds a
bf16 leaf as its 2-byte words, a numpy array of dtype ``V2``
(``BF16_WORDS``), and writes it as the reference writes a bf16 array:
descr ``'<V2'``, manifest dtype ``"bfloat16"``, the crc32 over the same
bytes.  ``convert.from_jax_params`` reads such words back into bf16.  The
reference's own reader refuses these leaves (it compares the loaded
``V2`` dtype with the manifest's ``bfloat16``; ROADMAP F7).

Not ported: the reference's elastic re-placement (``restore``'s
``mesh``/``specs``), which comes with multi-device serving.
"""
from __future__ import annotations

import ast
import json
import os
import re
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

BF16_WORDS = np.dtype("V2")
# leaves are written and read on this many threads at once (file I/O,
# fsync and crc32 release the GIL)
IO_THREADS = min(8, os.cpu_count() or 1)
_KEY = re.compile(r"\[('(?:[^'\\]|\\.)*'|-?\d+)\]")


class CheckpointCorruptionError(IOError):
    """A step failed its integrity check at restore.  ``param`` is the path
    of the corrupted parameter (or ``manifest.json``)."""

    def __init__(self, step: int, param: str, reason: str):
        super().__init__(
            f"checkpoint step {step} corrupted at {param!r}: {reason}")
        self.step = step
        self.param = param
        self.reason = reason


# -- trees: nested dicts (and tuples) of leaves, flattened in the reference's
# order: dicts by sorted key, tuples by index ------------------------------

def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in the reference's flatten order (a tuple's
    entries by index, as the trainer's ``(params, opt)``)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple):
        return [item for i, t in enumerate(tree)
                for item in flatten(t, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def treedef_str(tree: Any) -> str:
    """The manifest's ``treedef``: ``str`` of the reference's PyTreeDef."""
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, tuple):
            inner = ", ".join(walk(x) for x in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def _tuples(node: Any) -> Any:
    """Nodes keyed 0..n-1 by integers (a tuple's paths) back to tuples."""
    if not isinstance(node, dict):
        return node
    node = {k: _tuples(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node) \
            and sorted(node) == list(range(len(node))):
        return tuple(node[i] for i in range(len(node)))
    return node


def unflatten(paths: List[str], leaves: List[Any]) -> Any:
    """Nested dicts (and tuples) from ``flatten``'s paths."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        keys = [ast.literal_eval(k) for k in _KEY.findall(path)]
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return _tuples(out)


def host_copy(x: Any) -> np.ndarray:
    """A host copy of one leaf, made on the caller's thread: a torch tensor
    (any device) or an array; a bf16 leaf becomes its ``BF16_WORDS``."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_WORDS)
        return t.numpy()
    arr = np.array(x, copy=True)
    if arr.dtype.name == "bfloat16":          # an ml_dtypes array
        return arr.view(np.uint16).view(BF16_WORDS)
    return arr


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == BF16_WORDS else str(arr.dtype)


def _io_map(fn, items) -> list:
    """``[fn(x) for x in items]`` on IO_THREADS threads; the first failure
    in ``items``' order is raised once every call has ended."""
    with ThreadPoolExecutor(IO_THREADS) as pool:
        futures = [pool.submit(fn, x) for x in items]
    return [f.result() for f in futures]


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _crc32(arr: np.ndarray) -> int:
    """crc32 of a leaf's bytes in C order (read in place where the array
    is contiguous: the bytes ``tobytes`` would copy)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _write_leaf(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        if arr.dtype == BF16_WORDS:
            # the header numpy writes for a bf16 array
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": arr.shape})
            f.write(np.ascontiguousarray(arr).tobytes())
        else:
            np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())


# -- legacy (separate wq/wk/wv) migration -------------------------------------

def _qkv_layout(cfg):
    from repro_torch.models.attention import qkv_packing, qkv_sizes
    return tuple(qkv_sizes(cfg)), qkv_packing(cfg)


def _map_attn(tree: Any, fn) -> Any:
    """``tree`` with ``fn`` applied to every dict under a key ``attn`` (the
    self-attention's; whisper's ``xattn`` keeps its separate views)."""
    if not isinstance(tree, dict):
        return tree
    return {k: fn(v) if k == "attn" and isinstance(v, dict)
            else _map_attn(v, fn) for k, v in tree.items()}


def pack_legacy(tree: Any, cfg) -> Any:
    """Pack every self-attention's ``wq``/``wk``/``wv`` into ``wqkv``
    (column groups of ``qkv_packing(cfg)``, the reference's
    ``param.pack_views``)."""
    sizes, g = _qkv_layout(cfg)

    def pack(attn):
        if "wqkv" in attn or not {"wq", "wk", "wv"} <= set(attn):
            return attn
        views = [attn[n] for n in ("wq", "wk", "wv")]
        lead = views[0].shape[:-1]
        parts = [v.reshape(*lead, g, s // g) for v, s in zip(views, sizes)]
        out = {k: v for k, v in attn.items() if k not in ("wq", "wk", "wv")}
        out["wqkv"] = np.concatenate(parts, axis=-1).reshape(*lead, -1)
        return out
    return _map_attn(tree, pack)


def split_legacy(tree: Any, cfg) -> Any:
    """The inverse of ``pack_legacy`` (the reference's
    ``param.split_tree`` for the packed ``wqkv``)."""
    sizes, g = _qkv_layout(cfg)

    def split(attn):
        if "wqkv" not in attn:
            return attn
        w = attn["wqkv"]
        lead = w.shape[:-1]
        a = w.reshape(*lead, g, sum(sizes) // g)
        cuts = np.cumsum([s // g for s in sizes])[:-1]
        out = {k: v for k, v in attn.items() if k != "wqkv"}
        for name, part, s in zip(("wq", "wk", "wv"),
                                 np.split(a, cuts, axis=-1), sizes):
            out[name] = np.ascontiguousarray(part).reshape(*lead, s)
        return out
    return _map_attn(tree, split)


# -- the manager ---------------------------------------------------------------

class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._pending: set = set()      # steps with a save in flight
        self._error: Optional[BaseException] = None

    # -- save -----------------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        items = flatten(tree)
        paths = [p for p, _ in items]
        treedef = treedef_str(tree)
        # host copies on this thread: the writer never reads a CUDA tensor,
        # and the caller may change its tensors once save returns
        host = [host_copy(x) for _, x in items]
        self.wait()  # one writer at a time; re-raises an earlier failure
        with self._lock:
            self._pending.add(step)

        def write():
            tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
            final = os.path.join(self.dir, f"step_{step:08d}")
            try:
                os.makedirs(tmp, exist_ok=True)

                def put(i):
                    _write_leaf(os.path.join(tmp, f"arr_{i}.npy"), host[i])
                    return _crc32(host[i])
                crcs = _io_map(put, range(len(host)))
                manifest = {"step": step, "treedef": treedef, "leaves": [{
                    "file": f"arr_{i}.npy",
                    "param": paths[i],
                    "shape": list(arr.shape),
                    "dtype": _dtype_name(arr),
                    "crc32": crc,
                } for i, (arr, crc) in enumerate(zip(host, crcs))]}
                mpath = os.path.join(tmp, "manifest.json")
                with open(mpath, "w") as f:
                    json.dump(manifest, f)
                    f.flush()
                    os.fsync(f.fileno())
                _fsync_dir(tmp)
                os.rename(tmp, final)  # the commit
                _fsync_dir(self.dir)   # the rename itself must survive
            except BaseException as e:  # noqa: BLE001 - must not vanish
                with self._lock:
                    if self._error is None:  # keep the first failure
                        self._error = e
                    self._pending.discard(step)
                shutil.rmtree(tmp, ignore_errors=True)
                return
            # durable: the step leaves the pending set (and may fall to its
            # own retention)
            with self._lock:
                self._pending.discard(step)
            self._gc()

        if self.async_save and not blocking:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
            self._raise_pending_error()

    def wait(self) -> None:
        """Join an in-flight save and raise its failure, once."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending_error()

    def _raise_pending_error(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def _gc(self) -> None:
        with self._lock:
            pending = set(self._pending)
        # a step in flight is never deleted and does not count as one of
        # the ``keep`` durable steps
        steps = [s for s in self.all_steps() if s not in pending]
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def export_legacy(self, step: int, tree: Any, cfg,
                      blocking: bool = True) -> None:
        """Save with every packed ``wqkv`` split into ``wq``/``wk``/``wv``
        leaves, for tooling that predates packing."""
        def host(t):
            return ({k: host(v) for k, v in t.items()}
                    if isinstance(t, dict) else host_copy(t))
        self.save(step, split_legacy(host(tree), cfg), blocking=blocking)

    # -- restore ----------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int], like: Any = None, *, cfg=None,
                fallback: bool = False) -> Tuple[int, Any]:
        """``(step, tree)`` of numpy leaves (bf16 as ``BF16_WORDS``).

        The tree is rebuilt from the manifest's paths; ``like`` (a tree)
        gives it that tree's structure instead, filled in flatten order as
        the reference fills its ``like``.  ``cfg`` (the model's
        ``ArchConfig``, the counterpart of the reference's ``defs``) packs
        a checkpoint of separate ``wq``/``wk``/``wv`` leaves into ``wqkv``.
        ``step`` None restores the newest step.  Every leaf is checked
        against the manifest; corruption raises
        ``CheckpointCorruptionError`` naming the parameter, or with
        ``fallback`` is printed and the newest earlier intact step
        restored, the error raised only when none is left."""
        steps = self.all_steps()
        if step is None:
            if not steps:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
            candidates = list(reversed(steps))
        else:
            candidates = [step] + (
                [s for s in reversed(steps) if s < step] if fallback else [])
        last_err: Optional[CheckpointCorruptionError] = None
        for s in candidates:
            try:
                return s, self._restore_step(s, like, cfg)
            except CheckpointCorruptionError as e:
                last_err = e
                if not fallback:
                    raise
                print(f"checkpoint: {e}; falling back to the previous "
                      f"intact step")
        assert last_err is not None
        raise CheckpointCorruptionError(
            last_err.step, last_err.param,
            f"{last_err.reason} (and no earlier intact step to fall "
            f"back to)")

    def _restore_step(self, step: int, like: Any, cfg) -> Any:
        d = os.path.join(self.dir, f"step_{step:08d}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, UnicodeDecodeError, json.JSONDecodeError) as e:
            raise CheckpointCorruptionError(
                step, "manifest.json",
                f"unreadable manifest ({type(e).__name__}: {e})") from e
        metas = manifest["leaves"]
        tree = unflatten([m["param"] for m in metas],
                         _io_map(lambda m: self._load_leaf(d, m, step),
                                 metas))
        if cfg is not None:
            tree = pack_legacy(tree, cfg)
        if like is None:
            return tree
        leaves = [x for _, x in flatten(tree)]
        like_paths = [p for p, _ in flatten(like)]
        if len(leaves) != len(like_paths):
            raise ValueError(
                f"checkpoint at step {step} has {len(leaves)} leaves but "
                f"the target tree has {len(like_paths)}; a checkpoint of "
                f"separate wq/wk/wv leaves needs cfg= to be packed")
        return unflatten(like_paths, leaves)

    def _load_leaf(self, d: str, meta, step: int) -> np.ndarray:
        name = meta.get("param", meta["file"])
        try:
            arr = np.load(os.path.join(d, meta["file"]))
        except Exception as e:  # a torn .npy: the parser's failure
            raise CheckpointCorruptionError(
                step, name,
                f"unreadable leaf file {meta['file']} "
                f"({type(e).__name__}: {e})") from e
        if list(arr.shape) != list(meta["shape"]) \
                or _dtype_name(arr) != meta["dtype"]:
            raise CheckpointCorruptionError(
                step, name,
                f"shape/dtype mismatch: manifest says "
                f"{meta['shape']}/{meta['dtype']}, file holds "
                f"{list(arr.shape)}/{_dtype_name(arr)}")
        crc = _crc32(arr)
        if crc != meta["crc32"]:
            raise CheckpointCorruptionError(
                step, name,
                f"crc32 mismatch in {meta['file']} (expected "
                f"{meta['crc32']}, got {crc})")
        return arr
