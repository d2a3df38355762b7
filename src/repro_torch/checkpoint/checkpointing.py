"""Checkpoints of a training state: save, async writes, rotation and
restore (counterpart of ``repro/checkpoint/checkpointing.py``).

* **Layout** (the reference's): ``<dir>/step_N/`` holds one
  ``shards_h{host}.npz`` a host, keyed ``"<name>|full"`` or
  ``"<name>|<start>:<stop>,…"`` (a stop of -1 is the end of the axis),
  and a manifest.  ``<name>`` is JAX's ``keystr`` of the leaf's path,
  ``"['opt']['m']['embed']"``, so both packages name a tensor alike.
* **Atomicity**: a save writes ``step_N.tmp/`` and renames it onto
  ``step_N/`` once the shards and the manifest are fsynced;
  :func:`latest_step` skips ``.tmp`` directories, so a crash mid-write
  never hides the last whole checkpoint.  Rotation keeps ``keep``.
* **Async**: ``save_checkpoint(..., async_=True)`` copies every leaf to
  host memory on the caller's thread and writes on a background thread,
  so the training loop is blocked only for the device→host copy.  The
  copy is a copy even of a CPU tensor: the port's optimizer updates in
  place, and a view would let the writer save a later step's values.
* **Restore** assembles each tensor from whatever shards the files hold,
  whole or sliced by any number of hosts (the read side of the
  reference's reshard-on-restore), and matches leaves by name, not by
  order: JAX flattens a dict in sorted key order, :func:`tree_paths` in
  insertion order.  A missing tensor raises ``KeyError``, a shard or
  shape that does not fit the target leaf ``ValueError``; nothing is
  filled in.  A restored leaf lands on the target leaf's device and
  dtype; ``inplace=True`` writes it into the target leaf itself, one
  leaf at a time from host memory, so that restoring a training state
  on the card needs no second copy of it there.

Where the port differs from the reference:

* The manifest is ``manifest.json`` with the reference's fields (step,
  names, structure, shapes, dtypes): the port does not depend on
  ``msgpack``.  The loader reads no manifest (the reference's reads
  ``manifest.msgpack`` and never uses it), so the port restores the
  reference's checkpoints as they are; the reference cannot read the
  port's.
* Non-tensor leaves: a Python int (the optimizer's ``"step"``) is saved
  as a 0-d int32 array, as the reference holds it, and restored as an
  int.  bf16 has no numpy dtype: it is stored as the raw 2-byte void
  ``|V2``, as numpy writes the reference's bf16 arrays, and a ``|V2``
  shard is read back as bf16 bit for bit.
* A failed background write is raised by :meth:`CheckpointManager.wait`
  and the next :meth:`CheckpointManager.maybe_save` (the reference's
  thread loses it); the shards file is fsynced as well as the manifest.

Sharded state (a run on a ``(data, model)`` mesh, where each rank
holds blocks):

* ``save_checkpoint(..., shardings=specs, mesh=mesh)``, called by every
  rank: each rank writes ``shards_h{rank}.npz`` holding its blocks keyed
  ``"<name>|<start>:<stop>,…"`` by their global slices, in the
  reference's format (a dimension held whole is ``0:-1``); a fused
  leaf's block (``sharding.Fused``: ``[v_r | og_r]``) is written as its
  parts, one key a part, so the file holds the reference's global
  layout.  A block is written by one rank only (the rank at index 0 of
  every mesh axis the leaf is not split over, and the first of the
  ranks that hold a replicated kv head), a leaf held whole as
  ``"<name>|full"``.  A world of more than one rank saves only this
  way.
* Completion: a rank's shard file appears under its final name only
  once it is fsynced (written as ``.part``, then renamed); rank 0 writes
  the manifest, waits until every rank's shard file is there, and only
  then renames ``step_N.tmp`` onto ``step_N`` — so a rank that is slower
  (or dead) leaves no ``step_N`` with a shard missing.  A stale
  ``step_N.tmp`` is removed by rank 0 before a barrier that every rank
  passes before writing.  The barrier runs on the caller's thread; the
  writer threads run no collective, only the file-system wait.
* ``load_checkpoint(..., shardings=specs, mesh=mesh)`` and
  ``restore_latest(..., shardings=)``: each target leaf is this rank's
  block; it is read from the checkpoint's full tensor, whatever number
  of ranks (the reference's hosts included) wrote it.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.data.pipeline import host_and_count

#: how numpy stores a bf16 array (it has no bf16 dtype)
_BF16_FILE = np.dtype("V2")
#: how long rank 0's writer waits for the other ranks' shard files
SHARD_WAIT_S = 600.0


def _keystr(path: tuple) -> str:
    """JAX's ``keystr`` of a path of dict keys: ``"['opt']['step']"``."""
    return "".join(f"[{k!r}]" for k in path)


def _flatten(tree: dict, prefix: tuple = ()) -> list[tuple[str, object]]:
    """``(name, leaf)`` of a nested dict in JAX's order (sorted keys)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _flatten(v, prefix + (k,))
        else:
            out.append((_keystr(prefix + (k,)), v))
    return out


def _structure(tree) -> str:
    """The tree's shape as JAX prints a dict tree's ``PyTreeDef``."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    return "*"


def _to_host(leaf) -> np.ndarray:
    """A host copy of one leaf as the file stores it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_FILE)
        return t.numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)
    raise TypeError(f"checkpoint: cannot save a leaf of type "
                    f"{type(leaf).__name__}")


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return "int32"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class AsyncSave(threading.Thread):
    """A checkpoint write on a background thread.  ``stats``: the step,
    the bytes written, the snapshot's ms on the caller's thread, and the
    write's seconds once it ends.  :meth:`result` joins and raises what
    the write raised.  The host copy is let go once the write ends, so a
    caller that keeps the handle does not keep the state's bytes."""

    def __init__(self, write, stats: dict):
        super().__init__(daemon=True, name=f"ckpt-{stats['step']}")
        self._write, self.stats, self.error = write, stats, None

    def run(self):
        t0 = time.perf_counter()
        try:
            self._write()
        except BaseException as e:          # re-raised by result()
            self.error = e
        finally:
            self.stats["write_s"] = time.perf_counter() - t0
            self._write = None

    def result(self) -> None:
        self.join()
        if self.error is not None:
            raise self.error


def _index_key(sls: tuple, shape: tuple) -> str:
    """The reference's shard key of a block's global slices: a dimension
    held whole is ``0:-1``."""
    return ",".join("0:-1" if (s.start, s.stop) == (0, n)
                    else f"{s.start}:{s.stop}" for s, n in zip(sls, shape))


def _spec_leaves(shardings: dict, tree: dict) -> dict:
    """``{name: spec}`` of a spec tree shaped like ``tree`` (a leaf's
    spec None is replicated)."""
    from repro_torch.distributed.sharding import P
    out = {}
    for (name, spec), (tname, _) in zip(_flatten(shardings),
                                        _flatten(tree)):
        if name != tname:
            raise ValueError(f"checkpoint: shardings hold {name}, the tree "
                             f"{tname}")
        out[name] = P() if spec is None else spec
    return out


def _sharded_shards(tree: dict, shardings: dict, mesh):
    """This rank's ``{key: host array}`` and every leaf's global shape
    and dtype name."""
    from repro_torch.distributed import sharding as sh
    specs = _spec_leaves(shardings, tree)
    shards, shapes, dtypes = {}, [], []
    for name, leaf in _flatten(tree):
        spec = specs[name]
        block = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()
        full = sh.global_shape(block, spec, mesh)
        shapes.append(list(full))
        dtypes.append(_dtype_name(leaf))
        used = {a for e in spec for a in sh.entry_axes(e)}
        if any(mesh.coords[a] for a in mesh.axis_names if a not in used) \
                or (sh.MODEL in used and mesh.coords[sh.MODEL] % spec.rep):
            continue            # another rank writes this block
        if full == block:
            shards[f"{name}|full"] = _to_host(leaf)
            continue
        parts = sh.block_parts(full, spec, mesh)
        host, at = _to_host(leaf), 0
        for sls in parts:       # a fused block's parts, side by side
            w = sls[-1].stop - sls[-1].start
            shards[f"{name}|{_index_key(sls, full)}"] = np.ascontiguousarray(
                host[..., at:at + w]) if len(parts) > 1 else host
            at += w
    return shards, shapes, dtypes


def _fsynced(path: str, put) -> None:
    with open(path, "wb") as f:
        put(f)
        f.flush()
        os.fsync(f.fileno())


def _wait_for_shards(tmp: str, world: int) -> None:
    want = [os.path.join(tmp, f"shards_h{r}.npz") for r in range(world)]
    deadline = time.monotonic() + SHARD_WAIT_S
    while not all(os.path.exists(p) for p in want):
        if time.monotonic() > deadline:
            missing = [os.path.basename(p) for p in want
                       if not os.path.exists(p)]
            raise TimeoutError(f"checkpoint {tmp}: {missing} not written "
                               f"after {SHARD_WAIT_S:.0f} s")
        time.sleep(0.01)


def save_checkpoint(ckpt_dir: str, step: int, tree: dict, *,
                    async_: bool = False, keep: int = 3, shardings=None,
                    mesh=None):
    """Save a nested dict of tensors (and ints) as
    ``step``; with ``async_`` return the :class:`AsyncSave` writing it
    (every leaf already copied to host memory), else write and return
    None.  With ``shardings`` (a tree of ``P`` shaped like ``tree``)
    and ``mesh`` every rank calls it with its blocks (the module's
    docstring); a world of more than one rank must."""
    rank, world = host_and_count()
    if shardings is not None and mesh is None:
        from repro_torch.distributed.sharding import current_mesh
        mesh = current_mesh()
    if world > 1 and (shardings is None or mesh is None):
        raise ValueError(
            f"save_checkpoint: a world of {world} ranks saves each rank's "
            f"blocks — pass shardings= and mesh=")
    if shardings is not None and mesh is None:
        raise ValueError("save_checkpoint: shardings= needs a mesh")
    t0 = time.perf_counter()
    leaves = _flatten(tree)
    if shardings is None:
        shards = {f"{name}|full": _to_host(leaf) for name, leaf in leaves}
        shapes = [list(np.shape(a)) for a in shards.values()]
        dtypes = [_dtype_name(leaf) for _, leaf in leaves]
    else:
        shards, shapes, dtypes = _sharded_shards(tree, shardings, mesh)
    meta = {"step": step, "names": [n for n, _ in leaves],
            "treedef": f"PyTreeDef({_structure(tree)})",
            "shapes": shapes, "dtypes": dtypes}
    stats = {"step": step,
             "bytes": sum(a.nbytes for a in shards.values()),
             "snapshot_ms": (time.perf_counter() - t0) * 1e3}
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    if world > 1:
        if rank == 0 and os.path.exists(tmp):
            shutil.rmtree(tmp)      # a crashed save's leftovers
        import torch.distributed as dist
        dist.barrier()

    def write():
        final = os.path.join(ckpt_dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        mine = os.path.join(tmp, f"shards_h{rank}.npz")
        _fsynced(mine + ".part", lambda f: np.savez(f, **shards))
        os.replace(mine + ".part", mine)
        if rank:
            return              # rank 0 completes the checkpoint
        _fsynced(os.path.join(tmp, "manifest.json"),
                 lambda f: f.write(json.dumps(meta).encode()))
        _wait_for_shards(tmp, world)
        _fsync_dir(tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(ckpt_dir)
        _gc(ckpt_dir, keep)

    if async_:
        t = AsyncSave(write, stats)
        t.start()
        return t
    write()
    return None


def _gc(ckpt_dir: str, keep: int):
    for s in latest_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)


def latest_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                out.append(int(d.split("_")[1]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = latest_steps(ckpt_dir)
    return steps[-1] if steps else None


def _slices(name: str, idx: str, shape: tuple) -> tuple:
    """The slices of a shard key's ``<start>:<stop>,…`` within ``shape``."""
    parts = idx.split(",")
    if len(parts) != len(shape):
        raise ValueError(f"checkpoint: shard {name}|{idx} has {len(parts)} "
                         f"axes, the target {shape}")
    out = []
    for p, n in zip(parts, shape):
        a, b = (int(x) for x in p.split(":"))
        b = n if b == -1 else b
        if not 0 <= a <= b <= n:
            raise ValueError(f"checkpoint: shard {name}|{idx} lies outside "
                             f"the target {shape}")
        out.append(slice(a, b))
    return tuple(out)


def _assemble(name: str, shape: tuple, parts: dict) -> np.ndarray:
    """One tensor from its shards (``{index key: array loader}``), whole
    or sliced; the same index from two hosts (a replicated tensor) is
    read once."""
    if "full" in parts:
        arr = parts["full"]()
        if arr.shape != shape:
            raise ValueError(f"checkpoint: {name} has shape {arr.shape}, "
                             f"the target {shape}")
        return arr
    out = covered = None
    for idx, load in parts.items():
        sls = _slices(name, idx, shape)
        piece = load()
        want = tuple(s.stop - s.start for s in sls)
        if piece.shape != want:
            raise ValueError(f"checkpoint: shard {name}|{idx} has shape "
                             f"{piece.shape}, its slice {want}")
        if len(parts) == 1 and want == shape:
            return piece
        if out is None:
            out = np.empty(shape, piece.dtype)
            covered = np.zeros(shape, bool)
        if piece.dtype != out.dtype:
            raise ValueError(f"checkpoint: shards of {name} disagree on "
                             f"dtype ({piece.dtype}, {out.dtype})")
        out[sls] = piece
        covered[sls] = True
    if not covered.all():
        raise ValueError(f"checkpoint: the shards of {name} cover "
                         f"{int(covered.sum())} of {covered.size} entries")
    return out


def _as_leaf(arr: np.ndarray, like, host: bool = False):
    """``arr`` as the target leaf's kind, device (with ``host``, left in
    host memory) and dtype."""
    if isinstance(like, torch.Tensor):
        if arr.dtype == _BF16_FILE:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(device="cpu" if host else like.device, dtype=like.dtype)
    if isinstance(like, int) and not isinstance(like, bool):
        return int(arr)
    raise TypeError(f"checkpoint: cannot restore a leaf of type "
                    f"{type(like).__name__}")


def load_checkpoint(ckpt_dir: str, step: int, target_tree: dict, *,
                    shardings=None, mesh=None,
                    inplace: bool = False) -> dict:
    """``target_tree``'s structure with every leaf read from checkpoint
    ``step``, on the target leaf's device and dtype.

    With ``shardings`` (a tree of ``P`` shaped like the target) and
    ``mesh`` (default: the active one of ``distributed.sharding``) each
    target leaf is this rank's block under its spec, and is read from
    the tensor's global slices (a fused block's parts, side by side).

    With ``inplace`` the checkpoint is written into ``target_tree``
    itself and that tree is returned: each tensor leaf is assembled in
    host memory and copied into the target tensor before the next is
    read (so a parameter stays a leaf that requires grad, and the device
    never holds a second copy of the state), other leaves (the
    optimizer's step) are replaced.  Every name is looked up before the
    first write; a shard that does not fit raises part way, leaving the
    target partly written."""
    block_of = None
    if shardings is not None:
        from repro_torch.distributed import sharding as sh
        mesh = mesh if mesh is not None else sh.current_mesh()
        if mesh is None:
            raise ValueError("load_checkpoint: shardings= needs a mesh")
        specs = _spec_leaves(shardings, target_tree)

        def block_of(name, block_shape):
            spec = specs[name]
            full = sh.global_shape(block_shape, spec, mesh)
            return full, sh.block_parts(full, spec, mesh)
    path = os.path.join(ckpt_dir, f"step_{step}")
    files = [np.load(os.path.join(path, fn))
             for fn in sorted(os.listdir(path)) if fn.endswith(".npz")]
    try:
        index: dict[str, dict] = {}
        for zf in files:
            for key in zf.files:
                name, _, idx = key.partition("|")
                index.setdefault(name, {}).setdefault(
                    idx, lambda zf=zf, key=key: zf[key])
        for name, _ in _flatten(target_tree):
            if name not in index:
                raise KeyError(f"checkpoint missing tensor {name}")

        def read(name, like):
            shape = tuple(like.shape) if hasattr(like, "shape") else ()
            if block_of is None:
                return _assemble(name, shape, index[name])
            full, parts = block_of(name, shape)
            whole = _assemble(name, full, index[name])
            if len(parts) == 1:
                return whole[parts[0]]
            return np.concatenate([whole[sls] for sls in parts], -1)

        def build(node, prefix):
            out = {}
            for k, like in node.items():
                name = _keystr(prefix + (k,))
                if isinstance(like, dict):
                    out[k] = build(like, prefix + (k,))
                elif inplace and isinstance(like, torch.Tensor):
                    with torch.no_grad():
                        like.copy_(_as_leaf(read(name, like), like,
                                            host=True))
                    out[k] = like
                else:
                    out[k] = _as_leaf(read(name, like), like)
                if inplace:
                    node[k] = out[k]
            return node if inplace else out
        return build(target_tree, ())
    finally:
        for zf in files:
            zf.close()


class CheckpointManager:
    """Rotation, one async write at a time, and restore-latest; with a
    ``mesh`` every save and restore is of this rank's blocks (the
    ``shardings=`` of :func:`save_checkpoint` and
    :func:`load_checkpoint`)."""

    def __init__(self, ckpt_dir: str, keep: int = 3, every: int = 100,
                 mesh=None):
        self.dir = ckpt_dir
        self.keep = keep
        self.every = every
        self.mesh = mesh
        self.last_saved: int | None = None
        self._pending: AsyncSave | None = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def maybe_save(self, step: int, tree: dict, force: bool = False,
                   shardings=None) -> AsyncSave | None:
        """Save at every ``every``-th step, or when forced; a step this
        manager saved or restored already is not written again.  Returns
        the write it started (its ``stats``), else None."""
        if (not force and step % self.every) or step == self.last_saved:
            return None
        self.wait()
        self._pending = save_checkpoint(
            self.dir, step, tree, async_=True, keep=self.keep,
            shardings=shardings, mesh=self.mesh if shardings else None)
        self.last_saved = step
        return self._pending

    def writing(self) -> bool:
        """Whether a write is in flight."""
        return self._pending is not None and self._pending.is_alive()

    def wait(self):
        """Join the write in flight; raises what it raised."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def restore_latest(self, target_tree: dict, shardings=None, *,
                       inplace: bool = False):
        """``(tree, step)`` of the newest checkpoint, or ``(None, 0)``;
        ``inplace`` as in :func:`load_checkpoint`."""
        step = latest_step(self.dir)
        if step is None:
            return None, 0
        tree = load_checkpoint(self.dir, step, target_tree,
                               shardings=shardings, mesh=self.mesh,
                               inplace=inplace)
        self.last_saved = step
        return tree, step
