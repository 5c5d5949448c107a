"""On-disk feature store: image id -> float32[4096] fc7 vector.

A copy of ``lrcn_tpu/data/feature_store.py`` in the same on-disk format, so
each package reads the other's stores.  It is copied, not imported, because
``lrcn_tpu.data`` loads JAX through its package ``__init__``.

Replaces the reference's JLD feature dicts (``featsn.jld`` etc., loaded
whole into host RAM at lrcn.jl:121-123) with a memory-mappable directory
format:

    store_dir/
      features.npy   (N, dim) float32, mmap-able
      ids.npy        (N,) int64, row i holds the image id of features[i]
      meta.json      {"dim": ..., "normalized": ...}

``gather`` vectorizes the reference's per-batch, row-by-row host->device
feature copy (lrcn.jl:369-376) into one fancy-index + one transfer.
Extraction is resumable like the reference (skips ids already present,
lrcn.jl:203) via the append + save cycle.

``device_table`` puts a store's whole table on a device in a compute
dtype: the float32 rows go up as they are stored, through pinned blocks
on a card, and are cast there.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Mapping, Sequence

import numpy as np
import torch

from lrcn_tpu_torch.config import CNN_FEATURE_DIM

STAGE_BYTES = 16 << 20   # one pinned block of device_table's upload


def l1_normalize(feats: np.ndarray) -> np.ndarray:
    """Per-row L1 normalization.

    The reference's generation path normalizes live CNN features by their
    sum (``input/sum(input)``, lrcn.jl:597) and its precomputed feature
    files (``featsn.jld``) are stored already normalized.  fc7 is taken
    before relu7 (lrcn.jl:717), so a row may hold negative entries: the
    divisor is the row's signed sum, not its L1 norm.  A row that sums to
    0 is left as it is.
    """
    sums = feats.sum(axis=-1, keepdims=True)
    return feats / np.where(sums == 0, 1.0, sums)


def _read_only(array: np.ndarray) -> np.ndarray:
    """``array`` itself where numpy already refuses writes to it, else a
    view that refuses them (the array stays writable)."""
    if array.flags.writeable:
        array = array.view()
        array.flags.writeable = False
    return array


class FeatureStore:
    """Mutable id -> feature mapping with mmap-able persistence.

    Rows live in at most two arrays: the rows loaded from disk (``load``:
    the memory map itself, or one array with ``mmap=False``), then the
    appended ones, written by ``add`` into one ``(capacity, dim)``
    float32 array that grows geometrically.  So ``table()`` is a view, and
    copies only for a store holding both kinds of row (extraction resumed
    from disk), counted in ``table_copies``.

    What ``table()`` and ``get`` return is read-only: a caller that wants
    to write copies it, and cannot reach the store.  Such a view never
    changes under its holder: ``add`` writes past the rows it shows, or
    moves the rows to a larger array and leaves the old one as it is.
    (``torch.from_numpy`` warns on a read-only array; ``device_table``
    uploads one without it.)
    """

    def __init__(self, dim: int = CNN_FEATURE_DIM, normalized: bool = False):
        self.dim = dim
        self.normalized = normalized
        self._index: dict[int, int] = {}
        self._added = np.empty((0, dim), np.float32)  # appended rows
        self._n_added = 0
        self._mmap: np.ndarray | None = None   # rows loaded from disk
        self._mmap_count = 0
        self.table_copies = 0   # table() calls that had to concatenate

    # --- construction ---

    @classmethod
    def from_dict(cls, feats: Mapping[int, np.ndarray],
                  normalized: bool = False) -> "FeatureStore":
        ids = list(feats)
        dim = int(np.asarray(feats[ids[0]]).reshape(-1).shape[0])
        store = cls(dim=dim, normalized=normalized)
        store.reserve(len(ids))
        for i in ids:
            store.add(i, feats[i])
        return store

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "FeatureStore":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        store = cls(dim=meta["dim"], normalized=meta.get("normalized", False))
        ids = np.load(os.path.join(path, "ids.npy"))
        # copy-on-write: the store never writes the map, and a writable
        # one lets device_table read it through torch's threaded copy
        feats = np.load(os.path.join(path, "features.npy"),
                        mmap_mode="c" if mmap else None)
        if feats.shape != (len(ids), store.dim):
            raise ValueError(f"corrupt store: features {feats.shape} vs "
                             f"{len(ids)} ids, dim {store.dim}")
        store._mmap = feats
        store._mmap_count = len(ids)
        store._index = {int(i): row for row, i in enumerate(ids)}
        return store

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        n, m = len(self), self._mmap_count
        # a copy even of a loaded store's rows: saving over the directory
        # they are mapped from truncates the file
        feats = np.empty((n, self.dim), np.float32)
        if m:
            feats[:m] = self._mmap
        feats[m:] = self._added[:self._n_added]
        ids = np.empty((n,), np.int64)
        ids[np.fromiter(self._index.values(), np.int64, count=n)] = (
            np.fromiter(self._index, np.int64, count=n))
        np.save(os.path.join(path, "features.npy"), feats)
        np.save(os.path.join(path, "ids.npy"), ids)
        # meta last: a directory is a valid store iff meta.json exists,
        # which is what save_atomic/recover key on
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"dim": self.dim, "normalized": self.normalized}, f)

    def save_atomic(self, path: str) -> None:
        """Crash-safe save: write a complete snapshot to ``path.tmp``,
        then swap it into place.

        A kill at ANY instant leaves a loadable store: either the old
        ``path``, or a complete ``path.tmp``/``path.old`` that
        :meth:`recover` rotates back in.  Required for periodic flushing
        during extraction — a plain ``save`` onto a directory this store
        is mmap-reading from would truncate the mapped file mid-run.
        """
        import shutil

        tmp, old = path + ".tmp", path + ".old"
        shutil.rmtree(tmp, ignore_errors=True)
        self.save(tmp)
        if os.path.exists(os.path.join(path, "meta.json")):
            shutil.rmtree(old, ignore_errors=True)
            os.rename(path, old)
        elif os.path.isdir(path):   # partial non-atomic save: discard
            shutil.rmtree(path)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)

    @classmethod
    def recover(cls, path: str) -> str | None:
        """Roll a crashed :meth:`save_atomic` forward; return the loadable
        path (``path`` itself) or None when nothing is there.

        Precedence: a COMPLETE ``path.tmp`` is strictly newer than
        ``path`` (save_atomic clears it before every snapshot), so it
        wins; else an intact ``path``; else ``path.old`` (the crash hit
        mid-swap).  Incomplete leftovers are removed.
        """
        import shutil

        def complete(p):
            return os.path.exists(os.path.join(p, "meta.json"))

        tmp, old = path + ".tmp", path + ".old"
        for candidate in (tmp, path, old):
            if complete(candidate):
                if candidate != path:
                    if os.path.isdir(path):
                        shutil.rmtree(path)
                    os.rename(candidate, path)
                break
        for leftover in (tmp, old):
            shutil.rmtree(leftover, ignore_errors=True)
        return path if complete(path) else None

    # --- access ---

    def __len__(self) -> int:
        return len(self._index)

    def __contains__(self, image_id: int) -> bool:
        return int(image_id) in self._index

    def ids(self) -> list[int]:
        return list(self._index)

    def _row(self, row: int) -> np.ndarray:
        if row < self._mmap_count:
            return _read_only(np.asarray(self._mmap[row]))
        return _read_only(self._added[row - self._mmap_count])

    def reserve(self, n: int) -> None:
        """Make room for ``n`` more appended rows, so that the next ``n``
        ``add`` calls copy nothing but their own rows."""
        if self._n_added + n > len(self._added):
            self._resize(self._n_added + n)

    def _resize(self, capacity: int) -> None:
        # a new array: views of the old one keep their rows
        added = np.empty((capacity, self.dim), np.float32)
        added[:self._n_added] = self._added[:self._n_added]
        self._added = added

    def add(self, image_id: int, feat: np.ndarray) -> None:
        feat = np.asarray(feat, np.float32).reshape(-1)
        if feat.shape[0] != self.dim:
            raise ValueError(f"feature dim {feat.shape[0]} != {self.dim}")
        image_id = int(image_id)
        if image_id in self._index:
            raise KeyError(f"duplicate feature id {image_id}")
        if self._n_added == len(self._added):
            self._resize(max(64, 2 * len(self._added)))
        self._added[self._n_added] = feat
        self._index[image_id] = self._mmap_count + self._n_added
        self._n_added += 1

    def get(self, image_id: int) -> np.ndarray:
        row = self._index.get(int(image_id))
        if row is None:
            # reference errors out on missing features (lrcn.jl:603)
            raise KeyError(f"missing features for image {image_id}")
        return self._row(row)

    def gather(self, image_ids: Sequence[int] | np.ndarray) -> np.ndarray:
        """Batch feature lookup -> (B, dim) float32.

        One vectorized fancy-index instead of the reference's row-by-row
        device copies (lrcn.jl:369-376).
        """
        rows = np.fromiter((self._index[int(i)] for i in image_ids),
                           np.int64, count=len(image_ids))
        m = self._mmap_count
        if not m:
            return self._added[rows]
        if not self._n_added:
            return np.asarray(self._mmap[rows])
        feats = np.empty((len(rows), self.dim), np.float32)
        loaded = rows < m
        feats[loaded] = self._mmap[rows[loaded]]
        feats[~loaded] = self._added[rows[~loaded] - m]
        return feats

    def rows(self, image_ids: Sequence[int] | np.ndarray) -> np.ndarray:
        """Row indices of ``image_ids`` into ``table()`` -> (B,) int32.

        For device-resident training: upload ``table()`` to HBM once, then
        feed batches as row indices (a few KB) instead of feature rows
        (MBs) — the gather happens on device inside the jitted step.
        """
        return np.fromiter((self._index[int(i)] for i in image_ids),
                           np.int32, count=len(image_ids))

    def _parts(self) -> list[np.ndarray]:
        """The arrays that hold the rows, in row order: the loaded rows,
        then the appended ones.  Writable, and the store's own: only for
        reading."""
        parts = [self._mmap] if self._mmap_count else []
        if self._n_added:
            parts.append(self._added[:self._n_added])
        return parts

    def table(self) -> np.ndarray:
        """The full (N, dim) float32 feature table, rows as in ``rows()``,
        read-only: a view of the appended rows, or the loaded rows
        themselves; a store holding both concatenates them (one copy,
        counted in ``table_copies``)."""
        parts = self._parts()
        if len(parts) == 2:
            self.table_copies += 1
            return _read_only(np.concatenate(parts, axis=0))
        return _read_only(parts[0] if parts else self._added[:0])

    def missing(self, image_ids: Iterable[int]) -> list[int]:
        """Ids not yet in the store (resumable extraction, lrcn.jl:203)."""
        return [i for i in dict.fromkeys(int(x) for x in image_ids)
                if i not in self._index]


def device_table(store: FeatureStore, device, dtype: torch.dtype, *,
                 normalize: bool = False) -> torch.Tensor:
    """``store.table()`` on ``device`` in ``dtype``, L1-normalized first
    on the host (in float32) with ``normalize``.

    The float32 rows are copied from the store's own arrays (a store
    holding loaded and appended rows is not concatenated) to ``device``
    and cast there.  On a card they go through two pinned blocks of
    ``STAGE_BYTES``: torch's threaded copy fills one while the one before
    is on its way (the caching host allocator hands the blocks out again
    in later calls).  A card's cast rounds to nearest even as the host's
    does: the same table bit for bit.
    """
    parts = [l1_normalize(store.table())] if normalize else store._parts()
    device = torch.device(device)
    card = device.type == "cuda"
    table = torch.empty((len(store), store.dim), dtype=torch.float32,
                        device=device)
    step = max(1, STAGE_BYTES // (4 * store.dim))
    blocks, row = [], 0
    for part in parts:
        src = torch.from_numpy(part)
        blocks += [(row + s, src[s:s + step])
                   for s in range(0, len(part), step)]
        row += len(part)
    stages: list[torch.Tensor] = []
    copied: list[torch.cuda.Event] = []
    for i, (row, block) in enumerate(blocks):
        rows = table[row:row + len(block)]
        if not card:
            rows.copy_(block)
            continue
        j = i % 2
        if len(stages) <= j:
            stages.append(torch.empty((min(step, len(table)), store.dim),
                                      pin_memory=True))
            copied.append(torch.cuda.Event())
        else:
            copied[j].synchronize()   # the block's last copy has left it
        stage = stages[j][:len(block)]
        stage.copy_(block)
        rows.copy_(stage, non_blocking=True)
        copied[j].record(torch.cuda.current_stream(device))
    return table.to(dtype)
