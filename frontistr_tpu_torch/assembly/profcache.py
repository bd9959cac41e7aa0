"""On-disk cache for symbolic assembly profiles (torch port of
``frontistr_tpu/assembly/profcache.py``).

The ELL and cluster-ELL profile builds are host numpy (a unique and
an argsort over every element pair) and dwarf the solve they feed at a
million dofs.  A run is a fresh process, so the profiles persist to
disk keyed by a full hash of the connectivity, the node count and ndof.

Layout: one uncompressed ``.npz`` per entry in
``$FRONTISTR_TPU_CACHE_DIR`` (default ``~/.cache/frontistr_tpu_torch``;
``0`` or empty turns the cache off).  The key carries the tag
``torch-<kind>``, so an entry of the JAX package is never read here.
Writes are atomic (a temporary name, then ``os.replace``) so concurrent
runs never observe torn files; a corrupt entry is rebuilt and
overwritten.  The ranks of a sharded run (``parallel/dist.py``) build a
profile under ``rank_zero_first``: rank 0 builds and saves it, the
others wait at a barrier and load it.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np

from frontistr_tpu_torch.parallel import dist

_VERSION = 1      # bump to invalidate all entries on layout change


def cache_dir() -> Optional[str]:
    d = os.environ.get("FRONTISTR_TPU_CACHE_DIR",
                       os.path.expanduser("~/.cache/frontistr_tpu_torch"))
    if not d or d == "0":
        return None
    return d


def conn_key(conns: Sequence[np.ndarray], n_node: int, ndof: int,
             tag: str = "") -> str:
    """Full-content hash of the connectivity (the in-memory key samples
    rows; a persistent cache must not collide)."""
    h = hashlib.sha1()
    h.update(f"v{_VERSION}:{n_node}:{ndof}:{tag}".encode())
    for c in conns:
        h.update(np.int64(c.shape[0]).tobytes())
        h.update(np.int64(c.shape[1]).tobytes())
        h.update(np.ascontiguousarray(c, dtype=np.int64).tobytes())
    return h.hexdigest()


def load(key: str) -> Optional[Dict[str, np.ndarray]]:
    d = cache_dir()
    if d is None:
        return None
    path = os.path.join(d, key + ".npz")
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except Exception:
        return None            # corrupt entry: rebuild, overwrite


def save(key: str, arrays: Dict[str, np.ndarray]) -> None:
    d = cache_dir()
    if d is None:
        return
    try:
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
        os.close(fd)
        # uncompressed: profile arrays are int32 noise, zip deflate costs
        # more wall time than the disk it saves
        np.savez(tmp, **arrays)
        os.replace(tmp, os.path.join(d, key + ".npz"))
    except Exception:
        pass                   # cache is best-effort, never fail the run


@contextlib.contextmanager
def rank_zero_first():
    """Rank 0 of a sharded run runs the block first, the other ranks
    after it, behind a barrier: a profile is built and saved once, then
    loaded by the others.  Without the cache or a group, a no-op."""
    comm = dist.current()
    if comm is None or comm.size == 1 or cache_dir() is None:
        yield
        return
    if comm.rank != 0:
        comm.barrier()
    try:
        yield
    finally:
        if comm.rank == 0:
            comm.barrier()
