"""Ranks of a multi-device run (torch port of
``frontistr_tpu/parallel/multihost.py`` and of ``requested_shards`` /
``device_mesh`` in ``frontistr_tpu/parallel/shard.py``).

The JAX package grows one GSPMD program over a device mesh; PyTorch has
no such partitioner, so the port takes the reference's own model: SPMD,
one process (a rank) per device, joined into a ``torch.distributed``
process group.  A rank owns one device, ``cuda:<local rank>``, or the
CPU when the caller asks for it.  The backend follows the device count
and is printed: NCCL when every rank has a card of its own, gloo when
the ranks run on the CPU or share a card (NCCL refuses two ranks on one
device; gloo's CUDA tensors are copied to the host and back here
explicitly).

How ranks come up:

- ``FRONTISTR_TPU_SHARDS=n`` (``auto``: the card count) on
  ``run_directory`` or ``python -m frontistr_tpu_torch`` spawns n ranks
  on this host (``spawn``), joined through a ``FileStore`` in the work
  directory: no TCP port is picked.  ``n = 1`` runs the sharded code
  with a group of one and spawns nothing.
- ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) or
  ``FRONTISTR_TPU_COORDINATOR=<host:port>``,
  ``FRONTISTR_TPU_NUM_PROCESSES`` and ``FRONTISTR_TPU_PROCESS_ID``
  (the JAX package's multi-host switches) join processes that were
  started elsewhere, over a TCP store (``maybe_init_distributed``);
  nothing is spawned then.

``Comm`` is what the sharded code sees of the group: ``all_gather_rows``,
``all_reduce_sum``, ``broadcast_object``, ``all_gather_object`` and
``barrier``, each a no-op in a group of one.  ``is_writer()`` is the
rank-0 guard of the run's output files.  ``RankPool`` keeps ranks up
across several tasks (the tests and ``chip_smoke.py`` start one pool a
file and run every deck there).  A rank that raises makes the others
wait in a collective: the parent kills them and re-raises.  A hung
collective ends at ``COLLECTIVE_TIMEOUT`` with an error, and a rank that
dies is seen by its exit code; a task has no deadline of its own.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import socket
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as tdist


# how long a collective (and the join) waits for the other ranks
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


def requested_shards(device_type: str = "cuda") -> int:
    """The rank count FRONTISTR_TPU_SHARDS asks for (0: not sharded);
    ``auto`` is the card count on CUDA, 1 on the CPU."""
    v = os.environ.get("FRONTISTR_TPU_SHARDS", "")
    if not v or v == "0":
        return 0
    if v.lower() == "auto":
        return max(torch.cuda.device_count(), 1) \
            if device_type == "cuda" else 1
    return max(int(v), 0)


def choose_backend(device_type: str, ranks_on_host: int) -> str:
    """NCCL when every rank of this host has a card of its own, else
    gloo (the CPU, or several ranks on one card)."""
    if device_type == "cuda" and \
            torch.cuda.device_count() >= ranks_on_host:
        return "nccl"
    return "gloo"


def rank_device(device_type: str, local_rank: int) -> torch.device:
    if device_type == "cuda":
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return torch.device("cpu")


@dataclasses.dataclass
class Comm:
    """One rank's view of its group."""
    rank: int
    size: int
    device: torch.device
    backend: str                 # "nccl", "gloo" or "none" (one rank)

    @property
    def staged(self) -> bool:
        """gloo with CUDA tensors: the collectives run on host copies."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' equal-length chunks ``x``, concatenated in rank
        order."""
        if self.size == 1:
            return x
        t = x.detach().cpu() if self.staged else x.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        tdist.all_gather(parts, t)
        return torch.cat(parts).to(x.device)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks (a new tensor)."""
        if self.size == 1:
            return x
        t = x.detach().cpu().clone() if self.staged else x.clone()
        tdist.all_reduce(t)
        return t.to(x.device)

    def broadcast_object(self, obj: Any = None, src: int = 0) -> Any:
        if self.size == 1:
            return obj
        box = [obj]
        tdist.broadcast_object_list(box, src=src, device=self._obj_dev())
        return box[0]

    def all_gather_object(self, obj: Any) -> List[Any]:
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        tdist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        if self.size > 1:
            tdist.barrier()

    def _obj_dev(self):
        return self.device if self.backend == "nccl" else None


_COMM: Optional[Comm] = None


def current() -> Optional[Comm]:
    """The process's ``Comm``, None outside a sharded run."""
    return _COMM


def set_current(comm: Optional[Comm]) -> None:
    global _COMM
    _COMM = comm


def is_writer() -> bool:
    """True where the run's output files are written: rank 0, or a
    process outside a group."""
    return _COMM is None or _COMM.rank == 0


def single(device) -> Comm:
    """A group of one (FRONTISTR_TPU_SHARDS=1): no process group."""
    return Comm(0, 1, torch.device(device), "none")


def init_group(rank: int, size: int, device_type: str, store=None,
               init_method: Optional[str] = None,
               ranks_on_host: Optional[int] = None,
               local_rank: Optional[int] = None) -> Comm:
    """Join the process group (a store or an ``init_method`` URL) with
    the backend ``choose_backend`` gives; print it; make the ``Comm``
    current."""
    on_host = size if ranks_on_host is None else ranks_on_host
    lr = rank if local_rank is None else local_rank
    backend = choose_backend(device_type, on_host)
    dev = rank_device(device_type, lr)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, rank=rank, world_size=size,
              timeout=COLLECTIVE_TIMEOUT)
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method
    tdist.init_process_group(**kw)
    comm = Comm(rank, size, dev, backend)
    set_current(comm)
    print(f"### rank {rank}/{size}: backend {backend}, device {dev}",
          flush=True)
    return comm


def close_group() -> None:
    if tdist.is_initialized():
        tdist.destroy_process_group()
    set_current(None)


def host_layout(store, rank: int, size: int,
                host: Optional[str] = None) -> tuple:
    """This rank's local rank and the number of ranks on its host, from
    every rank's host name exchanged over the join's ``store``."""
    host = socket.gethostname() if host is None else host
    store.set(f"host/{rank}", host)
    names = [store.get(f"host/{r}").decode() for r in range(size)]
    local = [r for r, h in enumerate(names) if h == host]
    return local.index(rank), len(local)


def maybe_init_distributed(device_type: str = "cuda") -> Optional[Comm]:
    """Join processes started elsewhere, before any device use: under
    ``torchrun`` (``RANK``/``WORLD_SIZE`` and its store) or through
    FRONTISTR_TPU_COORDINATOR=<host:port>, FRONTISTR_TPU_NUM_PROCESSES
    and FRONTISTR_TPU_PROCESS_ID (a TCP store at the coordinator, over
    which the ranks first learn which of them share a host).
    Returns the current ``Comm`` (None when nothing asks for a group).
    A group already up is kept."""
    if _COMM is not None:
        return _COMM
    coord = os.environ.get("FRONTISTR_TPU_COORDINATOR")
    nproc = os.environ.get("FRONTISTR_TPU_NUM_PROCESSES")
    if coord and nproc and int(nproc) > 1:
        rank = int(os.environ.get("FRONTISTR_TPU_PROCESS_ID", "0"))
        size = int(nproc)
        addr, port = coord.rsplit(":", 1)
        store = tdist.TCPStore(addr, int(port), size, is_master=rank == 0,
                               timeout=COLLECTIVE_TIMEOUT)
        lr, on_host = host_layout(store, rank, size)
        return init_group(rank, size, device_type,
                          store=tdist.PrefixStore("group", store),
                          ranks_on_host=on_host, local_rank=lr)
    if "RANK" in os.environ and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        size = int(os.environ["WORLD_SIZE"])
        return init_group(int(os.environ["RANK"]), size, device_type,
                          init_method="env://",
                          ranks_on_host=int(os.environ.get(
                              "LOCAL_WORLD_SIZE", size)),
                          local_rank=int(os.environ.get("LOCAL_RANK", 0)))
    return None


# ---------------- spawned ranks ---------------------------------------------


def _dumps(obj) -> bytes:
    """Pickle with every device tensor moved to the host."""
    import io

    class _Host(pickle.Pickler):
        def reducer_override(self, o):
            if isinstance(o, torch.Tensor) and o.device.type != "cpu":
                return o.cpu().__reduce_ex__(pickle.HIGHEST_PROTOCOL)
            return NotImplemented

    buf = io.BytesIO()
    _Host(buf, pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def _exc(e: BaseException) -> Optional[bytes]:
    """The exception, pickled, when it pickles."""
    try:
        return pickle.dumps(e)
    except Exception:
        return None


def _rank_main(rank, size, store_path, device_type, inq, outq) -> None:
    """A spawned rank: join the group, then run the tasks of ``inq``
    (``(fn, args, kwargs)``, None ends) and put each result, pickled,
    on ``outq``."""
    torch.set_num_threads(1)
    try:
        store = tdist.FileStore(store_path, size)
        init_group(rank, size, device_type, store=store)
    except BaseException as e:
        outq.put(("err", rank, (traceback.format_exc(), _exc(e))))
        return
    while True:
        task = inq.get()
        if task is None:
            break
        fn, args, kw = task
        try:
            outq.put(("ok", rank, _dumps(fn(*args, **kw))))
        except BaseException as e:
            outq.put(("err", rank, (traceback.format_exc(), _exc(e))))
    close_group()


class RankPool:
    """``n`` spawned ranks on this host, joined through a ``FileStore``
    under ``store_dir``; ``run(fn, *args)`` runs ``fn`` on every rank
    and returns the ranks' results in rank order (``fn`` must be
    importable by name).  A rank's exception (a hung collective's
    included) or a rank that dies closes the pool (its processes
    killed) and raises."""

    def __init__(self, n: int, device_type: str = "cpu",
                 store_dir: Optional[str] = None):
        import tempfile
        ctx = torch.multiprocessing.get_context("spawn")
        self.n = n
        self.device_type = device_type
        self._own_dir = store_dir is None
        self.store_dir = tempfile.mkdtemp(prefix="fstr_ranks_") \
            if store_dir is None else store_dir
        store_path = os.path.join(self.store_dir,
                                  f".fstr_store.{os.getpid()}.{id(self)}")
        if os.path.exists(store_path):
            os.remove(store_path)
        self._store_path = store_path
        self._inq = [ctx.Queue() for _ in range(n)]
        self._outq = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, n, store_path, device_type,
                                         self._inq[r], self._outq),
                                   daemon=True) for r in range(n)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args, **kw) -> List[Any]:
        if self._procs is None:
            raise RuntimeError("the rank pool is closed")
        for q in self._inq:
            q.put((fn, args, kw))
        got: dict = {}
        while len(got) < self.n:
            try:
                kind, rank, payload = self._outq.get(timeout=5.0)
            except queue_mod.Empty:
                dead = [p.exitcode for p in self._procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    self.close(kill=True)
                    raise RuntimeError(f"{fn.__name__}: ranks exited with "
                                       f"{dead}")
                continue
            if kind == "err":
                # the rank's exception, its type kept, after the others
                # are stopped (they may wait in a collective)
                self.close(kill=True)
                tb, exc = payload
                cause = RuntimeError(f"{fn.__name__} failed on rank "
                                     f"{rank}:\n{tb}")
                if exc is not None:
                    raise pickle.loads(exc) from cause
                raise cause
            got[rank] = pickle.loads(payload)
        return [got[r] for r in range(self.n)]

    def close(self, kill: bool = False) -> None:
        if self._procs is None:
            return
        if not kill:
            for q in self._inq:
                q.put(None)
            for p in self._procs:
                p.join(timeout=30)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self._procs = None
        if os.path.exists(self._store_path):
            os.remove(self._store_path)
        if self._own_dir:
            import shutil
            shutil.rmtree(self.store_dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(kill=exc[0] is not None)


def spawn(fn: Callable, args: tuple, n: int, device_type: str,
          store_dir: str) -> Any:
    """Run ``fn(*args)`` on ``n`` fresh ranks (the FRONTISTR_TPU_SHARDS
    spawn) and return rank 0's result."""
    with RankPool(n, device_type, store_dir) as pool:
        return pool.run(fn, *args)[0]
