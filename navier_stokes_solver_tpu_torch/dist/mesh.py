"""Process meshes for the domain-decomposition and ensemble axes.

One process per tile, the analog of the reference's MPI ranks (and of the
JAX package's devices inside ``shard_map``).  A ``Mesh`` holds this
rank's place on the ``('y', 'x')`` tile grid (y-major, as the JAX package
stacks tiles) or on the ``('ens', 'x')`` grid of ``make_mesh``, its
neighbours, its device and the collectives the solver needs:

  * ``seam_sum``: the seam exchange with the neighbour tiles (the JAX
    package's ``lax.ppermute`` ring, Trilinos ``compress(add)``) -- one
    round of messages with the up to eight neighbours, added as the JAX
    package's x-exchange then y-exchange add, so that corner nodes (four
    tiles) come out right and every copy of a seam node is the same;
  * ``strip_seam_sum``: the table-driven seam exchange of the ``-M``
    simplex x-strips (``dist/simplex.py``) with the left and right
    neighbour strips;
  * ``all_reduce``: the sum over the tiles (``psum``, MPI allreduce), in
    rank order on every rank, so that every rank holds the same bits and
    takes the same branch;
  * ``all_gather``: every tile's tensor, in rank order.

Backends.  NCCL sends CUDA tensors; gloo sends host tensors only, so on
CUDA tensors under gloo (several ranks sharing one card, which NCCL
refuses) every slab and scalar is copied through the host explicitly.
The route follows the process group's backend.

``launch`` starts ``n`` ranks with ``torch.multiprocessing`` (``spawn``:
a forked child would inherit the parent's threads) and a ``FileStore`` in
a fresh temporary directory (no fixed port: several launches may run at
once).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.nn.functional as Fn

__all__ = ["Mesh", "make_mesh", "make_dd_mesh", "launch", "rank_device", "backend_for"]


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place on a process grid of ``n_ens x n_y x n_x`` ranks
    (rank = (ie * n_y + iy) * n_x + ix) and its collectives."""

    n_x: int
    n_y: int
    n_ens: int
    rank: int
    device: torch.device
    backend: str
    # the group of this rank's tiles (one ensemble slice), and of the
    # ranks that hold the same tile of every ensemble slice; None = the
    # default group
    group: Any = None
    ens_group: Any = None
    # collectives issued (seam exchanges, all_reduces, all_gathers) and
    # the bytes of the seam slabs this rank sent
    counts: dict = dataclasses.field(
        default_factory=lambda: dict(seam_exchanges=0, all_reduces=0, all_gathers=0, seam_bytes=0)
    )

    @property
    def n_tiles(self) -> int:
        return self.n_x * self.n_y

    @property
    def ix(self) -> int:
        return self.rank % self.n_x

    @property
    def iy(self) -> int:
        return (self.rank // self.n_x) % self.n_y

    @property
    def ie(self) -> int:
        return self.rank // self.n_tiles

    @property
    def host_route(self) -> bool:
        """True when collectives copy CUDA tensors through the host (gloo)."""
        return self.backend == "gloo" and self.device.type != "cpu"

    def _rank_of(self, iy: int, ix: int) -> int:
        return (self.ie * self.n_y + iy) * self.n_x + ix

    # ---- collectives -----------------------------------------------------
    def _out(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.cpu() if self.host_route else t

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        # from pinned memory, the copy to the card does not wait for the
        # card's queue (the caching host allocator keeps the buffer alive
        # until the copy has run)
        return t.pin_memory().to(self.device, non_blocking=True) if self.host_route else t

    def _tile_ranks(self) -> list[int]:
        base = self.ie * self.n_tiles
        return list(range(base, base + self.n_tiles))

    def _p2p(self, sends: list, recvs: list) -> None:
        """Post every send ``(tensor, rank)`` and receive ``(buffer, rank)``
        and wait for all: gloo's single sends (its lowest latency), NCCL's
        batched ones.  Every rank posts in the same program order, so the
        messages of a pair match in order."""
        if self.backend == "nccl":
            ops = [dist.P2POp(dist.isend, t, r) for t, r in sends]
            ops += [dist.P2POp(dist.irecv, t, r) for t, r in recvs]
            reqs = dist.batch_isend_irecv(ops)
        else:
            reqs = [dist.isend(t, r) for t, r in sends] + [dist.irecv(t, r) for t, r in recvs]
        for req in reqs:
            req.wait()

    def _neighbour(self, dy: int, dx: int) -> int | None:
        iy, ix = self.iy + dy, self.ix + dx
        if 0 <= iy < self.n_y and 0 <= ix < self.n_x:
            return self._rank_of(iy, ix)
        return None

    def seam_sum(self, y: torch.Tensor) -> torch.Tensor:
        """Complete the partial sums on the seam columns and rows of the
        lattice tensor ``y`` [..., NY, NX] with the neighbour tiles' copies,
        in one round: each tile sends its raw edge columns, edge rows and
        corners to the up to eight neighbours sharing them (through the
        host in one copy each way under gloo), then adds as the JAX
        package's two passes do -- the x-exchange (own + neighbour), then
        the y-exchange over x-complete rows -- so every copy of a seam
        node holds the same bits (a corner of four tiles is (a + b) +
        (c + d), its rows' pairs first)."""
        NY, NX = y.shape[-2:]
        parts = {  # (dy, dx) -> this tile's raw slab that neighbour shares
            (0, -1): y[..., :, :1], (0, 1): y[..., :, NX - 1:],
            (-1, 0): y[..., :1, :], (1, 0): y[..., NY - 1:, :],
            (-1, -1): y[..., :1, :1], (-1, 1): y[..., :1, NX - 1:],
            (1, -1): y[..., NY - 1:, :1], (1, 1): y[..., NY - 1:, NX - 1:],
        }
        nbs = {d: r for d in parts if (r := self._neighbour(*d)) is not None}
        if not nbs:
            return y
        keys = list(nbs)
        send = torch.cat([parts[d].reshape(-1) for d in keys])
        send = send.cpu() if self.host_route else send
        recv = torch.empty_like(send)
        sizes = [parts[d].numel() for d in keys]
        sends, recvs = [], []
        for d, s_, r_ in zip(keys, send.split(sizes), recv.split(sizes)):
            sends.append((s_, nbs[d]))
            recvs.append((r_, nbs[d]))
        self._p2p(sends, recvs)
        self.counts["seam_exchanges"] += 1
        self.counts["seam_bytes"] += send.numel() * send.element_size()
        recv = self._in(recv)
        got = {d: r_.reshape(parts[d].shape) for d, r_ in zip(keys, recv.split(sizes))}
        out = y.clone()
        # the x-pass: own columns plus the x-neighbours' raw columns
        if (0, -1) in got:
            out[..., :, :1] += got[(0, -1)]
        if (0, 1) in got:
            out[..., :, NX - 1:] += got[(0, 1)]
        # the y-pass: own x-complete rows plus the y-neighbours' rows made
        # x-complete with their own x-neighbours' corners (the diagonals)
        for dy, row in ((-1, slice(0, 1)), (1, slice(NY - 1, NY))):
            if (dy, 0) not in got:
                continue
            other = got[(dy, 0)].clone()
            if (dy, -1) in got:
                other[..., :, :1] += got[(dy, -1)]
            if (dy, 1) in got:
                other[..., :, NX - 1:] += got[(dy, 1)]
            out[..., row, :] += other
        return out

    def strip_seam_sum(self, v: torch.Tensor, seam) -> torch.Tensor:
        """Complete the partial sums of the strip vector ``v`` [..., n_loc]
        with the neighbour strips' copies of the shared nodes (``seam``, a
        ``unstructured.tri.SeamTables``): this strip sends ``v[..., send_r]``
        to its right neighbour and ``v[..., send_l]`` to its left one (the
        sentinel reads an appended zero), receives theirs, and adds as the
        JAX package's ring does, ``v + from_l[add_l] + from_r[add_r]``.  A
        strip end has no neighbour there: it adds a zero buffer, the bits
        of the JAX ring's all-sentinel wraparound buffer, and sends
        nothing.  Under gloo on a card the buffers go through the host in
        one copy each way."""
        left, right = self._neighbour(0, -1), self._neighbour(0, 1)
        lead, B = v.shape[:-1], seam.send_l.shape[0]
        from_l = from_r = None
        if left is not None or right is not None:
            pad = Fn.pad(v, (0, 1))
            keys = [k for k, r in (("l", left), ("r", right)) if r is not None]
            table = {"l": seam.send_l, "r": seam.send_r}
            send = torch.cat([pad[..., table[k]].reshape(-1) for k in keys])
            send = send.cpu() if self.host_route else send
            recv = torch.empty_like(send)
            nbs = {"l": left, "r": right}
            parts = list(zip(keys, send.chunk(len(keys)), recv.chunk(len(keys))))
            self._p2p([(s_, nbs[k]) for k, s_, _ in parts], [(r_, nbs[k]) for k, _, r_ in parts])
            self.counts["seam_exchanges"] += 1
            self.counts["seam_bytes"] += send.numel() * send.element_size()
            got = {k: r_.reshape(*lead, B) for k, r_ in zip(keys, self._in(recv).chunk(len(keys)))}
            # the left neighbour's buffer for its right neighbour, and back
            from_l, from_r = got.get("l"), got.get("r")
        zero = torch.zeros((*lead, B + 1), dtype=v.dtype, device=v.device)
        from_l = zero if from_l is None else Fn.pad(from_l, (0, 1))
        from_r = zero if from_r is None else Fn.pad(from_r, (0, 1))
        return v + from_l[..., seam.add_l] + from_r[..., seam.add_r]

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def _gather(self, t: torch.Tensor, group) -> list[torch.Tensor]:
        src = self._out(t)
        if group is self.group and self.backend != "nccl":
            # the tile group under gloo: one send to and one receive from
            # every other tile
            ranks = self._tile_ranks()
            out = [src if r == self.rank else torch.empty_like(src) for r in ranks]
            others = [(o, r) for o, r in zip(out, ranks) if r != self.rank]
            self._p2p([(src, r) for _, r in others], others)
            return out
        out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, src, group=group)
        return out

    def all_gather(self, t: torch.Tensor, group=None) -> list[torch.Tensor]:
        """Every rank's ``t`` (the same shape on all) in the group
        (default: this rank's tiles), in rank order, on this rank's
        device."""
        self.counts["all_gathers"] += 1
        return [self._in(o) for o in self._gather(t, self.group if group is None else group)]

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over this rank's tiles, added in rank order on
        every rank (the same bits everywhere)."""
        self.counts["all_reduces"] += 1
        parts = self._gather(t, self.group)
        s = parts[0]
        for p in parts[1:]:
            s = s + p
        return self._in(s)


def rank_device(rank: int, devices=None, default="cuda") -> torch.device:
    """The device of ``rank``: ``devices[rank]`` from an explicit list,
    else ``default`` -- with "cuda" (no index) meaning ``cuda:{LOCAL_RANK}``
    (the rank itself when ``LOCAL_RANK`` is unset)."""
    if devices is not None:
        return torch.device(devices[rank])
    d = torch.device(default)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return d


def backend_for(device) -> str:
    """The process group's backend for ``device``, one device for every
    rank (``cuda`` meaning ``cuda:{LOCAL_RANK}``) or a list of one per
    rank: gloo on the CPU and where ranks share a card (NCCL refuses two
    ranks on one card), else NCCL."""
    devs = [torch.device(d) for d in device] if isinstance(device, (list, tuple)) else [torch.device(device)]
    if any(d.type == "cpu" for d in devs) or len(set(devs)) < len(devs):
        return "gloo"
    return "nccl"


def _check_group(n: int, what: str) -> tuple[int, str]:
    if not dist.is_initialized():
        raise RuntimeError(
            f"{what} needs a process group: start the ranks with "
            "navier_stokes_solver_tpu_torch.dist.launch (or torchrun)"
        )
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"{what} needs {n} ranks, the process group has {world}")
    return dist.get_rank(), dist.get_backend()


def _check_devices(backend: str, device: torch.device, n: int):
    """NCCL refuses two ranks on one card: ask for gloo there."""
    if backend != "nccl" or device.type != "cuda":
        return
    idx = torch.tensor([device.index if device.index is not None else torch.cuda.current_device()],
                       device=device)
    out = [torch.empty_like(idx) for _ in range(n)]
    dist.all_gather(out, idx)
    if len({int(o) for o in out}) < n:
        raise ValueError("NCCL cannot run two ranks on one card: use the gloo backend")


def make_dd_mesh(n_x: int, n_y: int = 1, devices=None, *, default="cuda") -> Mesh:
    """The ``('y', 'x')`` tile mesh of ``n_x x n_y`` ranks over the default
    process group (which must hold exactly that many).  ``devices``: an
    explicit device per rank (ranks may share a card under gloo), else
    ``rank_device``'s ``cuda:{LOCAL_RANK}`` (or ``default``)."""
    rank, backend = _check_group(n_x * n_y, f"a {n_x} x {n_y} tile mesh")
    device = rank_device(rank, devices, default)
    _check_devices(backend, device, n_x * n_y)
    return Mesh(n_x=n_x, n_y=n_y, n_ens=1, rank=rank, device=device, backend=backend)


def make_mesh(n_x: int = 1, n_ens: int = 1, devices=None, *, default="cuda") -> Mesh:
    """The ``('ens', 'x')`` mesh of ``n_ens x n_x`` ranks: ``x`` decomposes
    the channel, ``ens`` shards an ensemble's members
    (``ensemble.run_sweep(mesh=...)``)."""
    rank, backend = _check_group(n_x * n_ens, f"an {n_ens} x {n_x} ('ens', 'x') mesh")
    device = rank_device(rank, devices, default)
    _check_devices(backend, device, n_x * n_ens)
    group = ens_group = None
    if n_ens > 1:
        # every rank creates every group, in the same order
        for e in range(n_ens):
            g = dist.new_group([e * n_x + i for i in range(n_x)])
            if rank // n_x == e:
                group = g
        for i in range(n_x):
            g = dist.new_group([e * n_x + i for e in range(n_ens)])
            if rank % n_x == i:
                ens_group = g
    return Mesh(n_x=n_x, n_y=1, n_ens=n_ens, rank=rank, device=device, backend=backend,
                group=group, ens_group=ens_group)


# ---------------------------------------------------------------------------
# launch
# ---------------------------------------------------------------------------


def _wait_asleep() -> None:
    """Make this process wait for its card asleep, not spinning
    (``cudaDeviceScheduleBlockingSync``, set before the card is first
    used): ranks that share one card under gloo mostly wait for it, and a
    spinning wait holds a host core the other ranks and processes need.
    Nothing to set where PyTorch has no CUDA runtime."""
    import ctypes

    try:
        cudart = ctypes.CDLL("libcudart.so.12")  # the runtime torch has loaded
    except OSError:
        return
    cudart.cudaSetDeviceFlags(4)


def _rank_main(rank: int, fn: Callable, n: int, backend: str, root: str, args: tuple):
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(n)
    # the ranks share the host's cores
    torch.set_num_threads(max(1, torch.get_num_threads() // n))
    if backend == "gloo":
        _wait_asleep()
    store = dist.FileStore(os.path.join(root, "store"), n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n)
    try:
        out = fn(rank, *args)
        with open(os.path.join(root, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n: int, *args, backend: str = "gloo") -> list:
    """Run ``fn(rank, *args)`` on ``n`` spawned ranks of a fresh
    process group (``backend``, a ``FileStore`` in a new temporary
    directory); returns every rank's (picklable) result, in rank order.
    ``fn`` must be importable by name (a module-level function).  Raises
    when a rank fails."""
    import torch.multiprocessing as mp

    root = tempfile.mkdtemp(prefix="nstt_launch_")
    try:
        mp.spawn(_rank_main, args=(fn, n, backend, root, args), nprocs=n, join=True)
        out = []
        for r in range(n):
            with open(os.path.join(root, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)
