"""The sharded board and its halo exchange, with the roll engine on a mesh.

Counterpart of ``distributed_gol_tpu/parallel/halo.py``.  The JAX package
is single-controller SPMD: one process, a ``Mesh``, ``shard_map`` and
``lax.ppermute`` halos.  The port is one process as well:

- A :class:`ShardedBoard` holds one tensor per shard of a ``(ny, nx)``
  mesh, shard ``(iy, ix)`` on ``mesh.devices[iy][ix]`` — the counterpart
  of a global array under ``NamedSharding(mesh, P("y", "x"))``.
- A halo exchange is a tensor copy from the neighbour shard's boundary
  rows or columns into a fresh extended block (``dst.copy_(src)``): a
  peer copy between two cards, a copy on the device within one.  The
  shift is the cyclic permutation :func:`_shift_perm`, so a 1-sized axis
  copies a shard's own edge, which IS the torus wrap.
- Rows are exchanged first; the columns are then taken from the
  neighbours' row-extended blocks, so the four corner blocks arrive with
  them and no diagonal copy is needed.
- The alive count is the sum of the per-shard counts (:func:`psum`,
  :meth:`ShardedBoard.reduce`); :class:`WholeBoard` gives a one-device
  board the same methods.
- A row mesh may span processes (``mesh.span``, ``parallel/multihost.py``):
  a board then holds this process's strips alone.  Every row exchange
  looks its neighbours' edges up in one place, :func:`neighbour_edges`,
  which takes the two edges at the band's ends from the neighbouring
  ranks; sums, gathers and windows combine the ranks' parts the same way
  (``RankSpan``).  A mesh in one process takes none of these collectives.

Nothing here writes a shard it has read: every generation or launch
builds fresh extended blocks and fresh output shards, so shards that share
one device and one stream (a virtual mesh) always exchange halos of the
same generation.  :func:`edge_rows` is the exchange without extended
blocks, for the adaptive strip kernels: their launches write buffers of
two launches ago, never the strips the exchange handed out.

The roll forms (:func:`sharded_step`, :func:`sharded_superstep`,
:func:`sharded_steps_with_counts`) advance a {0,255} uint8 board one
generation per exchange, bit-identical to ``ops/stencil.py`` on any mesh.
"""

from __future__ import annotations

import torch

from distributed_gol_torch.ops import stencil
from distributed_gol_torch.parallel.mesh import AXES, Mesh

#: Rows over mesh axis "y", columns over "x" (``P("y", "x")``).
BOARD_SPEC = AXES


class ShardedBoard:
    """A board split over a mesh: ``shards[iy][ix]`` is the block of rows
    ``iy * h_loc ...`` and columns ``ix * w_loc ...``, on
    ``mesh.devices[iy][ix]``."""

    __slots__ = ("mesh", "shards")

    def __init__(self, mesh: Mesh, shards):
        self.mesh = mesh
        self.shards = tuple(tuple(row) for row in shards)

    @property
    def shard_shape(self) -> tuple[int, int]:
        return tuple(self.shards[0][0].shape)

    @property
    def shape(self) -> tuple[int, int]:
        """The whole board's shape (on a process-spanning mesh, every
        rank's strips)."""
        h, w = self.shard_shape
        return h * self.mesh.shape["y"], w * len(self.shards[0])

    @property
    def flat(self) -> list[torch.Tensor]:
        """The shards in row-major order (``mesh.flat``'s order)."""
        return [t for row in self.shards for t in row]

    def map(self, fn) -> "ShardedBoard":
        """``fn`` applied to every shard, on its own device."""
        return ShardedBoard(self.mesh, [[fn(t) for t in row] for row in self.shards])

    def gather(self, device=None) -> torch.Tensor:
        """The whole board as one tensor on ``device`` (default: the first
        shard's device); on a process-spanning mesh every rank gets it
        (an allgather)."""
        device = self.shards[0][0].device if device is None else torch.device(device)
        rows = [torch.cat([t.to(device) for t in row], dim=1) for row in self.shards]
        band = torch.cat(rows, dim=0)
        return band if self.mesh.span is None else self.mesh.span.gather(band)

    def reduce(self, fn) -> torch.Tensor:
        """The sum over the shards of ``fn(shard, y0, x0)``, each computed on
        its own device with the shard's offset in the whole board, on the
        first shard's device (``lax.psum`` of a per-shard reduction; on a
        process-spanning mesh, over every rank's shards)."""
        h, w = self.shard_shape
        y0 = self.mesh.y0
        return psum((fn(t, (y0 + iy) * h, ix * w)
                     for iy, row in enumerate(self.shards) for ix, t in enumerate(row)),
                    self.mesh.span)

    def equal(self, other: "ShardedBoard") -> torch.Tensor:
        """Unsynced 0-d bool: ``other`` (on the same mesh) holds the same
        board (on a process-spanning mesh, on every rank)."""
        dev = self.shards[0][0].device
        same = torch.stack([torch.all(a == b).to(dev)
                            for a, b in zip(self.flat, other.flat)]).all()
        if self.mesh.span is None:
            return same
        return self.mesh.span.sum((~same).to(torch.int32)) == 0

    def rows(self, start: int, n: int) -> torch.Tensor:
        """Rows ``start .. start + n - 1`` of the whole board, taken modulo
        its height, as one (n, W) tensor on the first shard's device.  Only
        the shards that hold them are read, and only those rows are
        copied."""
        return self.window(start, 0, n, self.shape[1])

    def window(self, y0: int, x0: int, vh: int, vw: int) -> torch.Tensor:
        """The toroidal (vh, vw) window of the whole board anchored at
        (y0, x0) (``ops.stencil.viewport``), as one tensor on the first
        shard's device.  A window crossing shard seams or the torus seam
        is put together from the pieces of the shards it covers: only
        those shards are read, and only the window's cells are copied."""
        h, w = self.shard_shape
        height, width = self.shape
        dev = self.shards[0][0].device

        def piece(iy, r, nr):
            return torch.cat([self.shards[iy][ix][r : r + nr, c : c + nc].to(dev)
                              for ix, c, nc in _spans(x0, vw, w, width)], dim=1)

        span = self.mesh.span
        if span is None:
            return torch.cat([piece(iy, r, nr) for iy, r, nr in _spans(y0, vh, h, height)],
                             dim=0)
        # Each rank writes the window's rows it holds into zeros; every
        # row is some one rank's, so the sum over ranks is the window.
        out = torch.zeros((vh, vw), dtype=self.shards[0][0].dtype, device=dev)
        at = 0
        for iy, r, nr in _spans(y0, vh, h, height):
            if 0 <= iy - self.mesh.y0 < len(self.shards):
                out[at : at + nr] = piece(iy - self.mesh.y0, r, nr)
            at += nr
        return span.sum(out)

    def pool(self, fy: int, fx: int) -> torch.Tensor:
        """``ops.stencil.frame_pool`` of the whole board by (fy, fx), on
        the first shard's device, without gathering the board.  Each
        shard max-pools the windows it holds whole, and reduces the
        partial windows at its edges (those a shard seam cuts) to one
        row or column each; the partials of one window from neighbouring
        shards then meet in the output under a max.  Cells are never
        negative, so that equals the zero padding ``frame_pool`` puts past
        the board's bottom and right edges.  Not on a process-spanning
        mesh: multi-host runs are headless."""
        if self.mesh.span is not None:
            raise NotImplementedError("multi-host runs are headless: no pooled frames")
        h, w = self.shard_shape
        height, width = self.shape
        dev = self.shards[0][0].device
        out = torch.zeros((-(-height // fy), -(-width // fx)),
                          dtype=self.shards[0][0].dtype, device=dev)
        for iy, row in enumerate(self.shards):
            for ix, t in enumerate(row):
                part = _segment_max(_segment_max(t, iy * h, fy, 0), ix * w, fx, 1).to(dev)
                r0, c0 = iy * h // fy, ix * w // fx
                block = out[r0 : r0 + part.shape[0], c0 : c0 + part.shape[1]]
                block.copy_(torch.maximum(block, part))
        return out


def _spans(start: int, n: int, size: int, total: int):
    """The pieces of the cyclic range ``start .. start + n - 1`` (modulo
    ``total``) over blocks of ``size``: ``(block, offset, length)``."""
    y = start % total
    while n > 0:
        i, r = divmod(y, size)
        k = min(n, size - r)
        yield i, r, k
        n, y = n - k, (y + k) % total


def _segment_max(t: torch.Tensor, offset: int, f: int, dim: int) -> torch.Tensor:
    """The max over ``dim`` of each window of ``f`` that a tensor starting
    at ``offset`` of the whole board meets, in order: a partial window at
    the start (when ``offset`` is not a multiple of ``f``), the whole
    windows, and a partial window at the end."""
    n = t.shape[dim]
    head = min(-offset % f, n)
    whole = (n - head) // f
    tail = n - head - whole * f
    parts = []
    if head:
        parts.append(t.narrow(dim, 0, head).amax(dim=dim, keepdim=True))
    if whole:
        body = t.narrow(dim, head, whole * f)
        shape = list(body.shape)
        shape[dim : dim + 1] = [whole, f]
        parts.append(body.reshape(shape).amax(dim=dim + 1))
    if tail:
        parts.append(t.narrow(dim, n - tail, tail).amax(dim=dim, keepdim=True))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


class WholeBoard:
    """A board on one device, behind :class:`ShardedBoard`'s ``gather``,
    ``reduce``, ``equal``, ``rows``, ``window`` and ``pool``, so that code
    serving both kinds of board (``engine/backend.py``) never tests which
    it holds."""

    __slots__ = ("tensor",)

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor

    def gather(self, device=None) -> torch.Tensor:
        return self.tensor if device is None else self.tensor.to(device)

    def reduce(self, fn) -> torch.Tensor:
        return fn(self.tensor, 0, 0)

    def equal(self, other: torch.Tensor) -> torch.Tensor:
        return torch.all(self.tensor == other)

    def rows(self, start: int, n: int) -> torch.Tensor:
        idx = torch.arange(start, start + n, device=self.tensor.device)
        return self.tensor[torch.remainder(idx, self.tensor.shape[0])]

    def window(self, y0: int, x0: int, vh: int, vw: int) -> torch.Tensor:
        return stencil.viewport(self.tensor, y0, x0, vh, vw)

    def pool(self, fy: int, fx: int) -> torch.Tensor:
        return stencil.frame_pool(self.tensor, fy, fx)


def as_board(board):
    """``board`` as a :class:`ShardedBoard` or :class:`WholeBoard`: a
    tensor wrapped, either of those as it is."""
    return board if isinstance(board, (ShardedBoard, WholeBoard)) else WholeBoard(board)


class BoardSharding:
    """How a board lies on ``mesh``: rows split over "y", columns over "x"
    (``NamedSharding(mesh, BOARD_SPEC)``)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def shard(self, board: torch.Tensor) -> ShardedBoard:
        """Split a whole board into its mesh shards, each moved to its
        device (on a process-spanning mesh, this rank's band of them)."""
        ny, nx = self.mesh.shape["y"], self.mesh.shape["x"]
        h, w = board.shape
        if h % ny or w % nx:
            raise ValueError(f"mesh {(ny, nx)} does not divide a {h}x{w} board")
        hl, wl = h // ny, w // nx
        return ShardedBoard(self.mesh, [
            [board[iy * hl : (iy + 1) * hl, ix * wl : (ix + 1) * wl].contiguous().to(dev)
             for ix, dev in enumerate(row)]
            for iy, row in enumerate(self.mesh.devices, start=self.mesh.y0)
        ])


def board_sharding(mesh: Mesh) -> BoardSharding:
    return BoardSharding(mesh)


def _shift_perm(axis_size: int, forward: bool) -> list[tuple[int, int]]:
    """Cyclic shift permutation as (source, destination) pairs; a self-send
    when axis_size == 1 (= torus wrap)."""
    if forward:
        return [(i, (i + 1) % axis_size) for i in range(axis_size)]
    return [(i, (i - 1) % axis_size) for i in range(axis_size)]


def psum(values, span=None) -> torch.Tensor:
    """The sum of per-shard values (0-d or 1-d tensors, possibly on
    several devices), on the first one's device — ``lax.psum``; with a
    ``span`` (``mesh.RankSpan``), summed over the ranks too."""
    values = list(values)
    dev = values[0].device
    total = values[0]
    for v in values[1:]:
        total = total + v.to(dev)
    return total if span is None else span.sum(total)


def neighbour_edges(items: list, last, first, span=None) -> list:
    """The one lookup of a neighbour's edge on a row mesh: for each of
    ``items`` (one per strip, top to bottom: the strips, their skip flags
    or their row intervals), ``(last(its north neighbour), first(its south
    neighbour))``, each on the neighbour's device (a self-send when there
    is one strip: the torus wrap).  On a process-spanning mesh (``span``)
    the first item's north neighbour and the last one's south neighbour
    are the neighbouring ranks' last and first items, whose edges cross
    by ``span.exchange``."""
    n = len(items)
    if span is None:
        return [(last(items[(i - 1) % n]), first(items[(i + 1) % n])) for i in range(n)]
    top, bottom = span.exchange(last(items[-1]), first(items[0]))
    return list(zip([top] + [last(t) for t in items[:-1]],
                    [first(t) for t in items[1:]] + [bottom]))


def extend(board: ShardedBoard, pad: int, xpad: int) -> list[list[torch.Tensor]]:
    """Every (h, w) shard -> a fresh (h + 2·pad, w + 2·xpad) block on its
    device, with ``pad`` boundary rows and ``xpad`` boundary columns from
    its torus neighbours.  The rows come first; the columns are copied
    from the neighbours' row-extended blocks, so the corners ride along.
    ``xpad == 0`` extends rows only (a row mesh's strips)."""
    ny, nx = len(board.shards), len(board.shards[0])
    h, w = board.shard_shape
    if not (1 <= pad <= h and 0 <= xpad <= w):
        raise ValueError(f"halo ({pad} rows, {xpad} columns) does not fit a {h}x{w} shard")
    src = board.shards
    ext = [[torch.empty((h + 2 * pad, w + 2 * xpad), dtype=t.dtype, device=t.device)
            for t in row] for row in src]
    cols = slice(xpad, xpad + w)
    for iy in range(ny):
        for ix in range(nx):
            ext[iy][ix][pad : pad + h, cols].copy_(src[iy][ix])
    # My last rows are my south neighbour's north halo, and my first rows
    # my north neighbour's south halo.
    for ix in range(nx):
        edges = neighbour_edges([row[ix] for row in src], lambda t: t[-pad:],
                                lambda t: t[:pad], board.mesh.span)
        for iy, (north, south) in enumerate(edges):
            ext[iy][ix][:pad, cols].copy_(north)
            ext[iy][ix][pad + h :, cols].copy_(south)
    if xpad:
        for s, d in _shift_perm(nx, forward=True):
            for iy in range(ny):
                ext[iy][d][:, :xpad].copy_(ext[iy][s][:, w : w + xpad])
        for s, d in _shift_perm(nx, forward=False):
            for iy in range(ny):
                ext[iy][d][:, xpad + w :].copy_(ext[iy][s][:, xpad : 2 * xpad])
    return ext


def edge_rows(strips: list[torch.Tensor], n: int,
              span=None) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The row exchange of a row mesh without the extended blocks: for
    each strip (top to bottom), ``(north, south)`` — its north
    neighbour's last ``n`` rows and its south neighbour's first ``n``,
    on its own device (:func:`neighbour_edges`; ``span`` for a
    process-spanning mesh).  A neighbour on the same device gives a view,
    on another a copy; the strips' kernels read them and write other
    buffers."""
    h = strips[0].shape[0]
    if not 1 <= n <= h:
        raise ValueError(f"an exchange of {n} rows does not fit a strip of {h}")
    edges = neighbour_edges(strips, lambda t: t[-n:], lambda t: t[:n], span)
    return [(north.to(t.device), south.to(t.device)) for t, (north, south) in zip(strips, edges)]


def _exchange_and_extend(board: ShardedBoard) -> list[list[torch.Tensor]]:
    """Every (h, w) shard -> its (h+2, w+2) block with the halo ring from
    its torus neighbours."""
    return extend(board, 1, 1)


def _local_step(ext: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """One generation of a shard from its (h+2, w+2) extended block, no
    wrap arithmetic: the separable 3x3 window sum over the block."""
    a = ext & 1
    rows = a[:-2, :] + a[1:-1, :] + a[2:, :]  # (h, w+2)
    counts = rows[:, :-2] + rows[:, 1:-1] + rows[:, 2:] - a[1:-1, 1:-1]
    return stencil.apply_rule(a[1:-1, 1:-1], counts, table.to(ext.device))


def _step(board: ShardedBoard, table: torch.Tensor) -> ShardedBoard:
    ext = _exchange_and_extend(board)
    return ShardedBoard(board.mesh, [[_local_step(e, table) for e in row] for row in ext])


def _local_count(board: ShardedBoard) -> torch.Tensor:
    return psum((torch.sum(t & 1, dtype=torch.int32) for t in board.flat), board.mesh.span)


def sharded_step(mesh: Mesh):
    """One-generation step over ``mesh``: (board, table) -> board."""

    def step(board: ShardedBoard, table: torch.Tensor) -> ShardedBoard:
        return _step(board, table)

    return step


def sharded_superstep(mesh: Mesh):
    """(board, table, turns) -> board, one halo exchange per generation."""

    def run(board: ShardedBoard, table: torch.Tensor, turns: int) -> ShardedBoard:
        for _ in range(turns):
            board = _step(board, table)
        return board

    return run


def sharded_steps_with_counts(mesh: Mesh):
    """(board, table, turns) -> (board, int32[turns] global counts), each
    count the sum of the shards' counts after that generation."""

    def run(board: ShardedBoard, table: torch.Tensor, turns: int):
        counts = []
        for _ in range(turns):
            board = _step(board, table)
            counts.append(_local_count(board))
        if not counts:
            return board, torch.zeros(0, dtype=torch.int32, device=board.shards[0][0].device)
        return board, torch.stack(counts)

    return run
