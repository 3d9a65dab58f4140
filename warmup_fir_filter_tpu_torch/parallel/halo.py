"""Overlap-save halo exchange: sequence-parallel FIR over a device mesh.

Counterpart of ``warmup_fir_filter_tpu/parallel/halo.py``.  A long stream
is sharded along time across the ranks of a mesh axis; each shard
exchanges ``L-1`` boundary samples with its neighbours and runs the same
fixed-point FIR as the unsharded path on its extended block, so shard
boundaries are bit-identical to the global zero-padded computation.

Halo asymmetry follows same-mode centre alignment (``center = L // 2``):
each shard needs ``L-1-center`` trailing samples from its left neighbour
and ``center`` leading ones from its right neighbour.  The exchange is a
ring of ``batch_isend_irecv`` on the axis's process group: rank i sends
its tail to i+1 and its head to i−1, and the end ranks keep zero edges,
which is the global zero pad (``ppermute``'s unmatched destinations in
JAX).  Halos travel in the samples' dtype, uint8 on the fixed paths.  A
halo wider than its shard raises ``ValueError``: only nearest neighbours
are reached.

The shard-local compute is a function of the extended block
(:func:`_fir1d_local`, :func:`_fir2d_local`): the same-mode FIR over the
block, cropped to the outputs whose windows lie inside it, through a filter
prepared once a call (``prepare_fixed_fir``: kernel A up to 257 taps, C up
to 4,096, B beyond; ``prepare_fixed_fir2d``: kernels E/F).  On a CUDA
block each kernel launches; on a CPU block it runs its plain version,
bit-exact to the int32 cores the JAX body runs.  The entries keep the JAX
split: post the exchange, compute the interior (outputs that need no
neighbour data), wait, then compute the boundary strips.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from warmup_fir_filter_tpu_torch.kernels.dispatch import (
    prepare_fixed_fir,
    prepare_fixed_fir2d,
)
from warmup_fir_filter_tpu_torch.ops.qformat import QFormat
from warmup_fir_filter_tpu_torch.parallel.mesh import (
    as_dtensor,
    axis_size,
    check_divisible,
    global_shape,
    local_block,
)


class PendingHalo:
    """A posted ring exchange: the receive buffers (zero where the ring
    ends) and the works; :meth:`wait` completes it.  Holds the send
    buffers until then."""

    def __init__(self, lo, hi, ops, works):
        self.lo, self.hi = lo, hi
        self._ops, self._works = ops, works

    def wait(self) -> None:
        for work in self._works:
            work.wait()
        self._ops = self._works = []


def check_halo(width: int, lo_width: int, hi_width: int,
               axis_name: str) -> None:
    """Raise unless both halos fit in a shard ``width`` samples wide."""
    if lo_width > width or hi_width > width:
        raise ValueError(
            f"halo widths ({lo_width}, {hi_width}) exceed the shard's "
            f"{width} samples along mesh axis {axis_name!r}; only nearest "
            "neighbours are reached: use fewer shards or a shorter filter")


def post_halo(x: torch.Tensor, dim: int, *, mesh: DeviceMesh, axis_name: str,
              lo_width: int, hi_width: int) -> PendingHalo:
    """Post the ring exchange of ``x``'s edges along ``dim`` over mesh axis
    ``axis_name``: ``lo`` receives the previous rank's last ``lo_width``
    slices, ``hi`` the next rank's first ``hi_width``.  Every rank of the
    axis must call it."""
    width = x.shape[dim]
    check_halo(width, lo_width, hi_width, axis_name)
    group = mesh.get_group(axis_name)
    index = mesh.get_local_rank(axis_name)
    last = axis_size(mesh, axis_name) - 1
    prev = dist.get_global_rank(group, index - 1) if index > 0 else None
    nxt = dist.get_global_rank(group, index + 1) if index < last else None
    ops, bufs = [], {}
    for name, w, send_start, send_to, recv_from in (
            ("lo", lo_width, width - lo_width, nxt, prev),
            ("hi", hi_width, 0, prev, nxt)):
        if not w:
            bufs[name] = None
            continue
        shape = list(x.shape)
        shape[dim] = w
        bufs[name] = buf = x.new_zeros(shape)
        if send_to is not None:
            ops.append(dist.P2POp(dist.isend,
                                  x.narrow(dim, send_start, w).contiguous(),
                                  send_to, group))
        if recv_from is not None:
            ops.append(dist.P2POp(dist.irecv, buf, recv_from, group))
    works = dist.batch_isend_irecv(ops) if ops else []
    return PendingHalo(bufs["lo"], bufs["hi"], ops, works)


def _attach(pending: PendingHalo, x: torch.Tensor, dim: int) -> torch.Tensor:
    parts = [p for p in (pending.lo, x, pending.hi) if p is not None]
    return torch.cat(parts, dim=dim) if len(parts) > 1 else x


def exchange_halo_1d(
    x_local: torch.Tensor,
    *,
    mesh: DeviceMesh,
    axis_name: str,
    left_width: int,
    right_width: int,
) -> torch.Tensor:
    """Attach neighbour halos along the last axis of a rank's block.

    Every rank of ``axis_name`` must call it.  Returns the block extended
    to ``N_local + left_width + right_width`` columns; halos from beyond
    the ends of the axis are zero (global zero-pad semantics).
    """
    dim = x_local.dim() - 1
    pending = post_halo(x_local, dim, mesh=mesh, axis_name=axis_name,
                        lo_width=left_width, hi_width=right_width)
    pending.wait()
    return _attach(pending, x_local, dim)


def _fir1d_local(x_ext: torch.Tensor, fir: nn.Module, left_w: int,
                 right_w: int) -> torch.Tensor:
    """The shard-local step: the same-mode fixed FIR over the extended
    uint8 rows ``x_ext``, columns ``[left_w, W - right_w)``.

    With the filter's halo widths this is the prehaloed core's output;
    with ``(0, 0)`` it is the block's own same-mode output, exact at the
    columns that need no neighbour.  ``fir`` is ``prepare_fixed_fir``'s
    module on the block's device: its kernel on CUDA, the kernel's plain
    version on the CPU.
    """
    y = fir(x_ext)
    return y[:, left_w : y.shape[1] - right_w]


def _fir1d_block(x_loc: torch.Tensor, fir: nn.Module, mesh: DeviceMesh,
                 time_axis: str, left_w: int, right_w: int) -> torch.Tensor:
    """A rank's fixed FIR outputs: exchange, interior, boundary strips."""
    t_loc = x_loc.shape[1]
    pending = post_halo(x_loc, 1, mesh=mesh, axis_name=time_axis,
                        lo_width=left_w, hi_width=right_w)
    if t_loc < fir.num_taps:
        # Shard too narrow for an interior: plain exchange+compute.
        pending.wait()
        return _fir1d_local(_attach(pending, x_loc, 1), fir, left_w, right_w)
    # The interior — outputs that need no neighbour data — while the
    # halos fly, then the two boundary strips from the received halos:
    # the same core on sub-windows, so bit-identical to exchange-then-
    # compute.
    y = _fir1d_local(x_loc, fir, 0, 0)
    pending.wait()
    span = left_w + right_w
    if left_w:
        y[:, :left_w] = _fir1d_local(
            torch.cat([pending.lo, x_loc[:, :span]], 1), fir, left_w, right_w)
    if right_w:
        y[:, t_loc - right_w:] = _fir1d_local(
            torch.cat([x_loc[:, t_loc - span:], pending.hi], 1), fir,
            left_w, right_w)
    return y


def _require_int32(qformat: QFormat) -> None:
    if not qformat.tpu_native:
        raise ValueError(
            f"acc_bits={qformat.acc_bits} > 32 is not representable in the "
            "int32 TPU sim path."
        )


def fir1d_fixed_sharded(
    x_u8,
    h,
    qformat: QFormat = QFormat(),
    *,
    mesh: DeviceMesh,
    channel_axis: str = "data",
    time_axis: str = "time",
) -> DTensor:
    """Bit-exact fixed-point FIR over (C, T), sharded C×T across a mesh.

    - channels (C) shard over ``channel_axis``: pure data parallelism;
    - time (T) shards over ``time_axis``: sequence parallelism with the
      halo ring.

    Requires C and T divisible by the respective mesh axis sizes (pad at
    the caller for ragged streams) and shards at least as wide as the
    halos.  Returns (C, T) uint8 placed ``(channel_axis, time_axis)``.
    """
    _require_int32(qformat)
    num_taps = int(np.asarray(h).size)
    center = num_taps // 2
    left_w, right_w = num_taps - 1 - center, center
    spec = (channel_axis, time_axis)
    check_divisible(global_shape(x_u8), spec, mesh)
    x_loc = local_block(x_u8, mesh, spec, torch.uint8)
    fir = prepare_fixed_fir(h, qformat, x_loc.device)
    y = _fir1d_block(x_loc, fir, mesh, time_axis, left_w, right_w)
    return as_dtensor(y, mesh, spec)


def exchange_halo_2d(
    x_local: torch.Tensor,
    *,
    mesh: DeviceMesh,
    row_axis: str,
    col_axis: str,
    top_width: int,
    bottom_width: int,
    left_width: int,
    right_width: int,
) -> torch.Tensor:
    """Attach neighbour halos on both image axes of a 2-D-sharded block.

    Two rings: rows first, then columns of the row-EXTENDED block, so the
    column phase also carries the four corner halos.  Halos from beyond
    the mesh are zero (global zero-pad semantics).
    """
    check_halo(x_local.shape[1], left_width, right_width, col_axis)
    pending = post_halo(x_local, 0, mesh=mesh, axis_name=row_axis,
                        lo_width=top_width, hi_width=bottom_width)
    pending.wait()
    return exchange_halo_1d(_attach(pending, x_local, 0), mesh=mesh,
                            axis_name=col_axis, left_width=left_width,
                            right_width=right_width)


def _margins_2d(taps_r: int, taps_c: int) -> tuple[int, int, int, int]:
    """(top, bottom, left, right) same-mode halo widths."""
    return taps_r - 1 - taps_r // 2, taps_r // 2, taps_c - 1 - taps_c // 2, \
        taps_c // 2


def _fir2d_local(x_ext: torch.Tensor, fir,
                 margins: tuple[int, int, int, int]) -> torch.Tensor:
    """The 2-D shard-local step: the same-mode fixed 2-D FIR over the
    extended uint8 block, cropped by ``margins`` (top, bottom, left,
    right).  ``fir`` is ``prepare_fixed_fir2d``'s function on the block's
    device: kernels E/F on CUDA, their plain versions on the CPU."""
    y = fir(x_ext)
    top, bottom, left, right = margins
    return y[top : y.shape[0] - bottom, left : y.shape[1] - right]


def fir2d_fixed_sharded(
    x_u8,
    h,
    qformat: QFormat = QFormat(),
    *,
    mesh: DeviceMesh,
    row_axis: str = "data",
    col_axis: str = "time",
) -> DTensor:
    """Bit-exact fixed 2-D FIR over an (H, W) image, sharded H×W.

    The 2-D extension of :func:`fir1d_fixed_sharded`: image rows shard
    over ``row_axis`` and columns over ``col_axis``; every shard exchanges
    its ``(Lr-1, Lc-1)`` same-mode-asymmetric halos (corners included)
    with its mesh neighbours, so shard boundaries are bit-identical to the
    global zero-padded golden contract.

    Requires H and W divisible by the respective mesh axis sizes and
    shards at least as large as the halos.  Returns (H, W) uint8 placed
    ``(row_axis, col_axis)``.
    """
    _require_int32(qformat)
    h = np.asarray(h)
    taps_r, taps_c = h.shape
    margins = top_w, bottom_w, left_w, right_w = _margins_2d(taps_r, taps_c)
    spec = (row_axis, col_axis)
    check_divisible(global_shape(x_u8), spec, mesh)
    x_loc = local_block(x_u8, mesh, spec, torch.uint8)
    h_loc, w_loc = x_loc.shape
    check_halo(w_loc, left_w, right_w, col_axis)
    fir = prepare_fixed_fir2d(h, qformat, x_loc.device)
    pending = post_halo(x_loc, 0, mesh=mesh, axis_name=row_axis,
                        lo_width=top_w, hi_width=bottom_w)
    split = h_loc >= taps_r and w_loc >= taps_c
    if split:
        # The fully-interior region while the row halos fly.
        y = _fir2d_local(x_loc, fir, (0, 0, 0, 0))
    pending.wait()
    x_ext = exchange_halo_1d(_attach(pending, x_loc, 0), mesh=mesh,
                             axis_name=col_axis, left_width=left_w,
                             right_width=right_w)
    if not split:
        # Shard too small for an interior: plain exchange+compute.
        return as_dtensor(_fir2d_local(x_ext, fir, margins), mesh,
                          spec)
    # The four boundary strips: top/bottom span all W output columns,
    # left/right cover the interior rows only.
    dr, dc = taps_r - 1, taps_c - 1
    rows = slice(top_w, top_w + h_loc)
    if top_w:
        y[:top_w] = _fir2d_local(x_ext[: top_w + dr], fir, margins)
    if bottom_w:
        y[h_loc - bottom_w:] = _fir2d_local(x_ext[top_w + h_loc - dr:], fir,
                                            margins)
    if left_w:
        y[top_w : h_loc - bottom_w, :left_w] = _fir2d_local(
            x_ext[rows, : left_w + dc], fir, margins)
    if right_w:
        y[top_w : h_loc - bottom_w, w_loc - right_w:] = _fir2d_local(
            x_ext[rows, left_w + w_loc - dc:], fir, margins)
    return as_dtensor(y, mesh, spec)
