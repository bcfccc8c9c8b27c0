"""Process mesh and the collectives of a sharded run (torch.distributed).

Counterpart of ``nuradiomc_tpu/parallel/mesh.py``. The JAX package runs one
program over a ``jax.sharding.Mesh`` of devices; the port runs one process
per rank, and the ranks form an ``(event, channel)`` grid:

* ``event`` axis: data parallelism over event groups. ``Simulation`` deals
  whole chunks to the ranks of an event row (the physics MC's
  embarrassingly parallel axis; replaces the reference's file splitting);
* ``channel`` axis: the per-channel stages of ``simulate_batch`` (ray solve,
  spectra, attenuation, antenna mix, placement) run on the rank's slice of
  the channels, for very large arrays (phased arrays, LOFAR-scale
  stations); the OR, MIN and MAX over channels and the gathers of
  per-channel results are collectives over this axis.

Rank ``r`` sits at ``(r // n_channel, r % n_channel)``. The default backend
is NCCL with one rank per card. A caller that puts several ranks on one
card (NCCL refuses that) passes ``backend="gloo"`` itself; gloo's
collectives run on host memory, so the helpers below copy a CUDA tensor to
the host and back around each collective on such a mesh. Every process
group gets a timeout, so a rank that fails makes the others raise instead
of hang.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import warnings

import torch
import torch.distributed as dist

logger = logging.getLogger("nuradiomc_tpu_torch.parallel")

DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)
_timeout = DEFAULT_TIMEOUT


def init_distributed(backend: str = "nccl", init_method: str = "env://",
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                     rank: int | None = None, world_size: int | None = None):
    """Join the process group (``torch.distributed.init_process_group``)
    and return ``(rank, world_size)``.

    ``init_method`` is ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``), ``tcp://host:port`` or ``file://path``, with
    ``rank`` and ``world_size`` given where the environment does not. NCCL
    takes one rank per card: with more ranks on this host
    (``LOCAL_WORLD_SIZE``, else the world size) than cards it raises. A
    second call warns and returns the group that exists (the JAX
    function's ``jax.distributed.initialize`` wrapper likewise).
    """
    global _timeout
    if dist.is_initialized():
        warnings.warn("torch.distributed is already initialized; keeping its process group")
        return dist.get_rank(), dist.get_world_size()
    if backend == "nccl":
        n_world = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", 1))
        n_local = int(os.environ.get("LOCAL_WORLD_SIZE", n_world))
        n_cards = torch.cuda.device_count()
        if n_local > n_cards:
            raise ValueError(f"NCCL takes one rank per card: {n_local} ranks on this host, "
                             f"{n_cards} cards; pass backend='gloo' to share a card")
    kw = {} if rank is None else {"rank": rank}
    if world_size is not None:
        kw["world_size"] = world_size
    dist.init_process_group(backend, init_method=init_method, timeout=timeout, **kw)
    _timeout = timeout
    return dist.get_rank(), dist.get_world_size()


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the mesh as this rank sees it: its size, the rank's
    index on it and the process group of the ranks along it (``None``: the
    whole world)."""

    name: str
    size: int
    index: int
    group: object
    backend: str


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the ``(event, channel)`` grid and the device
    it runs on."""

    n_event: int
    n_channel: int
    rank: int
    device: torch.device
    event: Axis            # the ranks that share this rank's channel index
    channel: Axis          # the ranks that share this rank's event index
    world: Axis

    @property
    def shape(self) -> dict:
        return {"event": self.n_event, "channel": self.n_channel}


def make_mesh(n_event: int | None = None, n_channel: int = 1, device="cuda") -> Mesh:
    """The ``(event, channel)`` mesh over the ranks of the process group.

    If the requested shape does not match the world size, the mesh falls
    back to ``(n // c, c)`` with ``c = 2`` for an even world and 1 for an
    odd one, with a warning, since silently changing the requested
    parallelism can mask a misconfigured job (the JAX function's rule).
    ``device="cuda"`` puts the rank on card ``LOCAL_RANK % device_count``
    (``LOCAL_RANK`` defaults to the rank); ``"cpu"`` on the host. Every
    rank must call it, in the same order as its other collectives.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed; call init_distributed first")
    n = dist.get_world_size()
    if n_event is None:
        n_event = n // n_channel
    if n_event * n_channel != n:
        requested = (n_event, n_channel)
        n_channel = 2 if (n % 2 == 0 and n >= 2) else 1
        n_event = n // n_channel
        warnings.warn(f"requested mesh {requested} does not match the {n} ranks; "
                      f"using ({n_event}, {n_channel}) instead")
    rank = dist.get_rank()
    e, c = divmod(rank, n_channel)
    backend = dist.get_backend()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda') but no CUDA device is available; "
                               "pass device='cpu' to run on the host")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("an NCCL process group needs device='cuda'")
    # every rank creates every group, in the same order
    ev_groups = [dist.new_group([i * n_channel + j for i in range(n_event)], timeout=_timeout)
                 for j in range(n_channel)]
    ch_groups = [dist.new_group([i * n_channel + j for j in range(n_channel)], timeout=_timeout)
                 for i in range(n_event)]
    return Mesh(n_event=n_event, n_channel=n_channel, rank=rank, device=dev,
                event=Axis("event", n_event, e, ev_groups[c], backend),
                channel=Axis("channel", n_channel, c, ch_groups[e], backend),
                world=Axis("world", n, rank, None, backend))


# ---- placement (counterparts of the JAX function's shardings) -------------

def pad_groups(n_groups: int, mesh: Mesh) -> int:
    """Smallest multiple of the event-axis size >= n_groups."""
    n_ev = mesh.n_event
    return ((n_groups + n_ev - 1) // n_ev) * n_ev


def shard_batch(batch, mesh: Mesh):
    """This rank's part of a batch whose leading (group) axis is split in
    equal contiguous parts over the event axis (pad with ``pad_groups``
    first); ``None`` fields stay ``None``."""
    n_ev, e = mesh.n_event, mesh.event.index

    def part(a):
        if a is None:
            return None
        if a.shape[0] % n_ev:
            raise ValueError(f"group axis {a.shape[0]} not divisible by event axis {n_ev}; "
                             "pad the batch first (mesh.pad_groups)")
        n = a.shape[0] // n_ev
        return a[e * n:(e + 1) * n]

    return type(batch)(*[part(a) for a in batch])


def channel_split(n_channels: int, axis: Axis | None) -> slice | None:
    """The rank's channels when ``n_channels`` divides over the channel
    axis, else None (the channel constants are replicated)."""
    if axis is None or axis.size == 1:
        return None
    if n_channels % axis.size:
        logger.info("channel count %d not divisible by channel axis %d; "
                    "replicating channel constants", n_channels, axis.size)
        return None
    n = n_channels // axis.size
    return slice(axis.index * n, (axis.index + 1) * n)


def shard_channels(ch, mesh: Mesh):
    """This rank's slice of the per-channel tensors (a ``ChannelParams``)
    when C divides over the channel axis, all of them otherwise."""
    sl = channel_split(ch.positions.shape[0], mesh.channel)
    return ch if sl is None else slice_channels(ch, sl)


def slice_channels(ch, sl: slice):
    """A ``ChannelParams`` with the channels ``sl`` of each per-channel
    tensor (the leading axis; the stacked grids of a tabulated antenna)."""
    def cut(a):
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return a[sl]
        # the tabulated antenna grids: only h_theta and h_phi are per channel
        return a._replace(h_theta=a.h_theta[sl], h_phi=a.h_phi[sl])

    return type(ch)(*[cut(a) for a in ch])


# ---- collectives -------------------------------------------------------------

def _wire(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The tensor as the backend takes it: gloo works on host memory."""
    return t.cpu() if axis.backend == "gloo" and t.device.type != "cpu" else t


def _reduce(t: torch.Tensor, op, axis: Axis | None) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return t
    wire = _wire(t, axis).clone()
    dist.all_reduce(wire, op=op, group=axis.group)
    return wire.to(t.device)


def all_reduce_min(t: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """Elementwise minimum over the ranks of ``axis`` (exact)."""
    return _reduce(t, dist.ReduceOp.MIN, axis)


def all_reduce_max(t: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """Elementwise maximum over the ranks of ``axis`` (exact)."""
    return _reduce(t, dist.ReduceOp.MAX, axis)


def all_reduce_or(t: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """Elementwise OR of a bool tensor over the ranks of ``axis``."""
    if axis is None or axis.size == 1:
        return t
    return _reduce(t.to(torch.uint8), dist.ReduceOp.MAX, axis).bool()


def all_gather(t: torch.Tensor, dim: int, axis: Axis | None) -> torch.Tensor:
    """The ranks' tensors of ``axis`` (equal shapes) concatenated along
    ``dim`` in axis order."""
    if axis is None or axis.size == 1:
        return t
    dim = dim % t.ndim
    wire = _wire(t, axis)
    if wire.dtype == torch.bool:
        wire = wire.to(torch.uint8)
    if wire.is_complex():
        wire = torch.view_as_real(wire)
    wire = wire.contiguous()
    parts = [torch.empty_like(wire) for _ in range(axis.size)]
    dist.all_gather(parts, wire, group=axis.group)
    out = torch.cat(parts, dim=dim)
    if t.is_complex():
        out = torch.view_as_complex(out.contiguous())
    return out.to(device=t.device, dtype=t.dtype)


def gather_objects(obj, axis: Axis | None) -> list:
    """Every rank's ``obj`` (picklable host data) along ``axis``, in axis
    order, on every rank of it."""
    if axis is None or axis.size == 1:
        return [obj]
    out = [None] * axis.size
    dist.all_gather_object(out, obj, group=axis.group)
    return out


def broadcast_object(obj, axis: Axis | None, src_index: int = 0):
    """The ``obj`` of the rank at ``src_index`` of ``axis``, on every rank
    of it."""
    if axis is None or axis.size == 1:
        return obj
    box = [obj]
    src = (src_index if axis.group is None
           else dist.get_global_rank(axis.group, src_index))
    dist.broadcast_object_list(box, src=src, group=axis.group)
    return box[0]
