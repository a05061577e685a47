"""Device mesh construction and placement helpers.

Port of ``sonata_tpu/parallel/mesh.py``.  The JAX package is one program
that drives every chip (``shard_map`` and XLA's SPMD partitioner); the port
keeps that process model: a :class:`Mesh` is a ``(data, seq, model)`` grid
of ``torch.device`` entries in ONE process, and the sharded stages place
their own work on it:

- ``data``  — sentence batches split by rows across the grid's data groups
  (:func:`map_rows`);
- ``seq``   — sequence parallelism: ring attention in the text encoder
  and halo-exchange convolutions in the flow and the decoder
  (:mod:`.ring`, :mod:`..models.seq_parallel`).  The shards of one data
  group run in lockstep, one persistent worker thread (a *lane*) per
  position of the axis (:meth:`Mesh.spmd`), and every collective is a
  tensor copy to the neighbour's device;
- ``model`` — tensor parallelism of the HiFi-GAN decoder's channels
  (:func:`param_shardings`; the collectives are placed by hand in
  :func:`..models.vits.decode_tensor_parallel`).

A mesh is built over the visible CUDA devices by default.  A device list
that repeats an entry, or that holds ``"cpu"``, runs the same schedule on
fewer physical devices; it is only ever built from an explicit
``devices=`` argument.  Parameters are copied once per distinct device
(:meth:`Mesh.put`).

Multi-host: :func:`initialize_distributed` wraps
``torch.distributed.init_process_group``; with one process it does nothing.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device

log = logging.getLogger("sonata.parallel")

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)

#: how long a lane waits for its peers at a collective before the call
#: fails (a peer that raised breaks the wait at once)
COLLECTIVE_TIMEOUT_S = 600.0


@dataclass(frozen=True)
class Placement:
    """Where one tensor lives on a mesh.

    ``spec`` is the reference's ``PartitionSpec`` as a tuple, written in
    the reference's layouts (a convolution ``[K, C_in, C_out]``): ``()``
    replicated, ``(None, None, "model")`` output channels split,
    ``(None, "model", None)`` input channels split, ``("model",)`` a
    split bias, ``("data",)`` rows.  ``dim`` is the dimension of the
    port's tensor that the axis splits (None when replicated)."""

    spec: tuple = ()
    dim: Optional[int] = None


REPLICATED = Placement()


class _Lane:
    """One persistent worker thread: a position of a mesh axis.  Work
    runs in submission order; the thread's cuDNN plans persist between
    calls, as a serving thread's do."""

    def __init__(self, name: str):
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        threading.Thread(target=self._run, name=name, daemon=True).start()

    def submit(self, fn: Callable) -> Future:
        fut: Future = Future()
        self._q.put((fut, fn))
        return fut

    def _run(self) -> None:
        while True:
            fut, fn = self._q.get()
            try:
                fut.set_result(fn())
            except BaseException as e:  # delivered to the caller
                fut.set_exception(e)
                if not isinstance(e, Exception):
                    raise


class _Axis:
    """The collective state of one SPMD call over ``size`` lanes: a board
    each lane posts to, read by its peers after everyone posted."""

    def __init__(self, size: int):
        self.size = size
        self._board: list = [None] * size
        self._barrier = threading.Barrier(size, timeout=COLLECTIVE_TIMEOUT_S)

    def exchange(self, index: int, value) -> list:
        """Post ``value`` as lane ``index``; every lane's posts."""
        self._board[index] = value
        self._barrier.wait()
        out = list(self._board)
        self._barrier.wait()  # nobody posts again before all have read
        return out

    def abort(self) -> None:
        self._barrier.abort()


_context = threading.local()


def axis_context(axis_name: str):
    """``(axis state, this lane's index)`` inside :meth:`Mesh.spmd` over
    ``axis_name``; raises outside one, as a JAX collective does outside
    ``shard_map``."""
    axes = getattr(_context, "axes", None) or {}
    if axis_name not in axes:
        raise RuntimeError(
            f"collective over axis {axis_name!r} outside an SPMD region "
            "(run it through Mesh.spmd)")
    return axes[axis_name]


def device_scope(device: torch.device):
    """The per-thread torch state of work on ``device``: inference mode
    and, on the card, ``device`` as the current one (both are
    thread-local, so every worker thread enters it around its work)."""
    scope = contextlib.ExitStack()
    scope.enter_context(torch.inference_mode())
    if device.type == "cuda":
        scope.enter_context(torch.cuda.device(device))
    return scope


class _State:
    """What the sub-meshes of one mesh share: placed parameter copies,
    weight slices and the lanes."""

    def __init__(self):
        self.lock = threading.Lock()
        self.spmd_lock = threading.Lock()
        self.placed: dict = {}
        #: id of a placed copy → its original (copies are held in placed)
        self.origin: dict = {}
        self.lanes: dict = {}


class Mesh:
    """A ``(data, seq, model)`` grid of devices.

    ``shape`` is the dict ``jax.sharding.Mesh.shape`` gives, ``devices``
    the grid (a numpy object array of ``torch.device``)."""

    def __init__(self, devices, axis_names: Sequence[str] = AXES, *,
                 _state: Optional[_State] = None):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-d device grid for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self._state = _state or _State()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        """The first device: where a voice on this mesh keeps its
        unsharded tensors."""
        return self.devices.flat[0]

    def distinct_devices(self) -> list:
        out: list = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def data_group(self, index: int) -> "Mesh":
        """The ``(1, seq, model)`` sub-mesh of data row ``index``."""
        return Mesh(self.devices[index:index + 1], self.axis_names,
                    _state=self._state)

    def axis_devices(self, axis_name: str) -> list:
        """The devices along ``axis_name``, at index 0 of the others."""
        ax = self.axis_names.index(axis_name)
        index = [0] * self.devices.ndim
        index[ax] = slice(None)
        return list(self.devices[tuple(index)])

    # -- placement ----------------------------------------------------------

    def put(self, obj: torch.nn.Module,
            device: Optional[torch.device] = None) -> torch.nn.Module:
        """Parameter module ``obj`` on ``device`` (default: :attr:`lead`):
        ``obj`` itself when it is there already, else one copy per device,
        made at first use and kept.  The submodules are registered with
        their copies, so a subtree of a placed tree is never copied
        again."""
        device = self.lead if device is None else device
        st = self._state
        with st.lock:
            obj = st.origin.get(id(obj), obj)  # a copy stands for its origin
            if _device_of(obj) == device:
                return obj
            hit = st.placed.get((id(obj), device))
            if hit is not None:
                return hit[1]
            new = copy.deepcopy(obj).to(device)
            for a, b in zip(obj.modules(), new.modules()):
                st.placed[(id(a), device)] = (a, b)
                st.origin[id(b)] = a
            return new

    def shard(self, tensor: torch.Tensor, dim: int, index: int, parts: int,
              device: torch.device) -> torch.Tensor:
        """Slice ``index`` of ``parts`` of ``tensor`` along ``dim``, on
        ``device``, made once and kept."""
        key = ("shard", id(tensor), dim, index, parts, device)
        st = self._state
        with st.lock:
            hit = st.placed.get(key)
            if hit is not None:
                return hit[1]
            size = tensor.shape[dim] // parts
            piece = tensor.narrow(dim, index * size, size).to(device)
            piece = piece.contiguous()
            st.placed[key] = (tensor, piece)
            return piece

    # -- SPMD over one axis ---------------------------------------------------

    def spmd(self, axis_name: str, fn: Callable, shard_args: list) -> list:
        """Run ``fn(*shard_args[j])`` once per position ``j`` of
        ``axis_name`` (on :meth:`axis_devices`), all in lockstep: each
        position is a lane of its own, inside whose call the collectives
        of :mod:`.ring` over ``axis_name`` reach the other positions.
        Returns the results in position order; a lane's exception is
        raised here (its peers' waits break at once)."""
        devices = self.axis_devices(axis_name)
        n = len(devices)
        axis = _Axis(n)
        if n == 1:
            return [_in_lane(axis_name, axis, 0, devices[0], fn,
                             shard_args[0])]
        st = self._state
        with st.spmd_lock:  # one submission order on every lane
            futures = []
            for j in range(n):
                lane = st.lanes.get(j)
                if lane is None:
                    lane = st.lanes[j] = _Lane(f"sonata_mesh_lane_{j}")
                futures.append(lane.submit(
                    lambda j=j: _in_lane(axis_name, axis, j, devices[j], fn,
                                         shard_args[j])))
        results, errors = [], []
        for fut in futures:  # every future is read
            try:
                results.append(fut.result())
            except Exception as e:
                errors.append(e)
        if errors:  # the failing lane's error, not its peers' broken waits
            raise next((e for e in errors
                        if not isinstance(e, threading.BrokenBarrierError)),
                       errors[0])
        return results


def _device_of(obj: torch.nn.Module) -> Optional[torch.device]:
    for t in obj.parameters():
        return t.device
    for t in obj.buffers():
        return t.device
    return None


def _in_lane(axis_name, axis: _Axis, index: int, device, fn, args):
    axes = getattr(_context, "axes", None)
    _context.axes = {**(axes or {}), axis_name: (axis, index)}
    try:
        with device_scope(device):
            return fn(*args)
    except BaseException:
        axis.abort()  # the peers' waits at a collective break at once
        raise
    finally:
        _context.axes = axes


def map_rows(mesh: Mesh, fn: Callable, *args):
    """Run ``fn(sub, *rows)`` once per data group of ``mesh`` and stack
    the results by rows.

    The batch ``B`` is the first tensor argument's leading size; every
    tensor argument with ``B`` leading rows is split into equal row
    blocks (``B`` must divide by the data axis), other tensors are passed
    whole; both land on the group's :attr:`Mesh.lead` device.  ``sub`` is
    the group's ``(1, seq, model)`` sub-mesh.  ``fn`` returns a tensor or a
    tuple of tensors (or None); the blocks return to the device of the
    first tensor argument, concatenated along dim 0."""
    first = next(a for a in args if isinstance(a, torch.Tensor))
    home, batch = first.device, first.shape[0]
    d = mesh.shape[DATA_AXIS]
    if batch % d:
        raise ValueError(f"batch of {batch} rows does not split over a "
                         f"data axis of {d}")
    rows = batch // d
    outs = []
    for i in range(d):
        sub = mesh.data_group(i)
        dev = sub.lead
        with device_scope(dev):
            part = [_rows(a, i, rows, batch, dev) for a in args]
            outs.append(fn(sub, *part))
    if d == 1:
        return _to(outs[0], home)
    if isinstance(outs[0], tuple):
        return tuple(
            None if col[0] is None else torch.cat([_to(c, home) for c in col])
            for col in zip(*outs))
    return torch.cat([_to(o, home) for o in outs])


def _rows(a, i: int, rows: int, batch: int, dev):
    if not isinstance(a, torch.Tensor):
        return a
    if a.dim() and a.shape[0] == batch:
        a = a[i * rows:(i + 1) * rows]
    return a.to(dev, non_blocking=True)


def _to(out, device):
    if out is None:
        return None
    if isinstance(out, tuple):
        return tuple(_to(o, device) for o in out)
    return out.to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# construction and the reference's placement helpers
# ---------------------------------------------------------------------------

def _visible_devices() -> list:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, *,
              seq_parallel: int = 1,
              model_parallel: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ``(data, seq, model)`` mesh over ``n_devices`` devices.

    ``devices`` defaults to the visible CUDA devices; ``seq_parallel`` and
    ``model_parallel`` split them between batch, sequence and tensor
    parallelism (both default to 1: a pure data mesh).  Raises
    ``ValueError`` when fewer than ``n_devices`` are available or the
    counts do not divide, as the reference does."""
    devs = ([resolve_device(d) for d in devices] if devices is not None
            else _visible_devices())
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devs)} devices are available")
        devs = devs[:n_devices]
    n = len(devs)
    if not n:
        raise ValueError("no devices for a mesh (no CUDA device is visible; "
                         "pass devices= explicitly)")
    inner = seq_parallel * model_parallel
    if inner < 1 or n % inner != 0:
        raise ValueError(
            f"{n} devices not divisible by seq_parallel={seq_parallel} "
            f"* model_parallel={model_parallel}")
    grid = np.empty((n // inner, seq_parallel, model_parallel), dtype=object)
    for i, d in enumerate(devs):
        grid.flat[i] = d
    return Mesh(grid, AXES)


def data_sharding(mesh: Mesh) -> Placement:
    """Batch-axis placement for [B, ...] tensors."""
    del mesh
    return Placement((DATA_AXIS,), 0)


def replicated(mesh: Mesh) -> Placement:
    del mesh
    return REPLICATED


def conv_placement(path: tuple, conv, tp: int) -> dict:
    """The placements of one convolution's ``w`` and ``b`` (the
    reference's rule; ``path`` is its key path in the parameter tree).

    The decoder follows the Megatron column/row pairing: ``conv_pre``,
    ``ups``, ``cond`` and each resblock's ``convs1`` split their output
    channels (column), each resblock's ``convs2`` splits its input
    channels (row; its bias adds after the partial-sum reduce, so it stays
    replicated), ``conv_post`` and everything outside the decoder are
    replicated.  A channel count the axis does not divide stays
    replicated."""
    from ..models.weights import QConv

    rep = {"w": REPLICATED, "b": REPLICATED}
    if (tp <= 1 or "dec" not in path or "conv_post" in path
            or isinstance(conv, QConv)):
        return rep
    w = conv.weight
    # torch layouts: Conv1d [C_out, C_in, K], ConvTranspose1d [C_in, C_out, K]
    out_dim = 1 if "ups" in path else 0
    if "convs2" in path:
        if w.shape[1] % tp == 0:
            return {"w": Placement((None, MODEL_AXIS, None), 1),
                    "b": REPLICATED}
        return rep
    out = {"w": REPLICATED, "b": REPLICATED}
    if w.shape[out_dim] % tp == 0:
        out["w"] = Placement((None, None, MODEL_AXIS), out_dim)
    if conv.bias is not None and conv.bias.shape[0] % tp == 0:
        out["b"] = Placement((MODEL_AXIS,), 0)
    return out


def param_shardings(mesh: Mesh, params) -> dict:
    """Per-leaf placements for a voice's parameters (a
    :class:`~..models.weights.VitsModel`), as a tree with the reference's
    keys (``{"w", "b"}`` per convolution): the tensor-parallel decoder,
    everything else replicated.  With ``model_parallel == 1`` every leaf
    is replicated."""
    from ..models.weights import Conv, QConv

    tp = mesh.shape.get(MODEL_AXIS, 1)

    def walk(module, path):
        if isinstance(module, (Conv, QConv)):
            pl = conv_placement(path, module, tp)
            leaves = (("w_q", "w_scale") if isinstance(module, QConv)
                      else ("w",))
            node = {k: pl["w"] if k == "w" else REPLICATED for k in leaves}
            if module.bias is not None:
                node["b"] = pl["b"]
            return node
        if isinstance(module, torch.nn.ModuleList):
            return [walk(m, path + (str(i),)) for i, m in enumerate(module)]
        node = {k: REPLICATED for k, _ in module.named_parameters(
            recurse=False)}
        for key, child in module.named_children():
            node[key] = walk(child, path + (key,))
        return node

    return walk(params, ())


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Join a multi-process run (no-op when single-process).

    ``coordinator_address`` is ``host:port`` of rank 0; the backend is
    NCCL on the card and gloo on the CPU.  Failures are logged and
    skipped, as the reference skips them."""
    if not num_processes or num_processes <= 1:
        log.debug("distributed init skipped: one process")
        return
    import torch.distributed as dist

    try:
        dist.init_process_group(
            backend="nccl" if torch.cuda.is_available() else "gloo",
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id or 0)
        log.info("distributed runtime: process %d/%d", dist.get_rank(),
                 dist.get_world_size())
    except (RuntimeError, ValueError) as e:
        log.debug("distributed init skipped: %s", e)
