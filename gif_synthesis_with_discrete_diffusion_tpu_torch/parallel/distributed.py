"""Process groups and the collectives of data- and tensor-parallel runs.

The counterpart of ``gif_synthesis_with_discrete_diffusion_tpu/parallel/
distributed.py``. Where the JAX package runs one program over a mesh of
devices and lets ``jit`` insert its collectives, the port runs one process
per device (a rank), as the reference's Lightning DDP does, and calls the
few collectives the model needs itself, from here:

* :func:`initialize_distributed` forms the group: explicit arguments first,
  then the environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``), else nothing happens
  and the process runs alone. NCCL for CUDA (device ``cuda:LOCAL_RANK``),
  gloo for the CPU; ``backend="gloo"`` also serves CUDA tensors, which is
  how two ranks share one card (NCCL refuses two ranks on one device).
  gloo takes CUDA tensors for every collective used here (all-reduce,
  broadcast, all-gather, barrier), so none is staged through the host.
* :func:`set_grid` lays the ranks out on a ``(data, model)`` grid as
  ``mesh_utils.create_device_mesh((data, model))`` lays out JAX's devices,
  ``model`` the fast axis: rank r sits at ``(r // model, r % model)``. It
  forms the **data group** (the ranks of one model index: the replicas of
  one shard) and the **model group** (the ranks of one data index: the
  shards of one replica); :func:`data_group` and :func:`model_group` name
  them, and without a grid the data group is every rank and the model
  group this rank alone;
* :func:`all_reduce_sum`, :func:`all_gather_rows`, :func:`all_gather`,
  :func:`broadcast_`, :func:`broadcast_object`, :func:`barrier`, each over
  the ``group`` it is given (default: every rank); :func:`all_reduce_sum_grad`
  is the all-reduce autograd sees (its backward all-reduces the gradient),
  which BatchNorm's global statistics need;
* Megatron's three autograd pairs over a model group:
  :func:`copy_to_group` (identity forward, all-reduce backward),
  :func:`reduce_from_group` (all-reduce forward, identity backward) and
  :func:`gather_from_group` (all-gather along a dimension forward, this
  rank's slice backward);
* :func:`average_gradients`: one flat all-reduce of a model's gradients
  over a group after the backward, divided by its size.

Without a group every function here is the identity and
:func:`is_distributed` is False, so a run on one device takes no collective;
a collective over a group of one rank is the identity too. A group that
fails to form raises.
"""
from __future__ import annotations

import os
from typing import Any, Iterable

import torch

__all__ = ["initialize_distributed", "is_distributed", "is_main_process",
           "rank", "world_size", "local_rank", "set_grid", "grid",
           "data_group", "model_group", "group_size", "group_rank",
           "all_reduce_sum", "all_reduce_sum_grad", "all_gather_rows",
           "all_gather", "copy_to_group", "reduce_from_group",
           "gather_from_group", "broadcast_", "broadcast_object", "barrier",
           "average_gradients", "destroy_distributed", "run_ranks"]

_LOCAL_RANK = 0
# (data, model, data group, model group) once set_grid has run
_GRID: tuple | None = None
# a group of this rank alone: every collective over it is the identity
_SELF = "self"


def initialize_distributed(device_type: str = "cuda",
                           backend: str | None = None,
                           init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           local_rank: int | None = None) -> bool:
    """Join a process group; True when one is formed (or was already).

    ``init_method`` (say ``tcp://localhost:29500``) with ``world_size`` and
    ``rank`` forms the group named; without them the environment of
    ``torchrun`` does (``init_method="env://"``); without that either the
    process runs alone and this returns False. ``backend`` defaults to NCCL
    for ``device_type="cuda"`` and gloo for the CPU; on CUDA the rank's
    device ``cuda:local_rank`` (default: ``LOCAL_RANK``, else the rank)
    becomes the current device."""
    global _LOCAL_RANK
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None:
        if "RANK" not in env or "WORLD_SIZE" not in env:
            return False
        init_method = "env://"
        rank = int(env["RANK"]) if rank is None else rank
        world_size = (int(env["WORLD_SIZE"]) if world_size is None
                      else world_size)
        if local_rank is None and "LOCAL_RANK" in env:
            local_rank = int(env["LOCAL_RANK"])
    if rank is None or world_size is None:
        raise ValueError("initialize_distributed: init_method needs "
                         "world_size and rank")
    _LOCAL_RANK = rank if local_rank is None else local_rank
    if device_type == "cuda":
        torch.cuda.set_device(_LOCAL_RANK)
    elif device_type != "cpu":
        raise ValueError(f"initialize_distributed: device_type "
                         f"{device_type!r} is 'cuda' or 'cpu'")
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", _LOCAL_RANK)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    return True


def destroy_distributed() -> None:
    """Leave the group, if there is one."""
    global _GRID
    import torch.distributed as dist
    _GRID = None
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def is_distributed() -> bool:
    """True inside an initialised process group (of any size)."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if is_distributed() else 1


def local_rank() -> int:
    """The index of this rank's CUDA device."""
    return _LOCAL_RANK if is_distributed() else 0


def is_main_process() -> bool:
    """True on rank 0 of an initialised process group, and without one."""
    return rank() == 0


def set_grid(data: int, model: int) -> None:
    """Lay this process group's ranks out on a ``(data, model)`` grid and
    form its data and model groups (module docstring). Every rank calls it
    with the same sizes, whose product must be the group's size; without a
    group only ``(1, 1)`` is taken."""
    global _GRID
    data, model = int(data), int(model)
    n = world_size()
    if data < 1 or model < 1 or data * model != n:
        raise ValueError(f"a ({data}, {model}) grid needs {data * model} "
                         f"ranks; there are {n}")
    if _GRID is not None and _GRID[:2] == (data, model):
        return
    if not is_distributed():
        _GRID = (1, 1, None, _SELF)
        return
    import torch.distributed as dist

    def form(groups):
        # every rank forms every group, in the same order (new_group's rule)
        mine = None
        for ranks in groups:
            if len(ranks) == 1:
                g = _SELF
            elif len(ranks) == n:
                g = None
            else:
                g = dist.new_group(ranks)
            if rank() in ranks:
                mine = g
        return mine
    dgroup = form([list(range(m, n, model)) for m in range(model)])
    mgroup = form([list(range(d * model, (d + 1) * model))
                   for d in range(data)])
    _GRID = (data, model, dgroup, mgroup)


def grid() -> tuple[int, int]:
    """``(data, model)``: the grid :func:`set_grid` formed, else every rank
    along ``data``."""
    return (_GRID[0], _GRID[1]) if _GRID is not None else (world_size(), 1)


def data_group():
    """The ranks that hold this rank's shard of the weights: every rank
    without a grid."""
    return _GRID[2] if _GRID is not None else None


def model_group():
    """The ranks that share this rank's rows of the batch: this rank alone
    without a grid."""
    return _GRID[3] if _GRID is not None else _SELF


def group_size(group=None) -> int:
    if group is _SELF or not is_distributed():
        return 1
    import torch.distributed as dist
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    """This rank's place in ``group``."""
    if group is _SELF or not is_distributed():
        return 0
    import torch.distributed as dist
    return dist.get_rank(group)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` (a new tensor; ``t``
    unchanged)."""
    if group_size(group) == 1:
        return t
    import torch.distributed as dist
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, grad):
        # d(sum over ranks)/d(this rank's t): every rank's upstream gradient
        return all_reduce_sum(grad, ctx.group), None


def all_reduce_sum_grad(t: torch.Tensor, group=None) -> torch.Tensor:
    """:func:`all_reduce_sum` under autograd: the gradient of a loss that
    reads the global sum flows back to every rank's share."""
    return _AllReduceSum.apply(t, group) if group_size(group) > 1 else t


def all_gather(t: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` (the same shape on each) concatenated
    along ``dim`` in rank order."""
    n = group_size(group)
    if n == 1:
        return t
    import torch.distributed as dist
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along the
    first axis in rank order: rank r's rows at ``[r*n, (r+1)*n)``."""
    return all_gather(t, 0, group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, t.shape[dim]
        return all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, grad):
        r = group_rank(ctx.group)
        return grad.narrow(ctx.dim, r * ctx.n, ctx.n), None, None


def copy_to_group(t: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel layer: ``t`` as it is, whose gradient
    is summed over ``group`` (each shard gives its columns' share)."""
    return _CopyTo.apply(t, group) if group_size(group) > 1 else t


def reduce_from_group(t: torch.Tensor, group) -> torch.Tensor:
    """The output of a row-parallel layer: the partial products summed over
    ``group``; the gradient reaches every shard as it is."""
    return _ReduceFrom.apply(t, group) if group_size(group) > 1 else t


def gather_from_group(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The output of a column-parallel layer gathered along ``dim`` in rank
    order; the backward takes this rank's slice of the gradient."""
    return (_GatherFrom.apply(t, dim, group) if group_size(group) > 1
            else t)


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Overwrite ``t`` in place with global rank ``src``'s (a rank of
    ``group``)."""
    if group_size(group) > 1:
        import torch.distributed as dist
        if t.is_contiguous():
            dist.broadcast(t, src, group=group)
        else:
            tmp = t.contiguous()
            dist.broadcast(tmp, src, group=group)
            t.copy_(tmp)
    return t


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if not is_distributed():
        return obj
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def barrier() -> None:
    if is_distributed():
        import torch.distributed as dist
        dist.barrier()


def average_gradients(params: Iterable[torch.nn.Parameter],
                      group=None) -> None:
    """Replace each gradient by its mean over the ranks of ``group``: one
    all-reduce of the gradients flattened into one buffer. A parameter
    without a gradient keeps none: every rank must have gradients for the
    same parameters, which the step's graph fixes (it depends on the config,
    not the data). Under tensor parallelism the group is the data group,
    whose ranks hold the same shard of each parameter."""
    n = group_size(group)
    if n == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    from torch._utils import (_flatten_dense_tensors,
                              _unflatten_dense_tensors)
    flat = all_reduce_sum(_flatten_dense_tensors(grads), group)
    flat /= n
    for g, avg in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(avg)


def run_ranks(fn, n: int, device_type: str, *args,
              backend: str | None = None, one_device: bool = False) -> Any:
    """Run ``fn(*args)`` in ``n`` new processes, one per rank of a new
    process group (``torch.multiprocessing.spawn``, the analogue of the
    reference's ddp_spawn), and return rank 0's result. Rank r takes
    ``cuda:r`` on CUDA (``one_device``: all take ``cuda:0``, which needs
    ``backend="gloo"``); on the CPU each takes its share of the cores. A
    rank that raises ends the others and raises here."""
    import pickle
    import socket
    import tempfile

    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pkl")
        mp.spawn(_rank_entry, args=(n, device_type, backend, one_device, port,
                                    out, fn, args), nprocs=n, join=True)
        with open(out, "rb") as f:
            return pickle.load(f)


def _rank_entry(r: int, n: int, device_type: str, backend: str | None,
                one_device: bool, port: int, out: str, fn, args) -> None:
    import pickle
    if device_type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    initialize_distributed(device_type, backend,
                           init_method=f"tcp://localhost:{port}",
                           world_size=n, rank=r,
                           local_rank=0 if one_device else r)
    try:
        result = fn(*args)
        if r == 0:
            with open(out, "wb") as f:
                pickle.dump(result, f)
    finally:
        destroy_distributed()
