"""The ``(data, model)`` layout: which rows of a global batch each rank
holds, and which slice of each weight.

The counterpart of ``gif_synthesis_with_discrete_diffusion_tpu/parallel/
mesh.py``. The JAX package places one program's arrays on a
``(data, model)`` device mesh; the port runs one process per device, so a
:class:`Mesh` here is the grid's size and this process's place on it
(:func:`..parallel.distributed.set_grid`: rank r at ``(r // model, r %
model)``, as ``mesh_utils.create_device_mesh`` lays devices out).

* :func:`shard_batch` takes data index i's rows ``[i*B/N, (i+1)*B/N)`` of
  a global batch of B rows, the order of JAX's ``data`` axis; the model
  ranks of one data index hold the same rows.
* :func:`shard_module_` is JAX's ``shard_state`` with
  :data:`DEFAULT_TP_RULES`: the first rule whose name occurs in a
  parameter's or buffer's name gives the dimension it is split along over
  ``model``; a dimension that does not divide by ``model`` is kept whole
  (JAX's fallback), as is every tensor no rule names. A sharded tensor
  keeps this rank's slice, and carries the dimension as ``tp_dim``, which
  the modules read to run their tensor-parallel forms
  (:mod:`..models.denoiser`, :mod:`..models.embeddings`,
  :mod:`..models.clip_text`, :mod:`..models.vqvae`) and the optimizer its
  moments' shapes from.
* :func:`full_state_dict` / :func:`load_full_state_dict_` and their
  optimizer twins move whole tensors in and out of a sharded module, so a
  checkpoint holds the same tensors on any mesh, as Orbax's global arrays;
  :func:`full_weights` lends a module its whole weights for a kernel that
  needs them (the whole-step sampling kernels).
* :func:`replicate` broadcasts rank 0's tensors; :func:`rank_generator`
  gives each data index its own stream.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Iterable, Iterator, Mapping

import numpy as np
import torch
from torch import nn

from .distributed import (all_gather, broadcast_, data_group, group_rank,
                          group_size, is_distributed, model_group, set_grid,
                          world_size)

__all__ = ["Mesh", "create_mesh", "shard_rows", "shard_batch", "replicate",
           "rank_generator", "DATA_AXIS", "MODEL_AXIS", "DEFAULT_TP_RULES",
           "tp_dim", "shard_module_", "full_state_dict",
           "load_full_state_dict_", "full_optimizer_state_dict",
           "load_full_optimizer_state_dict_", "full_weights",
           "sharded_names"]

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the JAX package's tensor-parallel rules in the port's names and layouts
# (path substring, the dimension split over ``model``), first match wins;
# torch keeps a Linear's weight as (out, in), the transpose of flax's kernel
DEFAULT_TP_RULES: list[tuple[str, int]] = [
    ("codebook.embeddings", 0),    # (K, D) over codes
    ("codebook.ema_sum", 0),
    ("codebook.ema_count", 0),
    ("to_logits.weight", 0),       # flax (D, K-1) over classes: (K-1, D)
    ("to_logits.bias", 0),
    ("content_emb.emb.weight", 0),
    ("mlp_fc.weight", 0),          # MLP megatron-style: (4D, D) by columns
    ("mlp_fc.bias", 0),
    ("mlp_proj.weight", 1),        # (D, 4D) by rows of the product
]


@dataclass(frozen=True)
class Mesh:
    """``data`` replicas of ``model`` shards; this process holds data index
    ``index`` and model index ``model_index``."""
    data: int = 1
    index: int = 0
    model: int = 1
    model_index: int = 0


def create_mesh(data: int | None = None, model: int = 1) -> Mesh:
    """The mesh over this process group's ranks, its groups formed
    (:func:`..parallel.distributed.set_grid`). ``data=None`` means every
    rank over ``model``; ``data * model`` other than the group's size
    raises. Without a group there is one rank, and a ``(1, model)`` mesh
    only describes the run the port's entries start (one process per rank):
    no module can be sharded over it."""
    model = int(model or 1)
    n = world_size()
    if model < 1 or (is_distributed() and n % model):
        raise ValueError(f"trainer.mesh.model={model}: {n} rank(s) do not "
                         f"divide into shards of {model}")
    per = n // model if is_distributed() else 1
    if data is not None and int(data) != per:
        where = ("this process group has" if is_distributed()
                 else "without a process group there is")
        raise ValueError(
            f"trainer.mesh.data={data}, mesh.model={model}: {where} {n} "
            f"rank(s); start the run through the port's entries (tasks, "
            f"generate, sweep), which start one process per rank, or under "
            f"torchrun")
    if not is_distributed():
        return Mesh(data=1, model=model)
    set_grid(per, model)
    return Mesh(data=per, index=group_rank(data_group()),
                model=model, model_index=group_rank(model_group()))


def shard_rows(n_rows: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of ``n_rows``; raises where the
    rows do not divide by the ranks (JAX's ``shard_batch`` does too)."""
    if n_rows % mesh.data:
        raise ValueError(f"a global batch of {n_rows} rows does not divide "
                         f"over {mesh.data} ranks")
    per = n_rows // mesh.data
    return slice(mesh.index * per, (mesh.index + 1) * per)


def shard_batch(batch: Mapping[str, Any], mesh: Mesh) -> dict:
    """This rank's rows of every per-row entry of a host batch (arrays,
    tensors and lists sliced along the first axis; 0-d entries kept)."""
    out, rows = {}, None
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim == 0:
            out[k] = v
            continue
        if rows is None:
            rows = shard_rows(len(v), mesh)
        out[k] = v[rows]
    return out


def replicate(tensors: Iterable[torch.Tensor]) -> None:
    """Overwrite every tensor with rank 0's (a no-op without a group)."""
    if not is_distributed():
        return
    for t in tensors:
        broadcast_(t, 0)


def rank_generator(generator: torch.Generator) -> torch.Generator:
    """A CPU generator of this data index's own stream: a seed drawn from
    ``generator`` (the same draw on every rank) plus the data index, the
    counterpart of JAX's ``fold_in(key, axis_index("data"))``. The model
    ranks of one replica draw alike."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return torch.Generator().manual_seed(seed + group_rank(data_group()))


def tp_dim(t: torch.Tensor | None) -> int | None:
    """The dimension ``t`` is split along over the model group, or None
    where this rank holds it whole."""
    return getattr(t, "tp_dim", None)


def _rule(name: str, t: torch.Tensor, model: int,
          rules: list[tuple[str, int]]) -> int | None:
    for frag, dim in rules:
        if frag in name:
            # JAX's fallback: a dimension that does not divide is replicated
            return (dim if dim < t.ndim and t.shape[dim] % model == 0
                    else None)
    return None


def _owned(module: nn.Module) -> Iterator[tuple[str, nn.Module, str, bool]]:
    """(full name, owner, local name, is a parameter) of every parameter and
    buffer of ``module``."""
    for mname, m in module.named_modules():
        for table, is_param in ((m._parameters, True), (m._buffers, False)):
            for leaf, t in table.items():
                if t is not None:
                    yield (f"{mname}.{leaf}" if mname else leaf), m, leaf, \
                        is_param


def sharded_names(module: nn.Module, mesh: Mesh,
                  rules: list[tuple[str, int]] | None = None
                  ) -> dict[str, int]:
    """The tensors of ``module`` that :func:`shard_module_` splits over
    ``mesh.model``, with their dimensions (none at ``model`` 1)."""
    rules = DEFAULT_TP_RULES if rules is None else rules
    if mesh.model == 1:
        return {}
    out = {}
    for name, m, leaf, is_param in _owned(module):
        t = (m._parameters if is_param else m._buffers)[leaf]
        dim = _rule(name, t, mesh.model, rules)
        if dim is not None:
            out[name] = dim
    return out


@torch.no_grad()
def _slice(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    per = t.shape[dim] // mesh.model
    return t.narrow(dim, mesh.model_index * per, per).clone()


def shard_module_(module: nn.Module, mesh: Mesh,
                  rules: list[tuple[str, int]] | None = None
                  ) -> dict[str, int]:
    """JAX's ``shard_state`` for a module holding whole tensors: every
    tensor :func:`sharded_names` names keeps this rank's slice (parameters
    in place, so an optimizer built over them keeps them) and carries its
    dimension as ``tp_dim``. Returns the names and dimensions."""
    if mesh.model != group_size(model_group()):
        raise RuntimeError(f"a mesh of model={mesh.model} needs a process "
                           f"group of that many shards (create_mesh inside "
                           f"the group); this rank's model group has "
                           f"{group_size(model_group())}")
    names = sharded_names(module, mesh, rules)
    for name, m, leaf, is_param in list(_owned(module)):
        if name not in names:
            continue
        dim = names[name]
        if is_param:
            p = m._parameters[leaf]
            p.data = _slice(p.data, dim, mesh)
            p.tp_dim = dim
        else:
            b = _slice(m._buffers[leaf], dim, mesh)
            b.tp_dim = dim
            m._buffers[leaf] = b
    return names


def _gather(t: torch.Tensor, dim: int | None) -> torch.Tensor:
    return t.detach() if dim is None else all_gather(t, dim, model_group())


def _local(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's slice of the whole ``t`` where ``like`` is sharded."""
    dim = tp_dim(like)
    if dim is None:
        return t
    n, r = group_size(model_group()), group_rank(model_group())
    per = t.shape[dim] // n
    return t.narrow(dim, r * per, per)


def full_state_dict(module: nn.Module) -> dict[str, torch.Tensor]:
    """``module.state_dict()`` with every sharded tensor whole (gathered
    over the model group: every rank of it calls this)."""
    return {k: _gather(v, tp_dim(v))
            for k, v in module.state_dict(keep_vars=True).items()}


def load_full_state_dict_(module: nn.Module,
                          state: Mapping[str, torch.Tensor]) -> None:
    """Load whole tensors into ``module``, each sharded one as this rank's
    slice."""
    mine = module.state_dict(keep_vars=True)
    module.load_state_dict({k: (_local(v, mine[k]) if k in mine else v)
                            for k, v in state.items()})


def _params(optimizer: torch.optim.Optimizer) -> list[torch.Tensor]:
    return [p for g in optimizer.param_groups for p in g["params"]]


def full_optimizer_state_dict(optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer.state_dict()`` with the moments of every sharded
    parameter whole."""
    sd = optimizer.state_dict()
    params = _params(optimizer)
    sd["state"] = {i: {k: (_gather(v, tp_dim(params[i]))
                           if isinstance(v, torch.Tensor) and v.ndim
                           else v) for k, v in st.items()}
                   for i, st in sd["state"].items()}
    return sd


def load_full_optimizer_state_dict_(optimizer: torch.optim.Optimizer,
                                    state: Mapping[str, Any]) -> None:
    """Load an optimizer state of whole moments, each sharded parameter's
    as this rank's slice."""
    params = _params(optimizer)
    state = dict(state)
    state["state"] = {i: {k: (_local(v, params[int(i)])
                              if isinstance(v, torch.Tensor) and v.ndim
                              else v) for k, v in st.items()}
                      for i, st in state["state"].items()}
    optimizer.load_state_dict(state)


@contextlib.contextmanager
def full_weights(module: nn.Module) -> Iterator[nn.Module]:
    """``module`` holding its whole tensors (gathered once over the model
    group) for the block, its shards and their ``tp_dim`` back after."""
    params, buffers = [], []
    with torch.no_grad():
        for name, m, leaf, is_param in list(_owned(module)):
            table = m._parameters if is_param else m._buffers
            t = table[leaf]
            if tp_dim(t) is None:
                continue
            whole = _gather(t, tp_dim(t))
            if is_param:
                params.append((t, t.data, t.tp_dim))
                t.data = whole
                del t.tp_dim
            else:
                buffers.append((m, leaf, t))
                table[leaf] = whole
    try:
        yield module
    finally:
        for p, data, dim in params:
            p.data = data
            p.tp_dim = dim
        for m, leaf, t in buffers:
            m._buffers[leaf] = t
