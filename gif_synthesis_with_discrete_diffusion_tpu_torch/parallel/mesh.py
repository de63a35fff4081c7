"""The data-parallel layout: which rows of a global batch each rank holds.

The counterpart of ``gif_synthesis_with_discrete_diffusion_tpu/parallel/
mesh.py``. The JAX package places one program's arrays on a
``(data, model)`` device mesh; the port runs one process per device, so a
:class:`Mesh` here is the count of ranks along ``data`` and this process's
place on it. :func:`shard_batch` takes rank r's rows ``[r*B/N, (r+1)*B/N)``
of a global batch of B rows, the order of JAX's ``data`` axis, so rank r
holds what JAX's shard r holds; :func:`replicate` broadcasts rank 0's
tensors. Tensor parallelism over ``model`` (JAX's ``shard_state`` with
:data:`DEFAULT_TP_RULES`) is ROADMAP item [16b]: a mesh with ``model > 1``
raises, and the rules are kept here as data for it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Mapping

import numpy as np
import torch

from .distributed import broadcast_, is_distributed, rank, world_size

__all__ = ["Mesh", "create_mesh", "shard_rows", "shard_batch", "replicate",
           "rank_generator", "DATA_AXIS", "MODEL_AXIS", "DEFAULT_TP_RULES"]

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the JAX package's tensor-parallel rules (path substring, the axis of each
# dimension), first match wins; for ROADMAP item [16b], read by nothing yet
DEFAULT_TP_RULES: list[tuple[str, tuple]] = [
    ("codebook/embeddings", (MODEL_AXIS, None)),   # (K, D) over codes
    ("codebook/ema_sum", (MODEL_AXIS, None)),
    ("codebook/ema_count", (MODEL_AXIS,)),
    ("to_logits/kernel", (None, MODEL_AXIS)),      # (D, K-1) over classes
    ("to_logits/bias", (MODEL_AXIS,)),
    ("content_emb/emb/embedding", (MODEL_AXIS, None)),
    ("mlp_fc/kernel", (None, MODEL_AXIS)),         # MLP megatron-style
    ("mlp_fc/bias", (MODEL_AXIS,)),
    ("mlp_proj/kernel", (MODEL_AXIS, None)),
]


@dataclass(frozen=True)
class Mesh:
    """``data`` ranks, each a replica; this process is rank ``index``."""
    data: int = 1
    index: int = 0


def create_mesh(data: int | None = None, model: int = 1) -> Mesh:
    """The mesh over this process group's ranks (one rank without a group).
    ``data=None`` means every rank; a ``data`` other than the group's size
    raises, as does ``model > 1`` (ROADMAP item [16b])."""
    if int(model) > 1:
        raise NotImplementedError(
            f"trainer.mesh.model={model}: tensor parallelism over the model "
            f"axis is ROADMAP item [16b], not ported yet")
    n = world_size()
    if data is not None and int(data) != n:
        where = ("this process group has" if is_distributed()
                 else "without a process group there is")
        raise ValueError(
            f"trainer.mesh.data={data}: {where} {n} rank(s); start the run "
            f"through the port's entries (tasks, generate, sweep), which "
            f"start one process per rank, or under torchrun")
    return Mesh(data=n, index=rank())


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
    """A CPU generator of this rank's own stream: a seed drawn from
    ``generator`` (the same draw on every rank) plus the rank, the
    counterpart of JAX's ``fold_in(key, axis_index("data"))``."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return torch.Generator().manual_seed(seed + rank())
