"""Which process leads: rank 0 of the ``torch.distributed`` group.

The counterpart of ``gif_synthesis_with_discrete_diffusion_tpu/parallel/
distributed.py: is_main_process``. The port runs on one GPU; a process
group (more than one GPU) comes with ROADMAP item [16]. Until a group is
initialised every process is the main one.
"""
from __future__ import annotations

__all__ = ["is_main_process"]


def is_main_process() -> bool:
    """True on rank 0 of an initialised process group, and without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True
