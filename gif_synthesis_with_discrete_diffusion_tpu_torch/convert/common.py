"""Reading the reference's torch checkpoints: the loader and layout helpers.

The port's copy of ``gif_synthesis_with_discrete_diffusion_tpu/convert/
common.py``. The reference loads its stage checkpoints with
``torch.load(...)['state_dict']`` and strips prefixes; here a checkpoint is
read once into ``{name: numpy array}``, prefixes are stripped, and the
converters (``torch_*.py``) map the names into the flax trees the JAX
package's converters build, with the same layout transposes:

* Conv3d  (O, I, kD, kH, kW)      -> DHWIO  (kD, kH, kW, I, O)
* ConvT3d (I, O, kD, kH, kW)      -> DHWIO  (kD, kH, kW, I, O)
* Linear  (out, in)               -> (in, out)

and then onto the port's state dicts through :mod:`.from_flax`, so each
converter's result is the JAX converter's, bridged.

A Lightning checkpoint (``.ckpt``) pickles its ``hyper_parameters``, often
as OmegaConf or Lightning objects that cannot be imported where the port
runs. :func:`load_torch_state_dict` unpickles with a loader that takes
torch's, numpy's and the standard containers' classes as they are and
stands in an inert placeholder for any other class, so the tensors come
back whatever else the file holds; it keeps the tensors and numbers of the
state dict, and raises, naming the key, where there is no state dict of
tensors.
"""
from __future__ import annotations

import pickle
import types
from pathlib import Path
from typing import Any, Mapping

import numpy as np

__all__ = ["load_torch_state_dict", "strip_prefix", "conv3d_kernel",
           "conv_transpose3d_kernel", "linear_kernel", "bn_params"]

# classes taken as they are; every other class is a placeholder
_REAL_MODULES = ("torch", "numpy", "collections", "_codecs", "copyreg")
_SAFE_BUILTINS = {"set", "frozenset", "slice", "range", "complex", "list",
                  "dict", "tuple", "int", "float", "str", "bytes",
                  "bytearray", "bool", "object"}


class _Placeholder(dict):
    """Stands in for a class the loader does not take: accepts whatever
    the pickle builds it with and keeps nothing but dict items."""

    def __new__(cls, *args, **kwargs):
        return dict.__new__(cls)

    def __init__(self, *args, **kwargs):
        super().__init__()

    def __setstate__(self, state):
        pass

    def append(self, item):
        pass

    def extend(self, items):
        pass


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str) -> Any:
        if module.split(".")[0] in _REAL_MODULES or (
                module == "builtins" and name in _SAFE_BUILTINS):
            return super().find_class(module, name)
        return type(name, (_Placeholder,), {"__module__": module})


_PICKLE = types.ModuleType("_checkpoint_pickle")
_PICKLE.Unpickler = _Unpickler
_PICKLE.load = pickle.load
_PICKLE.__name__ = "_checkpoint_pickle"


def _value(v: Any) -> np.ndarray | None:
    """A tensor or a number as numpy; None for anything else."""
    if hasattr(v, "detach") and hasattr(v, "numpy"):
        return np.asarray(v.detach().cpu().numpy())
    if isinstance(v, (bool, int, float, np.ndarray, np.generic)):
        return np.asarray(v)
    return None


def load_torch_state_dict(path: str | Path, key: str | None = "auto"
                          ) -> dict[str, np.ndarray]:
    """Load a .pt/.ckpt into ``{name: numpy array}``: with ``key="auto"``
    the ``state_dict`` entry of a Lightning checkpoint, or the file's dict
    itself; with another ``key`` that entry where the file has it; with
    ``None`` the file's dict. Raises ``ValueError`` naming the key where that
    is not a dict of tensors and numbers (no partial dict comes back), and
    where the file is no torch checkpoint."""
    import torch
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False,
                         pickle_module=_PICKLE)
    except (pickle.UnpicklingError, EOFError, RuntimeError) as e:
        raise ValueError(f"{path}: not a torch checkpoint ({e})") from e
    where = "the file"
    if isinstance(obj, Mapping) and key == "auto" and "state_dict" in obj:
        obj, where = obj["state_dict"], "key 'state_dict'"
    elif key not in (None, "auto") and isinstance(obj, Mapping) \
            and key in obj:
        obj, where = obj[key], f"key {key!r}"
    if not isinstance(obj, Mapping) or not obj:
        raise ValueError(f"{path}: no state_dict of tensors at {where}")
    out = {}
    for k, v in obj.items():
        a = _value(v)
        if a is None:
            raise ValueError(f"{path}: {where} holds {type(v).__name__} "
                             f"at {k!r}, not a tensor: no state_dict of "
                             f"tensors there")
        out[str(k)] = a
    if not any(hasattr(v, "detach") for v in obj.values()):
        raise ValueError(f"{path}: no state_dict of tensors at {where}")
    return out


def strip_prefix(sd: Mapping[str, np.ndarray], prefix: str
                 ) -> dict[str, np.ndarray]:
    out = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return out or dict(sd)


def conv3d_kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 4, 1, 0))


def conv_transpose3d_kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 4, 0, 1))


def linear_kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))


def bn_params(sd: Mapping[str, np.ndarray], prefix: str):
    """torch BatchNorm -> (flax params, flax batch_stats)."""
    params = {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}
    stats = {"mean": sd[f"{prefix}.running_mean"],
             "var": sd[f"{prefix}.running_var"]}
    return params, stats
