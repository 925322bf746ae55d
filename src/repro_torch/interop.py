"""Move parameter and optimizer-state trees between the JAX package and
the port.

The JAX package's params are a nested dict of arrays; given as numpy
arrays (``jax.tree.map(np.asarray, params)``, bf16 as ``ml_dtypes``'
bfloat16) they become the port's tree leaf for leaf, with the same keys,
shapes, dtypes and bits: both keep ``x @ W`` orientation and stacked
``(n_groups, ...)`` leaves, so no transpose is needed.

Optimizer state (``repro.train.optimizer.init``'s tree) moves the same
way: ``{"m", "v", "step"}`` whose m/v leaves are fp32 arrays or, with
``state_bits=8``, ``{"q": int8, "s": f32}`` dicts; ``step`` is a 0-d int32.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _is_bf16(dtype) -> bool:
    return np.dtype(dtype).name == "bfloat16"


def array_to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)          # a writable copy the tensor may own
    if _is_bf16(a.dtype):
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same tree of tensors on
    ``device``."""
    return {k: (params_from_numpy(v, device) if isinstance(v, dict)
                else array_to_tensor(v, device)) for k, v in tree.items()}


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's tree -> the same tree of numpy arrays (bf16 through
    ``ml_dtypes``), ready for ``jax.numpy.asarray``."""
    return {k: (params_to_numpy(v) if isinstance(v, dict)
                else tensor_to_array(v)) for k, v in tree.items()}


def opt_state_from_numpy(state: Dict[str, Any], device) -> Dict[str, Any]:
    """The JAX optimizer state as numpy (``jax.tree.map(np.asarray,
    opt)``) -> the port's, leaf for leaf on ``device``."""
    return params_from_numpy(state, device)


def opt_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's optimizer state -> numpy, ready for ``jnp.asarray``."""
    return params_to_numpy(state)
