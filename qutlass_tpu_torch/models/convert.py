"""Carry parameters across from the JAX package.

``params_from_numpy`` takes a JAX parameter pytree already converted to
numpy arrays (``jax.tree.map(np.asarray, params)``) and builds the
port's parameter dict on ``device``: raw bf16 weights as well as the
stored dicts of ``quantize_model_weights`` (``wi8``/``wsb``/``wqt``/
``wst``/``am`` leaves).  This module needs neither JAX nor ml_dtypes.
"""
from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One numpy array (or scalar) -> tensor, bit-exact.

    numpy carries JAX's bf16 as ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` rejects: its bits go through uint16 -> int16 ->
    bfloat16 views instead.
    """
    a = np.asarray(a)
    if not a.flags.writeable:      # JAX hands out read-only host buffers
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).view(np.int16)
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device)


def params_from_numpy(params_np, device=None):
    """Map a numpy pytree (dicts, lists, tuples, arrays) to tensors."""
    if isinstance(params_np, dict):
        return {k: params_from_numpy(v, device) for k, v in params_np.items()}
    if isinstance(params_np, (list, tuple)):
        return type(params_np)(params_from_numpy(v, device) for v in params_np)
    return tensor_from_numpy(params_np, device)
