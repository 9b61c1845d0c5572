"""Carry parameters across from the JAX package.

``params_from_numpy`` takes a JAX parameter pytree already converted to
numpy arrays (``jax.tree.map(np.asarray, params)``) and builds the
port's parameter dict on ``device`` (the card unless the caller names
another): raw bf16 weights as well as the stored dicts of
``quantize_model_weights``, MX (``wi8``/``wsb``/``wqt``/``wst``/``am``
leaves) and NV (``nvi8``/``nvsb``/``wqt``/``wst``/``gs``/``gsx``) alike,
since the conversion is leaf by leaf.  ``quartet_mlp_from_numpy`` loads
the QAT example's ``{"w1", "w2"}`` weights into a trainable
``QuartetMLP``.  This module needs neither JAX nor ml_dtypes.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import utils


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One numpy array (or scalar) -> tensor on ``device``, bit-exact.

    numpy carries JAX's bf16 as ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` rejects: its bits go through uint16 -> int16 ->
    bfloat16 views instead.
    """
    a = np.asarray(a)
    # a C-contiguous, writable copy of the same shape (JAX hands out
    # read-only host buffers; np.ascontiguousarray would turn a 0-dim
    # leaf such as an NV global scale into shape [1])
    a = np.array(a, order="C", copy=not a.flags.writeable or not a.flags.c_contiguous)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(utils.resolve_device(device))


def params_from_numpy(params_np, device=None):
    """Map a numpy pytree (dicts, lists, tuples, arrays) to tensors on
    ``device`` (the card unless the caller names another)."""
    device = utils.resolve_device(device)
    if isinstance(params_np, dict):
        return {k: params_from_numpy(v, device) for k, v in params_np.items()}
    if isinstance(params_np, (list, tuple)):
        return type(params_np)(params_from_numpy(v, device) for v in params_np)
    return tensor_from_numpy(params_np, device)


def quartet_mlp_from_numpy(params_np, *, rot_size: int = 32, method: str = "quest",
                           grad_mode: str = "int8", device=None):
    """The QAT example's parameters (``{"w1": [hidden, in], "w2": [out,
    hidden]}``, bf16 numpy) -> a ``QuartetMLP`` holding them as trainable
    bf16 parameters on ``device`` (the card unless the caller names
    another)."""
    from ..nn.linear import QuartetMLP
    p = params_from_numpy({"w1": params_np["w1"], "w2": params_np["w2"]}, device)
    (d_hidden, d_in), d_out = p["w1"].shape, p["w2"].shape[0]
    mlp = QuartetMLP(d_in, d_hidden, d_out, rot_size=rot_size, method=method,
                     grad_mode=grad_mode, device=p["w1"].device)
    with torch.no_grad():
        mlp.fc1.weight.copy_(p["w1"])
        mlp.fc2.weight.copy_(p["w2"])
    return mlp
