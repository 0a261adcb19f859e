"""The weight bridge between the two packages.

The JAX package's params are a pytree of dicts, lists and arrays; the port's
are the same structure with torch tensors at the leaves, so every registry
name and leaf key is shared. The bridge speaks numpy: a caller turns JAX
params into numpy with ``jax.tree.map(np.asarray, params)`` and hands the
result to ``params_from_numpy``; ``params_to_numpy`` goes the other way.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_tensor(arr, dtype, device):
    arr = np.asarray(arr)
    if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        # numpy has no native bfloat16: go through f32, then to `dtype`
        t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
        return t.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


# scales and zero points of the q8/q4 deployment leaves: always f32 (a bf16
# scale would shift every dequantized weight)
QUANT_SCALE_KEYS = frozenset({"Asc", "Azp", "Azs", "Bsc", "Bzp", "Bzs"})


def params_from_numpy(tree, spec=None, *, dtype=torch.float32, device="cpu"):
    """Numpy params pytree -> port params: floating arrays become ``dtype``
    tensors on ``device`` (quantized leaves' scales and zeros f32 whatever
    ``dtype`` is), integer arrays keep their type; dicts, lists, tuples and
    None keep their places. ``spec`` is accepted for symmetry with the
    loaders and not needed by the conversion."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(
                    v, dtype=torch.float32 if k in QUANT_SCALE_KEYS else dtype,
                    device=device)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, dtype=dtype, device=device)
                          for v in tree)
    if tree is None:
        return None
    return _to_tensor(tree, dtype, device)


def pools_from_numpy(pools, *, dtype=torch.float32, device="cpu"):
    """A serving engine's page pools as numpy arrays (a list of per-layer
    dicts, e.g. ``[{k: np.asarray(v) for k, v in p.items()} for p in
    jax_engine.pools]``) -> the port's pools: ``dtype`` tensors on
    ``device`` with the same keys and shapes."""
    return [{k: _to_tensor(v, dtype, device) for k, v in layer.items()}
            for layer in pools]


def params_to_numpy(tree):
    """Port params -> numpy pytree (floating tensors as float32)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    if tree is None:
        return None
    t = tree.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()
