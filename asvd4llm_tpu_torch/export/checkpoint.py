"""Native compressed-model checkpoint: safetensors params + rank manifest.

Counterpart of asvd4llm_tpu/export/checkpoint.py. A checkpoint directory
holds:

- ``manifest.json``      — {"format_version": 2, "spec": DecoderSpec fields,
                            "truncation_ranks": {layer_name: rank},
                            "encodings": per-leaf array shapes and dtypes of
                            every low-rank / int8 / int4 leaf,
                            "config": the ASVDConfig that produced it};
- ``params.safetensors`` — every tensor of the params dict under its path
                            ("layers.0.q_proj.A", "embed_tokens", ...), in
                            its own dtype: bf16 as bit patterns, int8 and
                            packed int4 codes as they are.

The manifest is the JAX package's, key for key and value for value (dtype
names are NumPy's). The container is not: the JAX package writes an Orbax
directory (``params.orbax/``), which needs a package this one does without,
so the two packages read each other's manifests but not each other's
weights. ``load_compressed`` rebuilds the params structure from the
manifest alone, so loading never needs the original dense checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from asvd4llm_tpu_torch.device import resolve_device
from asvd4llm_tpu_torch.models.convert import QUANT_SCALE_KEYS
from asvd4llm_tpu_torch.models.init import init_params
from asvd4llm_tpu_torch.models.registry import (
    get_linear, is_lowrank, is_q4_lowrank, is_q8_lowrank, iter_linears,
    lowrank_leaf, set_linear,
)
from asvd4llm_tpu_torch.models.spec import DecoderSpec
from asvd4llm_tpu_torch.utils.tensorio import SafetensorsFile, write_safetensors

PARAMS_FILE = "params.safetensors"
MANIFEST_FILE = "manifest.json"

_TAGS = {torch.bfloat16: "BF16", torch.float32: "F32", torch.float16: "F16",
         torch.int8: "I8", torch.uint8: "U8", torch.int32: "I32",
         torch.int64: "I64"}


def dtype_name(dtype: torch.dtype) -> str:
    """NumPy's name of a torch dtype ("bfloat16", "int8", ...)."""
    return str(dtype).removeprefix("torch.")


def tensor_entry(name: str, t: torch.Tensor, cast=None):
    """A ``write_safetensors`` entry for one tensor (cast to ``cast`` first
    when given), which copies it to the host only when the file reaches it."""
    dtype = cast or t.dtype

    def produce():
        h = t.detach().to(device="cpu", dtype=dtype).contiguous()
        if dtype == torch.bfloat16:
            return h.view(torch.int16).numpy().view(np.uint16)
        return h.numpy()
    return (name, _TAGS[dtype], tuple(t.shape), produce)


def read_tensor(f: SafetensorsFile, name: str) -> torch.Tensor:
    """One tensor of a file in its stored dtype (bf16 from its bits)."""
    arr = f.tensor(name, to_f32=False)
    if f.header[name]["dtype"] == "BF16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def flatten(tree, prefix=""):
    """(path, tensor) of every tensor in a params tree; None is skipped."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, f"{prefix}.{i}")
    elif tree is not None:
        yield prefix, tree


def _leaf_encoding(leaf: dict):
    """Serializable description of a non-dense linear leaf, enough to
    rebuild its skeleton (asvd4llm_tpu/export/checkpoint.py:31)."""
    if is_q4_lowrank(leaf):
        kind = "q4"
    elif is_q8_lowrank(leaf):
        kind = "q8"
    elif is_lowrank(leaf):
        kind = "lowrank"
    else:
        return None
    return {
        "kind": kind,
        "arrays": {k: {"shape": list(v.shape), "dtype": dtype_name(v.dtype)}
                   for k, v in leaf.items() if k != "b" and v is not None},
        "bias": leaf.get("b") is not None,
    }


def manifest(spec: DecoderSpec, manifest_ranks: dict, cfg=None,
             params=None) -> dict:
    """The manifest of asvd4llm_tpu/export/checkpoint.py:54, format v2."""
    encodings = {}
    if params is not None:
        for name, leaf in iter_linears(params, spec, include_extras=True):
            enc = _leaf_encoding(leaf)
            if enc is not None:
                encodings[name] = enc
    return {
        "format_version": 2,
        "spec": dataclasses.asdict(spec),
        "truncation_ranks": {k: int(v) for k, v in manifest_ranks.items()},
        "encodings": encodings,
        "config": None if cfg is None else cfg.to_dict(),
    }


def save_compressed(path: str, params: dict, spec: DecoderSpec,
                    manifest_ranks: dict, cfg=None) -> str:
    """Write ``manifest.json`` and ``params.safetensors`` under ``path``;
    tensors go to the file one at a time."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, MANIFEST_FILE), "w") as f:
        json.dump(manifest(spec, manifest_ranks, cfg, params), f, indent=2)
    write_safetensors(os.path.join(path, PARAMS_FILE),
                      [tensor_entry(n, t) for n, t in flatten(params)])
    return path


def _skeleton(man: dict, spec: DecoderSpec, dtype) -> dict:
    """The params structure the manifest describes, as meta tensors
    (asvd4llm_tpu/export/checkpoint.py:88-129)."""
    skeleton = init_params(spec, None, dtype=dtype or torch.bfloat16,
                           device="meta")
    encodings = man.get("encodings")
    if encodings:  # format v2: any leaf encoding (lowrank / q8 / q4)
        for name, enc in encodings.items():
            leaf = get_linear(skeleton, spec, name)
            new = {k: torch.empty(d["shape"], dtype=getattr(torch, d["dtype"]),
                                  device="meta")
                   for k, d in enc["arrays"].items()}
            if enc["bias"]:
                if leaf.get("b") is not None:
                    new["b"] = leaf["b"]
                else:  # e.g. a factored tied head: bias dim from A's rows
                    out_dim = next(d["shape"][0] for k, d in enc["arrays"].items()
                                   if k in ("A", "A8", "Asc"))
                    new["b"] = torch.empty(out_dim, device="meta")
            else:
                new["b"] = None
            skeleton = set_linear(skeleton, spec, name, new)
    else:  # format v1: the rank manifest implies plain low-rank leaves
        for name, rank in man["truncation_ranks"].items():
            leaf = get_linear(skeleton, spec, name)
            out_f, in_f = leaf["w"].shape
            w = leaf["w"]
            skeleton = set_linear(skeleton, spec, name, lowrank_leaf(
                torch.empty(out_f, rank, dtype=w.dtype, device="meta"),
                torch.empty(rank, in_f, dtype=w.dtype, device="meta"), leaf["b"]))
    return skeleton


def load_compressed(path: str, dtype=None, device=None
                    ) -> tuple[dict, DecoderSpec, dict]:
    """(params, spec, manifest_ranks) from a checkpoint directory, on
    ``device`` (``cuda:0`` unless the caller names another). Tensors keep
    their saved dtypes; with ``dtype``, floating tensors other than the
    quantized leaves' scales and zero points are cast to it."""
    device = resolve_device(device)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    with open(os.path.join(path, MANIFEST_FILE)) as f:
        man = json.load(f)
    spec = DecoderSpec(**man["spec"])
    skeleton = _skeleton(man, spec, dtype)

    with SafetensorsFile(os.path.join(path, PARAMS_FILE)) as f:
        unused = set(f.keys())

        def fill(tree, prefix="", key=""):
            if isinstance(tree, dict):
                return {k: fill(v, f"{prefix}.{k}" if prefix else str(k), k)
                        for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(fill(v, f"{prefix}.{i}", key)
                                  for i, v in enumerate(tree))
            if tree is None:
                return None
            if prefix not in unused:
                raise KeyError(f"{path}: no tensor {prefix!r} in {PARAMS_FILE}")
            unused.discard(prefix)
            t = read_tensor(f, prefix)
            if tuple(t.shape) != tuple(tree.shape):
                raise ValueError(f"{path}: {prefix!r} has shape {tuple(t.shape)}, "
                                 f"the manifest says {tuple(tree.shape)}")
            cast = dtype if (dtype is not None and t.is_floating_point()
                             and key not in QUANT_SCALE_KEYS) else t.dtype
            return t.to(device=device, dtype=cast)

        params = fill(skeleton)
    if unused:
        raise ValueError(f"{path}: tensors the manifest does not describe: "
                         f"{sorted(unused)[:5]}")
    return params, spec, man["truncation_ranks"]
