"""HF-compatible export of a compressed model.

Counterpart of asvd4llm_tpu/export/hf_repo.py: a ``trust_remote_code``
repository a transformers user loads directly (ref build_asvd_repo.py:
47-108). ``config.json`` gains ``truncation_ranks`` and an ``auto_map`` to
generated modeling classes that swap factored linears into the skeleton
BEFORE the checkpoint loads (ref modeling_asvd_llama.py:14-42); the
modeling file comes from the template below, the JAX package's text apart
from the generator's name in its first line.

State dict naming: a factored layer exports as ``<name>.BLinear.weight``
([rank, in]) and ``<name>.ALinear.weight`` ([out, rank]), the bias on
ALinear (ref modeling_asvd_llama.py:5-12); int8 and packed int4 factors as
the ``ASVDQ8Linear`` / ``ASVDQ4Linear`` buffers. Floating tensors are
written in f32, codes as int8 / uint8, through this package's safetensors
writer with the ``{"format": "pt"}`` metadata that transformers requires,
one tensor at a time: host memory holds one tensor, never the state dict.

Where the JAX exporter takes a ``transformers`` config object and a
tokenizer, this one takes the source checkpoint's ``config.json`` as a dict
and a tokenizer directory whose files it copies, so it needs neither
``transformers`` nor ``safetensors``.
"""

from __future__ import annotations

import json
import os
import shutil

import torch

from asvd4llm_tpu_torch.export.checkpoint import tensor_entry
from asvd4llm_tpu_torch.models.loader import HF_LAYOUTS
from asvd4llm_tpu_torch.models.registry import (
    is_lowrank, is_q4_lowrank, is_q8_lowrank, iter_linears, layer_linear_keys,
)
from asvd4llm_tpu_torch.ops.quant import INT4_COL_TILE
from asvd4llm_tpu_torch.utils.tensorio import write_safetensors

TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model", "tokenizer_config.json",
                   "special_tokens_map.json")

_MODELING_TEMPLATE = '''"""Generated by asvd4llm_tpu_torch — low-rank (ASVD) {family} for transformers.

Loads a checkpoint whose config carries `truncation_ranks`: every listed
linear is replaced by a rank-r factor pair before weight loading, so the
factored state dict loads natively. Layers listed in `asvd_int4` load as
packed 4-bit factors (2 codes/byte + per-(row, group) asymmetric scales,
the storage analogue of AWQ w4 deployment) and dequantize lazily on the
first forward.
"""
import torch
import torch.nn as nn
from transformers import {base_cls} as _Base
from transformers import {cfg_cls} as _BaseConfig


class ASVDConfig(_BaseConfig):
    model_type = "{model_type}"

    def __init__(self, truncation_ranks=None, asvd_int4=None,
                 asvd_int8=None, **kwargs):
        self.truncation_ranks = truncation_ranks or {{}}
        self.asvd_int4 = asvd_int4 or None
        self.asvd_int8 = asvd_int8 or None
        super().__init__(**kwargs)


class ASVDLinear(nn.Module):
    def __init__(self, in_features, out_features, rank, bias=True):
        super().__init__()
        self.BLinear = nn.Linear(in_features, rank, bias=False)
        self.ALinear = nn.Linear(rank, out_features, bias=bias)

    def forward(self, x):
        return self.ALinear(self.BLinear(x))


def _ceil_to(n, m):
    return -(-n // m) * m


class ASVDQ4Linear(nn.Module):
    """Low-rank factor pair stored as packed int4 codes.

    Storage is 4 bits/weight on disk and in memory until first use; this
    generic consumer dequantizes to the activation dtype lazily (swap in a
    fused int4 GEMM where the hardware provides one). Packing layout: the
    padded matrix is processed in `col_tile`-wide column tiles; packed
    column c of a tile holds original column c of the tile's FIRST half in
    the low nibble and of the SECOND half in the high nibble. Dequant of
    code q in (row r, group g) is scales[r, g] * q - zero_scales[r, g].
    """

    def __init__(self, in_features, out_features, rank, bias=True,
                 group=128, col_tile=512):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.rank = rank
        self.group = group
        self.col_tile = col_tile
        rp = _ceil_to(rank, col_tile)
        kp = _ceil_to(in_features, col_tile)
        self.register_buffer(
            "A_qweight", torch.zeros(out_features, rp // 2, dtype=torch.uint8))
        self.register_buffer("A_scales", torch.zeros(out_features, rp // group))
        self.register_buffer(
            "A_zero_scales", torch.zeros(out_features, rp // group))
        self.register_buffer(
            "B_qweight", torch.zeros(rp, kp // 2, dtype=torch.uint8))
        self.register_buffer("B_scales", torch.zeros(rp, kp // group))
        self.register_buffer("B_zero_scales", torch.zeros(rp, kp // group))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_features))
        else:
            self.bias = None
        self._Aw = None
        self._Bw = None

    def _dequant(self, q, sc, zs, rows, cols):
        r, ch = q.shape
        half = self.col_tile // 2
        tiles = q.reshape(r, ch // half, half)
        codes = torch.stack([tiles & 15, tiles >> 4], dim=2)
        codes = codes.reshape(r, ch * 2).float()
        grouped = codes.reshape(r, -1, self.group)
        w = grouped * sc.float().unsqueeze(-1) - zs.float().unsqueeze(-1)
        return w.reshape(r, ch * 2)[:rows, :cols]

    def forward(self, x):
        if self._Aw is None or self._Aw.dtype != x.dtype:
            self._Aw = self._dequant(
                self.A_qweight, self.A_scales, self.A_zero_scales,
                self.out_features, self.rank).to(x.dtype)
            self._Bw = self._dequant(
                self.B_qweight, self.B_scales, self.B_zero_scales,
                self.rank, self.in_features).to(x.dtype)
        t = nn.functional.linear(x, self._Bw)
        return nn.functional.linear(t, self._Aw, self.bias)


class ASVDQ8Linear(nn.Module):
    """Low-rank factor pair stored as int8 codes + per-row asymmetric
    (scale, zero); dequant of code q in row r is scale[r] * (q - zero[r]).
    Dequantizes to the activation dtype lazily on the first forward."""

    def __init__(self, in_features, out_features, rank, bias=True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.rank = rank
        self.register_buffer(
            "A_qweight", torch.zeros(out_features, rank, dtype=torch.int8))
        self.register_buffer("A_scale", torch.zeros(out_features, 1))
        self.register_buffer("A_zero", torch.zeros(out_features, 1))
        self.register_buffer(
            "B_qweight", torch.zeros(rank, in_features, dtype=torch.int8))
        self.register_buffer("B_scale", torch.zeros(rank, 1))
        self.register_buffer("B_zero", torch.zeros(rank, 1))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_features))
        else:
            self.bias = None
        self._Aw = None
        self._Bw = None

    def forward(self, x):
        if self._Aw is None or self._Aw.dtype != x.dtype:
            self._Aw = (self.A_scale.float()
                        * (self.A_qweight.float() - self.A_zero.float())
                        ).to(x.dtype)
            self._Bw = (self.B_scale.float()
                        * (self.B_qweight.float() - self.B_zero.float())
                        ).to(x.dtype)
        t = nn.functional.linear(x, self._Bw)
        return nn.functional.linear(t, self._Aw, self.bias)


class ASVDModelForCausalLM(_Base):
    config_class = ASVDConfig

    def __init__(self, config):
        super().__init__(config)
        int4 = getattr(config, "asvd_int4", None) or {{}}
        int4_names = set(int4.get("layers", []))
        int8 = getattr(config, "asvd_int8", None) or {{}}
        int8_names = set(int8.get("layers", []))
        modules = dict(self.named_modules())
        for name, rank in getattr(config, "truncation_ranks", {{}}).items():
            parent_name, _, child = name.rpartition(".")
            parent = modules[parent_name]
            old = getattr(parent, child)
            if name in int4_names:
                new = ASVDQ4Linear(
                    old.in_features, old.out_features, int(rank),
                    bias=old.bias is not None,
                    group=int(int4.get("group", 128)),
                    col_tile=int(int4.get("col_tile", 512)))
            elif name in int8_names:
                new = ASVDQ8Linear(old.in_features, old.out_features,
                                   int(rank), bias=old.bias is not None)
            else:
                new = ASVDLinear(old.in_features, old.out_features, int(rank),
                                 bias=old.bias is not None)
            setattr(parent, child, new)
'''

_FAMILY_CLASSES = {
    "llama": ("LlamaForCausalLM", "LlamaConfig", "llama"),
    "opt": ("OPTForCausalLM", "OPTConfig", "opt"),
    "gemma": ("GemmaForCausalLM", "GemmaConfig", "gemma"),
    "gemma2": ("Gemma2ForCausalLM", "Gemma2Config", "gemma2"),
    "mistral": ("MistralForCausalLM", "MistralConfig", "mistral"),
    "qwen2": ("Qwen2ForCausalLM", "Qwen2Config", "qwen2"),
}


def _state_dict_entries(params, spec) -> list:
    """``write_safetensors`` entries with HF + ASVDLinear naming
    (asvd4llm_tpu/export/hf_repo.py:211-281): floating tensors as f32,
    int8 / packed int4 codes as they are."""
    layout = HF_LAYOUTS[spec.family]
    entries = []

    def put(name, t):
        entries.append(tensor_entry(
            name, t, torch.float32 if t.is_floating_point() else None))

    def emit_leaf(base, leaf):
        if is_q8_lowrank(leaf):
            for key, sub in (("A8", "A_qweight"), ("Asc", "A_scale"),
                             ("Azp", "A_zero"), ("B8", "B_qweight"),
                             ("Bsc", "B_scale"), ("Bzp", "B_zero")):
                put(f"{base}.{sub}", leaf[key])
            if leaf["b"] is not None:
                put(f"{base}.bias", leaf["b"])
        elif is_q4_lowrank(leaf):
            for key, sub in (("A4", "A_qweight"), ("Asc", "A_scales"),
                             ("Azs", "A_zero_scales"), ("B4", "B_qweight"),
                             ("Bsc", "B_scales"), ("Bzs", "B_zero_scales")):
                put(f"{base}.{sub}", leaf[key])
            if leaf["b"] is not None:
                put(f"{base}.bias", leaf["b"])
        elif is_lowrank(leaf):
            put(f"{base}.ALinear.weight", leaf["A"])
            put(f"{base}.BLinear.weight", leaf["B"])
            if leaf["b"] is not None:
                put(f"{base}.ALinear.bias", leaf["b"])
        else:
            put(f"{base}.weight", leaf["w"])
            if leaf.get("b") is not None:
                put(f"{base}.bias", leaf["b"])

    put(f"{layout['embed']}.weight", params["embed_tokens"])
    if spec.pos_emb == "learned":
        put(f"{layout['embed_positions']}.weight", params["embed_positions"])
    for i, layer in enumerate(params["layers"]):
        pfx = layout["layers"].format(i=i)
        for key in layer_linear_keys(spec):
            emit_leaf(f"{pfx}.{layout['linears'][key]}", layer[key])
        for nkey, sub in layout["norms"].items():
            put(f"{pfx}.{sub}.weight", layer[nkey]["w"])
            if layer[nkey]["b"] is not None:
                put(f"{pfx}.{sub}.bias", layer[nkey]["b"])
    if params.get("final_norm") is not None:
        put(f"{layout['final_norm']}.weight", params["final_norm"]["w"])
        if params["final_norm"]["b"] is not None:
            put(f"{layout['final_norm']}.bias", params["final_norm"]["b"])
    if params.get("project_in") is not None:  # OPT-350m
        emit_leaf("model.decoder.project_in", params["project_in"])
        emit_leaf("model.decoder.project_out", params["project_out"])
    if params.get("lm_head") is not None:
        emit_leaf("lm_head", params["lm_head"])
    return entries


def export_hf_repo(path: str, params, spec, manifest_ranks: dict,
                   hf_config: dict | None = None,
                   tokenizer_dir: str | None = None) -> str:
    """Write a trust_remote_code HF repo directory (ref build_asvd_repo.py:
    65-108): ``config.json`` with truncation_ranks and auto_map,
    ``modeling_asvd.py``, ``model.safetensors`` and, from
    ``tokenizer_dir``, the tokenizer files that are there.

    hf_config: the source checkpoint's config.json as a dict; its
    ``model_type`` picks the classes, so qwen2 and mistral repos rebuild
    their own skeletons (their spec family is "llama")."""
    os.makedirs(path, exist_ok=True)
    family_key = spec.family
    if hf_config is not None and hf_config.get("model_type") in _FAMILY_CLASSES:
        family_key = hf_config["model_type"]
    base_cls, cfg_cls, model_type = _FAMILY_CLASSES[family_key]

    cfg_dict = dict(hf_config) if hf_config is not None \
        else _spec_to_hf_config_dict(spec)
    cfg_dict["truncation_ranks"] = {k: int(v) for k, v in manifest_ranks.items()}
    int4_block = _int4_config_block(params, spec)
    if int4_block is not None:
        cfg_dict["asvd_int4"] = int4_block
    int8_names = [name for name, leaf in
                  iter_linears(params, spec, include_extras=True)
                  if is_q8_lowrank(leaf)]
    if int8_names:
        cfg_dict["asvd_int8"] = {"layers": int8_names}
    cfg_dict["auto_map"] = {
        "AutoConfig": "modeling_asvd.ASVDConfig",
        "AutoModelForCausalLM": "modeling_asvd.ASVDModelForCausalLM",
    }
    cfg_dict["architectures"] = ["ASVDModelForCausalLM"]
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg_dict, f, indent=2)

    with open(os.path.join(path, "modeling_asvd.py"), "w") as f:
        f.write(_MODELING_TEMPLATE.format(
            family=spec.family, base_cls=base_cls, cfg_cls=cfg_cls,
            model_type=model_type))

    write_safetensors(os.path.join(path, "model.safetensors"),
                      _state_dict_entries(params, spec),
                      metadata={"format": "pt"})

    if tokenizer_dir is not None:
        for name in TOKENIZER_FILES:
            src = os.path.join(tokenizer_dir, name)
            if os.path.isfile(src):
                shutil.copyfile(src, os.path.join(path, name))
    return path


def _int4_config_block(params, spec) -> dict | None:
    """The config's ``asvd_int4`` block: which layers load as ASVDQ4Linear,
    with the group (recovered from the scale shapes) and column tile."""
    names, group = [], None
    for name, leaf in iter_linears(params, spec, include_extras=True):
        if not is_q4_lowrank(leaf):
            continue
        g = leaf["B4"].shape[1] * 2 // leaf["Bsc"].shape[1]
        if group is not None and g != group:
            raise ValueError(
                f"mixed int4 quant groups in one export ({group} vs {g} at "
                f"{name}); export them as separate repos")
        group = g
        names.append(name)
    if not names:
        return None
    return {"group": int(group), "col_tile": int(INT4_COL_TILE),
            "layers": names}


def _spec_to_hf_config_dict(spec) -> dict:
    if spec.family == "llama":
        return {
            "model_type": "llama", "vocab_size": spec.vocab_size,
            "hidden_size": spec.hidden_size,
            "intermediate_size": spec.intermediate_size,
            "num_hidden_layers": spec.num_layers,
            "num_attention_heads": spec.num_heads,
            "num_key_value_heads": spec.num_kv_heads,
            "head_dim": spec.head_dim,
            "max_position_embeddings": spec.max_position_embeddings,
            "rms_norm_eps": spec.norm_eps, "rope_theta": spec.rope_theta,
            "tie_word_embeddings": spec.tie_word_embeddings,
            "torch_dtype": "float32",
        }
    if spec.family == "opt":
        return {
            "model_type": "opt", "vocab_size": spec.vocab_size,
            "hidden_size": spec.hidden_size, "ffn_dim": spec.intermediate_size,
            "num_hidden_layers": spec.num_layers,
            "num_attention_heads": spec.num_heads,
            "max_position_embeddings": spec.max_position_embeddings,
            "do_layer_norm_before": spec.do_layer_norm_before,
            # OPT-350m keeps its narrow embedding dim (round-1 bug: this was
            # hardcoded to hidden_size, breaking 350m export)
            "word_embed_proj_dim": spec.word_embed_proj_dim or spec.hidden_size,
            "activation_function": "relu" if spec.act == "relu" else spec.act,
            "tie_word_embeddings": spec.tie_word_embeddings,
            "torch_dtype": "float32",
        }
    raise NotImplementedError(spec.family)
