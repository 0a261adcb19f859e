"""Checkpoint directory -> params dict.

Counterpart of the native path of asvd4llm_tpu/models/loader.py
(``load_model_native``, :195-214): ``config.json`` plus ``*.safetensors``
in HF naming, read with the port's numpy safetensors reader. Neither
``transformers`` nor ``safetensors`` is used; hub ids (which need the
network and ``transformers``) are still to port (ROADMAP queue 1).
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import numpy as np
import torch

from asvd4llm_tpu_torch.device import resolve_device
from asvd4llm_tpu_torch.models.registry import (
    dense_leaf, layer_linear_keys, lowrank_leaf, q4_lowrank_leaf,
    q8_lowrank_leaf,
)
from asvd4llm_tpu_torch.models.spec import DecoderSpec, spec_from_hf_config

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


# HF param-name layout per family
HF_LAYOUTS = {
    "llama": {
        "layers": "model.layers.{i}",
        "linears": {k: f"self_attn.{k}" for k in ("q_proj", "k_proj", "v_proj", "o_proj")}
        | {k: f"mlp.{k}" for k in ("gate_proj", "up_proj", "down_proj")},
        "norms": {"ln1": "input_layernorm", "ln2": "post_attention_layernorm"},
        "embed": "model.embed_tokens",
        "final_norm": "model.norm",
    },
    "gemma2": {
        "layers": "model.layers.{i}",
        "linears": {k: f"self_attn.{k}" for k in ("q_proj", "k_proj", "v_proj", "o_proj")}
        | {k: f"mlp.{k}" for k in ("gate_proj", "up_proj", "down_proj")},
        "norms": {"ln1": "input_layernorm",
                  "ln1_post": "post_attention_layernorm",
                  "ln2": "pre_feedforward_layernorm",
                  "ln2_post": "post_feedforward_layernorm"},
        "embed": "model.embed_tokens",
        "final_norm": "model.norm",
    },
    "opt": {
        "layers": "model.decoder.layers.{i}",
        "linears": {k: f"self_attn.{k}" for k in ("q_proj", "k_proj", "v_proj", "out_proj")}
        | {"fc1": "fc1", "fc2": "fc2"},
        "norms": {"ln1": "self_attn_layer_norm", "ln2": "final_layer_norm"},
        "embed": "model.decoder.embed_tokens",
        "embed_positions": "model.decoder.embed_positions",
        "final_norm": "model.decoder.final_layer_norm",
    },
}
HF_LAYOUTS["gemma"] = HF_LAYOUTS["llama"]


def params_from_state_dict(sd: dict, spec: DecoderSpec, *, dtype=torch.bfloat16,
                           device="cpu") -> dict:
    """{HF name: numpy array} -> port params, tensors of ``dtype`` on
    ``device``. Dense linears, factored ones (``<name>.ALinear`` /
    ``.BLinear``, bias on ALinear) and int8 / packed-int4 factored ones
    (``<name>.A_qweight`` ..., bias on ``<name>.bias``) load."""
    if isinstance(dtype, str):
        dtype = DTYPES[dtype]
    layout = HF_LAYOUTS[spec.family]

    def t(name):
        return torch.from_numpy(np.ascontiguousarray(sd[name])).to(
            device=device, dtype=dtype)

    def opt_t(name):
        return t(name) if name in sd else None

    def raw(name, dt):
        return torch.from_numpy(np.ascontiguousarray(sd[name])).to(
            device=device, dtype=dt)

    def linear(prefix):
        if f"{prefix}.weight" in sd:
            return dense_leaf(t(f"{prefix}.weight"), opt_t(f"{prefix}.bias"))
        if f"{prefix}.ALinear.weight" in sd:
            return lowrank_leaf(t(f"{prefix}.ALinear.weight"),
                                t(f"{prefix}.BLinear.weight"),
                                opt_t(f"{prefix}.ALinear.bias"))
        # int8 / packed-int4 factors (the JAX package's hf_repo.py buffer
        # names): codes keep their integer type, scales stay f32
        if f"{prefix}.A_scale" in sd:
            return q8_lowrank_leaf(raw(f"{prefix}.A_qweight", torch.int8),
                                   raw(f"{prefix}.A_scale", torch.float32),
                                   raw(f"{prefix}.A_zero", torch.float32),
                                   raw(f"{prefix}.B_qweight", torch.int8),
                                   raw(f"{prefix}.B_scale", torch.float32),
                                   raw(f"{prefix}.B_zero", torch.float32),
                                   opt_t(f"{prefix}.bias"))
        if f"{prefix}.A_qweight" in sd:
            return q4_lowrank_leaf(raw(f"{prefix}.A_qweight", torch.uint8),
                                   raw(f"{prefix}.A_scales", torch.float32),
                                   raw(f"{prefix}.A_zero_scales", torch.float32),
                                   raw(f"{prefix}.B_qweight", torch.uint8),
                                   raw(f"{prefix}.B_scales", torch.float32),
                                   raw(f"{prefix}.B_zero_scales", torch.float32),
                                   opt_t(f"{prefix}.bias"))
        raise KeyError(f"no weights for linear {prefix!r} in state dict")

    def norm(prefix):
        return {"w": t(f"{prefix}.weight"), "b": opt_t(f"{prefix}.bias")}

    params: dict = {"embed_tokens": t(f"{layout['embed']}.weight")}
    if spec.pos_emb == "learned":
        params["embed_positions"] = t(f"{layout['embed_positions']}.weight")
    if "model.decoder.project_in.weight" in sd:
        params["project_in"] = linear("model.decoder.project_in")
        params["project_out"] = linear("model.decoder.project_out")
    layers = []
    for i in range(spec.num_layers):
        pfx = layout["layers"].format(i=i)
        layer = {key: linear(f"{pfx}.{layout['linears'][key]}")
                 for key in layer_linear_keys(spec)}
        for nkey, sub in layout["norms"].items():
            layer[nkey] = norm(f"{pfx}.{sub}")
        layers.append(layer)
    params["layers"] = layers
    params["final_norm"] = norm(layout["final_norm"]) \
        if f"{layout['final_norm']}.weight" in sd else None
    # a factored head loads whatever the tie says: compressing a tied head
    # makes it a leaf of its own (registry.set_linear). The JAX package's
    # loader reads only "lm_head.weight", so it drops a factored head.
    factored_head = "lm_head.ALinear.weight" in sd or "lm_head.A_qweight" in sd
    params["lm_head"] = linear("lm_head") if factored_head or (
        not spec.tie_word_embeddings and "lm_head.weight" in sd) else None
    return params


def load_model(model_dir: str, dtype="bfloat16", device=None):
    """(params, spec, tokenizer info) from a local checkpoint directory.

    The tokenizer info is a namespace with the ids the pipeline reads from
    a tokenizer (``bos_token_id``, ``eos_token_id``) taken from
    ``config.json``; text tokenization is not part of this slice."""
    if not os.path.isdir(model_dir):
        raise NotImplementedError(
            f"{model_dir!r} is not a local checkpoint directory; loading hub "
            "ids is still to port (ROADMAP queue 1)")
    from asvd4llm_tpu_torch.utils.tensorio import load_safetensors_state_dict

    device = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        config = json.load(f)
    spec = spec_from_hf_config(config)
    sd = load_safetensors_state_dict(model_dir, to_f32=True)
    params = params_from_state_dict(sd, spec, dtype=dtype, device=device)
    tokenizer = SimpleNamespace(name_or_path=model_dir,
                                bos_token_id=config.get("bos_token_id"),
                                eos_token_id=config.get("eos_token_id"))
    return params, spec, tokenizer
