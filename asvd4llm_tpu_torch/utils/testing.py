"""Offline test and smoke assets: write a complete random checkpoint
(``config.json`` + one ``model.safetensors`` in HF naming) with numpy only.
The counterpart of asvd4llm_tpu/utils/testing.build_tiny_checkpoint,
without the tokenizer."""

from __future__ import annotations

import json
import os

import numpy as np

from asvd4llm_tpu_torch.models.loader import HF_LAYOUTS
from asvd4llm_tpu_torch.models.spec import spec_from_hf_config
from asvd4llm_tpu_torch.utils.tensorio import f32_to_bf16_bits, save_safetensors


def _random_state_dict(spec, rng) -> dict:
    """{HF name: f32 array} with He-ish scaled weights and unit norms."""
    from asvd4llm_tpu_torch.models.init import linear_shapes

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32) * np.float32(std))

    H = spec.hidden_size
    layout = HF_LAYOUTS[spec.family]
    sd = {f"{layout['embed']}.weight": normal((spec.vocab_size, H), 0.02)}
    if spec.pos_emb == "learned":
        sd[f"{layout['embed_positions']}.weight"] = normal(
            (spec.max_position_embeddings + spec.pos_offset, H), 0.02)
    for i in range(spec.num_layers):
        pfx = layout["layers"].format(i=i)
        for key, (o, n_in) in linear_shapes(spec).items():
            sub = layout["linears"][key]
            sd[f"{pfx}.{sub}.weight"] = normal((o, n_in), n_in ** -0.5)
            mlp = key in ("fc1", "fc2", "gate_proj", "up_proj", "down_proj")
            if spec.mlp_bias if mlp else spec.attn_bias:
                sd[f"{pfx}.{sub}.bias"] = np.zeros((o,), np.float32)
        for sub in layout["norms"].values():
            sd[f"{pfx}.{sub}.weight"] = np.ones((H,), np.float32)
            if spec.norm == "layernorm":
                sd[f"{pfx}.{sub}.bias"] = np.zeros((H,), np.float32)
    if spec.final_norm:
        sd[f"{layout['final_norm']}.weight"] = np.ones((H,), np.float32)
        if spec.norm == "layernorm":
            sd[f"{layout['final_norm']}.bias"] = np.zeros((H,), np.float32)
    if not spec.tie_word_embeddings:
        sd["lm_head.weight"] = normal((spec.vocab_size, H), 0.02)
    return sd


def write_random_checkpoint(path: str, config: dict, *, seed: int = 0,
                            dtype: str = "bfloat16") -> str:
    """Write ``config`` as ``config.json`` and random weights at its widths
    as ``model.safetensors`` (bf16 or f32) under ``path``."""
    os.makedirs(path, exist_ok=True)
    spec = spec_from_hf_config(config)
    sd = _random_state_dict(spec, np.random.default_rng(seed))
    if dtype == "bfloat16":
        sd = {k: f32_to_bf16_bits(v) for k, v in sd.items()}
        bf16 = frozenset(sd)
    elif dtype == "float32":
        bf16 = frozenset()
    else:
        raise ValueError(f"checkpoint dtype {dtype!r} not in bfloat16, float32")
    save_safetensors(os.path.join(path, "model.safetensors"), sd, bf16=bf16)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
    return path
