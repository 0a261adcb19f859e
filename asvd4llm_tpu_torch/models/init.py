"""Random parameter initialization for a DecoderSpec (demo, smoke and test
use; real runs load a checkpoint through models/loader.py)."""

from __future__ import annotations

import torch

from asvd4llm_tpu_torch.models.registry import dense_leaf
from asvd4llm_tpu_torch.models.spec import DecoderSpec


def linear_shapes(spec: DecoderSpec) -> dict:
    """{layer linear key: (out, in)}."""
    H, Q, KV, I = (spec.hidden_size, spec.q_dim, spec.kv_dim,
                   spec.intermediate_size)
    if spec.mlp == "gated":
        return {"q_proj": (Q, H), "k_proj": (KV, H), "v_proj": (KV, H),
                "o_proj": (H, Q), "gate_proj": (I, H), "up_proj": (I, H),
                "down_proj": (H, I)}
    return {"q_proj": (Q, H), "k_proj": (KV, H), "v_proj": (KV, H),
            "out_proj": (H, Q), "fc1": (I, H), "fc2": (H, I)}


def norm_keys(spec: DecoderSpec) -> list[str]:
    keys = ["ln1", "ln2"]
    if spec.post_attn_out_norm:
        keys.append("ln1_post")
    if spec.post_mlp_out_norm:
        keys.append("ln2_post")
    return keys


def init_params(spec: DecoderSpec, generator: torch.Generator,
                dtype=torch.bfloat16, device="cpu") -> dict:
    """He-ish scaled random params in the layout of the loaders. The
    generator must live on ``device``."""
    H = spec.hidden_size
    shapes = linear_shapes(spec)

    def normal(*shape, std):
        return (torch.randn(shape, generator=generator, device=device) * std
                ).to(dtype)

    def norm_leaf():
        return {"w": torch.ones((H,), dtype=dtype, device=device),
                "b": torch.zeros((H,), dtype=dtype, device=device)
                if spec.norm == "layernorm" else None}

    params: dict = {"embed_tokens": normal(spec.vocab_size, H, std=0.02)}
    if spec.pos_emb == "learned":
        params["embed_positions"] = normal(
            spec.max_position_embeddings + spec.pos_offset, H, std=0.02)
    layers = []
    for _ in range(spec.num_layers):
        layer: dict = {}
        for k, (o, i) in shapes.items():
            has_bias = spec.mlp_bias if k in ("fc1", "fc2", "gate_proj",
                                              "up_proj", "down_proj") \
                else spec.attn_bias
            layer[k] = dense_leaf(
                normal(o, i, std=i ** -0.5),
                torch.zeros((o,), dtype=dtype, device=device) if has_bias else None)
        for nk in norm_keys(spec):
            layer[nk] = norm_leaf()
        layers.append(layer)
    params["layers"] = layers
    params["final_norm"] = norm_leaf() if spec.final_norm else None
    params["lm_head"] = None if spec.tie_word_embeddings else dense_leaf(
        normal(spec.vocab_size, H, std=0.02), None)
    return params
