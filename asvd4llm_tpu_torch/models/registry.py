"""Linear-layer registry over the params dict.

The reference discovers compressible layers by walking the nn.Module tree
for isinstance(nn.Linear) and mutating modules in place
(ref sensitivity.py:19-33, binary_search.py:11-27). Here params are a plain
dict of tensors mirroring the JAX package's pytree; a "linear" is a leaf
dict and substitution is functional (shallow copies, tensors shared).

Leaf encodings (structure, not tags):
  dense:    {"w": [out, in], "b": [out] | None}
  lowrank:  {"A": [out, rank], "B": [rank, in], "b": [out] | None}
  q8 / q4:  the deployment formats below (q8_lowrank_leaf, q4_lowrank_leaf)

Full names follow HF module naming so sensitivity dicts and rank manifests
read like the reference's (e.g. "model.layers.3.self_attn.q_proj",
"model.decoder.layers.0.fc1").
"""

from __future__ import annotations

from typing import Iterator


def dense_leaf(w, b=None) -> dict:
    return {"w": w, "b": b}


def lowrank_leaf(a, b_factor, bias=None) -> dict:
    return {"A": a, "B": b_factor, "b": bias}


def is_lowrank(leaf: dict) -> bool:
    return "A" in leaf


def q8_lowrank_leaf(a8, a_scale, a_zero, b8, b_scale, b_zero, bias=None
                    ) -> dict:
    """Int8-quantized low-rank leaf: factor codes + per-row (scale, zero),
    f32 [rows, 1]. The deployment format of the fused q8 kernel
    (ops/fused_lowrank_q.py)."""
    return {"A8": a8, "Asc": a_scale, "Azp": a_zero,
            "B8": b8, "Bsc": b_scale, "Bzp": b_zero, "b": bias}


def is_q8_lowrank(leaf: dict) -> bool:
    return "A8" in leaf


def q4_lowrank_leaf(a4, a_scale, a_zscale, b4, b_scale, b_zscale, bias=None
                    ) -> dict:
    """Int4-packed low-rank leaf: 2 codes/byte + per-(row, group) scales
    (deployment format of the fused q4 kernel, ops/fused_lowrank_q.py; the
    reference's analogue is the AWQ w4 GEMM path, ref quantization.py:269).
    A4: [N, Rp/2] uint8, Asc/Azs: [N, Rp/group];
    B4: [Rp, Kp/2] uint8, Bsc/Bzs: [Rp, Kp/group]."""
    return {"A4": a4, "Asc": a_scale, "Azs": a_zscale,
            "B4": b4, "Bsc": b_scale, "Bzs": b_zscale, "b": bias}


def is_q4_lowrank(leaf: dict) -> bool:
    return "A4" in leaf


def leaf_shape(leaf: dict) -> tuple[int, int]:
    """(out_features, in_features) of any encoding. (q4: in_features is the
    512-padded K the codes were packed at — deployment leaves never feed
    the search's accounting, which runs before quantization.)"""
    if is_q4_lowrank(leaf):
        return leaf["Asc"].shape[0], leaf["B4"].shape[1] * 2
    if is_q8_lowrank(leaf):
        return leaf["A8"].shape[0], leaf["B8"].shape[1]
    if is_lowrank(leaf):
        return leaf["A"].shape[0], leaf["B"].shape[1]
    return tuple(leaf["w"].shape)


def leaf_n_params(leaf: dict) -> int:
    if is_q4_lowrank(leaf):
        return leaf["A4"].numel() + leaf["B4"].numel()  # packed bytes = 2 params
    if is_q8_lowrank(leaf):
        return leaf["A8"].numel() + leaf["B8"].numel()
    if is_lowrank(leaf):
        return leaf["A"].numel() + leaf["B"].numel()
    return leaf["w"].numel()


# Per-family linear key sets inside one decoder layer, in HF child order.
GATED_MLP_KEYS = ("q_proj", "k_proj", "v_proj", "o_proj",
                  "gate_proj", "up_proj", "down_proj")
PLAIN_MLP_KEYS = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")


def layer_linear_keys(spec) -> tuple[str, ...]:
    return GATED_MLP_KEYS if spec.mlp == "gated" else PLAIN_MLP_KEYS


def _layer_prefix(spec, i: int) -> str:
    if spec.family == "opt":
        return f"model.decoder.layers.{i}"
    return f"model.layers.{i}"


def _hf_subname(spec, key: str) -> str:
    if key in ("fc1", "fc2"):
        return key
    if key in ("gate_proj", "up_proj", "down_proj"):
        return f"mlp.{key}"
    return f"self_attn.{key}"


def linear_name(spec, layer_idx: int, key: str) -> str:
    return f"{_layer_prefix(spec, layer_idx)}.{_hf_subname(spec, key)}"


def parse_linear_name(spec, name: str) -> tuple[int, str]:
    """Inverse of linear_name -> (layer_idx, key)."""
    parts = name.split(".")
    idx = parts.index("layers") + 1
    return int(parts[idx]), parts[-1]


# Non-decoder linears the reference's isinstance(nn.Linear) walk also
# covers (ref sensitivity.py:19-33 starts from `modules=[model]`): the
# lm_head (even when weight-tied — torch keeps a tied nn.Linear module,
# which the reference factorizes, silently breaking the tie for the head
# only) and OPT-350m's project_in/project_out.
LM_HEAD_NAME = "lm_head"
PROJECT_IN_NAME = "model.decoder.project_in"
PROJECT_OUT_NAME = "model.decoder.project_out"


def extra_linear_names(params: dict, spec) -> list[str]:
    names = []
    if params.get("project_in") is not None:
        names += [PROJECT_IN_NAME, PROJECT_OUT_NAME]
    names.append(LM_HEAD_NAME)
    return names


def linear_names(params: dict, spec, include_extras: bool = False) -> list[str]:
    names = [linear_name(spec, i, k)
             for i in range(len(params["layers"]))
             for k in layer_linear_keys(spec)]
    if include_extras:
        names += extra_linear_names(params, spec)
    return names


def iter_linears(params: dict, spec, include_extras: bool = False
                 ) -> Iterator[tuple[str, dict]]:
    """Yield (full_name, leaf) for every compressible linear.

    include_extras=True matches the reference's walk over EVERY nn.Linear
    (lm_head + OPT project_in/out, ref sensitivity.py:19-33); False limits
    the scope to decoder-layer projections."""
    for i, layer in enumerate(params["layers"]):
        for k in layer_linear_keys(spec):
            yield linear_name(spec, i, k), layer[k]
    if include_extras:
        for name in extra_linear_names(params, spec):
            yield name, get_linear(params, spec, name)


def reference_walk_order(params: dict, spec, names) -> list[str]:
    """Arrange `names` in the reference's stack-DFS nn.Module walk order
    (ref sensitivity.py:14-33 / binary_search.py:14-27): the LIFO stack
    pops the most-recently-pushed module first, so lm_head (a direct child
    of the CausalLM root) is recorded FIRST, decoder layers are visited
    DESCENDING, and within a llama-family layer the mlp's linears
    (pushed after self_attn, popped before it) precede the attention's;
    OPT records fc1/fc2 during the layer's own iteration and k/v/q/out
    when its self_attn pops (verified against transformers 4.x modules).

    The binary search's stable PPL sort and its naive float accumulation
    of compressed params are both sensitive to this order at exact ties /
    knife-edge targets, so bit-parity with the reference requires walking
    in its order, not ours."""
    if spec.family == "opt":
        per_layer = ("fc1", "fc2", "k_proj", "v_proj", "q_proj", "out_proj")
        extras = [LM_HEAD_NAME, PROJECT_OUT_NAME, PROJECT_IN_NAME]
    else:
        per_layer = ("gate_proj", "up_proj", "down_proj",
                     "q_proj", "k_proj", "v_proj", "o_proj")
        extras = [LM_HEAD_NAME]
    full: list[str] = list(extras)
    for i in reversed(range(len(params["layers"]))):
        full += [linear_name(spec, i, k) for k in per_layer]
    names_set = set(names)
    ordered = [n for n in full if n in names_set]
    # defensive: unknown names keep their incoming relative order at the end
    ordered += [n for n in names if n not in set(ordered)]
    return ordered


def get_linear(params: dict, spec, name: str) -> dict:
    if name == LM_HEAD_NAME:
        head = params.get("lm_head")
        if head is None:  # tied: the head weight IS the embedding matrix
            return dense_leaf(params["embed_tokens"], None)
        return head
    if name in (PROJECT_IN_NAME, PROJECT_OUT_NAME):
        return params[name.rsplit(".", 1)[-1]]
    i, key = parse_linear_name(spec, name)
    return params["layers"][i][key]


def set_linear(params: dict, spec, name: str, leaf: dict) -> dict:
    """Functional substitution: returns a new params dict with one leaf
    replaced (shallow-copies only the touched path)."""
    if name == LM_HEAD_NAME:
        out = dict(params)
        # compressing a tied head materializes an explicit (low-rank)
        # lm_head leaf and leaves the embedding dense — the reference's
        # SVDLinear swap-in has the same tie-breaking effect
        out["lm_head"] = leaf
        return out
    if name in (PROJECT_IN_NAME, PROJECT_OUT_NAME):
        out = dict(params)
        out[name.rsplit(".", 1)[-1]] = leaf
        return out
    i, key = parse_linear_name(spec, name)
    layers = list(params["layers"])
    layer = dict(layers[i])
    layer[key] = leaf
    layers[i] = layer
    out = dict(params)
    out["layers"] = layers
    return out


def count_linear_params(params: dict, spec, include_extras: bool = False) -> int:
    return sum(leaf_n_params(leaf)
               for _, leaf in iter_linears(params, spec, include_extras))
