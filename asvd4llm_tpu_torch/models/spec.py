"""Architecture description for the one generic decoder implementation.

The reference supports any HF AutoModelForCausalLM via isinstance(nn.Linear)
tree walks, with OPT and Llama first-class and Gemma-2 exercised through the
generic path (ref quantization.py:160-163, experiments/gemma.sh,
huggingface_repos/). We support the same families from one functional
decoder parameterized by this spec instead of three forked model files.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace


@dataclass(frozen=True)
class DecoderSpec:
    family: str                      # "llama" | "opt" | "gemma2" | "gemma"
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    max_position_embeddings: int = 2048
    # positional encoding: "rope" (llama/gemma) or "learned" (opt, offset 2)
    pos_emb: str = "rope"
    rope_theta: float = 10000.0
    # norms: "rmsnorm" (llama/gemma) or "layernorm" (opt)
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    # mlp: "gated" (llama/gemma: gate*up->down) or "plain" (opt: fc1->fc2)
    mlp: str = "gated"
    act: str = "silu"                # "silu" | "relu" | "gelu" | "gelu_tanh"
    # biases on linears
    attn_bias: bool = False
    mlp_bias: bool = False
    tie_word_embeddings: bool = False
    # attention scale; None -> 1/sqrt(head_dim)
    attn_scale: float | None = None
    # --- gemma(-2) specifics ---
    embed_scale: float = 1.0         # gemma multiplies embeddings by sqrt(hidden)
    post_attn_out_norm: bool = False  # gemma2 post-norms around residual adds
    post_mlp_out_norm: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    sliding_window: int = 0          # 0 = disabled
    sliding_pattern: int = 2         # gemma2: every other layer is sliding
    rmsnorm_unit_offset: bool = False  # gemma rmsnorm uses (1 + w)
    # --- opt specifics ---
    pos_offset: int = 0              # OPT learned embeddings offset (=2)
    do_layer_norm_before: bool = True
    final_norm: bool = True
    # OPT-350m style: embeddings live in word_embed_proj_dim and are
    # projected in/out of hidden_size (0 = same as hidden, no projection)
    word_embed_proj_dim: int = 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_uses_sliding(self, layer_idx: int) -> bool:
        """Gemma-2 interleaves sliding/global attention (even layers sliding
        in HF's implementation: `not bool(layer_idx % 2)`)."""
        if self.sliding_window <= 0:
            return False
        return layer_idx % self.sliding_pattern != self.sliding_pattern - 1 \
            if self.sliding_pattern > 1 else True


def llama_spec(**kw) -> DecoderSpec:
    defaults = dict(
        family="llama", pos_emb="rope", norm="rmsnorm", mlp="gated",
        act="silu", attn_bias=False, mlp_bias=False,
    )
    defaults.update(kw)
    return DecoderSpec(**defaults)


def opt_spec(**kw) -> DecoderSpec:
    defaults = dict(
        family="opt", pos_emb="learned", pos_offset=2, norm="layernorm",
        norm_eps=1e-5, mlp="plain", act="relu", attn_bias=True, mlp_bias=True,
        tie_word_embeddings=True,
    )
    defaults.update(kw)
    return DecoderSpec(**defaults)


def gemma2_spec(**kw) -> DecoderSpec:
    defaults = dict(
        family="gemma2", pos_emb="rope", norm="rmsnorm", mlp="gated",
        act="gelu_tanh", attn_bias=False, mlp_bias=False,
        tie_word_embeddings=True, rmsnorm_unit_offset=True,
        post_attn_out_norm=True, post_mlp_out_norm=True,
    )
    defaults.update(kw)
    return DecoderSpec(**defaults)


def spec_from_hf_config(config) -> DecoderSpec:
    """Build a DecoderSpec from a checkpoint's ``config.json``, given as the
    parsed dict or as any namespace with the same attributes."""
    if isinstance(config, dict):
        config = SimpleNamespace(**config)
    mt = getattr(config, "model_type", "")
    if mt in ("llama", "mistral", "qwen2"):
        # mistral: sliding-window attention on EVERY layer; qwen2: q/k/v
        # biases (picked up from the state dict by the loader)
        sliding = getattr(config, "sliding_window", None) or 0
        return llama_spec(
            sliding_window=sliding if mt == "mistral" else 0,
            sliding_pattern=1,
            vocab_size=config.vocab_size,
            hidden_size=config.hidden_size,
            intermediate_size=config.intermediate_size,
            num_layers=config.num_hidden_layers,
            num_heads=config.num_attention_heads,
            num_kv_heads=getattr(config, "num_key_value_heads",
                                 config.num_attention_heads),
            head_dim=getattr(config, "head_dim", None)
            or config.hidden_size // config.num_attention_heads,
            max_position_embeddings=config.max_position_embeddings,
            rope_theta=getattr(config, "rope_theta", 10000.0),
            norm_eps=config.rms_norm_eps,
            tie_word_embeddings=getattr(config, "tie_word_embeddings", False),
            attn_bias=getattr(config, "attention_bias", False),
            mlp_bias=getattr(config, "mlp_bias", False),
        )
    if mt == "opt":
        return opt_spec(
            vocab_size=config.vocab_size,
            hidden_size=config.hidden_size,
            intermediate_size=config.ffn_dim,
            num_layers=config.num_hidden_layers,
            num_heads=config.num_attention_heads,
            num_kv_heads=config.num_attention_heads,
            head_dim=config.hidden_size // config.num_attention_heads,
            max_position_embeddings=config.max_position_embeddings,
            do_layer_norm_before=getattr(config, "do_layer_norm_before", True),
            act={"relu": "relu", "gelu": "gelu"}.get(
                getattr(config, "activation_function", "relu"), "relu"),
            tie_word_embeddings=getattr(config, "tie_word_embeddings", True),
            word_embed_proj_dim=(
                0 if getattr(config, "word_embed_proj_dim",
                             config.hidden_size) == config.hidden_size
                else config.word_embed_proj_dim),
            # OPT-350m (post-norm) has no final decoder layer norm
            final_norm=getattr(config, "do_layer_norm_before", True),
        )
    if mt == "gemma":
        return DecoderSpec(
            family="gemma", pos_emb="rope", norm="rmsnorm", mlp="gated",
            act="gelu_tanh", rmsnorm_unit_offset=True,
            tie_word_embeddings=True,
            vocab_size=config.vocab_size,
            hidden_size=config.hidden_size,
            intermediate_size=config.intermediate_size,
            num_layers=config.num_hidden_layers,
            num_heads=config.num_attention_heads,
            num_kv_heads=config.num_key_value_heads,
            head_dim=config.head_dim,
            max_position_embeddings=config.max_position_embeddings,
            rope_theta=getattr(config, "rope_theta", 10000.0),
            norm_eps=config.rms_norm_eps,
            embed_scale=config.hidden_size ** 0.5,
        )
    if mt == "gemma2":
        return gemma2_spec(
            vocab_size=config.vocab_size,
            hidden_size=config.hidden_size,
            intermediate_size=config.intermediate_size,
            num_layers=config.num_hidden_layers,
            num_heads=config.num_attention_heads,
            num_kv_heads=config.num_key_value_heads,
            head_dim=config.head_dim,
            max_position_embeddings=config.max_position_embeddings,
            rope_theta=getattr(config, "rope_theta", 10000.0),
            norm_eps=config.rms_norm_eps,
            embed_scale=config.hidden_size ** 0.5,
            attn_scale=getattr(config, "query_pre_attn_scalar",
                               config.head_dim) ** -0.5,
            attn_logit_softcap=getattr(config, "attn_logit_softcapping", 0.0) or 0.0,
            final_logit_softcap=getattr(config, "final_logit_softcapping", 0.0) or 0.0,
            sliding_window=getattr(config, "sliding_window", 0) or 0,
        )
    raise NotImplementedError(f"unsupported model_type {mt!r}")
