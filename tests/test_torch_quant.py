"""PyTorch port vs JAX package for quantization, on the CPU: the
quantizers, the AWQ search, the deployment conversions, the plain versions
of kernels 3 and 4 (what a CPU tensor takes) against the JAX wrappers in
interpret mode and on their dequantize fallback, quantized leaves through
the decoder, the decode step and generation, the loader, and the pipeline's
quantization modes end to end. The CUDA kernels themselves are held
against these plain versions on a card by tests/test_torch_cuda.py.

Tolerances: integer codes bit-identical; scales and zeros rtol 1e-6; fake-
quant weights rtol 1e-5. Where the two packages' f32 `log` differ in the
last bit (XLA's CPU log is its own approximation: about a fifth of the AWQ
scale exponents differ by one ulp), a value sitting on a rounding boundary
can land one code apart: the AWQ search and the AWQ-folded int4 conversion
allow at most 0.1% of codes one step apart, all others within rtol 1e-5.
Kernel plain versions and forwards in f32: atol/rtol 1e-4 (summation order,
and the kernels' raw-code form against the JAX fallback's dequantized
factors). Pipelines: manifests equal, PPL rtol 1e-3 (as
tests/test_torch_e2e.py).
"""

import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from asvd4llm_tpu import config as jconfig  # noqa: E402
from asvd4llm_tpu import pipeline as jpipe  # noqa: E402
from asvd4llm_tpu.eval import generate as jgen  # noqa: E402
from asvd4llm_tpu.models import decoder as jdec  # noqa: E402
from asvd4llm_tpu.models import registry as jreg  # noqa: E402
from asvd4llm_tpu.models.loader import load_model_native  # noqa: E402
from asvd4llm_tpu.ops import awq as jawq  # noqa: E402
from asvd4llm_tpu.ops import pallas_lowrank as jpl  # noqa: E402
from asvd4llm_tpu.ops import quant as jq  # noqa: E402
from asvd4llm_tpu.ops import quant_apply as jqa  # noqa: E402
from asvd4llm_tpu_torch import cli as tcli  # noqa: E402
from asvd4llm_tpu_torch.eval import generate as tgen  # noqa: E402
from asvd4llm_tpu_torch.models import decoder as tdec  # noqa: E402
from asvd4llm_tpu_torch.models.convert import params_from_numpy, params_to_numpy  # noqa: E402
from asvd4llm_tpu_torch.models.loader import load_model  # noqa: E402
from asvd4llm_tpu_torch.ops import awq as tawq  # noqa: E402
from asvd4llm_tpu_torch.ops import fused_lowrank_q as fq  # noqa: E402
from asvd4llm_tpu_torch.ops import quant as tq  # noqa: E402
from asvd4llm_tpu_torch.ops import quant_apply as tqa  # noqa: E402
from asvd4llm_tpu_torch.utils import tensorio  # noqa: E402
from asvd4llm_tpu_torch.utils.testing import write_random_checkpoint  # noqa: E402
from test_torch_pipeline import SEQLEN, TINY_LLAMA  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(a):
    return np.asarray(a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a)


def _close_but_few_steps(got, want, step, frac=1e-3):
    """All of `got` within rtol 1e-5 of `want`, except at most `frac` of the
    entries, which may be one quantization `step` (broadcastable) apart."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    step = np.broadcast_to(np.asarray(step, np.float64), got.shape)
    off = ~np.isclose(got, want, rtol=1e-5, atol=1e-7)
    assert off.mean() <= frac, f"{off.sum()} of {off.size} entries differ"
    np.testing.assert_array_less(np.abs(got - want)[off], 1.01 * step[off] + 1e-7)


# ------------------------------------------------------------ quantizers ----

@pytest.mark.parametrize("bits", [8, 6, 4])
def test_quantize_to_int_bit_identical(bits):
    w = np.random.RandomState(bits).randn(48, 300).astype(np.float32)
    w[3] = 0.0  # a degenerate row
    jcodes, jqp = jq.quantize_to_int(jnp.asarray(w), bits)
    tcodes, tqp = tq.quantize_to_int(_t(w), bits)
    assert tcodes.dtype == torch.int8
    np.testing.assert_array_equal(_n(tcodes), _n(jcodes))
    np.testing.assert_allclose(_n(tqp.scale), _n(jqp.scale), rtol=1e-6)
    np.testing.assert_allclose(_n(tqp.zero), _n(jqp.zero), rtol=1e-6)
    np.testing.assert_allclose(_n(tq.dequantize(tcodes, tqp)),
                               _n(jq.dequantize(jcodes, jqp)), rtol=1e-6)


@pytest.mark.parametrize("group,cols", [(128, 1000), (64, 512), (16, 700), (256, 1536)])
def test_int4_grouped_and_packing_bit_identical(group, cols):
    w = (np.random.RandomState(group).randn(24, cols) * 0.05).astype(np.float32)
    w[:, :group] = 0.0  # degenerate groups quantize to scale 0
    jp, js, jz = jq.quantize_to_int4_grouped(jnp.asarray(w), group=group)
    tp, ts, tz = tq.quantize_to_int4_grouped(_t(w), group=group)
    assert tp.dtype == torch.uint8 and tp.shape == jp.shape
    np.testing.assert_array_equal(_n(tp), _n(jp))
    np.testing.assert_allclose(_n(ts), _n(js), rtol=1e-6)
    np.testing.assert_allclose(_n(tz), _n(jz), rtol=1e-6)
    codes = np.random.RandomState(1).randint(0, 16, (5, 1024)).astype(np.uint8)
    packed = tq.pack_int4(_t(codes))
    np.testing.assert_array_equal(_n(packed), _n(jq.pack_int4(jnp.asarray(codes))))
    np.testing.assert_array_equal(_n(tq.unpack_int4(packed)), codes)
    np.testing.assert_allclose(
        _n(tq.dequantize_int4_grouped(tp, ts, tz, group=group)),
        _n(jq.dequantize_int4_grouped(jp, js, jz, group=group)), rtol=1e-6)


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("mse", [False, True])
def test_rtn_quantize_weight_matches_jax(bits, mse):
    w = np.random.RandomState(bits).standard_t(df=3, size=(32, 200)).astype(np.float32)
    np.testing.assert_allclose(_n(tq.rtn_quantize_weight(_t(w), bits, mse=mse)),
                               _n(jq.rtn_quantize_weight(jnp.asarray(w), bits, mse=mse)),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("in_f", [256, 200])
def test_groupwise_fake_quant_and_awq_search_match_jax(bits, in_f):
    rng = np.random.RandomState(bits + in_f)
    w = rng.randn(40, in_f).astype(np.float32)
    act = np.abs(rng.randn(in_f)).astype(np.float32) * 3
    np.testing.assert_allclose(_n(tawq.groupwise_fake_quant(_t(w), bits)),
                               _n(jawq.groupwise_fake_quant(jnp.asarray(w), bits)),
                               rtol=1e-5, atol=1e-7)
    got = _n(tawq.awq_search_and_quant(_t(w), _t(act), bits=bits))
    want = _n(jawq.awq_search_and_quant(jnp.asarray(w), jnp.asarray(act), bits=bits))
    # a code step of Q(W·s)/s in column j is at most the range of W·s over
    # its group, over maxq, divided by s_j; bound it over every alpha
    x = np.maximum(act, 1e-8)
    steps = []
    for i in range(jawq.N_GRID):
        s = x ** (i / jawq.N_GRID)
        s = s / np.exp(np.mean(np.log(s)))
        steps.append(2 * np.abs(w).max() * s.max() / (2 ** bits - 1) / s)
    _close_but_few_steps(got, want, np.max(steps, axis=0)[None, :])


# --------------------------------------------------- deployment conversion ----

def _tiny_params_with_lowrank():
    """The JAX package's tiny Llama with low-rank leaves (rank not a
    multiple of 16 on some), and its port copy; plus calibration-like
    stats for the AWQ fold."""
    from asvd4llm_tpu.models.init import init_params
    from asvd4llm_tpu.models.spec import llama_spec
    from asvd4llm_tpu.ops.asvd import factorize_linear

    spec = llama_spec(vocab_size=128, hidden_size=64, intermediate_size=160,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                      max_position_embeddings=64)
    params = init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    names = ["model.layers.0.self_attn.q_proj", "model.layers.0.self_attn.k_proj",
             "model.layers.1.mlp.down_proj", "lm_head"]
    for name, ratio in zip(names, (0.5, 0.4, 0.5, 0.5)):
        leaf = jreg.get_linear(params, spec, name)
        f = factorize_linear(leaf["w"], leaf["b"], ratio, backend="exact")
        params = jreg.set_linear(params, spec, name, jreg.lowrank_leaf(f.A, f.B, f.bias))
    rng = np.random.RandomState(7)
    stats = {n: np.abs(rng.randn(jreg.leaf_shape(leaf)[1])).astype(np.float32) + 0.1
             for n, leaf in jreg.iter_linears(params, spec, include_extras=True)}
    tparams = params_from_numpy(jax.tree.map(np.asarray, params))
    return params, tparams, spec, stats


@pytest.fixture(scope="module")
def tiny():
    return _tiny_params_with_lowrank()


@pytest.fixture(scope="module")
def jax_deployed(tiny):
    """The tiny model converted by the JAX package: {"int8": ..., "int4": ...}
    (int4 at group 64)."""
    jparams, _, spec, _ = tiny
    return {"int8": jqa.quantize_lowrank_factors_int8(jparams, spec),
            "int4": jqa.quantize_lowrank_factors_int4(jparams, spec, group=64)}


def test_int8_conversion_bit_identical(tiny, jax_deployed):
    _, tparams, spec, _ = tiny
    jout = jax_deployed["int8"]
    tout = tqa.quantize_lowrank_factors_int8(tparams, spec)
    n = 0
    for (name, jl), (_, tl) in zip(jreg.iter_linears(jout, spec, include_extras=True),
                                   jreg.iter_linears(tout, spec, include_extras=True)):
        assert set(jl) == set(tl), name
        if "A8" in jl:
            n += 1
            for k in ("A8", "B8"):
                np.testing.assert_array_equal(_n(tl[k]), _n(jl[k]), err_msg=name)
            for k in ("Asc", "Azp", "Bsc", "Bzp"):
                np.testing.assert_allclose(_n(tl[k]), _n(jl[k]), rtol=1e-6, err_msg=name)
    assert n == 4  # lm_head included


@pytest.mark.parametrize("awq_fold", [True, False])
def test_int4_conversion_matches_jax(tiny, awq_fold):
    jparams, tparams, spec, stats = tiny
    jout = jqa.quantize_lowrank_factors_int4(jparams, spec, group=64,
                                             stats={k: jnp.asarray(v) for k, v in stats.items()},
                                             awq_fold=awq_fold)
    tout = tqa.quantize_lowrank_factors_int4(tparams, spec, group=64,
                                             stats={k: _t(v) for k, v in stats.items()},
                                             awq_fold=awq_fold)
    n = 0
    for (name, jl), (_, tl) in zip(jreg.iter_linears(jout, spec, include_extras=True),
                                   jreg.iter_linears(tout, spec, include_extras=True)):
        assert set(jl) == set(tl), name
        if "A4" not in jl:
            continue
        n += 1
        for side in "AB":
            codes_j = _n(jq.unpack_int4(jl[f"{side}4"])).astype(int)
            codes_t = _n(tq.unpack_int4(tl[f"{side}4"])).astype(int)
            assert codes_t.shape == codes_j.shape, name
            assert np.abs(codes_t - codes_j).max() <= 1, name
            assert (codes_t != codes_j).mean() <= 1e-3, name
            sc = _n(jl[f"{side}sc"])
            got = _n(tq.dequantize_int4_grouped(tl[f"{side}4"], tl[f"{side}sc"],
                                                tl[f"{side}zs"], group=64))
            want = _n(jq.dequantize_int4_grouped(jl[f"{side}4"], jl[f"{side}sc"],
                                                 jl[f"{side}zs"], group=64))
            _close_but_few_steps(got, want, np.repeat(sc, 64, axis=1))
    assert n == 4


def test_params_from_numpy_keeps_quant_scales_f32(jax_deployed):
    for tree, codes in ((jax_deployed["int4"], ("A4", "B4")),
                        (jax_deployed["int8"], ("A8", "B8"))):
        t = params_from_numpy(jax.tree.map(np.asarray, tree), dtype=torch.bfloat16)
        leaf = t["layers"][0]["q_proj"]
        assert all(leaf[k].dtype == (torch.uint8 if "4" in k else torch.int8) for k in codes)
        assert all(v.dtype == torch.float32 for k, v in leaf.items()
                   if k not in codes and k != "b" and v is not None)
        assert t["layers"][0]["o_proj"]["w"].dtype == torch.bfloat16


# ------------------------------------------------ kernel 3 and 4 plain versions ----

def _q8_case(seed, M, K, N, R, bias):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    a8, aq = jq.quantize_to_int((rng.randn(N, R) * 0.1).astype(np.float32), 8)
    b8, bq = jq.quantize_to_int((rng.randn(R, K) * 0.1).astype(np.float32), 8)
    bv = rng.randn(N).astype(np.float32) if bias else None
    return x, a8, aq, b8, bq, bv


@pytest.mark.parametrize("M,K,N,R,bias,pad", [
    (8, 384, 256, 64, True, False),
    (3, 200, 130, 50, False, False),       # unaligned rank
    (8, 384, 200, 72, True, True),         # pre-padded codes
    (16, 512, 512, 128, False, True),
])
def test_fused_q8_plain_matches_jax(M, K, N, R, bias, pad):
    x, a8, aq, b8, bq, bv = _q8_case(M + K, M, K, N, R, bias)
    if pad:  # codes widened as the serving engine pre-pads them
        a8, b8 = jpl._pad2(a8, 512, 128), jpl._pad2(b8, 128, 512)
    jb = None if bv is None else jnp.asarray(bv)
    ref_i = _n(jpl.fused_lowrank_apply_q8(jnp.asarray(x), a8, aq, b8, bq, jb, interpret=True))
    ref_x = _n(jpl.fused_lowrank_apply_q8(jnp.asarray(x), a8, aq, b8, bq, jb))
    tqp = lambda qp: tq.QuantParams(_t(qp.scale), _t(qp.zero), 255)  # noqa: E731
    got = fq.fused_lowrank_apply_q8(_t(x), _t(a8), tqp(aq), _t(b8), tqp(bq),
                                    None if bv is None else _t(bv))
    assert got.shape == (M, N)
    np.testing.assert_allclose(_n(got), ref_i, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_n(got), ref_x, atol=1e-4, rtol=1e-4)


def _q4_case(seed, M, K, N, R, group, bias):
    rng = np.random.RandomState(seed)
    x = (rng.randn(M, K) * 0.3).astype(np.float32)
    a4, asc, azs = jq.quantize_to_int4_grouped((rng.randn(N, R) * 0.05).astype(np.float32),
                                               group=group)
    b4, bsc, bzs = jq.quantize_to_int4_grouped((rng.randn(R, K) * 0.05).astype(np.float32),
                                               group=group)
    rp = a4.shape[1] * 2 - R
    b4, bsc, bzs = (jnp.pad(v, ((0, rp), (0, 0))) for v in (b4, bsc, bzs))
    bv = (rng.randn(N) * 0.1).astype(np.float32) if bias else None
    return x, [a4, asc, azs, b4, bsc, bzs], bv


@pytest.mark.parametrize("M,K,N,R,group,bias,pad,interpret", [
    (4, 512, 520, 140, 128, True, False, True),
    (8, 1024, 256, 512, 64, False, True, True),   # pre-padded A4 rows
    (3, 512, 130, 50, 128, False, False, True),
    (4, 640, 520, 140, 128, True, False, False),  # K not a 512 multiple: JAX fallback only
    (5, 300, 100, 30, 64, True, False, False),
])
def test_fused_q4_plain_matches_jax(M, K, N, R, group, bias, pad, interpret):
    x, q, bv = _q4_case(M + K + R, M, K, N, R, group, bias)
    if pad:
        q[0] = jpl._pad2(q[0], -(-N // 512) * 512, q[0].shape[1])
    jb = None if bv is None else jnp.asarray(bv)
    ref = _n(jpl.fused_lowrank_apply_q4(jnp.asarray(x), *q, jb, group=group,
                                        interpret=interpret))
    got = fq.fused_lowrank_apply_q4(_t(x), *(_t(v) for v in q),
                                    None if bv is None else _t(bv), group=group)
    assert got.shape == (M, N)
    np.testing.assert_allclose(_n(got), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", ["q8", "q4"])
def test_quantized_large_m_is_dequant_and_two_matmuls(kind):
    """Above max_tokens the op is dequantize (to x's dtype) + the plain
    two-matmul path, as the JAX wrappers run above 1024 tokens."""
    from asvd4llm_tpu_torch.ops.lowrank import lowrank_apply
    if kind == "q8":
        x, a8, aq, b8, bq, bv = _q8_case(1, 40, 64, 48, 8, True)
        tqp = lambda qp: tq.QuantParams(_t(qp.scale), _t(qp.zero), 255)  # noqa: E731
        args = (_t(a8), tqp(aq), _t(b8), tqp(bq), _t(bv))
        got = fq.fused_lowrank_apply_q8(_t(x), *args, max_tokens=16)
        a, b = tq.dequantize(args[0], args[1]), tq.dequantize(args[2], args[3])
    else:
        x, q, bv = _q4_case(2, 40, 64, 48, 8, 64, True)
        args = [_t(v) for v in q]
        got = fq.fused_lowrank_apply_q4(_t(x), *args, _t(bv), group=64, max_tokens=16)
        a = tq.dequantize_int4_grouped(*args[:3], group=64)[:, :args[3].shape[0]]
        b = tq.dequantize_int4_grouped(*args[3:], group=64)[:, :64]
    np.testing.assert_array_equal(_n(got), _n(lowrank_apply(_t(x), a, b, _t(bv))))


# -------------------------------------------- decoder, decode step, generate ----

@pytest.mark.parametrize("deploy", ["int8", "int4"])
def test_quantized_leaves_through_decoder_and_generate(tiny, jax_deployed, deploy):
    """Quantized models from the JAX package, converted: forward logits, a
    decode step (dense caches: a quantized k/v leaf has no "A") and greedy
    tokens agree with the JAX package, with and without the kernels' plain
    versions."""
    spec = tiny[2]
    jq_params = jax_deployed[deploy]
    tq_params = params_from_numpy(jax.tree.map(np.asarray, jq_params))
    ids = np.random.RandomState(3).randint(0, 128, (2, 9))
    ref = _n(jdec.forward(jq_params, jnp.asarray(ids), spec))
    for up in (False, True):
        got = _n(tdec.forward(tq_params, _t(ids), spec, use_pallas=up))
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4, err_msg=str(up))

    jc = jgen.init_caches(jq_params, spec, 2, 12, jnp.float32, latent="kv")
    tc = tgen.init_caches(tq_params, spec, 2, 12, torch.float32, latent="kv")
    assert all("k" in c and "v" in c for c in tc)
    _, jc = jgen.prefill(jq_params, spec, jnp.asarray(ids), jc)
    _, tc = tgen.prefill_host(tq_params, spec, _t(ids), tc, latent="kv")
    tok = ids[:, -1:]
    jlog, _ = jgen.decode_step(jq_params, spec, jnp.asarray(tok), jc, 9)
    for up in (False, True):
        c = [{k: v.clone() for k, v in cc.items()} for cc in tc]
        tlog, _ = tgen.decode_step(tq_params, spec, _t(tok), c, 9, use_pallas=up)
        np.testing.assert_allclose(_n(tlog), _n(jlog), atol=1e-4, rtol=1e-4)

    want = jgen.generate(jq_params, spec, ids[:, :5], max_new_tokens=5)
    for up in (False, True):
        got = tgen.generate(tq_params, spec, ids[:, :5], max_new_tokens=5, use_pallas=up)
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------- loader ----

def test_loader_reads_quantized_state_dicts(tmp_path, tiny, jax_deployed):
    """A checkpoint holding q8 and q4 leaves (the JAX package's HF buffer
    names), written with the port's safetensors writer: the port's loader
    and the JAX package's native loader read the same pytree, codes in
    their integer types and scales in f32 even for a bf16 load. The one
    difference is the factored head: the JAX loader reads a head only from
    ``lm_head.weight`` and drops it (ROADMAP §3); the port loads it."""
    jparams, _, spec, _ = tiny
    q8, q4 = jax_deployed["int8"], jax_deployed["int4"]
    sd = {"model.embed_tokens.weight": jparams["embed_tokens"],
          "model.norm.weight": jparams["final_norm"]["w"]}
    for i, layer in enumerate(jparams["layers"]):
        for key, sub in (("ln1", "input_layernorm"), ("ln2", "post_attention_layernorm")):
            sd[f"model.layers.{i}.{sub}.weight"] = layer[key]["w"]
    for n, (name, leaf) in enumerate(jreg.iter_linears(jparams, spec, include_extras=True)):
        if "A" not in leaf:
            sd[f"{name}.weight"] = leaf["w"]
        elif n % 2:
            ql = jreg.get_linear(q8, spec, name)
            sd.update({f"{name}.A_qweight": ql["A8"], f"{name}.A_scale": ql["Asc"],
                       f"{name}.A_zero": ql["Azp"], f"{name}.B_qweight": ql["B8"],
                       f"{name}.B_scale": ql["Bsc"], f"{name}.B_zero": ql["Bzp"]})
        else:
            ql = jreg.get_linear(q4, spec, name)
            sd.update({f"{name}.A_qweight": ql["A4"], f"{name}.A_scales": ql["Asc"],
                       f"{name}.A_zero_scales": ql["Azs"], f"{name}.B_qweight": ql["B4"],
                       f"{name}.B_scales": ql["Bsc"], f"{name}.B_zero_scales": ql["Bzs"]})
    sd["model.layers.0.self_attn.q_proj.bias"] = np.linspace(-1, 1, 64, dtype=np.float32)
    ckpt = tmp_path / "q"
    ckpt.mkdir()
    tensorio.save_safetensors(str(ckpt / "model.safetensors"),
                              {k: np.asarray(v) for k, v in sd.items()})
    with open(ckpt / "config.json", "w") as f:
        json.dump(dict(TINY_LLAMA, hidden_size=64, intermediate_size=160,
                       num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                       vocab_size=128, max_position_embeddings=64), f)
    jp, _ = load_model_native(str(ckpt), dtype=jnp.float32)
    tp, _, _ = load_model(str(ckpt), dtype="float32", device="cpu")
    assert jp["lm_head"] is None and "lm_head.A_qweight" in sd
    head = params_to_numpy(tp["lm_head"])
    want = jreg.get_linear(q8 if "lm_head.A_scale" in sd else q4, spec, "lm_head")
    assert head.keys() == want.keys()
    for k, v in want.items():
        if v is None:
            assert head[k] is None, k
        else:
            np.testing.assert_array_equal(head[k], np.asarray(v), err_msg=k)
    jl = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jp))[0]
    tl = jax.tree_util.tree_flatten_with_path(params_to_numpy(dict(tp, lm_head=None)))[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, j), (_, t) in zip(jl, tl):
        assert j.dtype == t.dtype, path
        np.testing.assert_array_equal(t, j, err_msg=str(path))
    kinds = {k for layer in tp["layers"] for leaf in layer.values() for k in leaf}
    assert {"A8", "A4"} <= kinds
    tb, _, _ = load_model(str(ckpt), dtype="bfloat16", device="cpu")
    q_leaf = tb["layers"][0]["q_proj"]
    assert q_leaf["b"].dtype == torch.bfloat16
    assert all(q_leaf[k].dtype == torch.float32 for k in q_leaf if k[1:] in ("sc", "zp", "zs"))


# ------------------------------------------------------------- pipeline ----

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_random_checkpoint(str(tmp_path_factory.mktemp("ckpt")),
                                   TINY_LLAMA, seed=3, dtype="float32")


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """One cache directory per package, shared by the four modes: the
    quantization flags are outside the sensitivity key, so the modes after
    the first reuse the scan, as a user's sweep does."""
    return tmp_path_factory.mktemp("jcache"), tmp_path_factory.mktemp("tcache")


@pytest.mark.parametrize("quant", [
    {"deploy_int8_factors": True}, {"deploy_int4_factors": True},
    {"weight_quant": "rtn_int8"}, {"weight_quant": "awq_int4"},
], ids=["deploy_int8", "deploy_int4", "rtn_int8", "awq_int4"])
def test_pipeline_quant_modes_match_jax(ckpt, caches, tmp_path, quant, monkeypatch):
    # the JAX package's scan check reads leaf["w"] of a q4 leaf and raises
    # (asvd4llm_tpu/models/scan_forward.py:56 tests for "A8" only); a model
    # holding q4 leaves is never scannable, so answer that for it here
    from asvd4llm_tpu.models import scan_forward
    can_scan = scan_forward.can_scan
    monkeypatch.setattr(scan_forward, "can_scan", lambda p, s: not any(
        "A4" in leaf for layer in p["layers"] for leaf in layer.values()) and can_scan(p, s))
    common = dict(model_id=ckpt, act_aware=True, calib_dataset="synthetic",
                  eval_ppl="synthetic", n_calib_samples=4, seqlen=SEQLEN,
                  eval_dtype="float32", svd_backend="exact", param_ratio_target=0.8,
                  rank_align=2, int4_group_size=64, **quant)
    jcfg = jconfig.ASVDConfig(**common, cache_dir=str(caches[0]),
                              output_dir=str(tmp_path / "jo"))
    jp, jspec = load_model_native(ckpt, dtype=jnp.float32)
    jparams, jman, _ = jpipe.compress(jp, jspec, None, jcfg)
    jres = jpipe.evaluate(jparams, jspec, None, jcfg)

    argv = []
    for k, v in dict(common, cache_dir=str(caches[1]),
                     output_dir=str(tmp_path / "to")).items():
        argv += [f"--{k}"] if v is True else [f"--{k}", str(v)]
    out = tcli.main(argv, device="cpu")
    assert jman and out["manifest"] == jman
    np.testing.assert_allclose(out["results"]["synthetic"], jres["synthetic"], rtol=1e-3)
    phase = {"deploy_int8_factors": "deploy_int8", "deploy_int4_factors": "deploy_int4",
             "weight_quant": "weight_quant"}[next(iter(quant))]
    assert phase in out["phase_times"]
    if "weight_quant" not in quant:
        code = "A8" if "deploy_int8_factors" in quant else "A4"
        leaves = [leaf for _, leaf in jreg.iter_linears(out["params"], out["spec"],
                                                        include_extras=True)]
        assert sum(code in leaf for leaf in leaves) == len(jman)
        assert not any("A" in leaf for leaf in leaves)
    with open(os.path.join(tmp_path / "to", "results.jsonl")) as f:
        assert json.loads(f.readline())["config"][next(iter(quant))] == quant[next(iter(quant))]
