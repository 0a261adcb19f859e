"""PyTorch port vs JAX package around the pipeline, on a tiny random
checkpoint in float32 on the CPU: the synthetic corpora, the PPL
evaluators, the checkpoint reader and writer, the CLI's flags, the entry
points' device rule, and the port's isolation from JAX.

Tolerances: corpora and checkpoint round trips bit-exact; the evaluators
rtol 1e-5 (true-f32 contractions on both sides, summation order differs).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from asvd4llm_tpu import config as jconfig  # noqa: E402
from asvd4llm_tpu.data import datasets as jdata  # noqa: E402
from asvd4llm_tpu.eval import ppl as jppl  # noqa: E402
from asvd4llm_tpu.models.loader import load_model_native  # noqa: E402
from asvd4llm_tpu_torch import config as tconfig  # noqa: E402
from asvd4llm_tpu_torch import pipeline as tpipe  # noqa: E402
from asvd4llm_tpu_torch.data import datasets as tdata  # noqa: E402
from asvd4llm_tpu_torch.eval import ppl as tppl  # noqa: E402
from asvd4llm_tpu_torch.models.convert import params_from_numpy, params_to_numpy  # noqa: E402
from asvd4llm_tpu_torch.models.loader import load_model  # noqa: E402
from asvd4llm_tpu_torch.utils import tensorio  # noqa: E402
from asvd4llm_tpu_torch.utils.testing import write_random_checkpoint  # noqa: E402

TINY_LLAMA = {
    "model_type": "llama", "hidden_size": 32, "intermediate_size": 48,
    "num_attention_heads": 4, "num_key_value_heads": 2, "num_hidden_layers": 2,
    "vocab_size": 96, "max_position_embeddings": 128, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "tie_word_embeddings": False,
}
SEQLEN = 64


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_random_checkpoint(str(tmp_path_factory.mktemp("ckpt")),
                                   TINY_LLAMA, seed=3, dtype="float32")


def test_synthetic_corpora_bit_identical(tmp_path):
    np.testing.assert_array_equal(tdata.synthetic_token_corpus(5000, 97, seed=4),
                                  jdata.synthetic_token_corpus(5000, 97, seed=4))
    assert tdata.synthetic_text_corpus(3000, seed=2) == \
        jdata.synthetic_text_corpus(3000, seed=2)
    kw = dict(seqlen=20, seed=7, vocab_size=97, use_cache=False,
              cache_dir=str(tmp_path))
    jc = jdata.get_calib_data("synthetic", None, "m", 5, **kw)
    tc = tdata.get_calib_data("synthetic", None, "m", 5, **kw)
    assert len(tc) == len(jc) == 5
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(np.asarray(a["input_ids"]),
                                      np.asarray(b["input_ids"]))
    ekw = dict(cache_dir=str(tmp_path), use_cache=False, vocab_size=97)
    np.testing.assert_array_equal(tdata.get_eval_tokens("synthetic", None, **ekw),
                                  jdata.get_eval_tokens("synthetic", None, **ekw))
    with pytest.raises(NotImplementedError):
        tdata.get_eval_tokens("wikitext2", None, **ekw)


def test_safetensors_and_params_round_trip(tmp_path, ckpt):
    rng = np.random.RandomState(0)
    f32 = rng.randn(3, 5).astype(np.float32)
    tensors = {"a": f32, "b": tensorio.f32_to_bf16_bits(f32),
               "c": rng.randint(-9, 9, (4,)).astype(np.int64)}
    path = str(tmp_path / "t.safetensors")
    tensorio.save_safetensors(path, tensors, bf16=frozenset({"b"}))
    back = tensorio.load_safetensors_state_dict(str(tmp_path))
    np.testing.assert_array_equal(back["a"], f32)
    np.testing.assert_array_equal(back["c"], tensors["c"])
    np.testing.assert_array_equal(
        back["b"], tensorio.bf16_bits_to_f32(tensors["b"]))
    assert np.abs(back["b"] - f32).max() <= np.abs(f32).max() * 2 ** -8
    # the port's loader and the JAX package's native loader read the same
    # checkpoint into the same pytree; the numpy bridge round-trips it
    jp, jspec = load_model_native(ckpt, dtype=jnp.float32)
    tp, tspec, _ = load_model(ckpt, dtype="float32", device="cpu")
    jl = dict(_leaves(jax.tree.map(np.asarray, jp)))
    tl = dict(_leaves(params_to_numpy(tp)))
    assert jl.keys() == tl.keys()
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
    again = dict(_leaves(params_to_numpy(params_from_numpy(
        jax.tree.map(np.asarray, jp), tspec))))
    for k in jl:
        np.testing.assert_array_equal(again[k], jl[k], err_msg=k)


def test_ppl_evaluators_match_jax(ckpt):
    jp, jspec = load_model_native(ckpt, dtype=jnp.float32)
    tp, tspec, _ = load_model(ckpt, dtype="float32", device="cpu")
    rng = np.random.RandomState(5)
    rows = rng.randint(0, 96, (5, SEQLEN))
    np.testing.assert_allclose(
        tppl.evaluate_perplexity(tp, tspec, rows, limit=4),
        jppl.evaluate_perplexity(jp, jspec, rows, limit=4), rtol=1e-5)
    stream = rng.randint(0, 96, (1, 7 * SEQLEN + 5))
    for use_bos in (False, True):
        kw = dict(seqlen=SEQLEN, use_bos=use_bos, bos_token_id=1)
        np.testing.assert_allclose(
            tppl.evaluate_ppl_windowed(tp, tspec, stream, **kw),
            jppl.evaluate_ppl_windowed(jp, jspec, stream, **kw), rtol=1e-5)


def test_port_imports_no_jax():
    """Every module of the port, the serving package included, imports
    without pulling in jax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import asvd4llm_tpu_torch as pkg\n"
        "import asvd4llm_tpu_torch.serving\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "assert 'asvd4llm_tpu_torch.serving.engine' in names, names\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'asvd4llm_tpu' or m.startswith('asvd4llm_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 30


def test_entry_points_refuse_cpu_fallback(ckpt, monkeypatch):
    """Without a card, an entry point asked for its default device raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(ckpt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.run(tconfig.ASVDConfig(model_id=ckpt, raw_model=True, eval_ppl=""))


def test_cli_flags_match_jax(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--model_id", "m", "--param_ratio_target", "0.9", "--act_aware",
            "--rank_align", "128", "--no-use_cache", "--mesh_shape", "1,1"]
    t = tconfig.config_from_args(argv)
    assert t.to_dict() == jconfig.config_from_args(argv).to_dict()
    assert t.use_pallas is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tconfig.config_from_args(argv).use_pallas is True
    assert tconfig.config_from_args(argv + ["--no-use_pallas"]).use_pallas is False
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpipe.check_supported(t.replace(calib_dataset="selfgen"))
    for method in ("fisher", "fisher_abs_mean"):
        tpipe.check_supported(t.replace(scaling_method=method))
    for quant in ({"weight_quant": "awq_int4"}, {"deploy_int8_factors": True},
                  {"deploy_int4_factors": True}):
        tpipe.check_supported(t.replace(**quant))
    assert json.loads(json.dumps(t.to_dict(), default=str))
