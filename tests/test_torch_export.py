"""PyTorch port vs JAX package: the native checkpoint and the HF repo
export (export/{checkpoint,hf_repo,build_repo}.py), on the CPU.

Both packages get the same weights through models/convert.params_from_numpy.

Tolerances: manifests and config.json JSON-equal; native round trips bit
for bit; the HF repo's tensors equal to the JAX exporter's (names, dtypes,
shapes, values); logits of the repo loaded through transformers within
atol 1e-5 of the port's forward (f32); the port's reload of the repo equal
to the exported params.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
transformers = pytest.importorskip("transformers")
pytest.importorskip("safetensors")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from safetensors import safe_open  # noqa: E402
from safetensors.numpy import load_file  # noqa: E402

from asvd4llm_tpu import config as jconfig  # noqa: E402
from asvd4llm_tpu.export.checkpoint import _manifest as jmanifest  # noqa: E402
from asvd4llm_tpu.export.hf_repo import export_hf_repo as jexport  # noqa: E402
from asvd4llm_tpu.models import params_from_torch_model  # noqa: E402
from asvd4llm_tpu.models.registry import (  # noqa: E402
    get_linear, lowrank_leaf, set_linear,
)
from asvd4llm_tpu.ops.asvd import factorize_linear  # noqa: E402
from asvd4llm_tpu.ops.quant_apply import (  # noqa: E402
    quantize_lowrank_factors_int4, quantize_lowrank_factors_int8,
)
from asvd4llm_tpu_torch import config as tconfig  # noqa: E402
from asvd4llm_tpu_torch.export import build_repo  # noqa: E402
from asvd4llm_tpu_torch.export.checkpoint import (  # noqa: E402
    MANIFEST_FILE, load_compressed, save_compressed,
)
from asvd4llm_tpu_torch.export.hf_repo import export_hf_repo  # noqa: E402
from asvd4llm_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from asvd4llm_tpu_torch.models.decoder import forward  # noqa: E402
from asvd4llm_tpu_torch.models.loader import load_model  # noqa: E402
from asvd4llm_tpu_torch.models.spec import DecoderSpec  # noqa: E402
from asvd4llm_tpu_torch.utils.testing import write_random_checkpoint  # noqa: E402
from test_torch_pipeline import SEQLEN, TINY_LLAMA  # noqa: E402

LOGIT_ATOL = 1e-5


def _factorize(params, spec, names):
    manifest = {}
    for name in names:
        leaf = get_linear(params, spec, name)
        f = factorize_linear(leaf["w"], leaf["b"], 0.6, backend="exact")
        params = set_linear(params, spec, name, lowrank_leaf(f.A, f.B, f.bias))
        manifest[name] = int(f.rank)
    return params, manifest


def _family(family):
    """(hf model, JAX params, JAX spec, manifest) of a tiny model of one
    family with two factored linears (the JAX package's export tests)."""
    if family == "llama":
        cfg = transformers.LlamaConfig(
            vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
            max_position_embeddings=128, tie_word_embeddings=False)
        torch.manual_seed(0)
        model = transformers.LlamaForCausalLM(cfg).eval()
        names = ("model.layers.0.mlp.gate_proj", "model.layers.1.self_attn.q_proj")
    elif family == "opt350m":
        cfg = transformers.OPTConfig(
            vocab_size=128, hidden_size=48, ffn_dim=96, num_hidden_layers=1,
            num_attention_heads=2, max_position_embeddings=64,
            word_embed_proj_dim=24, do_layer_norm_before=False,
            tie_word_embeddings=False)
        torch.manual_seed(5)
        model = transformers.OPTForCausalLM(cfg).eval()
        names = ("model.decoder.layers.0.fc1", "lm_head")
    elif family == "qwen2":
        cfg = transformers.Qwen2Config(
            vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=96, tie_word_embeddings=False)
        torch.manual_seed(11)
        model = transformers.Qwen2ForCausalLM(cfg).eval()
        names = ("model.layers.0.self_attn.q_proj", "model.layers.1.mlp.down_proj")
    else:
        cfg = transformers.GemmaConfig(
            vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
            head_dim=16, max_position_embeddings=64)
        torch.manual_seed(7)
        model = transformers.GemmaForCausalLM(cfg).eval()
        names = ("model.layers.0.mlp.up_proj",)
    jp, jspec = params_from_torch_model(model, dtype=jnp.float32)
    jp, manifest = _factorize(jp, jspec, names)
    return model, jp, jspec, manifest


QUANT = {"lowrank": lambda p, s: p, "q8": quantize_lowrank_factors_int8,
         "q4": quantize_lowrank_factors_int4}


@pytest.fixture(scope="module")
def llama():
    return _family("llama")


def _case(llama, kind):
    """(hf config, JAX params, JAX spec, port params, port spec, manifest)
    with low-rank, int8 or int4 factors."""
    model, jp, jspec, manifest = llama
    jp = QUANT[kind](jp, jspec)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return model.config, jp, jspec, tp, DecoderSpec(**dataclasses.asdict(jspec)), manifest


def _tensors(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{path}/{i}")
    else:
        yield path, tree


def _assert_same_params(got, want):
    a, b = dict(_tensors(got)), dict(_tensors(want))
    assert a.keys() == b.keys()
    for k in a:
        if b[k] is None:
            assert a[k] is None, k
            continue
        assert a[k].dtype == b[k].dtype, (k, a[k].dtype, b[k].dtype)
        assert torch.equal(a[k], b[k]), k


def _json(obj):
    return json.loads(json.dumps(obj))


CFG = dict(model_id="m", param_ratio_target=0.9, act_aware=True,
           calib_dataset="synthetic", n_calib_samples=4, seqlen=SEQLEN)


@pytest.mark.parametrize("kind", ["lowrank", "q8", "q4"])
def test_manifest_equals_jax(llama, tmp_path, kind):
    """manifest.json is JSON-equal to the JAX package's _manifest for the
    same params: spec, ranks, per-leaf encodings with NumPy dtype names,
    and the config."""
    _, jp, jspec, tp, tspec, manifest = _case(llama, kind)
    save_compressed(str(tmp_path), tp, tspec, manifest, tconfig.ASVDConfig(**CFG))
    with open(tmp_path / MANIFEST_FILE) as f:
        got = json.load(f)
    want = _json(jmanifest(jspec, manifest, jconfig.ASVDConfig(**CFG), jp))
    assert got == want
    assert got["encodings"] and {e["kind"] for e in got["encodings"].values()} == {kind}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind", ["lowrank", "q8", "q4"])
def test_native_round_trip_bit_for_bit(llama, tmp_path, kind, dtype):
    """Every tensor comes back with its dtype and bits; spec and ranks are
    equal; a dtype= on load casts the floating tensors but not the scales."""
    _, jp, _, _, tspec, manifest = _case(llama, kind)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), dtype=dtype)
    save_compressed(str(tmp_path), tp, tspec, manifest)
    got, spec2, ranks2 = load_compressed(str(tmp_path), device="cpu")
    assert spec2 == tspec and ranks2 == manifest
    _assert_same_params(got, tp)
    cast, _, _ = load_compressed(str(tmp_path), dtype="float32", device="cpu")
    assert cast["embed_tokens"].dtype == torch.float32
    if kind != "lowrank":
        assert cast["layers"][0]["gate_proj"]["Bsc"].dtype == torch.float32


def test_native_v1_manifest_loads_low_rank_leaves(llama, tmp_path):
    """A format-1 manifest (ranks only, no encodings) rebuilds plain
    low-rank leaves at the manifested ranks."""
    _, _, _, tp, tspec, manifest = _case(llama, "lowrank")
    save_compressed(str(tmp_path), tp, tspec, manifest)
    with open(tmp_path / MANIFEST_FILE) as f:
        man = json.load(f)
    man.pop("encodings")
    man["format_version"] = 1
    with open(tmp_path / MANIFEST_FILE, "w") as f:
        json.dump(man, f)
    got, _, _ = load_compressed(str(tmp_path), device="cpu")
    _assert_same_params(got, tp)


@pytest.mark.parametrize("with_config", [False, True], ids=["spec_config", "hf_config"])
@pytest.mark.parametrize("kind", ["lowrank", "q8", "q4"])
def test_hf_repo_equals_jax_export(llama, tmp_path, kind, with_config):
    """The port's repo against the JAX exporter's on the same params:
    config.json JSON-equal (no hf_config on both sides, or the JAX call
    given the transformers config and the port's its to_dict()); the same
    tensors in model.safetensors with the {"format": "pt"} metadata; the
    modeling file equal apart from its first line."""
    hf_cfg, jp, jspec, tp, tspec, manifest = _case(llama, kind)
    jrepo, trepo = str(tmp_path / "j"), str(tmp_path / "t")
    jexport(jrepo, jp, jspec, manifest, hf_config=hf_cfg if with_config else None)
    export_hf_repo(trepo, tp, tspec, manifest,
                   hf_config=hf_cfg.to_dict() if with_config else None)
    cfgs = []
    for repo in (jrepo, trepo):
        with open(os.path.join(repo, "config.json")) as f:
            cfgs.append(json.load(f))
    assert cfgs[1] == cfgs[0]
    want = load_file(os.path.join(jrepo, "model.safetensors"))
    got = load_file(os.path.join(trepo, "model.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with safe_open(os.path.join(trepo, "model.safetensors"), "np") as f:
        assert f.metadata() == {"format": "pt"}
    mods = []
    for repo in (jrepo, trepo):
        with open(os.path.join(repo, "modeling_asvd.py")) as f:
            mods.append(f.read().split("\n", 1))
    assert mods[1][1] == mods[0][1] and mods[1][0] != mods[0][0]


def test_safetensors_writer_metadata(tmp_path):
    """save_safetensors writes the __metadata__ block that transformers
    checks (format "pt"); the safetensors package reads it and the tensors,
    and the port's reader skips it."""
    from asvd4llm_tpu_torch.utils.tensorio import SafetensorsFile, save_safetensors
    arrs = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.arange(4, dtype=np.int8)}
    path = str(tmp_path / "m.safetensors")
    save_safetensors(path, arrs, metadata={"format": "pt"})
    with safe_open(path, "np") as f:
        assert f.metadata() == {"format": "pt"}
    back = load_file(path)
    with SafetensorsFile(path) as f:
        assert sorted(f.keys()) == ["a", "b"]
        for k, v in arrs.items():
            np.testing.assert_array_equal(back[k], v)
            np.testing.assert_array_equal(f.tensor(k), v)


def _family_case(family, kind):
    if family == "llama":
        model, jp, jspec, manifest = _family("llama")
        jp = QUANT[kind](jp, jspec)
    else:
        model, jp, jspec, manifest = _family(family)
    return model, jp, jspec, manifest


THROUGH_TRANSFORMERS = [("llama", "lowrank"), ("llama", "q8"), ("llama", "q4"),
                        ("opt350m", "lowrank"), ("qwen2", "lowrank"),
                        ("gemma", "lowrank")]


@pytest.mark.parametrize("family,kind", THROUGH_TRANSFORMERS,
                         ids=[f"{f}_{k}" for f, k in THROUGH_TRANSFORMERS])
def test_hf_repo_loads_through_transformers(tmp_path, family, kind):
    """AutoModelForCausalLM.from_pretrained(repo, trust_remote_code=True)
    on the port's repo gives the port's logits; the port's load_model on
    the same repo gives back the exported params."""
    model, jp, jspec, manifest = _family_case(family, kind)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    tspec = DecoderSpec(**dataclasses.asdict(jspec))
    repo = str(tmp_path / "repo")
    export_hf_repo(repo, tp, tspec, manifest, hf_config=model.config.to_dict())

    loaded = transformers.AutoModelForCausalLM.from_pretrained(
        repo, trust_remote_code=True).eval()
    mods = dict(loaded.named_modules())
    for name in manifest:
        assert hasattr(mods[name], "ALinear" if kind == "lowrank" else "A_qweight"), name
    ids = np.random.RandomState(2).randint(2, 128, size=(1, 10))
    with torch.no_grad():
        ref = loaded(torch.from_numpy(ids.copy())).logits.float()
        ours = forward(tp, torch.from_numpy(ids.copy()), tspec)
    torch.testing.assert_close(ours, ref, atol=LOGIT_ATOL, rtol=0)

    p2, spec2, _ = load_model(repo, dtype="float32", device="cpu")
    assert spec2 == tspec
    _assert_same_params(p2, tp)


def test_loader_reads_a_factored_tied_head(tmp_path):
    """A tied model whose head was factored (set_linear gives it a leaf of
    its own) exports the head's factors, and the port's load_model reads
    them back rather than re-tying the head to the embedding."""
    model, jp, jspec, _ = _family("gemma")
    jp, manifest = _factorize(jp, jspec, ("lm_head",))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    tspec = DecoderSpec(**dataclasses.asdict(jspec))
    assert tspec.tie_word_embeddings and "A" in tp["lm_head"]
    export_hf_repo(str(tmp_path), tp, tspec, manifest,
                   hf_config=model.config.to_dict())
    p2, _, _ = load_model(str(tmp_path), dtype="float32", device="cpu")
    _assert_same_params(p2, tp)


def test_build_repo_main_writes_both_artifacts(tmp_path):
    """The builder CLI on a tiny random checkpoint with the synthetic
    corpus writes the HF repo and the native checkpoint; both reload to
    the same params, which give the same logits as transformers' load of
    the repo."""
    ckpt = write_random_checkpoint(str(tmp_path / "ckpt"), TINY_LLAMA, seed=3,
                                   dtype="float32")
    with open(os.path.join(ckpt, "tokenizer_config.json"), "w") as f:
        json.dump({"model_max_length": 128}, f)
    repo, native = str(tmp_path / "repo"), str(tmp_path / "native")
    assert build_repo.main(
        ["--model_id", ckpt, "--param_ratio_target", "0.8", "--act_aware",
         "--calib_dataset", "synthetic", "--n_calib_samples", "4",
         "--seqlen", str(SEQLEN), "--eval_dtype", "float32",
         "--svd_backend", "exact", "--cache_dir", str(tmp_path / "cache"),
         "--repo_dir", repo, "--native_dir", native], device="cpu") == 0
    assert os.path.isfile(os.path.join(repo, "tokenizer_config.json"))
    with open(os.path.join(repo, "config.json")) as f:
        ranks = json.load(f)["truncation_ranks"]
    nat, spec, nat_ranks = load_compressed(native, device="cpu")
    assert ranks and nat_ranks == ranks
    with open(os.path.join(native, MANIFEST_FILE)) as f:
        assert json.load(f)["config"]["n_calib_samples"] == 4
    hf, _, _ = load_model(repo, dtype="float32", device="cpu")
    _assert_same_params(hf, nat)
    loaded = transformers.AutoModelForCausalLM.from_pretrained(
        repo, trust_remote_code=True).eval()
    ids = np.random.RandomState(4).randint(0, 96, size=(1, 9))
    with torch.no_grad():
        ref = loaded(torch.from_numpy(ids.copy())).logits.float()
        ours = forward(nat, torch.from_numpy(ids.copy()), spec)
    torch.testing.assert_close(ours, ref, atol=LOGIT_ATOL, rtol=0)


def test_builder_canonical_recipe_and_sample_default(tmp_path, monkeypatch):
    """main() raises the default of 32 calibration rows to the
    recipe's 256, and warns (does not refuse) on a non-canonical recipe."""
    seen = {}
    monkeypatch.setattr(build_repo, "build_repo",
                        lambda cfg, repo, **kw: seen.update(cfg=cfg, repo=repo, **kw))
    build_repo.main(["--model_id", "m", "--repo_dir", "r"], device="cpu")
    assert seen["cfg"].n_calib_samples == 256 and seen["repo"] == "r"
    assert seen["native_dir"] is None and seen["device"] == "cpu"
    cfg = tconfig.ASVDConfig(**build_repo.CANONICAL)
    assert all(getattr(cfg, k) == v for k, v in build_repo.CANONICAL.items())


def test_entry_points_refuse_cpu_fallback(tmp_path, monkeypatch):
    """Without a card the builder and load_compressed raise unless they are
    given device="cpu"."""
    ckpt = write_random_checkpoint(str(tmp_path / "ckpt"), TINY_LLAMA, seed=3,
                                   dtype="float32")
    p, spec, _ = load_model(ckpt, dtype="float32", device="cpu")
    save_compressed(str(tmp_path / "native"), p, spec, {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_compressed(str(tmp_path / "native"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_repo.main(["--model_id", ckpt, "--calib_dataset", "synthetic",
                         "--repo_dir", str(tmp_path / "repo")])
    assert not os.path.exists(tmp_path / "repo")
    p2, _, _ = load_compressed(str(tmp_path / "native"), device="cpu")
    _assert_same_params(p2, p)
