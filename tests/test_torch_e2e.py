"""PyTorch port vs JAX package end to end, on a tiny random checkpoint in
float32 on the CPU: one compress + evaluate run per target mode (weight
ratio, KV-cache ratio) and greedy generation on the compressed models.

Tolerances: manifests and greedy tokens exactly equal; final PPL rtol 1e-3
(both sides run true-f32 contractions, so the difference is summation order
through the scan, the search and the evaluation).
"""

import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from asvd4llm_tpu import config as jconfig  # noqa: E402
from asvd4llm_tpu import pipeline as jpipe  # noqa: E402
from asvd4llm_tpu.eval import generate as jgen  # noqa: E402
from asvd4llm_tpu.models.loader import load_model_native  # noqa: E402
from asvd4llm_tpu_torch import cli as tcli  # noqa: E402
from asvd4llm_tpu_torch.eval import generate as tgen  # noqa: E402
from asvd4llm_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from asvd4llm_tpu_torch.utils.testing import write_random_checkpoint  # noqa: E402
from test_torch_pipeline import SEQLEN, TINY_LLAMA  # noqa: E402


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_random_checkpoint(str(tmp_path_factory.mktemp("ckpt")),
                                   TINY_LLAMA, seed=3, dtype="float32")


def _run_both(ckpt, tmp_path, **target):
    """One port CLI run and the JAX package's compress + evaluate with the
    same configuration, exact SVD on both sides. The JAX side takes its
    default prefix-cached scan-stacked sensitivity evaluator, the port its
    serial scan: the same math."""
    common = dict(model_id=ckpt, act_aware=True, calib_dataset="synthetic",
                  eval_ppl="synthetic", n_calib_samples=4, seqlen=SEQLEN,
                  eval_dtype="float32", svd_backend="exact", use_cache=False,
                  **target)
    jcfg = jconfig.ASVDConfig(**common, cache_dir=str(tmp_path / "j"),
                              output_dir=str(tmp_path / "jo"))
    jp, jspec = load_model_native(ckpt, dtype=jnp.float32)
    jparams, jman, _ = jpipe.compress(jp, jspec, None, jcfg)
    jres = jpipe.evaluate(jparams, jspec, None, jcfg)

    argv = []
    for k, v in dict(common, cache_dir=str(tmp_path / "t"),
                     output_dir=str(tmp_path / "to")).items():
        if isinstance(v, bool):
            argv.append(f"--{k}" if v else f"--no-{k}")
        else:
            argv += [f"--{k}", str(v)]
    out = tcli.main(argv, device="cpu")
    out["output_dir"] = str(tmp_path / "to")
    return jparams, jspec, jman, jres, out


@pytest.fixture(scope="module")
def weight_run(ckpt, tmp_path_factory):
    return _run_both(ckpt, tmp_path_factory.mktemp("w"), param_ratio_target=0.8,
                     rank_align=2)


@pytest.fixture(scope="module")
def kv_run(ckpt, tmp_path_factory):
    return _run_both(ckpt, tmp_path_factory.mktemp("kv"), compress_kv_cache=True,
                     kv_cache_ratio_target=0.5)


@pytest.mark.parametrize("mode", ["weight", "kv"])
def test_end_to_end_matches_jax(request, mode):
    jparams, jspec, jman, jres, out = request.getfixturevalue(f"{mode}_run")
    assert jman and out["manifest"] == jman
    assert list(out["manifest"]) == list(jman)
    np.testing.assert_allclose(out["results"]["synthetic"], jres["synthetic"],
                               rtol=1e-3)
    assert set(out["phase_times"]) >= {"load_model", "calib_stats",
                                       "sensitivity", "binary_search"}


def test_results_files_written(weight_run, tmp_path_factory):
    """write_results appends the reference's result.txt lines and one JSONL
    record with the manifest."""
    out = weight_run[-1]
    out_dir = out["output_dir"]
    with open(os.path.join(out_dir, "result.txt")) as f:
        lines = f.read().splitlines()
    assert len(lines) == 2 and "synthetic" in lines[1]
    with open(os.path.join(out_dir, "results.jsonl")) as f:
        rec = json.loads(f.readline())
    assert rec["manifest"] == out["manifest"]
    assert rec["results"] == out["results"]
    assert rec["config"]["param_ratio_target"] == 0.8


@pytest.mark.parametrize("mode", ["weight", "kv"])
def test_greedy_generate_tokens_identical(request, mode):
    """The JAX package's compressed model, converted, decodes the same
    greedy tokens in the port: dense caches, and for the KV run the
    realized latent cache, with and without the fused kernels."""
    jparams, jspec, _, _, out = request.getfixturevalue(f"{mode}_run")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), out["spec"])
    ids = np.random.RandomState(9).randint(0, 96, (2, 7))
    latent = [False] + (["kv", "v"] if mode == "kv" else [])
    for lat in latent:
        ref = jgen.generate(jparams, jspec, ids, max_new_tokens=6, latent_kv=lat)
        for up in (False, True):
            got = tgen.generate(tparams, out["spec"], ids, max_new_tokens=6,
                                latent_kv=lat, use_pallas=up)
            np.testing.assert_array_equal(got, ref, err_msg=f"{lat} {up}")
    if mode == "kv":
        assert any(tgen.layer_uses_latent_kv(layer) for layer in tparams["layers"])
