"""Deployable-repo builder — the second command-line entry point
(ref huggingface_repos/build_asvd_repo.py:18-108).

Counterpart of asvd4llm_tpu/export/build_repo.py: loads a local checkpoint,
runs the calibration + sensitivity + search pipeline (``compress``) and
exports BOTH deployment artifacts:
- an HF trust_remote_code repo (truncation_ranks + generated modeling
  class + safetensors), with the source ``config.json`` and the source
  directory's tokenizer files, and
- when ``--native_dir`` is given, the native safetensors + manifest
  checkpoint (export/checkpoint.py).

The reference hardcodes the canonical recipe and asserts it
(ref build_asvd_repo.py:29,48-56: n_calib 256, alpha 0.5, abs_mean,
wikitext2 calib, ppl metric); this warns instead, and the default config
IS the canonical recipe. The JAX package's builder substitutes a
synthetic corpus when a corpus cannot be fetched
(``allow_synthetic_fallback=True``); this one has no such fallback: a
corpus the port's datasets lack raises, so a run on synthetic data is one
that asked for it (``--calib_dataset synthetic``).

Usage: python -m asvd4llm_tpu_torch.export.build_repo --model_id <dir> \
           --param_ratio_target 0.9 --repo_dir output/asvd-repo \
           [--native_dir output/asvd-native]
The run goes to ``cuda:0``; ``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import json
import logging
import os
import sys

log = logging.getLogger(__name__)

CANONICAL = dict(alpha=0.5, scaling_method="abs_mean",
                 calib_dataset="wikitext2", sensitivity_metric="ppl",
                 n_calib_samples=256)


def build_repo(cfg, repo_dir: str, *, native_dir: str | None = None,
               device=None):
    """Compress ``cfg.model_id`` on ``device`` (``cuda:0`` unless the caller
    names another) and write the artifacts; returns (repo_dir, manifest)."""
    from asvd4llm_tpu_torch.device import resolve_device
    from asvd4llm_tpu_torch.export.checkpoint import save_compressed
    from asvd4llm_tpu_torch.export.hf_repo import export_hf_repo
    from asvd4llm_tpu_torch.models.loader import load_model
    from asvd4llm_tpu_torch.pipeline import compress

    for key, want in CANONICAL.items():
        got = getattr(cfg, key)
        if got != want:
            log.warning("non-canonical %s=%r (canonical recipe uses %r, "
                        "ref build_asvd_repo.py:48-56)", key, got, want)

    device = resolve_device(device)
    params, spec, tokenizer = load_model(cfg.model_id, dtype=cfg.eval_dtype,
                                         device=device)
    compressed, manifest, _ = compress(params, spec, tokenizer, cfg)
    del params

    with open(os.path.join(cfg.model_id, "config.json")) as f:
        hf_config = json.load(f)
    # floating tensors go out in f32, for maximal loader compatibility
    export_hf_repo(repo_dir, compressed, spec, manifest, hf_config=hf_config,
                   tokenizer_dir=cfg.model_id)
    log.info("wrote HF repo: %s (%d factored layers)", repo_dir, len(manifest))
    if native_dir:
        save_compressed(native_dir, compressed, spec, manifest, cfg)
        log.info("wrote native checkpoint: %s", native_dir)
    return repo_dir, manifest


def main(argv=None, *, device=None):
    from asvd4llm_tpu_torch.config import config_from_args

    logging.basicConfig(level=logging.INFO)
    argv = list(sys.argv[1:] if argv is None else argv)
    repo_dir = "output/asvd_repo"
    native_dir = None
    if "--repo_dir" in argv:
        i = argv.index("--repo_dir")
        repo_dir = argv[i + 1]
        del argv[i:i + 2]
    if "--native_dir" in argv:
        i = argv.index("--native_dir")
        native_dir = argv[i + 1]
        del argv[i:i + 2]
    cfg = config_from_args(argv)
    if cfg.n_calib_samples == 32:  # builder default (ref :29)
        cfg = cfg.replace(n_calib_samples=256)
    build_repo(cfg, repo_dir, native_dir=native_dir, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
