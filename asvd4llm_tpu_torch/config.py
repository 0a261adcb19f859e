"""Single typed configuration shared by every entry point.

The reference duplicates an argparse block between its two drivers
(ref: asvd.py:81-201, huggingface_repos/build_asvd_repo.py:112-198) and
uses raw flag values as cache keys. Here one dataclass carries the whole
pipeline configuration; its content hash is the cache key.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass


SCALING_METHODS = ("abs_mean", "abs_max", "fisher", "fisher_abs_mean")
SENSITIVITY_METRICS = ("ppl", "stable_rank")
WEIGHT_QUANTS = ("none", "rtn_int8", "rtn_int6", "awq_int8", "awq_int4")
SIGMA_FUSES = ("U", "V", "UV")
CALIB_DATASETS = ("wikitext2", "c4", "ptb", "alpaca", "selfgen", "synthetic")


@dataclass(frozen=True)
class ASVDConfig:
    """Pipeline configuration (flag surface parity with ref asvd.py:81-201)."""

    model_id: str = "facebook/opt-1.3b"
    # -- targets (exactly one should be set for weight compression) --
    ppl_target: float = -1.0
    param_ratio_target: float = -1.0
    # -- ASVD core --
    act_aware: bool = False
    alpha: float = 0.5
    sigma_fuse: str = "UV"
    rank_align: int = 1
    # walk EVERY linear like the reference's isinstance(nn.Linear) tree walk
    # (lm_head + OPT project_in/out, ref sensitivity.py:19-33); False limits
    # compression scope to decoder-layer projections
    compress_all_linears: bool = True
    # -- calibration --
    n_calib_samples: int = 32
    calib_dataset: str = "wikitext2"
    scaling_method: str = "abs_mean"
    sensitivity_metric: str = "ppl"
    # reproduce the reference's Fisher loss bit-for-bit: it passes labels
    # already shifted by one to the HF model, which shifts again internally
    # (ref act_aware_utils.py:25-27) — a predict-2-ahead CE. False = the
    # intended single-shift next-token Fisher.
    fisher_double_shift: bool = False
    seed: int = 233
    use_bos: bool = False
    seqlen: int = 2048
    # the reference's alpaca chat template escapes its placeholders (ref
    # datautils.py:84-89,134), rendering every sample as the same literal
    # string; False replicates that, True substitutes for real
    fixed_alpaca_template: bool = False
    # -- quantization: fake-quant evaluation (weight_quant) or real int8 /
    # int4 factors served by the fused quantized kernels (deploy_*) --
    weight_quant: str = "none"
    deploy_int8_factors: bool = False
    deploy_int4_factors: bool = False
    int4_group_size: int = 128
    # -- KV-cache compression --
    compress_kv_cache: bool = False
    kv_cache_ratio_target: float = -1.0
    # -- evaluation --
    eval_ppl: str = "wikitext2,ptb"
    eval_tasks: str = ""
    eval_mmlu: bool = False
    # -- infra --
    use_cache: bool = True
    cache_dir: str = "cache"
    output_dir: str = "output"
    raw_model: bool = False
    # compute dtype for model forward ("bfloat16" | "float32" | "float16");
    # factorization always runs in float32 (ref svd_linear.py:47).
    eval_dtype: str = "bfloat16"
    # SVD backend: "auto" is exact up to 1M entries and the Gram path above
    # (ops/svd.py:auto_backend, measured on the card).
    svd_backend: str = "auto"
    # The sensitivity evaluator (True: the prefix-cached suffix scan on a
    # uniform all-dense model, else the serial loop), the device mesh, the
    # scan's per-leaf resume file (factor checkpoints under
    # <scan_resume_path>.factors) and the host-RSS budget. The flags and
    # cache-key hashes match the JAX package's; pipeline.py raises for a
    # mesh above one device and for max_host_rss_gb > 0 (ROADMAP queue 1,
    # items 7 and 8).
    sensitivity_batch_ratios: bool = True
    mesh_shape: tuple = (1, 1)
    scan_resume_path: str = ""
    max_host_rss_gb: float = -1.0
    # run the hand-written CUDA kernels (ops/fused_lowrank.py,
    # ops/fused_lowrank_q.py, ops/latent_attention.py) where the forward
    # meets low-rank or quantized low-rank leaves; the
    # name is the JAX package's. The CLI defaults it to True when a CUDA
    # card is present (config_from_args).
    use_pallas: bool = False

    def __post_init__(self):
        if self.scaling_method not in SCALING_METHODS:
            raise ValueError(f"scaling_method {self.scaling_method!r} not in {SCALING_METHODS}")
        if self.sensitivity_metric not in SENSITIVITY_METRICS:
            raise ValueError(f"sensitivity_metric {self.sensitivity_metric!r} not in {SENSITIVITY_METRICS}")
        if self.weight_quant not in WEIGHT_QUANTS:
            raise ValueError(f"weight_quant {self.weight_quant!r} not in {WEIGHT_QUANTS}")
        if self.sigma_fuse not in SIGMA_FUSES:
            raise ValueError(f"sigma_fuse {self.sigma_fuse!r} not in {SIGMA_FUSES}")
        if self.compress_kv_cache and self.ppl_target > 0:
            # ref binary_search.py:32
            raise ValueError("ppl_target is not supported when compressing kv_cache")

    # ---- cache keying -----------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def content_hash(self, *fields_subset: str) -> str:
        """Stable hash of (a subset of) the config, used as cache key."""
        d = self.to_dict()
        if fields_subset:
            d = {k: d[k] for k in fields_subset}
        blob = json.dumps(d, sort_keys=True, default=str).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def replace(self, **kw) -> "ASVDConfig":
        return dataclasses.replace(self, **kw)

    # Fields that determine calibration statistics (cache key parity with
    # ref act_aware_utils.py:10,50 / datautils.py:108)
    CALIB_FIELDS = (
        "model_id", "calib_dataset", "n_calib_samples", "scaling_method",
        "seed", "use_bos", "seqlen", "compress_all_linears",
        "fisher_double_shift", "fixed_alpaca_template",
    )
    # Fields that determine the sensitivity dict (ref sensitivity.py:13).
    # svd_backend is included because exact vs randomized SVD yields
    # (slightly) different factors and therefore different layer PPLs.
    SENSITIVITY_FIELDS = CALIB_FIELDS + (
        "alpha", "rank_align", "compress_kv_cache", "sensitivity_metric",
        "eval_dtype", "svd_backend",
    )

    def calib_key(self) -> str:
        return self.content_hash(*self.CALIB_FIELDS)

    def sensitivity_key(self) -> str:
        return self.content_hash(*self.SENSITIVITY_FIELDS)


def config_from_args(argv=None) -> ASVDConfig:
    """CLI surface mirroring ref asvd.py:81-201 (one flag per field)."""
    import argparse

    p = argparse.ArgumentParser(description="ASVD compression pipeline "
                                "(PyTorch/CUDA port)")
    for f in dataclasses.fields(ASVDConfig):
        name = "--" + f.name
        if f.type == "bool" or isinstance(f.default, bool):
            # BooleanOptionalAction also provides --no_<flag>, which
            # default-True fields (use_cache, ...) need
            p.add_argument(name, action=argparse.BooleanOptionalAction,
                           default=None if f.name == "use_pallas" else f.default)
        elif f.name == "mesh_shape":
            p.add_argument(name, type=lambda s: tuple(int(x) for x in s.split(",")),
                           default=f.default)
        else:
            p.add_argument(name, type=type(f.default), default=f.default)
    ns = p.parse_args(argv)
    if ns.use_pallas is None:
        # the kernels are the port's main path wherever a card is present
        import torch
        ns.use_pallas = torch.cuda.is_available()
    return ASVDConfig(**vars(ns))
