"""Per-layer sensitivity scanning.

Counterpart of asvd4llm_tpu/calib/sensitivity.py: ``calib_sensitivity_ppl``
(:837) with its two evaluators, and ``calib_sensitivity_stable_rank``
(:962-994). Reference behavior (ref sensitivity.py:10-61): for every linear
and every candidate ratio ([0.4..0.9] for weights, [0.1..1.9] in KV mode),
factorize THAT ONE layer (always act-aware, ref :50), measure calibration
PPL, restore. Result: {layer_full_name: {ratio: ppl}}.

One SVD per layer serves every ratio of the grid: truncating the max-rank
factorization at r IS the rank-r ASVD solution, and the candidate is
substituted as a same-shaped dense leaf w = A @ B.

Two evaluators give the same numbers:

- the prefix-cached suffix scan (JAX :593 ``_scan_suffix_sensitivity``,
  taken with ``sensitivity_batch_ratios`` on a uniform all-dense model,
  ``models/scan_forward.can_scan``): layers are walked in order with the
  dense model's hidden at the current layer's input cached on the device,
  so a candidate at layer l pays only layers l..L-1 and the head; a head
  candidate pays one head GEMM. The prefix of a one-leaf trial IS the
  dense prefix. Candidates of a leaf are recomposed in chunks sized from
  the card's free memory (JAX :519). A loop over candidates stands where
  JAX has ``vmap``. Per-leaf resume lines in the JAX format (:318-381) and
  the device-OOM ladder (:383) come with it;
- the serial loop (JAX :899-959, ``batch_ratios=False``): one full forward
  per candidate.

Each leaf draws its own generator from the scan's (``split_generator``),
before any resume check, as JAX splits its key (:706-708): a randomized
SVD sees the same draws whether a leaf is recomputed or replayed, and in
either evaluator.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import defaultdict

import numpy as np
import torch

from asvd4llm_tpu_torch.eval.ppl import evaluate_perplexity
from asvd4llm_tpu_torch.models.decoder import apply_lm_head
from asvd4llm_tpu_torch.models.registry import (
    LM_HEAD_NAME, dense_leaf, extra_linear_names, get_linear, iter_linears,
    layer_linear_keys, leaf_shape, linear_name, linear_names, set_linear,
)
from asvd4llm_tpu_torch.models.scan_forward import (
    _finish_hidden, apply_stacked_layer, can_scan, embed_scan_inputs,
    forward_hidden_scan_from,
)
from asvd4llm_tpu_torch.ops.asvd import (
    build_scaling_vector, rank_for_param_ratio, scaled_svd,
)
from asvd4llm_tpu_torch.ops.svd import (
    gram_truncated_svd_host_eigh, gram_truncated_svd_lowmem, resolve_backend,
    singular_values, truncated_svd,
)
from asvd4llm_tpu_torch.utils.membudget import grid_chunk_candidates

log = logging.getLogger(__name__)

WEIGHT_RATIO_GRID = [0.4, 0.5, 0.6, 0.7, 0.8, 0.9]          # ref :39
KV_RATIO_GRID = [0.1 * i for i in range(1, 20)]               # ref :37
STABLE_RANK_GRID = [0.1 * i for i in range(1, 10)]            # ref :90


def split_generator(generator: torch.Generator) -> torch.Generator:
    """A leaf's own generator: one draw from ``generator`` seeds it."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    return torch.Generator(device=generator.device).manual_seed(seed)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def recomposed_dense_all_ratios(w, bias, ratios, scale, rank_align,
                                svd_backend, generator):
    """{ratio: dense leaf w_hat = U_r S_r Vh_r, or None} from ONE SVD at the
    grid's largest rank. None marks rank 0 or a non-finite recomposition."""
    out_f, in_f = w.shape
    ranks = {r: min(rank_for_param_ratio(in_f, out_f, r, rank_align),
                    in_f, out_f)
             for r in ratios}
    max_rank = max(ranks.values())
    if max_rank <= 0:
        return {r: None for r in ratios}
    u, s, vh = scaled_svd(w, max_rank, scale=scale, backend=svd_backend,
                          generator=generator)
    out = {}
    for r, rank in ranks.items():
        if rank <= 0:
            out[r] = None
            continue
        w_hat = ((u[:, :rank] * s[:rank][None, :]) @ vh[:rank, :]).to(w.dtype)
        out[r] = dense_leaf(w_hat, bias) if bool(torch.isfinite(w_hat).all()) \
            else None
    return out


# ------------------------------------------------- the suffix evaluator ---

def _grid_factors(w, scale, ranks: tuple, backend: str, generator):
    """SVD factors of ``w * scale`` at max(ranks), 1/scale folded into vh
    (JAX :118-134). The Gram backend takes the blocked low-memory form."""
    if backend == "gram":
        u, s, vh = gram_truncated_svd_lowmem(w, scale, max(ranks))
        return u, s, vh / scale[None, :]
    w32 = w.float() * scale[None, :]
    u, s, vh = truncated_svd(w32, max(ranks), backend=backend,
                             generator=generator)
    return u, s, vh / scale[None, :]


def _recompose_chunk(u, s, vh, ranks: tuple, dtype):
    """Dense recompositions [C, out, in] for one chunk of grid ranks, and
    their finite flags (JAX :137-143). Each product is cast into its slot
    of one buffer, so the chunk is held once (a stack of casts would hold
    it twice, beside a [C, out, in] bool mask: 4.4 GB for the 32000 x 4096
    head's six candidates)."""
    w_hats = torch.empty((len(ranks), u.shape[0], vh.shape[1]), dtype=dtype,
                         device=u.device)
    finite = torch.empty((len(ranks),), dtype=torch.bool, device=u.device)
    for i, r in enumerate(ranks):
        w_hats[i] = (u[:, :r] * s[:r][None, :]) @ vh[:r, :]
        finite[i] = torch.isfinite(w_hats[i]).all()
    return w_hats, finite


def _row_block(n: int, S: int) -> int:
    """Rows per block of the cached hidden (JAX :200)."""
    return max(1, min(2048 // max(S - 1, 1), n))


def _embed_rows(params, spec, rows):
    """[rb, S] id rows -> layer-0 input hidden [rb, S-1, H] (inputs are
    rows[:, :-1]; labels are rows[:, 1:])."""
    x, _, _ = embed_scan_inputs(params, rows[:, :-1], spec)
    return x


def _advance_block(params, spec, hidden, idx):
    """Apply dense decoder layer ``idx`` to one row block's cached hidden:
    the prefix update after a layer's grid is done."""
    return apply_stacked_layer(params, hidden, spec, idx=idx)


def _ce_mean_chunked(head_params, spec, out, lab, ck=256):
    """Mean next-token NLL per row, the head GEMM, logsumexp and label
    gather run ``ck`` positions at a time, so [rows, S, vocab] f32
    log-probs are never held (JAX :224-260). out [..., S, H]; lab [..., S].
    Returns [...]."""
    S = out.shape[-2]
    total = torch.zeros(out.shape[:-2], dtype=torch.float32, device=out.device)
    for c0 in range(0, S, ck):
        z = apply_lm_head(head_params, spec, out[..., c0:c0 + ck, :]).float()
        lse = torch.logsumexp(z, dim=-1)
        gold = torch.gather(z, -1, lab[..., c0:c0 + ck, None])[..., 0]
        total = total + (lse - gold).sum(dim=-1)
    return total / S


def _ppl_multi_ratio_suffix(params, spec, hidden, labels, mask, leaf_key,
                            target, w_hats):
    """Per-candidate sums of masked per-row mean NLLs [C] for ONE row block:
    ``hidden`` [rb, S-1, H] is the dense model's hidden at layer
    ``target``'s input, and each candidate runs only layers target..L-1
    with ``leaf_key`` of layer ``target`` replaced (JAX :264-285)."""
    out = []
    for w_hat in w_hats:
        h = forward_hidden_scan_from(params, hidden, spec, start=target,
                                     substitute=(leaf_key, target, w_hat))
        out.append((_ce_mean_chunked(params, spec, h, labels) * mask).sum())
    return torch.stack(out)


def _ppl_head_grid(params, spec, hidden, labels, mask, w_hats, bias):
    """Head candidates leave the decoder untouched: the hidden after all
    layers is fixed and each candidate costs one head GEMM and the CE
    (JAX :288-303). One row block per call."""
    h_fin = _finish_hidden(params, spec, hidden)
    out = []
    for w_hat in w_hats:
        trial = dict(params)
        trial["lm_head"] = dense_leaf(w_hat, bias)
        out.append((_ce_mean_chunked(trial, spec, h_fin, labels) * mask).sum())
    return torch.stack(out)


def _blocks_ppl(n: int, block_eval) -> np.ndarray:
    """exp(sum over row blocks of the masked NLL sums / n) (JAX :306-315).
    Reading each block back is the sync that bounds live blocks to one."""
    total = None
    for out in block_eval:
        part = out.float().cpu().numpy()
        total = part if total is None else total + part
    return np.exp(total / n)


def _grid_eval_streamed(leaf, grid, cfg, scale, generator, eval_fn, *,
                        force_backend=None, chunk_shrink=1, record=None):
    """Evaluate a leaf's whole ratio grid (JAX :519-590): one SVD at the
    grid's largest rank, then the candidates recomposed and evaluated in
    chunks that the card's free memory sizes (``grid_chunk_candidates``),
    divided by ``chunk_shrink``. ``force_backend`` overrides the SVD
    backend; a Gram backend at ``chunk_shrink >= 8`` runs its
    eigendecomposition on the host. ``record``, when given, receives the
    backend, the SVD and evaluation seconds and the candidate count.
    Returns (valid_ratios, ppls, finite) as numpy."""
    out_f, in_f = leaf_shape(leaf)
    ranks = {r: min(rank_for_param_ratio(in_f, out_f, r, cfg.rank_align),
                    in_f, out_f) for r in grid}
    valid = [r for r in grid if ranks[r] > 0]
    if not valid:
        return valid, None, None
    w = leaf["w"]
    dev = w.device
    backend = force_backend or resolve_backend(out_f, in_f, max(ranks.values()),
                                               cfg.svd_backend, dev)
    scale_vec = scale if scale is not None else \
        torch.ones((in_f,), dtype=torch.float32, device=dev)
    ranks_tuple = tuple(ranks[r] for r in valid)
    t0 = time.perf_counter()
    if backend == "gram" and chunk_shrink >= 8:
        u, s, vh = gram_truncated_svd_host_eigh(w, scale_vec, max(ranks_tuple))
        vh = vh / scale_vec[None, :]
    else:
        u, s, vh = _grid_factors(w, scale_vec, ranks_tuple, backend, generator)
    _sync(dev)
    t1 = time.perf_counter()
    cs = grid_chunk_candidates(len(valid), out_f * in_f * w.element_size(), dev)
    cs = max(1, cs // max(1, chunk_shrink))
    ppls, fins = [], []
    for i in range(0, len(valid), cs):
        wh, fin = _recompose_chunk(u, s, vh, ranks_tuple[i:i + cs], w.dtype)
        ppls.append(eval_fn(wh))
        fins.append(fin.cpu().numpy())
        del wh
    if record is not None:
        record.update(backend=backend, svd_s=t1 - t0,
                      eval_s=time.perf_counter() - t1, candidates=len(valid))
    return valid, np.concatenate(ppls), np.concatenate(fins)


def _load_resume(path):
    """Per-leaf resume state (JAX :318-359): one JSON line per finished leaf,
    ``{"name", "li", "dt", "ratios": {str(ratio): ppl}}``, written after
    every leaf, so a killed process loses at most the leaf in flight. A
    line with ``"oom": N`` and no ``"ratios"`` marks a leaf that ran out of
    device memory N times; its ``"shape"``, when present, marks every leaf
    of that [out, in] shape. A torn last line is ignored.

    Returns ``({name: (li, dt, {float: float})}, {name: oom_count},
    {(out, in), ...})``."""
    state, oom_counts, oom_shapes = {}, {}, set()
    if path and os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn final line from a killed process
                if "ratios" not in rec:
                    if "oom" in rec:
                        oom_counts[rec["name"]] = max(
                            int(rec["oom"]), oom_counts.get(rec["name"], 0))
                        if rec.get("shape"):
                            oom_shapes.add(tuple(rec["shape"]))
                    continue
                state[rec["name"]] = (
                    rec.get("li", -1), rec.get("dt", 0.0),
                    {float(r): float(p) for r, p in rec["ratios"].items()})
    return state, oom_counts, oom_shapes


def _append_line(path, rec):
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
        f.flush()


def _append_resume(path, name, li, dt, ratios):
    _append_line(path, {"name": name, "li": li, "dt": round(dt, 2),
                        "ratios": {str(r): p for r, p in ratios.items()}})


def _append_oom(path, name, count, shape=None):
    rec = {"name": name, "oom": count}
    if shape is not None:
        rec["shape"] = list(shape)
    _append_line(path, rec)


def _grid_eval_oom_safe(call, name, resume, oom_counts, shape=None,
                        oom_shapes=None):
    """Run ``call(force_backend, chunk_shrink)``, a leaf's grid eval, with
    the device-OOM ladder of JAX :383-459:

    1. a leaf marked in the resume file, or of a marked shape, runs with the
       Gram backend and chunks shrunk 4x from the start (8x, which takes
       the host eigendecomposition, once the leaf is marked 4 times);
    2. a fresh ``torch.cuda.OutOfMemoryError`` marks the shape (a count-0
       line) and retries once on the Gram backend with chunks shrunk 4x;
    3. a second OOM writes the leaf's marker and re-raises; a rerun with
       the same resume file starts at step 1.

    The retry runs after the ``except`` block is left: until then the
    failed call's frames, and the tensors they hold, are alive. JAX's last
    step, a process recycle (``utils/hostguard.py``), is not ported."""
    in_oom_shape = oom_shapes is not None and shape is not None \
        and tuple(shape) in oom_shapes
    marked = bool(oom_counts.get(name)) or in_oom_shape
    shrink = 1 if not marked else (8 if oom_counts.get(name, 0) >= 4 else 4)
    try:
        return call("gram" if marked else None, shrink)
    except torch.cuda.OutOfMemoryError:
        log.warning("device OOM at %s (marked=%s): retrying on the gram "
                    "backend with shrunk chunks", name, marked)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    if shape is not None and oom_shapes is not None:
        if tuple(shape) not in oom_shapes and resume:
            # count 0: marks the SHAPE without counting against the leaf
            _append_oom(resume, name, 0, shape)
        oom_shapes.add(tuple(shape))
    try:
        return call("gram", 4)
    except torch.cuda.OutOfMemoryError:
        n_oom = oom_counts.get(name, 0) + 1
        oom_counts[name] = n_oom
        if resume:
            _append_oom(resume, name, n_oom, shape)
        raise


def _fill(sensitivity, name, grid, valid, ppls, finite):
    """The leaf's dict in JAX's insertion order: rank-0 ratios first (inf),
    then the valid ones, a non-finite recomposition scoring inf."""
    for ratio in set(grid) - set(valid):
        sensitivity[name][ratio] = float("inf")
    for j, ratio in enumerate(valid):
        sensitivity[name][ratio] = float(ppls[j]) if finite[j] else float("inf")


def _scale(name, stats, fisher, alpha):
    return build_scaling_vector(None if stats is None else stats.get(name),
                                None if fisher is None else fisher.get(name),
                                alpha)


def _serial_leaf(params, spec, name, leaf, grid, cfg, scale, generator,
                 input_ids) -> dict:
    """One leaf's grid by the serial evaluator: a full-forward calibration
    PPL per candidate. Rank-0 and non-finite ratios score inf and come
    first, in the JAX package's order (the search's stable sort sees it)."""
    leaves = recomposed_dense_all_ratios(
        leaf["w"], leaf["b"], grid, scale, cfg.rank_align, cfg.svd_backend,
        generator)
    valid = [r for r in grid if leaves[r] is not None]
    out = {r: float("inf") for r in set(grid) - set(valid)}
    for ratio in valid:
        out[ratio] = evaluate_perplexity(
            set_linear(params, spec, name, leaves[ratio]), spec, input_ids,
            cfg.n_calib_samples)
    return out


def _scan_suffix_sensitivity(params, spec, input_ids, grid, cfg, *, stats,
                             fisher, include_extras, generator, resume=None,
                             scan_log=None) -> dict:
    """Layer-major scan loop for a uniform all-dense model (JAX :593-834).

    ``resume`` is the JSONL path of per-leaf results: leaves found there are
    replayed (their generator still drawn), the rest computed and appended.
    ``scan_log`` receives one dict per leaf computed in this call (name,
    layer, shape, backend, SVD and evaluation seconds, candidates)."""
    resume_state, oom_counts, oom_shapes = (
        _load_resume(resume) if resume else ({}, {}, set()))
    if resume_state:
        expected = linear_names(params, spec, include_extras)
        if all(n in resume_state for n in expected):
            log.info("sensitivity resume: all %d leaves cached in %s",
                     len(expected), resume)
            return {n: dict(resume_state[n][2]) for n in expected}
        log.info("sensitivity resume: %d leaves cached in %s",
                 len(resume_state), resume)

    dev = params["embed_tokens"].device
    limit = min(cfg.n_calib_samples, input_ids.shape[0])
    rows_np = np.asarray(input_ids[:limit])
    n, S = rows_np.shape
    # fixed-size row blocks with a masked remainder
    rb = _row_block(n, S)
    n_pad = -(-n // rb) * rb
    if n_pad > n:
        rows_np = np.concatenate(
            [rows_np, np.zeros((n_pad - n, S), rows_np.dtype)])
    valid_rows = (np.arange(n_pad) < n).astype(np.float32)
    h_blocks, l_blocks, m_blocks = [], [], []
    for i in range(0, n_pad, rb):
        blk = torch.as_tensor(rows_np[i:i + rb], device=dev)
        h_blocks.append(_embed_rows(params, spec, blk))
        l_blocks.append(blk[:, 1:])
        m_blocks.append(torch.as_tensor(valid_rows[i:i + rb], device=dev))

    sensitivity: dict = {}
    t0 = time.time()

    def finished(name, li, t_name):
        log.info("sensitivity %s done (%.1fs elapsed)", name, time.time() - t0)
        if resume:
            _append_resume(resume, name, li, time.time() - t_name,
                           sensitivity[name])

    def score(name, li, leaf, sub, eval_fn):
        """One leaf: its grid through the OOM ladder, its resume line."""
        t_name = time.time()
        rec = {}
        valid, ppls, finite = _grid_eval_oom_safe(
            lambda fb, shrink: _grid_eval_streamed(
                leaf, grid, cfg, _scale(name, stats, fisher, cfg.alpha), sub,
                eval_fn, force_backend=fb, chunk_shrink=shrink, record=rec),
            name, resume, oom_counts, leaf_shape(leaf), oom_shapes)
        sensitivity[name] = {}
        _fill(sensitivity, name, grid, valid, ppls, finite)
        if scan_log is not None:
            scan_log.append(dict(rec, name=name, li=li,
                                 shape=tuple(leaf_shape(leaf))))
        finished(name, li, t_name)

    def replayed(name):
        """Take a leaf from the resume file; False if it is not there."""
        if name not in resume_state:
            return False
        sensitivity[name] = dict(resume_state[name][2])
        return True

    for li in range(len(params["layers"])):
        for k in layer_linear_keys(spec):
            name = linear_name(spec, li, k)
            # drawn BEFORE the resume check: the stream is the same whether
            # a leaf is recomputed or replayed
            sub = split_generator(generator)
            if replayed(name):
                continue
            score(name, li, params["layers"][li][k], sub,
                  lambda wh, k=k, li=li: _blocks_ppl(n, (
                      _ppl_multi_ratio_suffix(params, spec, h, lab, m, k, li, wh)
                      for h, lab, m in zip(h_blocks, l_blocks, m_blocks))))
        # advance the cached prefix past this (dense) layer
        h_blocks = [_advance_block(params, spec, h, li) for h in h_blocks]

    if include_extras:
        for name in extra_linear_names(params, spec):
            sub = split_generator(generator)
            if replayed(name):
                continue
            leaf = get_linear(params, spec, name)
            if name == LM_HEAD_NAME:
                score(name, -1, leaf, sub,
                      lambda wh, b=leaf["b"]: _blocks_ppl(n, (
                          _ppl_head_grid(params, spec, h, lab, m, wh, b)
                          for h, lab, m in zip(h_blocks, l_blocks, m_blocks))))
                continue
            # OPT-350m project_in/out: before/after the whole decoder, no
            # suffix to save; serial full evals (2 leaves)
            t_name = time.time()
            sensitivity[name] = _serial_leaf(
                params, spec, name, leaf, grid, cfg,
                _scale(name, stats, fisher, cfg.alpha), sub, input_ids)
            finished(name, -1, t_name)
    return sensitivity


# --------------------------------------------------------- the dispatch ---

@torch.no_grad()
def calib_sensitivity_ppl(params, spec, calib_loader, cfg, *, stats=None,
                          fisher=None, cache=None,
                          generator: torch.Generator | None = None,
                          resume=None, scan_log=None) -> dict:
    """{full_name: {ratio: ppl}} via single-layer decompose + calib PPL
    (ref sensitivity.py:10-61). Always act-aware (ref :50).

    With ``cfg.sensitivity_batch_ratios`` on a model that ``can_scan`` the
    prefix-cached suffix evaluator runs, with ``resume`` and ``scan_log``
    as ``_scan_suffix_sensitivity`` takes them; otherwise the serial loop
    (JAX ``batch_ratios=False``). A leaf with no valid ratio (every rank 0
    or non-finite) records inf at every ratio."""
    if cache is not None:
        hit = cache.load_sensitivity(cfg.sensitivity_key())
        if hit is not None:
            log.info("sensitivity cache hit (%s)", cfg.sensitivity_key())
            return hit

    grid = KV_RATIO_GRID if cfg.compress_kv_cache else WEIGHT_RATIO_GRID
    input_ids = np.concatenate(
        [np.asarray(b["input_ids"]) for b in calib_loader], axis=0)
    include_extras = getattr(cfg, "compress_all_linears", True)
    if generator is None:
        generator = torch.Generator(device=params["embed_tokens"].device)
        generator.manual_seed(cfg.seed)

    if cfg.sensitivity_batch_ratios and can_scan(params, spec):
        sensitivity = _scan_suffix_sensitivity(
            params, spec, input_ids, grid, cfg, stats=stats, fisher=fisher,
            include_extras=include_extras, generator=generator,
            resume=resume, scan_log=scan_log)
    else:
        sensitivity = {}
        t0 = time.time()
        for name, leaf in iter_linears(params, spec, include_extras):
            if "A" in leaf:
                continue  # already low-rank; the reference scans raw models only
            sensitivity[name] = _serial_leaf(
                params, spec, name, leaf, grid, cfg,
                _scale(name, stats, fisher, cfg.alpha),
                split_generator(generator), input_ids)
            log.info("sensitivity %s done (%.1fs elapsed)", name,
                     time.time() - t0)

    if cache is not None:
        cache.save_json("sensitivity", cfg.sensitivity_key(), sensitivity)
    return sensitivity


@torch.no_grad()
def calib_sensitivity_stable_rank(params, spec, calib_loader, cfg,
                                  cache=None) -> dict:
    """Forward-free proxy (ref sensitivity.py:64-110): per layer,
    sr = (||W||_F^2 / sigma_max^2)^0.5, score[ratio] = -sr * ratio**0.1.
    Same-shaped weights take one batched SVD."""
    key_name = "sensitivity_stable_rank"
    if cache is not None:
        raw = cache.load_json(key_name, cfg.sensitivity_key())
        if raw is not None:
            return {n: {float(r): p for r, p in d.items()} for n, d in raw.items()}

    buckets: dict = defaultdict(list)
    for name, leaf in iter_linears(params, spec,
                                   getattr(cfg, "compress_all_linears", True)):
        if "A" in leaf:
            continue
        buckets[leaf_shape(leaf)].append((name, leaf["w"]))

    sensitivity: dict = {}
    for _, items in buckets.items():
        ws = torch.stack([w for _, w in items]).float()
        svs = singular_values(ws)                             # [L, min(m,n)]
        fro2 = (ws * ws).sum(dim=(1, 2))
        sr = torch.sqrt(fro2 / (svs[:, 0] ** 2))
        for (name, _), sr_i in zip(items, sr.cpu().numpy()):
            sensitivity[name] = {r: float(-sr_i * r ** 0.1)
                                 for r in STABLE_RANK_GRID}

    if cache is not None:
        cache.save_json(key_name, cfg.sensitivity_key(), sensitivity)
    return sensitivity
