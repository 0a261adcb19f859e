"""Continuous-batching engine over the paged KV pool.

Counterpart of asvd4llm_tpu/serving/engine.py. Host-side orchestration
(admission, page allocation, EOS retirement, the prefix cache) around one
``paged_decode_step`` whose shapes never change: [max_batch] slots,
[max_batch, max_pages] page table. On a CUDA device that step is a captured
CUDA graph (serving/paged.py::PagedDecoder), replayed once per token: the
host refreshes the decoder's device copies of the page table, positions and
current tokens with one copy each before the replays and reads the tokens
back once after them. Admission and chunked prefill stay eager (their
shapes vary, as the JAX package's separate jits do). Sequences of different lengths decode in
the same step — each row carries its own position, new requests join as
slots free up, and a finished request's pages return to the pool at once.
The pools and the device-side page table live on the params' device.

Page 0 is reserved as scratch: inactive slots point their whole page table
at it, so their masked writes never touch a live page.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from asvd4llm_tpu_torch.ops.lowrank import align_ranks
from asvd4llm_tpu_torch.serving.paged import (
    PagedDecoder, default_page_size, init_paged_pools, paged_append_batch_select,
    pages_needed, prefill_into_pages, sample_rows_keyed,
)

log = logging.getLogger(__name__)

# the smallest automatic page: an automatic page size keeps the pool's token
# capacity at num_pages * this many tokens
_AUTO_PAGE_UNIT = 64


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray            # [S]
    max_new_tokens: int
    tokens: list = field(default_factory=list)   # generated so far
    pages: list = field(default_factory=list)    # owned pool pages
    slot: int = -1
    filled: int = 0               # prompt tokens already in the cache
    done: bool = False
    # wall-clock latency markers (perf_counter seconds)
    t_enqueue: float = 0.0
    t_first: float = 0.0          # first generated token visible
    t_finish: float = 0.0

    @property
    def decoding(self) -> bool:
        return self.filled >= len(self.prompt)


class PagedEngine:
    """Greedy (or sampling) continuous-batching server over paged caches.

    Usage:
        eng = PagedEngine(params, spec, latent="kv")
        rid = eng.add_request(prompt_ids, max_new_tokens=32)
        eng.run()                  # or step() incrementally
        eng.result(rid)            # -> np.ndarray of generated tokens

    ``page_size=None`` picks the byte-sized default page and keeps the pool
    at ``num_pages * 64`` tokens (64 is the smallest automatic page), so an
    automatic page never grows the pool the caller asked for; an explicit
    ``page_size`` keeps ``num_pages`` as given.

    ``eager_steps`` is for measurements only, as ``form=`` is on the kernel
    wrappers: it runs each decode step as eager launches instead of
    replaying the captured graph (chip_smoke.py times both in turns). The
    tokens are the same either way.
    """

    def __init__(self, params, spec, *, max_batch: int = 4,
                 page_size: int | None = None, num_pages: int = 128,
                 max_pages_per_seq: int = 8, latent="auto",
                 eos_token_id=None, dtype=torch.float32,
                 use_pallas: bool | None = None, temperature: float = 0.0,
                 top_p: float = 1.0, seed: int = 0,
                 prefill_chunk: int = 0, prefix_cache: int = 0,
                 prefer_memory: bool = False, eager_steps: bool = False):
        # The JAX engine pre-pads q8/q4 code arrays to its kernels' tile grid
        # here; the port's kernels pad nothing per call, so nothing to do.
        self.params, self.spec = params, spec
        self.device = params["embed_tokens"].device
        if page_size is None:
            itemsize = torch.empty((), dtype=dtype).element_size()
            page_size = default_page_size(spec.num_kv_heads, spec.head_dim,
                                          itemsize)
            num_pages = max(2, -(-num_pages * _AUTO_PAGE_UNIT // page_size))
            log.info("auto page_size=%d, num_pages=%d (kv_heads=%d head_dim=%d)",
                     page_size, num_pages, spec.num_kv_heads, spec.head_dim)
        self.page_size = page_size
        self.eos_token_id = eos_token_id
        if latent == "auto" or use_pallas is None:
            from asvd4llm_tpu_torch.serving.layout import choose_layout
            # the per-sequence context bound stands in for the expected T
            dec = choose_layout(params, spec, device=self.device,
                                prefer_memory=prefer_memory,
                                expected_T=max_pages_per_seq * page_size)
            if latent == "auto":
                latent = dec.latent
            if use_pallas is None:
                use_pallas = dec.use_pallas
            log.info("layout auto-selection: latent=%r use_pallas=%s — %s",
                     dec.latent, dec.use_pallas, dec.reason)
        self.latent = latent
        self.use_pallas = use_pallas
        if use_pallas:
            # ranks zero-padded to the kernels' multiple, as generate does
            # (exact), so that the latent pools built below take the
            # tensor-core forms
            self.params = params = align_ranks(params, spec)
        self.prefill_chunk = int(prefill_chunk)
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.pools = init_paged_pools(params, spec, num_pages, page_size,
                                      dtype, latent=latent, device=self.device)
        self.page_table = np.zeros((max_batch, max_pages_per_seq), np.int32)
        self.positions = np.zeros((max_batch,), np.int32)
        self.cur_token = np.zeros((max_batch, 1), np.int64)
        self._decoder = PagedDecoder(params, spec, self.pools, max_batch,
                                     max_pages_per_seq, use_pallas=use_pallas,
                                     temperature=self.temperature, top_p=self.top_p,
                                     seed=self.seed, eager=eager_steps)
        self.slots: list[_Request | None] = [None] * max_batch
        # page 0 is the reserved scratch page for inactive slots
        self.free_pages = list(range(num_pages - 1, 0, -1))
        # automatic prefix caching (chunked admission only): finished
        # prefills register their whole-page prompt prefixes; a later
        # request sharing one points its page table at the same pool pages
        # and skips those prefill tokens. Pages are refcounted (owners + one
        # index ref each); prefix pages are read-only, since private writes
        # start at a page boundary. `prefix_cache` = max cached prefixes.
        self.prefix_cache = int(prefix_cache)
        self.page_refs: dict[int, int] = {}
        self._prefix_index: dict[bytes, list] = {}   # key -> [pages, lru]
        self._lru = 0
        self.waiting: list[_Request] = []
        self.requests: dict[int, _Request] = {}
        self._next_rid = 0
        # wall-clock phase breakdown (seconds): prefill/decode cover the
        # device work and the result fetch; host is scheduling bookkeeping
        self.phase_s = {"prefill": 0.0, "decode": 0.0, "host": 0.0}
        self.prefix_tokens_skipped = 0   # prompt tokens served by the prefix cache

    def _dev(self, arr):
        return torch.as_tensor(arr, device=self.device)

    # ------------------------------------------------------------ admin --

    def add_request(self, prompt_ids, max_new_tokens: int = 32) -> int:
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, np.asarray(prompt_ids, np.int64).reshape(-1),
                       max_new_tokens)
        req.t_enqueue = time.perf_counter()
        self.requests[rid] = req
        self.waiting.append(req)
        self._admit()
        return rid

    def result(self, rid: int) -> np.ndarray:
        return np.asarray(self.requests[rid].tokens, np.int32)

    def request_stats(self, rid: int) -> dict:
        """Per-request latency: TTFT (enqueue -> first generated token)
        and TPOT (mean inter-token time after the first)."""
        req = self.requests[rid]
        n = len(req.tokens)
        ttft = (req.t_first - req.t_enqueue) if req.t_first else None
        end = req.t_finish or req.t_first
        tpot = ((end - req.t_first) / (n - 1)
                if req.t_first and n > 1 else None)
        return {"rid": rid, "n_tokens": n, "prompt_tokens": len(req.prompt),
                "ttft_s": ttft, "tpot_s": tpot, "done": req.done}

    def stats(self) -> dict:
        """Aggregate engine stats: token counts, phase wall-clock, and
        TTFT/TPOT percentiles over finished requests."""
        # t_enqueue == 0 marks requests stuffed directly into slots
        done = [r for r in self.requests.values()
                if r.done and r.t_first and r.t_enqueue]
        ttfts = sorted(r.t_first - r.t_enqueue for r in done)
        tpots = sorted((r.t_finish - r.t_first) / (len(r.tokens) - 1)
                       for r in done if len(r.tokens) > 1)

        def pct(xs, p):
            return xs[min(len(xs) - 1, int(p * len(xs)))] if xs else None

        return {
            "requests_done": len(done),
            "tokens_generated": sum(len(r.tokens)
                                    for r in self.requests.values()),
            "phase_s": dict(self.phase_s),
            "prefix_tokens_skipped": self.prefix_tokens_skipped,
            "ttft_s": {"p50": pct(ttfts, 0.5), "p90": pct(ttfts, 0.9),
                       "max": ttfts[-1] if ttfts else None},
            "tpot_s": {"p50": pct(tpots, 0.5), "p90": pct(tpots, 0.9),
                       "max": tpots[-1] if tpots else None},
        }

    def _pick(self, logits_row, rid: int, q: int) -> int:
        """Greedy (temperature 0) or temperature/top-p sampling of the
        token at sequence index q of request rid from logits_row [vocab]
        on the device. Sampling runs the same position-keyed sampler as the
        multi-step decode (serving/paged.py::sample_rows_keyed), so both
        schedules emit identical tokens for identical seeds."""
        if self.temperature <= 0:
            return int(torch.argmax(logits_row))
        tok = sample_rows_keyed(logits_row[None, :], [rid], [q], self.seed,
                                self.temperature, self.top_p)
        return int(tok[0])

    def all_done(self) -> bool:
        return not self.waiting and all(s is None for s in self.slots)

    def _alloc(self, n: int) -> list:
        if len(self.free_pages) < n:
            raise RuntimeError(
                f"page pool exhausted ({n} needed, {len(self.free_pages)} "
                f"free) — raise num_pages or lower concurrency")
        pages = [self.free_pages.pop() for _ in range(n)]
        for p in pages:
            self.page_refs[p] = 1
        return pages

    def _release(self, pages):
        """Drop one reference per page; pages return to the pool at 0
        (shared prefix pages stay live while other requests or the prefix
        index still hold them)."""
        for p in pages:
            r = self.page_refs.get(p, 1) - 1
            if r <= 0:
                self.page_refs.pop(p, None)
                self.free_pages.append(p)
            else:
                self.page_refs[p] = r

    # -------------------------------------------------- prefix caching --

    def _prefix_key(self, prompt: np.ndarray, n_tokens: int) -> bytes:
        return np.ascontiguousarray(prompt[:n_tokens]).tobytes()

    def _prefix_lookup(self, prompt: np.ndarray):
        """Longest indexed whole-page prefix strictly shorter than the
        prompt (at least one token must prefill so the next-token logits
        exist). Returns (shared_pages, covered_tokens)."""
        if not (self.prefix_cache and self.prefill_chunk):
            return [], 0
        P = self.page_size
        for k in range((len(prompt) - 1) // P, 0, -1):
            hit = self._prefix_index.get(self._prefix_key(prompt, k * P))
            if hit is not None:
                self._lru += 1
                hit[1] = self._lru
                for p in hit[0]:
                    self.page_refs[p] = self.page_refs.get(p, 0) + 1
                return list(hit[0]), k * P
        return [], 0

    def _prefix_register(self, req: _Request):
        """Index every whole-page prefix of the request's prompt once it is
        fully cached; each entry holds its own page references. LRU-evict
        beyond capacity."""
        if not (self.prefix_cache and self.prefill_chunk):
            return
        P = self.page_size
        for k in range(1, len(req.prompt) // P + 1):
            key = self._prefix_key(req.prompt, k * P)
            if key in self._prefix_index:
                continue
            pages = req.pages[:k]
            for p in pages:
                self.page_refs[p] = self.page_refs.get(p, 0) + 1
            self._lru += 1
            self._prefix_index[key] = [pages, self._lru]
        while len(self._prefix_index) > self.prefix_cache:
            victim = min(self._prefix_index, key=lambda k:
                         self._prefix_index[k][1])
            self._release(self._prefix_index.pop(victim)[0])

    def clear_prefix_cache(self):
        for pages, _ in self._prefix_index.values():
            self._release(pages)
        self._prefix_index.clear()

    def _admit(self):
        """Move waiting requests into free slots.

        Whole-prompt mode (prefill_chunk == 0): prefill runs here, one
        request at a time. Chunked mode: admission only assigns the slot and
        pages; the prompt streams into the cache through _prefill_tick(),
        whose batched segments interleave with decode steps."""
        for slot in range(len(self.slots)):
            if self.slots[slot] is not None or not self.waiting:
                continue
            req = self.waiting.pop(0)
            S = len(req.prompt)
            n = pages_needed(S, self.page_size)
            if n > self.page_table.shape[1]:
                raise ValueError(f"prompt needs {n} pages > max_pages_per_seq")
            shared, covered = self._prefix_lookup(req.prompt)
            try:
                req.pages = shared + self._alloc(n - len(shared))
            except RuntimeError:
                self._release(shared)
                raise
            req.filled = covered     # shared prefix tokens never prefill
            self.prefix_tokens_skipped += covered
            req.slot = slot
            self.slots[slot] = req
            if self.prefill_chunk:
                # the decode view stays scratch (0) until decoding starts
                continue
            t0 = time.perf_counter()
            logits, self.pools = prefill_into_pages(
                self.params, self.spec, self._dev(req.prompt[None, :]),
                self.pools, req.pages)
            first = self._pick(logits[0], req.rid, S)
            self.phase_s["prefill"] += time.perf_counter() - t0
            req.filled = S
            self._start_decode(req, first)

    def _start_decode(self, req: _Request, first: int):
        """Prompt fully cached: emit the first token and expose the real
        pages and position to the decode step."""
        slot = req.slot
        req.tokens.append(first)
        req.t_first = time.perf_counter()
        self._prefix_register(req)
        self.page_table[slot, :] = 0
        self.page_table[slot, :len(req.pages)] = req.pages
        self.positions[slot] = len(req.prompt)
        self.cur_token[slot, 0] = first
        if self._finished(req):
            self._retire(req)

    def _prefill_tick(self):
        """One batched chunked-prefill step: every admitted request that is
        not decoding yet appends its next prefill_chunk prompt tokens
        (per-row positions and page tables; padded rows write scratch).
        Requests whose prompt completes in it enter decode."""
        filling = [r for r in self.slots if r is not None and not r.decoding]
        if not filling:
            return
        t0 = time.perf_counter()
        C = self.prefill_chunk
        MB = len(self.slots)
        ids = np.zeros((MB, C), np.int64)
        pt = np.zeros((MB, self.page_table.shape[1]), np.int32)
        pos0 = np.zeros((MB,), np.int32)
        # only requests whose prompt completes in this segment need
        # next-token logits: the head runs on those (row, column) pairs
        rows = np.zeros((MB,), np.int64)
        cols = np.zeros((MB,), np.int64)
        finishing = []
        for req in filling:
            c0 = req.filled
            seg = req.prompt[c0:c0 + C]
            ids[req.slot, :len(seg)] = seg
            pt[req.slot, :len(req.pages)] = req.pages
            pos0[req.slot] = c0
            if len(req.prompt) - c0 <= C:
                rows[len(finishing)] = req.slot
                cols[len(finishing)] = len(req.prompt) - 1 - c0
                finishing.append(req)
        logits, self.pools = paged_append_batch_select(
            self.params, self.spec, self._dev(ids), self.pools, self._dev(pt),
            self._dev(pos0), self._dev(rows), self._dev(cols))
        firsts = [self._pick(logits[i], req.rid, len(req.prompt))
                  for i, req in enumerate(finishing)]
        self.phase_s["prefill"] += time.perf_counter() - t0
        for req in filling:
            req.filled += min(C, len(req.prompt) - req.filled)
        for req, first in zip(finishing, firsts):
            self._start_decode(req, first)

    def _finished(self, req: _Request) -> bool:
        if len(req.tokens) >= req.max_new_tokens:
            return True
        return (self.eos_token_id is not None
                and req.tokens and req.tokens[-1] == self.eos_token_id)

    def _retire(self, req: _Request):
        slot = req.slot
        req.done = True
        req.t_finish = time.perf_counter()
        if not req.t_first and req.tokens:
            req.t_first = req.t_enqueue or req.t_finish
        self._release(req.pages)
        req.pages = []
        self.slots[slot] = None
        self.page_table[slot, :] = 0     # scratch page for the idle slot
        self.positions[slot] = 0
        self.cur_token[slot, 0] = 0
        self._admit()

    # ------------------------------------------------------------- step --

    def _grow_pages(self, active, n_steps: int):
        """Give every decoding slot the pages its next n_steps positions
        open."""
        for req in active:
            p0 = int(self.positions[req.slot])
            last_page = (p0 + n_steps - 1) // self.page_size
            if last_page >= self.page_table.shape[1]:
                raise RuntimeError(
                    f"request {req.rid} would exceed max_pages_per_seq")
            for page_idx in range(p0 // self.page_size, last_page + 1):
                if self.page_table[req.slot, page_idx] == 0:
                    new_page = self._alloc(1)[0]
                    req.pages.append(new_page)
                    self.page_table[req.slot, page_idx] = new_page

    def step(self):
        """One admission segment (chunked mode) and one decode token for
        every decoding slot (ragged positions): one replay of the decode
        graph, then the host's bookkeeping."""
        self.step_many(1)

    def step_many(self, n_steps: int):
        """Decode n_steps tokens per active slot with no host round trip
        in between (multi-step scheduling): n_steps replays of the decode
        graph, one copy of the tokens to the host, then admission and
        retirement. Rows finishing mid-chunk have their surplus tokens
        discarded — the same output as step() by step."""
        if self.prefill_chunk:
            self._prefill_tick()
        active = [s for s in self.slots if s is not None and s.decoding]
        if not active:
            return
        self._grow_pages(active, n_steps)

        rids = np.zeros((len(self.slots),), np.int64)
        for req in active:
            rids[req.slot] = req.rid
        t0 = time.perf_counter()
        toks = self._decoder.scan(self.cur_token, self.page_table, self.positions,
                                  n_steps, rids.tolist()).cpu().numpy()   # [B, n_steps]
        self.phase_s["decode"] += time.perf_counter() - t0
        t0 = time.perf_counter()

        for req in list(active):
            emitted = 0
            for tok in toks[req.slot]:
                req.tokens.append(int(tok))
                emitted += 1
                if self._finished(req):
                    break
            self.positions[req.slot] += emitted
            self.cur_token[req.slot, 0] = req.tokens[-1]
            if self._finished(req):
                self._retire(req)
        self.phase_s["host"] += time.perf_counter() - t0

    def run(self, max_steps: int = 10_000, chunk: int = 1):
        """Run until every request is done; chunk > 1 decodes chunk tokens
        per scheduling step (greedy or sampled: the same tokens either
        way)."""
        steps = 0
        while not self.all_done():
            if chunk > 1:
                self.step_many(chunk)
            else:
                self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("run() exceeded max_steps")

    def stream(self, max_steps: int = 10_000, chunk: int = 1):
        """Generator form of run(): yields (rid, token) pairs as tokens
        become visible to the host — once per token with chunk=1, once per
        scheduling chunk otherwise. Tokens come in emission order per
        request; requests may interleave."""
        sent: dict[int, int] = {}
        steps = 0
        while not self.all_done():
            if chunk > 1:
                self.step_many(chunk)
            else:
                self.step()
            for rid in list(self.requests):
                toks = self.requests[rid].tokens
                for t in toks[sent.get(rid, 0):]:
                    yield rid, int(t)
                sent[rid] = len(toks)
            steps += 1
            if steps > max_steps:
                raise RuntimeError("stream() exceeded max_steps")
