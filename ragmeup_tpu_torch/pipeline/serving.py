"""Continuous-batching serving engine for the local LLM over a paged KV pool.

Counterpart of ``ragmeup_tpu/pipeline/serving.py``:

- prompts prefill chunk by chunk straight into the shared ``PagedKVCache``
  pool (chunk-append attention, kernel #9 in its q_len > 1 mode); a group of
  concurrent arrivals prefills together, one forward per chunk for all;
- full pages are registered in the prefix cache, so a later prompt with the
  same leading tokens (the next turn of a thread, the next LLM call of the
  same /chat) reuses them instead of prefilling them again;
- every decode step runs ONE batched forward for all active sequences whose
  attention is the paged decode kernel (#9, q_len = 1); sequences join and
  retire independently;
- a *wave* runs ``steps`` decode+sample iterations with the sampling state
  on the device and no host sync until one (B, steps) token fetch; waves
  pipeline one deep (wave N+1 is enqueued before wave N's fetch);
- a *speculative wave* runs ``iters`` batched chunk forwards of width
  ``draft``: greedy rows verify a 2-gram prompt-lookup draft from their
  device-resident context and advance up to ``draft`` tokens a forward,
  temperature rows one. An adaptive gate (``_spec_gate``) falls back to
  plain waves while the measured tokens per forward stay below
  ``spec_accept_floor`` and re-probes every ``spec_reprobe_every``
  decisions.

Under a mesh (``LocalLLM(mesh=...)``) the pools are held per shard of the
model axis over kv heads, and each shard writes and attends its own heads.

``BatchedChatBackend`` puts the engine behind the ChatBackend interface: a
worker thread owns the engine (and with it all of its CUDA work, on one
stream); /chat threads only enqueue and wait.

Sampling (temperature, repetition penalty, EOS) follows ``LocalLLM``.
Temperature rows sample with ``torch.Generator``s (per sequence in
``step``, seeded from the seed and the wave counter in waves): sampled
streams are the port's own, greedy streams equal the JAX package's.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ragmeup_tpu_torch.models.decoder import (LocalLLM, _next_pow2_int, draft_greedy,
                                             penalize)
from ragmeup_tpu_torch.ops.paged_attention import PagedKVCache
from ragmeup_tpu_torch.ops.topk import rank_topk
from ragmeup_tpu_torch.pipeline.llm_backends import ChatBackend, llama3_template


class _SeqState:
    __slots__ = ("prompt_len", "pos", "out", "vals", "ids", "gen", "seen",
                 "max_new", "temperature", "rep_penalty", "done",
                 "dev_logits", "reserved_pages", "prompt_ids")

    def __init__(self, prompt_len, prompt_ids, vals, ids, seed, max_new,
                 temperature, rep_penalty, dev_logits, reserved_pages):
        self.prompt_len = prompt_len
        self.prompt_ids: List[int] = list(prompt_ids)
        self.pos = prompt_len
        self.out: List[int] = []
        self.vals = vals  # top-K logit values (host)
        self.ids = ids    # top-K token ids (host)
        self.gen = torch.Generator().manual_seed(seed)
        self.seen = set(int(t) for t in prompt_ids)
        self.max_new = max_new
        self.temperature = temperature
        self.rep_penalty = rep_penalty
        self.done = False
        self.dev_logits = dev_logits  # (V,) on the device, or None
        self.reserved_pages = reserved_pages


class ServingEngine:
    def __init__(self, llm: LocalLLM, num_pages: int = 256,
                 page_size: int = 64, max_pages_per_seq: int = 16,
                 max_batch: int = 16, topk_support: int = 64,
                 prefill_chunk: int = 256, prefix_cache: bool = True,
                 spec_accept_floor: float = 1.35, spec_reprobe_every: int = 16):
        """``spec_accept_floor``: the greedy rows' emitted tokens per spec
        forward (an EWMA over waves) below which ``_spec_gate`` falls back
        to plain waves, re-probing spec every ``spec_reprobe_every``
        decisions; 0 keeps spec on whenever it is asked for."""
        self.llm = llm
        cfg = llm.cfg
        self.spec_accept_floor = spec_accept_floor
        self.spec_reprobe_every = max(spec_reprobe_every, 1)
        self._spec_accept: Optional[float] = None
        self._spec_waves = 0
        self._spec_mode = "spec"
        self._spec_probe_left = 0
        self._spec_gate_iters = 0  # the re-probe tail guard's wave length
        self.page_size = page_size
        # sampling happens within the top-K support (greedy is exact: the
        # argmax is always in it)
        self.topk_support = min(topk_support, cfg.vocab_size)
        self.max_pages_per_seq = max_pages_per_seq
        self.max_batch = max_batch
        self.device = llm.device
        # a model-sharded LLM (parallel.model_axis > 1) serves from pools held
        # per shard over kv heads; tables, admission and sampling are the same
        self.mesh = getattr(llm, "mesh", None)
        self.cache = PagedKVCache(num_pages, page_size, cfg.num_kv_heads,
                                  cfg.head_dim, cfg.num_layers,
                                  dtype=cfg.torch_dtype, device=self.device,
                                  mesh=self.mesh)
        # reserved trash page: batch-padding rows write here harmlessly
        self.cache.allocate("__pad__", 1)
        self._trash = self.cache.seq_pages["__pad__"][0]
        self.seqs: Dict[object, _SeqState] = {}
        # the JAX package caps the prefill chunk so its TPU kernel's VMEM
        # accumulators stay ~2 MB (128 tokens at 8B). The cap means nothing
        # on the GPU, but keeping it keeps chunk boundaries, and so the
        # rounding, equal to the reference.
        vmem_cap = max(32, (2 * 1024 * 1024)
                       // max(cfg.num_heads * cfg.head_dim * 4, 1))
        pow2 = 32
        while pow2 * 2 <= vmem_cap:
            pow2 *= 2
        self.prefill_chunk = min(prefill_chunk, pow2)
        self.prefix_cache = prefix_cache
        self._eos = torch.tensor(sorted(llm.eos_ids) or [-1], dtype=torch.int32,
                                 device=self.device)
        self._wave_counter = 0
        # at most one carry is live: setting one clears the other
        self._wave_state: Optional[dict] = None
        self._spec_state: Optional[dict] = None
        self._infl_steps: Dict[object, int] = {}
        self._spec_infl: Dict[object, int] = {}
        self._B_hwm = 0
        # per-dispatch host timings when set to a list (observability)
        self.wave_timings: Optional[list] = None

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """Host array → device, without waiting for queued device work."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device,
                                                            non_blocking=True)

    def _forward(self, ids, positions, page_idx, lengths, pages, slots,
                 head_at=None, skip_head: bool = False):
        c = self.cache
        return self.llm.model(ids, positions,
                              paged_caches=list(zip(c.k_pages, c.v_pages)),
                              paged_meta=(page_idx, lengths, pages, slots),
                              head_at=head_at, skip_head=skip_head)

    def _support(self, logits: torch.Tensor):
        """(vals f32, ids) of each row's top-K support on the host, ordered
        by (-score, index): one fetch for all rows."""
        vals, ids = rank_topk(logits.float(), self.topk_support)
        return vals.cpu().numpy(), ids.to(torch.int32).cpu().numpy()

    # -- admission control --------------------------------------------------------

    def _lifetime_pages(self, n_prompt: int, max_new: int) -> int:
        """Worst-case page count a request will ever hold (after the same
        prompt truncation add_request applies)."""
        max_prompt = self.max_pages_per_seq * self.page_size - max_new
        n = min(n_prompt, max(max_prompt, 8))
        toks = min(n + max_new, self.max_pages_per_seq * self.page_size)
        return -(-toks // self.page_size)

    def can_admit(self, n_prompt: int, max_new: int,
                  extra_reserved: int = 0) -> bool:
        """True if the pool can cover this request's FULL lifetime on top of
        every active sequence's outstanding reservation, so a mid-decode
        ``extend`` never runs out of pages. ``extra_reserved`` counts
        requests already collected into the same admission group."""
        need = self._lifetime_pages(n_prompt, max_new)
        outstanding = extra_reserved
        for sid, st in self.seqs.items():
            if st.done:
                continue
            held = len(self.cache.seq_pages.get(sid, []))
            outstanding += max(0, st.reserved_pages - held)
        return self.cache.available_pages - outstanding >= need

    # -- request lifecycle -------------------------------------------------------

    def _truncate(self, prompt_ids: Sequence[int], max_new: int) -> List[int]:
        """Cap a prompt by the page budget and the model's context window."""
        msl = self.llm.cfg.max_seq_len
        max_prompt = min(self.max_pages_per_seq * self.page_size - max_new,
                         msl - min(max_new, msl // 2))
        return list(prompt_ids)[-max(max_prompt, 8):]

    @torch.inference_mode()
    def add_request(self, seq_id, prompt_ids: Sequence[int],
                    max_new_tokens: int = 100, temperature: float = 0.2,
                    repetition_penalty: float = 1.1, seed: int = 0) -> None:
        """Prefill the prompt into the page pool and queue it for decoding."""
        if seq_id in self.seqs:
            raise ValueError(f"duplicate seq_id {seq_id}")
        prompt_ids = self._truncate(prompt_ids, max_new_tokens)
        n = len(prompt_ids)
        logits = self._prefill_into_pages(seq_id, prompt_ids)
        vals, ids = self._support(logits[None])
        self.seqs[seq_id] = _SeqState(
            n, prompt_ids, vals[0].copy(), ids[0].copy(), seed, max_new_tokens,
            temperature, repetition_penalty, logits,
            self._lifetime_pages(n, max_new_tokens))
        self._spec_track_reset()  # a new prompt re-earns speculation

    def _prefill_into_pages(self, seq_id, prompt_ids):
        """Chunked paged prefill of one prompt; returns the last real
        token's logits. With the prefix cache, leading full pages already
        registered are reused and prefill starts at the first uncached
        position (the chunk kernel attends reused pages exactly as it would
        freshly written ones)."""
        ps = self.page_size
        cs = self.prefill_chunk
        n = len(prompt_ids)
        if self.prefix_cache:
            n_cached = self.cache.allocate_prefixed(seq_id, prompt_ids)
        else:
            self.cache.allocate(seq_id, n)
            n_cached = 0
        plist = self.cache.seq_pages[seq_id]
        page_idx = np.zeros((1, self.max_pages_per_seq), np.int32)
        page_idx[0, :len(plist)] = plist
        page_idx_d = self._tensor(page_idx)
        max_pos = self.llm.cfg.max_seq_len - 1
        logits = None
        for c0 in range(n_cached, n, cs):
            chunk = prompt_ids[c0:c0 + cs]
            m = len(chunk)
            ids = np.zeros((1, cs), np.int64)
            ids[0, :m] = chunk
            positions = np.clip(np.arange(c0, c0 + cs), 0, max_pos)[None]
            pages = np.full(cs, self._trash, np.int64)
            slots = np.arange(cs, dtype=np.int64) % ps  # pad rows: trash
            for j in range(m):
                pages[j] = plist[(c0 + j) // ps]
                slots[j] = (c0 + j) % ps
            # length counts the WHOLE chunk (pad rows included): real row j
            # then gets causal limit c0+j+1; pad rows are never read
            length = self._tensor(np.asarray([c0 + cs], np.int32))
            final = c0 + cs >= n
            out = self._forward(self._tensor(ids), self._tensor(positions),
                                page_idx_d, length, self._tensor(pages),
                                self._tensor(slots), head_at=m - 1,
                                skip_head=not final)
            if final:
                logits = out[0, 0]
        if self.prefix_cache:
            # register the prompt's full pages NOW: concurrent requests and
            # the same /chat's later calls reuse them while this one decodes
            self.cache.register_prefix(seq_id, prompt_ids)
        return logits

    def add_requests(self, reqs: List[dict]) -> None:
        """Admit several requests at once; more than one prefill TOGETHER,
        chunk by chunk. Each req dict: {id, prompt_ids, max_new,
        temperature, rp, seed?}."""
        if len(reqs) > 1:
            self._add_requests_batched(reqs)
            return
        for r in reqs:
            self.add_request(r["id"], r["prompt_ids"],
                             max_new_tokens=r["max_new"],
                             temperature=r["temperature"],
                             repetition_penalty=r["rp"],
                             seed=r.get("seed", 0))

    @torch.inference_mode()
    def _add_requests_batched(self, reqs: List[dict]) -> None:
        items = []
        try:
            for r in reqs:
                if r["id"] in self.seqs:
                    raise ValueError("duplicate seq_id %s" % r["id"])
                pids = self._truncate(r["prompt_ids"], r["max_new"])
                if self.prefix_cache:
                    n_cached = self.cache.allocate_prefixed(r["id"], pids)
                else:
                    self.cache.allocate(r["id"], len(pids))
                    n_cached = 0
                items.append((r, pids, n_cached))
        except Exception:
            for r, _, _ in items:  # release the group's partial allocations
                self.cache.free(r["id"])
            raise
        try:
            self._run_batched_prefill(items)
        except Exception:
            for r, _, _ in items:
                self.cache.free(r["id"])
                self.seqs.pop(r["id"], None)
            raise

    def _run_batched_prefill(self, items) -> None:
        """items: [(req, pids, n_cached)]. Rows prefill only their uncached
        tail; per-row positions and lengths let cached and uncached rows
        share each chunk forward."""
        ps = self.page_size
        cs = self.prefill_chunk
        b = len(items)
        max_pos = self.llm.cfg.max_seq_len - 1
        n_chunks = max(-(-(len(p) - nc) // cs) for _, p, nc in items)
        page_idx = np.zeros((b, self.max_pages_per_seq), np.int32)
        page_idx[:, 0] = self._trash
        for i, (r, _, _) in enumerate(items):
            plist = self.cache.seq_pages[r["id"]]
            page_idx[i, :len(plist)] = plist
        page_idx_d = self._tensor(page_idx)
        logits_rows = [None] * b
        for ci in range(n_chunks):
            ids = np.zeros((b, cs), np.int64)
            positions = np.tile(np.clip(np.arange(ci * cs, (ci + 1) * cs), 0,
                                        max_pos), (b, 1))
            pages = np.full((b, cs), self._trash, np.int64)
            slots = np.tile(np.arange(cs, dtype=np.int64) % ps, (b, 1))
            lengths = np.full(b, cs, np.int32)
            head_at = np.zeros(b, np.int64)
            ends_here = []
            for i, (r, pids, nc) in enumerate(items):
                c0 = nc + ci * cs  # this row's absolute chunk start
                m = min(len(pids) - c0, cs)
                if m <= 0:
                    continue
                ids[i, :m] = pids[c0:c0 + m]
                positions[i] = np.clip(np.arange(c0, c0 + cs), 0, max_pos)
                plist = self.cache.seq_pages[r["id"]]
                for j in range(m):
                    pages[i, j] = plist[(c0 + j) // ps]
                    slots[i, j] = (c0 + j) % ps
                lengths[i] = c0 + cs
                if c0 + m >= len(pids):
                    head_at[i] = m - 1
                    ends_here.append(i)
            out = self._forward(self._tensor(ids), self._tensor(positions),
                                page_idx_d, self._tensor(lengths),
                                self._tensor(pages), self._tensor(slots),
                                head_at=self._tensor(head_at),
                                skip_head=not ends_here)
            for i in ends_here:
                logits_rows[i] = out[i, 0]
        # one fetch for ALL rows' top-K supports
        vals, ids = self._support(torch.stack(logits_rows))
        for i, (r, pids, _) in enumerate(items):
            self.seqs[r["id"]] = _SeqState(
                len(pids), pids, vals[i].copy(), ids[i].copy(),
                r.get("seed", 0), r["max_new"], r["temperature"], r["rp"],
                logits_rows[i], self._lifetime_pages(len(pids), r["max_new"]))
            if self.prefix_cache:
                self.cache.register_prefix(r["id"], pids)
        self._spec_track_reset()

    def _sample(self, st: _SeqState) -> int:
        """Sample within the top-K support (penalty + temperature)."""
        if st.vals is None:
            # host snapshot invalidated by a wave: refresh from the
            # device-resident logits
            vals, ids = self._support(st.dev_logits[None])
            st.vals, st.ids = vals[0], ids[0]
        lg = st.vals.copy()
        if st.rep_penalty and st.rep_penalty != 1.0 and st.seen:
            hit = np.isin(st.ids, np.fromiter(st.seen, dtype=np.int64))
            lg = np.where(hit, np.where(lg > 0, lg / st.rep_penalty,
                                        lg * st.rep_penalty), lg)
        if st.temperature and st.temperature > 0:
            probs = torch.softmax(torch.from_numpy(lg / st.temperature).double(), 0)
            j = int(torch.multinomial(probs, 1, generator=st.gen))
        else:
            j = int(np.argmax(lg))
        return int(st.ids[j])

    def _flush_wave_state(self) -> None:
        """Write the live carry's (wave or spec) per-row logits back to their
        sequences and drop both carries. Runs before any host-side change
        the carry would shadow (single step, retire, batch membership
        change)."""
        for prev in (self._wave_state, self._spec_state):
            if prev is not None:
                for j, old_sid in enumerate(prev["sig"][0]):
                    if old_sid in self.seqs:
                        self.seqs[old_sid].dev_logits = prev["logits"][j]
        self._wave_state = None
        self._spec_state = None

    @torch.inference_mode()
    def step(self) -> int:
        """Sample one token for every active sequence, run one batched paged
        decode step. Returns the number of sequences still active."""
        self._flush_wave_state()  # the single-step path mutates host state
        active = [(sid, st) for sid, st in self.seqs.items() if not st.done]
        if not active:
            return 0
        active = active[:self.max_batch]
        batch, toks = [], []
        for sid, st in active:
            tok = self._sample(st)
            if tok in self.llm.eos_ids or len(st.out) >= st.max_new or \
                    st.pos + 1 >= self.max_pages_per_seq * self.page_size:
                st.done = True
                continue
            st.out.append(tok)
            st.seen.add(tok)
            batch.append((sid, st))
            toks.append(tok)
        if not batch:
            return sum(1 for _, st in self.seqs.items() if not st.done)
        # columns [token, position, page, slot, length, page_idx...]
        B = _next_pow2_int(len(batch))
        mp = self.max_pages_per_seq
        meta = np.zeros((B, mp + 5), np.int64)
        meta[:, 2] = self._trash  # pad rows write the trash page
        meta[:, 4] = 1
        meta[:, 5] = self._trash
        for i, (sid, st) in enumerate(batch):
            self.cache.extend(sid, 1)
            plist = self.cache.seq_pages[sid]
            meta[i, 0] = toks[i]
            meta[i, 1] = st.pos
            meta[i, 2] = plist[st.pos // self.page_size]
            meta[i, 3] = st.pos % self.page_size
            meta[i, 4] = st.pos + 1
            meta[i, 5:5 + len(plist)] = plist
        m = self._tensor(meta)
        logits = self._forward(m[:, 0:1], m[:, 1:2], m[:, 5:], m[:, 4],
                               m[:, 2], m[:, 3])
        vals, ids = self._support(logits[:, 0])
        for i, (sid, st) in enumerate(batch):
            st.vals = vals[i].copy()
            st.ids = ids[i]
            st.pos += 1
            st.dev_logits = None  # the host top-K is fresh, the device copy is not kept
        return sum(1 for _, st in self.seqs.items() if not st.done)

    def run(self, max_steps: Optional[int] = None) -> Dict[object, List[int]]:
        """Step until every sequence finishes; returns generated ids."""
        steps = 0
        while self.step() > 0:
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.results()

    def results(self) -> Dict[object, List[int]]:
        return {sid: list(st.out) for sid, st in self.seqs.items()}

    def retire(self, seq_id) -> List[int]:
        """Free a finished sequence's pages and return its tokens. With the
        prefix cache its confirmed stream (prompt + generated) registers its
        full pages for later requests that share the prefix."""
        # flush first: survivors keep their current logits, and a later
        # add_request reusing this seq_id cannot inherit the old carry
        self._flush_wave_state()
        st = self.seqs.pop(seq_id)
        reg = (list(st.prompt_ids) + list(st.out)
               if self.prefix_cache and st.prompt_ids else None)
        self.cache.free(seq_id, register_tokens=reg)
        return list(st.out)

    # -- waves: N tokens per dispatch, sampling on the device ------------------------

    def wave_once(self, steps: int = 8, seed: int = 0) -> int:
        """One wave: decode up to `steps` tokens for every active sequence
        with one host fetch. Returns the sequences still active."""
        entry = self._wave_dispatch(steps, seed, allow_rebuild=True)
        if entry is None:
            return 0
        return self._wave_collect(entry)

    @torch.inference_mode()
    def _wave_dispatch(self, steps: int, seed: int, allow_rebuild: bool):
        """Enqueue one wave without waiting for its tokens. Returns an entry
        for _wave_collect, None when nothing is active, or "drain" when the
        batch membership changed but in-flight waves must be collected
        before the host state can be rebuilt.

        Pipelining is sound because a row either advances exactly `steps`
        positions or goes done for good on the device (done rows write the
        trash page), so wave N+1's page tables can be built from host
        positions before wave N's tokens arrive."""
        t0 = time.perf_counter()
        active = [(sid, st) for sid, st in self.seqs.items()
                  if not st.done][:self.max_batch]
        if not active:
            return None
        # B stays at the engine-wide high-water mark: done rows ride as
        # masked pad rows (the JAX package does so to keep one program
        # shape; here it keeps the carry's shape stable)
        B = max(_next_pow2_int(len(active)), self._B_hwm)
        self._B_hwm = B
        limit = self.max_pages_per_seq * self.page_size
        mpp = self.max_pages_per_seq
        sig = (tuple(sid for sid, _ in active), B, steps)
        prev = self._wave_state
        infl = self._infl_steps
        if (prev is None or prev["sig"] != sig) and not allow_rebuild:
            return "drain"

        # per-step (page, slot) tables + page index from host bookkeeping,
        # one upload: [pages_step | slots_step | page_idx]
        tables = np.zeros((B, 2 * steps + mpp), np.int64)
        tables[:, :steps] = self._trash
        tables[:, 2 * steps] = self._trash
        for i, (sid, st) in enumerate(active):
            p0 = int(st.pos) + infl.get(sid, 0)  # optimistic when pipelined
            room = min(steps, limit - 1 - p0)
            if room > 0:
                self.cache.seq_len[sid] = p0
                self.cache.extend(sid, room)
                self.cache.seq_len[sid] = int(st.pos)  # truth kept on host
            plist = self.cache.seq_pages[sid]
            tables[i, 2 * steps:2 * steps + len(plist)] = plist
            for ss in range(steps):
                tp = p0 + ss
                if tp < limit and tp // self.page_size < len(plist):
                    tables[i, ss] = plist[tp // self.page_size]
                    tables[i, steps + ss] = tp % self.page_size

        if prev is not None and prev["sig"] == sig:
            carry = prev
        else:
            self._flush_wave_state()
            carry = self._build_carry(active, B)

        t1 = time.perf_counter()
        gen = None
        if carry["sampled"]:
            gen = torch.Generator(device=self.device)
            gen.manual_seed((seed * 1_000_003 + self._wave_counter) % (2 ** 63))
        self._wave_counter += 1
        out, new = self._wave_run(carry, self._tensor(tables), steps, gen)
        t2 = time.perf_counter()
        self._wave_state = dict(carry, **new, sig=sig)
        for sid, _ in active:
            infl[sid] = infl.get(sid, 0) + steps
        if self.wave_timings is not None:
            self.wave_timings.append({"prep": t1 - t0, "dispatch": t2 - t1})
        return {"active": active, "out": out, "steps": steps}

    def _build_carry(self, active, B: int) -> dict:
        """A wave's device carry rebuilt from host state: each active row's
        logits, seen set, position, budget and sampling knobs; rows past the
        active ones are pad rows, done for good."""
        V = self.llm.cfg.vocab_size
        logits = torch.zeros((B, V), dtype=torch.float32, device=self.device)
        seen = np.zeros((B, V), bool)
        pos = np.zeros(B, np.int32)
        emitted = np.zeros(B, np.int32)
        done = np.ones(B, bool)  # pad rows are done for good
        temps = np.zeros(B, np.float32)
        rps = np.ones(B, np.float32)
        max_new = np.zeros(B, np.int32)
        for i, (sid, st) in enumerate(active):
            if st.dev_logits is None:
                # row last advanced by the single-step path: rebuild from
                # the host top-K support (its next token samples as
                # _sample would; later tokens use full-vocab logits)
                full = np.full(V, -1e30, np.float32)
                full[np.asarray(st.ids)] = st.vals
                logits[i] = self._tensor(full)
            else:
                logits[i] = st.dev_logits
            if st.seen:
                seen[i, np.fromiter(st.seen, dtype=np.int64)] = True
            pos[i] = st.pos
            emitted[i] = len(st.out)
            done[i] = False
            temps[i] = st.temperature
            rps[i] = st.rep_penalty
            max_new[i] = st.max_new
        return {"logits": logits, "seen": self._tensor(seen),
                "done": self._tensor(done), "emitted": self._tensor(emitted),
                "pos": self._tensor(pos), "temps": self._tensor(temps),
                "rps": self._tensor(rps), "max_new": self._tensor(max_new),
                "sampled": bool((temps > 0).any())}

    def _wave_run(self, carry: dict, tables: torch.Tensor, steps: int,
                  gen: Optional[torch.Generator]):
        """`steps` decode+sample iterations on the device (the JAX
        package's _wave_program): penalty, temperature (Gumbel-max over the
        full vocabulary, as jax.random.categorical) or argmax, EOS, and one
        batched paged decode forward each. Nothing here waits for the
        device. Returns (tokens (B, steps) with -1 holes, the new carry)."""
        logits, seen = carry["logits"], carry["seen"]
        done, emitted, pos = carry["done"], carry["emitted"], carry["pos"]
        temps, rps, max_new = carry["temps"], carry["rps"], carry["max_new"]
        B, V = logits.shape
        pages_step = tables[:, :steps]
        slots_step = tables[:, steps:2 * steps]
        page_idx = tables[:, 2 * steps:]
        rows = torch.arange(B, device=self.device)
        out = torch.full((B, steps), -1, dtype=torch.int32, device=self.device)
        hit = (rps != 1.0)[:, None]
        for s in range(steps):
            lg = penalize(logits, seen & hit, rps[:, None])
            tok = torch.argmax(lg, dim=1)
            if gen is not None:
                u = torch.rand((B, V), generator=gen, device=self.device)
                gumbel = -torch.log(-torch.log(u))
                sampled = torch.argmax(lg / temps.clamp_min(1e-6)[:, None]
                                       + gumbel, dim=1)
                tok = torch.where(temps > 0, sampled, tok)
            is_eos = (tok[:, None] == self._eos[None, :]).any(dim=1)
            emit = ~done & ~is_eos & (emitted < max_new)
            out[:, s] = torch.where(emit, tok, -1).to(torch.int32)
            seen[rows, tok] = seen[rows, tok] | emit
            done = done | is_eos | (emitted >= max_new)
            emitted = emitted + emit.to(emitted.dtype)
            w_pages = torch.where(emit, pages_step[:, s], self._trash)
            w_slots = torch.where(emit, slots_step[:, s], 0)
            tok_in = torch.where(emit, tok, 0)
            logits = self._forward(tok_in[:, None], pos[:, None].long(),
                                   page_idx, pos + 1, w_pages, w_slots)[:, 0]
            pos = pos + emit.to(pos.dtype)
        return out, {"logits": logits, "seen": seen, "done": done,
                     "emitted": emitted, "pos": pos}

    def _wave_collect(self, entry) -> int:
        """Fetch one in-flight wave's tokens and update host state. Returns
        the number of sequences still active."""
        t0 = time.perf_counter()
        steps = entry["steps"]
        limit = self.max_pages_per_seq * self.page_size
        infl = self._infl_steps
        toks = entry["out"].cpu().numpy()  # ONE fetch per B * steps tokens
        if self.wave_timings is not None:
            self.wave_timings.append({"fetch": time.perf_counter() - t0})
        for i, (sid, st) in enumerate(entry["active"]):
            row = [int(t) for t in toks[i] if t >= 0]
            st.out.extend(row)
            st.seen.update(row)
            st.pos += len(row)
            if sid in self.seqs:  # not retired while in flight
                self.cache.seq_len[sid] = st.pos
            left = infl.get(sid, 0) - steps
            if left > 0:
                infl[sid] = left
            else:
                infl.pop(sid, None)
            st.vals = None  # the host top-K snapshot is stale now
            if len(row) < steps or len(st.out) >= st.max_new or \
                    st.pos + 1 >= limit:
                st.done = True
        return sum(1 for _, st in self.seqs.items() if not st.done)

    def run_wave(self, steps_per_dispatch: int = 8, seed: int = 0,
                 pipeline: bool = True) -> Dict[object, List[int]]:
        """Decode all active sequences to completion in waves. With
        pipeline=True wave N+1 is enqueued before wave N's tokens are
        fetched; token streams equal the unpipelined path's (the sampling
        seed depends only on the dispatch counter)."""
        if not pipeline:
            while self.wave_once(steps=steps_per_dispatch, seed=seed) > 0:
                pass
            return self.results()
        q: deque = deque()
        while True:
            if self._more(use_spec=False):
                entry = self._wave_dispatch(steps_per_dispatch, seed,
                                            allow_rebuild=not q)
                if entry == "drain":
                    self._wave_collect(q.popleft())
                    continue
                if entry is None:
                    break
                q.append(entry)
                if len(q) >= 2:
                    self._wave_collect(q.popleft())
            elif q:
                self._wave_collect(q.popleft())
            else:
                break
        return self.results()


    # -- speculative waves: up to `draft` tokens a forward for greedy rows ---------

    @property
    def spec_supported(self) -> bool:
        """Spec waves write a chunk per row, which needs one token per pool
        row: the port's pool always has it (ops/paged_attention.py), so this
        is always true, and the JAX package's fallback to plain waves on
        its packed layout has no counterpart here."""
        return True

    def spec_wave_once(self, iters: int = 4, draft: int = 8, seed: int = 0) -> int:
        """One synchronous spec wave (dispatch + collect). Returns the
        sequences still active."""
        entry = self._spec_dispatch(iters, draft, seed, allow_rebuild=True)
        if entry is None:
            return 0
        return self._spec_collect(entry)

    def _ctx_rows(self, active, B: int) -> torch.Tensor:
        """(B, limit) confirmed tokens (prompt + collected output) of each
        active row, -1 after them: the drafts' source."""
        T = self.max_pages_per_seq * self.page_size
        ctx = np.full((B, T), -1, np.int64)
        for i, (_, st) in enumerate(active):
            confirmed = (list(st.prompt_ids) + list(st.out))[:T]
            ctx[i, :len(confirmed)] = confirmed
        return self._tensor(ctx)

    @torch.inference_mode()
    def _spec_dispatch(self, iters: int, draft: int, seed: int, allow_rebuild: bool):
        """Enqueue one spec wave without waiting for its tokens. Returns an
        entry for _spec_collect, None when nothing is active, or "drain"
        when the batch membership changed while waves are in flight.

        A row's advance is data-dependent, its write cover is not: each
        row's pages are extended to its position plus the in-flight waves'
        advance plus this wave's iters * draft (clamped by max_new and the
        page limit), and the device sends writes past the cover to the
        trash page, so wave N+1 can be enqueued before wave N's tokens
        arrive; the carry (pos, emitted, ctx) flows from one to the next on
        the device. Temperature rows sample from a generator seeded by the
        seed and the dispatch counter, so pipelining leaves the streams as
        they are."""
        t0 = time.perf_counter()
        active = [(sid, st) for sid, st in self.seqs.items()
                  if not st.done][:self.max_batch]
        if not active:
            return None
        B = max(_next_pow2_int(len(active)), self._B_hwm)
        self._B_hwm = B
        limit = self.max_pages_per_seq * self.page_size
        sig = (tuple(sid for sid, _ in active), B, iters, draft)
        prev = self._spec_state
        infl = self._spec_infl
        if (prev is None or prev["sig"] != sig) and not allow_rebuild:
            return "drain"

        page_idx = np.zeros((B, self.max_pages_per_seq), np.int64)
        page_idx[:, 0] = self._trash
        cover = np.zeros(B, np.int64)
        for i, (sid, st) in enumerate(active):
            room = min(infl.get(sid, 0) + iters * draft, limit - 1 - int(st.pos),
                       st.max_new - len(st.out))
            if room > 0:
                self.cache.extend(sid, room)
                self.cache.seq_len[sid] = int(st.pos)  # truth kept on host
            cover[i] = int(st.pos) + max(room, 0)
            plist = self.cache.seq_pages[sid]
            page_idx[i, :len(plist)] = plist

        wprev = self._wave_state
        if prev is not None and prev["sig"] == sig:
            carry = prev
        elif wprev is not None and wprev["sig"][:2] == sig[:2]:
            # wave -> spec over the same rows (a re-probe): adopt the wave
            # carry; only ctx is new, and the host knows it, since a kind
            # switch comes after a drain. At most one carry is live (each
            # dispatch that sets one clears the other), so no spec carry
            # is left to flush here.
            assert prev is None
            carry = {k: v for k, v in wprev.items() if k != "sig"}
            carry["ctx"] = self._ctx_rows(active, B)
            self._wave_state = None
        else:
            self._flush_wave_state()
            carry = self._build_carry(active, B)
            carry["ctx"] = self._ctx_rows(active, B)

        t1 = time.perf_counter()
        gen = None
        if carry["sampled"]:
            gen = torch.Generator(device=self.device)
            gen.manual_seed((seed * 1_000_003 + self._wave_counter) % (2 ** 63))
        self._wave_counter += 1
        packed, new = self._spec_run(carry, self._tensor(cover), self._tensor(page_idx),
                                     iters, draft, gen)
        self._spec_state = dict(carry, **new, sig=sig)
        for sid, _ in active:
            infl[sid] = infl.get(sid, 0) + iters * draft
        if self.wave_timings is not None:
            self.wave_timings.append({"prep": t1 - t0,
                                      "dispatch": time.perf_counter() - t1,
                                      "spec": True})
        return {"active": active, "packed": packed, "iters": iters, "draft": draft}

    def _spec_run(self, carry: dict, cover: torch.Tensor, page_idx: torch.Tensor,
                  iters: int, draft: int, gen: Optional[torch.Generator]):
        """`iters` batched chunk forwards of width `draft` on the device (the
        JAX package's _wave_spec_program); nothing here waits for the
        device. Each iteration samples every row's pending token from the
        carried logits as _wave_run does; a greedy row appends the 2-gram
        draft from its context (the last match whose continuation is
        confirmed); one chunk forward (#9's chunk mode, lengths = pos + d)
        verifies all rows; a greedy row emits its pending token and the
        drafts that equal the penalized argmax before them, a temperature
        row its pending token. The next logits are those after the last
        emitted token.

        Parity: every emitted token is the penalized argmax of the logits
        its own verify forward computed. The d-wide chunk forward and the
        one-token decode forward round differently in their last bits, so
        where an argmax margin is below that difference a spec and a plain
        stream can pick different tokens.

        Returns (packed (B, iters * d + 2): the emitted tokens with -1
        holes, then pos and done, fetched at once; the new carry)."""
        logits, seen, ctx = carry["logits"], carry["seen"], carry["ctx"]
        done = carry["done"]
        emitted, pos, max_new = (carry[k].long() for k in ("emitted", "pos", "max_new"))
        temps, rps = carry["temps"], carry["rps"]
        B, V = logits.shape
        T = ctx.shape[1]
        d = draft
        ps = self.page_size
        limit = self.max_pages_per_seq * ps
        dev = self.device
        rows = torch.arange(B, device=dev)
        step_i = torch.arange(d, device=dev)
        j = torch.arange(T - 1, device=dev)
        out = torch.full((B, iters * d), -1, dtype=torch.long, device=dev)
        hit = (rps != 1.0)[:, None]
        for it in range(iters):
            # the pending token, sampled as _wave_run samples it
            lg = penalize(logits, seen & hit, rps[:, None])
            t0 = torch.argmax(lg, dim=1)
            if gen is not None:
                u = torch.rand((B, V), generator=gen, device=dev)
                sampled = torch.argmax(lg / temps.clamp_min(1e-6)[:, None]
                                       - torch.log(-torch.log(u)), dim=1)
                t0 = torch.where(temps > 0, sampled, t0)
            is_eos0 = (t0[:, None] == self._eos[None, :]).any(dim=1)
            live = ~done & ~is_eos0 & (emitted < max_new) & (pos + 1 < limit)
            # the 2-gram draft from the row's context (greedy rows)
            t1 = ctx[rows, (pos - 1).clamp_min(0)]
            match = ((ctx[:, :-1] == t1[:, None]) & (ctx[:, 1:] == t0[:, None])
                     & (j[None, :] <= (pos - d - 1)[:, None]))
            m = torch.where(match, j[None, :], -1).max(dim=1).values
            have = (m >= 0) & (temps == 0) & live
            idxs = (m + 2).clamp(0, T - d)[:, None] + step_i[None, :d - 1]
            cont = torch.where(have[:, None] & (idxs < pos[:, None]),
                               ctx.gather(1, idxs), 0)
            chunk = torch.where(live[:, None], torch.cat([t0[:, None], cont], dim=1), 0)
            # the chunk forward: writes past the row's pre-extended cover go
            # to the trash page (no token there is emitted or attended)
            raw = pos[:, None] + step_i[None, :]
            positions = raw.clamp(0, limit - 1)
            w_ok = live[:, None] & (raw < limit) & (raw < cover[:, None])
            w_pages = torch.where(w_ok, page_idx.gather(1, positions // ps), self._trash)
            w_slots = torch.where(w_ok, positions % ps, 0)
            lengths = torch.where(live, pos + d, d)
            logits_all = self._forward(chunk, positions, page_idx, lengths, w_pages, w_slots)
            # the batched verify: greedy-with-penalty at every position
            greedy = draft_greedy(logits_all, seen, cont, rps)
            acc = torch.cumprod((chunk[:, 1:] == greedy[:, :-1]).long(), dim=1)
            a = torch.where(have, acc.sum(dim=1), 0)
            # emission: the pending token and the accepted drafts, bounded by
            # EOS, max_new and the page limit
            chk_eos = (chunk[:, :, None] == self._eos[None, None, :]).any(dim=2)
            fe = torch.where(chk_eos, step_i[None, :], d).min(dim=1).values
            room = torch.minimum(max_new - emitted, limit - 1 - pos)
            n_emit = torch.where(live, torch.minimum(torch.minimum(1 + a, fe), room), 0)
            ok = step_i[None, :] < n_emit[:, None]
            out[:, it * d:(it + 1) * d] = torch.where(ok, chunk, -1)
            widx = raw.clamp(0, T - 1)
            ctx.scatter_(1, widx, torch.where(ok, chunk, ctx.gather(1, widx)))
            for i in range(d):  # one column at a time: a chunk may repeat a token
                seen[rows, chunk[:, i]] = seen[rows, chunk[:, i]] | ok[:, i]
            emitted = emitted + n_emit
            pos = pos + n_emit
            done = (done | (live & (is_eos0 | (fe <= a))) | (emitted >= max_new)
                    | (pos + 1 >= limit) | ~live)
            last = logits_all[rows, (n_emit - 1).clamp_min(0)]
            logits = torch.where((n_emit > 0)[:, None], last, logits)
        packed = torch.cat([out, pos[:, None], done[:, None].long()], dim=1)
        return packed, {"logits": logits, "seen": seen, "done": done,
                        "emitted": emitted, "pos": pos, "ctx": ctx}

    def _spec_collect(self, entry) -> int:
        """Fetch one in-flight spec wave's packed [tokens | pos | done] and
        update host state; greedy rows that ran the whole wave feed the
        gate's acceptance EWMA. Returns the sequences still active."""
        t0 = time.perf_counter()
        w = entry["iters"] * entry["draft"]
        infl = self._spec_infl
        host = entry["packed"].cpu().numpy()  # ONE fetch per wave
        if self.wave_timings is not None:
            self.wave_timings.append({"fetch": time.perf_counter() - t0})
        acc_toks = acc_fwds = 0
        for i, (sid, st) in enumerate(entry["active"]):
            row = [int(t) for t in host[i, :w] if t >= 0]
            st.out.extend(row)
            st.seen.update(row)
            st.pos = int(host[i, w])
            if sid in self.seqs:  # not retired while in flight
                self.cache.seq_len[sid] = st.pos
            left = infl.get(sid, 0) - w
            if left > 0:
                infl[sid] = left
            else:
                infl.pop(sid, None)
            st.vals = None
            st.dev_logits = None  # carried in _spec_state until flushed
            if host[i, w + 1]:
                st.done = True
            elif st.temperature == 0:
                # rows that finished mid-wave emitted fewer for EOS or
                # max_new, not for rejection: only whole waves are counted
                acc_toks += len(row)
                acc_fwds += entry["iters"]
        if acc_fwds:
            a = acc_toks / acc_fwds
            prev = self._spec_accept
            self._spec_accept = a if prev is None else 0.5 * prev + 0.5 * a
            self._spec_waves += 1
        return sum(1 for _, st in self.seqs.items() if not st.done)

    def _spec_track_reset(self) -> None:
        """A newly admitted prompt re-earns speculation: acceptance belongs
        to the text being decoded, so the EWMA resets and the gate goes back
        to spec mode."""
        self._spec_accept = None
        self._spec_waves = 0
        self._spec_mode = "spec"
        self._spec_probe_left = 0

    def _spec_gate(self) -> bool:
        """The adaptive choice, consulted once per dispatch decision: True
        for a spec wave, False for a plain one. Spec mode drops to plain
        once two or more waves averaged below ``spec_accept_floor`` emitted
        tokens a forward; plain mode counts ``spec_reprobe_every`` decisions
        down and then re-probes spec with a fresh EWMA, unless no greedy
        row has 4 * ``_spec_gate_iters`` tokens left beyond what the waves
        in flight will emit (a probe costs two or more waves at the
        acceptance that demoted it). Greedy streams are the same either
        way up to argmax near-ties at the kernels' rounding (see
        _spec_run)."""
        if self.spec_accept_floor <= 0:
            return True
        if self._spec_mode == "spec":
            if (self._spec_accept is not None and self._spec_waves >= 2
                    and self._spec_accept < self.spec_accept_floor):
                self._spec_mode = "plain"
                self._spec_probe_left = self.spec_reprobe_every
                return False
            return True
        self._spec_probe_left -= 1
        if self._spec_probe_left <= 0:
            it = self._spec_gate_iters
            if it and not any(
                    not st.done and st.temperature == 0
                    and st.max_new - len(st.out) - self._infl_steps.get(sid, 0)
                    - self._spec_infl.get(sid, 0) >= 4 * it
                    for sid, st in self.seqs.items()):
                self._spec_probe_left = self.spec_reprobe_every
                return False
            self._spec_track_reset()
            return True
        return False

    def _more(self, use_spec: bool) -> bool:
        """A new wave of this kind could still help a row: its budget and
        the page limit are not covered by the waves in flight (a host
        prediction; EOS wastes at most one wave)."""
        imap = self._spec_infl if use_spec else self._infl_steps
        limit = self.max_pages_per_seq * self.page_size
        return any(not st.done
                   and len(st.out) + imap.get(sid, 0) < st.max_new
                   and st.pos + imap.get(sid, 0) + 1 < limit
                   for sid, st in self.seqs.items())

    def _collect(self, kind: str, entry) -> int:
        if kind == "spec":
            return self._spec_collect(entry)
        return self._wave_collect(entry)

    def run_spec(self, iters: int = 4, draft: int = 8, seed: int = 0,
                 pipeline: bool = True) -> Dict[object, List[int]]:
        """Decode all active sequences to completion, each dispatch a spec
        wave while a greedy row is active and the gate agrees, else a plain
        wave of ``iters`` steps. With ``pipeline`` wave N+1 is enqueued
        before wave N's fetch; a membership change or a kind switch drains
        the waves in flight first. The streams do not depend on
        ``pipeline``."""
        self._spec_gate_iters = iters
        q: deque = deque()
        depth = 2 if pipeline else 1
        while True:
            use_spec = (any(st.temperature == 0 and not st.done
                            for st in self.seqs.values()) and self._spec_gate())
            if self._more(use_spec):
                if use_spec:
                    entry = self._spec_dispatch(iters, draft, seed, allow_rebuild=not q)
                    kind = "spec"
                else:
                    entry = self._wave_dispatch(iters, seed, allow_rebuild=not q)
                    kind = "wave"
                if entry == "drain":
                    self._collect(*q.popleft())
                    continue
                if entry is None:
                    break
                q.append((kind, entry))
                if len(q) >= depth:
                    self._collect(*q.popleft())
            elif q:
                self._collect(*q.popleft())
            else:
                break
        return self.results()


# ---------------------------------------------------------------------------
# Chat-backend adapter: concurrent /chat requests share one engine
# ---------------------------------------------------------------------------

class BatchedChatBackend(ChatBackend):
    """A ChatBackend whose generations run through a shared ServingEngine.

    Server threads call ``chat()`` concurrently; one worker thread owns the
    engine and continuously batches all in-flight generations. Per request
    the reply follows LocalChatBackend (template, assistant-token strip).
    """

    def __init__(self, llm, template=llama3_template, assistant_token=None,
                 seed: int = 0, wave_steps: int = 8, spec_draft: int = 8,
                 **engine_kwargs):
        """``wave_steps`` > 0 decodes that many tokens per dispatch (0: the
        single-step path). ``spec_draft`` > 0 decodes greedy rows in
        speculative waves of ``wave_steps`` chunk forwards of that width,
        while the engine's adaptive gate keeps them (``engine_kwargs``:
        ``spec_accept_floor``, ``spec_reprobe_every``)."""
        self.llm = llm
        self.template = template
        self.assistant_token = assistant_token
        self.seed = seed
        self.wave_steps = wave_steps
        self.spec_draft = spec_draft
        self.engine = ServingEngine(llm, **engine_kwargs)
        self._submit: "queue.Queue" = queue.Queue()
        self._next_id = 0
        self._id_lock = threading.Lock()
        # per-request latency ring: TTFT = submit → first token available;
        # tok_s = generated tokens / decode span (first fetch → retire)
        self._metrics: deque = deque(maxlen=1024)
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def stop(self) -> None:
        """Stop the worker thread (idempotent). In-flight requests finish;
        queued-but-unadmitted requests fail."""
        if self._worker.is_alive():
            self._submit.put(None)
            self._worker.join(timeout=60)

    def latency_stats(self) -> dict:
        """p50/p95 TTFT (ms) and per-request decode throughput (tok/s) over
        the last <=1024 completed requests."""
        snap = list(self._metrics)
        if not snap:
            return {"completed": 0}
        ttft = np.asarray([m["ttft_ms"] for m in snap])
        toks = np.asarray([m["tok_s"] for m in snap if m["tok_s"] > 0])
        out = {"completed": len(snap),
               "ttft_ms_p50": round(float(np.percentile(ttft, 50)), 1),
               "ttft_ms_p95": round(float(np.percentile(ttft, 95)), 1)}
        if len(toks):
            out["tok_s_p50"] = round(float(np.percentile(toks, 50)), 1)
            out["tok_s_p95"] = round(float(np.percentile(toks, 95)), 1)
        return out

    @staticmethod
    def _fail(req, exc) -> None:
        req["error"] = exc
        req["event"].set()

    def _loop(self):
        """Worker loop. Invariants: (a) the thread never exits on an error:
        every exception becomes an error on the affected request(s); (b) a
        request is admitted only when the pool can cover its full lifetime
        (ServingEngine.can_admit), so decoding never runs out of pages;
        excess requests wait in FIFO order.

        Waves, plain or speculative, pipeline one deep; each in-flight
        entry carries its kind. Membership changes (admission, a row
        finishing) and kind switches drain the in-flight wave first, so
        host state is current when the batch rebuilds."""
        eng = self.engine
        pending = {}          # seq_id → request dict (in the engine)
        waiting = deque()     # not admitted yet, FIFO
        infl = deque()        # in-flight (kind, wave) (pipeline depth 1)

        def drain_all():
            while infl:
                eng._collect(*infl.popleft())

        while True:
            try:
                # take new requests (block when fully idle)
                try:
                    block = not pending and not waiting and not infl
                    while True:
                        req = self._submit.get(block=block,
                                               timeout=None if block else 0)
                        if req is None:       # stop() sentinel
                            drain_all()
                            for w in list(pending.values()) + list(waiting):
                                self._fail(w, RuntimeError("backend stopped"))
                            return
                        waiting.append(req)
                        block = False
                except queue.Empty:
                    pass
                # admission: FIFO while the pool covers the full lifetime;
                # the admissible requests prefill together as one group
                group, group_pages = [], 0
                while waiting:
                    req = waiting[0]
                    n = len(req["prompt_ids"])
                    need = eng._lifetime_pages(n, req["max_new"])
                    if need > eng.cache.num_pages - 1:  # -1: the trash page
                        waiting.popleft()
                        self._fail(req, MemoryError(
                            f"request needs {need} KV pages; pool has "
                            f"{eng.cache.num_pages - 1}"))
                        continue
                    if not eng.can_admit(n, req["max_new"],
                                         extra_reserved=group_pages):
                        break  # wait for active sequences to retire
                    waiting.popleft()
                    group.append(req)
                    group_pages += need
                if group:
                    try:
                        drain_all()  # prefill changes membership
                        eng.add_requests([
                            {"id": r["id"], "prompt_ids": r["prompt_ids"],
                             "max_new": r["max_new"],
                             "temperature": r["temperature"], "rp": r["rp"],
                             "seed": self.seed}
                            for r in group])
                        for r in group:
                            pending[r["id"]] = r
                    except Exception as exc:  # prefill/alloc failure
                        for r in group:
                            eng.cache.free(r["id"])
                            eng.seqs.pop(r["id"], None)
                            self._fail(r, exc)
                if not pending:
                    drain_all()
                    continue
                try:
                    if self.wave_steps > 0:
                        # spec drafts only help greedy rows: an all-sampled
                        # phase takes plain waves; the gate is consulted only
                        # where spec is otherwise eligible
                        any_greedy = any(st.temperature == 0 and not st.done
                                         for st in eng.seqs.values())
                        eng._spec_gate_iters = self.wave_steps
                        use_spec = (self.spec_draft > 0 and any_greedy
                                    and eng._spec_gate())
                        if not eng._more(use_spec):
                            drain_all()
                        else:
                            if use_spec:
                                entry = eng._spec_dispatch(
                                    self.wave_steps, self.spec_draft, self.seed,
                                    allow_rebuild=not infl)
                                kind = "spec"
                            else:
                                entry = eng._wave_dispatch(self.wave_steps, self.seed,
                                                           allow_rebuild=not infl)
                                kind = "wave"
                            if entry == "drain":
                                eng._collect(*infl.popleft())
                            elif entry is None:
                                drain_all()
                            else:
                                infl.append((kind, entry))
                                if len(infl) >= 2:
                                    eng._collect(*infl.popleft())
                    else:
                        eng.step()
                except Exception as exc:  # fail in-flight, keep serving
                    infl.clear()
                    eng._infl_steps.clear()
                    eng._spec_infl.clear()
                    for sid, req in list(pending.items()):
                        self._fail(req, exc)
                        try:
                            eng.retire(sid)
                        except Exception:
                            eng.cache.free(sid)
                            eng.seqs.pop(sid, None)
                    pending.clear()
                    continue
                now = time.perf_counter()
                for sid, req in pending.items():
                    if "t_first" not in req and eng.seqs[sid].out:
                        req["t_first"] = now
                done = [sid for sid in pending if eng.seqs[sid].done]
                if done and infl:
                    # retire flushes the wave carry into per-row state, which
                    # is only consistent once every wave has been collected
                    drain_all()
                    done = [sid for sid in pending if eng.seqs[sid].done]
                for sid in done:
                    req = pending.pop(sid)
                    req["tokens"] = eng.retire(sid)
                    t0 = req.get("t_submit")
                    tf = req.get("t_first", now)
                    if t0 is not None:
                        span = max(now - tf, 1e-9)
                        n_tok = len(req["tokens"])
                        self._metrics.append({
                            "ttft_ms": (tf - t0) * 1e3, "tokens": n_tok,
                            "tok_s": n_tok / span if n_tok > 1 else 0.0})
                    req["event"].set()
            except Exception as exc:  # last resort: never die silently
                for req in list(pending.values()) + list(waiting):
                    self._fail(req, exc)
                pending.clear()
                waiting.clear()

    def chat(self, messages, max_new_tokens: int = 1000,
             temperature: float = 0.2, repetition_penalty: float = 1.1) -> str:
        ids = self.llm.tokenizer.encode(self.template(messages))
        self.last_prompt_tokens = len(ids)
        with self._id_lock:
            self._next_id += 1
            sid = f"req-{self._next_id}"
        req = {"id": sid, "prompt_ids": ids, "max_new": max_new_tokens,
               "temperature": temperature, "rp": repetition_penalty,
               "event": threading.Event(), "t_submit": time.perf_counter()}
        self._submit.put(req)
        req["event"].wait()
        if "error" in req:
            raise RuntimeError(f"generation failed for {sid}") from req["error"]
        toks = req["tokens"]
        if hasattr(self.llm.tokenizer, "decode"):
            reply = self.llm.tokenizer.decode(toks)
        else:
            reply = " ".join(str(t) for t in toks)
        if self.assistant_token and self.assistant_token in reply:
            reply = reply.rsplit(self.assistant_token, 1)[-1]
        for stop in ("<|eot_id|>", "<|end_of_text|>"):
            if stop in reply:
                reply = reply.split(stop, 1)[0]
        return reply.strip()
