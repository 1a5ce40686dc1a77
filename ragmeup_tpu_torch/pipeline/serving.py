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
  pipeline one deep (wave N+1 is enqueued before wave N's fetch).

``BatchedChatBackend`` puts the engine behind the ChatBackend interface: a
worker thread owns the engine (and with it all of its CUDA work, on one
stream); /chat threads only enqueue and wait.

Sampling (temperature, repetition penalty, EOS) follows ``LocalLLM``.
Temperature rows sample with ``torch.Generator``s (per sequence in
``step``, seeded from the seed and the wave counter in waves): sampled
streams are the port's own, greedy streams equal the JAX package's.
Speculative waves (2-gram drafts for greedy rows) are not ported yet: the
backend raises NotImplementedError where the JAX package would dispatch
one.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ragmeup_tpu_torch.models.decoder import LocalLLM, _next_pow2_int
from ragmeup_tpu_torch.ops.paged_attention import PagedKVCache
from ragmeup_tpu_torch.ops.topk import rank_topk
from ragmeup_tpu_torch.pipeline.llm_backends import ChatBackend, llama3_template

SPEC_NOT_PORTED = ("speculative waves (greedy rows with spec_draft > 0) are not "
                   "ported yet (ROADMAP queue 1 item 4); pass spec_draft=0")


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
                 prefill_chunk: int = 256, prefix_cache: bool = True):
        self.llm = llm
        cfg = llm.cfg
        self.page_size = page_size
        # sampling happens within the top-K support (greedy is exact: the
        # argmax is always in it)
        self.topk_support = min(topk_support, cfg.vocab_size)
        self.max_pages_per_seq = max_pages_per_seq
        self.max_batch = max_batch
        self.device = llm.device
        self.cache = PagedKVCache(num_pages, page_size, cfg.num_kv_heads,
                                  cfg.head_dim, cfg.num_layers,
                                  dtype=cfg.torch_dtype, device=self.device)
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
        self._wave_state: Optional[dict] = None
        self._infl_steps: Dict[object, int] = {}
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
        """Write the wave carry's per-row logits back to their sequences and
        drop the carry. Runs before any host-side change the carry would
        shadow (single step, retire, batch membership change)."""
        prev = self._wave_state
        if prev is not None:
            for j, old_sid in enumerate(prev["sig"][0]):
                if old_sid in self.seqs:
                    self.seqs[old_sid].dev_logits = prev["logits"][j]
        self._wave_state = None

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

    def _spec_dispatch(self, *args, **kwargs):
        """Where the JAX package dispatches a speculative wave."""
        raise NotImplementedError(SPEC_NOT_PORTED)

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
        V = self.llm.cfg.vocab_size
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
            dev = self.device
            logits = torch.zeros((B, V), dtype=torch.float32, device=dev)
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
            carry = {"logits": logits, "seen": self._tensor(seen),
                     "done": self._tensor(done), "emitted": self._tensor(emitted),
                     "pos": self._tensor(pos), "temps": self._tensor(temps),
                     "rps": self._tensor(rps), "max_new": self._tensor(max_new),
                     "sampled": bool((temps > 0).any())}

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
        penalize = (rps != 1.0)[:, None]
        for s in range(steps):
            penal = torch.where(logits > 0, logits / rps[:, None],
                                logits * rps[:, None])
            lg = torch.where(seen & penalize, penal, logits)
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

    def _can_advance(self, infl: Dict[object, int]) -> bool:
        """Some row could still emit in a new wave (host prediction; EOS is
        unpredictable and wastes at most one wave)."""
        limit = self.max_pages_per_seq * self.page_size
        return any(not st.done
                   and len(st.out) + infl.get(sid, 0) < st.max_new
                   and st.pos + infl.get(sid, 0) + 1 < limit
                   for sid, st in self.seqs.items())

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
            if self._can_advance(self._infl_steps):
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
        single-step path). ``spec_draft`` > 0 asks for speculative waves for
        greedy rows, which are not ported: such a request fails with
        NotImplementedError."""
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

        Waves pipeline one deep. Membership changes (admission, a row
        finishing) drain the in-flight wave first, so host state is current
        when the batch rebuilds."""
        eng = self.engine
        pending = {}          # seq_id → request dict (in the engine)
        waiting = deque()     # not admitted yet, FIFO
        infl = deque()        # in-flight waves (pipeline depth 1)

        def drain_all():
            while infl:
                eng._wave_collect(infl.popleft())

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
                        any_greedy = any(st.temperature == 0 and not st.done
                                         for st in eng.seqs.values())
                        if not eng._can_advance(eng._infl_steps):
                            drain_all()
                        else:
                            if self.spec_draft > 0 and any_greedy:
                                eng._spec_dispatch(self.wave_steps,
                                                   self.spec_draft, self.seed)
                            entry = eng._wave_dispatch(self.wave_steps, self.seed,
                                                       allow_rebuild=not infl)
                            if entry == "drain":
                                eng._wave_collect(infl.popleft())
                            elif entry is None:
                                drain_all()
                            else:
                                infl.append(entry)
                                if len(infl) >= 2:
                                    eng._wave_collect(infl.popleft())
                    else:
                        eng.step()
                except Exception as exc:  # fail in-flight, keep serving
                    infl.clear()
                    eng._infl_steps.clear()
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
