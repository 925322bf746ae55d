"""DecodeScheduler — continuous batching over a paged KV cache (the port
of ``repro.serve.decode_scheduler``).

The serve block's data plane: many users' generate sessions multiplex one
fixed-shape decode batch (``max_slots`` slots) over one shared page pool.
Every ``step()``:

1. **admit** queued sessions into free slots while pages last: the prompt
   is prefilled (dense, padded to a page multiple, as the reference pads
   to bound its compiled buckets), scattered into freshly allocated pool
   pages, and the first generated token is emitted immediately — TTFT is
   admission time, not queue-drain time;
2. **decode** one token for every running slot in a single fixed-shape
   batched ``decode_step_paged`` call;
3. **retire** slots that hit EOS / their token budget / the sequence cap,
   releasing their pages to the pool.

Pages are allocated lazily (a slot gains its next page only when its write
position crosses a page boundary); when the pool runs dry mid-decode the
least-progressed running session is *evicted* and re-queued with its
context.  Page 0 is the reserved trash page idle slots write into.

PyTorch runs eagerly, so the reference's compile-cache wrappers have no
counterpart, and the pool is updated in place where the JAX version
donates it.  ``state_tree()``/``load_state()`` round-trip the whole state
(pool, page table, per-slot lengths and host session metadata).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import TRACER
from repro_torch.serve.serve_step import pick

#: fixed budget for the JSON-encoded host session metadata in state_tree()
META_CAP = 1 << 20


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class PagePool:
    """Host-side free list over the device page pool.  Page 0 is reserved
    (the trash page idle slots write into) and never handed out."""

    def __init__(self, n_pages: int):
        assert n_pages >= 2, "pool needs at least one real page + the trash page"
        self.n_pages = n_pages
        self.free: List[int] = list(range(n_pages - 1, 0, -1))

    @property
    def available(self) -> int:
        return len(self.free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """All-or-nothing allocation of ``n`` pages (None = pool exhausted)."""
        if n > len(self.free):
            return None
        return [self.free.pop() for _ in range(n)]

    def release(self, pages: Sequence[int]) -> None:
        for p in pages:
            assert 0 < p < self.n_pages, p
            self.free.append(p)


@dataclasses.dataclass
class GenSession:
    """One generate session.  ``prompt + generated`` is the full context;
    eviction re-queues the session with everything generated so far folded
    into the context, so re-admission resumes mid-generation."""
    sid: str
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    state: str = "queued"            # queued | running | done
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    pages: List[int] = dataclasses.field(default_factory=list)
    submitted_t: Optional[float] = None
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None
    evictions: int = 0
    finish_reason: Optional[str] = None

    @property
    def context(self) -> List[int]:
        return self.prompt + self.generated

    def to_dict(self) -> Dict[str, Any]:
        return {"sid": self.sid, "prompt": self.prompt,
                "max_new_tokens": self.max_new_tokens, "eos_id": self.eos_id,
                "state": self.state, "generated": self.generated,
                "slot": self.slot, "pages": self.pages,
                "submitted_t": self.submitted_t,
                "first_token_t": self.first_token_t,
                "evictions": self.evictions}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GenSession":
        return cls(sid=d["sid"], prompt=list(d["prompt"]),
                   max_new_tokens=int(d["max_new_tokens"]),
                   eos_id=d["eos_id"], state=d["state"],
                   generated=list(d["generated"]), slot=d["slot"],
                   pages=list(d["pages"]), submitted_t=d["submitted_t"],
                   first_token_t=d["first_token_t"],
                   evictions=int(d["evictions"]))


def paged_geometry(cfg: ModelConfig, *, page_size: int, n_pages: int,
                   max_slots: int, max_seq_len: int) -> Dict[str, int]:
    """Normalize a job's paged-cache geometry.  ``n_pages=0`` derives a
    full-residency pool (every slot can grow to ``max_seq_len`` without an
    eviction) plus the reserved trash page."""
    assert page_size >= 1 and max_slots >= 1 and max_seq_len >= 2
    pages_per_seq = _ceil_div(max_seq_len, page_size)
    if n_pages <= 0:
        n_pages = max_slots * pages_per_seq + 1
    return {"page_size": page_size, "n_pages": n_pages,
            "max_slots": max_slots, "max_seq_len": max_seq_len,
            "pages_per_seq": pages_per_seq}


class DecodeScheduler:
    def __init__(self, cfg: ModelConfig, params, *, page_size: int = 16,
                 n_pages: int = 0, max_slots: int = 8, max_seq_len: int = 128,
                 sample: bool = False, seed: int = 0, time_fn=time.monotonic,
                 init_pool: bool = True, device="cuda"):
        model_lib.check_paged_support(cfg)
        self.cfg = cfg
        self.params = params
        self.device = resolve(device)
        geo = paged_geometry(cfg, page_size=page_size, n_pages=n_pages,
                             max_slots=max_slots, max_seq_len=max_seq_len)
        self.page_size = geo["page_size"]
        self.n_pages = geo["n_pages"]
        self.max_slots = geo["max_slots"]
        self.max_seq_len = geo["max_seq_len"]
        self.pages_per_seq = geo["pages_per_seq"]
        self.sample = sample
        self._time_fn = time_fn
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed + 17)

        # device state
        self.pool = (model_lib.init_paged_cache(cfg, self.n_pages,
                                                self.page_size, self.device)
                     if init_pool else None)
        self.last_tokens_dev = torch.zeros((self.max_slots, 1),
                                           dtype=torch.int32,
                                           device=self.device)
        # host mirrors pushed to device each decode round
        self.page_table = np.zeros((self.max_slots, self.pages_per_seq),
                                   np.int32)
        self.seq_lens = np.zeros((self.max_slots,), np.int32)
        self.tokens = np.zeros((self.max_slots, 1), np.int32)

        # host bookkeeping
        self.pages = PagePool(self.n_pages)
        self.slots: List[Optional[GenSession]] = [None] * self.max_slots
        self.queued: Deque[GenSession] = collections.deque()
        self.sessions: Dict[str, GenSession] = {}
        self._next_id = 0
        self.tokens_generated = 0
        self.admissions = 0
        self.evictions = 0
        self.finished = 0
        self.ttft_s: List[float] = []

    # ---------------------------------------------------------- device fns
    def _admit_prefill(self, tokens, pages: List[int], last_idx: int) -> int:
        """Admission: zero temp cache + dense prefill + page scatter +
        first-token pick, with one host sync for the token."""
        # prompt padded to a page multiple: causal masking keeps logits at
        # ``last_idx`` and cache rows [0, last_idx] identical to the
        # unpadded run; pad-token rows land past the live length and are
        # overwritten before the length mask ever exposes them
        S = tokens.shape[1]
        cache = model_lib.init_cache(self.cfg, 1, S, tokens.device)
        x = model_lib.embed_inputs(self.params, self.cfg, {"tokens": tokens})
        logits, _, cache = model_lib.forward(
            self.params, self.cfg, x,
            positions=torch.arange(S, device=x.device), cache=cache,
            cache_len=0)
        self.pool = model_lib.write_prefill_to_pages(self.pool, cache, pages,
                                                     self.page_size)
        return int(pick(logits[0, last_idx][None], sample=self.sample,
                        gen=self._gen if self.sample else None)[0])

    def _decode_step(self, tokens, page_table, seq_lens):
        """One batched paged decode step over every slot: (max_slots, 1)
        next tokens on the device; the pool is written in place."""
        logits, self.pool = model_lib.decode_step_paged(
            self.params, self.cfg, tokens, self.pool, page_table, seq_lens)
        return pick(logits, sample=self.sample,
                    gen=self._gen if self.sample else None)[:, None]

    # --------------------------------------------------------------- submit
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               sid: Optional[str] = None) -> str:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if len(prompt) >= self.max_seq_len:
            raise ValueError(
                f"prompt length {len(prompt)} >= max_seq_len "
                f"{self.max_seq_len}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if sid is None:
            sid = f"g{self._next_id:06d}"
            self._next_id += 1
        if sid in self.sessions:
            raise ValueError(f"duplicate session id {sid!r}")
        # serve.admit is the DecodeScheduler's admission decision; on the
        # generate path it nests under the daemon's serve.submit span
        with TRACER.span("serve.admit", cat="serve", session=sid,
                         prompt_tokens=len(prompt)):
            sess = GenSession(sid=sid, prompt=prompt,
                              max_new_tokens=int(max_new_tokens),
                              eos_id=(None if eos_id is None
                                      else int(eos_id)),
                              submitted_t=self._time_fn())
            self.sessions[sid] = sess
            self.queued.append(sess)
        return sess.sid

    @property
    def active_count(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def has_work(self) -> bool:
        return self.active_count > 0 or bool(self.queued)

    def stats(self) -> Dict[str, Any]:
        return {"tokens_generated": self.tokens_generated,
                "admissions": self.admissions, "evictions": self.evictions,
                "finished": self.finished, "active": self.active_count,
                "queued": len(self.queued),
                "free_pages": self.pages.available}

    # ----------------------------------------------------------------- step
    def step(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One continuous-batching round: admit, batch-decode, retire.
        Returns the round's emissions — ``{"event": "token", ...}`` per
        generated token plus ``admitted``/``evicted``/``finished``
        lifecycle markers."""
        t = now if now is not None else self._time_fn()
        emissions: List[Dict[str, Any]] = []
        with TRACER.span("serve.decode_round", cat="serve") as sp:
            self._admit(emissions, t)
            self._decode_round(emissions, t)
            sp.set(emissions=len(emissions))
        return emissions

    # ------------------------------------------------------------ admission
    def _admit(self, emissions: List[Dict[str, Any]], now: float) -> None:
        while self.queued:
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if not free_slots:
                return
            sess = self.queued[0]
            plen = len(sess.context)
            # pages for the prompt *and* the first decode write position
            need = plen // self.page_size + 1
            pages = self.pages.alloc(need)
            if pages is None:
                return                      # admission refusal: pool full
            self.queued.popleft()
            slot = free_slots[0]

            bucket = need * self.page_size
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :plen] = sess.context
            first = self._admit_prefill(torch.from_numpy(toks).to(self.device),
                                        pages, plen - 1)

            sess.state = "running"
            sess.slot = slot
            sess.pages = pages
            self.slots[slot] = sess
            self.page_table[slot, :] = 0
            self.page_table[slot, :need] = pages
            self.seq_lens[slot] = plen
            self.tokens[slot, 0] = first
            sess.generated.append(first)
            if sess.first_token_t is None:
                sess.first_token_t = now
                self.ttft_s.append(now - sess.submitted_t)
            self.admissions += 1
            self.tokens_generated += 1
            emissions.append({"event": "admitted", "session": sess.sid,
                              "slot": slot, "prompt_tokens": plen,
                              "pages": len(pages)})
            done = self._is_done(sess, first)
            emissions.append(self._token_emission(sess, first, done))
            if done:
                self._finish(sess, emissions, now)

    def _is_done(self, sess: GenSession, token: int) -> bool:
        if sess.eos_id is not None and token == sess.eos_id:
            sess.finish_reason = "eos"
            return True
        if len(sess.generated) >= sess.max_new_tokens:
            sess.finish_reason = "length"
            return True
        return False

    def _token_emission(self, sess: GenSession, token: int,
                        done: bool) -> Dict[str, Any]:
        return {"event": "token", "session": sess.sid, "token": int(token),
                "index": len(sess.generated) - 1, "done": done}

    # --------------------------------------------------------------- decode
    def _ensure_pages(self, emissions: List[Dict[str, Any]],
                      now: float) -> None:
        """Grow each running slot's page table to cover this round's write
        position, evicting the least-progressed *other* session when the
        pool is dry (the requester itself only as a last resort)."""
        for i in range(self.max_slots):
            sess = self.slots[i]
            if sess is None:
                continue
            pos = int(self.seq_lens[i])
            if pos + 1 > self.max_seq_len:
                sess.finish_reason = "cap"
                self._finish(sess, emissions, now)
                continue
            idx = pos // self.page_size
            while idx >= len(sess.pages):
                got = self.pages.alloc(1)
                if got is not None:
                    self.page_table[i, len(sess.pages)] = got[0]
                    sess.pages.extend(got)
                    continue
                victims = [s for s in self.slots
                           if s is not None and s is not sess]
                victim = (min(victims, key=lambda s: len(s.generated))
                          if victims else sess)
                self._evict(victim, emissions, now)
                if victim is sess:
                    break

    def _decode_round(self, emissions: List[Dict[str, Any]],
                      now: float) -> None:
        self._ensure_pages(emissions, now)
        active = [i for i in range(self.max_slots)
                  if self.slots[i] is not None]
        if not active:
            return
        dev = self.device
        nxt = self._decode_step(torch.from_numpy(self.tokens).to(dev),
                                torch.from_numpy(self.page_table).to(dev),
                                torch.from_numpy(self.seq_lens).to(dev))
        self.last_tokens_dev = nxt
        nxt_host = nxt.cpu().numpy()        # host sync: EOS/feedback point
        for i in active:
            sess = self.slots[i]
            self.seq_lens[i] += 1
            token = int(nxt_host[i, 0])
            sess.generated.append(token)
            self.tokens[i, 0] = token
            self.tokens_generated += 1
            done = self._is_done(sess, token)
            emissions.append(self._token_emission(sess, token, done))
            if done:
                self._finish(sess, emissions, now)

    # ----------------------------------------------------------- retirement
    def _clear_slot(self, sess: GenSession) -> None:
        slot = sess.slot
        self.pages.release(sess.pages)
        sess.pages = []
        sess.slot = None
        self.slots[slot] = None
        self.page_table[slot, :] = 0
        self.seq_lens[slot] = 0
        self.tokens[slot, 0] = 0

    def _finish(self, sess: GenSession, emissions: List[Dict[str, Any]],
                now: float) -> None:
        self._clear_slot(sess)
        sess.state = "done"
        sess.done_t = now
        self.finished += 1
        emissions.append({"event": "finished", "session": sess.sid,
                          "n_tokens": len(sess.generated),
                          "reason": sess.finish_reason or "length"})

    def _evict(self, sess: GenSession, emissions: List[Dict[str, Any]],
               now: float) -> None:
        """Pool-pressure eviction: fold progress into the context and
        re-queue at the front — tokens already emitted stay emitted;
        re-admission prefills the longer context and generation continues
        from the next token."""
        freed = len(sess.pages)
        self._clear_slot(sess)
        sess.state = "queued"
        sess.evictions += 1
        self.evictions += 1
        self.queued.appendleft(sess)
        emissions.append({"event": "evicted", "session": sess.sid,
                          "pages_freed": freed,
                          "generated": len(sess.generated)})

    # ---------------------------------------------------------------- state
    def state_tree(self) -> Dict[str, Any]:
        """The scheduler's full state as fixed-shape leaves: the pool
        tensors (live, not copied), host arrays, and the session metadata
        as a length-prefixed JSON blob in a fixed ``META_CAP`` byte
        buffer."""
        live = [s.to_dict() for s in self.sessions.values()
                if s.state != "done"]
        meta = json.dumps({
            "next_id": self._next_id,
            "sessions": live,
            "queued": [s.sid for s in self.queued],
            "counters": [self.tokens_generated, self.admissions,
                         self.evictions, self.finished],
        }).encode()
        if len(meta) + 8 > META_CAP:
            raise ValueError(
                f"session metadata ({len(meta)}B) exceeds the state "
                f"budget ({META_CAP}B)")
        buf = np.zeros((META_CAP,), np.uint8)
        buf[:8] = np.frombuffer(np.uint64(len(meta)).tobytes(), np.uint8)
        buf[8:8 + len(meta)] = np.frombuffer(meta, np.uint8)
        return {"pool": self.pool,
                "page_table": self.page_table.copy(),
                "seq_lens": self.seq_lens.copy(),
                "tokens": self.tokens.copy(),
                "meta": buf}

    def load_state(self, tree: Dict[str, Any]) -> None:
        """Adopt a saved state; pool leaves (tensors or numpy arrays) land
        on this scheduler's device."""
        self.pool = {k: torch.as_tensor(v).to(self.device)
                     for k, v in tree["pool"].items()}
        self.page_table = np.asarray(tree["page_table"], np.int32).copy()
        self.seq_lens = np.asarray(tree["seq_lens"], np.int32).copy()
        self.tokens = np.asarray(tree["tokens"], np.int32).copy()
        self.last_tokens_dev = torch.tensor(self.tokens, device=self.device)
        buf = np.asarray(tree["meta"], np.uint8)
        n = int(np.frombuffer(buf[:8].tobytes(), np.uint64)[0])
        meta = json.loads(buf[8:8 + n].tobytes().decode())
        self._next_id = int(meta["next_id"])
        (self.tokens_generated, self.admissions,
         self.evictions, self.finished) = meta["counters"]
        self.sessions = {d["sid"]: GenSession.from_dict(d)
                         for d in meta["sessions"]}
        self.slots = [None] * self.max_slots
        used = []
        for sess in self.sessions.values():
            if sess.state == "running":
                self.slots[sess.slot] = sess
                used.extend(sess.pages)
        self.queued = collections.deque(self.sessions[sid]
                                        for sid in meta["queued"])
        self.pages = PagePool(self.n_pages)
        taken = set(used)
        assert len(taken) == len(used), "page double-booked in saved state"
        self.pages.free = [p for p in range(self.n_pages - 1, 0, -1)
                           if p not in taken]
