"""Dynamic SplitFuse scheduler over the ragged v2 engine.

Port of ``deepspeed_tpu/inference/v2/scheduler.py`` (DeepSpeed-FastGen's
Dynamic SplitFuse: long prompts are split into chunks scheduled across
forward passes, short prompts fill a token budget, and decodes never
stall behind a long prefill). Each composed step is one ``put()`` — one
ragged step — except pure greedy decode steps, which take the engine's
fused decode window. The trace spans, telemetry and LoRA adapter routing
of the JAX package are not ported.

Usage:
    sched = DynamicSplitFuseScheduler(engine, token_budget=256)
    sched.submit(uid, prompt_tokens, max_new_tokens=64)
    while sched.pending():
        sched.step()
    outs = sched.results()   # {uid: np.ndarray of prompt+generated tokens}
"""

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


@dataclass
class _Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    eos_token_id: Optional[int]
    submit_t: float
    temperature: float = 0.0         # 0 = greedy
    top_p: float = 1.0
    top_k: int = 0                   # 0 = no rank cutoff
    rng: Optional[np.random.Generator] = None
    prefill_sent: int = 0            # prompt tokens handed to the engine
    generated: List[int] = field(default_factory=list)
    next_token: Optional[int] = None  # pending decode input
    first_token_t: Optional[float] = None
    last_emit_t: Optional[float] = None
    finish_t: Optional[float] = None
    cancelled: bool = False
    # streaming hook: called as on_token(uid, token, finished) from step()
    on_token: Optional[Callable[[int, int, bool], None]] = None

    def pick(self, logits_row: np.ndarray) -> int:
        from .sampling import host_sample
        return host_sample(logits_row, self.rng, self.temperature,
                           self.top_p, self.top_k)

    @property
    def prefill_done(self) -> bool:
        return self.prefill_sent >= len(self.prompt)

    @property
    def done(self) -> bool:
        return self.finish_t is not None


class DynamicSplitFuseScheduler:
    """Composes each engine step from (a) every running decode and (b) as
    many prompt-chunk tokens as fit in the remaining token budget."""

    def __init__(self, engine, token_budget: Optional[int] = None,
                 chunk: Optional[int] = None, clock=time.perf_counter):
        self.engine = engine
        sm = engine.state_manager.config
        self.token_budget = min(token_budget or sm.max_ragged_batch_size,
                                sm.max_ragged_batch_size)
        # chunks align to the prefill bucket
        self.chunk = chunk or engine.config.prefill_bucket
        self.clock = clock
        self._queue: List[_Request] = []     # waiting for prefill budget
        self._running: List[_Request] = []   # prefill done, decoding
        self._all: Dict[int, _Request] = {}
        self.steps = 0

    # ------------------------------------------------------------------
    def submit(self, uid: int, prompt: Sequence[int], max_new_tokens: int,
               eos_token_id: Optional[int] = None,
               temperature: float = 0.0, top_p: float = 1.0,
               top_k: int = 0, seed: Optional[int] = None,
               on_token: Optional[Callable[[int, int, bool], None]]
               = None) -> None:
        """temperature/top_p/seed are PER REQUEST: mixed greedy and sampled
        requests compose into the same steps; a SEEDED request's tokens are
        deterministic (the rng is per request), an unseeded one draws fresh
        OS entropy. ``on_token(uid, token, finished)`` fires for every
        emitted token."""
        if uid in self._all:
            raise ValueError(
                f"uid {uid} already submitted to this scheduler "
                f"(per-uid results()/metrics() state would be "
                f"corrupted); use a fresh uid, or release(uid) once the "
                f"previous request is finished or cancelled")
        max_seq_len = self.engine.state_manager.config.max_seq_len
        # the final emitted token is never fed back (_emit), so the request
        # writes prompt + max(new-1, 0) KV slots
        need = len(prompt) + max(max_new_tokens - 1, 0)
        if need > max_seq_len:
            raise RuntimeError(
                f"request uid={uid} cannot be scheduled: "
                f"len(prompt)={len(prompt)} + max_new_tokens="
                f"{max_new_tokens} needs {need} KV slots, over "
                f"max_seq_len={max_seq_len}; shorten the request or "
                f"raise state_manager.max_seq_len")
        req = _Request(uid, list(map(int, prompt)), max_new_tokens,
                       eos_token_id, self.clock(),
                       temperature=temperature, top_p=top_p, top_k=top_k,
                       rng=np.random.default_rng(seed), on_token=on_token)
        self._all[uid] = req
        self._queue.append(req)

    def resume(self, uid: int, prompt: Sequence[int],
               generated: Sequence[int], max_new_tokens: int,
               eos_token_id: Optional[int] = None,
               temperature: float = 0.0, top_p: float = 1.0,
               top_k: int = 0, rng_state: Optional[dict] = None,
               on_token: Optional[Callable[[int, int, bool], None]]
               = None) -> None:
        """Adopt a request mid-generation whose KV the engine already holds
        (a handed-off prefill): it enters the RUNNING set directly, its
        last generated token pending as the next decode input."""
        if uid in self._all:
            raise ValueError(
                f"uid {uid} already submitted to this scheduler; "
                f"resume needs a fresh uid")
        sm = self.engine.state_manager
        need = len(prompt) + max(int(max_new_tokens) - 1, 0)
        if need > sm.config.max_seq_len:
            raise RuntimeError(
                f"request uid={uid} cannot be resumed: "
                f"len(prompt)={len(prompt)} + max_new_tokens="
                f"{max_new_tokens} needs {need} KV slots, over "
                f"max_seq_len={sm.config.max_seq_len}")
        if not sm.known_seq(uid):
            raise ValueError(
                f"cannot resume uid {uid}: the engine holds no KV for "
                f"it (restore the handoff first)")
        if not generated:
            raise ValueError("resume needs at least the first generated "
                             "token (emitted by the prefill side)")
        if len(generated) >= max_new_tokens or (
                eos_token_id is not None
                and int(generated[-1]) == eos_token_id):
            raise ValueError(
                f"uid {uid} already finished at prefill; nothing to "
                f"resume")
        seen = sm.seqs[uid].seen_tokens
        expect = len(prompt) + len(generated) - 1
        if seen != expect:
            raise ValueError(
                f"handoff state inconsistent for uid {uid}: cache holds "
                f"{seen} tokens, descriptor implies {expect}")
        rng = np.random.default_rng()
        if rng_state is not None:
            rng.bit_generator.state = rng_state
        now = self.clock()
        req = _Request(uid, list(map(int, prompt)), max_new_tokens,
                       eos_token_id, now, temperature=temperature,
                       top_p=top_p, top_k=top_k, rng=rng,
                       on_token=on_token)
        req.prefill_sent = len(req.prompt)
        req.generated = list(map(int, generated))
        req.next_token = int(generated[-1])
        req.first_token_t = now        # TTFT was paid on the prefill side
        req.last_emit_t = now
        self._all[uid] = req
        self._running.append(req)

    def pending(self) -> bool:
        return bool(self._queue or self._running)

    def inflight(self) -> int:
        """Requests admitted and not yet finished/cancelled."""
        return len(self._queue) + len(self._running)

    def known_uids(self) -> List[int]:
        """Every uid the scheduler still tracks."""
        return list(self._all)

    # ------------------------------------------------------------------
    def cancel(self, uid: int) -> bool:
        """Abort an in-flight request and release its KV blocks. Returns
        False if the uid is unknown, already finished, or already
        cancelled."""
        req = self._all.get(uid)
        if req is None or req.done or req.cancelled:
            return False
        req.cancelled = True
        req.next_token = None
        if req in self._running:
            self._running.remove(req)
        if req in self._queue:
            self._queue.remove(req)
        self.engine.flush(uid)     # frees the blocks; no-op if none held
        return True

    def release(self, uid: int) -> None:
        """Forget a finished or cancelled request so its uid can be
        resubmitted."""
        req = self._all.get(uid)
        if req is None:
            return
        if not (req.done or req.cancelled):
            raise ValueError(
                f"uid {uid} is still in flight; cancel() it first")
        del self._all[uid]

    # ------------------------------------------------------------------
    def _finish(self, req: _Request) -> None:
        req.finish_t = self.clock()
        self.engine.flush(req.uid)
        if req in self._running:
            self._running.remove(req)

    def _evict_partial_prefill(self, exclude=()) -> bool:
        """Free the KV blocks of the most recently admitted partial prefill
        (it restarts from token 0 later)."""
        for req in reversed(self._queue):
            if req.prefill_sent > 0 and req.uid not in exclude:
                self.engine.flush(req.uid)
                req.prefill_sent = 0
                return True
        return False

    def step(self) -> int:
        """One composed engine step; returns the number of tokens run."""
        uids: List[int] = []
        toks: List[List[int]] = []
        decode_reqs: List[_Request] = []
        budget = self.token_budget

        # (a) decodes first, round-robin so a budget smaller than the
        # running set starves nobody
        for req in list(self._running):
            if budget <= 0:
                break
            uids.append(req.uid)
            toks.append([req.next_token])
            decode_reqs.append(req)
            budget -= 1
        if decode_reqs and len(decode_reqs) < len(self._running):
            k = len(decode_reqs)
            self._running = self._running[k:] + self._running[:k]

        # (b) fill the remainder with prompt chunks (FIFO, chunk-aligned)
        sm = self.engine.state_manager
        new_admitted = 0  # new uids admitted into this batch so far
        for req in list(self._queue):
            if budget <= 0:
                break
            if req.prefill_sent == 0:
                if (sm.tracked_sequences() + new_admitted
                        >= sm.config.max_tracked_sequences):
                    break  # sequence slots full: wait for a finish
                # prefix caching matches the FULL prompt here: put() only
                # ever sees one chunk
                _, n_reused = sm.match_prefix(
                    req.uid, np.asarray(req.prompt, np.int64))
                if n_reused:
                    req.prefill_sent = n_reused
            left = len(req.prompt) - req.prefill_sent
            take = min(left, budget, max(self.chunk, 1))
            piece = req.prompt[req.prefill_sent:req.prefill_sent + take]
            if not self.engine.can_schedule(
                    uids + [req.uid], [len(t) for t in toks] + [take]):
                break  # KV pool full: wait for a running seq to finish
            if req.prefill_sent == 0:
                new_admitted += 1
            uids.append(req.uid)
            toks.append(piece)
            req.prefill_sent += take
            budget -= take

        if uids and not self.engine.can_schedule(
                uids, [len(t) for t in toks]):
            # decodes alone over the pool: free blocks held by a queued
            # partial prefill before declaring the config impossible
            if self._evict_partial_prefill(exclude=set(uids)):
                return 0
            raise RuntimeError(
                "running decodes alone exceed the KV pool; shrink the "
                "admitted set (lower max_tracked_sequences) or add blocks")

        if not uids:
            if self._queue and not self._running:
                head = self._queue[0]
                bs = sm.block_size
                total = len(head.prompt) + max(head.max_new_tokens - 1, 0)
                need = -(-total // bs)
                if need > sm.config.num_blocks - 1:  # block 0 is the null
                    raise RuntimeError(
                        f"request uid={head.uid} cannot be scheduled: "
                        f"{len(head.prompt)}+{head.max_new_tokens} tokens "
                        f"need {need} KV blocks, pool has "
                        f"{sm.config.num_blocks - 1}")
                if self._evict_partial_prefill(exclude={head.uid}):
                    return 0
                raise RuntimeError(
                    f"request uid={head.uid} cannot be scheduled: KV "
                    f"pool exhausted with no running sequences to drain")
            return 0

        if (decode_reqs and len(decode_reqs) == len(uids)
                and all(r.temperature <= 0.0 for r in decode_reqs)):
            # pure-GREEDY-decode step: device argmax, [N] int32 to host
            # instead of [N, vocab] logits
            assert all(len(t) == 1 for t in toks)
            window = getattr(self.engine, "decode_window", 1)
            if window > 1:
                # fused multi-step window: no prompt chunk was composed
                # this step, so none waits behind the K steps
                return self._step_fused_window(uids, toks, decode_reqs)
            nxt_map = self.engine._decode_batch_greedy(
                uids, [t[0] for t in toks])
            self.steps += 1
            for req in decode_reqs:
                self._emit(req, nxt_map[req.uid])
            return len(uids)

        # mixed composition: put() runs it as one ragged step
        logits = np.asarray(self.engine.put(uids, toks))
        self.steps += 1
        now = self.clock()

        for i, uid in enumerate(uids):
            req = self._all[uid]
            if req in decode_reqs:
                self._emit(req, req.pick(logits[i]))
            elif req.prefill_done:
                # final prompt chunk: its last-token logits yield the first
                # generated token (TTFT is measured here)
                req.first_token_t = now
                self._queue.remove(req)
                if req.max_new_tokens <= 0:
                    self._finish(req)
                else:
                    self._running.append(req)
                    self._emit(req, req.pick(logits[i]))
            # else: mid-prompt chunk — logits ignored
        return sum(len(t) for t in toks)

    def _step_fused_window(self, uids: List[int], toks: List[List[int]],
                           decode_reqs: List["_Request"]) -> int:
        """One fused K-step decode window over the composed greedy decode
        set; emits every produced token through _emit."""
        remaining = [r.max_new_tokens - len(r.generated)
                     for r in decode_reqs]
        sl = self.engine._window_steps_left(uids, remaining)
        eos = [(-1 if r.eos_token_id is None else int(r.eos_token_id))
               for r in decode_reqs]
        em = self.engine._decode_window_greedy(
            uids, [t[0] for t in toks], sl, eos)
        self.steps += 1
        for req in decode_reqs:
            for tok in em[req.uid]:
                self._emit(req, tok)
        return sum(len(em[u]) for u in uids)

    def _emit(self, req: _Request, tok: int) -> None:
        """Record a produced token; finish or queue it as the next decode
        input. The EOS is included in the output, and the final emitted
        token is never fed back."""
        req.last_emit_t = self.clock()
        req.generated.append(tok)
        if ((req.eos_token_id is not None and tok == req.eos_token_id)
                or len(req.generated) >= req.max_new_tokens):
            self._finish(req)
        else:
            req.next_token = tok
        if req.on_token is not None:
            req.on_token(req.uid, tok, req.done)

    # ------------------------------------------------------------------
    def run(self, max_steps: int = 10 ** 6) -> None:
        while self.pending() and max_steps > 0:
            self.step()
            max_steps -= 1

    def results(self) -> Dict[int, np.ndarray]:
        return {uid: np.asarray(r.prompt + r.generated)
                for uid, r in self._all.items() if r.done}

    def metrics(self) -> Dict[int, Dict[str, float]]:
        """Per-request latency bookkeeping (TTFT / total / tokens)."""
        out = {}
        for uid, r in self._all.items():
            if not r.done:
                continue
            out[uid] = {
                "ttft_s": (r.first_token_t or r.finish_t) - r.submit_t,
                "total_s": r.finish_t - r.submit_t,
                "new_tokens": len(r.generated),
            }
        return out
