"""Dynamic SplitFuse scheduler over the ragged v2 engine.

Port of ``deepspeed_tpu/inference/v2/scheduler.py`` (DeepSpeed-FastGen's
Dynamic SplitFuse: long prompts are split into chunks scheduled across
forward passes, short prompts fill a token budget, and decodes never
stall behind a long prefill). A copy with the same telemetry (the
``serving_*`` metrics, trace spans and flight-recorder events). Each
composed step is one ``put()`` — one ragged step (paged_model
``paged_ragged_step``) — except pure greedy decode steps, which take the
engine's fused decode window. Sampled requests draw on the host from
put()'s logits with their own numpy Generator (``host_sample``), as in
the JAX package, so seeded streams match it. LoRA adapters are not
ported (ROADMAP A11): ``submit(adapter=...)`` raises.

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

from ...telemetry import trace
from ...telemetry import recorder as flight


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
    # streaming hook (the async serving runtime, serve/): called as
    # on_token(uid, token, finished) from inside step()
    on_token: Optional[Callable[[int, int, bool], None]] = None
    # timeline anchors (telemetry/timeline.py request lifeline). These are
    # ALWAYS perf_counter stamps — submit_t/finish_t follow the
    # scheduler's injectable clock (tests fake it), and a fake timestamp
    # must never leak into the shared trace buffer's time base.
    t_submit_pc: float = 0.0
    t_prefill_pc: Optional[float] = None
    t_first_tok_pc: Optional[float] = None
    # distributed trace id (telemetry/context.py): lifeline spans and
    # flight events carry it so the stitched fleet timeline follows the
    # request across router dispatch / prefill / handoff / decode hops
    trace_id: Optional[str] = None
    # multi-tenant LoRA: adapter NAME serving this request (None = base
    # model); scopes prefix-cache matches and rides the engine's
    # per-row slot gather
    adapter: Optional[str] = None

    def trace_attr(self) -> Dict[str, str]:
        return ({"trace_id": self.trace_id}
                if self.trace_id is not None else {})

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
    many prompt-chunk tokens as fit in the remaining token budget —
    FastGen's two behaviors: long prompts split across steps, short
    prompts/chunks fused with generation so forward sizes stay uniform."""

    def __init__(self, engine, token_budget: Optional[int] = None,
                 chunk: Optional[int] = None, clock=time.perf_counter):
        self.engine = engine
        sm = engine.state_manager.config
        self.token_budget = min(token_budget or sm.max_ragged_batch_size,
                                sm.max_ragged_batch_size)
        # chunks align to the prefill bucket so every split hits an
        # already-compiled program size
        self.chunk = chunk or engine.config.prefill_bucket
        self.clock = clock
        self._queue: List[_Request] = []     # waiting for prefill budget
        self._running: List[_Request] = []   # prefill done, decoding
        self._all: Dict[int, _Request] = {}
        self.steps = 0
        self._init_telemetry()

    def _init_telemetry(self):
        from ...telemetry import get_registry
        reg = get_registry()
        self._m_queue = reg.gauge(
            "serving_queue_depth", "requests waiting on prefill budget")
        self._m_running = reg.gauge(
            "serving_running_sequences", "requests decoding")
        self._m_steps = reg.counter(
            "serving_steps_total", "composed engine steps run")
        self._m_step_tokens = reg.histogram(
            "serving_step_tokens", "tokens composed per engine step",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
        self._m_submitted = reg.counter(
            "serving_requests_submitted_total", "requests submitted")
        self._m_finished = reg.counter(
            "serving_requests_finished_total", "requests finished")
        self._m_preempted = reg.counter(
            "serving_preemptions_total",
            "partial prefills evicted to free KV blocks")
        self._m_ttft = reg.histogram(
            "serving_ttft_seconds", "submit -> first generated token",
            unit="s")
        self._m_tpot = reg.histogram(
            "serving_tpot_seconds",
            "time per output token (gap between consecutive emitted "
            "tokens of one request)", unit="s")
        self._m_req_time = reg.histogram(
            "serving_request_seconds", "submit -> request finished",
            unit="s")
        self._m_cancelled = reg.counter(
            "serving_requests_cancelled_total",
            "requests cancelled before finishing (KV blocks released)")
        self._m_gen_tokens = reg.counter(
            "serving_generated_tokens_total",
            "tokens generated across finished requests")

    def _update_depth_gauges(self):
        self._m_queue.set(len(self._queue))
        self._m_running.set(len(self._running))

    # ------------------------------------------------------------------
    def submit(self, uid: int, prompt: Sequence[int], max_new_tokens: int,
               eos_token_id: Optional[int] = None,
               temperature: float = 0.0, top_p: float = 1.0,
               top_k: int = 0, seed: Optional[int] = None,
               on_token: Optional[Callable[[int, int, bool], None]]
               = None, trace_ctx=None,
               adapter: Optional[str] = None) -> None:
        """temperature/top_p/seed are PER REQUEST (the MII SamplingParams
        surface): mixed greedy and sampled requests compose into the same
        steps; a SEEDED request's tokens are deterministic (independent
        of batch composition — the rng is per request), an unseeded one
        draws fresh OS entropy. ``on_token(uid, token, finished)`` fires
        for every emitted token (the serve/ streaming hook).
        ``trace_ctx`` (a :class:`~...telemetry.context.TraceContext`)
        correlates the request's lifeline spans — and, via
        ``engine.bind_trace``, the engine's batch spans — with its
        distributed trace. ``adapter`` (a LoRA adapter name) is not
        ported and raises NotImplementedError (ROADMAP A11)."""
        if adapter:
            raise NotImplementedError(
                "LoRA adapters are not ported to deepspeed_tpu_torch yet "
                "(ROADMAP A11)")
        if uid in self._all:
            # results()/metrics() are keyed by uid: admitting a second
            # request under a live key would silently cross their
            # per-request state. Reject loudly (a plain assert vanishes
            # under python -O).
            raise ValueError(
                f"uid {uid} already submitted to this scheduler "
                f"(per-uid results()/metrics() state would be "
                f"corrupted); use a fresh uid, or release(uid) once the "
                f"previous request is finished or cancelled")
        max_seq_len = self.engine.state_manager.config.max_seq_len
        # the final emitted token is never fed back (_emit), so the
        # request writes prompt + max(new-1, 0) KV slots — the same need
        # formula as the drain-path diagnostic below
        need = len(prompt) + max(max_new_tokens - 1, 0)
        if need > max_seq_len:
            # reject up front: admitted, the request would run until the
            # state manager refuses the decode past max_seq_len and the
            # failure would surface as a misleading KV-pool error
            raise RuntimeError(
                f"request uid={uid} cannot be scheduled: "
                f"len(prompt)={len(prompt)} + max_new_tokens="
                f"{max_new_tokens} needs {need} KV slots, over "
                f"max_seq_len={max_seq_len}; shorten the request or "
                f"raise state_manager.max_seq_len")
        req = _Request(uid, list(map(int, prompt)), max_new_tokens,
                       eos_token_id, self.clock(),
                       temperature=temperature, top_p=top_p, top_k=top_k,
                       rng=np.random.default_rng(seed), on_token=on_token,
                       t_submit_pc=time.perf_counter(), adapter=adapter)
        self._bind_trace(req, trace_ctx)
        self._all[uid] = req
        self._queue.append(req)
        self._m_submitted.inc()
        flight.record("request_submit", uid=int(uid),
                      prompt_tokens=len(req.prompt),
                      max_new_tokens=int(max_new_tokens),
                      **req.trace_attr())
        self._update_depth_gauges()

    def resume(self, uid: int, prompt: Sequence[int],
               generated: Sequence[int], max_new_tokens: int,
               eos_token_id: Optional[int] = None,
               temperature: float = 0.0, top_p: float = 1.0,
               top_k: int = 0, rng_state: Optional[dict] = None,
               on_token: Optional[Callable[[int, int, bool], None]]
               = None, trace_ctx=None) -> None:
        """Adopt a request mid-generation (the prefill/decode
        disaggregation path, serve/handoff.py): the engine already holds
        the sequence's KV — restored from a prefill replica — and
        ``generated`` tokens were emitted there (at least the first
        token, whose logits came from the handed-off prefill). The
        request enters the RUNNING set directly, its last generated
        token pending as the next decode input — exactly the state a
        colocated request is in after its final prompt chunk, which is
        what makes handed-off streams bit-identical to colocated ones.

        ``rng_state`` is the numpy bit-generator state captured after
        the prefill side's draws; restoring it keeps SAMPLED streams on
        the colocated token path too. ``on_token`` fires only for
        tokens decoded here — the caller already streamed
        ``generated``."""
        if uid in self._all:
            raise ValueError(
                f"uid {uid} already submitted to this scheduler; "
                f"resume needs a fresh uid")
        sm = self.engine.state_manager
        # same KV-slot precheck submit() enforces: an oversized request
        # must fail HERE, not mid-decode as a misleading pool error
        # that would take every in-flight request on this replica down
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
            # the last emitted token is never fed back, so the cache
            # must hold exactly prompt + all-but-last generated tokens
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
                       on_token=on_token,
                       t_submit_pc=time.perf_counter())
        self._bind_trace(req, trace_ctx)
        req.prefill_sent = len(req.prompt)
        req.generated = list(map(int, generated))
        req.next_token = int(generated[-1])
        req.first_token_t = now        # TTFT was paid on the prefill side
        req.last_emit_t = now
        req.t_prefill_pc = req.t_first_tok_pc = time.perf_counter()
        self._all[uid] = req
        self._running.append(req)
        self._m_submitted.inc()
        flight.record("request_resume", uid=int(uid),
                      prompt_tokens=len(req.prompt),
                      generated=len(req.generated),
                      max_new_tokens=int(max_new_tokens),
                      **req.trace_attr())
        self._update_depth_gauges()

    def _bind_trace(self, req: _Request, trace_ctx) -> None:
        """Record the request's distributed trace id and mirror it into
        the engine's per-uid binding so batch-level engine spans
        (ragged_step / decode_window / ...) carry it too."""
        if trace_ctx is None:
            return
        req.trace_id = str(trace_ctx.trace_id)
        bind = getattr(self.engine, "bind_trace", None)
        if bind is not None:
            bind(req.uid, req.trace_id)

    def pending(self) -> bool:
        return bool(self._queue or self._running)

    def inflight(self) -> int:
        """Requests admitted and not yet finished/cancelled (queued for
        prefill budget + decoding)."""
        return len(self._queue) + len(self._running)

    def known_uids(self) -> List[int]:
        """Every uid the scheduler still tracks (in flight, finished but
        not yet released) — the set the KV-leak detector reconciles the
        block pool against at drain."""
        return list(self._all)

    # ------------------------------------------------------------------
    def cancel(self, uid: int) -> bool:
        """Abort an in-flight request: drop it from the step composition
        and release its KV blocks back to the pool. No further tokens are
        emitted (and no on_token callback fires again). Returns False if
        the uid is unknown, already finished, or already cancelled. The
        request stays recorded (excluded from results()/metrics()) so the
        uid cannot be silently reused; release(uid) forgets it."""
        req = self._all.get(uid)
        if req is None or req.done or req.cancelled:
            return False
        req.cancelled = True
        req.next_token = None
        now_pc = time.perf_counter()
        t0 = req.t_submit_pc or now_pc
        trace.record("request", t0, now_pc - t0, uid=req.uid,
                     tokens=len(req.generated), status="cancelled",
                     **req.trace_attr())
        if req in self._running:
            self._running.remove(req)
        if req in self._queue:
            self._queue.remove(req)
        self.engine.flush(uid)     # frees the blocks; no-op if none held
        self._m_cancelled.inc()
        flight.record("request_cancel", uid=int(uid),
                      tokens=len(req.generated))
        self._update_depth_gauges()
        return True

    def release(self, uid: int) -> None:
        """Forget a finished or cancelled request so its uid can be
        resubmitted (long-lived serving: _all must not grow forever)."""
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
        now_pc = time.perf_counter()
        start = req.t_first_tok_pc or now_pc
        trace.record("request_decode", start, now_pc - start,
                     uid=req.uid, tokens=len(req.generated),
                     **req.trace_attr())
        t0 = req.t_submit_pc or start
        trace.record("request", t0, now_pc - t0, uid=req.uid,
                     tokens=len(req.generated), status="completed",
                     **req.trace_attr())
        self.engine.flush(req.uid)
        if req in self._running:
            self._running.remove(req)
        self._m_finished.inc()
        self._m_gen_tokens.inc(len(req.generated))
        ttft = (req.first_token_t or req.finish_t) - req.submit_t
        self._m_ttft.observe(ttft)
        self._m_req_time.observe(req.finish_t - req.submit_t)
        flight.record("request_finish", uid=int(req.uid),
                      tokens=len(req.generated),
                      ttft_s=round(ttft, 4),
                      total_s=round(req.finish_t - req.submit_t, 4),
                      **req.trace_attr())
        self._update_depth_gauges()

    def _evict_partial_prefill(self, exclude=()) -> bool:
        """Free the KV blocks of the most recently admitted partial
        prefill (it restarts from token 0 later). The recovery move when
        the pool is exhausted by work that cannot finish."""
        for req in reversed(self._queue):
            if req.prefill_sent > 0 and req.uid not in exclude:
                self.engine.flush(req.uid)
                req.prefill_sent = 0
                self._m_preempted.inc()
                return True
        return False

    def step(self) -> int:
        """One composed engine step; returns the number of tokens run."""
        uids: List[int] = []
        toks: List[List[int]] = []
        decode_reqs: List[_Request] = []
        budget = self.token_budget

        # (a) decodes first: generation is never stalled behind prefill.
        # Round-robin rotation so a budget smaller than the running set
        # starves nobody (the skipped tail leads the next step).
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

        # (b) fill the remainder with prompt chunks (FIFO, chunk-aligned;
        # the final or budget-tail chunk may be smaller — bucketed compile
        # sizes absorb fragments)
        sm = self.engine.state_manager
        new_admitted = 0  # can_schedule checks each uid against the
        # CURRENT tracked count; new uids admitted into the same batch
        # must be counted here or put() raises mid-batch
        for req in list(self._queue):
            if budget <= 0:
                break
            if req.prefill_sent == 0:
                if (sm.tracked_sequences() + new_admitted
                        >= sm.config.max_tracked_sequences):
                    break  # sequence slots full: wait for a finish
                # prefix caching must match against the FULL prompt here:
                # put() only ever sees one chunk (<= self.chunk tokens),
                # which would cap reuse at a chunk's worth
                _, n_reused = sm.match_prefix(
                    req.uid, np.asarray(req.prompt, np.int64),
                    adapter=req.adapter)
                if n_reused:
                    # match_prefix registered the uid in sm.seqs, so
                    # tracked_sequences() already counts it — no
                    # new_admitted increment (that compensates only for
                    # sequences created later inside put())
                    req.prefill_sent = n_reused
            left = len(req.prompt) - req.prefill_sent
            take = min(left, budget, max(self.chunk, 1))
            piece = req.prompt[req.prefill_sent:req.prefill_sent + take]
            # whole-batch check: decodes already composed + chunks so far
            # + this piece (a decode crossing a page boundary can itself
            # need a fresh KV block)
            if not self.engine.can_schedule(
                    uids + [req.uid], [len(t) for t in toks] + [take]):
                break  # KV pool full: wait for a running seq to finish
            if req.prefill_sent == 0:
                new_admitted += 1
            if req.t_prefill_pc is None:
                # first prefill chunk composed: the queue phase of the
                # request's timeline lifeline ends here
                req.t_prefill_pc = time.perf_counter()
                trace.record("request_queue", req.t_submit_pc,
                             req.t_prefill_pc - req.t_submit_pc,
                             uid=req.uid, **req.trace_attr())
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
                # pool dry with nothing draining it (requests exceeding
                # max_seq_len were already rejected at submit). Two cases:
                head = self._queue[0]
                bs = sm.block_size
                # the final emitted token is never fed back (_emit), so a
                # request writes prompt + max(new-1, 0) KV slots total
                total = len(head.prompt) + max(head.max_new_tokens - 1, 0)
                need = -(-total // bs)
                if need > sm.config.num_blocks - 1:  # block 0 is the null
                    raise RuntimeError(
                        f"request uid={head.uid} cannot be scheduled: "
                        f"{len(head.prompt)}+{head.max_new_tokens} tokens "
                        f"need {need} KV blocks, pool has "
                        f"{sm.config.num_blocks - 1}")
                # mutual exhaustion: several long prompts were admitted
                # concurrently and none can finish prefill — free the
                # most recent partial so the head makes progress.
                if self._evict_partial_prefill(exclude={head.uid}):
                    return 0
                raise RuntimeError(
                    f"request uid={head.uid} cannot be scheduled: KV "
                    f"pool exhausted with no running sequences to drain")
            return 0

        if (decode_reqs and len(decode_reqs) == len(uids)
                and all(r.temperature <= 0.0 for r in decode_reqs)):
            # pure-GREEDY-decode step: device argmax, [N] int32 to host
            # instead of [N, vocab] logits (same fast path generate()
            # uses). Gated on EVERY piece being a decode — a 1-token
            # final prompt chunk also has len(t) == 1 but needs the
            # put() path's prefill-completion handling — and on greedy
            # rows only (sampled requests draw from host rngs).
            assert all(len(t) == 1 for t in toks)
            window = getattr(self.engine, "decode_window", 1)
            if window > 1:
                # fused multi-step window. Reaching this path means the
                # composition loop above added NO prompt chunk this step
                # — the queue is empty or blocked (sequence slots full,
                # KV pool tight, or the budget consumed by decodes), so
                # no prefill work is stalled by running K steps at once;
                # composition re-runs after every window, so prefill
                # admission latency is bounded by one window (<= K
                # tokens/row). Each request carries its own budget/eos,
                # so rows finish mid-window (masked on device); every
                # emitted token still flows through _emit -> on_token,
                # arriving in bursts of up to K per step.
                return self._step_fused_window(uids, toks, decode_reqs,
                                               window)
            nxt_map = self.engine._decode_batch_greedy(
                uids, [t[0] for t in toks])
            self.steps += 1
            self._m_steps.inc()
            self._m_step_tokens.observe(len(uids))
            for req in decode_reqs:
                self._emit(req, nxt_map[req.uid])
            self._update_depth_gauges()
            return len(uids)

        # mixed composition: with ragged attention enabled (engine
        # default) put() emits this step as ONE RaggedBatch launch —
        # chunks and decode rows packed into the unified ragged program
        # (engine_v2.step_ragged) — instead of sequencing the
        # prefill/continue/decode families, so the scheduler never
        # trades prefill against decode across separate dispatches
        logits = np.asarray(self.engine.put(uids, toks))
        self.steps += 1
        self._m_steps.inc()
        self._m_step_tokens.observe(sum(len(t) for t in toks))
        now = self.clock()

        for i, uid in enumerate(uids):
            req = self._all[uid]
            if req in decode_reqs:
                self._emit(req, req.pick(logits[i]))
            elif req.prefill_done:
                # final prompt chunk: its last-token logits yield the
                # first generated token (TTFT is measured here)
                req.first_token_t = now
                req.t_first_tok_pc = time.perf_counter()
                start = req.t_prefill_pc or req.t_first_tok_pc
                trace.record("request_prefill", start,
                             req.t_first_tok_pc - start, uid=req.uid,
                             prompt_tokens=len(req.prompt),
                             **req.trace_attr())
                self._queue.remove(req)
                if req.max_new_tokens <= 0:
                    self._finish(req)
                else:
                    self._running.append(req)
                    self._emit(req, req.pick(logits[i]))
            # else: mid-prompt chunk — logits ignored
        self._update_depth_gauges()
        return sum(len(t) for t in toks)

    def _step_fused_window(self, uids: List[int], toks: List[List[int]],
                           decode_reqs: List["_Request"],
                           window: int) -> int:
        """One fused K-step decode window over the composed greedy
        decode set; emits every produced token through _emit (streaming
        on_token hooks fire per token, deadlines/cancellation re-check
        at the window boundary)."""
        remaining = [r.max_new_tokens - len(r.generated)
                     for r in decode_reqs]
        sl = self.engine._window_steps_left(uids, remaining)
        eos = [(-1 if r.eos_token_id is None else int(r.eos_token_id))
               for r in decode_reqs]
        em = self.engine._decode_window_greedy(
            uids, [t[0] for t in toks], sl, eos)
        self.steps += 1
        self._m_steps.inc()
        total = sum(len(em[u]) for u in uids)
        self._m_step_tokens.observe(total)
        for req in decode_reqs:
            for tok in em[req.uid]:
                self._emit(req, tok)
        self._update_depth_gauges()
        return total

    def _emit(self, req: _Request, tok: int) -> None:
        """Record a produced token; finish or queue it as the next decode
        input. Matches generate(): eos is included in the output, and the
        final emitted token is never fed back (no wasted forward)."""
        now = self.clock()
        if req.last_emit_t is not None:
            # inter-token gap = the serving TPOT distribution (first
            # token is TTFT territory, not TPOT)
            self._m_tpot.observe(now - req.last_emit_t)
        req.last_emit_t = now
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
