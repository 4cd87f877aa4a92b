"""The benchmark's own spans and counts around calls into the server.

The port does not yet count decode steps, per-request spans or frames
vocoded itself, so the benchmark wraps the calls it needs on one server
instance (instance attributes shadow the methods; the classes are not
touched):

  * `engine.submit`: an admission's prefill, its prompt length, its span;
  * `engine.step_begin`: a decode dispatch and its snapped step count;
  * `engine.step_commit`: the tokens each dispatch emitted, and the
    context each was computed over;
  * `server._finish`: a request's emitted ids, as the engine handed them
    over;
  * `server._push_vocode_result`: the speaker ids its audio was rendered
    with;
  * `server._vocode_scalar` / `_vocode_group`: vocode spans and the samples
    each emits;
  * `server.waiting.put`: which client request a queued pending is, read
    from a context variable the client sets before its call.
"""

from __future__ import annotations

import asyncio
import contextvars
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from perfbench.roofline import counts

CURRENT = contextvars.ContextVar("perfbench_request", default=None)


class TaggedQueue(asyncio.Queue):
    def __init__(self, probe: "Probe"):
        super().__init__()
        self._probe = probe

    async def put(self, item):
        key = CURRENT.get()
        if key is not None:
            self._probe.request_of[id(item)] = key
        await super().put(item)


class Probe:
    def __init__(self, server, llm: Dict, head_rows: int):
        self.server = server
        self.llm = llm
        self.head_rows = head_rows
        self.lock = threading.Lock()
        self.request_of: Dict[int, Tuple] = {}
        self.tokens: Dict[Tuple, np.ndarray] = {}
        self.speakers: Dict[Tuple, Optional[np.ndarray]] = {}
        self.prompt_len: Dict[int, int] = {}
        # (time, value) records
        self.dispatches: List[Tuple[float, int]] = []
        self.emitted: List[Tuple[float, int, float]] = []  # (t, tokens, flops) a commit
        self.prefills: List[Tuple[float, int, float]] = []  # (t, tokens, flops)
        self.vocodes: List[Tuple[float, float, int]] = []  # (t0, t1, samples emitted)
        self.spans: List[Tuple[str, float, float]] = []
        self._wrap()

    def _span(self, name, t0, t1):
        with self.lock:
            self.spans.append((name, t0, t1))

    def _wrap(self):
        srv, eng = self.server, self.server.engine
        srv.waiting = TaggedQueue(self)
        submit, begin, commit = eng.submit, eng.step_begin, eng.step_commit
        finish, push = srv._finish, srv._push_vocode_result
        scalar, group = srv._vocode_scalar, srv._vocode_group

        def submit_w(prompt_ids, *a, prompt_len=None, **kw):
            t0 = time.perf_counter()
            req = submit(prompt_ids, *a, prompt_len=prompt_len, **kw)
            t1 = time.perf_counter()
            n = int(prompt_len) if prompt_len is not None else len(prompt_ids)
            self.prompt_len[req] = n
            self.prefills.append((t1, n, counts.prefill_flops(self.llm, n, self.head_rows)))
            self._span("admit", t0, t1)
            return req

        def begin_w(n_steps, chain_fn=None):
            t0 = time.perf_counter()
            handle = begin(n_steps, chain_fn)
            t1 = time.perf_counter()
            if handle is not None:
                self.dispatches.append((t0, int(handle[2])))
            self._span("dispatch", t0, t1)
            return handle

        def commit_w(handle, fetched):
            t0 = time.perf_counter()
            base = {req: len(eng.buffers[req]) for req in handle[3]
                    if req is not None and req in eng.buffers}
            out = commit(handle, fetched)
            t1 = time.perf_counter()
            runs = [(self.prompt_len.get(req, 0) + base.get(req, 0), len(new))
                    for req, new in out[0].items()]
            self.emitted.append((t1, sum(n for _, n in runs),
                                 sum(counts.decode_run_flops(self.llm, s, n, self.head_rows)
                                     for s, n in runs)))
            self._span("commit", t0, t1)
            return out

        def finish_w(req_id, tokens):
            pending = srv.inflight.get(req_id)
            key = self.request_of.get(id(pending))
            if key is not None:
                self.tokens[key] = np.asarray(tokens, np.int64).copy()
            return finish(req_id, tokens)

        def push_w(res):
            pending = res["pending"]
            key = self.request_of.get(id(pending))
            if key is not None and (res["offline"] or res["final"]) and res["error"] is None:
                g = pending.global_tokens
                if g is not None:
                    g = g.cpu().numpy() if hasattr(g, "cpu") else np.asarray(g)
                    g = np.asarray(g, np.int64).reshape(-1)
                self.speakers[key] = g
            return push(res)

        def scalar_w(w, out):
            t0 = time.perf_counter()
            r = scalar(w, out)
            t1 = time.perf_counter()
            with self.lock:
                self.vocodes.append((t0, t1, int(w[5] - w[4])))
            self._span("vocode", t0, t1)
            return r

        def group_w(take, b, out):
            t0 = time.perf_counter()
            r = group(take, b, out)
            t1 = time.perf_counter()
            with self.lock:
                self.vocodes.append((t0, t1, int(sum(w[5] - w[4] for w in take))))
            self._span("vocode", t0, t1)
            return r

        eng.submit, eng.step_begin, eng.step_commit = submit_w, begin_w, commit_w
        srv._finish, srv._push_vocode_result = finish_w, push_w
        srv._vocode_scalar, srv._vocode_group = scalar_w, group_w

    # -- reductions over a time interval ----------------------------------

    def steps_in(self, t0: float, t1: float) -> int:
        return sum(n for t, n in self.dispatches if t0 <= t < t1)

    def lm_flops_in(self, t0: float, t1: float) -> float:
        return (sum(f for t, _, f in self.emitted if t0 <= t < t1)
                + sum(f for t, _, f in self.prefills if t0 <= t < t1))

    def vocoded_samples_in(self, t0: float, t1: float) -> float:
        """Samples emitted by vocode calls, each weighted by the share of
        its span inside [t0, t1)."""
        total = 0.0
        with self.lock:
            spans = list(self.vocodes)
        for a, b, n in spans:
            inside = max(0.0, min(b, t1) - max(a, t0))
            total += n * (inside / (b - a) if b > a else float(t0 <= a < t1))
        return total
