"""Captured decode units: the port's counterpart of `jax.jit`'s program cache
for the decode loops.

The JAX package runs each decode loop as one XLA program: `generate`'s
`while_loop`, `decode_chunk`'s `lax.scan` and the engines' n-step scans.
Run eagerly, one decode step of the port launches ~1200 kernels, and the
host's launch overhead takes ~90% of the step's wall time.  So the port
captures a *unit* of U decode steps as one CUDA graph over fixed state
buffers, and replays it n / U times for a dispatch of n steps: the host
launches one graph per U steps instead of ~1200 kernels per step.

A `DecodeUnit` is built from a scan function (`make_scan(generators)` gives
`scan(state) -> (state, tokens (B, U), valid (B, U))`; `generators` is one
generator, or a list of one per row) and the state
buffers it is bound to.  The last step of the unit copies its state back
into those buffers and the unit's tokens and validity into `out`, so every
replay starts from where the previous one ended.  A unit whose steps emit a
variable number of tokens (a speculative round emits 1 to k,
`lm/speculative.py`) keeps its tokens in its state's own buffers at device
offsets instead: its scan returns `(state, *columns)`, (B, n) int columns
that fill an `out` of `out_width` columns (the speculative unit reports its
step and done flags there), and `unpack` does not apply.  Around the
capture:

  * the warm-up that must precede it (it builds the kernels, cuBLAS plans
    and the RoPE table) runs on a scratch copy of the buffers, so it never
    advances a live request's state;
  * it is captured on a stream of its own and counts its merges on arrival
    counters of its own (`arrivals.private`), which the graph keeps
    wherever it replays: no other unit, and no other thread's warm-up on the
    same pooled stream, shares them; the capture touches no other stream
    (no device-wide synchronize), and errors only in its own thread
    (`thread_local`), so other threads dispatch while it runs; everything
    it writes on its stream was allocated before that stream waited for
    the caller's (the generators' seed and offset included);
  * the unit owns a generator registered with the graph, or one per batch
    row (`n_generators`, for per-row seeds: each registered with the same
    graph); `bound` copies the caller's generator states into them before
    the first replay and back after the last, so a request's draws are
    those of its own generators, one per sampled step, as in the eager
    loop;
  * temperature and top_p are device buffers of the unit (`inputs`), filled
    per request, because JAX traces them;
  * the warm-up and the capture are set-up, not the caller's work (the
    capture records launches without running them): the wrappers'
    `launches` ticks of both, this thread's alone (`build.launch_tally`),
    are taken back (the warm-up's are kept in `setup_launches`), and every
    replay adds the unit's launches to `REPLAYED` instead.

A capture or replay error raises: there is no eager fallback on the card.
On the CPU the same unit runs its scan eagerly at each replay; nothing is
captured and nothing is cached (`unit` builds a fresh one every call).  A
unit built with `capture=False` (a tensor-parallel shard whose row
all-reduces through gloo, which runs on the host: `parallel.capturable`)
runs its scan eagerly on the card too, and is cached like the others.

Units have owners (`UnitCache`): a pipeline keeps the units of its
`generate` and `decode_chunk` calls, an engine those of its dispatches, and
each goes with its owner or when the owner evicts it.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import weakref
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch

from sparktts_tpu_torch.kernels import (
    arrivals,
    build,
    decode_attention,
    flash_attention,
    int4_matmul,
    int8_mlp,
    paged_attention,
    vocoder_fusion,
)
from sparktts_tpu_torch.lm.sample import Generators

#: The kernel wrapper modules, by kernel name; each keeps a `launches` count.
KERNELS = {
    "flash_attention_prefill": flash_attention,
    "dense_decode_attention": decode_attention,
    "fused_residual_unit": vocoder_fusion,
    "int8_mlp_matvec": int8_mlp,
    "int4_matvec": int4_matmul,
    "paged_decode_attention": paged_attention,
}

#: Kernel launches made by graph replays since the last `reset_launches`.
REPLAYED: Dict[str, int] = dict.fromkeys(KERNELS, 0)
_replayed_lock = threading.Lock()

Scan = Callable[[Any], Tuple[Any, torch.Tensor, torch.Tensor]]


def tensors(state) -> List[torch.Tensor]:
    """The tensors of a state (nested tuples of tensors), in field order."""
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for field in state for t in tensors(field)]


def _clone(state):
    if isinstance(state, torch.Tensor):
        return state.clone()
    return type(state)(*(_clone(field) for field in state))


def launches() -> Dict[str, int]:
    """Launches of each kernel: eager ones (the wrappers' counts) plus those
    of graph replays."""
    with _replayed_lock:
        return {name: m.launches + REPLAYED[name] for name, m in KERNELS.items()}


def reset_launches() -> None:
    """Set every wrapper's count and every replayed count to 0."""
    with _replayed_lock:
        for name, m in KERNELS.items():
            m.launches = 0
            REPLAYED[name] = 0


class DecodeUnit:
    """U decode steps over fixed state buffers: one CUDA graph on the card,
    the eager scan on the CPU."""

    def __init__(self, make_scan: Callable[[Generators], Scan], state, steps: int,
                 inputs: Optional[Dict[str, torch.Tensor]] = None, name: str = "decode unit",
                 n_generators: int = 1, out_width: Optional[int] = None,
                 capture: bool = True):
        self.state = state            # the buffers every replay reads and updates
        self.steps = steps
        self.inputs = inputs or {}    # static inputs the caller fills before replaying
        self.name = name
        self.device = tensors(state)[0].device
        self.generators = [torch.Generator(device=self.device) for _ in range(n_generators)]
        self._scan = make_scan(self.generators[0] if n_generators == 1 else self.generators)
        b = state.cur_token.shape[0]
        self.out = torch.zeros((b, out_width or 2 * steps), dtype=torch.int32, device=self.device)
        self.replays = 0
        self.unit_launches = dict.fromkeys(KERNELS, 0)   # launches a replay
        self.setup_launches = dict.fromkeys(KERNELS, 0)  # launches of the warm-up
        self.capture_ms = 0.0
        self.pool_bytes = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.owner = ""  # the tag of the cache that built it
        self._replayed: Optional[torch.cuda.Event] = None  # after the last replay's work
        self.lock = threading.RLock()
        if self.device.type == "cuda" and capture:
            self._capture()

    def _body(self, state, out: torch.Tensor) -> None:
        new, *columns = self._scan(state)
        for mine, theirs in zip(tensors(state), tensors(new)):
            if mine is not theirs:
                mine.copy_(theirs)
        out.copy_(torch.cat([c.int() for c in columns], dim=1))

    def _capture(self) -> None:
        with arrivals.private(self.device) as counters:
            self._counters = counters  # bound by the graph: kept as long as the unit
            self._capture_on(torch.cuda.Stream(self.device))

    def _capture_on(self, stream: torch.cuda.Stream) -> None:
        graph = torch.cuda.CUDAGraph()
        # registering a generator allocates its seed and offset on the
        # caller's stream, and capture_begin writes them on `stream`: so
        # register before `stream` waits for the caller's stream.  The block
        # may have been freed by another thread a moment before, with work
        # still queued that reads it (unordered, the writes landed in a live
        # dispatch's step result)
        for generator in self.generators:
            graph.register_generator_state(generator)
        scratch = _clone(self.state)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with build.launch_tally() as warm, torch.cuda.stream(stream):
            self._body(scratch, torch.empty_like(self.out))
        stream.synchronize()
        del scratch
        reserved = torch.cuda.memory_reserved(self.device)  # the graph's pool is new segments
        caller = torch.cuda.current_stream(self.device)
        t0 = time.perf_counter()
        # capture_begin/end, not `torch.cuda.graph`: that context synchronizes
        # the whole card, runs the garbage collector and empties the cache
        # first, which would stall every other thread's dispatches (a server
        # captures in background threads while it serves)
        try:
            with build.launch_tally() as captured, torch.cuda.stream(stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self._body(self.state, self.out)
                finally:
                    graph.capture_end()
        finally:
            torch.cuda.set_stream(caller)  # a failed capture leaves its stream current
            # set-up, this thread's launches only: replays count the unit's
            for name, m in KERNELS.items():
                m.launches -= warm.get(name, 0) + captured.get(name, 0)
                self.setup_launches[name] = warm.get(name, 0)
                self.unit_launches[name] = captured.get(name, 0)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph = graph
        self._replayed = torch.cuda.Event()

    @contextlib.contextmanager
    def bound(self, state, generator: Generators):
        """Inside the block the unit's buffers hold `state` and its
        generators hold the states of `generator` (one, or a list of one per
        row, as the unit was built); after it `state` (each of its tensors
        that is not the unit's own) and `generator` hold the unit's.  Holds
        the unit's lock throughout."""
        theirs_gens = [generator] if isinstance(generator, torch.Generator) else list(generator)
        if len(theirs_gens) != len(self.generators):
            raise ValueError(f"{self.name}: got {len(theirs_gens)} generators for a unit of "
                             f"{len(self.generators)}")
        with self.lock:
            pairs = [(mine, theirs) for mine, theirs in zip(tensors(self.state), tensors(state))
                     if mine.data_ptr() != theirs.data_ptr()]
            for mine, theirs in pairs:
                mine.copy_(theirs)
            for mine, theirs in zip(self.generators, theirs_gens):
                mine.set_state(theirs.get_state())
            try:
                yield self
            finally:
                for mine, theirs in pairs:
                    theirs.copy_(mine)
                for mine, theirs in zip(self.generators, theirs_gens):
                    theirs.set_state(mine.get_state())

    def replay(self) -> torch.Tensor:
        """Run the unit's U steps once; returns `out` (B, 2U) int32: the U
        emitted tokens, then their validity (or the scan's own columns, for a
        unit built with `out_width`).  The next replay overwrites it."""
        with self.lock:
            if self.graph is None:
                self._body(self.state, self.out)
            else:
                self.graph.replay()
                self._replayed.record()
                with _replayed_lock:
                    for name, n in self.unit_launches.items():
                        REPLAYED[name] += n
            self.replays += 1
        return self.out

    def wait(self) -> None:
        """Block until the work of the last replay has ended on the card."""
        if self._replayed is not None:
            self._replayed.synchronize()

    def run(self, n_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """n_steps (a multiple of U) as n_steps / U replays; returns (tokens
        (B, n) int64, valid (B, n) bool)."""
        if n_steps % self.steps:
            raise ValueError(f"{self.name}: {n_steps} steps are not a multiple of {self.steps}")
        outs = [self.replay().clone() for _ in range(n_steps // self.steps)]
        return unpack(outs, self.steps)


def unpack(outs: List[torch.Tensor], steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replay outputs (each (B, 2U)) -> (tokens (B, n) int64, valid (B, n) bool)."""
    toks = torch.cat([o[:, :steps] for o in outs], dim=1).long()
    valid = torch.cat([o[:, steps:] for o in outs], dim=1).bool()
    return toks, valid


#: Device types whose units are cached.  On the CPU a unit is built fresh
#: every call (nothing is captured, so nothing is worth keeping); a test adds
#: "cpu" here to exercise the registry's ownership and eviction on the CPU.
CACHED_DEVICE_TYPES = ("cuda",)

_live: List["weakref.ref[DecodeUnit]"] = []  # every unit a cache built, in build order
_live_lock = threading.Lock()
_builds = 0  # units built by caches since import


class UnitCache:
    """The decode units of one owner: a pipeline (the units of `generate`
    and `decode_chunk` over its `llm_params`) or an engine (the units of its
    dispatches over its slot buffers).  JAX keeps its program cache per
    pipeline; here each owner holds a cache, so its units, with the params,
    state buffers and graph pool each keeps alive, go when the owner goes,
    or at `clear` (a pipeline whose `llm_params` is replaced, an engine's
    `close`).  A unit still held by a caller (a replay in flight in another
    thread) keeps what it reads alive until that caller drops it.

    A build holds only its key's lock: a lookup of a unit already built
    never waits for the capture of another (35-1000 ms), and callers of one
    key wait for its single build.  A build that began before a `clear` is
    returned to its caller but not kept."""

    _serial = itertools.count()

    def __init__(self, label: str):
        self.tag = f"{label} #{next(UnitCache._serial)}"  # each unit's `owner`
        self._units: Dict[Hashable, DecodeUnit] = {}
        self._lock = threading.Lock()  # guards the dicts, never held during a build
        self._building: Dict[Hashable, threading.Lock] = {}
        self._epoch = 0  # bumped by clear

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._units

    def __len__(self) -> int:
        with self._lock:
            return len(self._units)

    def get(self, key: Hashable, build: Callable[[], DecodeUnit]) -> DecodeUnit:
        """The unit of `key`, built by `build` on first use."""
        global _builds
        with self._lock:
            u = self._units.get(key)
            if u is not None:
                return u
            lock = self._building.setdefault(key, threading.Lock())
            epoch = self._epoch
        with lock:
            with self._lock:
                u = self._units.get(key)
            if u is not None:
                return u
            u = build()
            with _live_lock:
                _builds += 1
                if isinstance(u, DecodeUnit):  # (a test's stand-in is kept, not listed)
                    u.owner = self.tag
                    _live.append(weakref.ref(u))
            with self._lock:
                if epoch == self._epoch:
                    self._units[key] = u
                    self._building.pop(key, None)
            return u

    def pop(self, key: Hashable) -> Optional[DecodeUnit]:
        with self._lock:
            return self._units.pop(key, None)

    def clear(self) -> None:
        """Evict every unit, after the work its last replay queued on the
        card has ended (its graph pool then returns to the allocator)."""
        with self._lock:
            evicted = list(self._units.values())
            self._units.clear()
            self._building.clear()
            self._epoch += 1
        for u in evicted:
            u.wait()


#: The cache of callers that name no owner (direct calls of `generate` or
#: `decode_chunk` with a params tree): their units live as long as the process.
SHARED = UnitCache("shared")


def unit(key: Hashable, device: torch.device, build: Callable[[], DecodeUnit],
         cache: Optional[UnitCache] = None) -> DecodeUnit:
    """The captured unit of `key` in `cache` (default `SHARED`) on a card,
    built (and captured) by `build` on first use; on a device type not in
    CACHED_DEVICE_TYPES a fresh unit every call."""
    if device.type not in CACHED_DEVICE_TYPES:
        return build()
    return (SHARED if cache is None else cache).get(key, build)


def units() -> List[DecodeUnit]:
    """The units of every cache still alive (held by their owner's cache or
    by a caller), in build order."""
    with _live_lock:
        alive = [(r, r()) for r in _live]
        _live[:] = [r for r, u in alive if u is not None]
        return [u for _, u in alive if u is not None]


def builds() -> int:
    """Units built by caches since import (a capture each on a card)."""
    with _live_lock:
        return _builds
