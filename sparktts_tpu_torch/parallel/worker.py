"""Leader and followers: one engine and one server code path over a
tensor-parallel row.

The JAX package serves a mesh from one controller: "multi-chip serving is
a device_put of the params — no separate server code path".  PyTorch runs
one process a card, and every rank of a row must make the same LM calls in
the same order, since each call all-reduces over the row.  So the row's
rank 0, the *leader*, owns everything above the LM: the tokenizer, the
codec, the engines' bookkeeping, the servers and the front doors.  Before
each LM device call (an engine's construction, admission, dispatch, slot
release or unit eviction, and the pipeline's `generate`) it announces the
call's name and host arguments to the row over a gloo side group
(`broadcast_object_list`), then makes it.  The other ranks, the
*followers*, run `Follower.run`: they make the same call on their own
shard, until the leader sends stop.  An announcement and its call happen
under one lock, so calls from several threads of the leader reach every
rank in one order.  Device arguments cross as host copies: a fused clone
admission tokenizes on the leader and announces the assembled prompt ids.

After each call every follower replies (`gather_object`) with whether the
call succeeded, how many all-reduces it made, and a hash of what it
committed: the call's result and an engine's replicated slot vectors (the
sampled tokens, positions, flags).  Every rank draws from a generator with
the engine's seed, and the logits after the row's all-reduce are the same
on every rank, so the hashes must agree.  A call that failed on every rank
after the same all-reduces leaves the row in step: the leader raises the
call's error and the row serves on.  Anything else (a call that failed on
some ranks only, different collectives, different hashes) breaks the row:
the leader tells the followers to abort, and every later call raises
`RowBroken`.  The check waits for each call's device work, once a call.

While the row is idle the leader pings the followers, so that a follower
waiting for the next call never reaches its group's timeout.

`spawn` starts the ranks of one host (`torch.multiprocessing`, one process
a rank) and returns each rank's result; `serve` runs a leader function on
rank 0 and a follower elsewhere.  Across hosts, start one process a rank
yourself and call `run_rank`.  A rank that fails ends the run: `spawn`
terminates the others and raises, and every process group has a timeout.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import hashlib
import itertools
import os
import pickle
import socket
import tempfile
import threading
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from sparktts_tpu_torch.parallel.mesh import (DEFAULT_TIMEOUT_S, Mesh, TPGroup, local_card,
                                              make_mesh, tp_of)


class RowBroken(RuntimeError):
    """The ranks of a tensor-parallel row fell out of step: a call failed
    on some ranks only, made different collectives on them, or committed
    different results.  Every later call of the row raises it, and the
    followers leave `Follower.run` with it (`report`: the follower's
    `Follower.report` then)."""

    def __init__(self, reason: str, report: Optional[dict] = None):
        super().__init__(reason)
        self.report = report


def _tensors(x) -> list:
    """The tensors of a call's outcome, in order; an engine's slot state
    without its KV cache (each rank holds its own heads of it)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if x is None:
        return []
    fields = getattr(x, "_fields", None)
    if fields is not None:
        return [t for name in fields if name != "cache" for t in _tensors(getattr(x, name))]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def outcome_hash(result, state=None) -> str:
    """A hash of a call's result and of the replicated part of its state
    (waits for the device)."""
    h = hashlib.sha1()
    for t in _tensors(result) + _tensors(state):
        a = t.detach().to("cpu").contiguous().reshape(-1)
        h.update(f"{a.dtype}{tuple(t.shape)}".encode())
        h.update(a.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _describe(error: BaseException) -> str:
    return f"{type(error).__name__}: {error}"


def _fault(replies: list) -> Optional[str]:
    """Why the row's replies to one call leave it out of step, or None.
    A reply is (succeeded, all-reduces made, hash or error)."""
    made = [r[1] for r in replies]
    if len(set(made)) > 1:
        return f"the ranks made {made} all-reduces"
    if len({r[0] for r in replies}) > 1:
        failed = {i: r[2] for i, r in enumerate(replies) if not r[0]}
        return f"it failed on row ranks {sorted(failed)} only: {failed}"
    if replies[0][0] and len({r[2] for r in replies}) > 1:
        return "the ranks committed different results"
    return None


class Leader:
    """The announcing side of a row (its rank 0)."""

    def __init__(self, tp: TPGroup):
        self.tp = tp
        self.ping_s = tp.timeout_s / 3  # idle seconds before a ping
        self.broken: Optional[str] = None
        self.checked = 0  # calls whose replies agreed
        self._lock = threading.RLock()
        self._depth = threading.local()
        self._engines = itertools.count()
        self._last = time.monotonic()
        self._stopped = threading.Event()
        self._beat = threading.Thread(target=self._heartbeat, name="tp-leader-ping", daemon=True)
        self._beat.start()

    def _send(self, msg) -> None:
        dist.broadcast_object_list([msg], src=self.tp.ranks[0], group=self.tp.side)
        self._last = time.monotonic()

    def _gather(self, reply) -> list:
        replies = [None] * self.tp.size
        dist.gather_object(reply, replies, dst=self.tp.ranks[0], group=self.tp.side)
        return replies

    def _break(self, reason: str) -> RowBroken:
        self.broken = reason
        with contextlib.suppress(Exception):
            self._send(("abort", reason))
        return RowBroken(reason)

    def run(self, msg, fn: Callable, outcome: Optional[Callable] = None):
        """Announce `msg`, run `fn()`, and check the followers' replies
        against this rank's, all under the row's lock; returns fn's result.
        `outcome(result)` gives the (result, state) whose hash the ranks
        compare (default: the result alone).  A call made inside another
        (one mirrored method calling another) is neither announced nor
        checked: the follower's outer call makes it."""
        with self._lock:
            if self.broken is not None:
                raise RowBroken(self.broken)
            depth = getattr(self._depth, "n", 0)
            if depth:
                self._depth.n = depth + 1
                try:
                    return fn()
                finally:
                    self._depth.n = depth
            self._send(msg)
            before = self.tp.reduces
            self._depth.n = 1
            error = result = None
            try:
                result = fn()
                mine = (True, 0, outcome_hash(*(outcome(result) if outcome else (result,))))
            except Exception as e:  # the row decides whether it stays in step
                error, mine = e, (False, 0, _describe(e))
            finally:
                self._depth.n = 0
            mine = (mine[0], self.tp.reduces - before, mine[2])
            try:
                replies = self._gather(mine)
            except Exception as e:
                raise self._break(f"{msg[0]}: no reply from the followers ({_describe(e)})") from e
            fault = _fault(replies)
            if fault is not None:
                raise self._break(f"{_name(msg)}: {fault}") from error
            if error is not None:
                raise error
            self.checked += 1
            return result

    def new_engine(self, kwargs: dict) -> int:
        """Announce an engine's construction; returns its id on the row."""
        with self._lock:
            eid = next(self._engines)
            self.run(("engine", eid, kwargs), lambda: None)
        return eid

    def ping(self) -> None:
        """Tell the followers the row is alive (no call)."""
        with self._lock:
            if self.broken is None and not self._stopped.is_set():
                self._send(("ping",))

    def _heartbeat(self) -> None:
        while not self._stopped.wait(self.ping_s / 4):
            if time.monotonic() - self._last >= self.ping_s:
                try:
                    self.ping()
                except Exception as e:
                    self.broken = f"ping: {_describe(e)}"
                    return

    def stop(self) -> None:
        with self._lock:
            self._stopped.set()
            if self.broken is None:
                self._send(("stop",))
        self._beat.join()


def _name(msg) -> str:
    return f"{msg[0]} {msg[2]}" if msg[0] == "engine_call" else msg[0]


def leader_of(params) -> Optional[Leader]:
    tp = tp_of(params)
    return None if tp is None else tp.leader


def mirrored(method):
    """An engine method that does LM device work: on a leading row it is
    announced to the followers, which make the same call on their engine,
    and the ranks' results and slot vectors are checked to agree.  Its
    arguments must be host values."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        leader = getattr(self, "leader", None)
        if leader is None:
            return method(self, *args, **kwargs)
        return leader.run(("engine_call", self.leader_id, method.__name__, args, kwargs),
                          lambda: method(self, *args, **kwargs),
                          lambda result: (result, self.slots))

    return wrapper


@contextlib.contextmanager
def lead(mesh: Mesh):
    """Make this rank the leader of its row for the block (it must be the
    row's rank 0, with every other rank of the row in `Follower.run`); stop
    the followers at its end, also on an error."""
    if mesh.tp.rank != 0:
        raise ValueError("only a row's rank 0 leads")
    leader = Leader(mesh.tp)
    mesh.tp.leader = leader
    try:
        yield leader
    finally:
        mesh.tp.leader = None
        leader.stop()


def _generators(states, device):
    gens = []
    for state in states:
        g = torch.Generator(device=device)
        g.set_state(state)
        gens.append(g)
    return gens


def generator_states(generator) -> list:
    """The host states of one generator or a list of them (an announcement
    carries them, so a follower draws what the leader draws)."""
    gens = [generator] if isinstance(generator, torch.Generator) else list(generator)
    return [g.get_state() for g in gens]


class Follower:
    """A rank > 0 of a row: makes the leader's LM calls on its own shard
    (`params`, a `ShardedTree`, and `cfg`, its shard's config), and replies
    after each."""

    def __init__(self, mesh: Mesh, params, cfg, device=None):
        if tp_of(params) is not mesh.tp:
            raise ValueError("a follower needs its row's shard (pipeline.shard_llm)")
        self.mesh = mesh
        self.params = params
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else mesh.device
        self.engines: dict = {}
        self.calls = 0
        self.pings = 0

    def _receive(self):
        box = [None]
        dist.broadcast_object_list(box, src=self.mesh.tp.ranks[0], group=self.mesh.tp.side)
        return box[0]

    def report(self) -> dict:
        """The calls made and the pings received."""
        return {"calls": self.calls, "pings": self.pings}

    def _make(self, msg):
        """Make one announced call; returns (result, state) to hash."""
        from sparktts_tpu_torch.lm.continuous import ContinuousBatchingEngine
        from sparktts_tpu_torch.lm.generate import generate

        kind = msg[0]
        if kind == "engine":
            _, eid, kwargs = msg
            self.engines[eid] = ContinuousBatchingEngine(
                self.params, self.cfg, mesh=self.mesh, device=self.device, **kwargs)
            return None, None
        if kind == "engine_call":
            _, eid, name, args, kwargs = msg
            engine = self.engines[eid]
            return getattr(engine, name)(*args, **kwargs), engine.slots
        if kind == "generate":
            kwargs = dict(msg[1])
            gens = _generators(kwargs.pop("generator_states"), self.device)
            kwargs["generator"] = gens[0] if kwargs.pop("one_generator") else gens
            for name in ("input_ids", "prompt_mask"):
                kwargs[name] = torch.from_numpy(kwargs[name]).to(self.device)
            return generate(self.params, self.cfg, **kwargs), None
        raise ValueError(f"follower: unknown call {kind!r}")

    @torch.inference_mode()
    def run(self) -> int:
        """Follow until the leader stops; returns the number of calls made.
        Raises `RowBroken` when the leader aborts the row."""
        tp = self.mesh.tp
        while True:
            msg = self._receive()
            kind = msg[0]
            if kind == "stop":
                return self.calls
            if kind == "ping":
                self.pings += 1
                continue
            if kind == "abort":
                raise RowBroken(msg[1], self.report())
            self.calls += 1
            before = tp.reduces
            try:
                reply = (True, outcome_hash(*self._make(msg)))
            except Exception as e:  # reported to the leader, which decides
                reply = (False, _describe(e))
            dist.gather_object((reply[0], tp.reduces - before, reply[1]), None,
                               dst=tp.ranks[0], group=tp.side)


def lead_generate(leader: Leader, fn: Callable, input_ids: torch.Tensor,
                  prompt_mask: torch.Tensor, generator, **kwargs):
    """One `generate` call `fn()` on a leading row: announced with host
    copies of its inputs and the generators' states, its ids checked."""
    msg = dict(kwargs, input_ids=input_ids.cpu().numpy(), prompt_mask=prompt_mask.cpu().numpy(),
               generator_states=generator_states(generator),
               one_generator=isinstance(generator, torch.Generator))
    msg.pop("units", None)
    return leader.run(("generate", msg), fn)


# ---------------------------------------------------------------------------
# starting the ranks
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_rank(rank: int, world_size: int, backend: str, address: str, fn: Callable,
             args: Sequence = (), device=None, timeout_s: float = DEFAULT_TIMEOUT_S,
             mesh_kwargs: Optional[dict] = None):
    """One rank: join the process group at `address` (tcp://host:port),
    build the mesh (`make_mesh(**mesh_kwargs)`), run `fn(mesh, *args)`,
    leave the group; returns fn's result.  `device`: the rank's device, or
    a function of the rank giving it, whatever the backend (default: the
    rank's card, `mesh.local_card`; pass "cpu" for the CPU)."""
    if callable(device):
        device = device(rank)
    device = local_card(rank) if device is None else torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=address, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        mesh = make_mesh(device=device, timeout_s=timeout_s, **(mesh_kwargs or {}))
        return fn(mesh, *args)
    finally:
        dist.destroy_process_group()


def _spawned(rank, world_size, backend, address, fn, args_path, device, timeout_s, mesh_kwargs,
             queue, threads):
    if threads:
        torch.set_num_threads(threads)
    with open(args_path, "rb") as f:
        args = pickle.load(f)
    out = run_rank(rank, world_size, backend, address, fn, args, device, timeout_s, mesh_kwargs)
    queue.put((rank, out))


def spawn(fn: Callable, world_size: int, backend: str = "nccl", args: Sequence = (),
          device=None, timeout_s: float = DEFAULT_TIMEOUT_S, mesh_kwargs: Optional[dict] = None,
          threads: Optional[int] = None) -> list:
    """Run `fn(mesh, *args)` on `world_size` ranks of this host, one
    process a rank (`fn` and its results must pickle); returns the results
    in rank order.  Each rank computes on its card (`device` as in
    `run_rank`; device="cpu" with backend="gloo" for the CPU).  If a rank
    fails, the others are terminated and this raises.  `threads`: torch's
    intra-op threads in each rank."""
    import torch.multiprocessing as mp

    address = f"tcp://127.0.0.1:{free_port()}"
    queue = mp.get_context("spawn").SimpleQueue()
    # `args` go through a file: a process's spawn arguments are written to
    # its pipe before the next process starts, and arguments larger than
    # the pipe's buffer wait there until the child has imported torch, so
    # the ranks would start one after another
    with tempfile.NamedTemporaryFile(suffix=".pkl", delete=False) as f:
        pickle.dump(tuple(args), f)
    try:
        ctx = mp.start_processes(
            _spawned, args=(world_size, backend, address, fn, f.name, device, timeout_s,
                            mesh_kwargs, queue, threads),
            nprocs=world_size, join=False, start_method="spawn")
        results = {}
        while True:
            while not queue.empty():
                rank, out = queue.get()
                results[rank] = out
            if ctx.join(timeout=0.05):
                break
        while not queue.empty():
            rank, out = queue.get()
            results[rank] = out
    finally:
        os.unlink(f.name)
    return [results[r] for r in range(world_size)]


def follow(pipe, mesh: Mesh, *args) -> dict:
    """The followers' side of `serve`: follow the leader with the
    pipeline's LM shard until it stops; returns the calls made and the
    pings received."""
    follower = Follower(mesh, pipe.llm_params, pipe.config.llm, pipe.device)
    follower.run()
    return follower.report()


def _serve_rank(mesh: Mesh, setup: Callable, main: Callable, follow_fn: Callable,
                args: Sequence):
    pipe = setup(mesh, *args)
    if mesh.tp.rank == 0:
        with lead(mesh):
            return main(pipe, mesh, *args)
    return follow_fn(pipe, mesh, *args)


def serve(setup: Callable, main: Callable, world_size: int, backend: str = "nccl",
          args: Sequence = (), follow: Callable = follow, device=None,
          timeout_s: float = DEFAULT_TIMEOUT_S, threads: Optional[int] = None) -> list:
    """`spawn` rows in leader/follower form: every rank runs
    `setup(mesh, *args)`, which returns its pipeline with the LM sharded
    (`pipeline.shard_llm(mesh)`); each row's rank 0 then runs `main(pipe,
    mesh, *args)` as the leader while the row's other ranks run
    `follow(pipe, mesh, *args)` (default: `worker.follow`).  Returns each
    rank's result in rank order."""
    return spawn(_serve_rank, world_size, backend, (setup, main, follow, tuple(args)), device,
                 timeout_s, None, threads)
