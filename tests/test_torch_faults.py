"""Repairs of the port's faults, held on the CPU: the per-stream arrival
counters of the kernels that merge across blocks (`kernels/arrivals.py`), and
the codec's precision scope `nn/layers.codec_fp32` (which replaced a
process-wide TF32-flag bookkeeping) under threads that overlap.  The launch guard (every
wrapper launches on its tensor's card) is in `test_torch_guards.py`; the card
tests of both are in `test_torch_cuda_kernels.py`."""

import gc
import sys
import threading
import weakref

import pytest
import torch

from sparktts_tpu_torch.kernels import arrivals
from sparktts_tpu_torch.nn.layers import codec_fp32, in_codec_scope


def test_arrival_registry_gives_each_stream_its_own_zeroed_counters():
    reg = arrivals.ArrivalRegistry(minimum=8)
    a = reg.counters(("card 0", 11), "cpu", 4, capturing=False)
    assert a.dtype == torch.int32 and a.numel() == 8 and not a.any()
    assert reg.counters(("card 0", 11), "cpu", 8, capturing=False) is a  # same stream, same array
    b = reg.counters(("card 0", 12), "cpu", 4, capturing=False)  # another stream of the card
    c = reg.counters(("card 1", 11), "cpu", 4, capturing=False)  # the same handle on another card
    assert len({a.data_ptr(), b.data_ptr(), c.data_ptr()}) == 3
    assert sorted(reg.keys()) == [("card 0", 11), ("card 0", 12), ("card 1", 11)]


def test_arrival_registry_grows_only_outside_capture():
    reg = arrivals.ArrivalRegistry(minimum=8)
    a = reg.counters(("card 0", 11), "cpu", 4, capturing=False)
    assert reg.counters(("card 0", 11), "cpu", 8, capturing=True) is a  # made before capture
    with pytest.raises(RuntimeError, match="capture"):
        reg.counters(("card 0", 12), "cpu", 4, capturing=True)  # first use inside a capture
    with pytest.raises(RuntimeError, match="capture"):
        reg.counters(("card 0", 11), "cpu", 9, capturing=True)  # too short, cannot grow
    assert reg.keys() == [("card 0", 11)]
    grown = reg.counters(("card 0", 11), "cpu", 20, capturing=False)
    assert grown.numel() == 20 and not grown.any()
    assert reg.counters(("card 0", 11), "cpu", 20, capturing=True) is grown


def test_arrival_registry_keeps_an_outgrown_array_alive():
    """A graph captured before the growth still counts on the old array at
    every replay, so the registry must not free it."""
    reg = arrivals.ArrivalRegistry(minimum=8)
    old = reg.counters(("card 0", 11), "cpu", 8, capturing=False)
    old_ref, old_ptr = weakref.ref(old), old.data_ptr()
    del old
    grown = reg.counters(("card 0", 11), "cpu", 40, capturing=False)
    gc.collect()
    assert grown.numel() == 40 and grown.data_ptr() != old_ptr
    assert old_ref() is not None and old_ref().data_ptr() == old_ptr
    assert reg.counters(("card 0", 11), "cpu", 40, capturing=False) is grown


def test_arrival_registry_threads_asking_at_once_share_one_array():
    """16 threads (more than the cores here), switching often, ask for one
    stream's counters at once: one array is made, and all get it."""
    reg = arrivals.ArrivalRegistry(minimum=8)
    got, start = [], threading.Barrier(16)

    def ask():
        start.wait(30)
        got.append(reg.counters(("card 0", 11), "cpu", 8, capturing=False))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 16 and all(x is got[0] for x in got)


@pytest.fixture
def tf32_flags():
    """PyTorch's default TF32 flags for the test; the caller's back after it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32, matmul.allow_tf32 = True, False
    yield lambda: (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32, matmul.allow_tf32 = saved


def test_full_fp32_overlapping_threads_restore_once_and_keep_a_flag_set_meanwhile(tf32_flags):
    """Thread A enters the codec scope, B enters, C sets the matmul flag, A
    leaves, B leaves.  The scope is each thread's own and assigns no TF32
    flag: C is outside it all along, A and B inside theirs until each leaves,
    and the flags are what C left them at every point."""
    a_in, b_in, c_done, a_out = (threading.Event() for _ in range(4))
    seen = {}

    def thread_a():
        with codec_fp32():
            seen["a inside"] = (in_codec_scope(), tf32_flags())
            a_in.set()
            b_in.wait(30)
            c_done.wait(30)
        seen["a after"] = in_codec_scope()
        a_out.set()

    def thread_b():
        a_in.wait(30)
        with codec_fp32():
            b_in.set()
            a_out.wait(30)
            seen["b after a left"] = (in_codec_scope(), tf32_flags())
        seen["b after"] = in_codec_scope()

    def thread_c():
        b_in.wait(30)
        seen["c"] = in_codec_scope()
        torch.backends.cuda.matmul.allow_tf32 = True
        c_done.set()

    threads = [threading.Thread(target=f) for f in (thread_a, thread_b, thread_c)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert seen["a inside"] == (True, (True, False))  # the caller's flags, untouched
    assert seen["c"] is False  # two scopes open in other threads
    assert seen["b after a left"] == (True, (True, True))  # C's flag in force
    assert seen["a after"] is False and seen["b after"] is False
    assert tf32_flags() == (True, True) and not in_codec_scope()


def test_full_fp32_nested_and_raising_blocks_restore_at_the_outermost_exit(tf32_flags):
    """Nested scopes (a decorated codec call inside a block) and a raising
    block: each exit closes its own scope, the outermost one closes it all,
    and no flag moves at any point."""
    @codec_fp32()
    def codec_call():
        return in_codec_scope(), tf32_flags()

    with pytest.raises(ValueError):
        with codec_fp32():
            assert codec_call() == (True, (True, False))
            assert in_codec_scope()  # the inner exit closed the inner scope only
            raise ValueError("a codec error")
    assert not in_codec_scope()
    assert tf32_flags() == (True, False)
