"""Library / profiler / schedule tests (model: reference test_library.cpp,
test_schedule.cpp)."""

import time

import pytest

from spla_tpu.library import get_library, log_msg, set_message_callback
from spla_tpu.profiling import profiler, time_profile_scope
from spla_tpu.schedule import Schedule, ScheduleTask, make_sched_task_callback


def test_library_info():
    lib = get_library()
    info = lib.get_accelerator_info()
    assert isinstance(info, str) and len(info) > 0


def test_force_no_acceleration():
    lib = get_library()
    lib.set_force_no_acceleration(True)
    assert not lib.is_accelerated()


@pytest.mark.parametrize("platform, forced_off, want", [
    ("gpu", False, True),
    ("gpu", True, False),
    ("cpu", False, False),
])
def test_is_accelerated_names_the_gpu(monkeypatch, platform, forced_off, want):
    """The one device decision: a GPU is accelerated unless forced off."""
    from types import SimpleNamespace

    import jax

    from spla_tpu.library import Library

    monkeypatch.setattr(jax, "devices",
                        lambda *a: [SimpleNamespace(platform=platform)])
    lib = Library()
    lib.force_no_acceleration = forced_off
    assert lib.is_accelerated() is want


def test_message_callback():
    got = []
    set_message_callback(lambda *a: got.append(a))
    log_msg("Ok", "hello", "f.py", "fn", 1)
    assert got and got[0][1] == "hello"
    set_message_callback(None)


def test_profiler_disabled_by_default():
    # profiled dispatch blocks on device results; must be opt-in
    import spla_tpu.profiling as P

    assert P.TimeProfiler().enabled is False


def test_profiler_scopes():
    profiler.reset()
    profiler.enabled = True
    with time_profile_scope("outer"):
        with time_profile_scope("outer/inner"):
            time.sleep(0.01)
    s = profiler.stats()
    assert "outer" in s and "outer/inner" in s
    assert s["outer/inner"]["parent"] == "outer"
    assert s["outer"]["ms"] >= 10
    dump = profiler.dump()
    assert "outer" in dump
    profiler.reset()
    profiler.enabled = False
    assert not profiler.stats()


def test_schedule_callback():
    # reference test_schedule.cpp:32-39 — callback task through Schedule
    hits = []
    s = Schedule()
    step = s.add_step(make_sched_task_callback(lambda: hits.append("a")))
    s.add_task(step, make_sched_task_callback(lambda: hits.append("b")))
    s.add_step(make_sched_task_callback(lambda: hits.append("c")))
    s.submit()
    assert hits == ["a", "b", "c"]


def test_profiler_scopes_facade_ops():
    from spla_tpu import INT, get_library
    from spla_tpu.facade import Matrix, Vector
    from spla_tpu.profiling import profiler

    profiler.reset()
    get_library().set_time_profiling(True)
    try:
        A = Matrix.from_lists([0, 1, 2], [1, 2, 0], [1, 2, 3], shape=(3, 3), dtype=INT)
        A.mxm(A, INT.MULT, INT.PLUS)
        v = Vector.from_lists([0, 2], [5, 7], (3,), INT)
        v.reduce(INT.PLUS)
        stats = profiler.stats()
        assert "matrix_mxm" in stats and stats["matrix_mxm"]["count"] == 1
        assert "vector_reduce" in stats
        dump = get_library().time_profile_dump()
        assert "matrix_mxm" in dump
    finally:
        get_library().set_time_profiling(False)
    profiler.reset()
    assert profiler.stats() == {}
