"""The port's ``tracing.py`` against the JAX package's, on the CPU: the
same event sequence gives the same tally and step-tagged records, the
ring keeps the newest 4096 records, ``percentile`` and
``get_trace_stats`` agree on the same recorded times, ``@trace`` records
each call under the function's name, and ``bench.py``'s percentiles are
``tracing.percentile``'s."""
from __future__ import annotations

import logging
import threading

import pytest

from kfac_pytorch_tpu_torch import tracing

pytestmark = pytest.mark.torch_port

EVENTS = [('consistency_mismatch', 1, None), ('consistency_repair', 1, 4),
          ('consistency_mismatch', 2, 7), ('checkpoint_fallback', 1, None),
          ('consistency_quarantine', 3, 9)]


@pytest.fixture(autouse=True)
def clean():
    from kfac_pytorch_tpu import tracing as jt

    tracing.clear_trace()
    jt.clear_trace()
    yield
    tracing.clear_trace()
    jt.clear_trace()


def test_event_tally_and_step_records_match_jax():
    from kfac_pytorch_tpu import tracing as jt

    for name, n, step in EVENTS:
        tracing.count_event(name, n=n, step=step)
        jt.count_event(name, n=n, step=step)
    tracing.record_event('drill', 11)
    jt.record_event('drill', 11)
    assert tracing.get_events() == jt.get_events()
    assert tracing.get_step_events() == jt.get_step_events()
    assert tracing.get_step_events(since_step=7) == jt.get_step_events(
        since_step=7)
    assert tracing.get_events()['consistency_mismatch'] == 3
    tracing.clear_trace()
    assert tracing.get_events() == {} and tracing.get_step_events() == []


def test_step_ring_is_bounded_and_counts_stay_exact():
    from kfac_pytorch_tpu import tracing as jt

    n = tracing._STEP_EVENT_LIMIT + 10
    assert n - 10 == jt._STEP_EVENT_LIMIT
    for i in range(n):
        tracing.count_event('e', step=i)
        jt.count_event('e', step=i)
    got = tracing.get_step_events()
    assert got == jt.get_step_events()
    assert len(got) == tracing._STEP_EVENT_LIMIT
    assert got[0]['step'] == 10 and got[-1]['step'] == n - 1
    assert tracing.get_events() == {'e': n}


def test_count_event_is_thread_safe():
    def work():
        for _ in range(2000):
            tracing.count_event('t')
    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert tracing.get_events() == {'t': 8000}


@pytest.mark.parametrize('q', [0.0, 0.25, 0.5, 0.95, 1.0])
def test_percentile_matches_jax(q):
    from kfac_pytorch_tpu import tracing as jt

    for sample in ([3.0], [1.0, 2.0], [0.5, 0.1, 7.0, 2.0, 2.0, 9.5]):
        ordered = sorted(sample)
        assert tracing.percentile(ordered, q) == jt.percentile(ordered, q)


def test_percentile_errors_match_jax():
    from kfac_pytorch_tpu import tracing as jt

    for args in (([], 0.5), ([1.0], 1.5)):
        with pytest.raises(ValueError) as want:
            jt.percentile(*args)
        with pytest.raises(ValueError) as got:
            tracing.percentile(*args)
        assert str(got.value) == str(want.value)


def test_trace_stats_match_jax_on_the_same_times():
    from kfac_pytorch_tpu import tracing as jt

    times = {'refresh': [0.5, 0.1, 0.3, 0.9], 'step': [0.01] * 3,
             'empty': []}
    for store in (tracing._func_traces, jt._func_traces):
        for name, ts in times.items():
            store[name] = list(ts)
    assert tracing.get_trace() == jt.get_trace()
    assert tracing.get_trace(average=False, max_history=2) == jt.get_trace(
        average=False, max_history=2)
    assert tracing.get_trace_stats() == jt.get_trace_stats()
    assert tracing.get_trace_stats(max_history=3) == jt.get_trace_stats(
        max_history=3)
    assert 'empty' not in tracing.get_trace()


@pytest.mark.parametrize('sync', [False, True])
def test_trace_decorator_records_each_call(sync):
    @tracing.trace(sync=sync)
    def work(x, y=1):
        return x + y

    assert work.__name__ == 'work'
    assert [work(1), work(2, y=3)] == [2, 5]
    stats = tracing.get_trace_stats()['work']
    assert stats['count'] == 2.0
    assert 0.0 <= stats['p50'] <= stats['max']


def test_log_helpers(caplog):
    tracing.count_event('consistency_repair', n=2)

    @tracing.trace()
    def f():
        return None
    f()
    with caplog.at_level(logging.INFO, logger=tracing.__name__):
        tracing.log_events()
        tracing.log_trace()
    text = caplog.text
    assert 'consistency_repair: 2' in text and 'f: ' in text


def test_bench_percentiles_are_tracing_percentile():
    from kfac_pytorch_tpu_torch import bench

    sample = [0.3, 0.1, 0.9, 0.4]
    ordered = sorted(sample)
    for q in (0.5, 0.95):
        assert bench.percentile(ordered, q) == tracing.percentile(ordered, q)
