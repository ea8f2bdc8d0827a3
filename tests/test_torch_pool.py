"""The port's router connection pool (``kdtree_tpu_torch/serve/pool.py``)
held to the reference's pool contract (``tests/test_pool.py``'s cases,
with stub sockets): a connection returns to the idle list only after a
clean, fully drained exchange, every other disposal is a counted
discard, and the hedge winner's abort mark is sticky.
The end-to-end reuse through a live router is in
``tests/test_torch_router.py``."""

import time

import pytest

from kdtree_tpu_torch import obs
from kdtree_tpu_torch.serve import pool as pool_mod


@pytest.fixture(autouse=True)
def _fresh_registry():
    obs.get_registry().reset()
    yield
    obs.get_registry().reset()


class _StubSock:
    def __init__(self):
        self.timeouts = []
        self.closed = False

    def settimeout(self, t):
        self.timeouts.append(t)

    def close(self):
        self.closed = True


def _connected(host="127.0.0.1", port=9, timeout_s=1.0):
    """A PooledConn that looks post-exchange: socket present, as if
    request()/getresponse()/read() just completed."""
    pc = pool_mod.PooledConn(host, port, timeout_s)
    pc.conn.sock = _StubSock()
    return pc


def _counter(key):
    return obs.get_registry().snapshot()["counters"].get(key, 0.0)


def _discards(reason):
    return _counter(
        f'kdtree_router_pool_discards_total{{reason="{reason}"}}')


def test_lease_miss_opens_fresh_and_counts():
    pool = pool_mod.ConnectionPool()
    pc = pool.lease("127.0.0.1", 9, 1.5)
    assert not pc.reused and not pc.dead
    assert pc.conn.timeout == 1.5
    assert _counter("kdtree_router_pool_misses_total") == 1
    assert _counter("kdtree_router_pool_hits_total") == 0


def test_release_then_lease_hits_and_reapplies_timeout():
    pool = pool_mod.ConnectionPool()
    pc = _connected()
    pool.release(pc, drained=True)
    assert pool.idle_count() == 1
    got = pool.lease("127.0.0.1", 9, 0.25)
    assert got is pc and got.reused
    # the per-attempt timeout lands on the live socket, not just the
    # conn object — timeouts are a property of the attempt
    assert got.conn.timeout == 0.25
    assert got.conn.sock.timeouts[-1] == 0.25
    assert _counter("kdtree_router_pool_hits_total") == 1
    assert pool.idle_count() == 0


def test_lease_is_lifo_most_recent_first():
    pool = pool_mod.ConnectionPool()
    a, b = _connected(), _connected()
    pool.release(a)
    pool.release(b)
    assert pool.lease("127.0.0.1", 9, 1.0) is b
    assert pool.lease("127.0.0.1", 9, 1.0) is a


def test_undrained_release_is_discarded_never_pooled():
    pool = pool_mod.ConnectionPool()
    pc = _connected()
    pool.release(pc, drained=False)
    assert pool.idle_count() == 0
    assert pc.dead
    assert _discards("undrained") == 1


def test_aborted_release_is_discarded():
    pool = pool_mod.ConnectionPool()
    pc = _connected()
    pc.close()  # the hedge winner's loser-sweep
    pool.release(pc, drained=True)
    assert pool.idle_count() == 0
    assert _discards("abort") == 1


def test_sticky_abort_after_release_discards_at_next_lease():
    """The race the sticky mark exists for: the loser released its
    connection back to the pool an instant before the winner's close
    sweep reached it. The next lease must inspect the flag and discard
    instead of reusing a closed socket."""
    pool = pool_mod.ConnectionPool()
    pc = _connected()
    pool.release(pc, drained=True)
    pc.close()  # post-release abort
    got = pool.lease("127.0.0.1", 9, 1.0)
    assert got is not pc and not got.reused
    assert _discards("abort") == 1
    assert _counter("kdtree_router_pool_misses_total") == 1


def test_stale_idle_connection_not_reused():
    pool = pool_mod.ConnectionPool(idle_reuse_s=0.05)
    pc = _connected()
    pool.release(pc, drained=True)
    time.sleep(0.08)
    got = pool.lease("127.0.0.1", 9, 1.0)
    assert got is not pc and not got.reused
    assert _discards("stale") == 1


def test_max_idle_bounds_the_bucket():
    pool = pool_mod.ConnectionPool(max_idle=2)
    for _ in range(3):
        pool.release(_connected(), drained=True)
    assert pool.idle_count() == 2
    assert _discards("full") == 1


def test_buckets_are_per_host_port():
    pool = pool_mod.ConnectionPool()
    a = _connected(port=9)
    b = _connected(port=10)
    pool.release(a)
    pool.release(b)
    assert pool.lease("127.0.0.1", 10, 1.0) is b
    # no cross-bucket theft: port 9's bucket still holds a
    assert pool.lease("127.0.0.1", 9, 1.0) is a


def test_skips_stale_head_picks_fresh_candidate():
    """One stale entry must not turn the whole bucket into a miss: the
    lease walks past it (counting the discard) to a fresh sibling."""
    pool = pool_mod.ConnectionPool()
    fresh_pc = _connected()
    dead_pc = _connected()
    pool.release(fresh_pc)
    pool.release(dead_pc)  # LIFO head
    dead_pc.close()
    got = pool.lease("127.0.0.1", 9, 1.0)
    assert got is fresh_pc and got.reused
    assert _discards("abort") == 1


def test_close_all_drains_and_later_release_discards():
    pool = pool_mod.ConnectionPool()
    parked = _connected()
    pool.release(parked)
    in_flight = _connected()
    pool.close_all()
    assert pool.idle_count() == 0 and parked.dead
    pool.release(in_flight, drained=True)
    assert pool.idle_count() == 0
    assert _discards("shutdown") == 1
    # leases still work post-shutdown (always a fresh miss): a racing
    # request during stop() degrades, never crashes
    assert not pool.lease("127.0.0.1", 9, 1.0).reused


def test_discard_reason_is_bounded_enum():
    pool = pool_mod.ConnectionPool()
    pool.discard(_connected(), "not-a-reason")
    assert _discards("error") == 1
    snap = obs.get_registry().snapshot()["counters"]
    reasons = {
        key.split('reason="', 1)[1].rstrip('"}')
        for key in snap if key.startswith(
            "kdtree_router_pool_discards_total")
    }
    assert reasons <= set(pool_mod.DISCARD_REASONS)


def test_bad_max_idle_rejected():
    with pytest.raises(ValueError):
        pool_mod.ConnectionPool(max_idle=-1)
