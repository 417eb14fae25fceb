"""The traffic of ``test_torch_sharded_store.py``, drawn with numpy only, so
that the JAX subprocess (8 faked host devices) and the port (8 shards on
the CPU) replay the same calls: ``ops`` lists ``("hist", users, items,
cats, masks)``, ``("events", users, items, cats)`` and ``("evict", user)``
in order, and ``apply`` runs them against a ``BSEServer`` of either
package. Item and category ids index the margin-screened behavior table of
``torch_runtime_parity.behaviors`` (N_ITEMS x N_CATS rows)."""
import numpy as np

N_ITEMS, N_CATS, D = 48, 8, 16
SHARDS = 8
ASK_MISS = "miss"


def random_ops(seed: int = 0):
    """Ingest / event / evict / re-ingest over 40 users in four rounds (the
    reference's ``test_sharded_store_parity_random_sequence``): histories of
    new users (an evicted one may come back), 8 events on live users
    (repeats allowed), 2 evictions. Returns (ops, the live users sorted)."""
    rng = np.random.default_rng(seed)
    live, ops = set(), []
    for _ in range(4):
        users = [int(u) for u in rng.choice(40, size=6, replace=False) if u not in live]
        if users:
            n = len(users)
            ops.append(("hist", users, rng.integers(0, N_ITEMS, (n, 9)),
                        rng.integers(0, N_CATS, (n, 9)),
                        (rng.uniform(size=(n, 9)) > 0.3).astype(np.float32)))
            live.update(users)
        ev_u = [int(u) for u in rng.choice(sorted(live), size=8)]
        ops.append(("events", ev_u, rng.integers(0, N_ITEMS, 8), rng.integers(0, N_CATS, 8)))
        for u in [int(u) for u in rng.choice(sorted(live), size=2, replace=False)]:
            ops.append(("evict", u))
            live.discard(u)
    return ops, sorted(live)


def tiered_ops(seed: int = 0):
    """24 users in bursts of 8 through a hot tier of 8 and a warm tier of 8
    (the reference's ``test_sharded_tiered_parity_and_restore``), 4 events,
    and the order the users are read back in."""
    rng = np.random.default_rng(seed)
    ops = [("hist", list(range(lo, lo + 8)), rng.integers(0, N_ITEMS, (8, 9)),
            rng.integers(0, N_CATS, (8, 9)), None) for lo in range(0, 24, 8)]
    ops.append(("events", [0, 5, 23, 0], rng.integers(0, N_ITEMS, 4),
                rng.integers(0, N_CATS, 4)))
    return ops, [int(u) for u in rng.permutation(24)]


def candidates(seed: int, shape):
    """(items, cats) of candidates: rows of the screened behavior table."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, N_ITEMS, shape), rng.integers(0, N_CATS, shape)


def apply(server, ops) -> None:
    for op in ops:
        if op[0] == "hist":
            server.ingest_histories(*op[1:])
        elif op[0] == "events":
            server.ingest_events(*op[1:])
        else:
            assert server.evict(op[1])
