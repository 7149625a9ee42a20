"""Synthetic kernel inputs for parity checks of the packed scan, and the
warm-tick cluster.

``example_arrays`` is a copy of the reference repository's
``__graft_entry__._example_arrays`` (numpy only, seeded); ``example_case``
turns its output into one of the named arena cases the tests and
``chip_smoke.py`` hold the kernels to. Every case takes the base builder
as an argument, so a test can feed the reference's own builder and check
that both packages see the same arrays. ``warm_cluster`` is a copy of the
reference's ``bench.build_warm_cluster``: the steady-state cluster the
incremental solve is measured on.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

#: the named arena cases: each exercises one read path of the scan
CASES = ("base", "existing", "min_values", "pool_limits", "daemon",
         "two_pools", "priority", "slots_run_out", "zero_r_column")


def example_arrays(n_groups=8, n_types=48, n_max=64, E=0, P=1, Z=4, C=3,
                   D=4, K=0, V=0):
    """All-numpy kernel inputs. K>0 adds minValues floors: K floored keys
    over V distinct values, membership as (type, value-id) pairs."""
    rng = np.random.RandomState(0)
    arrays = dict(
        A=rng.randint(1, 1 << 20, size=(n_types, D)).astype(np.int64),
        avail_zc=rng.rand(n_types, Z * C) < 0.8,
        R=rng.randint(1, 1 << 10, size=(n_groups, D)).astype(np.int64),
        n=rng.randint(1, 50, size=(n_groups,)).astype(np.int64),
        F=rng.rand(n_groups, n_types) < 0.7,
        agz=np.ones((n_groups, Z), bool),
        agc=np.ones((n_groups, C), bool),
        admit=np.ones((n_groups, P), bool),
        daemon=np.zeros((n_groups, P, D), np.int64),
        pool_types=np.ones((P, n_types), bool),
        pool_agz=np.ones((P, Z), bool),
        pool_agc=np.ones((P, C), bool),
        pool_limit=np.full((P, D), -1, np.int64),
        pool_used0=np.zeros((P, D), np.int64),
        ex_alloc=np.zeros((E, D), np.int64),
        ex_used0=np.zeros((E, D), np.int64),
        ex_compat=np.zeros((n_groups, E), bool),
    )
    statics = dict(n_max=n_max, E=E, P=P)
    if K:
        M = n_types  # one membership pair per (key, type)
        arrays.update(
            mv_floor=rng.randint(1, 4, size=(P, K)).astype(np.int64),
            mv_pairs_t=np.tile(np.arange(n_types, dtype=np.int64), (K, 1)),
            mv_pairs_v=rng.randint(0, V, size=(K, M)).astype(np.int64),
        )
        statics["V"] = V
    return arrays, statics


def example_case(name: str, base: Callable = example_arrays, G: int = 8,
                 T: int = 24, n_max: int = 16, Z: int = 3, C: int = 2,
                 D: int = 4, seed: int = 1) -> Tuple[Dict, Dict]:
    """(arrays, statics) of one named case; statics hold every packing
    and solve static (T, D, Z, C, G, E, P, K, M, V, Q, n_max)."""
    if name not in CASES:
        raise ValueError(f"unknown case {name!r}; one of {CASES}")
    rng = np.random.RandomState(seed)
    kw = dict(n_groups=G, n_types=T, n_max=n_max, Z=Z, C=C, D=D)
    if name == "existing":
        kw["E"] = 5
    elif name == "min_values":
        kw.update(K=2, V=6)
    elif name == "two_pools":
        kw["P"] = 2
    elif name == "slots_run_out":
        kw["n_max"] = 1
    arrays, st = base(**kw)
    E, P = st["E"], st["P"]
    Q = 0
    if name == "existing":
        arrays["ex_alloc"] = rng.randint(1, 1 << 20, size=(E, D)).astype(
            np.int64)
        arrays["ex_used0"] = rng.randint(0, 1 << 18, size=(E, D)).astype(
            np.int64)
        arrays["ex_compat"] = rng.rand(G, E) < 0.5
    elif name == "pool_limits":
        # room for a few nodes' worth of pods in two dims, unlimited in
        # the others: the prefix caps and the new-node budget both bind
        lim = np.full((P, D), -1, np.int64)
        lim[0, 0] = int(arrays["R"][:, 0].sum() * 6)
        lim[0, 2] = int(arrays["R"][:, 2].sum() * 9)
        arrays["pool_limit"] = lim
        arrays["pool_used0"] = rng.randint(0, 1 << 8, size=(P, D)).astype(
            np.int64)
    elif name == "daemon":
        arrays["daemon"] = rng.randint(0, 1 << 16, size=(G, P, D)).astype(
            np.int64)
    elif name == "two_pools":
        # disjoint types, zones and capacity types per pool; groups admit
        # one pool, the other or both
        pt = np.zeros((P, T), bool)
        pt[0, : T // 2], pt[1, T // 2:] = True, True
        pz = np.zeros((P, Z), bool)
        pz[0, :1], pz[1, 1:] = True, True
        pc = np.zeros((P, C), bool)
        pc[0, 0], pc[1, 1:] = True, True
        arrays.update(pool_types=pt, pool_agz=pz, pool_agc=pc,
                      admit=np.stack([np.arange(G) % 3 != 1,
                                      np.arange(G) % 3 != 0], axis=1),
                      daemon=rng.randint(0, 1 << 12, size=(G, P, D)).astype(
                          np.int64))
    elif name == "priority":
        Q = 1
        arrays["prio"] = np.sort(rng.randint(0, 3, size=G))[::-1].astype(
            np.int64)
    elif name == "zero_r_column":
        arrays["R"][:, 1] = 0
    K = arrays["mv_floor"].shape[1] if "mv_floor" in arrays else 0
    M = arrays["mv_pairs_t"].shape[1] if K else 0
    statics = dict(T=T, D=D, Z=Z, C=C, G=G, E=E, P=P, K=K, M=M,
                   V=st.get("V", 0), Q=Q, n_max=st["n_max"])
    return arrays, statics


def pack_statics(statics: dict) -> tuple:
    """Positional statics of ``hostpack.pack_inputs1`` (F=1)."""
    s = statics
    return (s["T"], s["D"], s["Z"], s["C"], s["G"], s["E"], s["P"], s["K"],
            s["M"], 1, s["Q"])


def solve_statics(statics: dict) -> dict:
    """Keyword statics of ``solve_scan_packed1``."""
    return {k: statics[k] for k in ("T", "D", "Z", "C", "G", "E", "P",
                                    "n_max", "K", "V", "M", "Q")}


def warm_cluster(pods: int = 50_000, pending_frac: float = 0.01,
                 seed: int = 23):
    """The steady-state cluster of the warm provisioning tick: a copy of
    the reference repository's ``bench.build_warm_cluster`` on this
    package's classes, giving the same pod names, nodes and churn for the
    same seed. All but ``pending_frac`` of the ``pods`` are BOUND — they
    exist only as existing-node ``used`` — and the pending slice churns
    tick to tick on a STABLE signature set (20 base deployments and 5
    "hot" ones that sort last in canonical order, so the dirty frontier
    stays deep), under one family-pinned pool (the ``m5.*`` types).

    Returns ``(snapshot, tick)``: ``snapshot()`` builds the current
    snapshot (fresh ExistingNode objects every call); ``tick(churned=None,
    binds=False)`` cycles pending pods within the hot deployments, moves
    one pod between two hot deployments and, with ``binds``, lands four
    binds on node ``used``. Resets the pod-name counter."""
    import random

    from .apis import labels as L
    from .apis.resources import Resources
    from .fake.environment import Environment, make_pods, reset_pod_counter
    from .solver.types import ExistingNode, NodePoolSpec

    reset_pod_counter()
    env = Environment()
    np_obj, nc = env.nodepool("bench-warm")
    spec = NodePoolSpec(
        nodepool=np_obj,
        instance_types=[it for it in env.instance_types.list(nc)
                        if it.name.startswith("m5.")])
    zones = ["us-west-2a", "us-west-2b", "us-west-2c"]
    rng = random.Random(seed)

    n_pending = max(25, int(pods * pending_frac))
    n_bound = pods - n_pending
    # m5.16xlarge nodes, CPU-bound at ~480 of these 120m pods per node
    per_node = 480
    E = max(1, (n_bound + per_node - 1) // per_node)

    sigs = []
    for i in range(20):
        sel = {L.CAPACITY_TYPE: "spot"} if i % 8 == 7 else None
        sigs.append(dict(cpu=f"{150 + (i * 37) % 500}m",
                         memory=f"{256 + (i * 61) % 900}Mi",
                         group=f"warm{i:02d}", node_selector=sel))
    for i in range(5):
        # hot cpu requests sit below every base request: they sort last
        sigs.append(dict(cpu=f"{100 + i * 5}m",
                         memory=f"{200 + i * 17}Mi",
                         group=f"warmhot{i:02d}", node_selector=None))
    hot = list(range(20, 25))
    serial = [0]

    def mk(n, gi):
        kw = dict(sigs[gi % len(sigs)])
        g = kw.pop("group")
        serial[0] += 1
        return make_pods(n, prefix=f"{g}-r{serial[0]}", group=g, **kw)

    #: pending as (signature index, pod), so churn replaces a pod with a
    #: same-signature successor and no group ever empties
    pend = []
    for gi in range(len(sigs)):
        pend.extend((gi, p) for p in mk(n_pending // len(sigs) or 1, gi))

    alloc = Resources.parse(
        {"cpu": "63770m", "memory": "241591Mi", "pods": "737"})
    used = []
    for i in range(E):
        n_on = min(per_node, n_bound - i * per_node)
        used.append(Resources.parse(
            {"cpu": f"{n_on * 120}m", "memory": f"{n_on * 420}Mi",
             "pods": str(n_on)}))

    counts = [0] * len(sigs)
    for gi, _ in pend:
        counts[gi] += 1

    def snapshot():
        snap = env.snapshot([p for _, p in pend], [(np_obj, nc)])
        snap.nodepools = [spec]
        snap.existing_nodes = [
            ExistingNode(
                name=f"warm-node-{i:04d}",
                labels={L.ZONE: zones[i % 3], L.ARCH: "amd64",
                        L.CAPACITY_TYPE: "on-demand",
                        L.INSTANCE_TYPE: "m5.16xlarge",
                        L.INSTANCE_FAMILY: "m5"},
                allocatable=alloc, used=used[i])
            for i in range(E)]
        return snap

    bump = Resources.parse({"cpu": "120m", "memory": "420Mi"})

    def tick(churned=None, binds=False):
        k = churned if churned is not None else max(1, n_pending // 5)
        hot_slots = [j for j, (gi, _) in enumerate(pend) if gi in hot]
        for _ in range(k):
            j = hot_slots[rng.randrange(len(hot_slots))]
            gi, _ = pend[j]
            pend[j] = (gi, mk(1, gi)[0])
        # one hot deployment scales down a pod, another scales up
        donor = max(hot, key=lambda g: counts[g])
        recip = min(hot, key=lambda g: counts[g])
        if donor != recip and counts[donor] > 1:
            for j, (gi, _) in enumerate(pend):
                if gi == donor:
                    pend.pop(j)
                    break
            pend.append((recip, mk(1, recip)[0]))
            counts[donor] -= 1
            counts[recip] += 1
        # binds move node used: ex_used goes dirty and the bank with it
        if binds:
            for _ in range(4):
                i = rng.randrange(E)
                used[i] = used[i] + bump
        return k

    return snapshot, tick
