"""Synthetic kernel inputs for parity checks of the packed scan, the
warm-tick cluster, and consolidation's config 4 with its decision walks.

``example_arrays`` is a copy of the reference repository's
``__graft_entry__._example_arrays`` (numpy only, seeded); ``example_case``
turns its output into one of the named arena cases the tests and
``chip_smoke.py`` hold the kernels to. Every case takes the base builder
as an argument, so a test can feed the reference's own builder and check
that both packages see the same arrays. ``warm_cluster`` is a copy of the
reference's ``bench.build_warm_cluster``: the steady-state cluster the
incremental solve is measured on. ``config4`` is a copy of the
reference's ``bench.build_config4``, and ``deletion_snapshot``,
``replacement_snapshot``, ``single_consolidation_device``,
``single_consolidation_batched`` and ``multi_consolidation`` copy the
disruption controller's consolidation walks (the reference's
``controllers/disruption.py`` ``_single_consolidation`` and
``_multi_consolidation``, as ``bench.py`` drives them) over a base
snapshot and a candidate list, without budgets. ``preempt_case`` makes
the preemption kernel's (K8) hazard tables, and ``preempt_cluster`` a
running cluster, in either package's objects, whose next provisioning
round must preempt. ``fused_case`` makes the fused block scan's (K5)
arena cases, and ``striped_cluster`` its 50,000-pod cell.
``dist_ticks_rank`` is the multi-process mesh's (K11) rank body over the
reference's multi-host shapes (``DIST_SMOKE_SHAPE``,
``DIST_CEILING_SHAPE``).
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


# ---------------------------------------------------------------------------
# synthetic fused-scan (K5) inputs
# ---------------------------------------------------------------------------

#: the fusion width of the fused cases (hostpack.DEV_FUSE)
FUSE = 4

#: the fused scan's parity cases: every K == 0 arena case, whose fuse
#: flags alternate a vectorized block with a sequential one (the flags
#: are data: a vectorized block of groups that contend still follows the
#: reference's merge formula, which the byte tests hold), and "striped",
#: four pools with disjoint types whose groups admit one each, with
#: existing nodes, and whose flags are the solver's plan (admit runs
#: ANDed with existing-compat runs)
FUSED_CASES = tuple(c for c in CASES if c != "min_values") + (
    "striped", "wrap_n_rem")


def fused_case(name: str, base: Callable = example_arrays, G: int = 8,
               **kw) -> Tuple[Dict, Dict]:
    """(arrays, statics) of one fused case (``FUSED_CASES``): the arena
    case's arrays plus the [G] ``fuse`` flags, statics with F = FUSE."""
    if name not in FUSED_CASES:
        raise ValueError(f"unknown fused case {name!r}; one of "
                         f"{FUSED_CASES}")
    if name != "striped":
        if name == "wrap_n_rem":   # the pruned case with fuse flags
            arrays, st = pruned_case(name, base=base, G=max(G, 16), **kw)
            G = st["G"]
        else:
            arrays, st = example_case(name, base=base, G=G, **kw)
        rng = np.random.RandomState(7)
        fuse = np.ones(G, bool)
        fuse[0::FUSE] = rng.rand(G // FUSE) < 0.5   # never read
        fuse[FUSE + 2::2 * FUSE] = False            # odd blocks: sequential
        arrays["fuse"] = fuse
        return arrays, dict(st, F=FUSE)
    from .models.encoding import independent_runs
    G = max(G, 16)
    arrays, st = example_case("existing", base=base, G=G, **kw)
    T, E = arrays["A"].shape[0], st["E"]
    P = 4
    Z, C = arrays["agz"].shape[1], arrays["agc"].shape[1]
    # pool p owns types [p*T/P, (p+1)*T/P); group g admits pool stripe[g]
    # (a repeat breaks a run); existing node e is compatible with the
    # groups of pool e % P only
    stripe = np.array([0, 1, 2, 3, 0, 0, 1, 2, 3, 1, 2, 0, 3, 3, 0, 1]
                      * (G // 16 + 1))[:G]
    pt = np.zeros((P, T), bool)
    for p in range(P):
        pt[p, p * T // P:(p + 1) * T // P] = True
    admit = np.zeros((G, P), bool)
    admit[np.arange(G), stripe] = True
    rng = np.random.RandomState(11)
    arrays.update(
        pool_types=pt, pool_agz=np.ones((P, Z), bool),
        pool_agc=np.ones((P, C), bool), admit=admit,
        daemon=rng.randint(0, 1 << 12, size=(G, P, arrays["A"].shape[1])
                           ).astype(np.int64),
        pool_limit=np.full((P, arrays["A"].shape[1]), -1, np.int64),
        pool_used0=np.zeros((P, arrays["A"].shape[1]), np.int64),
        ex_compat=stripe[:, None] == (np.arange(E) % P)[None, :])
    arrays["fuse"] = independent_runs(admit) & independent_runs(
        arrays["ex_compat"])
    return arrays, dict(st, P=P, F=FUSE)


#: the striped cluster's NodePools, one an instance family (the families
#: of the reference's ``bench.build_config7``)
STRIPE_FAMILIES = ("m5", "c5", "r5", "m6i", "c6i")


def striped_cluster(env, n_pods: int = 50_000, n_sigs: int = 500,
                    n_existing: int = 0, api=None):
    """The fused scan's cell: ``n_sigs`` signatures of n_pods/n_sigs pods
    each, cpu and memory drawn as the reference's
    ``bench.build_batch_snapshots`` draws them, signature i pinned to the
    NodePool of family ``STRIPE_FAMILIES[i % 5]`` (one NodePool per
    instance family, each over its family of the full catalog). Adjacent
    groups in canonical order that admit disjoint pools form the runs
    the encoder fuses. ``n_existing`` adds that many ready nodes (16 cpu,
    64Gi, 58 pods, as the reference's fused-kernel test builds its one,
    zones round-robin) labeled with the families round-robin, so each is
    compatible with one family's groups: the vectorized blocks fill
    existing rows, and the existing-compat runs follow the pools.
    ``api`` as ``topo_api``."""
    a = topo_api(api)
    L = a.L
    fams = STRIPE_FAMILIES
    per = max(1, n_pods // n_sigs)
    pods = []
    for i in range(n_sigs):
        cnt = per if i < n_sigs - 1 else n_pods - per * (n_sigs - 1)
        pods += a.make_pods(cnt, cpu=f"{100 + (i * 7) % 400}m",
                            memory=f"{256 + (i * 13) % 700}Mi",
                            prefix=f"sc{i:03d}",
                            node_selector={L.INSTANCE_FAMILY:
                                           fams[i % len(fams)]})
    pools = [env.nodepool(f"stripe-{f}", requirements=[
        {"key": L.INSTANCE_FAMILY, "operator": "In", "values": [f]}])
        for f in fams]
    # the reference's Environment keeps its zones on its fake EC2
    zones = [z.name for z in getattr(env, "ec2", env).zones]
    existing = [a.ExistingNode(
        name=f"sx-{e:03d}",
        labels={L.ARCH: "amd64", L.OS: "linux", L.ZONE: zones[e % len(zones)],
                L.INSTANCE_FAMILY: fams[e % len(fams)]},
        allocatable=a.Resources.parse(
            {"cpu": "16", "memory": "64Gi", "pods": 58}))
        for e in range(n_existing)]
    return env.snapshot(pods, pools, existing_nodes=existing)


# ---------------------------------------------------------------------------
# synthetic pruned-scan (K6) inputs
# ---------------------------------------------------------------------------

#: the pruned scan's parity cases: existing nodes (one over-committed),
#: two pools with binding limits, daemon overhead, an all-zero request
#: row met by eight or more compatible open slots (k = BIG on each, so
#: the prefix wraps int64), the plain shape, and "wrap_n_rem": request
#: rows with no positive entry (one negative) met by enough open slots
#: that the fill's wrapping sums leave n_rem negative when the new-node
#: phase runs, over three pools: one whose limit binds mid-scan, one
#: unlimited, one whose limit is already exceeded (budget 0). The phase
#: then places a negative count, which moves pool_used (through the
#: negative entry) and n_rem. The request rows are scaled so a node holds
#: tens of pods and a group's fill spans slots.
PRUNED_CASES = ("plain", "existing", "pool_limits", "daemon", "zero_r_row",
                "wrap_n_rem")


def pruned_case(name: str, base: Callable = example_arrays, G: int = 16,
                T: int = 24, n_max: int = 16, Z: int = 3, C: int = 2,
                D: int = 4, seed: int = 3) -> Tuple[Dict, Dict]:
    """(arrays, statics) of one pruned-scan case: the K = M = 0, Q = 0
    layout, statics as ``example_case``'s."""
    if name not in PRUNED_CASES:
        raise ValueError(f"unknown case {name!r}; one of {PRUNED_CASES}")
    rng = np.random.RandomState(seed)
    kw = dict(n_groups=G, n_types=T, n_max=n_max, Z=Z, C=C, D=D)
    if name == "existing":
        kw["E"] = 6
    elif name == "pool_limits":
        kw["P"] = 2
    elif name == "wrap_n_rem":
        kw.update(P=3, n_max=max(n_max, 24))
    arrays, st = base(**kw)
    E, P = st["E"], st["P"]
    arrays["R"] = arrays["R"] * 64
    if name == "existing":
        arrays["ex_alloc"] = rng.randint(1 << 16, 1 << 20, size=(E, D)
                                         ).astype(np.int64)
        arrays["ex_used0"] = rng.randint(0, 1 << 16, size=(E, D)).astype(
            np.int64)
        arrays["ex_used0"][0] = arrays["ex_alloc"][0] + 5   # over-committed
        arrays["ex_compat"] = rng.rand(G, E) < 0.6
    elif name == "pool_limits":
        pt = np.zeros((P, T), bool)
        pt[0, : 2 * T // 3], pt[1, T // 3:] = True, True
        lim = np.full((P, D), -1, np.int64)
        lim[0, 0] = int(arrays["R"][:, 0].sum() * 3)
        lim[1, 2] = int(arrays["R"][:, 2].sum() * 4)
        arrays.update(pool_types=pt, pool_limit=lim,
                      admit=rng.rand(G, P) < 0.8,
                      pool_used0=rng.randint(0, 1 << 10, size=(P, D)
                                             ).astype(np.int64))
    elif name == "daemon":
        arrays["daemon"] = rng.randint(0, 1 << 16, size=(G, P, D)).astype(
            np.int64)
    elif name == "zero_r_row":
        arrays["R"][G - 1] = 0
        arrays["n"][G - 1] = 40
        arrays["F"][G - 1] = True
    elif name == "wrap_n_rem":
        lim = np.full((P, D), -1, np.int64)
        lim[0, 0] = int(arrays["R"][:, 0].sum() * 2)
        lim[2, 0] = 1 << 10
        used0 = np.zeros((P, D), np.int64)
        used0[2] = 1 << 12
        arrays.update(pool_limit=lim, pool_used0=used0,
                      admit=np.ones((G, P), bool))
        for g in (G - 5, G - 1):
            arrays["R"][g] = 0
            arrays["R"][g, 1] = -3
            arrays["n"][g] = 40
            arrays["F"][g] = True
    statics = dict(T=T, D=D, Z=Z, C=C, G=G, E=E, P=P, K=0, M=0, V=0, Q=0,
                   n_max=st["n_max"])
    return arrays, statics


#: the exact-slot budget at which ``pruned_lanes``' first lane bails and
#: the other two do not
PRUNED_LANES_S = 4


def pruned_lanes(base: Callable = example_arrays):
    """Three arenas of one statics bucket with different contents for
    the lane axis of the pruned scan (``_many``): the ``daemon`` case as
    it is (bails at ``PRUNED_LANES_S``), with one pod per group, and with
    a tenth of its pods (neither bails). Returns (list of arrays,
    statics)."""
    arrays, st = pruned_case("daemon", base=base)
    lanes = [arrays, dict(arrays, n=np.ones_like(arrays["n"])),
             dict(arrays, n=arrays["n"] // 10 + 1)]
    return lanes, st


def pruned_statics(statics: dict) -> dict:
    """Keyword statics of ``solve_scan_packed1_pruned`` (without S)."""
    return {k: statics[k] for k in ("T", "D", "Z", "C", "G", "E", "P",
                                    "n_max")}


# ---------------------------------------------------------------------------
# synthetic consolidation (K7) inputs: the parity cases of the four kernels
# ---------------------------------------------------------------------------

#: absorption-scan hazards: an all-zero request row (k = BIG on every
#: compatible node, so the exclusive prefix wraps int64), over-committed
#: nodes (negative floor quotients), dead nodes, padded lanes and groups,
#: and counts far past what the nodes hold
ABSORB_HAZARDS = ("plain", "zero_r_row", "overcommitted", "dead_nodes",
                  "padded_lanes", "wide_n")
#: subset-lane hazards: the above where they apply, lanes that keep no
#: type (price cap 0), and lanes that need more than the two subset slots
SUBSET_HAZARDS = ("plain", "zero_r_row", "overcommitted", "dead_nodes",
                  "padded_lanes", "no_keep", "three_nodes")
_BIG = 1 << 60


def absorb_case(hazard: str, seed: int, B: int = 16, E: int = 32,
                G: int = 4, D: int = 8, S: int = 8, Sc: int = 4):
    """Shared-table inputs of the deletion check and the pre-screen:
    (ex_alloc, ex_used0, compat_tab, R_tab, gid, cid, n, alive)."""
    rng = np.random.RandomState(seed)
    ex_alloc = rng.randint(1 << 10, 1 << 14, (E, D)).astype(np.int64)
    ex_used = (ex_alloc * rng.uniform(0, 0.9, (E, D))).astype(np.int64)
    compat = rng.rand(Sc, E) < 0.8
    R = rng.randint(1, 1 << 9, (S, D)).astype(np.int64)
    R[:, rng.rand(D) < 0.4] = 0
    gid = rng.randint(0, S, (B, G)).astype(np.int32)
    cid = rng.randint(0, Sc, (B, G)).astype(np.int32)
    n = rng.randint(0, 40, (B, G)).astype(np.int64)
    alive = rng.rand(B, E) < 0.9
    if hazard == "zero_r_row":
        R[0] = 0
        gid[::2, 0] = 0
        compat[:] = True
    elif hazard == "overcommitted":
        ex_used[::3] = ex_alloc[::3] + rng.randint(1, 1 << 8, (E, D))[::3]
    elif hazard == "dead_nodes":
        alive[:, ::2] = False
        alive[3 % B] = False
    elif hazard == "padded_lanes":
        n[B // 2:] = 0               # padded lanes: gid 0, n 0, all dead
        gid[B // 2:] = 0
        cid[B // 2:] = 0
        alive[B // 2:] = False
        n[:, G // 2:] = 0            # padded groups inside live lanes
    elif hazard == "wide_n":
        n *= 50
    return ex_alloc, ex_used, compat, R, gid, cid, n, alive


def prescreen_tables(seed: int, B: int = 16, T: int = 48, P: int = 2,
                     Sc: int = 4, D: int = 8):
    """The pre-screen's catalog inputs: (type_alloc, type_price, tcompat,
    padmit, pool_types, price_cap)."""
    rng = np.random.RandomState(seed + 1000)
    type_alloc = rng.randint(1 << 9, 1 << 15, (T, D)).astype(np.int64)
    type_price = rng.randint(1, 1 << 20, T).astype(np.int64)
    type_price[rng.rand(T) < 0.1] = _BIG          # no available offering
    tcompat = rng.rand(Sc, T) < 0.7
    padmit = rng.rand(P, Sc) < 0.7
    pool_types = rng.rand(P, T) < 0.6
    price_cap = rng.choice([0, 1 << 18, 1 << 19, _BIG], B).astype(np.int64)
    return type_alloc, type_price, tcompat, padmit, pool_types, price_cap


def dense_case(hazard: str, seed: int, **kw):
    """Per-lane tables (ex_alloc, ex_used0, ex_compat, R, n) gathered
    from the shared case (dead rows masked), some lanes' capacities
    moved, so every hazard carries over."""
    ex_alloc, ex_used, compat, R, gid, cid, n, alive = \
        absorb_case(hazard, seed, **kw)
    B, E = alive.shape
    rng = np.random.RandomState(seed + 7)
    a = np.broadcast_to(ex_alloc, (B,) + ex_alloc.shape).copy()
    u = np.broadcast_to(ex_used, (B,) + ex_used.shape).copy()
    a[rng.rand(B, E) < 0.2] += 1 << 8
    return a, u, compat[cid] & alive[:, None, :], R[gid], n


def subset_case(hazard: str, seed: int, Gu: int = 6, Ep: int = 16,
                T: int = 24, P: int = 2, Z: int = 3, C: int = 2, D: int = 8,
                B: int = 16, Gq: int = 2):
    """A synthetic union arena (the KernelInputs field set, no minValues)
    and subset lanes: ``(arena, tprice, lanes, statics)`` with lanes =
    dict(gid, n, dead, keep, removed_price) and statics = dict(n_max=2,
    E, P)."""
    rng = np.random.RandomState(seed)
    arena = dict(
        A=rng.randint(1 << 11, 1 << 14, (T, D)).astype(np.int64),
        avail_zc=rng.rand(T, Z * C) < 0.8,
        R=rng.randint(1, 1 << 9, (Gu, D)).astype(np.int64),
        n=rng.randint(1, 30, Gu).astype(np.int64),
        F=rng.rand(Gu, T) < 0.7,
        agz=rng.rand(Gu, Z) < 0.9, agc=rng.rand(Gu, C) < 0.9,
        admit=rng.rand(Gu, P) < 0.8,
        daemon=rng.randint(0, 1 << 6, (Gu, P, D)).astype(np.int64),
        ex_compat=rng.rand(Gu, Ep) < 0.7,
        pool_types=rng.rand(P, T) < 0.7,
        pool_agz=np.ones((P, Z), bool), pool_agc=np.ones((P, C), bool),
        pool_limit=np.full((P, D), -1, np.int64),
        pool_used0=np.zeros((P, D), np.int64),
        ex_alloc=rng.randint(1 << 11, 1 << 14, (Ep, D)).astype(np.int64),
        ex_used0=rng.randint(0, 1 << 12, (Ep, D)).astype(np.int64))
    arena["R"][:, D // 2:] = 0
    arena["daemon"][:, :, D // 2:] = 0
    tprice = rng.randint(1, 1 << 20, T).astype(np.int64)
    tprice[rng.rand(T) < 0.1] = _BIG
    gid = rng.randint(0, Gu, (B, Gq)).astype(np.int32)
    n = rng.randint(0, 40, (B, Gq)).astype(np.int64)
    dead = rng.rand(B, Ep) < 0.3
    cap = rng.choice([0, 1 << 18, 1 << 19, 1 << 21], B).astype(np.int64)
    if hazard == "zero_r_row":
        arena["R"][0] = 0
        arena["daemon"][0] = 0
        gid[::2, 0] = 0
        arena["ex_compat"][0] = True
    elif hazard == "overcommitted":
        arena["ex_used0"][::3] = arena["ex_alloc"][::3] + 17
    elif hazard == "dead_nodes":
        dead[:, ::2] = True
        dead[1 % B] = True
    elif hazard == "padded_lanes":
        gid[B // 2:] = 0
        n[B // 2:] = 0
        dead[B // 2:] = False
        cap[B // 2:] = 0
        n[: B // 2, Gq // 2:] = 0
    elif hazard == "no_keep":
        cap[::2] = 0
    elif hazard == "three_nodes":
        n[0] = 600
        n[1 % B, 0] = 200
        cap[:2] = 1 << 21
    keep = tprice[None, :] < cap[:, None]
    lanes = dict(gid=gid, n=n, dead=dead, keep=keep, removed_price=cap)
    return arena, tprice, lanes, dict(n_max=2, E=Ep, P=P)


#: odd shapes of the gather (``subset_case`` keywords): rows of T and E
#: bytes that are not multiples of 16 (so a lane's rows start at every
#: offset), D odd (the lane tables' 16-byte words straddle rows and lanes),
#: Gq = 1 and 128, a lane's bytes above and below a CTA's share, and round
#: (a)'s widths
GATHER_SHAPES = (
    dict(T=813, D=7, Ep=37, Z=3, C=2, P=3, B=33, Gq=1),
    dict(T=29, D=5, Ep=3, Z=2, C=3, P=2, B=7, Gq=3),
    dict(T=17, D=1, Ep=1, Z=1, C=1, P=1, B=5, Gq=2),
    dict(T=100, D=8, Ep=45, Z=4, C=3, P=2, B=9, Gq=128),
    dict(T=812, D=8, Ep=1000, Z=4, C=3, P=1, B=6, Gq=128),
    dict(T=812, D=8, Ep=1024, Z=4, C=3, P=1, B=40, Gq=1),
)

#: a fused round wider than grid y holds (hazard 57): the 16 lanes of
#: ``fused_mixed_lanes(16)``, each repeated this many times (65,552)
FUSED_WIDE_REPS = 4097


def fused_mixed_lanes(B: int) -> Tuple[list, Dict]:
    """B striped lanes whose blocks branch differently: lane b flips one
    block's flags (or none, the cycle of eight below) and rolls the
    counts by b. Returns (the lanes' arrays, the statics)."""
    arrays, st = fused_case("striped")
    lanes = []
    for b in range(B):
        a = {k: np.array(v) for k, v in arrays.items()}
        flip = (None, 1, 5, 6, 9, 10, 13, 14)[b % 8]
        if flip is not None:
            a["fuse"][flip] = ~a["fuse"][flip]
        a["n"] = np.roll(a["n"], b)
        lanes.append(a)
    return lanes, st


def tile_lanes(lanes: dict, reps: int) -> dict:
    """Subset lanes repeated ``reps`` times along the lane axis (a round
    wider than a grid axis holds, from a small case)."""
    return {k: np.tile(v, (reps,) + (1,) * (v.ndim - 1))
            for k, v in lanes.items()}


def pack_statics(statics: dict) -> tuple:
    """Positional statics of ``hostpack.pack_inputs1`` (F from the
    statics, 1 when absent)."""
    s = statics
    return (s["T"], s["D"], s["Z"], s["C"], s["G"], s["E"], s["P"], s["K"],
            s["M"], s.get("F", 1), s["Q"])


def solve_statics(statics: dict) -> dict:
    """Keyword statics of ``solve_scan_packed1``; F only for a fused
    arena (F > 1), so an unfused arena's statics also fit the
    checkpointed and suffix solves."""
    out = {k: statics[k] for k in ("T", "D", "Z", "C", "G", "E", "P",
                                   "n_max", "K", "V", "M", "Q")}
    if statics.get("F", 1) > 1:
        out["F"] = statics["F"]
    return out


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


# ---------------------------------------------------------------------------
# consolidation: config 4 and the controller's decision walks
# ---------------------------------------------------------------------------

def config7(env, n_pods: int = 50_000, n_sigs: int = 10_000):
    """BASELINE config 7, the high-cardinality pod-signature stress (the
    G axis): ~n_sigs distinct scheduling signatures across n_pods pods
    under one pool over the full catalog. A copy of the reference
    repository's ``bench.build_config7``: 80% unique-request groups (cpu
    at 1m, memory at 1Mi granularity), 15% pinned to an instance family,
    5% to spot capacity."""
    from .apis import labels as L
    from .fake.environment import make_pods

    per = max(1, n_pods // n_sigs)
    pods = []
    fams = ["m5", "c5", "r5", "m6i", "c6i"]
    i = 0
    while len(pods) < n_pods:
        cpu = 100 + (i % 400)          # 100..499 m
        mem = 256 + (i // 400) * 3     # Mi; unique (cpu, mem) pairs
        sel = None
        if i % 20 >= 17:               # 15%: family-pinned
            sel = {L.INSTANCE_FAMILY: fams[i % len(fams)]}
        elif i % 20 == 16:             # 5%: spot-pinned
            sel = {L.CAPACITY_TYPE: "spot"}
        cnt = min(per, n_pods - len(pods))
        pods += make_pods(cnt, cpu=f"{cpu}m", memory=f"{mem}Mi",
                          prefix=f"hc{i:05d}", node_selector=sel)
        i += 1
    return env.snapshot(pods, [env.nodepool("bench-c7")])


def batch_snapshots(env, batch: int = 8, n_sigs: int = 96, per: int = 4):
    """B independent snapshots of ONE statics bucket for the batched
    solve (``CUDASolver.solve_batch``), with different contents per
    snapshot: n_sigs signatures striped over three family-disjoint
    pools, requests varying with the snapshot's index. A copy of the
    reference repository's ``bench.build_batch_snapshots`` (the model of
    consolidation's candidate pre-screen: many small what-if snapshots
    in hand at once)."""
    from .apis import labels as L
    from .fake.environment import make_pods

    fams = ["m5", "c5", "r5"]
    pools = [env.nodepool(f"bench-batch-{f}", requirements=[
        {"key": L.INSTANCE_FAMILY, "operator": "In", "values": [f]}])
        for f in fams]
    snaps = []
    for b in range(batch):
        pods = []
        for i in range(n_sigs):
            pods += make_pods(
                per, cpu=f"{100 + (i * 7 + b * 31) % 400}m",
                memory=f"{256 + (i * 13 + b * 57) % 700}Mi",
                prefix=f"bt{b:02d}x{i:03d}",
                node_selector={L.INSTANCE_FAMILY: fams[i % 3]})
        snaps.append(env.snapshot(pods, pools))
    return snaps


def config4(env, n_nodes: int = 200, n_replaceable: int = 10):
    """BASELINE config 4, consolidation over a live cluster: a copy of
    the reference's ``bench.build_config4`` on this package's classes.
    ``n_nodes`` m5.4xlarge nodes, every one a candidate, deletion
    infeasible everywhere (each pod's request exceeds every neighbour's
    spare). The first ``n_nodes - n_replaceable`` hold 2 pods of
    (6500m, 26000Mi) pinned to the m5 family, where no cheaper type holds
    their aggregate: unreplaceable. The last ``n_replaceable`` hold 3
    memory-heavy pods of (650m, 17000Mi) that a cheaper r-family node
    holds: replaceable, met last in disruption-cost order.

    Returns ``(base, cands)``: the base snapshot (no pending pods, the
    full catalog in one pool) and per candidate ``(name, pods, gone
    names, price cap)``."""
    from .apis import labels as L
    from .apis.resources import Resources
    from .fake.environment import make_pods
    from .solver.types import ExistingNode

    zones = ["us-west-2a", "us-west-2b", "us-west-2c"]
    pool = env.nodepool("bench-c4")
    base = env.snapshot([], [pool])
    cand_price = max(
        (it.cheapest_price() or 0)
        for s in base.nodepools for it in s.instance_types
        if it.name == "m5.4xlarge")
    nodes, cands = [], []
    for i in range(n_nodes):
        if i >= n_nodes - n_replaceable:
            pods = make_pods(3, cpu="650m", memory="17000Mi",
                             prefix=f"c4z{i:03d}")
        else:
            pods = make_pods(2, cpu="6500m", memory="26000Mi",
                             prefix=f"c4a{i:03d}",
                             node_selector={L.INSTANCE_FAMILY: "m5"})
        used = Resources()
        for p in pods:
            used = used + p.effective_requests()
        name = f"bench-node-{i:03d}"
        nodes.append(ExistingNode(
            name=name,
            labels={L.ZONE: zones[i % 3], L.ARCH: "amd64",
                    L.CAPACITY_TYPE: "on-demand",
                    L.INSTANCE_TYPE: "m5.4xlarge",
                    L.INSTANCE_FAMILY: "m5"},
            allocatable=Resources.parse(
                {"cpu": "15796m", "memory": "57591Mi", "pods": "110"}),
            used=used))
        cands.append((name, pods, {name}, cand_price))
    base.existing_nodes = nodes
    return base, cands


def deletion_snapshot(base, cand):
    """The deletion check of one candidate: its pods against the other
    nodes, no pools (price cap 0)."""
    from .solver.types import SchedulingSnapshot
    _name, pods, gone, _cap = cand
    return SchedulingSnapshot(
        pods=pods, nodepools=[],
        existing_nodes=[n for n in base.existing_nodes if n.name not in gone],
        daemon_overheads=base.daemon_overheads, zones=base.zones)


def replacement_snapshot(base, cand):
    """The controller's price-filtered simulate of one candidate (or
    prefix): the pools keep only types strictly cheaper than the cap."""
    from .cloudprovider.types import InstanceTypes
    from .solver.types import NodePoolSpec, SchedulingSnapshot
    _name, pods, gone, cap = cand
    pools = []
    for spec in base.nodepools:
        kept = InstanceTypes(
            [it for it in spec.instance_types
             if (p := it.cheapest_price()) is not None and p < cap])
        if kept:
            pools.append(NodePoolSpec(nodepool=spec.nodepool,
                                      instance_types=kept,
                                      in_use=spec.in_use))
    return SchedulingSnapshot(
        pods=pods, nodepools=pools,
        existing_nodes=[n for n in base.existing_nodes if n.name not in gone],
        daemon_overheads=base.daemon_overheads, zones=base.zones)


def consolidation_queries(cands):
    """The whole-fleet round's lanes: a deletion query (price cap 0) per
    candidate, then a replacement query (its own price cap) each."""
    from .controllers.disruption import ReplacementQuery
    return ([ReplacementQuery(pods=c[1], gone=c[2], price_cap=0)
             for c in cands]
            + [ReplacementQuery(pods=c[1], gone=c[2], price_cap=c[3])
               for c in cands])


def _replace_one(solver, base, cand):
    res = solver.solve(replacement_snapshot(base, cand))
    if res.unschedulable or len(res.new_nodes) != 1:
        return None
    return ("replace", cand[0], res.decision_fingerprint())


def single_consolidation_device(ev, base, cands, queries=None):
    """``_single_consolidation``'s device branch: ONE subset round answers
    every deletion lane and every replacement lane; the first deletion
    with ``feasible and n_new == 0`` wins, else the first replacement
    lane with ``feasible and n_new == 1`` whose authoritative simulate
    (``ev.solver``) opens exactly one node. Returns ``(kind, name,
    fingerprint)``; ("fallback", "", "") when the round is ineligible."""
    n = len(cands)
    verdicts = ev.subset_solve(base, queries if queries is not None
                               else consolidation_queries(cands))
    if verdicts is None:
        return ("fallback", "", "")
    for c, v in zip(cands, verdicts[:n]):
        if v.feasible and v.n_new == 0:
            return ("delete", c[0], "")
    for c, v in zip(cands, verdicts[n:]):
        if v.feasible and v.n_new == 1:
            got = _replace_one(ev.solver, base, c)
            if got is not None:
                return got
    return ("none", "", "")


def single_consolidation_batched(ev, solver, base, cands):
    """``_single_consolidation``'s batched branch without subset lanes:
    one deletion batch, one replacement pre-screen batch, then the
    simulate (``solver``) on the surviving candidates in order."""
    from .controllers.disruption import ReplacementQuery
    ok = ev.deletions_feasible([deletion_snapshot(base, c) for c in cands])
    for c, o in zip(cands, ok):
        if o:
            return ("delete", c[0], "")
    maybe = ev.replacements_prescreen(base, [
        ReplacementQuery(pods=c[1], gone=c[2], price_cap=c[3])
        for c in cands])
    for c, m in zip(cands, maybe):
        if m:
            got = _replace_one(solver, base, c)
            if got is not None:
                return got
    return ("none", "", "")


def prefix_queries(cands):
    """The multi-node search's lanes: for k = 2 .. len(cands), the first
    k candidates' pods, gone names and summed price cap."""
    from .controllers.disruption import ReplacementQuery
    out, pods, gone, price = [], [], set(), 0
    for k, c in enumerate(cands, start=1):
        pods = pods + c[1]
        gone = gone | c[2]
        price += c[3]
        if k >= 2:
            out.append(ReplacementQuery(pods=pods, gone=gone,
                                        price_cap=price))
    return out


def _try_prefix(solver, base, prefix):
    """The authoritative simulate of one prefix: at most one new node at
    the summed price cap; a new node for an all-spot prefix must not be
    spot (spot-to-spot replacement is single-node only)."""
    from .apis import labels as L
    cap = sum(c[3] for c in prefix)
    gone = set().union(*(c[2] for c in prefix))
    res = solver.solve(replacement_snapshot(
        base, ("", [p for c in prefix for p in c[1]], gone, cap)))
    if res.unschedulable or len(res.new_nodes) > 1:
        return None
    ctype = {n.name: n.labels.get(L.CAPACITY_TYPE, "")
             for n in base.existing_nodes}
    if res.new_nodes and all(ctype.get(c[0]) == L.CAPACITY_TYPE_SPOT
                             for c in prefix):
        ct = res.new_nodes[0].requirements.get(L.CAPACITY_TYPE)
        if ct is None or ct.has(L.CAPACITY_TYPE_SPOT):
            return None
    return ("multi", tuple(c[0] for c in prefix),
            res.decision_fingerprint())


def multi_consolidation(ev, solver, base, cands, queries=None):
    """``_multi_consolidation`` over the candidate prefix the caller
    passes (budgets already applied): one subset round answers every
    prefix the binary search can visit (the pre-screen when the round is
    ineligible), then the binary search for the largest ascending-cost
    prefix that one cheaper node replaces, simulating only prefixes whose
    verdict allows it. Returns ``("multi", names, fingerprint)`` or
    ``("none", (), "")``."""
    if len(cands) < 2:
        return ("none", (), "")
    queries = queries if queries is not None else prefix_queries(cands)
    verdicts = ev.subset_solve(base, queries)
    if verdicts is not None:
        maybe = [v.feasible and v.n_new <= 1 for v in verdicts]
    else:
        maybe = ev.replacements_prescreen(base, queries)
    best = ("none", (), "")
    lo, hi = 2, len(cands)
    while lo <= hi:
        mid = (lo + hi) // 2
        got = _try_prefix(solver, base, cands[:mid]) if maybe[mid - 2] \
            else None
        if got is not None:
            best, lo = got, mid + 1
        else:
            hi = mid - 1
    return best


# ---------------------------------------------------------------------------
# topology (K9): BASELINE config 3, the equivalence scenarios, the fuzz,
# and the kernel cases
# ---------------------------------------------------------------------------

def topo_api(pkg=None):
    """The objects a topology scenario is built from, as a namespace:
    ``make_pods``, ``TopologySpreadConstraint``, ``PodAffinityTerm``,
    ``ExistingNode``, ``Resources`` and the ``labels`` module ``L``. By
    default this package's; a test passes the reference package's
    modules in the same shape to build the same scenario there."""
    from types import SimpleNamespace
    if pkg is not None:
        return pkg
    from .apis import labels as L
    from .apis.objects import PodAffinityTerm, TopologySpreadConstraint
    from .apis.resources import Resources
    from .fake.environment import make_pods
    from .solver.types import ExistingNode
    return SimpleNamespace(make_pods=make_pods, L=L, Resources=Resources,
                           TopologySpreadConstraint=TopologySpreadConstraint,
                           PodAffinityTerm=PodAffinityTerm,
                           ExistingNode=ExistingNode)


def config3(env, n_pods: int = 50_000, api=None):
    """BASELINE config 3, topology: half the pods plain, 20 zone-spread
    deployments (maxSkew 1, DoNotSchedule) and one hostname
    anti-affinity deployment of min(200, n/10) pods (one pod per node).
    A copy of the reference repository's ``bench.build_config3``."""
    a = topo_api(api)
    L = a.L
    n_plain = int(n_pods * 0.5)
    n_anti = min(200, n_pods // 10)
    n_spread = max(0, n_pods - n_plain - n_anti)
    spread_groups = max(1, min(20, n_spread))
    pods = a.make_pods(n_plain, cpu="250m", memory="512Mi", prefix="plain")
    per = n_spread // spread_groups
    for gi in range(spread_groups):
        cnt = per if gi < spread_groups - 1 \
            else n_spread - per * (spread_groups - 1)
        pods += a.make_pods(
            cnt, cpu="500m", memory="1Gi", prefix=f"spread{gi:02d}",
            group=f"spread{gi:02d}",
            topology_spread=[a.TopologySpreadConstraint(
                max_skew=1, topology_key=L.ZONE,
                when_unsatisfiable="DoNotSchedule", group=f"spread{gi:02d}")])
    pods += a.make_pods(
        n_anti, cpu="1", memory="2Gi", prefix="anti", group="anti",
        pod_affinity=[a.PodAffinityTerm(topology_key=L.HOSTNAME,
                                        group="anti", anti=True)])
    return env.snapshot(pods, [env.nodepool("bench-c3")])


def config6(env, n_pods: int = 50_000, api=None):
    """BASELINE config 6, preference relaxation at headline scale (a copy
    of the reference repository's ``bench.build_config6``): 70% plain
    pods, 20% with a ScheduleAnyway zone spread in at most 10 groups, 10%
    with a preferred (soft) zone anti-affinity in ~200-pod groups, which
    cannot hold when hardened, so the wrapper relaxes them."""
    a = topo_api(api)
    L = a.L
    n_plain = int(n_pods * 0.70)
    n_soft_spread = int(n_pods * 0.20)
    n_soft_anti = n_pods - n_plain - n_soft_spread
    pods = a.make_pods(n_plain, cpu="250m", memory="512Mi", prefix="plain6")
    groups = max(1, min(10, n_soft_spread))
    per = n_soft_spread // groups
    for gi in range(groups):
        cnt = per if gi < groups - 1 \
            else n_soft_spread - per * (groups - 1)
        pods += a.make_pods(
            cnt, cpu="500m", memory="1Gi", prefix=f"soft{gi:02d}",
            group=f"soft{gi:02d}",
            topology_spread=[a.TopologySpreadConstraint(
                max_skew=1, topology_key=L.ZONE,
                when_unsatisfiable="ScheduleAnyway", group=f"soft{gi:02d}")])
    anti_groups = max(1, n_soft_anti // 200)
    per = n_soft_anti // anti_groups
    for gi in range(anti_groups):
        cnt = per if gi < anti_groups - 1 \
            else n_soft_anti - per * (anti_groups - 1)
        pods += a.make_pods(
            cnt, cpu="1", memory="2Gi", prefix=f"panti{gi:03d}",
            group=f"panti{gi:03d}",
            pod_affinity=[a.PodAffinityTerm(
                topology_key=L.ZONE, group=f"panti{gi:03d}", anti=True,
                required=False)])
    return env.snapshot(pods, [env.nodepool("bench-c6")])


#: the scenarios of the reference's tests/test_topology_equivalence.py
#: that this package serves (ScheduleAnyway and preferred terms need the
#: preference wrapper), plus the kernel cases' own arenas
TOPO_SCENARIOS = (
    "zone_skew1", "zone_skew2", "two_deployments", "zone_selector",
    "hostname_cap", "zone_plus_hostname", "hostname_anti", "zone_anti",
    "anti_plus_positive", "zone_self_affinity", "cross_group_zone_anti",
    "cross_group_zone_affinity", "zone_pinned", "existing_seeded",
    "mixed_topo_plain", "min_values_zone_spread",
    "min_values_hostname_anti", "config3_small", "two_pools_limits",
    "anti_budget", "anti_slots", "fix_zones")


def topo_scenario(env, name: str, api=None):
    """One named topology scenario (``TOPO_SCENARIOS``) on ``env``."""
    a = topo_api(api)
    L, mk = a.L, a.make_pods
    Tsc, Pat = a.TopologySpreadConstraint, a.PodAffinityTerm

    def zs(skew=1, group=""):
        return Tsc(max_skew=skew, topology_key=L.ZONE, group=group)

    def hs(skew=1, group=""):
        return Tsc(max_skew=skew, topology_key=L.HOSTNAME, group=group)

    pool = [env.nodepool("d")]
    existing = ()
    if name == "zone_skew1":
        pods = mk(30, cpu="1", memory="2Gi", prefix="web",
                  topology_spread=[zs(1)])
    elif name == "zone_skew2":
        pods = mk(25, cpu="1", memory="2Gi", prefix="w2",
                  topology_spread=[zs(2)])
    elif name == "two_deployments":
        pods = (mk(20, cpu="1", memory="2Gi", prefix="a",
                   topology_spread=[zs(1)])
                + mk(15, cpu="2", memory="4Gi", prefix="b",
                     topology_spread=[zs(1)]))
    elif name == "zone_selector":
        pods = mk(12, cpu="1", memory="2Gi", prefix="zsel",
                  node_selector={L.ZONE: "us-west-2a"},
                  topology_spread=[zs(1)])
    elif name == "hostname_cap":
        pods = mk(12, cpu="250m", memory="512Mi", prefix="hcap",
                  topology_spread=[hs(2)])
    elif name == "zone_plus_hostname":
        pods = mk(18, cpu="500m", memory="1Gi", prefix="zh",
                  topology_spread=[zs(1), hs(3)])
    elif name == "hostname_anti":
        pods = mk(8, cpu="1", memory="2Gi", prefix="ha",
                  pod_affinity=[Pat(topology_key=L.HOSTNAME, group="ha",
                                    anti=True)])
    elif name == "zone_anti":
        pods = mk(6, cpu="1", memory="2Gi", prefix="za",
                  pod_affinity=[Pat(topology_key=L.ZONE, group="za",
                                    anti=True)])
    elif name == "anti_plus_positive":
        pods = mk(6, cpu="1", memory="2Gi", prefix="ap", pod_affinity=[
            Pat(topology_key=L.HOSTNAME, group="ap", anti=True),
            Pat(topology_key=L.HOSTNAME, group="ap", anti=False)])
    elif name == "zone_self_affinity":
        pods = mk(10, cpu="1", memory="2Gi", prefix="co",
                  pod_affinity=[Pat(topology_key=L.ZONE, group="co",
                                    anti=False)])
    elif name == "cross_group_zone_anti":
        pods = (mk(4, cpu="1", memory="2Gi", prefix="lead",
                   topology_spread=[zs(1)])
                + mk(6, cpu="1", memory="2Gi", prefix="avoid",
                     pod_affinity=[Pat(topology_key=L.ZONE, group="lead",
                                       anti=True)]))
    elif name == "cross_group_zone_affinity":
        pods = (mk(3, cpu="2", memory="4Gi", prefix="anchor")
                + mk(6, cpu="1", memory="2Gi", prefix="follow",
                     pod_affinity=[Pat(topology_key=L.ZONE, group="anchor",
                                       anti=False)]))
    elif name == "zone_pinned":
        pods = mk(12, cpu="1", memory="2Gi", prefix="pin",
                  topology_spread=[zs(1)])
    elif name == "existing_seeded":
        existing = [
            a.ExistingNode(
                name=f"node-{z}", labels={L.ZONE: z, L.ARCH: "amd64"},
                allocatable=a.Resources.parse(
                    {"cpu": "16", "memory": "64Gi", "pods": "110"}),
                used=a.Resources.parse({"cpu": "1", "memory": "1Gi"}),
                pod_groups=["web"] * cnt)
            for z, cnt in [("us-west-2a", 3), ("us-west-2b", 1)]]
        pods = mk(10, cpu="1", memory="2Gi", prefix="web",
                  topology_spread=[zs(1)])
    elif name == "mixed_topo_plain":
        pods = (mk(40, cpu="500m", memory="1Gi", prefix="plain")
                + mk(12, cpu="1", memory="2Gi", prefix="spreader",
                     topology_spread=[zs(1), hs(4)])
                + mk(20, cpu="250m", memory="512Mi", prefix="tiny"))
    elif name == "min_values_zone_spread":
        pods = mk(120, cpu="8", prefix="mvsp", group="mvsp",
                  topology_spread=[zs(1, group="mvsp")])
        pool = [env.nodepool("mvpool", requirements=[
            {"key": L.INSTANCE_FAMILY, "operator": "Exists",
             "minValues": 5}])]
    elif name == "min_values_hostname_anti":
        pods = mk(6, cpu="4", prefix="mvanti", group="mvanti",
                  pod_affinity=[Pat(topology_key=L.HOSTNAME, group="mvanti",
                                    anti=True)])
        pool = [env.nodepool("mvpool2", requirements=[
            {"key": L.INSTANCE_FAMILY, "operator": "Exists",
             "minValues": 3}])]
    elif name == "config3_small":
        # config 3's three kinds of group at a kernel case's size: every
        # event kind, the periodic jump and the cap-1 ladder
        pods = (mk(40, cpu="500m", memory="1Gi", prefix="ksp")
                + mk(24, cpu="1", memory="2Gi", prefix="kss", group="kss",
                     topology_spread=[zs(1, group="kss")])
                + mk(8, cpu="1", memory="2Gi", prefix="kha",
                     pod_affinity=[Pat(topology_key=L.HOSTNAME, group="kha",
                                       anti=True)]))
    elif name == "two_pools_limits":
        # two pools with cpu limits that bind mid-pour
        pods = (mk(30, cpu="1", memory="2Gi", prefix="tpl", group="tpl",
                   topology_spread=[zs(1, group="tpl"), hs(3, group="tpl")])
                + mk(6, cpu="2", memory="2Gi", prefix="tpa", group="tpa",
                     pod_affinity=[Pat(topology_key=L.HOSTNAME, group="tpa",
                                       anti=True)]))
        pool = [env.nodepool("lim-a", weight=10, limits={"cpu": "24"}),
                env.nodepool("lim-b", limits={"cpu": "40"})]
    elif name == "anti_budget":
        # the cap-1 ladder cut short by pool limits: the first pool's
        # budget ends with its first node (an anti run of m = 0), the
        # second's partway through the run
        pods = mk(12, cpu="3", memory="2Gi", prefix="ab", group="ab",
                  pod_affinity=[Pat(topology_key=L.HOSTNAME, group="ab",
                                    anti=True)])
        pool = [env.nodepool("lim-ab1", weight=10, limits={"cpu": "3"}),
                env.nodepool("lim-ab2", limits={"cpu": "20"})]
    elif name == "anti_slots":
        # the cap-1 ladder past the new-node slots of a kernel case
        pods = (mk(10, cpu="1", memory="2Gi", prefix="as0")
                + mk(80, cpu="1", memory="2Gi", prefix="as", group="as",
                     pod_affinity=[Pat(topology_key=L.HOSTNAME, group="as",
                                       anti=True)]))
    elif name == "fix_zones":
        # zone-free nodes (a hostname spread opens them) that a zone
        # spread of skew 3 then pins one by one, two pods a node: an
        # undecided slot chooses the emptier zone over a lower-named one
        # that its skew still admits
        pods = (mk(8, cpu="3", memory="4Gi", prefix="fzo", group="fzo",
                   topology_spread=[hs(1, group="fzo")])
                + mk(16, cpu="500m", memory="512Mi", prefix="fzs",
                     group="fzs", topology_spread=[zs(3, group="fzs"),
                                                   hs(2, group="fzs")]))
    elif name == "und_first":
        # a zone-free node in zone a (an earlier group's, undecided) below
        # nodes pinned to zones b-d: a spread already at its skew in zone
        # a fails that node's zone choice and pours on a pinned one
        pods = (mk(1, cpu="1", memory="2Gi", prefix="uf0", group="uf0",
                   node_selector={L.ZONE: "us-west-2a"})
                + mk(5, cpu="500m", memory="1Gi", prefix="ufb", group="web",
                     topology_spread=[zs(1, group="web")],
                     pod_affinity=[Pat(topology_key=L.HOSTNAME, group="uf0",
                                       anti=True)])
                + mk(6, cpu="250m", memory="256Mi", prefix="ufs",
                     group="web", topology_spread=[zs(1, group="web")]))
    elif name == "rows_last":
        # two spread deployments on their own counters and a hostname
        # anti-affinity; the kernel case reverses the counter axes, so each
        # group's rows sit at the end of the padded axes with the other
        # deployment's counts in a row it does not list
        pods = (mk(14, cpu="3", memory="4Gi", prefix="rla", group="rla",
                   topology_spread=[zs(1, group="rla"), hs(3, group="rla")])
                + mk(9, cpu="2", memory="4Gi", prefix="rlb", group="rlb",
                     topology_spread=[zs(2, group="rlb")])
                + mk(5, cpu="1", memory="2Gi", prefix="rlh", group="rlh",
                     pod_affinity=[Pat(topology_key=L.HOSTNAME, group="rlh",
                                       anti=True)]))
    elif name == "wide_slots":
        # a zone spread, then the cap-1 anti ladder filling every one of a
        # 2,048-slot bucket's slots (pods left over)
        pods = (mk(30, cpu="1", memory="2Gi", prefix="wsz", group="wsz",
                   topology_spread=[zs(1, group="wsz")])
                + mk(2100, cpu="500m", memory="512Mi", prefix="wsa",
                     group="wsa",
                     pod_affinity=[Pat(topology_key=L.HOSTNAME, group="wsa",
                                       anti=True)]))
    else:
        raise ValueError(f"unknown topology scenario {name!r}")
    return env.snapshot(pods, pool, existing_nodes=existing)


def topo_fuzz(env, seed: int, api=None):
    """The random topology scenario of the reference's
    tests/test_topology_equivalence.py ``test_random_scenarios`` (same
    generator, same seed)."""
    import random
    a = topo_api(api)
    L = a.L
    rng = random.Random(seed)
    pods = []
    for gi in range(rng.randint(1, 5)):
        spread, aff = [], []
        if rng.random() < 0.7:
            spread.append(a.TopologySpreadConstraint(
                max_skew=rng.randint(1, 3), topology_key=L.ZONE))
        if rng.random() < 0.4:
            spread.append(a.TopologySpreadConstraint(
                max_skew=rng.randint(1, 4), topology_key=L.HOSTNAME))
        if rng.random() < 0.3:
            aff.append(a.PodAffinityTerm(
                topology_key=rng.choice([L.ZONE, L.HOSTNAME]),
                group=f"fz{seed}g{rng.randint(0, gi)}",
                anti=rng.random() < 0.6))
        pods += a.make_pods(
            rng.randint(1, 25), cpu=rng.choice(["250m", "500m", "1", "2"]),
            memory=rng.choice(["512Mi", "1Gi", "4Gi"]),
            prefix=f"fz{seed}g{gi}", topology_spread=spread,
            pod_affinity=aff)
    pools = [env.nodepool(f"fzp{seed}")]
    if rng.random() < 0.3:
        pools.append(env.nodepool(f"fzp{seed}b", weight=10,
                                  limits={"cpu": "30"}))
    return env.snapshot(pods, pools)


#: the kernel cases (scenarios inside the device pour's envelope) and the
#: one shape bucket they share: padded groups, pools, counter spaces and
#: new-node slots
TOPO_CASES = ("config3_small", "zone_skew2", "two_deployments",
              "hostname_cap", "zone_plus_hostname", "zone_anti",
              "zone_self_affinity",
              "cross_group_zone_anti", "cross_group_zone_affinity",
              "mixed_topo_plain", "two_pools_limits", "anti_budget",
              "anti_slots", "fix_zones", "und_first", "rows_last",
              "wide_slots")
TOPO_BUCKET = dict(Gp=8, Pp=2, GZp=8, GHp=8)
TOPO_N_MAX = 64
#: the cases at another slot bucket than TOPO_N_MAX
TOPO_N_MAX_OF = dict(wide_slots=2048)
#: the cases whose counter axes are reversed after padding (their rows at
#: the last padded indices)
TOPO_FLIPPED = ("rows_last",)
#: a kernel case's counter axes padded past 2,048 rows
#: (``topo_case(name, counters=TOPO_WIDE_COUNTERS)``): the pour's shared
#: memory follows the rows a group lists, not the padded axes
TOPO_WIDE_COUNTERS = 4096


#: zone-spread constraints (one counter row each) of ``topo_wide_rows``'
#: group: at Z = 4 the pour's shared memory passes one block's 227 KB past
#: about 3,800 listed zone rows
TOPO_LAYOUT_ROWS = 5000


def topo_wide_rows(env, n_rows: int = TOPO_LAYOUT_ROWS, api=None):
    """A snapshot whose one topology group lists ``n_rows`` zone counter
    rows: six pods, each with ``n_rows`` zone-spread constraints (maxSkew
    1) over distinct selectors, on one default pool. Past the pour's
    layout (``TOPO_LAYOUT_ROWS``): the solver answers it on the host
    pour."""
    a = topo_api(api)
    pods = a.make_pods(6, cpu="1", memory="2Gi", prefix="wide",
                       topology_spread=[
                           a.TopologySpreadConstraint(
                               max_skew=1, topology_key=a.L.ZONE,
                               group=f"w{i}") for i in range(n_rows)])
    return env.snapshot(pods, [env.nodepool("d")])


def topo_case(name: str, env=None, counters: int = None):
    """(arrays, rows, statics) of one kernel case: the scenario encoded by
    this package and padded to ``TOPO_BUCKET`` with ``TOPO_N_MAX`` new-node
    slots (``TOPO_N_MAX_OF`` for a wider case), the counter axes of a
    ``TOPO_FLIPPED`` case reversed; statics Z/P/GZ/GH/n_max (the caller
    adds EVCAP and PMAX). ``counters`` pads both counter axes to that
    many rows instead."""
    from .fake.environment import Environment, reset_pod_counter
    from .models.encoding import encode_snapshot
    from .ops.topo import build_topo_encoding
    from .solver.cuda import topo_arrays
    reset_pod_counter()
    snap = topo_scenario(env or Environment(), name)
    enc = encode_snapshot(snap)
    tenc = build_topo_encoding(enc, snap, [])
    arrays, rows, stt = topo_arrays(enc, tenc)
    b = dict(TOPO_BUCKET)
    if counters:
        b.update(GZp=counters, GHp=counters)
    assert len(arrays["n"]) <= b["Gp"] and stt["P"] <= b["Pp"] \
        and stt["GZ"] <= b["GZp"] and stt["GH"] <= b["GHp"], name
    arrays = {k: _pad_axes(a, {0: b["Gp"]} if k in _G_ARRAYS else {})
              for k, a in arrays.items()}
    for k, axis in _P_ARRAYS.items():
        arrays[k] = _pad_axes(arrays[k], {axis: b["Pp"]})
    cols = dict(zs=b["GZp"], za=b["GZp"], hs=b["GHp"], ha=b["GHp"])
    rows = {k: _pad_axes(a, {0: b["Gp"], 1: cols.get(k[:2], a.shape[-1])},
                         _ROW_FILL.get(k, 0))
            for k, a in rows.items()}
    if name in TOPO_FLIPPED:
        rows = {k: _flip_counters(k, a, b) for k, a in rows.items()}
    return arrays, rows, dict(stt, P=b["Pp"], GZ=b["GZp"], GH=b["GHp"],
                              n_max=TOPO_N_MAX_OF.get(name, TOPO_N_MAX))


def _flip_counters(k, a, b):
    """Row ``k`` of a kernel case with its counter axis reversed: counter
    r becomes (padded size - 1 - r)."""
    if k in ("member_z", "member_h"):
        size = b["GZp"] if k == "member_z" else b["GHp"]
        return np.where(a >= 0, size - 1 - a, a).astype(a.dtype)
    if a.ndim == 2 and k[:3] in ("zs_", "za_", "hs_", "ha_"):
        return np.ascontiguousarray(a[:, ::-1])
    return a


#: the kernel cases' re-padding to TOPO_BUCKET: the arrays with a group
#: axis (axis 0) and with a pool axis, and the rows' pads (a padded
#: counter column enforces no skew; a padded group records nothing)
_G_ARRAYS = ("R", "n", "F", "agz", "agc", "admit", "daemon", "ex_compat")
_P_ARRAYS = dict(admit=1, daemon=1, pool_types=0, pool_agz=0, pool_agc=0,
                 pool_limit=0, pool_used0=0)
_ROW_FILL = dict(zs_skew=1 << 60, hs_skew=1 << 60, member_z=-1, member_h=-1)


def _pad_axes(a, sizes: dict, fill=0):
    """``a`` padded at the end of each axis in ``sizes`` to that size."""
    pad = [(0, sizes[ax] - a.shape[ax] if ax in sizes else 0)
           for ax in range(a.ndim)]
    return np.pad(a, pad, constant_values=fill)


def topo_kernel_steps(inp, rows, *, n_max: int, P: int, EVCAP: int = 128,
                      PMAX: int = 8, states: list = None):
    """Walk a topology scan with the plain parts on the inputs' (CUDA)
    device and, at every group's entry state, run that group's kernels
    from the same state: yields (kernel, what, kernel value, plain value)
    for each output of ``topo_pool_statics`` (at a chunk's first group:
    every row of the chunk, and at chunk 0 the offering words),
    ``topo_group_start`` (candidates, room), ``topo_pour`` (carry,
    counters, take, leftover, event-log row, ev_n, bail) and, for a group
    without topology, ``ffd_group_commit`` with its membership record
    (``topo_cuda.plain_commit`` after ``ffd_slot_headroom``: carry, take,
    leftover, counters; the record against ``_topo_record_plain_ref`` of
    the int32 takes the commit writes). The plain parts carry the state.
    ``states`` collects each group's entry state (g, carry, cz,
    ch, zfix, the plain group start or the plain take, the plain pour or
    None)."""
    import torch

    from .ops import ffd_cuda as fc
    from .ops import ffd_torch as ft
    from .ops import topo_cuda as tc
    from .ops import topo_torch as tt
    G = inp.R.shape[0]
    GZ, GH = rows.zs_any.shape[1], rows.hs_any.shape[1]
    Z, C = inp.agz.shape[1], inp.agc.shape[1]
    dev = inp.A.device
    cz = torch.zeros((GZ, Z), dtype=torch.int64, device=dev)
    ch = torch.zeros((GH, n_max), dtype=torch.int64, device=dev)
    ts = tc.topo_state(inp, rows, cz, ch, n_max=n_max, P=P, EVCAP=EVCAP,
                       PMAX=PMAX)
    st = ts.st
    carry = ft.carry0(inp, n_max, 0)
    zfix = torch.full((n_max,), -1, dtype=torch.int32, device=dev)

    def load(carry, cz, ch, zfix):
        for dst, src in zip(st.carry, carry):
            dst.copy_(src)
        ts.cz.copy_(cz)
        ts.ch.copy_(ch)
        ts.zfix.copy_(zfix)

    for g, topo in enumerate(rows.has_topo.tolist()):
        load(carry, cz, ch, zfix)
        if topo:
            r = ts.rank[g]
            if r % ts.chunk == 0:
                c = r // ts.chunk
                groups = ts.topo_groups[r:r + ts.chunk]
                tab = tt._topo_pool_statics_ref(inp, rows, groups, P=P)
                tc.topo_pool_statics(ts, c)
                for j, gj in enumerate(groups):
                    got = ts.statics(gj)
                    for f in tt.PoolStatics._fields:
                        yield "topo_pool_statics", \
                            f"chunk={c} g={gj} {f}", getattr(got, f), \
                            getattr(tab, f)[j]
                if c == 0 and Z * C <= tt.OFFER_BITS:
                    yield "topo_pool_statics", "offw", ts.offw, \
                        tt._offer_words_ref(inp.avail_zc, Z, C)
            cand, rem0 = tt._topo_slot_start_ref(inp, carry, g, P=P)
            gs = tt.group_start_of(cand, rem0, tab, r % ts.chunk)
            tc.topo_group_start(ts, g)
            yield "topo_group_start", f"g={g} cand", st.cand, cand
            yield "topo_group_start", f"g={g} rem0", ts.rem, rem0
            r = tt._topo_pour_ref(inp, carry, cz, ch, zfix, g, rows, gs,
                                  P=P, EVCAP=EVCAP, PMAX=PMAX)
            # the pour starts from the plain group-start state
            st.cand.copy_(gs.cand)
            ts.rem.copy_(gs.rem0)
            ts.load_statics(g, gs)
            tc.topo_pour(ts, g)
            for f, got, want in zip(ft.Carry._fields, st.carry, r.carry):
                yield "topo_pour", f"g={g} {f}", got, want
            yield "topo_pour", f"g={g} cz", ts.cz, r.cz
            yield "topo_pour", f"g={g} ch", ts.ch, r.ch
            yield "topo_pour", f"g={g} zfix", ts.zfix, r.zfix
            yield "topo_pour", f"g={g} take", st.takes[g].long(), r.take
            yield "topo_pour", f"g={g} leftover", st.leftover[g], r.n_rem
            for k in tt.EV_FILL:
                yield "topo_pour", f"g={g} ev_{k}", ts.ev[k][g], r.ev[k]
            yield "topo_pour", f"g={g} ev_n", ts.ev["n"][g], r.ev_n
            yield "topo_pour", f"g={g} bail", ts.bail[g], r.bail
            if states is not None:
                states.append((g, carry, cz, ch, zfix, gs, r))
            carry, cz, ch, zfix = r.carry, r.cz, r.ch, r.zfix
        else:
            nxt, take, n_rem = ft._group_step_ref(inp, carry, g, E=0, P=P,
                                                  V=0)
            if states is not None:
                states.append((g, carry, cz, ch, zfix, take, None))
            cz, ch = tt._topo_record_plain_ref(
                cz, ch, zfix, take.to(torch.int32).long(), rows.member_z[g],
                rows.member_h[g])
            fc.ffd_slot_headroom(st, g)
            tc.plain_commit(ts, g)
            for f, got, want in zip(ft.Carry._fields, st.carry, nxt):
                yield "ffd_group_commit", f"g={g} {f}", got, want
            yield "ffd_group_commit", f"g={g} take", st.takes[g].long(), take
            yield "ffd_group_commit", f"g={g} leftover", st.leftover[g], \
                n_rem
            yield "ffd_group_commit", f"g={g} record cz", ts.cz, cz
            yield "ffd_group_commit", f"g={g} record ch", ts.ch, ch
            carry = nxt


# ---------------------------------------------------------------------------
# preemption (K8)
# ---------------------------------------------------------------------------

#: K8 hazard tables: an all-zero request row compatible everywhere (k =
#: BIG on every node, so the exclusive prefix wraps int64), over-committed
#: nodes (negative floor quotients), refunds above the usage (the clamp
#: at 0), groups of 0 pods, a group compatible nowhere, one lane, the 64
#: lanes of a full search, and a carry past shared memory (E = 4096)
PREEMPT_HAZARDS = ("plain", "zero_r_row", "overcommitted",
                   "refund_above_used", "n_zero", "compat_nowhere",
                   "one_lane", "full_lanes", "wide_e")


def preempt_case(name: str, seed: int, E: int = 32, G: int = 4, D: int = 8,
                 B: int = 16):
    """The K8 inputs of hazard ``name`` (``PREEMPT_HAZARDS``): (ex_alloc,
    ex_used0, ex_compat, R, n, freed). As the planner builds them, lane
    b's refund is lane b-1's plus one victim's requests on one node."""
    B = {"one_lane": 1, "full_lanes": 64}.get(name, B)
    E = 4096 if name == "wide_e" else E
    rng = np.random.RandomState(seed)
    ex_alloc = rng.randint(1 << 10, 1 << 14, (E, D)).astype(np.int64)
    ex_used = (ex_alloc * rng.uniform(0.3, 1.0, (E, D))).astype(np.int64)
    ex_compat = rng.rand(G, E) < 0.8
    R = rng.randint(1, 1 << 9, (G, D)).astype(np.int64)
    R[:, rng.rand(D) < 0.4] = 0
    n = rng.randint(0, 60, G).astype(np.int64)
    step = np.zeros((B, E, D), dtype=np.int64)
    step[np.arange(B), rng.randint(0, E, B)] = \
        rng.randint(0, 1 << 8, (B, D))
    if name == "zero_r_row":
        R[0] = 0
        ex_compat[0] = True
    elif name == "overcommitted":
        ex_used[::3] = ex_alloc[::3] + rng.randint(1, 1 << 10, (E, D))[::3]
    elif name == "refund_above_used":
        step[0, ::4] += ex_used[::4] + rng.randint(1, 1 << 8, (E, D))[::4]
    elif name == "n_zero":
        n[::2] = 0
    elif name == "compat_nowhere":
        ex_compat[1 % G] = False
    return ex_alloc, ex_used, ex_compat, R, n, np.cumsum(step, axis=0)


def preempt_wide_values(seed: int, B: int = 6, E: int = 45, G: int = 5,
                        D: int = 4, small: bool = False):
    """K8 inputs (as ``preempt_case``) whose slacks (or, ``small``, only
    the R rows) reach past 2^51, with R = 1 dims, over-committed nodes and,
    ``small``, a group with a negative R: the absorption scan's quotients
    past their fp64 range, and its fp64 rows turned back to int64."""
    rng = np.random.RandomState(seed)
    hi = 1 << 30 if small else 1 << 58
    ex_alloc = rng.randint(hi >> 5, hi, (E, D)).astype(np.int64)
    ex_alloc[::5] = rng.randint(0, 1 << 10, (E, D))[::5]
    ex_used = (ex_alloc // 3).astype(np.int64)
    ex_used[::7] = ex_alloc[::7] + (1 << 12)        # over-committed
    R = rng.randint(1, 1 << 50, (G, D)).astype(np.int64)
    R[0, 0] = 1
    R[1] = 1
    R[2, 1] = (1 << 53) + 3
    R[3, 2] = 0
    if small:
        R[3] = rng.randint(1, 1 << 8, D)
        R[3, 3] = -5
    n = rng.randint(0, 1 << 12, G).astype(np.int64)
    compat = rng.rand(G, E) < 0.85
    freed = np.cumsum(rng.randint(0, hi >> 18, (B, E, D)), axis=0)
    return ex_alloc, ex_used, compat, R, n, freed.astype(np.int64)


def preempt_api(pkg=None):
    """The objects a preemption cluster is built from, as a namespace:
    the API objects, ``Resources``, ``Requirements``, the ``labels``
    module ``L``, ``FakeKube`` and ``Environment``. By default this
    package's; a test passes the reference package's modules in the same
    shape to build the same cluster there."""
    from types import SimpleNamespace
    if pkg is not None:
        return pkg
    from .apis import labels as L
    from .apis import objects as O
    from .apis.requirements import Requirements
    from .apis.resources import Resources
    from .fake.environment import Environment
    from .fake.kube import FakeKube
    return SimpleNamespace(O=O, L=L, Resources=Resources,
                           Requirements=Requirements, FakeKube=FakeKube,
                           Environment=Environment)


#: the preemption cluster's pools: name, the one instance type its nodes
#: run, and the share of the nodes
_PREEMPT_POOLS = (("pz0", "m5.2xlarge"), ("pz1", "c5.2xlarge"))
#: millicores of the low-tier pods, the spare room a node keeps, memory
_LOW_CPU = (100, 150, 200, 250, 300, 400)
_SLACK_CPU = (0, 50, 100, 150, 200, 250)
_LOW_MEM = ("256Mi", "512Mi", "768Mi", "1Gi")


def preempt_cluster(ns, n_nodes: int, per_node: int, seed: int, *,
                    wave: int = 4, wave_cpu=("300m", "500m"),
                    pools: int = 0, pdb: object = 3, topo: bool = False,
                    critical: float = 0.25,
                    env=None):
    """A running cluster whose next provisioning round must preempt,
    written straight into a fresh ``ns.FakeKube`` (``ns`` from
    ``preempt_api``). Every draw comes from ``seed``, so both packages
    build the same cluster.

    - one ready EC2NodeClass; ``pools`` NodePools (1 or 2; 0 draws it),
      each running one instance type, limits frozen at the capacity its
      NodeClaims hold (no new node can open);
    - ``n_nodes`` ready Nodes (each with its launched NodeClaim), each
      running one DaemonSet pod, a quarter of them (``critical``) one
      system-cluster-critical pod, and ``per_node`` low-tier pods bound
      and Running: priority 0 or the "bulk" class, mixed sizes that fill
      the node's CPU to within 0-250m; 30% carry ``guarded=yes``, which
      a PodDisruptionBudget of ``maxUnavailable=pdb`` covers (None: no
      budget);
    - PriorityClasses "bulk" (10), "high" (1000) and "sacred" (900,
      preemptionPolicy Never);
    - pending: ``wave`` "high" pods, their CPU requests cycling through
      ``wave_cpu``; one "sacred" pod of 1 CPU; with ``topo`` one "high"
      pod spread over zones (DoNotSchedule).

    Returns a namespace: kube, env (the catalog), nodes (names), wave,
    never and topo (the pending pods)."""
    import random
    from types import SimpleNamespace
    O, L, Res = ns.O, ns.L, ns.Resources
    rng = random.Random(seed)
    env = env if env is not None else ns.Environment()
    kube = ns.FakeKube()
    nc = env.nodeclass("pz-class")
    kube.create(nc)
    types = {it.name: it for it in env.instance_types.list(nc)}
    n_pools = pools or rng.randint(1, 2)
    for name, v in (("bulk", 10), ("high", 1000)):
        kube.create(O.PriorityClass(name, value=v))
    kube.create(O.PriorityClass("sacred", value=900,
                                preemption_policy="Never"))
    sizes: Dict[Tuple[int, str], object] = {}

    def req(mcpu: int, mem: str):
        key = (mcpu, mem)
        if key not in sizes:
            sizes[key] = Res.parse({"cpu": f"{mcpu}m", "memory": mem})
        return sizes[key]

    zones = [z for z in sorted({o.zone for it in types.values()
                                for o in it.offerings})]
    usage: Dict[str, object] = {}
    nodes = []
    for i in range(n_nodes):
        pool, tname = _PREEMPT_POOLS[i % n_pools]
        it = types[tname]
        name, zone = f"node-{i:04d}", zones[i % len(zones)]
        pid = f"aws:///{zone}/i-{i:08x}"
        labels = {L.NODEPOOL: pool, L.INSTANCE_TYPE: tname, L.ZONE: zone,
                  L.CAPACITY_TYPE: L.CAPACITY_TYPE_ON_DEMAND,
                  L.HOSTNAME: name, L.ARCH: "amd64", L.OS: "linux"}
        node = O.Node(name, labels=labels, capacity=it.capacity,
                      allocatable=it.allocatable(), provider_id=pid)
        node.ready = True
        kube.create(node)
        claim = O.NodeClaim(f"{pool}-seed-{i:04d}", ns.Requirements(),
                            O.NodeClassRef("pz-class"),
                            labels={L.NODEPOOL: pool,
                                    L.INSTANCE_TYPE: tname})
        claim.capacity, claim.allocatable = it.capacity, it.allocatable()
        claim.provider_id, claim.node_name = pid, name
        claim.set_condition("Launched", "True")
        kube.create(claim)
        usage[pool] = usage[pool] + it.capacity if pool in usage \
            else it.capacity
        nodes.append(name)
        room = it.allocatable()["cpu"] - rng.choice(_SLACK_CPU)
        kube.create(O.Pod(f"ds-{i:04d}", requests=req(100, "128Mi"),
                          node_name=name, phase="Running",
                          owner_kind="DaemonSet", scheduling_group="ds"))
        room -= 100
        if rng.random() < critical:
            kube.create(O.Pod(f"crit-{i:04d}", requests=req(200, "256Mi"),
                              node_name=name, phase="Running",
                              scheduling_group="crit",
                              priority_class_name="system-cluster-critical"))
            room -= 200
        for j in range(per_node):
            rest = per_node - j - 1
            mcpu = min(rng.choice(_LOW_CPU), room - 100 * rest)
            if rest == 0:
                mcpu = room
            mcpu = max(mcpu, 50)
            room -= mcpu
            pod = O.Pod(f"lo-{i:04d}-{j:02d}", requests=req(
                mcpu, rng.choice(_LOW_MEM)), node_name=name,
                phase="Running", scheduling_group=f"lo{j % 4}")
            if rng.random() < 0.3:
                pod.priority_class_name = "bulk"
            if rng.random() < 0.3:
                pod.metadata.labels["guarded"] = "yes"
            kube.create(pod)
    for pool, _t in _PREEMPT_POOLS[:n_pools]:
        kube.create(O.NodePool(pool, template=O.NodePoolTemplate(
            node_class_ref=O.NodeClassRef("pz-class"),
            requirements=ns.Requirements.from_terms(
                [{"key": L.INSTANCE_TYPE, "operator": "In",
                  "values": [_t]}])), limits=usage.get(pool, Res())))
    if pdb is not None:
        kube.create(O.PodDisruptionBudget("guard", {"guarded": "yes"},
                                          max_unavailable=pdb))
    hi = []
    for w in range(wave):
        hi.append(O.Pod(f"hi-{w:03d}", requests=Res.parse(
            {"cpu": wave_cpu[w % len(wave_cpu)], "memory": "512Mi"}),
            scheduling_group="hi", priority_class_name="high"))
    nv = O.Pod("nv-000", requests=req(1000, "512Mi"),
               scheduling_group="nv", priority_class_name="sacred")
    tp = O.Pod("tp-000", requests=Res.parse(
        {"cpu": wave_cpu[0], "memory": "512Mi"}), scheduling_group="tp",
        priority_class_name="high", topology_spread=[
            O.TopologySpreadConstraint(
                max_skew=1, topology_key=L.ZONE,
                when_unsatisfiable="DoNotSchedule", group="tp")]) \
        if topo else None
    for p in hi + [nv] + ([tp] if topo else []):
        kube.create(p)
    return SimpleNamespace(kube=kube, env=env, nodes=nodes, wave=hi,
                           never=nv, topo=tp)


# ---------------------------------------------------------------------------
# the sharded scan (K10): kernel-input cases, the pipeline fuzz, and the
# bodies of spawned mesh ranks (parallel/ranks.py imports them by name)
# ---------------------------------------------------------------------------

def mesh_rand_arrays(seed: int, T: int, D: int, Z: int, C: int, G: int,
                     E: int, P: int) -> Dict:
    """Seeded random kernel inputs at an arbitrary shape: a numpy copy of
    the reference repository's ``tests/test_mesh_solve.py``
    ``_rand_inputs`` (the same arrays for the same seed)."""
    rng = np.random.RandomState(seed)
    lim = np.where(rng.rand(P, D) < 0.5,
                   rng.randint(1 << 6, 1 << 12, size=(P, D)),
                   -1).astype(np.int64)
    return dict(
        A=rng.randint(1, 1 << 16, size=(T, D)).astype(np.int64),
        avail_zc=rng.rand(T, Z * C) < 0.8,
        R=rng.randint(1, 1 << 8, size=(G, D)).astype(np.int64),
        n=rng.randint(1, 40, size=(G,)).astype(np.int64),
        F=rng.rand(G, T) < 0.7,
        agz=np.ones((G, Z), bool),
        agc=np.ones((G, C), bool),
        admit=rng.rand(G, P) < 0.9,
        daemon=np.zeros((G, P, D), np.int64),
        pool_types=rng.rand(P, T) < 0.9,
        pool_agz=np.ones((P, Z), bool),
        pool_agc=np.ones((P, C), bool),
        pool_limit=lim,
        pool_used0=np.zeros((P, D), np.int64),
        ex_alloc=rng.randint(1 << 10, 1 << 16, size=(E, D)).astype(np.int64),
        ex_used0=np.zeros((E, D), np.int64),
        ex_compat=rng.rand(G, E) < 0.5)


def mesh_fixture_arrays() -> Dict:
    """The reference repository's ``tests/test_mesh_solve.py`` module
    fixture (T=45, D=4, Z=3, C=2, G=12, E=2, P=2; n_max 64), in numpy."""
    rng = np.random.RandomState(5)
    T, D, Z, C, G, E, P = 45, 4, 3, 2, 12, 2, 2
    return dict(
        A=rng.randint(1, 1 << 16, size=(T, D)).astype(np.int64),
        avail_zc=rng.rand(T, Z * C) < 0.8,
        R=rng.randint(1, 1 << 8, size=(G, D)).astype(np.int64),
        n=rng.randint(1, 40, size=(G,)).astype(np.int64),
        F=rng.rand(G, T) < 0.7,
        agz=np.ones((G, Z), bool),
        agc=np.ones((G, C), bool),
        admit=np.ones((G, P), bool),
        daemon=np.zeros((G, P, D), np.int64),
        pool_types=rng.rand(P, T) < 0.9,
        pool_agz=np.ones((P, Z), bool),
        pool_agc=np.ones((P, C), bool),
        pool_limit=np.full((P, D), -1, np.int64),
        pool_used0=np.zeros((P, D), np.int64),
        ex_alloc=rng.randint(1 << 10, 1 << 16, size=(E, D)).astype(np.int64),
        ex_used0=np.zeros((E, D), np.int64),
        ex_compat=rng.rand(G, E) < 0.5)


#: the sharded scan's cases: the reference's mesh test shapes (its module
#: fixture, its fuzz shapes at their seeds), the fixture with minValues
#: floors (type mesh only), and a fuzz shape with the hazards: groups of
#: n = 0, a group with no candidate type, a zero request row (BIG
#: headroom on 40 open slots: wrapping prefixes, negative takes) and a
#: zero-R column; two types over four ranks (two shards all padding); and
#: more existing nodes than a slot shard holds, small ones, under pool
#: limits (a later slot shard starts inside the existing rows, and new
#: nodes of a limited pool sit on two shards of the 4 x 1 layout)
MESH_CASES = ("fixture", "fuzz_e0", "fuzz_wide", "min_values", "hazards",
              "few_types", "existing_split")

#: the layouts a case runs on 4 ranks: the type mesh (1 x 4), pods x
#: types (2 x 2) and the slot split alone (4 x 1)
MESH_LAYOUTS = (("tp", 1), ("dp2", 2), ("dp4", 4))


def mesh_case(name: str) -> Tuple[Dict, Dict]:
    """(arrays, statics n_max/E/P/V) of one sharded-scan case."""
    if name not in MESH_CASES:
        raise ValueError(f"unknown mesh case {name!r}; one of {MESH_CASES}")
    if name in ("fixture", "min_values"):
        arrays = mesh_fixture_arrays()
        st = dict(n_max=64, E=2, P=2, V=0)
        if name == "min_values":
            rng = np.random.RandomState(11)
            T, P, K, V = 45, 2, 2, 3
            arrays.update(
                mv_floor=rng.randint(1, 4, size=(P, K)).astype(np.int64),
                mv_pairs_t=np.tile(np.arange(T, dtype=np.int64), (K, 1)),
                mv_pairs_v=rng.randint(0, V, size=(K, T)).astype(np.int64))
            st["V"] = V
        return arrays, st
    if name == "fuzz_e0":
        return (mesh_rand_arrays(38, T=17, D=4, Z=2, C=2, G=7, E=0, P=1),
                dict(n_max=33, E=0, P=1, V=0))
    if name == "few_types":
        return (mesh_rand_arrays(91, T=2, D=4, Z=2, C=2, G=5, E=1, P=1),
                dict(n_max=20, E=1, P=1, V=0))
    if name == "existing_split":
        arrays = mesh_rand_arrays(23, T=37, D=4, Z=2, C=2, G=9, E=40, P=2)
        rng = np.random.RandomState(24)
        arrays["ex_alloc"] = rng.randint(1 << 8, 1 << 10, size=(40, 4)
                                         ).astype(np.int64)
        arrays["A"] = rng.randint(300, 900, size=(37, 4)).astype(np.int64)
        # pool 0's limit binds after 11 nodes; pool 1 opens the next 5
        arrays["pool_limit"] = np.array([[3000, -1, -1, -1],
                                         [-1, 5000, -1, -1]], np.int64)
        return arrays, dict(n_max=24, E=40, P=2, V=0)
    arrays = mesh_rand_arrays(69, T=101, D=4, Z=3, C=2, G=20, E=5, P=3)
    if name == "hazards":
        # group 0 opens ~40 nodes (about one pod fits a node), so the zero
        # request row of group 9 (admitted everywhere) sees BIG headroom
        # on more than 16 open slots: its prefixes wrap int64
        arrays["R"][0] = 30000
        arrays["n"][[0, 9]] = 39
        arrays["n"][[3, 7]] = 0
        arrays["F"][5] = False
        arrays["R"][9] = 0
        arrays["admit"][9] = True
        arrays["R"][11, 1] = 0
    return arrays, dict(n_max=50, E=5, P=3, V=0)


def mesh_outputs(takes, leftover, carry) -> Dict:
    """A sharded solve's outputs as numpy arrays (num_nodes as [1])."""
    out = dict(takes=takes, leftover=leftover, **carry._asdict())
    return {k: np.asarray(v.cpu()).reshape(1) if k == "num_nodes"
            else np.asarray(v.cpu()) for k, v in out.items()}


def pipeline_api(pkg=None):
    """The objects the pipeline fuzz is built from, as a namespace: the
    ``labels``, ``objects``, ``resources`` and fake ``environment``
    modules and ``solver.types``. By default this package's; a test
    passes the reference package's modules in the same shape."""
    from types import SimpleNamespace
    if pkg is not None:
        return pkg
    from .apis import labels as L
    from .apis import objects as obj
    from .apis import resources as res
    from .fake import environment as env
    from .solver import types as types_
    return SimpleNamespace(L=L, obj=obj, res=res, env=env, types=types_)


def fuzz_scenario(ns, env, seed: int):
    """The pipeline fuzz's seeded scenario (the reference repository's
    ``tests/test_solver_equivalence.py`` generator): one to three pools
    (category / capacity-type requirements, taints, CPU limits, weights),
    one to five pod signatures (selectors, tolerations), up to three
    existing nodes; built from ``ns`` (``pipeline_api``)."""
    import random
    L = ns.L
    rng = random.Random(seed)
    pools = []
    for i in range(rng.randint(1, 3)):
        reqs = []
        if rng.random() < 0.4:
            reqs.append({"key": L.INSTANCE_CATEGORY, "operator": "In",
                         "values": rng.sample(["c", "m", "r", "t"], 2)})
        if rng.random() < 0.3:
            reqs.append({"key": L.CAPACITY_TYPE, "operator": "In",
                         "values": [rng.choice(["spot", "on-demand"])]})
        taints = [ns.obj.Taint("dedicated", "NoSchedule", "x")] \
            if rng.random() < 0.3 else []
        limits = {"cpu": str(rng.randint(8, 64))} \
            if rng.random() < 0.3 else None
        pools.append(env.nodepool(
            f"pool-{seed}-{i}", requirements=reqs, taints=taints,
            limits=limits, weight=rng.randint(0, 100)))
    pods = []
    for j in range(rng.randint(1, 5)):
        kw = {}
        if rng.random() < 0.4:
            kw["node_selector"] = rng.choice([
                {L.ARCH: "arm64"}, {L.ARCH: "amd64"},
                {L.ZONE: "us-west-2b"},
                {L.CAPACITY_TYPE: "spot"},
                {L.INSTANCE_SIZE: "2xlarge"},
            ])
        if rng.random() < 0.3:
            kw["tolerations"] = [ns.obj.Toleration(key="dedicated",
                                                   operator="Exists")]
        pods += ns.env.make_pods(
            rng.randint(1, 60),
            cpu=rng.choice(["100m", "250m", "500m", "1", "2", "7"]),
            memory=rng.choice(["128Mi", "1Gi", "4Gi", "30Gi"]),
            prefix=f"r{seed}-{j}", **kw)
    zones = [z.name for z in
             (env.ec2.zones if hasattr(env, "ec2") else env.zones)]
    existing = []
    for e in range(rng.randint(0, 3)):
        existing.append(ns.types.ExistingNode(
            name=f"ex-{seed}-{e}",
            labels={L.ARCH: rng.choice(["amd64", "arm64"]), L.OS: "linux",
                    L.ZONE: rng.choice(zones)},
            allocatable=ns.res.Resources.parse({
                "cpu": str(rng.randint(2, 16)),
                "memory": f"{rng.randint(4, 64)}Gi", "pods": 58})))
    return env.snapshot(pods, pools, existing_nodes=existing)


def min_values_scenario(ns, env, seed: int):
    """The pipeline fuzz's minValues shape (the reference repository's
    ``tests/test_solver_equivalence.py`` ``test_min_values_floors`` and
    ``_two_keys``): a pool whose family (and, for odd seeds, size) must
    keep several values on every node, at the fuzz's size."""
    import random
    L = ns.L
    rng = random.Random(seed)
    reqs = [{"key": L.INSTANCE_FAMILY, "operator": "Exists",
             "minValues": rng.randint(2, 5)}]
    if seed % 2:
        reqs.append({"key": L.INSTANCE_SIZE, "operator": "Exists",
                     "minValues": 2})
    pods = ns.env.make_pods(rng.randint(20, 120), cpu="500m",
                            memory="1Gi", prefix=f"mv{seed}a") \
        + ns.env.make_pods(rng.randint(5, 40), cpu="2", memory="4Gi",
                           prefix=f"mv{seed}b")
    return env.snapshot(pods, [env.nodepool(f"mv-{seed}",
                                            requirements=reqs)])


def priority_scenario(ns, env, seed: int):
    """Signatures spread over three PriorityClasses (one the global
    default) under a pool whose CPU limit binds, a few existing nodes
    (the port's ``tests/test_torch_pipeline.py`` priority scenario).
    Returns the snapshot with its ``priority_classes`` set (Q = 1)."""
    import random
    L = ns.L
    rng = random.Random(seed)
    pcs = [ns.obj.PriorityClass("low", value=1),
           ns.obj.PriorityClass("mid", value=50, global_default=True),
           ns.obj.PriorityClass("high", value=1000)]
    pods = []
    for j in range(rng.randint(4, 8)):
        grp = ns.env.make_pods(
            rng.randint(1, 40), cpu=rng.choice(["250m", "500m", "1", "2"]),
            memory=rng.choice(["512Mi", "1Gi", "4Gi"]),
            prefix=f"q{seed}-{j}")
        cls = rng.choice(["low", "mid", "high", ""])
        for p in grp:
            p.priority_class_name = cls
        pods += grp
    ns.obj.resolve_pod_priorities(pods, pcs)
    existing = [ns.types.ExistingNode(
        name=f"qx-{seed}-{e}", labels={L.ARCH: "amd64", L.OS: "linux"},
        allocatable=ns.res.Resources.parse({
            "cpu": str(rng.randint(2, 8)), "memory": "16Gi", "pods": 58}))
        for e in range(rng.randint(0, 3))]
    snap = env.snapshot(pods, [env.nodepool(
        f"prio-{seed}", limits={"cpu": str(rng.randint(8, 40))})],
        existing_nodes=existing)
    snap.priority_classes = pcs
    return snap


#: the solver cases of a mesh: the pipeline fuzz's seeds, its minValues
#: shape, a priority snapshot and a small pods x types snapshot
MESH_FUZZ_SEEDS = tuple(range(20))


def mesh_dp2_snapshot(ns, env, n_pods: int = 300):
    """A small snapshot that the pods x types shape takes when its slot
    floor is 0: config 2's pod mix at ``n_pods``, one pool with a CPU
    limit that binds (the pool caps' prefixes cross the slot shards)."""
    L = ns.L
    mk = ns.env.make_pods
    n_small, n_med = int(n_pods * 0.6), int(n_pods * 0.25)
    pods = (mk(n_small, cpu="250m", memory="512Mi", prefix="dps")
            + mk(n_med, cpu="1", memory="2Gi", prefix="dpm")
            + mk(n_pods - n_small - n_med, cpu="2", memory="4Gi",
                 prefix="dpt", node_selector={L.CAPACITY_TYPE: "spot"}))
    return env.snapshot(pods, [env.nodepool("dp2-pool",
                                            limits={"cpu": "160"})])


def _fp_digest(res) -> str:
    import hashlib
    return hashlib.sha256(repr(res.decision_fingerprint()).encode()
                          ).hexdigest()


def _mesh_stats(solver) -> Dict:
    s = solver.last_dispatch_stats
    return {k: s.get(k) for k in ("kernel", "mesh_kernel", "ndp", "ntp",
                                  "backend", "placement", "reason",
                                  "launches")}


def mesh_cases_rank(rank: int, world: int, names=MESH_CASES,
                    layouts=MESH_LAYOUTS, device: str = "cpu") -> Dict:
    """A spawned rank's body: every sharded-scan case on every layout,
    by the per-rank kernels (their plain parts on the CPU) and by the
    plain version; {(case, layout, plain): outputs}."""
    from .parallel.mesh import MeshComm, solve_scan_sharded, \
        solve_scan_sharded2
    comm = MeshComm()
    out = {}
    for name in names:
        arrays, st = mesh_case(name)
        for lay, ndp in layouts:
            if ndp > 1 and st["V"]:
                continue
            for plain in (False, True):
                if ndp == 1:
                    r = solve_scan_sharded(arrays, comm, st["n_max"], st["E"],
                                           st["P"], st["V"], device=device,
                                           plain=plain)
                else:
                    r = solve_scan_sharded2(arrays, comm.layout(ndp),
                                            st["n_max"], st["E"], st["P"],
                                            device=device, plain=plain)
                out[(name, lay, plain)] = mesh_outputs(*r)
    return out


def mesh_solver_rank(rank: int, world: int, seeds=MESH_FUZZ_SEEDS,
                     warm_pods: int = 2000) -> Dict:
    """A spawned rank's body: ``CUDASolver(device="cpu", mesh=comm)`` on
    the pipeline fuzz's seeds, its minValues shape, a priority snapshot
    and a small pods x types snapshot (decision fingerprints and the
    dispatch evidence), then three warm ticks of a small warm cluster
    (placement full, patch after a rows tick, reuse after a clean one),
    each against a single-device solve from scratch on the same
    snapshot."""
    from .fake.environment import Environment, reset_pod_counter
    from .parallel.mesh import MeshComm
    from .solver import CUDASolver
    comm = MeshComm()
    api = pipeline_api()
    env = Environment()
    solver = CUDASolver(device="cpu", mesh=comm)
    out: Dict = {}

    def run(key, build, s=solver):
        reset_pod_counter()
        res = s.solve(build())
        out[key] = (res.decision_fingerprint(), _mesh_stats(s))

    for seed in seeds:
        run(("fuzz", seed), lambda: fuzz_scenario(api, env, seed))
    for seed in (0, 1):
        run(("min_values", seed), lambda: min_values_scenario(api, env, seed))
    run(("priority", 0), lambda: priority_scenario(api, env, 0))
    run(("dp2", 0), lambda: mesh_dp2_snapshot(api, env),
        CUDASolver(device="cpu", mesh=comm, dp2_min_slots=0))
    snapshot, tick = warm_cluster(pods=warm_pods)
    warm = CUDASolver(device="cpu", mesh=comm)
    ticks = []
    for t in range(3):
        if t == 1:
            tick(binds=True)
        snap = snapshot()
        res = warm.solve(snap)
        fresh = CUDASolver(device="cpu", incremental=False).solve(snap)
        ticks.append(dict(
            same=res.decision_fingerprint() == fresh.decision_fingerprint(),
            cache=warm.last_phase_stats.get("cache"), **_mesh_stats(warm)))
    out["warm"] = ticks
    return out


def mesh_fail_rank(rank: int, world: int) -> None:
    """A spawned rank's body: a sharded solve in which rank 1 raises at
    its second group step (the others then wait in a collective)."""
    from .parallel.mesh import MeshComm, solve_scan_sharded

    def fail(name, args, st, ref):
        if rank == 1 and name == "mesh_commit" and args[0] == 1:
            raise RuntimeError("rank 1 fails mid-solve")

    arrays, st = mesh_case("fixture")
    solve_scan_sharded(arrays, MeshComm(), st["n_max"], st["E"], st["P"],
                       device="cpu", check=fail)


def config2(env, n_pods: int = 50_000):
    """BASELINE config 2 (a copy of the reference repository's
    ``bench.build_config2``): 60% small, 25% medium, 10% spot-pinned and
    5% arm64-pinned pods under one pool over the full catalog."""
    from .apis import labels as L
    from .fake.environment import make_pods as mk
    n_small, n_med = int(n_pods * 0.60), int(n_pods * 0.25)
    n_spot = int(n_pods * 0.10)
    n_arm = n_pods - n_small - n_med - n_spot
    pods = (mk(n_small, cpu="250m", memory="512Mi", prefix="small")
            + mk(n_med, cpu="1", memory="2Gi", prefix="med")
            + mk(n_spot, cpu="2", memory="4Gi", prefix="spot",
                 node_selector={L.CAPACITY_TYPE: "spot"})
            + mk(n_arm, cpu="500m", memory="1Gi", prefix="arm",
                 node_selector={L.ARCH: "arm64"}))
    return env.snapshot(pods, [env.nodepool("bench-pool")])


#: the mesh cells: (name, config-2 pods, the mesh solver's dp2_min_slots
#: (None: the default 2,048)). Both run at the slot bucket their solves
#: settle at: 256 at 50,000 pods, 1,024 at 500,000 (960 nodes), where the
#: default floor keeps the type mesh, as the reference's routing does; a
#: floor of 1,024 puts the 500,000-pod cell on the pods x types mesh.
MESH_CELLS = (("tp", 50_000, None), ("dp2", 500_000, 1024))

#: the minValues snapshots of the card's mesh phase (the pipeline fuzz's
#: minValues shape at the fuzz's size: the type mesh with h1 maxima)
MESH_MV_SEEDS = (0, 1)


def mesh_cell_solver(comm, dp2_min_slots=None, device=None):
    """The mesh solver of a cell (``MESH_CELLS``), or with ``comm=None``
    the single-device solver."""
    from .solver import CUDASolver
    if comm is None:
        return CUDASolver(incremental=False, device=device)
    kw = {} if dp2_min_slots is None else dict(dp2_min_slots=dp2_min_slots)
    return CUDASolver(mesh=comm, force_mesh=True, device=device, **kw)


def mesh_kernel_check(rank: int, records: list, check_ranks=(0,)):
    """A ``check`` hook for ``dispatch_mesh``: on the ranks of
    ``check_ranks``, every kernel launch's buffers against its plain
    part's, appended to ``records`` as (kernel, args, differing buffers,
    max |diff|); None on the other ranks (they only join the
    collectives)."""
    import torch
    if rank not in check_ranks:
        return None

    def check(name, args, st, ref):
        if st.device.type == "cuda":
            torch.cuda.synchronize()
        diffs, err = [], 0
        for nm, t in st.buffers().items():
            r = ref.buffers()[nm]
            if not torch.equal(t, r):
                diffs.append(nm)
                err = max(err, int((t.long() - r.long()).abs().max()))
        records.append((name, tuple(int(a) for a in args), diffs, err))
    return check


class ShardStub:
    """One process's stand-in for the layout of slot shard ``dp_idx`` of
    ``ndp`` (and type shard ``tp_idx`` of ``ntp``, default one), for
    holding that shard's kernels against their plain parts, or timing
    them, with no process group: the max over the type shards is the
    identity, the dp sums add nothing, and the earlier shards' prefixes
    are the given numbers (``before``: the P pools', then the fill's),
    wrapping ones included. Decisions under it mean nothing; each
    launch's agreement with its plain part does."""

    def __init__(self, ndp: int, dp_idx: int, before, ntp: int = 1,
                 tp_idx: int = 0):
        self.ndp, self.ntp, self.dp_idx, self.tp_idx = ndp, ntp, dp_idx, \
            tp_idx
        self.rank = dp_idx * ntp + tp_idx
        self.before = [int(b) for b in before]
        self._base, self.calls, self.seconds = self, 0, 0.0
        self._pools_next = True

    def axis_max(self, x):
        return x

    def dp_sum(self, x):
        return x

    def dp_before(self, x):
        """The pools' prefixes, then the fill's, by turns (the order of
        the step loop's two all_gathers)."""
        import torch
        vals = self.before[:-1] if self._pools_next else self.before[-1:]
        self._pools_next = not self._pools_next
        return torch.tensor(vals, dtype=x.dtype, device=x.device)


#: the slot shards a card test holds against their plain parts: (case,
#: ndp, dp index); each starts inside the existing rows or past them
MESH_LATER_SHARDS = (("existing_split", 2, 1), ("existing_split", 4, 2),
                     ("existing_split", 4, 3), ("hazards", 2, 1))

#: the earlier shards' prefixes those checks feed (per pool, then the
#: fill's), small and at the edge of int64 (the sums wrap)
MESH_BEFORES = {"small": lambda P: [3 * (p + 1) for p in range(P)] + [7],
                "wrap": lambda P: [(1 << 63) - 2 - p for p in range(P)]
                + [(1 << 63) - 5]}


#: the fill (``mesh_fill``) states ``chip_smoke.py`` times: (the rank's
#: rows, pools, existing rows at its head): the tp cell's shard (256), the
#: dp2 cell's (512), K11's (2,112) and the world-1 ceiling's (4,224), P =
#: 1 or 8 pools, every other one with a limit; and K11's first shard as
#: the ceiling cuts it (128 existing nodes)
FILL_SHAPES = ((256, 1, 0), (256, 8, 0), (512, 1, 0), (512, 8, 0),
               (2112, 1, 0), (2112, 8, 0), (4224, 1, 0), (4224, 8, 0),
               (2112, 1, 128))


def fill_state(Nl: int, P: int, *, seed: int = 0, limited: bool = True,
               E: int = 0, slot0: int = 0, before: str = None, K: int = 0,
               V: int = 0, device="cpu"):
    """A rank's ``MeshState`` at the entry of group 1's fill, made from
    ``seed``: ``Nl`` slot rows with global ids from ``slot0``, the first
    ``E`` global rows existing nodes (some dead, some incompatible, with
    their used rows), the other rows free or open in one of ``P`` pools
    (every other pool with a limit that binds inside the rows when
    ``limited``; one pool the group does not admit), and the headroom
    launch's k: 0 on free rows, existing rows and rows of a pool the group
    does not admit (as that launch writes), else small, with 1 << 60 on a
    few rows (a zero request row's headroom: prefixes that wrap int64).
    ``before`` names ``MESH_BEFORES`` prefixes of earlier shards (None:
    zeros); ``K`` / ``V`` add minValues floors and the step's per-value
    maxima h1. The pool state's kernels read nothing else. Returns (the
    state, the group)."""
    import torch

    from .ops import mesh_cuda as mc
    from .ops.ffd_torch import KernelInputs
    rng = np.random.RandomState(seed)
    T, D, Z, C, G = 4, 4, 2, 2, 2
    g = 1
    R = rng.randint(1, 1 << 6, size=(G, D)).astype(np.int64)
    admit = np.ones((G, P), bool)
    if P > 1:
        admit[g, P - 1] = False
    lim = np.full((P, D), -1, np.int64)
    if limited:
        lim[::2, 1] = rng.randint(1 << 12, 1 << 14, size=len(lim[::2]))
    ex_alloc = rng.randint(1 << 12, 1 << 16, size=(Nl, D)).astype(np.int64)
    ex_used = (ex_alloc * rng.rand(Nl, D)).astype(np.int64)
    arrays = dict(
        A=rng.randint(1, 1 << 16, size=(T, D)).astype(np.int64),
        avail_zc=np.ones((T, Z * C), bool), R=R,
        n=np.array([0, max(1, Nl * 3)], np.int64),
        F=np.ones((G, T), bool), agz=np.ones((G, Z), bool),
        agc=np.ones((G, C), bool), admit=admit,
        daemon=np.zeros((G, P, D), np.int64),
        pool_types=np.ones((P, T), bool), pool_agz=np.ones((P, Z), bool),
        pool_agc=np.ones((P, C), bool), pool_limit=lim,
        pool_used0=rng.randint(0, 1 << 10, size=(P, D)).astype(np.int64),
        ex_alloc=ex_alloc, ex_used0=ex_used,
        ex_compat=rng.rand(G, Nl) < 0.7)
    if K:
        arrays.update(
            mv_floor=rng.randint(0, V + 2, size=(P, K)).astype(np.int64),
            mv_pairs_t=np.zeros((K, 1), np.int64),
            mv_pairs_v=np.zeros((K, 1), np.int64))
    dev = torch.device(device)
    inp = KernelInputs(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                          for k, v in arrays.items()})
    st = mc.MeshState(inp, E=E, P=P, V=V, N=max(E, slot0 + Nl), slot0=slot0)
    ex = slot0 + np.arange(Nl) < E
    pool = np.where(rng.rand(Nl) < 0.25, -1, rng.randint(0, P, size=Nl))
    pool = np.where(ex, -2, pool).astype(np.int32)
    alive = np.where(ex, rng.rand(Nl) < 0.8, pool >= 0)
    k = rng.randint(0, 40, size=Nl).astype(np.int64)
    k[rng.rand(Nl) < 0.03] = 1 << 60
    k = np.where((pool >= 0) & admit[g, np.clip(pool, 0, P - 1)], k, 0)
    c = st.carry
    c.pool.copy_(torch.from_numpy(pool))
    c.alive.copy_(torch.from_numpy(alive))
    c.used.copy_(torch.from_numpy(np.where(
        ex[:, None], ex_used, rng.randint(0, 1 << 10, size=(Nl, D)))))
    st.k.copy_(torch.from_numpy(k))
    if K:
        st.h1.copy_(torch.from_numpy(rng.randint(
            0, 60, size=(Nl, K, V)).astype(np.int64)))
    if before is not None:
        st.before.copy_(torch.tensor(MESH_BEFORES[before](P),
                                     dtype=torch.int64))
    return st, g


#: ``mesh_new_caps``' shapes on the main paths: (name, the rank's types,
#: groups, pools, Z, C, D): config 2's tp cell and 500,000-pod cell at
#: world 1 (T = 812, G = 4), the tp cell's rank on four gloo ranks (Tl =
#: 203), the 500,000-pod cell's on 2 x 2 (Tl = 406), K11's shard (Tl =
#: 406, G = 64) and the distributed ceiling at world 1 (T = 812, G = 64)
CAPS_SHAPES = (("tp", 812, 4, 1, 4, 3, 8), ("tp_rank", 203, 4, 1, 4, 3, 8),
               ("dp2_rank", 406, 4, 1, 4, 3, 8),
               ("k11", 406, 64, 1, 3, 2, 4), ("ceiling", 812, 64, 1, 3, 2, 4))


#: ``mesh_new_caps``' test states: (name, ``caps_state`` shape, K) at
#: ``CAPS_SHAPES``, with minValues floors (K keys over 5 values), past
#: eight dimensions (the global rows), past the 64-bit offering word, at
#: exactly 64 pairs (bit 63, the sign bit, with floors) and past 1,024
#: types (two passes a CTA)
CAPS_CASES = ([(name, dict(zip("TGPZCD", sh)), 0) for name, *sh in CAPS_SHAPES]
              + [("tp_floors", dict(T=203, G=4, P=2, Z=4, C=3, D=8), 3),
                 ("ceiling_floors", dict(T=812, G=6, P=1, Z=3, C=2, D=4), 2),
                 ("wide_d", dict(T=300, G=3, P=2, Z=3, C=2, D=11), 0),
                 ("past_word", dict(T=150, G=3, P=2, Z=22, C=3, D=4), 0),
                 ("word_64", dict(T=150, G=3, P=2, Z=16, C=4, D=4), 2),
                 ("wide_types", dict(T=1500, G=3, P=1, Z=4, C=3, D=8), 0)])


def caps_state(T: int, G: int, P: int, Z: int, C: int, D: int, *,
               seed: int = 0, K: int = 0, V: int = 0, device="cpu"):
    """A rank's ``MeshState`` with random inputs from ``seed`` for
    ``mesh_new_caps`` (which reads A, avail_zc, R, F, agz, agc, daemon,
    pool_types, pool_agz, pool_agc and the minValues pairs): T types of
    D >= 2 dimensions (one no group requests, and group 1 none at all,
    whose headroom is BIG; daemon rows above some types' allocatable, so
    quotients go negative), sparse offerings over Z * C pairs, groups and
    pools that narrow zones and capacity types (one group takes no zone);
    ``K`` keys over ``V`` values add floors with 2T pairs, some pointing
    at the dump value V (another shard's type)."""
    import torch

    from .ops import mesh_cuda as mc
    from .ops.ffd_torch import KernelInputs
    rng = np.random.RandomState(seed)
    R = rng.randint(1, 1 << 12, size=(G, D)).astype(np.int64)
    R[:, 0] = 0
    R[rng.rand(G, D) < 0.1] = 0
    R[::7, 1] = 1
    if G > 2:
        R[1] = 0                              # no request: headroom BIG
    A = rng.randint(1, 1 << 20, size=(T, D)).astype(np.int64)
    agz = rng.rand(G, Z) < 0.8
    agz[-1] = False
    arrays = dict(
        A=A, avail_zc=rng.rand(T, Z * C) < 0.3, R=R,
        n=np.ones(G, np.int64), F=rng.rand(G, T) < 0.7, agz=agz,
        agc=rng.rand(G, C) < 0.8, admit=np.ones((G, P), bool),
        daemon=rng.randint(0, 1 << 16, size=(G, P, D)).astype(np.int64),
        pool_types=rng.rand(P, T) < 0.9, pool_agz=rng.rand(P, Z) < 0.9,
        pool_agc=rng.rand(P, C) < 0.9,
        pool_limit=np.full((P, D), -1, np.int64),
        pool_used0=np.zeros((P, D), np.int64),
        ex_alloc=np.zeros((1, D), np.int64),
        ex_used0=np.zeros((1, D), np.int64),
        ex_compat=np.zeros((G, 1), bool))
    arrays["A"][::5] = rng.randint(1, 1 << 10, size=arrays["A"][::5].shape)
    if K:
        M = 2 * T
        pt = rng.randint(0, T, size=(K, M)).astype(np.int64)
        pv = rng.randint(0, V + 1, size=(K, M)).astype(np.int64)
        arrays.update(mv_floor=rng.randint(0, V + 2, size=(P, K))
                      .astype(np.int64), mv_pairs_t=pt, mv_pairs_v=pv)
    dev = torch.device(device)
    inp = KernelInputs(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                          for k, v in arrays.items()})
    return mc.MeshState(inp, E=0, P=P, V=V, N=1, slot0=0)


#: ``pack_outputs``' odd shapes: (T, Z, C, N, G, P, D) with T, N and G*N
#: odd, so the bool segments straddle words and the takes end in half a
#: word; config 2's widths last (T = 812, N = 256, G = 4)
PACK_SHAPES = ((813, 3, 2, 7, 3, 2, 4), (813, 3, 2, 33, 5, 1, 8),
               (37, 4, 3, 5, 1, 3, 3), (1, 1, 1, 1, 1, 1, 1),
               (812, 4, 3, 256, 4, 1, 8))


def pack_case(T: int, Z: int, C: int, N: int, G: int, P: int, D: int, L: int,
              *, seed: int = 0, bail: bool = False, device="cpu"):
    """Random inputs of ``pack_outputs_lanes`` from ``seed``: (takes [L, G,
    N] int32 over the whole int32 range, leftover [L, G], a ``Carry`` of
    [L, ...] fields (int64 used and pool_used over the whole range, pool
    -2 .. P-1 and num_nodes int32, the bools at several densities), and
    with ``bail`` the [L, 1] bail flags, lane 0's set and lane 1's
    clear)."""
    import torch

    from .ops.ffd_torch import Carry
    rng = np.random.RandomState(seed)
    i64 = np.iinfo(np.int64)

    def big(*shape):
        return rng.randint(i64.min, i64.max, size=(L,) + shape,
                           dtype=np.int64)

    def bits(p, *shape):
        return rng.rand(L, *shape) < p

    vals = dict(
        takes=rng.randint(-(1 << 31), 1 << 31, size=(L, G, N),
                          dtype=np.int64).astype(np.int32),
        leftover=big(G), used=big(N, D), types=bits(0.6, N, T),
        zones=bits(0.5, N, Z), ct=bits(0.4, N, C),
        pool=rng.randint(-2, P, size=(L, N)).astype(np.int32),
        alive=bits(0.7, N),
        num_nodes=rng.randint(0, N + 1, size=(L, 1)).astype(np.int32),
        pool_used=big(P, D))
    if bail:
        b = bits(0.5, 1)
        b[0] = True
        if L > 1:
            b[1] = False
        vals["bail"] = b
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in vals.items()}
    carry = Carry(*[t[f] for f in Carry._fields])
    return t["takes"], t["leftover"], carry, t.get("bail")


#: ``unpack_bits``' widths: rows shorter than one 16-byte unit, one unit
#: and either side of it, units whose 16 bits straddle two words (from bit
#: 48, 49 or 50 of a word), one word and either side of it, odd widths
#: (333, the catalog's 813) and config 2's bool section (13,843 bits)
UNPACK_WIDTHS = (1, 15, 16, 17, 48, 49, 50, 63, 64, 65, 333, 813, 13_843)


def unpack_case(nbits: int, L: int, *, seed: int = 0, pad: int = 0,
                device="cpu"):
    """Random words of ``unpack_bits_lanes`` from ``seed``: the [L,
    nwords(nbits)] view of the first columns of a [L, nwords(nbits) + pad]
    int64 stack (lanes nwords + pad words apart; with pad = 0 the last
    lane's last word ends the tensor). Every word is drawn over the whole
    int64 range, so bit 63 is set in about half of them, and the bits past
    nbits are random too."""
    import torch

    from .ops.hostpack import nwords
    rng = np.random.RandomState(seed)
    i64 = np.iinfo(np.int64)
    nw = nwords(nbits)
    stack = rng.randint(i64.min, i64.max, size=(L, nw + pad), dtype=np.int64)
    stack[:, 0] |= np.int64(i64.min)   # bit 63 set in every lane
    return torch.from_numpy(stack).to(device)[:, :nw]


def mesh_shard_check(case: str, ndp: int, dp_idx: int, before: str,
                     device="cpu", **state_kw):
    """Every kernel launch of the first four group steps of slot shard
    ``dp_idx`` of ``ndp`` of a ``MESH_CASES`` case (slot0 > 0, the fill in
    its three phases) against its plain part from the same entry state,
    under a ``ShardStub`` with the ``MESH_BEFORES`` prefixes; ``state_kw``
    goes to the ``MeshState`` (``cluster``, ``threads``: the commit's
    shape). Returns (the ``mesh_kernel_check`` records, the shard's
    state)."""
    import torch

    from .ops import mesh_cuda as mc
    from .ops.ffd_torch import KernelInputs
    from .parallel import mesh as pm
    arrays, st = mesh_case(case)
    if st["V"]:
        raise ValueError(f"{case}: the slot split takes no minValues floors")
    lay = ShardStub(ndp, dp_idx, MESH_BEFORES[before](st["P"]))
    N = st["E"] + st["n_max"]
    Np = -(-N // ndp) * ndp
    T = np.asarray(arrays["A"]).shape[0]
    names = [f for f in pm.FIELDS if arrays.get(f) is not None]
    inp = KernelInputs(**pm._shard_inputs(arrays, lay, names, T, Np, Np, 0,
                                          torch.device(device)))
    state = mc.MeshState(inp, E=st["E"], P=st["P"], V=0, N=N,
                         slot0=dp_idx * (Np // ndp), **state_kw)
    records: list = []
    pm._mesh_scan(state, lay, check=mesh_kernel_check(0, records))
    return records, state


def mesh_cell_rank(rank: int, world: int, cells=MESH_CELLS,
                   rounds: int = 3, device=None,
                   mv_seeds=MESH_MV_SEEDS) -> Dict:
    """A spawned rank's body on the card (several ranks may share it):
    per mesh cell, a warm-up ``CUDASolver(mesh=comm).solve`` (its slot
    bucket settles), one dispatch at that bucket whose first four group
    steps rank 0 and the last rank (the last slot and type shard) hold
    kernel by kernel against the plain parts, then ``rounds`` timed
    solves with the launch counters set to 0 just before and read just
    after. Returns per cell
    the decision digest, the dispatch evidence, the solve times (ms), the
    collectives' time per step, the launches and the kernel checks; then
    per ``mv_seeds`` one minValues snapshot's decision digest and
    evidence (``("min_values", seed)``)."""
    import statistics
    import time

    import torch

    from .fake.environment import Environment, reset_pod_counter
    from .models.delta import full_existing_encode
    from .models.encoding import encode_snapshot
    from .ops import ffd_cuda
    from .ops import mesh_cuda as mc
    from .parallel.mesh import MeshComm, dispatch_mesh
    comm = MeshComm()
    env = Environment()
    out: Dict = {}

    def sync(dev):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for name, n_pods, dp2_min in cells:
        reset_pod_counter()
        snap = config2(env, n_pods)
        solver = mesh_cell_solver(comm, dp2_min, device)
        dev = solver.device
        solver.solve(snap)                       # warm-up
        enc = encode_snapshot(snap)
        arrays, stt = solver._prep_device_inputs(
            enc, *full_existing_encode(enc, []), mesh=True)
        records: list = []
        dispatch_mesh(arrays, comm=comm, n_max=solver._bucket, E=stt["E"],
                      P=stt["P"], V=stt["V"], cache={},
                      dp2_min_slots=solver.dp2_min_slots, device=dev,
                      check=mesh_kernel_check(rank, records,
                                              (0, world - 1)))
        sync(dev)
        ffd_cuda.reset_launches()
        times, coll = [], []
        for _ in range(rounds):
            t0 = time.perf_counter()
            res = solver.solve(snap)
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            s = solver.last_dispatch_stats
            coll.append(s["collective_ms"] / s["groups"])
        launches = {k: ffd_cuda.LAUNCHES[k] for k in mc.KERNELS}
        placed = sum(len(n.pod_names) for n in res.new_nodes)
        out[name] = dict(
            fp=_fp_digest(res), stats=_mesh_stats(solver), times_ms=times,
            collective_ms_per_step=statistics.median(coll),
            collectives=solver.last_dispatch_stats["collectives"],
            launches=launches, checks=records, pods=n_pods,
            accounted=placed + len(res.existing_assignments)
            + len(res.unschedulable), nodes=len(res.new_nodes),
            slot_bucket=solver.last_dispatch_stats["slot_bucket"],
            groups=solver.last_dispatch_stats["groups"])
    api = pipeline_api()
    for seed in mv_seeds:
        reset_pod_counter()
        solver = mesh_cell_solver(comm, device=device)
        res = solver.solve(min_values_scenario(api, env, seed))
        out[("min_values", seed)] = dict(fp=_fp_digest(res),
                                         stats=_mesh_stats(solver))
    return out


# ---------------------------------------------------------------------------
# the multi-process mesh (K11): the reference's multi-host shapes and a
# rank body that places only its host's slabs
# ---------------------------------------------------------------------------

#: the reference's multi-host driver shapes (``hack/multihost.py:38-44``):
#: the smoke workload, and the ceiling of 64 groups x >= 15,626 pods (at
#: least 1,000,064 pods, twice the single-process 500,032) over the
#: 812-type catalog, N = 4,224 slots; seed 7
DIST_SMOKE_SHAPE = dict(G=6, T=11, n_max=64, E=24, P=2, Z=3, C=2, D=4,
                        pods_per_group=17)
DIST_CEILING_SHAPE = dict(G=64, T=812, n_max=4096, E=128, P=1, Z=3, C=2,
                          D=4, pods_per_group=15626)
DIST_SEED = 7

#: (hosts, ranks per host) over four ranks: 2 x 2 and 4 x 1 (four slabs)
DIST_LAYOUTS = ((2, 2), (4, 1))

#: the tick sequence of a rank body: (tick, dirty): full, patch, patch,
#: then tick 2 again with nothing dirty (reuse)
DIST_TICKS = ((0, None), (1, ("n", "ex_used0")), (2, ("n", "ex_used0")),
              (2, ()))


def dist_ticks_rank(rank: int, world: int, shape=None, seed: int = DIST_SEED,
                    layouts=DIST_LAYOUTS, ticks=DIST_TICKS,
                    device: str = "cpu", check_ranks=()) -> Dict:
    """A spawned rank's body: per (hosts, L) layout of ``layouts`` the
    rank is local rank ``rank % L`` of host ``rank // L``; it builds only
    its host's slabs of each tick (``distmesh.tick_arrays(slab=)``) and
    runs ``dispatch_dist`` on the layout ``distmesh.dist_dp`` gives, the
    shard resident across the ``ticks``. The first tick of a rank in
    ``check_ranks`` holds its first steps' launches against the plain
    parts. Returns {(hosts, L): [per tick: fingerprint, placement, slab,
    the placed slot fields' rows, timing keys, layout, checks]} and
    {("oracle", tick): the single-device oracle's fingerprint, computed
    inside the process group}."""
    from .parallel import distmesh as dm
    from .parallel.mesh import MeshComm
    shape = DIST_SMOKE_SHAPE if shape is None else shape
    base = MeshComm()
    out: Dict = {}
    for hosts, L in layouts:
        if hosts * L != world:
            raise ValueError(f"{hosts} x {L} ranks on a world of {world}")
        ndp = dm.dist_dp(world, hosts)
        lay = base.layout(ndp)
        cache: dict = {}
        runs = []
        for tick, dirty in ticks:
            Np, lo, hi = dm.slab_rows(shape["n_max"], shape["E"], ndp,
                                      hosts, rank // L)
            arrays, st = dm.tick_arrays(shape, seed, tick, slab=(lo, hi, Np))
            records = [] if rank in check_ranks and not runs else None
            res = dm.dispatch_dist(
                arrays, comm=lay, cache=cache, device=device,
                dirty=None if dirty is None else list(dirty),
                check=None if records is None else
                mesh_kernel_check(0, records), **st)
            d = cache["resident"]["dev"]
            runs.append(dict(
                tick=tick, fp=dm.result_fingerprint(res),
                mode=cache["last_placement"]["mode"],
                fields=sorted(cache["last_placement"]["fields"]),
                slab=(lo, hi, Np), slot0=lay.dp_idx * d["ex_used0"].shape[0],
                rows={f: int(d[f].shape[1 if f == "ex_compat" else 0])
                      for f in ("ex_alloc", "ex_used0", "ex_compat")},
                timing=sorted(cache["last_timing"]),
                mesh=dict(cache["last_mesh"]), tick_seq=cache.get("tick_seq"),
                checks=records))
        out[(hosts, L)] = runs
    for tick in sorted({t for t, _ in ticks}):
        arrays, st = dm.tick_arrays(shape, seed, tick)
        out[("oracle", tick)] = dm.result_fingerprint(
            dm.oracle_out(arrays, device=device, **st))
    return out
