#!/usr/bin/env python3
"""Drive the port's provisioning solve and consolidation search on one
NVIDIA GPU and check them.

    python3 chip_smoke.py                    # on a machine with a CUDA card
    python3 chip_smoke.py --cpu-rehearsal    # plain versions, small, on CPU

Phases (any failure exits non-zero before the result line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: the CUDA kernels of ``karpenter_provider_aws_tpu_torch/csrc``
   from the sources in this checkout (one nvcc per source, all started
   together; sm_90a), with the build time and the ptxas register /
   shared-memory report;
3. kernels against their plain PyTorch versions, byte for byte: the K1
   and K2 kernels on the BASELINE config-2 arena (50,000 mixed pods x the
   full 812-type catalog) and on the synthetic arenas of
   ``karpenter_provider_aws_tpu_torch.examples`` (existing nodes,
   minValues floors, binding pool limits, daemon overhead, two pools, a
   priority section, exhausted slots, an all-zero R column); the K3 bank
   kernels, the checkpointed solve and every (jr, SUF, GL) suffix of
   G=8, CK=2 arenas with existing nodes and with minValues floors, and
   of the 50,000-pod warm-cluster arena (the chunk entries' bank rows
   stored by ``ffd_slot_headroom``, a suffix's pad rows re-stamped by its
   ``pack_outputs`` launch, and that pack with a range of several rows
   against the plain store; rows up to jr untouched); the K2 kernels on
   their lane axis with one lane (config 2 and the warm arena) and with
   five; the K7 kernels (``consol_absorb`` in its three modes,
   ``subset_gather``, the summary rows of a round's last
   ``ffd_group_commit``, whole subset rounds, one of a single lane on a
   cluster of 8) on the synthetic hazard cases
   of ``examples.absorb_case`` / ``subset_case`` (the gather also at the
   odd shapes of ``examples.GATHER_SHAPES``); ``consol_absorb`` in every
   form of its scan (``ABSORB_FORM_SHAPES``: rows in registers, in
   shared memory, in the global scratch), on one lane and 256, K8 at 64
   lanes of 1,000 nodes for G = 16, 64 and 256, every mode at B = 0 (no
   launch) and G = 0, and a subset round of Gq = 0 (no launch, the
   reference's rows);
   both K5 kernels
   (``ffd_fused_headroom``, ``ffd_fused_commit``) block by block on every
   ``examples.FUSED_CASES`` arena at F = 4 (each with a vectorized and a
   sequential block; "striped" also at the catalog's 812 types), on
   the lane axis with one lane and with three lanes that branch apart,
   and one fused dispatch of 65,552 lanes (more than grid y holds),
   each lane equal to the plain solve of its arena; K1's one-launch pack
   at ``examples.PACK_SHAPES`` (bool segments straddling words, odd
   G*N) on 1 and 3 lanes with and without the bail word and on 65,552
   lanes, and ``mesh_new_caps`` at ``examples.CAPS_CASES`` (its shapes,
   minValues floors, D past eight, Z*C past the 64-bit word);
4. the config-2 path: ``CUDASolver(incremental=False)`` solves config 2
   from scratch through ``Solver.solve`` (one warm-up, then timed rounds)
   with every launch counter set to 0 just before and read just after;
   the decisions must fingerprint-equal ``CUDASolver(device="cpu")`` (the
   plain versions) and every pod must be placed or reported;
5. the warm-tick path: ``CUDASolver()`` (incremental) on
   ``examples.warm_cluster(50_000, 0.01)``: a cold solve, 12 warm-up
   ticks with binds, then 60 measured ticks without binds with every
   launch counter set to 0 just before and read just after. Every
   measured tick must be served by a suffix re-solve and fingerprint-
   equal a from-scratch ``CUDASolver(incremental=False)`` solve on the
   card; the first five and the last also the plain versions' solve; the
   bank left resident (its rows stored by the suffixes' headroom launches
   and packs) must equal the plain checkpointed solve's of the last
   tick's arena; a tick launches 1 ``unpack_bits`` and 1 ``pack_outputs``
   and no other kernel of the bank;
6. the consolidation path, ``CUDAConsolidationEvaluator()`` on BASELINE
   config 4 (``examples.config4``): (a) the whole-fleet round of
   ``single_consolidation_device`` at 1,000 nodes (2,000 lanes), (b) the
   prefix round of ``multi_consolidation`` over the first 100 candidates
   (99 lanes), (c) ``single_consolidation_batched`` at 200 nodes, (d) the
   same deletion checks as a heterogeneous batch (the dense path); each
   a warm-up and timed rounds with every launch counter set to 0 just
   before and read just after. Every lane's row or answer must equal the
   plain versions' on the same CUDA tensors, and every decision the plain
   path's: the plain rows (a, b) or the plain evaluator on the CPU (c),
   with every simulate by ``CUDASolver(device="cpu")``;
8. the G-axis path: both K6 kernels (``ffd_pruned_probe``,
   ``ffd_pruned_commit``) against their plain parts over 512 group steps
   of BASELINE config 7 (``examples.config7``, 50,000 pods, 10,000
   signatures) from the first carry, from a mid-scan carry and at S = 1
   (the probe's selection, candidates, headroom and new-node tables);
   the host's enqueue of the G steps (two launches a step) without a
   synchronise beside the card's span; then
   ``CUDASolver()`` solves config 7 on the pruned kernels (one warm-up,
   timed rounds, counters set to 0 just before and read just after)
   with 0 bails, fingerprint-equal to the host engine on the CPU;
   a forced S = 1 solve must bail and be re-solved on the card with
   every slot selected (``reason="pruned_bail"``), fingerprint-equal;
9. the batch path: ``CUDASolver().solve_batch`` on
   ``examples.batch_snapshots`` at B = 8 and 64 (Gp = 128, so F = 4), one
   fused ``_dispatch_many`` of 1 + 2*Gp/4 + 1 launches each, every lane's
   output row byte-equal to its single solve on the card and to the
   plain versions; both K5 kernels block by block on the batch's lanes
   at the cluster size the dispatch takes (every block at B = 8, the
   first four at B = 64);
11. the topology path (run before phase 10, so that its launches and its
   kernels join phase 10's records): every chunk's ``topo_pool_statics``
   (the pool statics of its topology groups, the offering words), every
   topology group's ``topo_group_start`` and ``topo_pour`` and every
   other group's
   ``ffd_group_commit`` with its membership record of BASELINE config 3 (``examples.config3``,
   50,000 pods: 20 zone-spread deployments, one hostname anti-affinity
   deployment, plain pods) against the plain parts from the same entry
   state at EVCAP 128, 1, 2 and the bail's re-dispatch capacity, and so
   every group of every ``examples.TOPO_CASES`` kernel case (rows at the
   last padded index, an undecided slot below a decided one, the anti
   ladder filling 64 and 2,048 slots) and of ``rows_last`` with its
   counter axes padded to 4,096 rows;
   then ``CUDASolver()`` solves config 3 on the topology kernels
   (one warm-up, timed rounds, counters set to 0 just before and read
   just after; one ``topo_pool_statics`` a solve) with 0 bails,
   fingerprint-equal to the host pour
   (``ops/topo.py``) on the CPU; a forced EVCAP = 1 solve bails and is
   solved again on the card (``reason="topo_bail"``), fingerprint-equal;
12. the preemption path (run before phase 10 too): K8
   (``consol_absorb_preempt``) against its plain version on every
   ``examples.preempt_case`` hazard table; ``PreemptionPlanner.plan``
   timed on a 1,000-node cluster of 30 bound pods a node
   (``examples.preempt_cluster``, seed 1) whose wave of priority-1000
   pods must preempt; then ``Provisioner.reconcile`` on fresh clusters
   of that seed (the base solve on K1/K2, the planner's one K8 launch
   over 64 victim lanes, the evictions, the demand's re-solve), counters
   set to 0 just before and read just after: a feasible verdict from the
   device, several victims after an infeasible lane, the result equal to
   the same round on the plain versions on the CPU, K8 on the round's
   own tables against its plain version, an infeasible variant (all
   64 lanes short, nothing evicted), and K8 against its plain version on
   waves of 16, 64 and 256 signatures;
13. the fused path (run before phase 10 too): the striped cluster
   (``examples.striped_cluster``: 50,000 pods over 500 signatures, each
   pinned to one of five family NodePools; Gp = 512, F = 4) through
   ``CUDASolver(incremental=False)``: both K5 kernels block by block
   against their plain parts on the solver's arena (the commit on the
   cluster size a single solve takes), then one warm-up and
   timed solves (counters set to 0 just before and read just after) of
   1 + 2*128 + 1 launches with 22+ vectorized blocks, fingerprint-equal
   to the card's solve at ``dev_fuse = 1`` and to the plain versions on
   the CPU; the variant with 100 existing nodes; 10 incremental rows-tier
   ticks, each a full fused solve equal to a solve from scratch;
14. the mesh path (run before phase 10 too), the sharded scan (K10) on
   the mesh cells (``examples.MESH_CELLS``: config 2 at 50,000 pods, the
   type mesh; config 2 at 500,000 pods at its settled 1,024 slots with
   ``dp2_min_slots`` 1,024, the pods x types shape on more than one
   rank): (a) at world size 1 on NCCL, after a warm-up solve settles the
   slot bucket, each K10 kernel of the first four group steps of each
   cell against its plain part from the same entry state, every buffer
   it writes (the headroom's new-node table too; the fill in one launch
   and in its three phases); each kernel on later slot shards
   (``examples.MESH_LATER_SHARDS``, slot0 > 0, earlier-shard prefixes
   small and wrapping); then ``CUDASolver(mesh=comm, force_mesh=True)`` timed
   beside the single-device ``CUDASolver`` (K2) on the same snapshot,
   counters set to 0 just before and read just after, decisions equal;
   the pipeline fuzz's minValues snapshots (``examples.MESH_MV_SEEDS``)
   on the type mesh, kernels checked and decisions equal;
   (b) four ranks sharing the card over gloo (``parallel/ranks.py``),
   each solving both cells through ``CUDASolver(mesh=comm)`` (``tp`` on
   1 x 4, ``dp2`` on 2 x 2), every rank's decisions equal to the
   single-device solve, every K10 kernel launched on each rank, rank 0
   and the last rank (the last slot and type shard) holding their
   kernels against the plain parts over the first four steps of each
   cell, fed by the same collectives; the minValues snapshots on
   1 x 4, equal;
15. the distributed path (run before phase 10 too), the multi-process
   mesh (K11, ``parallel/distmesh.py``) at the reference's multi-host
   ceiling (``examples.DIST_CEILING_SHAPE``: 64 groups x 15,626+ pods,
   1,000,064+ pods over 812 types, N = 4,224 slots, seed 7) and on its
   smoke workload, each host placing only its own slab: (a)
   ``dispatch_dist`` at world size 1 on NCCL, the first four group steps
   of each workload checked launch by launch against the plain parts,
   then ticks 0 (full), 1 (patch) and timed patch ticks with the counters
   set to 0 just before and read just after (1 + 5*G K10 launches a
   solve: the fill in its three phases); (b) ``MeshGroup(workers=1,
   local_devices=2)``: 2 hosts x 2 rank processes sharing the card over
   gloo, the ceiling's ticks 0 and 1 and timed patch ticks, ranks 0 and 3
   holding their first steps against the plain parts, each rank's slot
   tables 2,112 rows (its host's slab), the launches each rank reports;
   (d) ``solve_batch`` of 5 and 64 packed lanes over the 4 ranks (K4),
   each lane equal to its single solve on the card and to the plain
   versions; (e) a rank killed between ticks: one full degraded solve on
   the card, then patch, batch routing refused, then the supervised
   regroup (canary) and distributed full and patch ticks; (c)
   ``MeshGroup(workers=3)``: 4 hosts x 1 rank, four slabs, the smoke
   workload. Every fingerprint equals the card's single-device oracle
   (``distmesh.oracle_out``), ticks 0 and 1 also the plain
   ``_solve_scan_ref`` on the CPU (computed from the start in a process
   of its own, two threads);
16. the preference path (run before phase 10 too): BASELINE config 6
   (``examples.config6``, 50,000 pods: 70% plain, 20% ScheduleAnyway
   zone spread in 10 deployments, 10% preferred zone anti-affinity in
   ~200-pod deployments) through ``CUDASolver().solve`` with ``metrics``
   set: the relaxation wrapper hardens the soft terms and relaxes the
   pods they block, so every solve runs at least two rounds (read from
   the counter), each on the topology kernels (``kernel="topo"``, no
   bail); each round's snapshot is kept by wrapping ``_solve_core`` in
   this script, and every round's K9 kernels (and the plain groups'
   ``ffd_group_commit`` with its record) are held to their plain parts
   from the same entry state, launches counted; one warm-up and timed
   solves (counters set to 0 just before and read just after), the split
   summed over the rounds; decisions equal to the port's CPU oracle
   (``CPUSolver``) on the same snapshot;
17. the oracle route (run before phase 10 too): config 2's shape at
   50,000 pods plus one deployment whose topology the pour does not
   model (an arch spread; a zone spread beside a zone-id requirement)
   through ``CUDASolver().solve``: ``kernel="oracle"``, no launch of any
   kernel, the fallback counted; the same solver's next config-2 tick
   runs on the card and equals a fresh solver's; then the grouping
   walk's ``group_ms`` p50 at config 2 and config 3 with the C walk
   (``models.encoding._groupwalk()``, which must have built) and with the
   Python loop, in turns (host times);
10. kernel times with CUDA events at the main paths' shapes, beside the
   plain versions' times and the bound the shapes allow;
   ``ffd_slot_headroom`` at config 2's and the warm arena's chunk entries
   without and with the bank row it stores (the row checked against the
   plain store), the warm suffix's ``pack_outputs`` without and with the
   re-stamp of its pad rows (beside the plain store and ``Tensor.copy_``
   of the same bytes), config 3's plain groups' ``ffd_group_commit``
   without and with the membership record, and each subset round's last
   ``ffd_group_commit`` without and with the summary rows; the gather at
   rounds (a) and (b); the suffix solve's device time beside the
   checkpointed full solve's on the warm arena; the K2 kernels on the
   lane axis at the whole-fleet round's 2,048 lanes; the
   K6 kernels at config 7's states (and config 7's step split, two
   launches a step, beside the figures of three), the lane-axis K1
   kernels at B = 8 and 64, the K9 kernels at config 3's states (the
   pool statics once), K8 at the preemption round's tables and at the
   wider waves', and the K5 kernels at the
   striped cluster's vectorized and sequential blocks, with one fused
   packed solve's device time beside the same snapshot packed unfused,
   and the K10 kernels at the type mesh's last group step of each mesh
   cell at world size 1 (N = 256 and 1,024), and K11 as one group step
   (five launches) of rank 0's shard of the 2 x 2 ceiling layout (2,112
   slots x 406 types) at its last group step, each launch's time and the
   headroom's and the commit's bounds beside it; ``pack_outputs`` at
   config 2 and on the pruned scan's pack at config 7 (its bail word in
   the row) with the CUDA kernels one call issues (the profiler: one),
   and ``mesh_new_caps`` at its main paths' shapes (``caps_states``:
   the tp cell at world 1 and its rank of four, the 500,000-pod cell's
   rank of 2 x 2, K11's shard and the ceiling at world 1) and with
   minValues floors (``caps_floors_state``), each checked against its
   plain part.

The last two lines are the card's name and power limit, then
``{"ok": true, "device": {...}}``; a line before them holds the per-kernel
JSON record. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
#: the non-tensor-core scalar rate (float32, 67 TFLOP/s), used as the
#: peak for the kernels' integer and boolean operations
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

#: BASELINE config 2 at its published size, and the timed solve rounds
PODS = 50_000
ROUNDS = 10

#: the warm tick (reference bench.py --warm-tick): cluster size, pending
#: share, warm-up ticks (with binds) and measured ticks (without)
WARM_PODS = 50_000
WARM_PENDING = 0.01
WARM_WARMUP = 12
WARM_TICKS = 60
#: measured ticks also checked against the plain versions' solve
WARM_CPU_CHECKS = (0, 1, 2, 3, 4, WARM_TICKS - 1)
CK = 2

#: consolidation (BASELINE config 4): whole-fleet round size, the
#: multi-node prefix (a NodePool's default 10% disruption budget), the
#: batched branch's cluster, timed rounds, and the plain check's lane chunk
C4_FLEET = 1000
C4_PREFIX = 100
C4_BATCHED = 200
C4_ROUNDS = 10
C4_DENSE_ROUNDS = 3
LANE_CHUNK = 256

#: the G-axis path: BASELINE config 7 at its published size (50,000
#: pods, 10,000 signatures), timed solves after one warm-up, and the
#: window of group steps over which each pruned kernel is held against
#: its plain part (from the first carry and from a mid-scan carry)
C7_PODS = 50_000
C7_SIGS = 10_000
C7_ROUNDS = 3
C7_WINDOW = 512
C7_ENQUEUE_STEPS = 64
C7_ENQUEUE_REPS = 5
#: config 7's step before ffd_pruned_probe (select, headroom and commit,
#: three launches), printed beside this run's split
C7_STEP_BEFORE = dict(kernels_us=46.00, loop_us=36.35, host_us=28.47,
                      source="PERF.md section 5, H100 80GB HBM3 at 700 W")

#: the batch path: lanes per solve_batch (examples.batch_snapshots) and
#: timed rounds after one warm-up
BATCH_SIZES = (8, 64)
BATCH_ROUNDS = 5
BATCH_CHECK_BLOCKS = 4

#: the topology path: BASELINE config 3 at its published size and the
#: timed solves after one warm-up
C3_PODS = 50_000
C3_ROUNDS = 10

#: the preemption path: nodes, bound pods a node (the density of the
#: Kubernetes ClusterLoader2 density test, PODS_PER_NODE 30), the seed of
#: examples.preempt_cluster, timed plans after one warm-up, and the
#: reconciles of the measured run (the first a warm-up)
P12_NODES = 1000
P12_PER_NODE = 30
P12_SEED = 1
P12_ROUNDS = 10
P12_RECONCILES = 3
#: K8 at wider waves than the round's G = 2: one signature a pod, cpu in
#: 1m steps as BASELINE config 7 draws them, up to the hundreds of
#: distinct shapes of the upstream pod-dense scale envelope
P12_WIDE_G = (16, 64, 256)

#: the fused path (K5): the striped cluster's pods and signatures (the
#: pod-dense envelope of bench.py:228, hundreds of shapes at ~50k pods),
#: timed solves after one warm-up, the incremental ticks, and the
#: vectorized blocks its 500 signatures give (22 holding a real group)
S13_PODS = 50_000
S13_SIGS = 500
S13_ROUNDS = 5
S13_TICKS = 10
S13_MIN_VEC = 22

#: the mesh path (K10): timed solves per cell after one warm-up, the
#: ranks that share the card over gloo, and their collective timeout
M14_ROUNDS = 5
M14_RANKS = 4
M14_TIMEOUT_S = 300

#: the distributed path (K11): timed patch ticks after the checked full
#: and patch ticks, the rank processes' reply and collective deadline,
#: the regroup's backoff and its budget, and the routed batch widths
D15_ROUNDS = 5
D15_TIMEOUT_S = 300
D15_BACKOFF_S = 0.5
D15_REGROUP_BUDGET_S = 180
D15_BATCHES = (5, 64)

#: the preference path: BASELINE config 6 at its published size (the
#: reference's bench.build_config6) and the timed solves after one warm-up
C6_PODS = 50_000
C6_ROUNDS = 3
#: the oracle route: config 2's shape plus one group the pour does not
#: model; and the grouping walk's timed walks (each way, in turns)
C17_PODS = 50_000
WALK_REPS = 10

#: the kernels phase 11 holds to their plain parts
TOPO_CHECKED = ("topo_pool_statics", "topo_group_start", "topo_pour",
                "ffd_group_commit")

#: the kernels of the warm-tick path (the suffix's unpack_bits launch
#: also loads its resume row, its pack_outputs launch re-stamps the pad
#: rows)
K3_PATH = ("unpack_bits", "ffd_slot_headroom", "ffd_group_commit",
           "pack_outputs")

K7_SRC = "karpenter_provider_aws_tpu_torch/csrc/consolidation.cu"
K7_REF = "karpenter_provider_aws_tpu/ops/consolidation_jax.py"
K6_SRC = "karpenter_provider_aws_tpu_torch/csrc/pruned.cu"
K9_SRC = "karpenter_provider_aws_tpu_torch/csrc/topo.cu"
K5_SRC = "karpenter_provider_aws_tpu_torch/csrc/fused.cu"
K10_SRC = "karpenter_provider_aws_tpu_torch/csrc/mesh.cu"
K9_REF = "karpenter_provider_aws_tpu/ops/topo_jax.py"
FFD_REF = "karpenter_provider_aws_tpu/ops/ffd_jax.py"

KERNELS = {
    # on the suffix re-solve the unpack also loads bank row jr (K3)
    "unpack_bits": dict(
        source="karpenter_provider_aws_tpu_torch/csrc/packed_io.cu",
        replaces=f"{FFD_REF}:1140, {FFD_REF}:1329"),
    # the headroom also stores a chunk entry's bank row (K3), the commit
    # also records a topology scan's plain group (K9) and writes a subset
    # round's summary rows (K7d), the pack also re-stamps the suffix's pad
    # rows (K3)
    "ffd_slot_headroom": dict(
        source="karpenter_provider_aws_tpu_torch/csrc/ffd_scan.cu",
        replaces=f"{FFD_REF}:279, {FFD_REF}:795"),
    "ffd_group_commit": dict(
        source="karpenter_provider_aws_tpu_torch/csrc/ffd_scan.cu",
        replaces=f"{FFD_REF}:380, {K9_REF}:685, {K7_REF}:253"),
    "pack_outputs": dict(
        source="karpenter_provider_aws_tpu_torch/csrc/packed_io.cu",
        replaces=f"{FFD_REF}:1159, {FFD_REF}:1311"),
    "consol_absorb_deletions": dict(source=K7_SRC, replaces=f"{K7_REF}:43"),
    "consol_absorb_prescreen": dict(source=K7_SRC, replaces=f"{K7_REF}:75"),
    "consol_absorb_dense": dict(source=K7_SRC, replaces=f"{K7_REF}:142"),
    "consol_absorb_preempt": dict(
        source=K7_SRC,
        replaces="karpenter_provider_aws_tpu/scheduling/preempt_jax.py:39"),
    "subset_gather": dict(source=K7_SRC, replaces=f"{K7_REF}:232"),
    "ffd_pruned_probe": dict(source=K6_SRC,
                             replaces=f"{FFD_REF}:910, {FFD_REF}:939"),
    "ffd_pruned_commit": dict(source=K6_SRC, replaces=f"{FFD_REF}:957"),
    "topo_pool_statics": dict(source=K9_SRC, replaces=f"{K9_REF}:292"),
    "topo_group_start": dict(source=K9_SRC, replaces=f"{K9_REF}:281"),
    "topo_pour": dict(source=K9_SRC, replaces=f"{K9_REF}:669"),
    "ffd_fused_headroom": dict(source=K5_SRC, replaces=f"{FFD_REF}:694"),
    "ffd_fused_commit": dict(source=K5_SRC, replaces=f"{FFD_REF}:743"),
    "mesh_new_caps": dict(source=K10_SRC, replaces=f"{FFD_REF}:400"),
    "mesh_slot_headroom": dict(source=K10_SRC, replaces=f"{FFD_REF}:488"),
    "mesh_fill": dict(source=K10_SRC, replaces=f"{FFD_REF}:469"),
    "mesh_commit": dict(source=K10_SRC, replaces=f"{FFD_REF}:534"),
    # K11: one group step of K10's kernels (the fill in its three
    # phases) on a rank's slab-placed shard of the distributed dispatch
    "dist2_step": dict(
        source=K10_SRC,
        replaces="karpenter_provider_aws_tpu/parallel/distmesh.py:413"),
}
#: the K1 kernels on their lane axis (the batch path), one record per
#: batch width: the kernel, its width, and the reference's vmap they
#: serve (solve_scan_packed1_many)
for _b in BATCH_SIZES:
    for _k in ("unpack_bits", "pack_outputs"):
        KERNELS[f"{_k}_lanes_b{_b}"] = dict(
            source="karpenter_provider_aws_tpu_torch/csrc/packed_io.cu",
            replaces=f"{FFD_REF}:1211")


def log(*a):
    print(*a, flush=True)


def config2(env_mod, env, n_pods: int):
    """bench.py build_config2: 60% small, 25% medium, 10% spot-pinned and
    5% arm64-pinned pods under one pool over the full catalog."""
    from karpenter_provider_aws_tpu_torch.apis import labels as L
    mk = env_mod.make_pods
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


def smi_line() -> str:
    p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if p.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {p.stderr.strip()}")
    return p.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against plain versions
# ---------------------------------------------------------------------------

class Compare:
    """Byte-identity bookkeeping per kernel."""

    def __init__(self):
        self.err = {k: 0 for k in KERNELS}
        self.checks = {k: 0 for k in KERNELS}

    def __call__(self, kernel, got, want, what):
        import torch
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{kernel} {what}: {got.dtype}{tuple(got.shape)}"
                                 f" vs {want.dtype}{tuple(want.shape)}")
        diff = (got.long() - want.long()).abs().max().item() \
            if got.numel() else 0
        self.err[kernel] = max(self.err[kernel], diff)
        self.checks[kernel] += 1
        if not torch.equal(got, want):
            raise AssertionError(f"{kernel} {what}: kernel != plain "
                                 f"(max abs diff {diff})")


def check_arena(label, buf_np, st, cmp, dev):
    """Every kernel against its plain version on one arena, group by
    group from the plain carry, then the whole packed solve."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.ops.hostpack import (
        in_layout_bool, in_layout_i64, layout_sizes, nwords)
    T, D, Z, C, G, E, P = (st[k] for k in "T D Z C G E P".split())
    K, M, V, Q, n_max = st["K"], st["M"], st["V"], st["Q"], st["n_max"]
    buf = torch.from_numpy(buf_np).to(dev)
    n_i64 = layout_sizes(in_layout_i64(T, D, Z, C, G, E, P, K, M, 1, Q))
    n_bits = layout_sizes(in_layout_bool(T, D, Z, C, G, E, P, K, M, 1, Q))
    words = buf[n_i64:n_i64 + nwords(n_bits)]
    bits = fc.unpack_bits(words, n_bits)
    cmp("unpack_bits", bits, ft._unpack_bits_ref(words, n_bits),
        f"{label} bool plane")
    inp = ft._unpack_inputs(buf[:n_i64], bits, T, D, Z, C, G, E, P, K, M,
                            1, Q)
    carry = ft.carry0(inp, E + n_max, E)
    state = fc.ScanState(inp, ft.Carry(*[t.clone() for t in carry]),
                         E=E, P=P, V=V)
    takes, lefts = [], []
    for g in range(G):
        for dst, src in zip(state.carry, carry):
            dst.copy_(src)
        cand, k = ft._slot_headroom_ref(inp, carry, g, E=E, P=P, V=V)
        fc.ffd_slot_headroom(state, g)
        cmp("ffd_slot_headroom", state.cand, cand, f"{label} g={g} cand")
        cmp("ffd_slot_headroom", state.k, k, f"{label} g={g} k")
        if not K:
            for nm, got, want in zip(("candn", "hrn", "cap"), state.table(),
                                     ft._new_node_table_ref(inp, g, P=P)):
                cmp("ffd_slot_headroom", got, want, f"{label} g={g} {nm}")
        carry, take, n_rem = ft._group_step_ref(inp, carry, g, E=E, P=P,
                                                V=V)
        fc.ffd_group_commit(state, g)
        for f, got, want in zip(ft.Carry._fields, state.carry, carry):
            cmp("ffd_group_commit", got, want, f"{label} g={g} {f}")
        cmp("ffd_group_commit", state.takes[g], take.to(torch.int32),
            f"{label} g={g} takes")
        cmp("ffd_group_commit", state.leftover[g:g + 1], n_rem.reshape(1),
            f"{label} g={g} leftover")
        takes.append(take.to(torch.int32))
        lefts.append(n_rem.reshape(1))
    tk, lf = torch.stack(takes), torch.cat(lefts)
    cmp("pack_outputs", fc.pack_outputs(tk, lf, carry),
        ft._pack_outputs_ref(tk, lf, carry), f"{label} output buffer")
    whole = ft.solve_scan_packed1(buf, **examples.solve_statics(st))
    plain = ft._pack_outputs_ref(*ft._solve_scan_ref(
        ft._unpack_inputs(buf[:n_i64], ft._unpack_bits_ref(words, n_bits),
                          T, D, Z, C, G, E, P, K, M, 1, Q),
        n_max, E, P, V))
    if not torch.equal(whole, plain):
        raise AssertionError(f"{label}: packed solve on the card differs "
                             "from the plain packed solve")
    return inp, carry, tk, lf


def check_k1_k10_shapes(cmp, dev):
    """K1's unpack at ``examples.UNPACK_WIDTHS`` (heads, tails, units
    straddling two words, bit 63 set, config 2's bool section) on 1, 3, 17
    and 64 lanes (rows at every offset mod 16; the last lane's last word
    ending the tensor, or lanes a word further apart) and on 65,552 lanes
    of 333 bits (sixteen distinct lanes repeated); K1's pack at
    ``examples.PACK_SHAPES`` (segments straddling words,
    odd G*N, config 2's widths) on 1 and 3 lanes with and without the
    bail word, and on 65,552 lanes (sixteen distinct lanes repeated), and
    ``mesh_new_caps`` at ``examples.CAPS_CASES`` (its main paths' shapes,
    minValues floors, D past eight, Z*C past the 64-bit word): each
    against its plain version on the same inputs, one launch a call.
    Returns the number of states checked."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc

    def plain_rows(words, nbits):
        return torch.stack([ft._unpack_bits_ref(w, nbits) for w in words])
    n = 0
    for nbits in examples.UNPACK_WIDTHS:
        for L in (1, 3, 17, 64):
            words = examples.unpack_case(nbits, L, seed=nbits + L,
                                         pad=L % 2, device=dev)
            n0 = fc.LAUNCHES["unpack_bits"]
            cmp("unpack_bits", fc.unpack_bits_lanes(words, nbits),
                plain_rows(words, nbits), f"unpack {nbits} bits L={L}")
            if fc.LAUNCHES["unpack_bits"] != n0 + 1:
                raise AssertionError("an unpack call is not one launch")
            n += 1
    words = examples.unpack_case(333, 16, seed=3, device=dev)
    reps = 65_552 // 16
    wide = fc.unpack_bits_lanes(words.repeat(reps, 1), 333)
    cmp("unpack_bits", wide.view(reps, 16, -1),
        plain_rows(words, 333)[None].expand(reps, -1, -1).contiguous(),
        "unpack 333 bits, 65,552 lanes")
    n += 1
    for shape in examples.PACK_SHAPES:
        for L in (1, 3):
            for bail in (False, True):
                takes, left, carry, bl = examples.pack_case(
                    *shape, L, seed=sum(shape) + L, bail=bail, device=dev)
                a, kw = (takes, left, carry), dict(bail=bl)
                n0 = fc.LAUNCHES["pack_outputs"]
                cmp("pack_outputs", fc.pack_outputs_lanes(*a, **kw),
                    pack_plain(a, kw), f"pack {shape} L={L} bail={bail}")
                if fc.LAUNCHES["pack_outputs"] != n0 + 1:
                    raise AssertionError("a pack call is not one launch")
                n += 1
    takes, left, carry, bl = examples.pack_case(37, 3, 2, 5, 3, 2, 3, 16,
                                                seed=4, bail=True, device=dev)
    reps = 65_552 // 16

    def rep(t):
        return t.repeat((reps,) + (1,) * (t.dim() - 1))
    wide = fc.pack_outputs_lanes(rep(takes), rep(left),
                                 type(carry)(*[rep(f) for f in carry]),
                                 bail=rep(bl))
    want = pack_plain((takes, left, carry), dict(bail=bl))
    cmp("pack_outputs", wide.view(reps, 16, -1),
        want[None].expand(reps, -1, -1).contiguous(), "pack, 65,552 lanes")
    n += 1
    for name, shape, K in examples.CAPS_CASES:
        st = examples.caps_state(**shape, seed=len(name), K=K,
                                 V=5 if K else 0, device=dev)
        want = st.clone()
        mc._new_caps_ref(want)
        mc.mesh_new_caps(st)
        cmp("mesh_new_caps", st.caps, want.caps, f"caps {name}")
        n += 1
    return n


def n_offset(st) -> int:
    """Word offset of the group-count vector ``n`` in a packed arena."""
    return st["T"] * st["D"] + st["G"] * st["D"]


def check_k3(label, buf_np, st, cmp, dev, gls=None):
    """The K3 kernels and solves against their plain versions on one
    arena: for each live bound GL (``gls``; default every multiple of CK
    up to G, the groups past GL emptied) the checkpointed solve's output
    and every bank field (each row stored by its chunk entry's
    ffd_slot_headroom), the suffix's prologue (unpack_bits_load: the
    arena's bool plane and one bank row into the working carry, one
    launch) at every bank row, the pack with a store range of rows [1,
    G/CK) (its output and those rows against the plain pack and store),
    then every SUF the bound allows: the suffix output and the spliced
    bank, each run from its own copy of the recorded bank (rows up to jr
    untouched, the later rows stored by the headroom, the pad rows by the
    suffix's pack), one unpack_bits and one pack_outputs launch a
    suffix."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.ops.hostpack import (
        in_layout_bool, in_layout_i64, layout_sizes)
    T, D, Z, C, G, E, P = (st[k] for k in "T D Z C G E P".split())
    K, M, V, Q, n_max = st["K"], st["M"], st["V"], st["Q"], st["n_max"]
    ss = examples.solve_statics(st)
    off = n_offset(st)
    n_i64 = layout_sizes(in_layout_i64(T, D, Z, C, G, E, P, K, M, 1, Q))
    n_bits = layout_sizes(in_layout_bool(T, D, Z, C, G, E, P, K, M, 1, Q))
    runs = 0
    for GL in (gls or range(CK, G + 1, CK)):
        b = buf_np.copy()
        b[off + GL:off + G] = 0
        d = torch.from_numpy(b).to(dev)
        out, bank = ft.solve_scan_packed1_ckpt(d, CK=CK, **ss)
        inp = ft._packed_inputs_ref(d, T, D, Z, C, G, E, P, K, M, Q)
        tk, lf, cr, pbank = ft._solve_ckpt_ref(inp, n_max, E, P, V, CK)
        cmp("pack_outputs", out, ft._pack_outputs_ref(tk, lf, cr),
            f"{label} GL={GL} ckpt output")
        for nm, g, w in zip(ft.Carry._fields, bank, pbank):
            cmp("ffd_slot_headroom", g, w,
                f"{label} GL={GL} ckpt bank.{nm}")
        work = ft.bank_row(pbank, 0)
        bs = fc.BankState(work, bank)
        words = d[n_i64:]
        plain_bits = ft._unpack_bits_ref(words, n_bits)
        for j in range(G // CK):
            bits = fc.unpack_bits_load(words, n_bits, bs, j)
            cmp("unpack_bits", bits, plain_bits,
                f"{label} GL={GL} prologue of row {j}: bool plane")
            for nm, g, w in zip(ft.Carry._fields, work,
                                ft.bank_row(pbank, j)):
                cmp("unpack_bits", g, w,
                    f"{label} GL={GL} prologue of row {j}: carry.{nm}")
        if G // CK > 1:   # the pack re-stamping rows [1, G/CK) of a copy
            ks = fc.BankState(work, ft.Carry(*[x.clone() for x in bank]))
            want = ft.Carry(*[x.clone() for x in bank])
            ft._bank_store_ref(want, work, 1, G // CK - 1)
            cmp("pack_outputs", fc.pack_outputs(
                tk, lf, work, store=(ks, 1, G // CK - 1)),
                ft._pack_outputs_ref(tk, lf, work),
                f"{label} GL={GL} pack re-stamping rows [1, {G // CK})")
            for nm, g, w in zip(ft.Carry._fields, ks.bank, want):
                cmp("pack_outputs", g, w, f"{label} GL={GL} pack's "
                    f"re-stamp of rows [1, {G // CK}): bank.{nm}")
        for SUF in range(1, GL // CK + 1):
            kb = ft.Carry(*[x.clone() for x in bank])
            pb = ft.Carry(*[x.clone() for x in pbank])
            n0 = dict(fc.LAUNCHES)
            o, kb = ft.solve_scan_suffix(d, kb, CK=CK, SUF=SUF, GL=GL, **ss)
            pad = GL < G
            got = {k: fc.LAUNCHES[k] - n0[k] for k in fc.LAUNCHES
                   if fc.LAUNCHES[k] != n0[k]}
            if got != dict(unpack_bits=1, ffd_slot_headroom=SUF * CK,
                           ffd_group_commit=SUF * CK, pack_outputs=1):
                raise AssertionError(
                    f"{label} GL={GL} SUF={SUF}: launches {got}, expected "
                    f"1 unpack_bits (loading row jr), {SUF * CK} of each K2 "
                    "kernel and 1 pack_outputs (re-stamping the pad rows), "
                    "nothing else")
            tk, lf, cr, pb = ft._solve_suffix_ref(inp, pb, n_max, E, P, V,
                                                  CK, SUF, GL)
            cmp("pack_outputs", o, ft._pack_outputs_ref(tk, lf, cr),
                f"{label} GL={GL} SUF={SUF} suffix output")
            jr, lb = GL // CK - SUF, GL // CK
            for nm, g, w, r in zip(ft.Carry._fields, kb, pb, bank):
                what = f"{label} GL={GL} SUF={SUF} spliced bank.{nm}"
                cmp("ffd_slot_headroom", g[:jr + 1], r[:jr + 1],
                    f"{what} rows up to jr (untouched)")
                cmp("ffd_slot_headroom", g[:lb], w[:lb],
                    f"{what} rows up to GL/CK")
                if pad:
                    cmp("pack_outputs", g[lb:], w[lb:],
                        f"{what} pad rows")
            runs += 1
    return runs


# ---------------------------------------------------------------------------
# phase 5: the warm tick
# ---------------------------------------------------------------------------

def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def warm_tick_phase(pods=WARM_PODS, device=None):
    """Drive the warm tick on ``device`` (default cuda; the rehearsal
    passes cpu); returns (launches of the measured run, summary dict).
    Raises on any failed check."""
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    snapshot, tick = examples.warm_cluster(pods=pods,
                                           pending_frac=WARM_PENDING)
    solver = CUDASolver(device=device)
    suffixes = []               # the last suffix dispatch's (buf, statics)
    dispatch_suffix = solver._dispatch_suffix

    def watched(buf, bank, **statics):
        suffixes[:] = [(buf, statics)]
        return dispatch_suffix(buf, bank, **statics)
    solver._dispatch_suffix = watched
    t0 = time.perf_counter()
    solver.solve(snapshot())
    cold_ms = (time.perf_counter() - t0) * 1e3
    warm_modes = []
    for _ in range(WARM_WARMUP):
        tick(binds=True)
        solver.solve(snapshot())
        warm_modes.append((solver.last_phase_stats["solve"],
                           solver.last_dispatch_stats["reason"]))
    snaps, fps, walls, stats = [], [], [], []
    fc.reset_launches()
    for _ in range(WARM_TICKS):
        tick(binds=False)
        snap = snapshot()
        t0 = time.perf_counter()
        res = solver.solve(snap)
        walls.append((time.perf_counter() - t0) * 1e3)
        snaps.append(snap)
        fps.append(res.decision_fingerprint())
        stats.append((dict(solver.last_phase_stats),
                      dict(solver.last_dispatch_stats)))
    launches = dict(fc.LAUNCHES)
    check_resident_bank(solver, *suffixes[-1])
    log(f"[warm] {pods} pods, {len(snaps[0].pods)} pending, "
        f"{len(snaps[0].existing_nodes)} existing nodes; cold solve "
        f"{cold_ms:.1f} ms; warm-up (mode, full reason): {warm_modes}")
    log(f"[warm] launches in the measured run ({WARM_TICKS} ticks): "
        f"{launches}")
    # the from-scratch solves (on the card, and the plain versions) run
    # after the counters are read: their launches are not the main path's
    on_card = CUDASolver(device=device, incremental=False)
    plain = CUDASolver(device="cpu", incremental=False)
    for t, snap in enumerate(snaps):
        if on_card.solve(snap).decision_fingerprint() != fps[t]:
            raise AssertionError(f"warm tick {t}: incremental decisions "
                                 "differ from the from-scratch solve")
        if t in WARM_CPU_CHECKS and \
                plain.solve(snap).decision_fingerprint() != fps[t]:
            raise AssertionError(f"warm tick {t}: decisions differ from "
                                 "the plain versions' solve")
    full = [(t, ds["reason"]) for t, (ps, ds) in enumerate(stats)
            if ps["solve"] == "full"]
    modes = {}
    for ps, _ in stats:
        modes[ps["solve"]] = modes.get(ps["solve"], 0) + 1
    resume = {}
    for _, ds in stats:
        if "resume_group" in ds:
            resume[ds["resume_group"]] = resume.get(ds["resume_group"], 0) + 1
    split = {k: statistics.median(ps[k] for ps, _ in stats)
             for k in ("group_ms", "encode_ms", "kernel_ms", "decode_ms")}
    tiers = {}
    for ps, _ in stats:
        tiers[ps["cache"]] = tiers.get(ps["cache"], 0) + 1
    summary = dict(p50_ms=statistics.median(walls), p99_ms=pct(walls, 0.99),
                   modes=modes, full_ticks=full, resume_groups=resume,
                   tiers=tiers, median_split_ms=split,
                   slot_bucket=stats[-1][1]["slot_bucket"],
                   groups=stats[-1][1]["groups"],
                   launches_per_tick={k: v / WARM_TICKS
                                      for k, v in launches.items()})
    log(f"[warm] {WARM_TICKS} measured ticks: split (mode: ticks) {modes}; "
        f"full ticks (tick, reason): {full}; resume groups {resume}; "
        f"delta tiers {tiers}; slot bucket {summary['slot_bucket']}, "
        f"padded groups {summary['groups']}")
    log(f"[warm] tick p50 {summary['p50_ms']:.3f} ms p99 "
        f"{summary['p99_ms']:.3f} ms; median split {json.dumps(split)}; "
        f"fingerprints == from scratch on the card: {WARM_TICKS}/"
        f"{WARM_TICKS}, == plain versions: {len(WARM_CPU_CHECKS)} ticks")
    if full:
        raise AssertionError(f"measured warm ticks served by a full solve: "
                             f"{full}")
    missing = [k for k in K3_PATH if launches[k] <= 0]
    if missing and solver.device.type == "cuda":
        raise AssertionError(f"kernels never launched on the warm-tick "
                             f"path: {missing}")
    return launches, summary


def check_resident_bank(solver, buf, statics):
    """The bank the warm ticks left resident (the chunk entries' rows
    stored by the suffix's ffd_slot_headroom launches, the pad rows by its
    pack_outputs launch) against the plain checkpointed solve of the last
    tick's arena, on the solver's device: every row, byte for byte."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    st = {k: statics.get(k, 0) for k in "T D Z C G E P K M V Q".split()}
    d = torch.as_tensor(buf).to(solver.device)
    inp = ft._packed_inputs_ref(d, *(st[k] for k in
                                     "T D Z C G E P K M Q".split()))
    _, _, _, want = ft._solve_ckpt_ref(inp, statics["n_max"], st["E"],
                                       st["P"], st["V"], statics["CK"])
    for nm, got, w in zip(ft.Carry._fields,
                          solver._ckpt_bank["bank"], want):
        if not torch.equal(got, w):
            raise AssertionError(f"warm tick: the resident bank.{nm} != the "
                                 "plain checkpointed solve's")
    log(f"[warm] the resident bank ({want.used.shape[0]} rows) == the plain "
        f"checkpointed solve of the last tick's arena")


def check_lane_one(label, inp, st, cmp):
    """The K2 kernels on their lane axis with ONE lane (every input
    field and the carry per lane) against the same kernels without a
    lane axis, over the whole scan: byte-identical."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    E, P, V, N = st["E"], st["P"], st["V"], st["E"] + st["n_max"]
    lane_fields = ("avail_zc", "R", "n", "F", "agz", "agc", "admit",
                   "daemon", "ex_alloc", "ex_compat")
    one = fc.ScanState(inp, ft.carry0(inp, N, E), E=E, P=P, V=V)
    lanes = fc.ScanState(
        inp._replace(**{f: getattr(inp, f)[None] for f in lane_fields}),
        ft.carry0(inp, N, E, lanes=1), E=E, P=P, V=V, lanes=1)
    for g in range(st["G"]):
        for state in (one, lanes):
            fc.ffd_slot_headroom(state, g)
            fc.ffd_group_commit(state, g)
    for nm, a, b in zip(ft.Carry._fields, one.carry, lanes.carry):
        cmp("ffd_group_commit", b[0], a, f"{label} lanes=1 {nm}")
    cmp("ffd_group_commit", lanes.takes[0], one.takes, f"{label} lanes=1 "
        "takes")
    cmp("ffd_group_commit", lanes.leftover[0], one.leftover,
        f"{label} lanes=1 leftover")


def check_subset_lanes(label, arena, tprice, lanes, st, cmp, nlanes=None):
    """One subset round piece by piece on the card against the plain
    versions: subset_gather, the K2 kernels on the lane axis group by
    group for the first ``nlanes`` lanes (default all), the last commit
    with the summary rows. ``arena`` is a KernelInputs and ``lanes`` a
    dict of tensors, all on the card."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    E, P, N = st["E"], st["P"], st["E"] + st["n_max"]
    t = lanes
    g_k = cc.subset_gather(arena, t["gid"], t["n"], t["dead"], t["keep"])
    g_p = ct._subset_gather_ref(arena, t["gid"], t["n"], t["dead"],
                                t["keep"])
    for f in ct.LANE_FIELDS:
        cmp("subset_gather", getattr(g_k, f), getattr(g_p, f),
            f"{label} {f}")
    del g_p
    B = nlanes or t["gid"].shape[0]
    sub = g_k._replace(**{f: getattr(g_k, f)[:B].contiguous()
                          for f in ct.LANE_FIELDS})
    del g_k
    state = fc.ScanState(sub, ft.carry0(sub, N, E, lanes=B), E=E, P=P,
                         lanes=B)
    keep, rp = t["keep"][:B].contiguous(), t["removed_price"][:B]
    sargs, rows = cc.summary_args(state, keep, tprice, rp)
    carries = [ft.carry0(ct.lane_inputs(sub, b), N, E) for b in range(B)]
    Gq = sub.R.shape[1]
    for g in range(Gq):
        fc.ffd_slot_headroom(state, g)
        cands, ks = [], []
        for b in range(B):
            cand, k = ft._slot_headroom_ref(ct.lane_inputs(sub, b),
                                            carries[b], g, E=E, P=P, V=0)
            cands.append(cand)
            ks.append(k)
        cmp("ffd_slot_headroom", state.cand, torch.stack(cands),
            f"{label} lanes g={g} cand")
        cmp("ffd_slot_headroom", state.k, torch.stack(ks),
            f"{label} lanes g={g} k")
        del cands
        tabs = [ft._new_node_table_ref(ct.lane_inputs(sub, b), g, P=P)
                for b in range(B)]
        for nm, got, i in zip(("candn", "hrn", "cap"), state.table(),
                              range(3)):
            cmp("ffd_slot_headroom", got, torch.stack([x[i] for x in tabs]),
                f"{label} lanes g={g} {nm}")
        del tabs
        fc.ffd_group_commit(state, g,
                            summary=sargs if g == Gq - 1 else None)
        takes, lefts = [], []
        for b in range(B):
            carries[b], take, n_rem = ft._group_step_ref(
                ct.lane_inputs(sub, b), carries[b], g, E=E, P=P, V=0)
            takes.append(take.to(torch.int32))
            lefts.append(n_rem)
        for i, nm in enumerate(ft.Carry._fields):
            cmp("ffd_group_commit", state.carry[i],
                torch.stack([c[i] for c in carries]),
                f"{label} lanes g={g} {nm}")
        cmp("ffd_group_commit", state.takes[:, g], torch.stack(takes),
            f"{label} lanes g={g} takes")
        cmp("ffd_group_commit", state.leftover[:, g], torch.stack(lefts),
            f"{label} lanes g={g} leftover")
    del carries
    cmp("ffd_group_commit", rows,
        ct._subset_summary_ref(state.leftover, state.carry.num_nodes,
                               state.carry.types, keep, tprice, rp, E),
        f"{label} lanes summary rows")
    del state, sub


def check_k7_synthetic(cmp, dev):
    """The K7 kernels on the seeded hazard cases of ``examples``: the
    three consol_absorb modes (E=32 with the carry in shared memory,
    E=4096 in the global scratch), and whole subset rounds piece by
    piece, the gather at ``GATHER_SHAPES``, one round of 65,552 lanes
    (more than grid y holds) and rounds of one lane (its commit, and so
    its summary row, on a cluster of 8). Returns the number of cases."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft

    def cuda(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]
    cases = 0
    for hazard in examples.ABSORB_HAZARDS:
        for seed, E in ((0, 32), (1, 32), (2, 4096)):
            a = cuda(*examples.absorb_case(hazard, seed, E=E))
            ps = cuda(*examples.prescreen_tables(seed))
            dn = cuda(*examples.dense_case(hazard, seed, E=E))
            what = f"{hazard} seed={seed} E={E}"
            cmp("consol_absorb_deletions", ct.deletions_feasible(*a),
                ct._deletions_feasible_ref(*a), what)
            pa = (*a[:4], *ps[:5], *a[4:], ps[5])
            cmp("consol_absorb_prescreen", ct.replacements_prescreen(*pa),
                ct._replacements_prescreen_ref(*pa), what)
            cmp("consol_absorb_dense", ct.deletions_feasible_dense(*dn),
                ct._deletions_feasible_dense_ref(*dn), what)
            cases += 1
    for hazard in examples.SUBSET_HAZARDS:
        for seed, kw in ((0, {}), (1, dict(T=812, Ep=64, B=32, Gq=4))):
            arena, tprice, lanes, st = examples.subset_case(hazard, seed,
                                                            **kw)
            inp = ft.kernel_inputs_from_numpy(arena, dev)
            tp = torch.from_numpy(tprice).to(dev)
            t = {k: torch.from_numpy(v).to(dev) for k, v in lanes.items()}
            what = f"subset {hazard} seed={seed}"
            check_subset_lanes(what, inp, tp, t, st, cmp)
            cmp("ffd_group_commit",
                ct.subset_solve(inp, tp, t["gid"], t["n"], t["dead"],
                                t["keep"], t["removed_price"], **st),
                ct._subset_solve_ref(inp, tp, t["gid"], t["n"], t["dead"],
                                     t["keep"], t["removed_price"], **st),
                f"{what} round")
            cases += 1
    # the gather at its odd shapes (rows of T and E not multiples of 16,
    # D odd, Gq = 1 and 128, round (a)'s widths)
    for i, shp in enumerate(examples.GATHER_SHAPES):
        for hazard in examples.SUBSET_HAZARDS:
            arena, _, lanes, _ = examples.subset_case(hazard, i, **shp)
            inp = ft.kernel_inputs_from_numpy(arena, dev)
            t = {k: torch.from_numpy(v).to(dev) for k, v in lanes.items()}
            g_k = cc.subset_gather(inp, t["gid"], t["n"], t["dead"],
                                   t["keep"])
            g_p = ct._subset_gather_ref(inp, t["gid"], t["n"], t["dead"],
                                        t["keep"])
            for f in ct.LANE_FIELDS:
                cmp("subset_gather", getattr(g_k, f), getattr(g_p, f),
                    f"gather shape {i} {hazard} {f}")
            cases += 1
    # more lanes than grid y's 65,535 blocks (subset_gather and
    # ffd_slot_headroom spread the lane over grid y and z): 16 lanes tiled
    # 4,097 times
    arena, tprice, lanes, st = examples.subset_case("dead_nodes", 5)
    reps = 4097
    inp = ft.kernel_inputs_from_numpy(arena, dev)
    tp = torch.from_numpy(tprice).to(dev)
    order = ("gid", "n", "dead", "keep", "removed_price")
    one = [torch.from_numpy(lanes[k]).to(dev) for k in order]
    tiled = examples.tile_lanes(lanes, reps)
    many = [torch.from_numpy(tiled[k]).to(dev) for k in order]

    def rep(x):
        return x.repeat((reps,) + (1,) * (x.dim() - 1))
    what = f"subset {16 * reps} lanes"
    g_k = cc.subset_gather(inp, *many[:4])
    g_p = ct._subset_gather_ref(inp, *one[:4])
    for f in ct.LANE_FIELDS:
        cmp("subset_gather", getattr(g_k, f), rep(getattr(g_p, f)),
            f"{what} {f}")
    del g_k, g_p
    cmp("ffd_group_commit", ct.subset_solve(inp, tp, *many, **st),
        rep(ct._subset_solve_ref(inp, tp, *one, **st)), f"{what} round")
    # one lane, whose commit takes a cluster of 8 CTAs: its summary row
    for hazard in ("plain", "three_nodes"):
        arena, tprice, lanes, st = examples.subset_case(
            hazard, 7, T=813, Ep=37, B=1)
        inp = ft.kernel_inputs_from_numpy(arena, dev)
        tp = torch.from_numpy(tprice).to(dev)
        one = [torch.from_numpy(lanes[k]).to(dev) for k in order]
        n0 = dict(fc.LAUNCHES)
        got = ct.subset_solve(inp, tp, *one, **st)
        Gq = lanes["gid"].shape[1]
        if {k: fc.LAUNCHES[k] - n0[k] for k in fc.LAUNCHES
                if fc.LAUNCHES[k] != n0[k]} != dict(
                    subset_gather=1, ffd_slot_headroom=Gq,
                    ffd_group_commit=Gq):
            raise AssertionError("a one-lane subset round's launches")
        E, N = st["E"], st["E"] + st["n_max"]
        if fc.k2_shape(1, 0, 0, st["P"], arena["R"].shape[1], N) != (8, 512):
            raise AssertionError("one lane's commit is not a cluster of 8")
        cmp("ffd_group_commit", got, ct._subset_solve_ref(inp, tp, *one,
                                                          **st),
            f"subset {hazard} one lane (a cluster of 8) row")
        cases += 1
    return cases + 1


# ---------------------------------------------------------------------------
# phase 6: consolidation
# ---------------------------------------------------------------------------

class Captured:
    """Wraps an object's method (or a module function) and keeps the
    arguments and result of its last call."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name
        self.inner = getattr(owner, name)
        self.last = None
        setattr(owner, name, self)

    def __call__(self, *a, **kw):
        out = self.inner(*a, **kw)
        self.last = (a, kw, out)
        # the dispatch evidence before a later solve overwrites it
        self.stats = dict(getattr(self.owner, "last_dispatch_stats", {}))
        return out

    def restore(self):
        setattr(self.owner, self.name, self.inner)


def drive(label, fn, rounds, split=None):
    """Run ``fn`` once (warm-up) and ``rounds`` times timed, with every
    launch counter set to 0 just before and read just after. Returns the
    last result and a record: p50/p99 ms, the median split (``split()``
    after each round), launches per round, device memory the rounds
    allocated."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    on_card = torch.cuda.is_available()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
    fc.reset_launches()
    got = fn()
    times, splits = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        res = fn()
        times.append((time.perf_counter() - t0) * 1e3)
        if res != got:
            raise AssertionError(f"{label}: decision moved between rounds: "
                                 f"{res[:2]} vs {got[:2]}")
        if split is not None:
            splits.append(split())
    launches = dict(fc.LAUNCHES)
    rec = dict(p50_ms=statistics.median(times), p99_ms=pct(times, 0.99),
               rounds=rounds,
               launches_per_round={k: v / (rounds + 1)
                                   for k, v in launches.items() if v},
               launches=launches)
    if splits:
        rec["median_split_ms"] = {
            k: statistics.median(s[k] for s in splits) for k in splits[0]
            if k.endswith("_ms")}
        rec["cache"] = splits[-1].get("cache")
    if on_card:
        rec["device_mb"] = (torch.cuda.max_memory_allocated() - m0) / 2**20
    return got, rec


def subset_rows_check(label, cap, cmp, dev):
    """Every lane of the last captured subset round against the plain
    versions on the same CUDA tensors (lanes in chunks). Returns the
    plain rows (numpy)."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    (arrays,), kw, rows = cap.last
    arena = ft.kernel_inputs_from_numpy(arrays, dev)
    tp = torch.from_numpy(kw["tprice"]).to(dev)
    t = {k: torch.from_numpy(kw[k]).to(dev)
         for k in ("gid", "n", "dead", "keep", "removed_price")}
    B = rows.shape[0]
    plain = torch.cat([ct._subset_solve_ref(
        arena, tp, *(t[k][b0:b0 + LANE_CHUNK] for k in (
            "gid", "n", "dead", "keep", "removed_price")),
        n_max=kw["n_max"], E=kw["E"], P=kw["P"]).cpu()
        for b0 in range(0, B, LANE_CHUNK)])
    cmp("ffd_group_commit", torch.from_numpy(rows), plain,
        f"{label}: all {B} lane rows (the last commit's summary)")
    return plain.numpy(), (arena, tp, t, kw)


class RowsEvaluator:
    """The plain path's evaluator for a decision check: verdicts from
    the plain versions' rows, the simulate on ``solver`` (the plain
    versions on the CPU)."""

    def __init__(self, rows, solver):
        from karpenter_provider_aws_tpu_torch.controllers.disruption import \
            SubsetVerdict
        self.solver = solver
        self.verdicts = [SubsetVerdict(feasible=int(r[0]) == 0,
                                       n_new=int(r[1]), flex=int(r[2]),
                                       min_price=int(r[3]),
                                       savings=int(r[4])) for r in rows]

    def subset_solve(self, base, queries):
        return self.verdicts[:len(queries)]


def consolidation_phase(cmp=None, device=None, fleet=C4_FLEET,
                        prefix=C4_PREFIX, batched=C4_BATCHED,
                        rounds=C4_ROUNDS, dense_rounds=C4_DENSE_ROUNDS):
    """Drive consolidation on ``device`` (default cuda; the rehearsal
    passes cpu) through the evaluator's entry points; returns (launches
    of the four runs summed, records, captures for the timings). With
    ``cmp`` (on the card) every lane is held against the plain versions
    on the same CUDA tensors and every decision against the plain
    path's, whose simulates run the plain versions on the CPU. Raises on
    any failed check."""
    import copy

    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    from karpenter_provider_aws_tpu_torch.solver.consolidation import \
        CUDAConsolidationEvaluator
    dev = torch.device(device or "cuda")
    recs, caps, total = {}, {}, {}
    # the plain path's simulate: the plain versions on the CPU
    plain_solver = CUDASolver(device="cpu", incremental=False)

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # (a) the whole-fleet round
    fenv.reset_pod_counter()
    t0 = time.perf_counter()
    base, cands = examples.config4(fenv.Environment(), n_nodes=fleet)
    queries = examples.consolidation_queries(cands)
    log(f"[c4] config 4 at {fleet} nodes, "
        f"{sum(len(c[1]) for c in cands)} pods, built in "
        f"{time.perf_counter() - t0:.2f} s")
    ev = CUDAConsolidationEvaluator(device=device)
    sub = Captured(ev.solver, "dispatch_subsets")
    got, rec = drive("fleet", lambda: examples.single_consolidation_device(
        ev, base, cands, queries), rounds,
        split=lambda: dict(ev.last_phase_stats))
    rec["decision"] = got[:2]
    rec["lanes"] = len(queries)
    rec["padded_lanes"] = ev.last_phase_stats["padded_lanes"]
    rec["subset_dispatch"] = sub.stats
    add(rec.pop("launches"))
    recs["fleet"] = rec
    if got[0] == "fallback":
        raise AssertionError("the whole-fleet round was not eligible")
    if cmp is not None:
        rows, caps["fleet"] = subset_rows_check("fleet", sub, cmp, dev)
        arena, tp, t, kw = caps["fleet"]
        st = dict(E=kw["E"], P=kw["P"], n_max=kw["n_max"])
        if dev.type == "cuda":
            check_subset_lanes("fleet", arena, tp, t, st, cmp)
        plain = examples.single_consolidation_device(
            RowsEvaluator(rows, plain_solver), base, cands, queries)
        if plain != got:
            raise AssertionError(f"fleet: decision {got[:2]} != plain path "
                                 f"{plain[:2]}")
    sub.restore()
    log(f"[c4] (a) whole-fleet round: {json.dumps(rec)}")

    # (b) the multi-node prefix round over the first `prefix` candidates
    pre = cands[:prefix]
    pq = examples.prefix_queries(pre)
    ev_m = CUDAConsolidationEvaluator(device=device)
    sub = Captured(ev_m.solver, "dispatch_subsets")
    got, rec = drive("prefix", lambda: examples.multi_consolidation(
        ev_m, ev_m.solver, base, pre, pq), rounds,
        split=lambda: dict(ev_m.last_phase_stats))
    rec["decision"] = [got[0], len(got[1])]
    rec["lanes"] = len(pq)
    rec["subset_dispatch"] = sub.stats
    add(rec.pop("launches"))
    recs["prefix"] = rec
    if cmp is not None:
        rows, caps["prefix"] = subset_rows_check("prefix", sub, cmp, dev)
        plain = examples.multi_consolidation(
            RowsEvaluator(rows, None), plain_solver, base, pre, pq)
        if plain != got:
            raise AssertionError(f"prefix: decision {got[:2]} != plain path "
                                 f"{plain[:2]}")
    sub.restore()
    log(f"[c4] (b) prefix round: {json.dumps(rec)}")

    # (c) the batched branch without subset lanes, config 4 as published
    fenv.reset_pod_counter()
    base_c, cands_c = examples.config4(fenv.Environment(), n_nodes=batched)
    ev_c = CUDAConsolidationEvaluator(device=device)
    solver_c = CUDASolver(device=device)
    dl = Captured(ct, "deletions_feasible")
    rp = Captured(ct, "replacements_prescreen")
    got, rec = drive("batched", lambda: examples.single_consolidation_batched(
        ev_c, solver_c, base_c, cands_c), rounds)
    rec["decision"] = got[:2]
    add(rec.pop("launches"))
    recs["batched"] = rec
    dl.restore()
    rp.restore()
    caps["deletions"], caps["prescreen"] = dl.last, rp.last
    if cmp is not None:
        for name, cap, ref in (
                ("consol_absorb_deletions", dl, ct._deletions_feasible_ref),
                ("consol_absorb_prescreen", rp,
                 ct._replacements_prescreen_ref)):
            a, kw, out = cap.last
            cmp(name, out, ref(*a, **kw), f"batched: all {len(out)} lanes")
        plain = examples.single_consolidation_batched(
            CUDAConsolidationEvaluator(device="cpu"), plain_solver, base_c,
            cands_c)
        if plain != got:
            raise AssertionError(f"batched: decision {got[:2]} != plain "
                                 f"path {plain[:2]}")
    log(f"[c4] (c) batched branch at {batched} nodes: {json.dumps(rec)}")

    # (d) the same deletion checks as a heterogeneous batch: every
    # snapshot holds its own copies of the nodes (the dense path)
    snaps = [examples.deletion_snapshot(base_c, c) for c in cands_c]
    for s_ in snaps:
        s_.existing_nodes = [copy.copy(n) for n in s_.existing_nodes]
    shared = ev_c.deletions_feasible(
        [examples.deletion_snapshot(base_c, c) for c in cands_c])
    dn = Captured(ct, "deletions_feasible_dense")
    got, rec = drive("dense", lambda: ev_c.deletions_feasible(snaps),
                     dense_rounds)
    dn.restore()
    caps["dense"] = dn.last
    if got != shared:
        raise AssertionError("dense: answers differ from the shared path's")
    rec["feasible"] = sum(got)
    rec["lanes"] = len(got)
    add(rec.pop("launches"))
    recs["dense"] = rec
    if cmp is not None:
        a, kw, out = dn.last
        cmp("consol_absorb_dense", out,
            ct._deletions_feasible_dense_ref(*a, **kw),
            f"dense: all {len(out)} lanes")
    log(f"[c4] (d) heterogeneous deletion batch: {json.dumps(rec)}")
    return total, recs, caps


# ---------------------------------------------------------------------------
# phase 8: the G-axis path (the pruned scan, K6)
# ---------------------------------------------------------------------------

def check_pruned_window(label, inp, carry, g0, steps, st, S, cmp,
                        keep=()):
    """Both K6 kernels against their plain parts over groups [g0,
    g0+steps) from ``carry`` (not modified): the probe (selection,
    candidates, headroom and the new-node table) against
    ``_pruned_probe_ref``, then the commit. The plain parts carry the
    state, and each step the kernels start from the plain carry. Returns
    the plain carry after the window and the states (g, carry) at the
    steps in ``keep`` (for the timing phase)."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    E, P = st["E"], st["P"]
    carry = ft.CarryP(*[t.clone() for t in carry])
    ps = fc.PrunedState(inp, ft.CarryP(*[t.clone() for t in carry]), E=E,
                        P=P, S=S)
    kept = []
    for g in range(g0, g0 + steps):
        if g in keep:
            kept.append((g, ft.CarryP(*[t.clone() for t in carry])))
        for dst, src in zip(ps.carry, carry):
            dst.copy_(src)
        sel, cnt, cand_s, k_s, tab = ft._pruned_probe_ref(inp, carry, g, E=E,
                                                          P=P, S=S)
        fc.ffd_pruned_probe(ps, g)
        for nm, got, want in (("sel", ps.sel, sel), ("cnt", ps.cnt, cnt),
                              ("cand", ps.cand, cand_s), ("ks", ps.ks, k_s)):
            cmp("ffd_pruned_probe", got, want, f"{label} g={g} {nm}")
        for nm, got, want in zip(ft.NewNodeTable._fields, ps.table(), tab):
            cmp("ffd_pruned_probe", got, want, f"{label} g={g} {nm}")
        carry, take, n_rem = ft._pruned_commit_ref(
            inp, carry, g, sel, cnt, cand_s, k_s, tab, E=E, P=P, S=S)
        fc.ffd_pruned_commit(ps, g)
        for f, got, want in zip(ft.CarryP._fields, ps.carry, carry):
            cmp("ffd_pruned_commit", got, want, f"{label} g={g} {f}")
        cmp("ffd_pruned_commit", ps.takes[g], take.to(torch.int32),
            f"{label} g={g} takes")
        cmp("ffd_pruned_commit", ps.leftover[g:g + 1], n_rem.reshape(1),
            f"{label} g={g} leftover")
    return carry, kept


def g_axis_phase(cmp, device=None, n_pods=C7_PODS, n_sigs=C7_SIGS,
                 rounds=C7_ROUNDS, window=C7_WINDOW, max_groups=None):
    """Drive config 7 through ``CUDASolver().solve`` on the pruned
    kernel (``device`` default cuda; the rehearsal passes
    cpu and a small ``max_groups`` so its small G still rides the pruned
    path). On the card, first each K6 kernel against its plain part over
    ``window`` steps from the first carry and from a mid-scan carry, and
    at S = 1 from the first carry. Returns (launches of the measured
    run, summary, timing states)."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.models.delta import \
        full_existing_encode
    from karpenter_provider_aws_tpu_torch.models.encoding import \
        encode_snapshot
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver

    def solver_for(dev, **attrs):
        s = CUDASolver(device=dev)
        if max_groups is not None:
            s.dev_max_groups = max_groups
        for k, v in attrs.items():
            setattr(s, k, v)
        return s

    fenv.reset_pod_counter()
    env = fenv.Environment()
    t0 = time.perf_counter()
    snap = examples.config7(env, n_pods=n_pods, n_sigs=n_sigs)
    build_s = time.perf_counter() - t0
    solver = solver_for(device)
    enc = encode_snapshot(snap)
    buf, st = solver.pack(enc, *full_existing_encode(enc, []))
    st = dict(st, n_max=solver._bucket)
    T, D, Z, C, G, E, P = (st[k] for k in "T D Z C G E P".split())
    N = E + st["n_max"]
    S = min(solver.dev_pruned_slots, N)
    log(f"[config7] {n_pods} pods, {len(enc.groups)} signatures, built in "
        f"{build_s:.2f} s; statics {st}, S {S}, arena {buf.size} words")
    states, plain_bail, enqueue = [], None, None
    if solver.device.type == "cuda":
        inp = ft._packed_inputs_ref(torch.from_numpy(buf).to(solver.device),
                                    T, D, Z, C, G, E, P, 0, 0, 0)
        c0 = ft.carry0_pruned(inp, N, E)
        g_mid = len(enc.groups) // 2
        _, kept = check_pruned_window(
            "config7 first", inp, c0, 0, window, st, S, cmp,
            keep=range(0, window, window // 4))
        states += kept
        ps = fc.PrunedState(inp, ft.carry0_pruned(inp, N, E), E=E, P=P,
                            S=S)
        fc.pruned_steps(ps, 0, g_mid)
        _, kept = check_pruned_window(
            "config7 mid", inp, ps.carry, g_mid, window, st, S, cmp,
            keep=range(g_mid, g_mid + window, window // 4))
        states += kept
        fin, _ = check_pruned_window("config7 S=1", inp, c0, 0, window, st,
                                     1, cmp)
        plain_bail = int(fin.bail)
        torch.cuda.synchronize()
        log(f"[config7] K6 kernels == plain parts over {window} steps from "
            f"the first carry and from group {g_mid} (S={S}), and from the "
            f"first carry at S=1 (bail after the window: {plain_bail}); "
            f"checks {dict((k, cmp.checks[k]) for k in KERNELS if 'pruned' in k)}")
        # the host's enqueue of the G steps (the scan's loop: two ctypes
        # launches a step, no synchronise) beside the span the card takes
        # for them; then the host's own cost a step, the first
        # C7_ENQUEUE_STEPS enqueued behind a sleep kernel, so that a full
        # launch queue never blocks the host and the card never paces it
        ps = fc.PrunedState(inp, ft.carry0_pruned(inp, N, E), E=E, P=P,
                            S=S)

        def steps(n):
            t0 = time.perf_counter()
            fc.pruned_steps(ps, 0, n)
            return (time.perf_counter() - t0) * 1e6 / n
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        loop_us = steps(G)
        ev[1].record()
        torch.cuda.synchronize()
        # host_us_per_step is the first window, taken as C7_STEP_BEFORE's
        # one window was; the further windows show the spread beside it
        host = []
        for _ in range(C7_ENQUEUE_REPS):
            for dst, src in zip(ps.carry, ft.carry0_pruned(inp, N, E)):
                dst.copy_(src)
            torch.cuda._sleep(200_000_000)
            host.append(steps(C7_ENQUEUE_STEPS))
            torch.cuda.synchronize()
        host_us = host[0]
        enqueue = dict(loop_us_per_step=loop_us,
                       span_us_per_step=ev[0].elapsed_time(ev[1]) * 1e3 / G,
                       host_us_per_step=host_us, host_us_windows=host,
                       host_us_median=statistics.median(host),
                       steps=G, host_steps=C7_ENQUEUE_STEPS,
                       cluster=ps.cluster, rows=ps.rows)
        log(f"[config7] the probe on {ps.rows} selecting clusters of "
            f"{ps.cluster} CTAs a lane; the {G} "
            f"steps enqueued at {loop_us:.2f} us a step, "
            f"the card's span {enqueue['span_us_per_step']:.2f} us a step; "
            f"the host alone (behind a sleep kernel, the first window of "
            f"{C7_ENQUEUE_STEPS} steps) {host_us:.2f} us a step; "
            f"{C7_ENQUEUE_REPS} windows {[round(h, 2) for h in host]}, "
            f"median {enqueue['host_us_median']:.2f}")
        del inp, ps, c0, fin

    fc.reset_launches()
    times, splits, stats = [], [], []
    res = cold = None
    for i in range(rounds + 1):
        t0 = time.perf_counter()
        res = solver.solve(snap)
        dt = (time.perf_counter() - t0) * 1e3
        stats.append(dict(solver.last_dispatch_stats))
        if i:   # round 0 is the warm-up: the cold solve
            times.append(dt)
            splits.append(solver.last_phase_stats)
        else:
            cold = dict(solver.last_phase_stats, wall_ms=dt)
    launches = dict(fc.LAUNCHES)
    kinds = {(d["kernel"], d["bails"]) for d in stats}
    if kinds != {("pruned", 0)}:
        raise AssertionError(f"config 7 solves not all served by the "
                             f"pruned kernel without a bail: {kinds}")
    if solver.device.type == "cuda":
        missing = [k for k in ("unpack_bits", "ffd_pruned_probe",
                               "ffd_pruned_commit", "pack_outputs")
                   if launches[k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the G-axis "
                                 f"path: {missing}")
    # the host engine on the CPU: the pruned cap at 0 routes it there
    host = CUDASolver(device="cpu", incremental=False)
    host.dev_max_groups_pruned = 0
    t0 = time.perf_counter()
    want = host.solve(snap)
    host_ms = (time.perf_counter() - t0) * 1e3
    if host.last_dispatch_stats["kernel"] != "host":
        raise AssertionError("the host-engine reference did not run on the "
                             "host engine")
    if res.decision_fingerprint() != want.decision_fingerprint():
        raise AssertionError("config 7: pruned-kernel decisions differ from "
                             "the host engine's")
    placed = sum(len(n.pod_names) for n in res.new_nodes)
    if placed + len(res.existing_assignments) + len(res.unschedulable) \
            != len(snap.pods):
        raise AssertionError("config 7: not every pod placed or reported")
    # the forced bail: S = 1 on the same snapshot bails, and the solver
    # re-solves the same arena on the device with every slot selected
    s1 = solver_for(device, dev_pruned_slots=1)
    t0 = time.perf_counter()
    r1 = s1.solve(snap)
    s1_ms = (time.perf_counter() - t0) * 1e3
    d1 = s1.last_dispatch_stats
    if (d1["kernel"], d1["reason"], d1["bails"]) != \
            ("pruned", "pruned_bail", 1):
        raise AssertionError(f"the S=1 solve did not bail and re-solve on "
                             f"the pruned kernel: {d1}")
    if solver.device.type == "cuda" and \
            d1["launches"]["ffd_pruned_commit"] < 2 * G:
        raise AssertionError(f"the S=1 solve's re-solve did not run on the "
                             f"card: {d1['launches']}")
    if plain_bail is not None and plain_bail != 1:
        raise AssertionError("the plain parts did not bail at S=1")
    if r1.decision_fingerprint() != want.decision_fingerprint():
        raise AssertionError("config 7: the re-solved S=1 solve differs")
    split = {k: statistics.median(x[k] for x in splits)
             for k in ("group_ms", "encode_ms", "kernel_ms", "decode_ms")}
    summary = dict(p50_ms=statistics.median(times), p99_ms=pct(times, 0.99),
                   rounds=rounds, median_split_ms=split,
                   launches_per_solve=stats[-1]["launches"],
                   bails=sum(d["bails"] for d in stats),
                   slot_bucket=stats[-1]["slot_bucket"], groups=G,
                   signatures=len(enc.groups), host_engine_ms=host_ms,
                   cold=cold, enqueue=enqueue,
                   s1=dict(kernel=d1["kernel"], reason=d1["reason"],
                           bails=d1["bails"], wall_ms=s1_ms,
                           commit_launches=d1["launches"][
                               "ffd_pruned_commit"]))
    log(f"[config7] {res.summary()}; cold solve {json.dumps(cold)}; solve "
        f"p50 {summary['p50_ms']:.3f} ms "
        f"p99 {summary['p99_ms']:.3f} ms over {rounds} rounds; median split "
        f"{json.dumps(split)}; launches per solve "
        f"{summary['launches_per_solve']}; bails 0; fingerprint == host "
        f"engine (CPU, {host_ms:.0f} ms): True; S=1: {summary['s1']}, "
        f"fingerprint equal")
    return launches, summary, (buf, st, S, states)


# ---------------------------------------------------------------------------
# phase 9: the batch path (K4)
# ---------------------------------------------------------------------------

def batch_phase(cmp, device=None, sizes=BATCH_SIZES, rounds=BATCH_ROUNDS,
                n_sigs=96):
    """Drive ``CUDASolver(incremental=False).solve_batch`` on
    ``examples.batch_snapshots`` at each width in ``sizes``: one fused
    ``_dispatch_many`` (F = 4) per batch of 1 + 2*Gp/4 + 1 launches;
    every lane's output row equal to the single packed solve of its arena
    on the card and to the plain versions, every decision to a single
    solve's.
    Returns ({B: launches}, {B: summary}, {B: (lane-axis K1 state,
    statics)})."""
    import numpy as np
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    all_launches, summaries, arenas = {}, {}, {}
    for B in sizes:
        fenv.reset_pod_counter()
        snaps = examples.batch_snapshots(fenv.Environment(), batch=B,
                                         n_sigs=n_sigs)
        solver = CUDASolver(device=device, incremental=False)
        calls = []
        orig = solver._dispatch_many

        def spy(bufs, orig=orig, calls=calls, **statics):
            out = orig(bufs, **statics)
            calls.append((bufs, statics, out))
            return out
        solver._dispatch_many = spy
        fc.reset_launches()
        times, res = [], None
        for i in range(rounds + 1):
            n0 = len(calls)
            t0 = time.perf_counter()
            res = solver.solve_batch(snaps)
            dt = (time.perf_counter() - t0) * 1e3
            ld = solver.last_dispatch_stats
            Gp, Fu = ld["groups"], ld["fuse"]
            lw = {k: v for k, v in ld["launches"].items() if v}
            if len(calls) != n0 + 1 or ld["kernel"] != "batch" \
                    or ld["batch"] != B or Fu != 4:
                raise AssertionError(f"B={B}: not one fused batched "
                                     f"dispatch of {B} lanes: {ld}")
            if solver.device.type == "cuda" and lw != dict(
                    unpack_bits=1, ffd_fused_headroom=Gp // Fu,
                    ffd_fused_commit=Gp // Fu, pack_outputs=1):
                raise AssertionError(f"B={B}: launches {lw} are not 1 + "
                                     f"2*{Gp}/{Fu} + 1")
            if i:
                times.append(dt)
        launches = dict(fc.LAUNCHES)
        single = CUDASolver(device=device, incremental=False)
        stimes, sres = [], None
        for i in range(rounds + 1):
            t0 = time.perf_counter()
            sres = [single.solve(x) for x in snaps]
            if i:
                stimes.append((time.perf_counter() - t0) * 1e3)
        if [r.decision_fingerprint() for r in res] != \
                [r.decision_fingerprint() for r in sres]:
            raise AssertionError(f"B={B}: batched decisions differ from "
                                 "the single solves'")
        bufs, statics, rows = calls[-1]
        T, D, Z, C, G, E, P = (statics[k] for k in "T D Z C G E P".split())
        d_bufs = torch.from_numpy(np.stack(bufs)).to(solver.device)
        outs, indep, per = [], [], []
        for b in range(B):
            one = ft.solve_scan_packed1(d_bufs[b], **statics).cpu().numpy()
            inp = ft._packed_inputs_ref(d_bufs[b], T, D, Z, C, G, E, P, 0, 0,
                                        0, statics["F"])
            per.append(inp)
            indep.append(ft.block_indep(inp.fuse, statics["F"]))
            outs.append(ft._solve_fused_ref(inp, statics["n_max"], E, P,
                                            statics["F"]))
            plain = ft._pack_outputs_ref(*outs[-1]).cpu().numpy()
            if not (np.array_equal(rows[b], one)
                    and np.array_equal(rows[b], plain)):
                raise AssertionError(f"B={B} lane {b}: the batched row "
                                     "differs from the single solve or the "
                                     "plain versions")
        if len({r.tobytes() for r in rows}) != B:
            raise AssertionError(f"B={B}: lanes with equal rows")
        indep = torch.stack(indep)
        k1 = k1_lane_state(d_bufs, statics, outs)
        cluster = None
        if solver.device.type == "cuda":
            check_k1_lanes(B, k1, cmp)
            # both K5 kernels block by block on the batch's lanes, at the
            # cluster size the dispatch took (every block at B = 8, the
            # first BATCH_CHECK_BLOCKS at B = 64)
            stacked = ft.KernelInputs(*[None if f[0] is None else
                                        torch.stack(f) for f in zip(*per)])
            _, _, cluster = check_fused_blocks(
                f"batch B={B}", stacked, statics, cmp, lanes=B,
                blocks=None if B <= 8 else BATCH_CHECK_BLOCKS)
            if cluster != fc.fused_cluster(B, Fu, P, statics["D"],
                                           E + statics["n_max"]):
                raise AssertionError("the check's cluster size is not the "
                                     "dispatch's")
        summaries[B] = dict(
            p50_ms=statistics.median(times), p99_ms=pct(times, 0.99),
            single_p50_ms=statistics.median(stimes), rounds=rounds,
            groups=Gp, slot_bucket=statics["n_max"], fuse=Fu,
            cluster=cluster,
            fused_blocks=ld["fused_blocks"], seq_blocks=ld["seq_blocks"],
            lanes_vectorized_per_block=indep.sum(0).tolist(),
            launches_per_batch=lw)
        all_launches[B] = launches
        arenas[B] = (k1, statics)
        log(f"[batch] B={B}: solve_batch p50 {summaries[B]['p50_ms']:.3f} "
            f"ms p99 {summaries[B]['p99_ms']:.3f} ms (commit cluster "
            f"{cluster}) vs {B} single solves "
            f"p50 {summaries[B]['single_p50_ms']:.3f} ms; one fused "
            f"dispatch of {lw} launches ({ld['fused_blocks']} vectorized "
            f"blocks a lane on average, lanes vectorized per block "
            f"{summaries[B]['lanes_vectorized_per_block']}); every lane == "
            f"its single solve on {solver.device} and the plain versions; "
            f"decisions == single solves'")
    return all_launches, summaries, arenas


def k1_lane_state(bufs, statics, outs):
    """The lane-axis K1 kernels' inputs at a batch's shapes: the [B, W]
    stack, its bool-plane offset and width, and the stacks of the plain
    per-lane solves ``outs`` (takes, leftover, carry)."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.ops.hostpack import (
        in_layout_bool, in_layout_i64, layout_sizes)
    T, D, Z, C, G, E, P = (statics[k] for k in "T D Z C G E P".split())
    F = statics.get("F", 1)
    n_i64 = layout_sizes(in_layout_i64(T, D, Z, C, G, E, P, 0, 0, F))
    n_bits = layout_sizes(in_layout_bool(T, D, Z, C, G, E, P, 0, 0, F))
    takes = torch.stack([o[0] for o in outs])
    lefts = torch.stack([o[1] for o in outs])
    carry = ft.Carry(*[torch.stack(f) for f in zip(*[o[2] for o in outs])])
    return bufs, n_i64, n_bits, takes, lefts, carry


def check_k1_lanes(B, k1, cmp):
    """The lane-axis unpack_bits and pack_outputs at width B against
    their plain versions lane by lane."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    bufs, n_i64, n_bits, takes, lefts, carry = k1
    bits = fc.unpack_bits_lanes(bufs[:, n_i64:], n_bits)
    packed = fc.pack_outputs_lanes(takes, lefts, carry)
    for b in range(B):
        cmp(f"unpack_bits_lanes_b{B}", bits[b],
            ft._unpack_bits_ref(bufs[b, n_i64:], n_bits), f"lane {b}")
        cmp(f"pack_outputs_lanes_b{B}", packed[b], ft._pack_outputs_ref(
            takes[b], lefts[b], ft.Carry(*[f[b] for f in carry])),
            f"lane {b}")


# ---------------------------------------------------------------------------
# phase 11: the topology path (K9)
# ---------------------------------------------------------------------------

def topo_phase(cmp, device=None, n_pods=C3_PODS, rounds=C3_ROUNDS):
    """Drive config 3 through ``CUDASolver().solve`` on the topology
    kernels (``device`` default cuda; the rehearsal passes cpu). On the
    card, first every group's K9 kernel against its plain part from the
    same entry state. Returns (launches of the measured run, summary,
    timing states)."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.models.encoding import \
        encode_snapshot
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.ops import topo_torch as tt
    from karpenter_provider_aws_tpu_torch.ops.topo import \
        build_topo_encoding
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    from karpenter_provider_aws_tpu_torch.solver.cuda import (safe_evcap,
                                                              topo_arrays)

    fenv.reset_pod_counter()
    t0 = time.perf_counter()
    snap = examples.config3(fenv.Environment(), n_pods)
    build_s = time.perf_counter() - t0
    solver = CUDASolver(device=device)
    enc = encode_snapshot(snap)
    tenc = build_topo_encoding(enc, snap, [])
    arrays, rows, stt = topo_arrays(enc, tenc)
    st = dict(stt, n_max=solver._bucket, EVCAP=solver.TOPO_EVCAP,
              PMAX=solver.TOPO_PMAX, T=enc.A.shape[0],
              D=arrays["A"].shape[1], G=len(arrays["n"]))
    n_topo = int(rows["has_topo"].sum())
    log(f"[config3] {n_pods} pods, {len(enc.groups)} groups ({n_topo} with "
        f"topology), built in {build_s:.2f} s; statics {st}")
    states = []
    if solver.device.type == "cuda":
        inp = ft.kernel_inputs_from_numpy(arrays, solver.device)
        trows = tt.topo_rows_from_numpy(rows, solver.device)
        n0 = dict(cmp.checks)
        for kernel, what, got, want in examples.topo_kernel_steps(
                inp, trows, n_max=st["n_max"], P=st["P"], EVCAP=st["EVCAP"],
                PMAX=st["PMAX"], states=states):
            cmp(kernel, got, want, f"config3 {what}")
        # and at the bailing capacities and the bail's re-dispatch's
        for evcap in (1, 2, safe_evcap(arrays, rows)):
            for kernel, what, got, want in examples.topo_kernel_steps(
                    inp, trows, n_max=st["n_max"], P=st["P"], EVCAP=evcap,
                    PMAX=st["PMAX"]):
                cmp(kernel, got, want, f"config3 EVCAP={evcap} {what}")
        torch.cuda.synchronize()
        log(f"[config3] every group's K9 kernel == its plain part from the "
            f"same entry state at EVCAP {st['EVCAP']}, 1, 2 and "
            f"{safe_evcap(arrays, rows)}; checks "
            f"{ {k: cmp.checks[k] - n0[k] for k in TOPO_CHECKED} }")
        states = (inp, trows, st, states)
        # the kernel cases (rows at the last padded index, an undecided
        # slot below a decided one, the ladder filling 64 and 2,048 slots),
        # and rows_last on counter axes of 4,096 rows
        n0 = dict(cmp.checks)
        # (an older checkout timed by hack/k9_ab.py has no wide case)
        wide = getattr(examples, "TOPO_WIDE_COUNTERS", None)
        for case, counters in ([(c, None) for c in examples.TOPO_CASES]
                               + ([("rows_last", wide)] if wide else [])):
            a_c, r_c, s_c = (examples.topo_case(case, counters=counters)
                             if counters else examples.topo_case(case))
            if counters:
                case = f"{case}@{counters}"
            i_c = ft.kernel_inputs_from_numpy(a_c, solver.device)
            t_c = tt.topo_rows_from_numpy(r_c, solver.device)
            for evcap in (1, 2, 128, safe_evcap(a_c, r_c)):
                for kernel, what, got, want in examples.topo_kernel_steps(
                        i_c, t_c, n_max=s_c["n_max"], P=s_c["P"],
                        EVCAP=evcap):
                    cmp(kernel, got, want, f"{case} EVCAP={evcap} {what}")
        torch.cuda.synchronize()
        log(f"[topo cases] {len(examples.TOPO_CASES)} kernel cases and "
            f"rows_last@{wide} at EVCAP 1, 2, 128 and their bails' "
            f"re-dispatch capacity: every K9 kernel == its plain part; "
            f"checks "
            f"{ {k: cmp.checks[k] - n0[k] for k in TOPO_CHECKED} }")

    fc.reset_launches()
    times, splits, stats = [], [], []
    res = cold = None
    for i in range(rounds + 1):
        t0 = time.perf_counter()
        res = solver.solve(snap)
        dt = (time.perf_counter() - t0) * 1e3
        stats.append(dict(solver.last_dispatch_stats))
        if i:   # round 0 is the warm-up
            times.append(dt)
            splits.append(solver.last_phase_stats)
        else:
            cold = dict(solver.last_phase_stats, wall_ms=dt)
    launches = dict(fc.LAUNCHES)
    kinds = {(d["kernel"], d["bails"]) for d in stats}
    if kinds != {("topo", 0)}:
        raise AssertionError(f"config 3 solves not all served by the "
                             f"topology kernels without a bail: {kinds}")
    per = stats[-1]["launches"]
    if solver.device.type == "cuda":
        Gp = st["G"]
        want = dict(topo_group_start=n_topo, topo_pour=n_topo,
                    ffd_slot_headroom=Gp - n_topo,
                    ffd_group_commit=Gp - n_topo)
        # one statics launch a chunk of topology groups (an older
        # checkout timed by hack/k9_ab.py has none)
        if "topo_pool_statics" in fc.LAUNCHES:
            want["topo_pool_statics"] = -(-n_topo // tt.statics_chunk(
                st["P"], st["T"], st["Z"]))
        got = {k: per[k] for k in want}
        if got != want:
            raise AssertionError(f"config 3 launches per solve {got}, "
                                 f"expected {want}")
    # the host pour on the CPU: a group cap of 0 routes the solve there
    host = CUDASolver(device="cpu", incremental=False)
    host.dev_max_groups = 0
    t0 = time.perf_counter()
    want_res = host.solve(snap)
    host_ms = (time.perf_counter() - t0) * 1e3
    if (host.last_dispatch_stats["kernel"],
            host.last_dispatch_stats["reason"]) != ("host", "group_cap"):
        raise AssertionError("the host-pour reference did not run on the "
                             "host pour")
    if res.decision_fingerprint() != want_res.decision_fingerprint():
        raise AssertionError("config 3: topology-kernel decisions differ "
                             "from the host pour's")
    placed = sum(len(n.pod_names) for n in res.new_nodes)
    if placed + len(res.existing_assignments) + len(res.unschedulable) \
            != len(snap.pods):
        raise AssertionError("config 3: not every pod placed or reported")
    # the forced bail: EVCAP = 1 overflows every topology group's log,
    # and the solver solves the same inputs again on the device
    s1 = CUDASolver(device=device)
    s1.TOPO_EVCAP = 1
    t0 = time.perf_counter()
    r1 = s1.solve(snap)
    s1_ms = (time.perf_counter() - t0) * 1e3
    d1 = s1.last_dispatch_stats
    if (d1["kernel"], d1["reason"], d1["bails"]) != \
            ("topo", "topo_bail", 1):
        raise AssertionError(f"the EVCAP=1 solve did not bail and re-solve "
                             f"on the topology kernels: {d1}")
    if solver.device.type == "cuda" and \
            d1["launches"]["topo_pour"] != 2 * n_topo:
        raise AssertionError(f"the EVCAP=1 re-solve did not run on the "
                             f"card: {d1['launches']}")
    if r1.decision_fingerprint() != want_res.decision_fingerprint():
        raise AssertionError("config 3: the re-solved EVCAP=1 solve "
                             "differs")
    split = {k: statistics.median(x[k] for x in splits)
             for k in ("group_ms", "encode_ms", "kernel_ms", "decode_ms")}
    summary = dict(p50_ms=statistics.median(times), p99_ms=pct(times, 0.99),
                   rounds=rounds, median_split_ms=split,
                   launches_per_solve=per, bails=0,
                   slot_bucket=stats[-1]["slot_bucket"], groups=st["G"],
                   topo_groups=n_topo, host_pour_ms=host_ms, cold=cold,
                   evcap1=dict(kernel=d1["kernel"], reason=d1["reason"],
                               bails=d1["bails"], evcap=d1["evcap"],
                               wall_ms=s1_ms,
                               pour_launches=d1["launches"]["topo_pour"]))
    log(f"[config3] {res.summary()}; cold solve {json.dumps(cold)}; solve "
        f"p50 {summary['p50_ms']:.3f} ms p99 {summary['p99_ms']:.3f} ms "
        f"over {rounds} rounds; median split {json.dumps(split)}; launches "
        f"per solve {per}; bails 0; fingerprint == host pour (CPU, "
        f"{host_ms:.0f} ms): True; EVCAP=1: {summary['evcap1']}, "
        f"fingerprint equal")
    return launches, summary, states


def round_recorder(solver):
    """Wrap ``solver._solve_core`` on the instance (here, never in the
    package) to keep each relax round's snapshot, its grouping and the
    round's dispatch and phase evidence; returns the list it fills."""
    rounds = []
    core = solver._solve_core

    def wrapped(snapshot, pod_groups=None):
        res = core(snapshot, pod_groups=pod_groups)
        rounds.append(dict(snapshot=snapshot, groups=pod_groups,
                           dispatch=dict(solver.last_dispatch_stats),
                           phase=dict(solver.last_phase_stats)))
        return res

    solver._solve_core = wrapped
    return rounds


def check_round_kernels(cmp, rnd, device, label):
    """Every K9 kernel of one relax round (and K2's plain-group commit
    with its record) against its plain part from the same entry state, on
    the round's own hardened snapshot at the slot bucket and event
    capacity the round ran at. Returns (groups, topology groups)."""
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.models.encoding import \
        encode_snapshot
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.ops import topo_torch as tt
    from karpenter_provider_aws_tpu_torch.ops.topo import \
        build_topo_encoding
    from karpenter_provider_aws_tpu_torch.solver.cuda import topo_arrays

    snap, d = rnd["snapshot"], rnd["dispatch"]
    enc = encode_snapshot(snap, pod_groups=rnd["groups"])
    tenc = build_topo_encoding(enc, snap, [])
    arrays, rows, stt = topo_arrays(enc, tenc)
    inp = ft.kernel_inputs_from_numpy(arrays, device)
    trows = tt.topo_rows_from_numpy(rows, device)
    for kernel, what, got, want in examples.topo_kernel_steps(
            inp, trows, n_max=d["slot_bucket"], P=stt["P"],
            EVCAP=d["evcap"]):
        cmp(kernel, got, want, f"{label} {what}")
    return len(arrays["n"]), int(rows["has_topo"].sum())


def prefs_phase(cmp, device=None, n_pods=C6_PODS, rounds=C6_ROUNDS):
    """Drive config 6 through ``CUDASolver().solve`` with ``metrics`` set
    (``device`` default cuda; the rehearsal passes cpu): every relax
    round on the topology kernels, the relaxation counted, and on the
    card every round's K9 kernels against their plain parts; the
    decisions against the port's CPU oracle on the same snapshot.
    Returns (launches of the measured run, summary)."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.models import encoding as penc
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.solver import CPUSolver, CUDASolver
    from karpenter_provider_aws_tpu_torch.utils.metrics import Metrics

    relax = "karpenter_solver_preference_relaxation_rounds_total"
    fenv.reset_pod_counter()
    t0 = time.perf_counter()
    snap = examples.config6(fenv.Environment(), n_pods)
    log(f"[config6] {n_pods} pods built in "
        f"{time.perf_counter() - t0:.2f} s")
    solver = CUDASolver(device=device)
    if penc._groupwalk() is None:
        raise AssertionError("the grouping walk's C extension did not build")
    solver.metrics = Metrics()
    per_round = round_recorder(solver)
    fc.reset_launches()
    times, splits, per_solve = [], [], []
    res = None
    for i in range(rounds + 1):
        n0 = len(per_round)
        r0 = solver.metrics.counter(relax)
        t0 = time.perf_counter()
        res = solver.solve(snap)
        dt = (time.perf_counter() - t0) * 1e3
        mine = per_round[n0:]
        extra = solver.metrics.counter(relax) - r0
        if extra < 1 or len(mine) != extra + 1:
            raise AssertionError(f"config 6 solve {i}: {extra} extra "
                                 f"round(s) counted, {len(mine)} run")
        kinds = {(r["dispatch"]["kernel"], r["dispatch"]["reason"])
                 for r in mine}
        if kinds != {("topo", None)}:
            raise AssertionError(f"config 6 rounds not all on the topology "
                                 f"kernels without a bail: {kinds}")
        per_solve.append([r["dispatch"]["launches"] for r in mine])
        if i:   # solve 0 is the warm-up
            times.append(dt)
            splits.append(dict(
                group_ms=mine[0]["phase"]["group_ms"],
                **{k: sum(r["phase"][k] for r in mine)
                   for k in ("encode_ms", "kernel_ms", "decode_ms")},
                wrapper_ms=dt - mine[0]["phase"]["group_ms"] - sum(
                    r["phase"][k] for r in mine
                    for k in ("encode_ms", "kernel_ms", "decode_ms"))))
    launches = dict(fc.LAUNCHES)
    dev = solver.device
    checked = []
    if dev.type == "cuda":
        # every round of the last solve: K9 (and the plain groups'
        # commit) against the plain parts, and its launches counted
        n0 = dict(cmp.checks)
        for j, rnd in enumerate(per_round[-len(per_solve[-1]):]):
            G, n_topo = check_round_kernels(cmp, rnd, dev,
                                            f"config6 round {j}")
            got = rnd["dispatch"]["launches"]
            want = dict(topo_group_start=n_topo, topo_pour=n_topo,
                        ffd_slot_headroom=G - n_topo,
                        ffd_group_commit=G - n_topo)
            scans = 1 + rnd["dispatch"]["retries"]
            if any(got[k] != scans * v for k, v in want.items()):
                raise AssertionError(f"config 6 round {j} launches {got}, "
                                     f"expected {scans} x {want}")
            checked.append(dict(groups=G, topo_groups=n_topo,
                                slot_bucket=rnd["dispatch"]["slot_bucket"],
                                evcap=rnd["dispatch"]["evcap"],
                                launches={k: v for k, v in got.items()
                                          if v}))
        torch.cuda.synchronize()
        log(f"[config6] every round's K9 kernel (and plain-group commit) "
            f"== its plain part from the same entry state: "
            f"{json.dumps(checked)}; checks "
            f"{ {k: cmp.checks[k] - n0[k] for k in TOPO_CHECKED} }")
    # the decisions: the port's CPU oracle on the same snapshot
    t0 = time.perf_counter()
    oracle = CPUSolver().solve(snap)
    oracle_ms = (time.perf_counter() - t0) * 1e3
    if res.decision_fingerprint() != oracle.decision_fingerprint():
        raise AssertionError("config 6: decisions differ from the CPU "
                             "oracle's")
    placed = sum(len(n.pod_names) for n in res.new_nodes)
    if placed + len(res.existing_assignments) + len(res.unschedulable) \
            != len(snap.pods):
        raise AssertionError("config 6: not every pod placed or reported")
    split = {k: statistics.median(s[k] for s in splits)
             for k in ("group_ms", "encode_ms", "kernel_ms", "decode_ms",
                       "wrapper_ms")}
    p50, p99 = p50_p99(times)
    summary = dict(p50_ms=p50, p99_ms=p99, rounds=rounds,
                   relax_rounds=len(per_solve[-1]) - 1,
                   median_split_ms=split,
                   launches_per_solve=[{k: v for k, v in x.items() if v}
                                       for x in per_solve[-1]],
                   rounds_checked=checked,
                   unschedulable=len(res.unschedulable), oracle_ms=oracle_ms)
    log(f"[config6] {res.summary()}; solve p50 {p50:.3f} ms p99 "
        f"{p99:.3f} ms over {rounds} solves of "
        f"{summary['relax_rounds'] + 1} rounds each; median split "
        f"{json.dumps(split)}; fingerprint == the CPU oracle's "
        f"({oracle_ms:.0f} ms): True")
    return launches, summary


def config2_arch(env, n_pods, zone_id=False):
    """Config 2's shape with one more deployment whose topology the pour
    does not model: a spread over the arch key (or, with ``zone_id``, a
    zone spread beside a zone-id requirement)."""
    from karpenter_provider_aws_tpu_torch.apis import labels as L
    from karpenter_provider_aws_tpu_torch.apis.objects import \
        TopologySpreadConstraint
    from karpenter_provider_aws_tpu_torch.fake.environment import make_pods
    from karpenter_provider_aws_tpu_torch import examples
    snap = examples.config2(env, n_pods)
    extra = make_pods(
        40, cpu="500m", memory="1Gi", prefix="odd", group="odd",
        node_selector={L.ZONE_ID: "usw2-az1"} if zone_id else None,
        topology_spread=[TopologySpreadConstraint(
            max_skew=1, topology_key=L.ZONE if zone_id else L.ARCH,
            when_unsatisfiable="DoNotSchedule", group="odd")])
    return env.snapshot(list(snap.pods) + extra, [env.nodepool("bench-pool")])


def oracle_phase(device=None, n_pods=C17_PODS):
    """The oracle route: config 2's shape plus a group the pour does not
    model, through ``CUDASolver().solve`` (``device`` default cuda): the
    oracle serves it with no launch; the same solver's next config-2
    tick runs on the card and equals a fresh solver's. Returns a
    summary."""
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    from karpenter_provider_aws_tpu_torch.utils.metrics import Metrics

    env = fenv.Environment()
    solver = CUDASolver(device=device)
    solver.metrics = Metrics()
    out = {}
    for case, zid in (("arch", False), ("zone_id", True)):
        fenv.reset_pod_counter()
        snap = config2_arch(env, n_pods, zone_id=zid)
        before = dict(fc.LAUNCHES)
        t0 = time.perf_counter()
        res = solver.solve(snap)
        wall = (time.perf_counter() - t0) * 1e3
        d = solver.last_dispatch_stats
        if (d["kernel"], d["reason"]) != ("oracle", "unsupported_topology") \
                or dict(fc.LAUNCHES) != before:
            raise AssertionError(f"oracle route ({case}): {d}, launches "
                                 f"moved: {dict(fc.LAUNCHES) != before}")
        out[case] = dict(pods=len(snap.pods), topo_reason=d["topo_reason"],
                         wall_ms=wall, oracle_ms=solver.last_phase_stats[
                             "kernel_ms"], summary=res.summary())
    if solver.metrics.counter("karpenter_solver_oracle_fallback_total",
                              {"reason": "unsupported-topology"}) != 2:
        raise AssertionError("the oracle fallbacks were not counted")
    # ROADMAP hazard 97 on the card: the next tick on the same solver
    fenv.reset_pod_counter()
    snap2 = examples.config2(env, n_pods)
    before = dict(fc.LAUNCHES)
    res = solver.solve(snap2)
    d = solver.last_dispatch_stats
    ran = {k: v - before[k] for k, v in fc.LAUNCHES.items() if v - before[k]}
    on_card = solver.device.type != "cuda" or (
        ran.get("ffd_group_commit", 0) > 0 and ran.get("pack_outputs", 0) > 0)
    if d["kernel"] in ("oracle", "host") or not on_card:
        raise AssertionError(f"the tick after the oracle did not run on the "
                             f"card: {d['kernel']}, {ran}")
    fresh = CUDASolver(device=device).solve(snap2)
    if res.decision_fingerprint() != fresh.decision_fingerprint():
        raise AssertionError("the tick after the oracle differs from a "
                             "fresh solver's")
    out["next_tick"] = dict(kernel=d["kernel"], reason=d["reason"],
                            launches=ran)
    log(f"[oracle] {json.dumps(out)}; the next config-2 tick on the same "
        f"solver == a fresh solver's: True")
    return ran, out


def walk_times(n_pods=PODS, reps=WALK_REPS):
    """``group_ms`` of config 2 and config 3 (the grouping walk that
    ``Solver.solve`` times), with the C walk and with the Python loop, in
    turns in one process; host times. Returns {config: {c, python}}."""
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.models import encoding as penc
    gw = penc._groupwalk()
    if gw is None:
        raise AssertionError("the grouping walk's C extension did not build")
    out = {}
    for name, build in (("config2", examples.config2),
                        ("config3", examples.config3)):
        fenv.reset_pod_counter()
        pods = build(fenv.Environment(), n_pods).pods
        penc.canonical_pod_groups(pods)   # intern: the warm walk is timed
        ms = {"c": [], "python": []}
        for i in range(reps):
            for which in (("c", "python") if i % 2 == 0
                          else ("python", "c")):
                penc._GROUPWALK = gw if which == "c" else None
                t0 = time.perf_counter()
                penc.canonical_pod_groups(pods)
                ms[which].append((time.perf_counter() - t0) * 1e3)
        penc._GROUPWALK = gw
        out[name] = {k: statistics.median(v) for k, v in ms.items()}
    log(f"[walk] group_ms p50 over {reps} walks each at {n_pods} pods "
        f"(host times): {json.dumps(out)}")
    return out


#: the absorption scan's forms, forced by shape: E with the form each
#: gives at D = 8 (csrc/consolidation.cu; the card test
#: test_consol_absorb_forms_match_plain)
ABSORB_FORM_SHAPES = {"registers": 1000, "registers_full": 1024,
                      "shared": 1100, "shared_wide": 2048, "global": 4096}


def check_absorb_forms(cmp, dev):
    """consol_absorb in each form of its scan (rows in registers, in
    shared memory, in the global scratch), every mode against its plain
    version on the hazard cases; one lane and 256 lanes (at 1,500 nodes
    rows in shared memory); K8 with slacks or R past 2^51 and a negative
    R (``examples.preempt_wide_values``), and at the preemption round's
    width (64 lanes, 1,000 nodes, D = 6) for each wide wave's G. Returns
    the number of cases."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    from karpenter_provider_aws_tpu_torch.scheduling import preempt_torch as pt

    def cuda(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]
    names = ("ex_alloc", "ex_used0", "compat", "R", "gid", "cid", "n",
             "alive")
    ps_names = ("type_alloc", "type_price", "tcompat", "padmit",
                "pool_types", "price_cap")
    cases = 0
    for hazard in examples.ABSORB_HAZARDS:
        for form, E in ABSORB_FORM_SHAPES.items():
            a = cuda(*examples.absorb_case(hazard, 5, E=E, G=6))
            ps = cuda(*examples.prescreen_tables(5))
            dn = cuda(*examples.dense_case(hazard, 5, E=E, G=6))
            kw = dict(zip(names, a))
            what = f"{hazard} {form} E={E}"
            cmp("consol_absorb_deletions",
                cc.consol_absorb("deletions", **kw),
                ct._deletions_feasible_ref(*a), what)
            cmp("consol_absorb_prescreen",
                cc.consol_absorb("prescreen", **kw,
                                 **dict(zip(ps_names, ps))),
                ct._replacements_prescreen_ref(*a[:4], *ps[:5], *a[4:],
                                               ps[5]), what)
            cmp("consol_absorb_dense", cc.consol_absorb(
                "dense", **dict(zip(("ex_alloc", "ex_used0", "compat", "R",
                                     "n"), dn))),
                ct._deletions_feasible_dense_ref(*dn), what)
            cases += 1
    for B in (1, 256):
        for E in (200, 1000, 1500):
            a = cuda(*examples.absorb_case("zero_r_row", 6, B=B, E=E))
            ps = cuda(*examples.prescreen_tables(6, B=B))
            dn = cuda(*examples.dense_case("overcommitted", 6, B=B, E=E))
            pa = (*a[:4], *ps[:5], *a[4:], ps[5])
            what = f"B={B} E={E}"
            cmp("consol_absorb_deletions", ct.deletions_feasible(*a),
                ct._deletions_feasible_ref(*a), what)
            cmp("consol_absorb_prescreen", ct.replacements_prescreen(*pa),
                ct._replacements_prescreen_ref(*pa), what)
            cmp("consol_absorb_dense", ct.deletions_feasible_dense(*dn),
                ct._deletions_feasible_dense_ref(*dn), what)
            t = cuda(*examples.preempt_case("refund_above_used", 3, E=E,
                                            G=8, B=B))
            cmp("consol_absorb_preempt", pt.preempt_solve(*t),
                pt._preempt_solve_ref(*t), what)
            cases += 1
    for seed in range(3):       # quotients past their fp64 range
        for small in (False, True):
            for E in (700, 1100):
                t = cuda(*examples.preempt_wide_values(seed, E=E,
                                                       small=small))
                cmp("consol_absorb_preempt", cc.preempt_absorb(*t),
                    pt._preempt_solve_ref(*t),
                    f"wide values seed={seed} small={small} E={E}")
                cases += 1
    for G in P12_WIDE_G:
        for hazard in ("plain", "zero_r_row", "overcommitted"):
            t = cuda(*examples.preempt_case(hazard, 2, E=P12_NODES, G=G, D=6,
                                            B=64))
            cmp("consol_absorb_preempt", cc.preempt_absorb(*t),
                pt._preempt_solve_ref(*t), f"{hazard} B=64 G={G}")
            cases += 1
    return cases


def check_absorb_edges(cmp, dev):
    """No lanes (B = 0: no launch, an empty answer) and no groups (G = 0:
    one launch) in every consol_absorb mode against the plain versions,
    and a subset round of no groups (Gq = 0: no launch, the reference's
    rows [0, 0, 0, 0, removed_price]) against the plain round. Returns the
    number of cases."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.scheduling import preempt_torch as pt

    def cuda(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]
    a = cuda(*examples.absorb_case("plain", 7))
    ps = cuda(*examples.prescreen_tables(7))
    dn = cuda(*examples.dense_case("plain", 7))
    pr = cuda(*examples.preempt_case("plain", 7))
    cases = 0
    for what, lanes, groups in (("B=0", lambda x: x[:0], lambda x: x),
                                ("G=0", lambda x: x, lambda x: x[:, :0])):
        sa = [*a[:4], *(groups(lanes(x)) for x in a[4:7]), lanes(a[7])]
        pa = (*sa[:4], *ps[:5], *sa[4:], lanes(ps[5]))
        sd = [lanes(x) for x in dn[:2]] + [groups(lanes(x)) for x in dn[2:]]
        gp = (lambda x: x[:0]) if what == "G=0" else (lambda x: x)
        sp = [*pr[:2], *(gp(x) for x in pr[2:5]), lanes(pr[5])]
        fc.reset_launches()
        got = [ct.deletions_feasible(*sa), ct.replacements_prescreen(*pa),
               ct.deletions_feasible_dense(*sd), pt.preempt_solve(*sp)]
        n = sum(v for k, v in fc.LAUNCHES.items()
                if k.startswith("consol_absorb"))
        if n != (0 if what == "B=0" else 4):
            raise AssertionError(f"absorb at {what}: {n} launches")
        for name, x, y in zip(
                ("consol_absorb_deletions", "consol_absorb_prescreen",
                 "consol_absorb_dense", "consol_absorb_preempt"), got,
                (ct._deletions_feasible_ref(*sa),
                 ct._replacements_prescreen_ref(*pa),
                 ct._deletions_feasible_dense_ref(*sd),
                 pt._preempt_solve_ref(*sp))):
            cmp(name, x, y, what)
        cases += 1
    # F7: a subset round of zero groups
    arena, tprice, lanes_np, st = examples.subset_case("dead_nodes", 4, B=4)
    inp = ft.kernel_inputs_from_numpy(arena, dev)
    tp = torch.from_numpy(tprice).to(dev)
    t = {k: torch.from_numpy(v).to(dev) for k, v in lanes_np.items()}
    t["gid"], t["n"] = t["gid"][:, :0], t["n"][:, :0]
    order = ("gid", "n", "dead", "keep", "removed_price")
    fc.reset_launches()
    rows = ct.subset_solve(inp, tp, *(t[k] for k in order), **st)
    if any(fc.LAUNCHES.values()):
        raise AssertionError(f"a subset round of Gq = 0 launched "
                             f"{ {k: v for k, v in fc.LAUNCHES.items() if v} }")
    # no kernel ran: held to the plain round here, not under a kernel's row
    want = ct._subset_solve_ref(inp, tp, *(t[k] for k in order), **st)
    if rows.device != want.device or not torch.equal(rows, want):
        raise AssertionError(f"a subset round of Gq = 0: {rows.tolist()} != "
                             f"the plain round's {want.tolist()}")
    return cases + 1


# ---------------------------------------------------------------------------
# phase 12: the preemption path (K8)
# ---------------------------------------------------------------------------

def check_k8_hazards(cmp, dev):
    """K8 against its plain version on every ``examples.preempt_case``
    hazard table (two seeds each). Returns the number of tables."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.scheduling import preempt_torch as pt
    n = 0
    for hazard in examples.PREEMPT_HAZARDS:
        for seed in (0, 1):
            t = [torch.from_numpy(a).to(dev)
                 for a in examples.preempt_case(hazard, seed)]
            cmp("consol_absorb_preempt", pt.preempt_solve(*t),
                pt._preempt_solve_ref(*t), f"{hazard} seed={seed}")
            n += 1
    return n


def verdict_fingerprint(v):
    """tests/test_preempt.py ``verdict_fingerprint``: the decision, not
    the backend."""
    if v is None:
        return None
    return (v.feasible, v.lanes, v.leftovers,
            tuple(p.full_name() for p in v.victims),
            tuple(p.full_name() for p in v.demand),
            v.command.to_bytes() if v.command is not None else None)


def round_fields(res):
    return (tuple(sorted(res.unschedulable)),
            tuple(sorted(res.nominated.items())),
            tuple(sorted(res.preempted.items())),
            verdict_fingerprint(res.preempt),
            [c.name for c in res.created_claims])


def preempt_phase(cmp, device=None, n_nodes=P12_NODES, per_node=P12_PER_NODE,
                  seed=P12_SEED, rounds=P12_ROUNDS,
                  reconciles=P12_RECONCILES):
    """The preemption round through ``Provisioner.reconcile`` (``device``
    default cuda; the rehearsal passes cpu): K8 against its plain version
    on the hazard tables; ``planner.plan`` timed over ``rounds`` after one
    warm-up on the cluster's own snapshot (plan mutates nothing); then
    ``reconciles`` rounds, each on a fresh cluster from ``seed``, with
    every launch counter set to 0 just before and read just after; the
    first round's result against the same round on the plain versions;
    K8 on the round's own tables against its plain version; the
    infeasible variant (no prefix of 64 frees enough); and K8 against its
    plain version on the tables of waves of ``P12_WIDE_G`` signatures.
    Returns (launches of the measured run, summary, the round's K8
    tables, {G: the wide waves' K8 tables})."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.cloudprovider.provider import \
        CloudProvider
    from karpenter_provider_aws_tpu_torch.controllers.provisioning import \
        Provisioner
    from karpenter_provider_aws_tpu_torch.fake.environment import \
        Environment
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.scheduling import (
        MAX_LANES, PreemptionPlanner)
    from karpenter_provider_aws_tpu_torch.scheduling import preempt_torch as pt
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    from karpenter_provider_aws_tpu_torch.state.cluster import ClusterState

    on_card = torch.device(device or "cuda").type == "cuda"
    if on_card:
        n_haz = check_k8_hazards(cmp, torch.device("cuda"))
        log(f"[preempt] K8 == plain on {n_haz} hazard tables")
    env = Environment()
    api = examples.preempt_api()

    def build(**kw):
        t0 = time.perf_counter()
        c = examples.preempt_cluster(api, n_nodes, per_node, seed, env=env,
                                     **kw)
        return c, time.perf_counter() - t0

    def provisioner(c, solver):
        planner = PreemptionPlanner(solver=solver)
        prov = Provisioner(c.kube, ClusterState(c.kube, clock=lambda: 0.0),
                           CloudProvider(c.kube, c.env.instance_types),
                           solver, clock=lambda: 0.0,
                           preempt_planner=planner)
        return prov, planner

    solver = CUDASolver(device=device)
    cap = Captured(solver, "dispatch_preempt")
    # plan alone, on the first round's snapshot and leftovers
    c, build_s = build()
    prov, planner = provisioner(c, solver)
    snap = prov.build_snapshot(prov.state.pending_pods())
    base = solver.solve(snap)
    unsched = list(base.unschedulable)
    E = len(snap.existing_nodes)
    log(f"[preempt] {n_nodes} nodes x {per_node} pods (seed {seed}) built "
        f"in {build_s:.2f} s: {len(snap.pods)} pending, E = {E}, base "
        f"solve {base.summary()}")
    times, splits = [], []
    first = None
    for i in range(rounds + 1):
        t0 = time.perf_counter()
        v = planner.plan(snap, unsched, prov.state)
        dt = (time.perf_counter() - t0) * 1e3
        if first is None:
            first = verdict_fingerprint(v)
        elif verdict_fingerprint(v) != first:
            raise AssertionError("preempt: plan moved between rounds")
        if i:   # round 0 is the warm-up
            times.append(dt)
            splits.append(dict(planner.last_phase_stats))
    kw = cap.last[1]
    B, Ee, D = kw["freed"].shape
    G = kw["R"].shape[0]
    plan = dict(p50_ms=statistics.median(times), p99_ms=pct(times, 0.99),
                rounds=rounds, median_split_ms={
                    k: statistics.median(x[k] for x in splits)
                    for k in splits[0]}, B=B, E=Ee, D=D, G=G)
    log(f"[preempt] plan p50 {plan['p50_ms']:.3f} ms p99 "
        f"{plan['p99_ms']:.3f} ms over {rounds} rounds; median split "
        f"{json.dumps(plan['median_split_ms'])}; lanes B = {B}, E = {Ee}, "
        f"D = {D}, G = {G}")

    # the main path: reconciles on fresh clusters of the same seed
    clusters = [build()[0] for _ in range(reconciles)]
    provs = [provisioner(x, solver) for x in clusters]
    if on_card:
        torch.cuda.synchronize()
    fc.reset_launches()
    walls, results, recs = [], [], []
    for prov_i, _planner in provs:
        cap.stats = None
        t0 = time.perf_counter()
        results.append(prov_i.reconcile())
        walls.append((time.perf_counter() - t0) * 1e3)
        recs.append(cap.stats)
    launches = dict(fc.LAUNCHES)
    res = results[0]
    v = res.preempt
    if any(round_fields(r) != round_fields(res) for r in results):
        raise AssertionError("preempt: the rounds on one seed differ")
    if not (v is not None and v.feasible and v.backend == "device"):
        raise AssertionError(f"preempt: verdict {v and (v.feasible, v.backend, v.reason)} "
                             "is not a feasible device verdict")
    if not (len(v.victims) > 1 and v.leftovers[0] > 0
            and v.lanes == MAX_LANES):
        raise AssertionError(f"preempt: the chosen prefix ({len(v.victims)} "
                             f"victims, lanes {v.leftovers}) is not several "
                             f"victims after an infeasible lane")
    if any(r is None or r["kernel"] != "preempt" or r["batch"] != MAX_LANES
           for r in recs):
        raise AssertionError(f"preempt: dispatch records {recs}")
    if on_card and launches["consol_absorb_preempt"] != reconciles:
        raise AssertionError(f"preempt: {launches['consol_absorb_preempt']} "
                             f"K8 launches in {reconciles} plans")
    if res.created_claims:
        raise AssertionError("preempt: a preemption round minted a node")
    # the same round on the plain versions, on the CPU
    cpu_c, _ = build()
    cpu_prov, _p = provisioner(cpu_c, CUDASolver(device="cpu"))
    t0 = time.perf_counter()
    want = cpu_prov.reconcile()
    cpu_ms = (time.perf_counter() - t0) * 1e3
    if round_fields(want) != round_fields(res):
        raise AssertionError("preempt: the round differs from the plain "
                             "versions' round")
    tables = None
    if on_card:
        t = [torch.from_numpy(np_a).to("cuda") for np_a in (
            kw["ex_alloc"], kw["ex_used"], kw["ex_compat"], kw["R"],
            kw["n"], kw["freed"])]
        cmp("consol_absorb_preempt", pt.preempt_solve(*t),
            pt._preempt_solve_ref(*t), "the round's tables")
        tables = t
    # the infeasible variant: no prefix of 64 frees four CPUs on a node
    ic, _ = build(wave_cpu=("4",))
    iprov, _ip = provisioner(ic, solver)
    cap.stats = None
    t0 = time.perf_counter()
    ires = iprov.reconcile()
    inf_ms = (time.perf_counter() - t0) * 1e3
    iv = ires.preempt
    if iv is None or iv.feasible or iv.lanes != MAX_LANES \
            or not all(x > 0 for x in iv.leftovers) or ires.preempted \
            or cap.stats is None or cap.stats["kernel"] != "preempt":
        raise AssertionError(f"preempt: the infeasible variant "
                             f"{iv and (iv.feasible, iv.leftovers)} "
                             f"evicted {len(ires.preempted)}")
    if on_card:
        ikw = cap.last[1]
        it = [torch.from_numpy(np_a).to("cuda") for np_a in (
            ikw["ex_alloc"], ikw["ex_used"], ikw["ex_compat"], ikw["R"],
            ikw["n"], ikw["freed"])]
        cmp("consol_absorb_preempt", pt.preempt_solve(*it),
            pt._preempt_solve_ref(*it), "the infeasible round's tables")
    # wider waves: G signatures of one pod each, every one too large for
    # a node's slack, so the whole wave is the planner's demand
    wide = {}
    for g in P12_WIDE_G:
        wc, _ = build(wave=g, wave_cpu=tuple(f"{300 + i}m" for i in range(g)))
        wprov, wplanner = provisioner(wc, solver)
        wsnap = wprov.build_snapshot(wprov.state.pending_pods())
        wv = wplanner.plan(wsnap, list(solver.solve(wsnap).unschedulable),
                           wprov.state)
        wkw = cap.last[1]
        if wv.lanes != MAX_LANES or wkw["R"].shape[0] != g:
            raise AssertionError(f"preempt: the {g}-signature wave ran "
                                 f"{wv.lanes} lanes over G = "
                                 f"{wkw['R'].shape[0]}")
        if on_card:
            wt = [torch.from_numpy(np_a).to("cuda") for np_a in (
                wkw["ex_alloc"], wkw["ex_used"], wkw["ex_compat"], wkw["R"],
                wkw["n"], wkw["freed"])]
            cmp("consol_absorb_preempt", pt.preempt_solve(*wt),
                pt._preempt_solve_ref(*wt), f"a {g}-signature wave's tables")
            wide[g] = wt
    cap.restore()
    walls_t = walls[1:] or walls
    summary = dict(
        plan=plan, reconcile_ms=walls, reconcile_p50_ms=statistics.median(
            walls_t), victims=len(v.victims), lanes=v.lanes,
        leftovers=list(v.leftovers[:len(v.victims) + 1]),
        demand=len(v.demand), nominated=len(res.nominated),
        unschedulable=len(res.unschedulable), plain_round_ms=cpu_ms,
        infeasible=dict(leftovers_min=min(iv.leftovers), wall_ms=inf_ms,
                        preempted=len(ires.preempted)),
        launches_per_round={k: n / reconciles
                            for k, n in launches.items() if n})
    log(f"[preempt] {reconciles} reconciles {json.dumps(walls)} ms; "
        f"verdict feasible on the device: {len(v.victims)} victims of "
        f"{v.lanes} lanes, leftovers {list(v.leftovers[:len(v.victims) + 1])}"
        f"; {len(res.nominated)} nominated, {len(res.preempted)} preempted, "
        f"{len(res.unschedulable)} unschedulable; == the plain versions' "
        f"round on the CPU ({cpu_ms:.0f} ms): True; infeasible variant: all "
        f"{iv.lanes} lanes > 0, nothing evicted; launches per round "
        f"{summary['launches_per_round']}; K8 == plain on waves of "
        f"{list(P12_WIDE_G)} signatures")
    return launches, summary, tables, wide


# ---------------------------------------------------------------------------
# K5: the fused block scan (phases 3, 9, 13)
# ---------------------------------------------------------------------------

def lane_inputs(inp, b):
    """Lane ``b`` of a lane-axis KernelInputs."""
    return type(inp)(*[None if f is None else f[b] for f in inp])


def check_fused_blocks(label, inp, st, cmp, lanes=None, keep=(),
                       cluster=None, blocks=None):
    """Both K5 kernels block by block against their plain parts, from the
    plain block-start carry of every lane: each group's candidates,
    headroom and new-node tables after ``ffd_fused_headroom`` (copied out
    before the commit, which turns k into takes and rewrites a sequential
    block's rows), the block's carry, takes and leftover after
    ``ffd_fused_commit`` on ``cluster`` CTAs a lane (None: the card's
    rule). ``inp`` is the arena's KernelInputs on the card (lane axis when
    ``lanes``); ``blocks`` limits the check to the first blocks. Returns
    (the final plain carries, the block-start states of the blocks in
    ``keep``: (g0, carry, branch) of lane 0, for the timing phase, the
    cluster size)."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    E, P, Fu, N = st["E"], st["P"], st["F"], st["E"] + st["n_max"]
    L = 1 if lanes is None else lanes
    per = [inp] if lanes is None else [lane_inputs(inp, b)
                                       for b in range(L)]
    carries = [ft.carry0(x, N, E) for x in per]
    fs = fc.FusedState(inp, ft.carry0(inp, N, E, lanes=lanes), E=E, P=P,
                       Fu=Fu, lanes=lanes, cluster=cluster)
    indep = [ft.block_indep(x.fuse, Fu).tolist() for x in per]

    def lane(t, b):
        return t if lanes is None else t[b]
    kept = []
    for g0 in range(0, st["G"] if blocks is None else blocks * Fu, Fu):
        bi = g0 // Fu
        for b in range(L):
            for dst, src in zip(fs.carry, carries[b]):
                lane(dst, b).copy_(src)
        if bi in keep:
            kept.append((g0, ft.Carry(*[t.clone() for t in carries[0]]),
                         indep[0][bi]))
        fc.ffd_fused_headroom(fs, g0)
        got_cand, got_k = fs.block_cand().clone(), fs.block_k().clone()
        got_tab = [t.clone() for t in fs.block_table()]
        fc.ffd_fused_commit(fs, g0)
        for b in range(L):
            cand, k = ft._fused_headroom_ref(per[b], carries[b], g0, Fu, E=E,
                                             P=P)
            tab = ft._fused_table_ref(per[b], g0, Fu, P=P)
            what = f"{label} lane {b} block {bi}"
            cmp("ffd_fused_headroom", lane(got_cand, b), cand, f"{what} cand")
            cmp("ffd_fused_headroom", lane(got_k, b), k, f"{what} k")
            for nm, got, want in zip(ft.NewNodeTable._fields, got_tab, tab):
                cmp("ffd_fused_headroom", lane(got, b), want, f"{what} {nm}")
            carries[b], takes, lefts = ft._fused_block_ref(
                per[b], carries[b], g0, Fu, indep[b][bi], tab, E=E, P=P)
            for f, got, want in zip(ft.Carry._fields, fs.carry, carries[b]):
                cmp("ffd_fused_commit", lane(got, b), want, f"{what} {f}")
            cmp("ffd_fused_commit", lane(fs.takes, b)[g0:g0 + Fu], takes,
                f"{what} takes")
            cmp("ffd_fused_commit", lane(fs.leftover, b)[g0:g0 + Fu], lefts,
                f"{what} leftover")
    return carries, kept, fs.cluster


def fused_arena(arrays_list, st, dev):
    """A [B, W] stack of fused arenas on ``dev`` and its lane-axis
    KernelInputs (plain unpack)."""
    import numpy as np
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.ops.hostpack import (
        in_layout_bool, in_layout_i64, layout_sizes, pack_inputs1)
    bufs = torch.from_numpy(np.stack([
        pack_inputs1(a, *examples.pack_statics(st))
        for a in arrays_list])).to(dev)
    args = [st[k] for k in "T D Z C G E P K M".split()]
    n_i64 = layout_sizes(in_layout_i64(*args, st["F"], st["Q"]))
    n_bits = layout_sizes(in_layout_bool(*args, st["F"], st["Q"]))
    bools = torch.stack([ft._unpack_bits_ref(b[n_i64:], n_bits)
                         for b in bufs])
    return bufs, ft._unpack_inputs_lanes(bufs[:, :n_i64], bools, *args,
                                         st["Q"], st["F"])


def check_fused_cases(cmp, dev):
    """Phase 3's K5 checks: every ``examples.FUSED_CASES`` arena (at its
    own width, and "striped" at the catalog's 812 types) block by block
    without a lane axis, the commit on 1, 2 and 8 CTAs, and the whole
    packed solve against the plain one; then the lane axis with one lane
    and with three lanes whose blocks branch differently. Returns the
    number of arenas checked."""
    import numpy as np
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    cases = [(c, {}) for c in examples.FUSED_CASES]
    cases.append(("striped", dict(T=812, D=8, G=32, n_max=64)))
    for name, kw in cases:
        arrays, st = examples.fused_case(name, **kw)
        label = f"{name}{'-812' if kw else ''} F={st['F']}"
        bufs, inp = fused_arena([arrays], st, dev)
        one = lane_inputs(inp, 0)
        for cs in (1, 2, 8):
            check_fused_blocks(f"{label} cluster={cs}", one, st, cmp,
                               cluster=cs)
        whole = ft.solve_scan_packed1(bufs[0], **examples.solve_statics(st))
        plain = ft._pack_outputs_ref(*ft._solve_fused_ref(
            one, st["n_max"], st["E"], st["P"], st["F"]))
        cmp("pack_outputs", whole, plain, f"{label} packed solve")
    arrays, st = examples.fused_case("striped", T=812, D=8, G=32, n_max=64)
    lanes = []
    for flip in (None, 1, 5):
        a = {k: np.array(v) for k, v in arrays.items()}
        if flip is not None:
            a["fuse"][flip] = ~a["fuse"][flip]
            a["n"] = np.roll(a["n"], flip)
        lanes.append(a)
    for B in (1, 3):
        bufs, inp = fused_arena(lanes[:B], st, dev)
        if B == 3:
            ind = torch.stack([ft.block_indep(inp.fuse[b], st["F"])
                               for b in range(B)])
            if not (ind.any(0) & ~ind.all(0)).any():
                raise AssertionError("the mixed lanes never branch apart")
        check_fused_blocks(f"striped-812 lanes={B}", inp, st, cmp, lanes=B)
        many = ft.solve_scan_packed1_many(bufs, **examples.solve_statics(st))
        for b in range(B):
            plain = ft._pack_outputs_ref(*ft._solve_fused_ref(
                lane_inputs(inp, b), st["n_max"], st["E"], st["P"],
                st["F"]))
            cmp("pack_outputs", many[b], plain,
                f"striped-812 lanes={B} lane {b} packed solve")
    # more lanes than grid y's 65,535 blocks (hazard 57: the fused
    # commit's clusters spread the lane over grid y and z): 16 mixed
    # striped lanes repeated 4,097 times in one dispatch, each lane equal
    # to the plain solve of its arena
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops.hostpack import pack_inputs1
    lanes, st = examples.fused_mixed_lanes(16)
    small = torch.from_numpy(np.stack([
        pack_inputs1(a, *examples.pack_statics(st)) for a in lanes]))
    reps = examples.FUSED_WIDE_REPS
    before = fc.LAUNCHES["ffd_fused_commit"]
    wide = ft.solve_scan_packed1_many(small.repeat(reps, 1).to(dev),
                                      **examples.solve_statics(st))
    if fc.LAUNCHES["ffd_fused_commit"] - before != st["G"] // st["F"]:
        raise AssertionError("the wide fused round was not one dispatch")
    plain = torch.stack([ft.solve_scan_packed1(
        small[b], **examples.solve_statics(st)) for b in range(16)])
    cmp("ffd_fused_commit", wide, plain.repeat(reps, 1).to(dev),
        f"fused round of {16 * reps} lanes")
    del wide
    return len(cases) + 3


def fused_phase(cmp, device=None, n_pods=S13_PODS, n_sigs=S13_SIGS,
                rounds=S13_ROUNDS, ticks=S13_TICKS, min_vec=S13_MIN_VEC):
    """Drive the striped cluster (``examples.striped_cluster``, n_pods
    over n_sigs signatures, five family NodePools) through
    ``CUDASolver(incremental=False).solve`` on the fused kernels: one
    warm-up and ``rounds`` timed solves with the counters set to 0 just
    before and read just after; then the variant with 100 existing
    nodes, and ``ticks`` incremental rows-tier ticks, each a full fused
    solve. Every solve takes both branches, at least ``min_vec`` blocks
    vectorized. On the card, first both K5 kernels block by block against
    their plain parts on the solver's own arena. Returns (launches of the
    measured runs, summary, timing states)."""
    import dataclasses

    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.models.delta import \
        full_existing_encode
    from karpenter_provider_aws_tpu_torch.models.encoding import \
        encode_snapshot
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    fenv.reset_pod_counter()
    env = fenv.Environment()
    t0 = time.perf_counter()
    snap = examples.striped_cluster(env, n_pods=n_pods, n_sigs=n_sigs)
    snap_ex = examples.striped_cluster(env, n_pods=n_pods, n_sigs=n_sigs,
                                       n_existing=100)
    build_s = time.perf_counter() - t0
    solver = CUDASolver(device=device, incremental=False)
    on_card = solver.device.type == "cuda"

    def measured(s, x, n):
        """One warm-up and n timed solves of x, counters zeroed before
        and read after: (launches, walls, last stats, result)."""
        fc.reset_launches()
        walls, res, kinds = [], None, set()
        for i in range(n + 1):
            t0 = time.perf_counter()
            res = s.solve(x)
            if i:
                walls.append((time.perf_counter() - t0) * 1e3)
            ds = s.last_dispatch_stats
            kinds.add((ds["kernel"], ds["fuse"]))
        if kinds != {("fused", 4)}:
            raise AssertionError(f"striped solves not all fused: {kinds}")
        return dict(fc.LAUNCHES), walls, dict(s.last_dispatch_stats), res

    launches, walls, ds, res = measured(solver, snap, rounds)
    splits = dict(solver.last_phase_stats)
    if ds["fused_blocks"] < min_vec or ds["seq_blocks"] <= 0:
        raise AssertionError(f"the striped cluster does not take both "
                             f"branches: {ds}")
    blocks = ds["scan_steps"]
    per_solve = {k: v for k, v in ds["launches"].items() if v}
    want = dict(unpack_bits=1, ffd_fused_headroom=blocks,
                ffd_fused_commit=blocks, pack_outputs=1)
    if on_card and (per_solve != want or launches != dict(
            dict.fromkeys(launches, 0),
            **{k: v * (rounds + 1) for k, v in want.items()})):
        raise AssertionError(f"fused solve launches {per_solve} (run: "
                             f"{launches}) are not 1 + 2*{blocks} + 1")
    enc = encode_snapshot(snap)
    buf, st = solver.pack(enc, *full_existing_encode(enc, []))
    st = dict(st, n_max=ds["slot_bucket"])
    log(f"[striped] {n_pods} pods, {len(enc.groups)} signatures, built in "
        f"{build_s:.2f} s; statics {st}; {ds['fused_blocks']} vectorized "
        f"and {ds['seq_blocks']} sequential blocks; launches per solve "
        f"{per_solve}")
    unfused = CUDASolver(device=device, incremental=False)
    unfused.dev_fuse = 1
    states, cluster = None, None
    if on_card:
        d_buf = torch.from_numpy(buf).to(solver.device)
        inp = ft._packed_inputs_ref(d_buf, *(st[k] for k in
                                             "T D Z C G E P K M Q F".split()))
        ind = ft.block_indep(inp.fuse, st["F"]).tolist()
        keep = [b for b, v in enumerate(ind) if v][:4] + \
            [b for b, v in enumerate(ind) if not v][:4]
        _, kept, cluster = check_fused_blocks("striped", inp, st, cmp,
                                              keep=keep)
        out = ft.solve_scan_packed1(d_buf, **examples.solve_statics(st))
        plain = ft._pack_outputs_ref(*ft._solve_fused_ref(
            inp, st["n_max"], st["E"], st["P"], st["F"]))
        cmp("pack_outputs", out, plain, "striped packed solve")
        buf1, st1 = unfused.pack(enc, *full_existing_encode(enc, []))
        states = (inp, st, kept, d_buf,
                  torch.from_numpy(buf1).to(solver.device),
                  dict(st1, n_max=st["n_max"]))
        torch.cuda.synchronize()
        log(f"[striped] K5 kernels == plain parts block by block on the "
            f"solver's arena ({blocks} blocks, the commit on a cluster of "
            f"{cluster} CTAs); the packed solve == the plain packed solve "
            f"on the card")
    if unfused.solve(snap).decision_fingerprint() != \
            res.decision_fingerprint():
        raise AssertionError("fused decisions differ from the unfused "
                             "solve's")
    if unfused.last_dispatch_stats["fuse"] != 1:
        raise AssertionError("dev_fuse = 1 still fused")
    t0 = time.perf_counter()
    plain_res = CUDASolver(device="cpu", incremental=False).solve(snap)
    plain_s = time.perf_counter() - t0
    if plain_res.decision_fingerprint() != res.decision_fingerprint():
        raise AssertionError("fused decisions differ from the plain "
                             "versions' on the CPU")
    placed = sum(len(n.pod_names) for n in res.new_nodes)
    if placed + len(res.existing_assignments) + len(res.unschedulable) \
            != len(snap.pods):
        raise AssertionError("striped pods not all placed or reported")

    # the variant with 100 existing nodes
    launches_ex, walls_ex, ds_ex, res_ex = measured(
        CUDASolver(device=device, incremental=False), snap_ex, rounds)
    if unfused.solve(snap_ex).decision_fingerprint() != \
            res_ex.decision_fingerprint():
        raise AssertionError("fused decisions with existing nodes differ "
                             "from the unfused solve's")
    if not res_ex.existing_assignments:
        raise AssertionError("no pod landed on an existing node")

    # incremental rows-tier ticks: one pod fewer in a signature each tick
    inc = CUDASolver(device=device)
    inc.solve(snap)
    fc.reset_launches()
    gone, tick_walls, tick_kinds, done = set(), [], set(), []
    per_sig = n_pods // n_sigs
    for t in range(ticks):
        gone.add(id(snap.pods[((t * 37) % n_sigs) * per_sig]))
        x = dataclasses.replace(snap, pods=[p for p in snap.pods
                                            if id(p) not in gone])
        t0 = time.perf_counter()
        got = inc.solve(x)
        tick_walls.append((time.perf_counter() - t0) * 1e3)
        tick_kinds.add((inc.last_dispatch_stats["kernel"],
                        inc.last_phase_stats["cache"]))
        done.append((x, got.decision_fingerprint()))
    launches_t = dict(fc.LAUNCHES)
    if tick_kinds != {("fused", "rows")}:
        raise AssertionError(f"incremental ticks not rows-tier fused "
                             f"solves: {tick_kinds}")
    # the solves from scratch run after the counters are read
    for t, (x, fp) in enumerate(done):
        if unfused.solve(x).decision_fingerprint() != fp:
            raise AssertionError(f"incremental tick {t}: decisions differ "
                                 "from a solve from scratch")
    summary = dict(
        p50_ms=statistics.median(walls), p99_ms=pct(walls, 0.99),
        rounds=rounds, split_ms={k: splits[k] for k in (
            "group_ms", "encode_ms", "kernel_ms", "decode_ms")},
        groups=st["G"], slot_bucket=st["n_max"], fuse=ds["fuse"],
        cluster=cluster, scan_steps=blocks, fused_blocks=ds["fused_blocks"],
        seq_blocks=ds["seq_blocks"], launches_per_solve=per_solve,
        plain_cpu_s=plain_s,
        existing=dict(p50_ms=statistics.median(walls_ex),
                      fused_blocks=ds_ex["fused_blocks"],
                      on_existing=len(res_ex.existing_assignments)),
        ticks=dict(p50_ms=statistics.median(tick_walls),
                   p99_ms=pct(tick_walls, 0.99), count=ticks))
    log(f"[striped] solve p50 {summary['p50_ms']:.3f} ms p99 "
        f"{summary['p99_ms']:.3f} ms over {rounds} (commit cluster "
        f"{cluster}); split "
        f"{json.dumps(summary['split_ms'])}; fingerprint == dev_fuse=1 on "
        f"{solver.device} and == plain versions on the CPU "
        f"({plain_s:.1f} s)")
    log(f"[striped] 100 existing nodes: p50 "
        f"{summary['existing']['p50_ms']:.3f} ms, "
        f"{ds_ex['fused_blocks']} vectorized blocks, "
        f"{len(res_ex.existing_assignments)} pods on existing nodes; "
        f"{ticks} rows-tier ticks p50 {summary['ticks']['p50_ms']:.3f} ms, "
        f"each fused and == a solve from scratch")
    all_launches = {k: launches[k] + launches_ex[k] + launches_t[k]
                    for k in launches}
    return all_launches, summary, states


# ---------------------------------------------------------------------------
# phase 14: the mesh path (K10)
# ---------------------------------------------------------------------------

def take_checks(cmp, records, label, also=None):
    """Fold a ``mesh_kernel_check`` record list into ``cmp`` (and into
    the record ``also``); raise on a kernel launch whose buffers differ
    from its plain part's."""
    for name, args, diffs, err in records:
        for k in (name, also) if also else (name,):
            cmp.err[k] = max(cmp.err[k], err)
            cmp.checks[k] += 1
        if diffs:
            raise AssertionError(f"{label}: {name}{args} kernel != plain in "
                                 f"{diffs} (max abs diff {err})")


def timed_solves(solver, snap, rounds, dev):
    """One warm-up, then ``rounds`` timed solves (ms, ending in a
    synchronise); returns (times, the last result)."""
    import torch
    solver.solve(snap)
    times, res = [], None
    for _ in range(rounds):
        t0 = time.perf_counter()
        res = solver.solve(snap)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, res


def p50_p99(times):
    xs = sorted(times)
    return (statistics.median(xs),
            xs[min(len(xs) - 1, int(round(0.99 * (len(xs) - 1))))])


def mesh_phase(cmp, device=None, cells=None, rounds=M14_ROUNDS,
               ranks=M14_RANKS):
    """Phase 14 (module docstring). Returns (the K10 launches of (a)'s
    main-path runs, a summary, the states kept for the timing phase)."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.models.delta import \
        full_existing_encode
    from karpenter_provider_aws_tpu_torch.models.encoding import \
        encode_snapshot
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    from karpenter_provider_aws_tpu_torch.parallel import (
        MeshComm, pick_backend, run_ranks, solve_scan_sharded)
    cells = examples.MESH_CELLS if cells is None else cells
    on_card = device is None
    dev = torch.device("cuda" if on_card else device)
    backend = pick_backend(1, dev)
    summary, kept, want = {}, {}, {}
    launches = {k: 0 for k in fc.LAUNCHES}
    # ---- (a) world size 1 ----
    tmp = tempfile.mkdtemp(prefix="karp_mesh1_")
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'rdzv')}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        if on_card:
            probe = torch.ones(1, device=dev)
            dist.all_reduce(probe)
            torch.cuda.synchronize()
        comm = MeshComm()
        env = fenv.Environment()
        for name, n_pods, dp2_min in cells:
            fenv.reset_pod_counter()
            t0 = time.perf_counter()
            snap = examples.config2(env, n_pods)
            t_build = time.perf_counter() - t0
            single = examples.mesh_cell_solver(None, device=device)
            s_times, s_res = timed_solves(single, snap, rounds, dev)
            want[name] = examples._fp_digest(s_res)
            solver = examples.mesh_cell_solver(comm, dp2_min, device)
            solver.solve(snap)              # warm-up: the bucket settles
            enc = encode_snapshot(snap)
            arrays, stt = solver._prep_device_inputs(
                enc, *full_existing_encode(enc, []), mesh=True)
            n_max = solver._bucket
            for split in (False, True):
                records = []
                solve_scan_sharded(
                    arrays, comm, n_max, stt["E"], stt["P"], stt["V"],
                    device=dev, split_fill=split,
                    check=examples.mesh_kernel_check(0, records))
                if {r[0] for r in records} != set(mc.KERNELS):
                    raise AssertionError(f"{name}: kernels checked "
                                         f"{sorted({r[0] for r in records})}")
                take_checks(cmp, records, f"mesh {name} split={split}")
            fc.reset_launches()
            m_times = []
            res = None
            for _ in range(rounds):
                t0 = time.perf_counter()
                res = solver.solve(snap)
                if on_card:
                    torch.cuda.synchronize()
                m_times.append((time.perf_counter() - t0) * 1e3)
            got = dict(fc.LAUNCHES)
            for k in launches:
                launches[k] += got[k]
            # the plain parts (a CPU rehearsal) count no launches
            missing = [k for k in mc.KERNELS if got[k] <= 0 and on_card]
            if missing:
                raise AssertionError(f"K10 kernels never launched on the "
                                     f"{name} cell: {missing}")
            if examples._fp_digest(res) != want[name]:
                raise AssertionError(f"mesh {name}: decisions differ from "
                                     f"the single-device solve")
            placed = sum(len(n.pod_names) for n in res.new_nodes)
            if placed + len(res.existing_assignments) + \
                    len(res.unschedulable) != n_pods:
                raise AssertionError(f"mesh {name}: pods unaccounted")
            ds = dict(solver.last_dispatch_stats)
            sp50, sp99 = p50_p99(s_times)
            mp50, mp99 = p50_p99(m_times)
            summary[name] = dict(
                pods=n_pods, build_s=t_build, nodes=len(res.new_nodes),
                slot_bucket=ds["slot_bucket"], groups=ds["groups"],
                mesh_kernel=ds["mesh_kernel"], placement=ds["placement"],
                backend=backend, collectives_per_solve=ds["collectives"],
                collective_ms_per_step=ds["collective_ms"] / ds["groups"],
                single_p50_ms=sp50, single_p99_ms=sp99, mesh_p50_ms=mp50,
                mesh_p99_ms=mp99, split=dict(solver.last_phase_stats),
                launches_per_solve={k: ds["launches"][k]
                                    for k in mc.KERNELS})
            kept[name] = (arrays, stt, n_max)
            log(f"[mesh] (a) {name}: {n_pods} pods, {len(res.new_nodes)} "
                f"nodes, world 1 on {backend}; {json.dumps(summary[name])}")
        # later slot shards: slot0 > 0 and earlier-shard prefixes, small
        # and wrapping (the code only a slot split runs)
        for case, ndp, dp_idx in examples.MESH_LATER_SHARDS:
            for before in examples.MESH_BEFORES:
                records, st = examples.mesh_shard_check(case, ndp, dp_idx,
                                                        before, device=dev)
                if st.slot0 <= 0 or {r[0] for r in records} != \
                        set(mc.KERNELS):
                    raise AssertionError(f"later shard {case} {ndp}/{dp_idx}")
                take_checks(cmp, records,
                            f"later shard {case} {ndp}/{dp_idx} {before}")
        log(f"[mesh] (a) later slot shards {examples.MESH_LATER_SHARDS} x "
            f"prefixes {sorted(examples.MESH_BEFORES)}: every kernel == "
            f"its plain part")
        # the minValues snapshots: the type mesh with its h1 maxima
        api = examples.pipeline_api()
        for seed in examples.MESH_MV_SEEDS:
            fenv.reset_pod_counter()
            snap = examples.min_values_scenario(api, env, seed)
            key = ("min_values", seed)
            want[key] = examples._fp_digest(
                examples.mesh_cell_solver(None, device=device).solve(snap))
            solver = examples.mesh_cell_solver(comm, device=device)
            enc = encode_snapshot(snap)
            arrays, stt = solver._prep_device_inputs(
                enc, *full_existing_encode(enc, []), mesh=True)
            if not stt["K"]:
                raise AssertionError(f"min_values {seed}: no floors")
            records = []
            solve_scan_sharded(arrays, comm, solver._bucket, stt["E"],
                               stt["P"], stt["V"], device=dev,
                               check=examples.mesh_kernel_check(0, records))
            take_checks(cmp, records, f"mesh min_values {seed}")
            if examples._fp_digest(solver.solve(snap)) != want[key]:
                raise AssertionError(f"mesh min_values {seed}: decisions "
                                     f"differ from the single-device solve")
            log(f"[mesh] (a) min_values {seed}: {len(snap.pods)} pods, "
                f"K = {stt['K']}, V = {stt['V']}, {len(records)} launches "
                f"checked, decisions == the single-device solve")
    finally:
        dist.destroy_process_group()
    # ---- (b) ranks sharing the card over gloo ----
    t0 = time.perf_counter()
    outs = run_ranks(examples.mesh_cell_rank, ranks,
                     pick_backend(ranks, dev), M14_TIMEOUT_S,
                     args=(cells, rounds, device), deadline_s=900,
                     threads=2, build=on_card, device=dev)
    t_ranks = time.perf_counter() - t0
    shapes = {"tp": ("tp", 1, ranks), "dp2": ("dp2", 2, ranks // 2)}
    for name, _n, _s in cells:
        for rank, out in enumerate(outs):
            r = out[name]
            st = r["stats"]
            if r["fp"] != want[name]:
                raise AssertionError(f"rank {rank} {name}: decisions differ "
                                     f"from the single-device solve")
            if (st["mesh_kernel"], st["ndp"], st["ntp"]) != shapes[name]:
                raise AssertionError(f"rank {rank} {name}: shape {st}")
            if st["backend"] != "gloo":
                raise AssertionError(f"rank {rank} {name}: {st}")
            missing = [k for k in mc.KERNELS
                       if r["launches"][k] <= 0 and on_card]
            if missing:
                raise AssertionError(f"rank {rank} {name}: K10 kernels never "
                                     f"launched: {missing}")
            if r["accounted"] != r["pods"]:
                raise AssertionError(f"rank {rank} {name}: pods unaccounted")
        for rank in (0, ranks - 1):
            recs = outs[rank][name]["checks"]
            if {x[0] for x in recs} != set(mc.KERNELS):
                raise AssertionError(f"rank {rank} {name}: kernels checked "
                                     f"{sorted({x[0] for x in recs})}")
            take_checks(cmp, recs, f"rank {rank} {name}")
        p50, p99 = p50_p99([t for o in outs for t in o[name]["times_ms"]])
        summary[name].update(
            ranks_p50_ms=p50, ranks_p99_ms=p99,
            ranks_collective_ms_per_step=statistics.median(
                o[name]["collective_ms_per_step"] for o in outs),
            ranks_collectives_per_solve=outs[0][name]["collectives"],
            ranks_launches=outs[0][name]["launches"],
            ranks_checks=len(recs),
            ranks_fill_phases=sorted({x[1][1] for x in recs
                                      if x[0] == "mesh_fill"}))
        log(f"[mesh] (b) {name}: {ranks} ranks over gloo on one card "
            f"({json.dumps(outs[0][name]['stats'])}); solve p50 {p50:.3f} "
            f"ms p99 {p99:.3f} ms (single-device p50 "
            f"{summary[name]['single_p50_ms']:.3f}); collectives "
            f"{summary[name]['ranks_collective_ms_per_step']:.3f} ms/step; "
            f"ranks 0 and {ranks - 1} checked {len(recs)} launches each; "
            f"every rank's decisions == the single-device solve")
    for seed in examples.MESH_MV_SEEDS:
        key = ("min_values", seed)
        for rank, out in enumerate(outs):
            st = out[key]["stats"]
            if out[key]["fp"] != want[key] or (
                    st["mesh_kernel"], st["ndp"], st["ntp"]) != shapes["tp"]:
                raise AssertionError(f"rank {rank} min_values {seed}: {st}")
        log(f"[mesh] (b) min_values {seed}: every rank on 1 x {ranks} == "
            f"the single-device solve")
    summary["ranks_wall_s"] = t_ranks
    return launches, summary, kept


# ---------------------------------------------------------------------------
# phase 15: the distributed path (K11)
# ---------------------------------------------------------------------------

def plain_fingerprint(shape, seed, tick):
    """The fingerprint of the plain single-device scan (``_solve_scan_ref``)
    of a seeded tick, on the CPU."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.parallel import distmesh as dm
    from karpenter_provider_aws_tpu_torch.parallel.mesh import _out_dict
    arrays, st = dm.tick_arrays(shape, seed, tick)
    out = _out_dict(*ft._solve_scan_ref(
        ft.kernel_inputs_from_numpy(arrays, "cpu"), st["n_max"], st["E"],
        st["P"]), arrays["A"].shape[0])
    return dm.result_fingerprint(out)


def plain_fingerprints(shapes, seed, threads=0):
    """``plain_fingerprint`` of ticks 0 and 1 of each (name, shape) of
    ``shapes`` with ``threads`` intra-op threads (0: torch's default);
    returns ({(name, tick): fingerprint}, seconds). ``main`` runs it in a
    process of its own from the start, beside the earlier phases."""
    import torch
    if threads:
        torch.set_num_threads(threads)
    t0 = time.perf_counter()
    out = {(name, t): plain_fingerprint(shape, seed, t)
           for name, shape in shapes for t in (0, 1)}
    return out, time.perf_counter() - t0


def check_launches(launches, G, label, per=1):
    """A distributed solve's K10 launches: 1 + 5*G per rank and solve
    (the caps, then per group step the headroom, the fill's three phases
    and the commit), ``per`` solves; raise otherwise."""
    want = dict(mesh_new_caps=per, mesh_slot_headroom=per * G,
                mesh_fill=3 * per * G, mesh_commit=per * G)
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{label}: K10 launches {got}, want {want}")


def group_logs(log_dir):
    """The tails of a mesh group's rank logs (for a failure's message)."""
    out = []
    for name in sorted(os.listdir(log_dir)) if os.path.isdir(log_dir) \
            else ():
        with open(os.path.join(log_dir, name), errors="replace") as f:
            out.append(f"--- {name}\n" + "".join(f.readlines()[-30:]))
    return "\n".join(out)


def dist_phase(cmp, device=None, ceiling=None, smoke=None,
               rounds=D15_ROUNDS, batches=D15_BATCHES, plain=None):
    """Phase 15 (module docstring). ``plain``: ``plain_fingerprints`` of
    (``smoke``, ``ceiling``), computed here when not given. Returns (the
    K10 launches of its main-path runs by kernel, in this process and
    reported by the rank processes, the K4 lane launches of the routed
    batches, a summary, the state kept for the timing phase)."""
    import datetime
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fleet import MeshGroup
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    from karpenter_provider_aws_tpu_torch.ops.hostpack import pack_inputs1
    from karpenter_provider_aws_tpu_torch.parallel import distmesh as dm
    from karpenter_provider_aws_tpu_torch.parallel import pick_backend
    from karpenter_provider_aws_tpu_torch.utils.metrics import Metrics
    ceiling = examples.DIST_CEILING_SHAPE if ceiling is None else ceiling
    smoke = examples.DIST_SMOKE_SHAPE if smoke is None else smoke
    on_card = device is None
    dev = torch.device("cuda" if on_card else device)
    seed = examples.DIST_SEED
    dirty = list(dm.DIRTY_FIELDS)
    launches = {k: 0 for k in fc.LAUNCHES}
    batch_launches = {k: 0 for k in fc.LAUNCHES}
    summary, oracle = {}, {}

    def add(into, got):
        for k, v in got.items():
            into[k] = into.get(k, 0) + v

    def want_fp(shape, tick):
        key = (shape["G"], shape["T"], shape["n_max"], tick)
        if key not in oracle:
            arrays, st = dm.tick_arrays(shape, seed, tick)
            oracle[key] = dm.result_fingerprint(
                dm.oracle_out(arrays, device=dev, **st))
        return oracle[key]

    # the plain single-device scan on the CPU, of the ticks held to it
    if plain is None:
        plain = plain_fingerprints((("smoke", smoke), ("ceiling", ceiling)),
                                   seed)
    plain, t_plain = plain
    arrays0, _ = dm.tick_arrays(ceiling, seed, 0)
    pods = int(np.asarray(arrays0["n"]).sum())
    log(f"[dist] ceiling {ceiling}: {pods} pods; plain scans of ticks 0 "
        f"and 1 on the CPU in {t_plain:.1f} s")

    # ---- (a) world size 1 (NCCL on the card) ----
    tmp = tempfile.mkdtemp(prefix="karp_dist1_")
    dist.init_process_group(
        pick_backend(1, dev), init_method=f"file://{os.path.join(tmp, 'r')}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        comm = dm.dist_mesh2(nproc=1)
        backend = comm.backend
        for name, shape in (("smoke", smoke), ("ceiling", ceiling)):
            Np, lo, hi = dm.slab_rows(shape["n_max"], shape["E"], comm.ndp)
            records = []
            arrays, st = dm.tick_arrays(shape, seed, 0, slab=(lo, hi, Np))
            dm.dispatch_dist(arrays, comm=comm, cache={}, device=dev,
                             check=examples.mesh_kernel_check(0, records),
                             **st)
            if {r[0] for r in records} != set(mc.KERNELS) or \
                    {r[1][1] for r in records if r[0] == "mesh_fill"} != \
                    {mc.PHASE_A, mc.PHASE_B, mc.PHASE_C}:
                raise AssertionError(f"dist (a) {name}: checked "
                                     f"{sorted({r[0] for r in records})}")
            take_checks(cmp, records, f"dist (a) {name}", also="dist2_step")
            cache, times, splits = {}, [], []
            for i in range(2 + rounds):   # the oracles, off the main path
                want_fp(shape, i)
            fc.reset_launches()
            for i in range(2 + rounds):
                arrays, st = dm.tick_arrays(shape, seed, i,
                                            slab=(lo, hi, Np))
                t0 = time.perf_counter()
                out = dm.dispatch_dist(arrays, comm=comm, cache=cache,
                                       device=dev, dirty=dirty if i else None,
                                       **st)
                times.append((time.perf_counter() - t0) * 1e3)
                splits.append(dict(cache["last_timing"]))
                mode = cache["last_placement"]["mode"]
                if mode != ("patch" if i else "full"):
                    raise AssertionError(f"dist (a) {name} tick {i}: {mode}")
                fp = dm.result_fingerprint(out)
                if fp != want_fp(shape, i) or (i < 2 and fp != plain[
                        (name, i)]):
                    raise AssertionError(f"dist (a) {name} tick {i}: "
                                         f"fingerprint differs")
            got = dict(fc.LAUNCHES)
            if on_card:
                check_launches(got, shape["G"], f"dist (a) {name}",
                               per=2 + rounds)
            add(launches, got)
            p50, p99 = p50_p99(times[2:])
            summary[f"a_{name}"] = dict(
                backend=backend, world=1, full_ms=times[0],
                patch_ms=times[1], patch_p50_ms=p50, patch_p99_ms=p99,
                split_p50_ms={k: 1e3 * statistics.median(
                    s[k] for s in splits[2:]) for k in splits[0]},
                collectives=cache["last_mesh"]["collectives"],
                launches={k: got[k] for k in mc.KERNELS})
            log(f"[dist] (a) {name} at world 1 on {backend}: every K10 "
                f"launch of the first 4 steps == its plain part; "
                f"{json.dumps(summary[f'a_{name}'])}; fingerprints == the "
                f"card's oracle and (ticks 0, 1) the plain scan on the CPU")
    finally:
        dist.destroy_process_group()

    # ---- (b) 2 hosts x 2 ranks sharing the card over gloo ----
    log_dir = tempfile.mkdtemp(prefix="karp_dist_logs_")
    m = Metrics()
    mg = MeshGroup(workers=1, local_devices=2, device=device, metrics=m,
                   reply_timeout_s=D15_TIMEOUT_S,
                   regroup_backoff_s=D15_BACKOFF_S, log_dir=log_dir)
    try:
        t0 = time.perf_counter()
        mg.start()
        t_form = time.perf_counter() - t0
        if not mg.alive():
            raise AssertionError("the 2 x 2 mesh group did not form")
        info = dict(mg.mesh_info)
        if (info["dp"], info["tp"], info["world"]) != (2, 2, 4):
            raise AssertionError(f"2 x 2 layout: {info}")
        G = ceiling["G"]
        Nl = (ceiling["E"] + ceiling["n_max"]) // 2
        times, walls, splits, colls = [], [], [], []
        rank_launches = [dict() for _ in range(4)]
        for i in range(2 + rounds):
            t0 = time.perf_counter()
            r = mg.solve_seeded(ceiling, seed, i, dirty=dirty if i else None,
                                check_ranks=(0, 3) if i == 0 else ())
            times.append((time.perf_counter() - t0) * 1e3)
            if not r["distributed"] or r["mode"] != ("patch" if i else
                                                     "full"):
                raise AssertionError(f"dist (b) tick {i}: {r['mode']} "
                                     f"distributed={r['distributed']}")
            if r["fingerprint"] != want_fp(ceiling, i) or (
                    i < 2 and r["fingerprint"] != plain[("ceiling", i)]):
                raise AssertionError(f"dist (b) tick {i}: fingerprint "
                                     f"differs")
            for rk in r["ranks"]:
                add(rank_launches[rk["rank"]], rk["launches"])
                if set(rk["slot_rows"].values()) != {Nl}:
                    raise AssertionError(f"dist (b) rank {rk['rank']}: slot "
                                         f"rows {rk['slot_rows']} != {Nl}")
                if "checks" in rk:
                    take_checks(cmp, [tuple(x) for x in rk["checks"]],
                                f"dist (b) rank {rk['rank']}",
                                also="dist2_step")
            if i == 0:
                checked = {rk["rank"]: {x[0] for x in rk["checks"]}
                           for rk in r["ranks"] if "checks" in rk}
                if checked != {0: set(mc.KERNELS), 3: set(mc.KERNELS)}:
                    raise AssertionError(f"dist (b) checks {checked}")
            walls.append(statistics.median(rk["wall_s"] * 1e3
                                           for rk in r["ranks"]))
            splits.append(r["timing"])
            colls.append(r["ranks"][0]["mesh"])
        for rk, got in enumerate(rank_launches):
            if on_card:
                check_launches(got, G, f"dist (b) rank {rk}", per=2 + rounds)
            add(launches, got)
        p50, p99 = p50_p99(times[2:])
        summary["b_ceiling"] = dict(
            layout=info, form_s=t_form, pods=pods, full_ms=times[0],
            patch_ms=times[1], patch_p50_ms=p50, patch_p99_ms=p99,
            rank_dispatch_p50_ms=statistics.median(walls[2:]),
            split_p50_ms={k: 1e3 * statistics.median(s[k]
                                                     for s in splits[2:])
                          for k in splits[0]},
            collectives=colls[-1]["collectives"],
            collective_ms_per_step=1e3 * statistics.median(
                c["collective_s"] for c in colls[2:]) / G,
            slot_rows_per_rank=Nl,
            launches_per_rank={k: rank_launches[0].get(k, 0)
                               for k in mc.KERNELS})
        log(f"[dist] (b) ceiling on 2 x 2 gloo ranks sharing the card: "
            f"{json.dumps(summary['b_ceiling'])}; ranks 0 and 3 held their "
            f"first 4 steps against the plain parts; every tick == the "
            f"card's oracle, ticks 0 and 1 == the plain scan on the CPU")

        # ---- (d) SolveBatch lanes routed over the ranks ----
        dims = {k: smoke[k] for k in ("T", "D", "Z", "C", "G", "E", "P")}
        kv = dict(dims, n_max=smoke["n_max"])
        for B in batches:
            lanes = [pack_inputs1(dm.tick_arrays(smoke, 100 + i, 0)[0],
                                  **dims) for i in range(B)]
            stack = np.stack(lanes)
            t0 = time.perf_counter()
            got = mg.solve_batch(stack, kv)
            t_b = (time.perf_counter() - t0) * 1e3
            if got is None:
                raise AssertionError(f"dist (d) B={B}: routing refused")
            for i in range(B):
                one = ft.solve_scan_packed1(stack[i], device=dev, **kv)
                cpu = ft.solve_scan_packed1(stack[i], device="cpu", **kv)
                if not (np.array_equal(got[i], one.cpu().numpy())
                        and np.array_equal(got[i], cpu.numpy())):
                    raise AssertionError(f"dist (d) B={B} lane {i} differs")
            for rb in mg.last_batch:
                add(batch_launches, rb["launches"])
            summary[f"d_batch_{B}"] = dict(
                wall_ms=t_b, spans=[rb["span"] for rb in mg.last_batch],
                launches=[rb["launches"] for rb in mg.last_batch])
            log(f"[dist] (d) solve_batch B={B} over 4 ranks: "
                f"{json.dumps(summary[f'd_batch_{B}'])}; every lane == its "
                f"single solve on the card and the plain versions")

        # ---- (e) a rank killed between ticks, then the regroup ----
        t = 2 + rounds
        mg._procs[-1].kill()
        mg._procs[-1].wait(timeout=10)
        fc.reset_launches()
        seen = []   # (tick, result): held to the oracles after the loop
        for _ in range(2):
            seen.append((t, mg.solve_seeded(ceiling, seed, t, dirty=dirty)))
            t += 1
        modes = [r["mode"] for _, r in seen]
        if modes != ["full", "patch"] or any(r["distributed"]
                                             for _, r in seen) or \
                mg.solve_batch(np.zeros((1, 4), np.int64), kv) is not None:
            raise AssertionError(f"dist (e) degraded ticks {modes}")
        t0 = time.perf_counter()
        while True:
            seen.append((t, mg.solve_seeded(ceiling, seed, t, dirty=dirty)))
            t += 1
            if seen[-1][1]["distributed"]:
                break
            if time.perf_counter() - t0 > D15_REGROUP_BUDGET_S:
                raise AssertionError("dist (e) regroup over budget")
        t_regroup = time.perf_counter() - t0
        seen.append((t, mg.solve_seeded(ceiling, seed, t, dirty=dirty)))
        add(launches, dict(fc.LAUNCHES))   # the degraded local solves
        r, r2 = seen[-2][1], seen[-1][1]
        if (r["mode"], r2["mode"], r2["distributed"]) != \
                ("full", "patch", True):
            raise AssertionError(f"dist (e) after the regroup: {r['mode']} "
                                 f"{r2['mode']}")
        for tick, rr in seen:
            if rr["fingerprint"] != want_fp(ceiling, tick):
                raise AssertionError(f"dist (e) tick {tick}: fingerprint")
            for rk in rr.get("ranks", ()):
                add(launches, rk["launches"])
        counts = {k: m.counter(f"karpenter_solver_distmesh_{k}_total",
                               labels={"reason": "worker_lost"})
                  for k in ("degraded", "recovered")}
        if counts != {"degraded": 1, "recovered": 1}:
            raise AssertionError(f"dist (e) counters {counts}")
        summary["e_chaos"] = dict(degraded_modes=modes, ticks=len(seen),
                                  regroup_s=t_regroup,
                                  regroup_ms=m.histograms.get(
                                      ("karpenter_solver_distmesh_regroup_ms",
                                       ())), epoch=mg.epoch)
        log(f"[dist] (e) rank killed: one full degraded solve on "
            f"{mg.device}, then patch, batch routing refused; regrouped in "
            f"{t_regroup:.1f} s (canary passed), then distributed full and "
            f"patch; {json.dumps(summary['e_chaos'])}")
    except Exception:
        log(group_logs(log_dir))
        raise
    finally:
        mg.stop()

    # ---- (c) 4 hosts x 1 rank: four slabs ----
    mg = MeshGroup(workers=3, local_devices=1, device=device,
                   reply_timeout_s=D15_TIMEOUT_S, log_dir=log_dir)
    try:
        mg.start()
        if not mg.alive() or (mg.mesh_info["dp"], mg.mesh_info["tp"]) != \
                (4, 1):
            raise AssertionError(f"4 x 1 group: {mg.mesh_info}")
        Nl = -(-(smoke["E"] + smoke["n_max"]) // 4)
        for i in range(3):
            r = mg.solve_seeded(smoke, seed, i, dirty=dirty if i else None,
                                check_ranks=(0, 3) if i == 0 else ())
            if not r["distributed"] or r["fingerprint"] != \
                    want_fp(smoke, i) or (i < 2 and r["fingerprint"] !=
                                          plain[("smoke", i)]):
                raise AssertionError(f"dist (c) tick {i}: {r['mode']}")
            for rk in r["ranks"]:
                add(launches, rk["launches"])
                if set(rk["slot_rows"].values()) != {Nl}:
                    raise AssertionError(f"dist (c) slot rows {rk}")
                if "checks" in rk:
                    take_checks(cmp, [tuple(x) for x in rk["checks"]],
                                f"dist (c) rank {rk['rank']}",
                                also="dist2_step")
        summary["c_smoke_4x1"] = dict(layout=dict(mg.mesh_info),
                                      collectives=r["ranks"][0]["mesh"][
                                          "collectives"])
        log(f"[dist] (c) smoke on 4 x 1 gloo ranks (four slabs of {Nl} "
            f"rows): ticks 0-2 == the card's oracle; "
            f"{json.dumps(summary['c_smoke_4x1'])}")
    except Exception:
        log(group_logs(log_dir))
        raise
    finally:
        mg.stop()
    # the timing phase's state: host 0's slab of the ceiling's tick 0
    Np, lo, hi = dm.slab_rows(ceiling["n_max"], ceiling["E"], 2, 2, 0)
    kept = dm.tick_arrays(ceiling, seed, 0, slab=(lo, hi, Np))
    return launches, batch_launches, summary, kept


# ---------------------------------------------------------------------------
# phase 10: timing and bounds
# ---------------------------------------------------------------------------

def time_launches(fn, reps=50, setup=None):
    """Mean ms per call of ``fn`` on the current stream, from CUDA event
    pairs around each call. A sleep kernel first lets the host enqueue
    ahead, so the events time the device work, not the launch gaps."""
    import torch
    for _ in range(3):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(20_000_000)
    for i in range(reps):
        if setup:
            setup()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return statistics.fmean(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound_ms(nbytes: float, ops: float):
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def capture_pack(fn):
    """``fn()`` with ``ffd_cuda.pack_outputs_lanes`` watched: (its result,
    [(args, kwargs)] of each pack call, the tensors cloned), so that a
    main path's pack can be replayed on its own inputs."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc

    def clone(x):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*[clone(f) for f in x])
        return x.clone() if hasattr(x, "clone") else x
    calls, orig = [], fc.pack_outputs_lanes

    def spy(*a, **kw):
        calls.append((tuple(clone(x) for x in a),
                      {k: clone(v) for k, v in kw.items()}))
        return orig(*a, **kw)
    fc.pack_outputs_lanes = spy
    try:
        out = fn()
    finally:
        fc.pack_outputs_lanes = orig
    return out, calls


def pack_plain(a, kw):
    """The plain version's rows of a captured pack call, lane by lane,
    each with its bail word where the call writes one."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    takes, left, carry = a[:3]
    bail = kw.get("bail")
    rows = []
    for b in range(takes.shape[0]):
        row = ft._pack_outputs_ref(takes[b], left[b],
                                   ft.Carry(*[f[b] for f in carry[:8]]))
        if bail is not None:
            row = torch.cat([row, bail[b].reshape(1).long()])
        rows.append(row)
    return torch.stack(rows)


def pack_cost(a, kw):
    """Bytes and operations of one pack call: every source read once
    (leftover; the carry's used, pool, num_nodes and pool_used at their
    own widths; the takes; the four bool segments; the bail bools) and
    the output rows written once, 8 bytes a word; an operation a bool
    and a takes lane."""
    takes, left, carry = a[:3]
    bail = kw.get("bail")
    L = takes.shape[0]
    i64 = [left, carry.used, carry.pool, carry.num_nodes, carry.pool_used]
    bools = [carry.types, carry.zones, carry.ct, carry.alive]
    srcs = i64 + [takes] + bools + ([bail] if bail is not None else [])
    nread = sum(t.numel() * t.element_size() for t in srcs)
    n32 = takes[0].numel()
    nb = sum(t[0].numel() for t in bools)
    W = (sum(t[0].numel() for t in i64) + (n32 + 1) // 2 + (nb + 63) // 64
         + (bail is not None))
    return nread + 8 * L * W, L * (nb + n32)


def kernels_per_call(fn, tries=5):
    """The CUDA kernels one call of ``fn`` issues, by the profiler's device
    events; a trace with no device event at all is taken again, and
    ``tries`` such traces raise."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            return names
    raise AssertionError(f"{tries} profiler traces showed no device event")


def pack_times(a, kw, reps=50, fn=None):
    """One captured pack call replayed (``fn``, by default
    ``pack_outputs_lanes(*a, **kw)``): its device µs (CUDA events), its
    bound and the kernels it issues; the output checked against the plain
    rows first."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    if fn is None:
        def fn():
            return fc.pack_outputs_lanes(*a, **kw)
    if not torch.equal(fn(), pack_plain(a, kw)):
        raise AssertionError("the pack != the plain rows")
    nbytes, ops = pack_cost(a, kw)
    b, by = bound_ms(nbytes, ops)
    kern = kernels_per_call(fn)
    return dict(us=time_launches(fn, reps=reps) * 1e3, bound_us=b * 1e3,
                bound_by=by, bytes=nbytes, lanes=int(a[0].shape[0]),
                kernels=len(kern), kernel_names=kern)


def kernel_times(c2, launches):
    """Time every kernel at the config-2 shapes; returns the records."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    inp, st, words, n_bits, carries, takes, lefts, final = c2
    T, D, Z, C, G, E, P = (st[k] for k in "T D Z C G E P".split())
    N = E + st["n_max"]
    recs = {}

    # K1 unpack_bits: reads the words, writes one byte per bool
    ms = time_launches(lambda: fc.unpack_bits(words, n_bits))
    pms = time_launches(lambda: ft._unpack_bits_ref(words, n_bits))
    recs["unpack_bits"] = (ms, pms, words.numel() * 8 + n_bits,
                           2 * n_bits)

    # K2 phase 1 at each group's entry carry (the scan's real states), and
    # at each chunk entry (g % CK == 0) with the carry's bank row stored by
    # the same launch (row 1 of two: the odd-width planes' rows are not
    # 16-byte aligned there), checked against the plain store
    state = fc.ScanState(inp, ft.Carry(*[t.clone() for t in carries[0]]),
                         E=E, P=P)
    bs = fc.BankState(state.carry, fc.empty_bank(state.carry, 2))
    want = fc.empty_bank(state.carry, 2)
    ms_l, pms_l, by_l, op_l, bank_l = [], [], [], [], []
    for g in range(G):
        cg = carries[g]
        for dst, src in zip(state.carry, cg):
            dst.copy_(src)
        if g % CK == 0:
            bank_l.append((
                time_launches(lambda: fc.ffd_slot_headroom(state, g)),
                time_launches(lambda: fc.ffd_slot_headroom(state, g, bank=bs,
                                                           j=1))))
            ft._bank_store_ref(want, cg, 1)
            for nm, got, w in zip(ft.Carry._fields, bs.bank, want):
                if not torch.equal(got[1], w[1]):
                    raise AssertionError(f"config 2 g={g}: the headroom's "
                                         f"bank row {nm} != the plain store")
        ms_l.append(time_launches(lambda: fc.ffd_slot_headroom(state, g)))
        pms_l.append(time_launches(
            lambda: ft._slot_headroom_ref(inp, cg, g, E=E, P=P, V=0),
            reps=10))
        cand, _ = ft._slot_headroom_ref(inp, cg, g, E=E, P=P, V=0)
        nbytes, ops = k2_cost(inp, cg, g, P, cand)[0]
        by_l.append(nbytes)
        op_l.append(ops)
    recs["ffd_slot_headroom"] = (statistics.fmean(ms_l),
                                 statistics.fmean(pms_l),
                                 statistics.fmean(by_l),
                                 statistics.fmean(op_l))
    row = sum(c.numel() * c.element_size() for c in state.carry)
    folded = dict(chunk_entries=len(bank_l), row_bytes=row,
                  headroom_us=statistics.fmean(b[0] for b in bank_l) * 1e3,
                  headroom_bank_row_us=statistics.fmean(
                      b[1] for b in bank_l) * 1e3)
    log(f"[time] ffd_slot_headroom at config 2's chunk entries without and "
        f"with the bank row: {json.dumps(folded)}")
    prologue = prologue_times(words, n_bits, bs, 1, want)
    log(f"[time] unpack_bits at config 2 alone and as the suffix's "
        f"prologue (with a bank row of config 2's carry): "
        f"{json.dumps(prologue)}")

    # K2 phase 2: restore the group's entry carry and its phase-1 result
    # (candidates, headroom, the new-node table) before each launch,
    # outside the timed events
    ms_l, pms_l, by_l, op_l = [], [], [], []
    for g in range(G):
        cg = carries[g]
        for dst, src in zip(state.carry, cg):
            dst.copy_(src)
        fc.ffd_slot_headroom(state, g)
        cand, k = state.cand.clone(), state.k.clone()

        def setup(cg=cg, cand=cand, k=k):
            for dst, src in zip(state.carry, cg):
                dst.copy_(src)
            state.cand.copy_(cand)
            state.k.copy_(k)
        ms_l.append(time_launches(lambda: fc.ffd_group_commit(state, g),
                                  setup=setup))
        pms_l.append(time_launches(
            lambda: ft._group_step_ref(inp, cg, g, E=E, P=P, V=0), reps=10))
        nxt = carries[g + 1] if g + 1 < G else final
        nbytes, ops = k2_cost(inp, cg, g, P, cand, nxt, takes[g])[1]
        by_l.append(nbytes)
        op_l.append(ops)
    recs["ffd_group_commit"] = (statistics.fmean(ms_l),
                                statistics.fmean(pms_l),
                                statistics.fmean(by_l),
                                statistics.fmean(op_l))

    # K1 pack_outputs on the final carry: one kernel a call
    ms = time_launches(lambda: fc.pack_outputs(takes, lefts, final))
    pms = time_launches(lambda: ft._pack_outputs_ref(takes, lefts, final))
    kern = kernels_per_call(lambda: fc.pack_outputs(takes, lefts, final))
    log(f"[time] pack_outputs at config 2: CUDA kernels a call {kern}")
    if len(kern) != 1:
        raise AssertionError(f"one pack_outputs call issued {kern}")
    recs["pack_outputs"] = (ms, pms, *pack_cost(
        (takes[None], lefts[None], ft.Carry(*[f[None] for f in final])),
        {}))

    out = []
    for name, (ms, pms, nbytes, ops) in recs.items():
        b, by = bound_ms(nbytes, ops)
        out.append(dict(name=name, route="cuda", **KERNELS[name],
                        launches=launches[name], ms=ms, plain_ms=pms,
                        bound_ms=b, bound_by=by, library_ms=None,
                        bytes=nbytes, ops=ops))
    out[0]["prologue_config2"] = prologue
    out[1]["folded_config2"] = folded
    return out


def prologue_times(words, n_bits, bs, j, bank):
    """``unpack_bits`` of ``words`` alone and as the suffix's prologue
    (``unpack_bits_load`` of row j of ``bs``, one launch), µs by CUDA
    events, the prologue's plane and carry checked against the plain
    unpack and ``bank_row(bank, j)`` first."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    bits = fc.unpack_bits_load(words, n_bits, bs, j)
    ok = torch.equal(bits, ft._unpack_bits_ref(words, n_bits)) and all(
        torch.equal(a, b) for a, b in zip(bs.carry, ft.bank_row(bank, j)))
    if not ok:
        raise AssertionError("the prologue's plane or carry != the plain "
                             "unpack and bank row")
    return dict(
        row_bytes=sum(c.numel() * c.element_size() for c in bs.carry),
        n_bits=n_bits,
        unpack_us=time_launches(lambda: fc.unpack_bits(words, n_bits)) * 1e3,
        prologue_us=time_launches(
            lambda: fc.unpack_bits_load(words, n_bits, bs, j)) * 1e3)


def bank_times(d_buf, st, gl):
    """The warm arena's folded bank copies, µs by CUDA events: its
    ``ffd_slot_headroom`` at a chunk entry without and with the bank row
    (``folded``), its ``unpack_bits`` alone and as the suffix's prologue
    loading a row (``prologue``), and the suffix's ``pack_outputs``
    without and with the re-stamp of its pad rows [GL/CK, G/CK)
    (``restamp``: the output and the rows checked against the plain pack
    and store first; beside the plain store and the eight
    ``Tensor.copy_`` calls that move the same bytes, the library
    yardstick, which the port never calls). Returns (folded, prologue,
    restamp)."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    ss = examples.solve_statics(st)
    _, bank = ft.solve_scan_packed1_ckpt(d_buf, CK=CK, **ss)
    j = bank.used.shape[0] // 2
    carry = ft.bank_row(bank, j)
    bs = fc.BankState(carry, bank)
    row = sum(c.numel() * c.element_size() for c in carry)
    g = j * CK
    inp = ft._packed_inputs_ref(d_buf, *(st[k] for k in
                                         "T D Z C G E P K M Q".split()))
    hs = fc.ScanState(inp, carry, E=st["E"], P=st["P"], V=st["V"])
    folded = dict(
        row_bytes=row,
        headroom_us=time_launches(lambda: fc.ffd_slot_headroom(hs, g)) * 1e3,
        headroom_bank_row_us=time_launches(
            lambda: fc.ffd_slot_headroom(hs, g, bank=bs, j=j)) * 1e3)
    log(f"[time] ffd_slot_headroom at the warm arena's chunk entry {g} "
        f"without and with its bank row: {json.dumps(folded)}")
    nbits = inp_bits(st)
    words = d_buf[d_buf.numel() - -(-nbits // 64):]
    prologue = prologue_times(words, nbits, bs, j - 1, bank)
    log(f"[time] unpack_bits at the warm arena alone and as the suffix's "
        f"prologue (loading bank row {j - 1}): {json.dumps(prologue)}")

    # the warm tick's suffix (SUF = 3 where the bound allows it): its
    # takes, leftover and final carry, and its pad rows
    NC, SUF = st["G"] // CK, min(3, gl // CK)
    tk, lf, cr, _ = ft._solve_suffix_ref(
        inp, ft.Carry(*[b.clone() for b in bank]), st["n_max"], st["E"],
        st["P"], st["V"], CK, SUF, gl)
    final = ft.Carry(*[c.contiguous().clone() for c in cr])
    count = max(NC - gl // CK, 1)
    j0 = NC - count
    rs = fc.BankState(final, ft.Carry(*[b.clone() for b in bank]))
    want = ft.Carry(*[b.clone() for b in bank])
    ft._bank_store_ref(want, final, j0, count)
    out = fc.pack_outputs(tk, lf, final, store=(rs, j0, count))
    if not torch.equal(out, ft._pack_outputs_ref(tk, lf, final)) or not all(
            torch.equal(a, b) for a, b in zip(rs.bank, want)):
        raise AssertionError("the warm pack's output or re-stamped rows != "
                             "the plain pack and store")

    def copy_store():
        for b, c in zip(rs.bank, final):
            b[j0:j0 + count].copy_(c.reshape(b[0].shape).expand(
                b[j0:j0 + count].shape))
    nbytes, ops = pack_cost((tk[None], lf[None], ft.Carry(
        *[f[None] for f in final])), {})
    # the re-stamp: one carry read, count rows written
    rb = row + count * row
    restamp = dict(
        rows=count, first_row=j0, row_bytes=row,
        pack_us=time_launches(lambda: fc.pack_outputs(tk, lf, final)) * 1e3,
        pack_restamp_us=time_launches(lambda: fc.pack_outputs(
            tk, lf, final, store=(rs, j0, count))) * 1e3,
        pack_bound_us=bound_ms(nbytes, ops)[0] * 1e3,
        pack_restamp_bound_us=bound_ms(nbytes + rb, ops)[0] * 1e3,
        restamp_bound_us=bound_ms(rb, 0)[0] * 1e3,
        plain_store_us=time_launches(lambda: ft._bank_store_ref(
            rs.bank, final, j0, count)) * 1e3,
        copy_us=time_launches(copy_store) * 1e3,
        kernels=kernels_per_call(lambda: fc.pack_outputs(
            tk, lf, final, store=(rs, j0, count))))
    log(f"[time] pack_outputs at the warm suffix without and with the "
        f"re-stamp of its pad rows: {json.dumps(restamp)}")
    if len(restamp["kernels"]) != 1:
        raise AssertionError(f"the re-stamping pack issued "
                             f"{restamp['kernels']}")
    return folded, prologue, restamp


def inp_bits(st) -> int:
    """Bools in the arena's bool section at the statics ``st``."""
    from karpenter_provider_aws_tpu_torch.ops.hostpack import (
        in_layout_bool, layout_sizes)
    return layout_sizes(in_layout_bool(*(st[k] for k in
                                         "T D Z C G E P K M".split()), 1,
                                       st["Q"]))


def _absorb_cost(kw, dense=False):
    """(bytes, ops) of one consol_absorb call from its inputs: each input
    read once, the answers written; one 64-bit quotient per (live group,
    compatible node, dim with R > 0) plus the prefix and the fill per
    (live group, node)."""
    n = kw["n"]
    B, G = n.shape
    if dense:
        _, E, D = kw["ex_alloc"].shape
        npos = (kw["R"] > 0).sum(-1)
        ncomp = kw["ex_compat"].sum(-1)
        nbytes = (16 * B * E * D + kw["ex_compat"].numel()
                  + 8 * kw["R"].numel() + 8 * B * G + B)
    else:
        E, D = kw["ex_alloc"].shape
        npos = (kw["R_tab"][kw["gid"].long()] > 0).sum(-1)
        ncomp = (kw["compat_tab"][kw["cid"].long()]
                 & kw["alive"][:, None, :]).sum(-1)
        nbytes = (16 * E * D + kw["compat_tab"].numel()
                  + 8 * kw["R_tab"].numel() + 16 * B * G + B * E + B)
    ops = int(((ncomp * npos + 3 * E) * (n > 0)).sum())
    if "type_alloc" in kw:
        T, P = kw["type_alloc"].shape[0], kw["padmit"].shape[0]
        nbytes += (8 * kw["type_alloc"].numel() + 8 * T
                   + kw["tcompat"].numel() + kw["padmit"].numel()
                   + kw["pool_types"].numel() + 8 * B)
        ops += B * T * (G + P + D)
    return nbytes, ops


def k7_times(caps, launches):
    """The K7 kernels at the consolidation phase's shapes (the captured
    inputs of its last rounds), beside the plain versions, and the K2
    kernels on their lane axis at both subset rounds' lanes, the last
    commit also with the summary rows (``summary_times``). Returns
    (records for the kernels line, lane-axis record, summary record)."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    recs = []

    def record(name, ms, pms, nbytes, ops):
        b, by = bound_ms(nbytes, ops)
        recs.append(dict(name=name, route="cuda", **KERNELS[name],
                         launches=launches.get(name, 0), ms=ms, plain_ms=pms,
                         bound_ms=b, bound_by=by, library_ms=None,
                         bytes=nbytes, ops=ops))

    for name, key, fn, ref, dense in (
            ("consol_absorb_deletions", "deletions", ct.deletions_feasible,
             ct._deletions_feasible_ref, False),
            ("consol_absorb_prescreen", "prescreen",
             ct.replacements_prescreen, ct._replacements_prescreen_ref,
             False),
            ("consol_absorb_dense", "dense", ct.deletions_feasible_dense,
             ct._deletions_feasible_dense_ref, True)):
        kw = caps[key][1]
        record(name, time_launches(lambda: fn(**kw)),
               time_launches(lambda: ref(**kw), reps=5),
               *_absorb_cost(kw, dense))

    # the gather at both rounds' shapes: the record at (a), (b) beside it
    gathers = {key: gather_times(caps[key]) for key in ("fleet", "prefix")}
    record("subset_gather", *gathers["fleet"][:2], gathers["fleet"][2], 0)
    b_ms, b_pms, b_bytes = gathers["prefix"]
    recs[-1].update(prefix_ms=b_ms, prefix_plain_ms=b_pms,
                    prefix_bound_ms=bound_ms(b_bytes, 0)[0])
    log(f"[time] subset_gather at round (b) "
        f"({tuple(caps['prefix'][2]['gid'].shape)} lanes x groups): "
        f"{b_ms * 1e3:.2f} us/launch, bound "
        f"{bound_ms(b_bytes, 0)[0] * 1e3:.4f} us (bytes, {b_bytes} B), "
        f"plain {b_pms * 1e3:.1f} us")
    # the K2 kernels on the lane axis at both subset rounds' shapes, and
    # each round's last commit without and with the summary rows
    lane = {"fleet": k2_lane_times(caps["fleet"], (0,))}
    summary = {"fleet": summary_times(caps["fleet"])}
    torch.cuda.empty_cache()
    Gp = caps["prefix"][2]["gid"].shape[1]
    lane["prefix"] = k2_lane_times(caps["prefix"],
                                   sorted({0, Gp // 4, Gp // 2, 3 * Gp // 4}))
    summary["prefix"] = summary_times(caps["prefix"])
    torch.cuda.empty_cache()
    return recs, lane, summary


def summary_times(cap):
    """A captured subset round's last ``ffd_group_commit`` on the card
    without and with the summary rows, from the same state (the kernels'
    scan up to that group's headroom, restored before each launch): µs
    by CUDA events, the rows checked against ``_subset_summary_ref`` of
    the scan's own outputs first; the plain summary's µs, and the bound
    of the rows' work (the leftovers, num_nodes, the t0 and keep rows,
    the prices of the types that are on, the removed prices read once,
    the rows written)."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    arena, tp, t, kw = cap
    E = kw["E"]
    B, Gq = t["gid"].shape
    T = arena.A.shape[0]
    st, _ = k2_lane_scan(cap, Gq - 1)
    fc.ffd_slot_headroom(st, Gq - 1)
    scratch = list(st.carry) + [st.k]    # what the commit writes
    before = [x.clone() for x in scratch]

    def restore():
        for dst, src in zip(scratch, before):
            dst.copy_(src)
    keep, rp = t["keep"], t["removed_price"]
    args, rows = cc.summary_args(st, keep, tp, rp)
    fc.ffd_group_commit(st, Gq - 1, summary=args)
    ref = (st.leftover, st.carry.num_nodes, st.carry.types, keep, tp, rp, E)
    if not torch.equal(rows, ct._subset_summary_ref(*ref)):
        raise AssertionError("the commit's summary rows != the plain rows")
    on = int((st.carry.types[:, E] & keep).sum())
    nbytes = 8 * B * Gq + 4 * B + 2 * B * T + 8 * on + 8 * B + 40 * B
    out = dict(
        lanes=B, groups=Gq, T=T, shape=[st.cluster, st.threads],
        commit_us=time_launches(lambda: fc.ffd_group_commit(st, Gq - 1),
                                reps=20, setup=restore) * 1e3,
        commit_summary_us=time_launches(
            lambda: fc.ffd_group_commit(st, Gq - 1, summary=args), reps=20,
            setup=restore) * 1e3,
        summary_bound_us=bound_ms(nbytes, 2 * B * T)[0] * 1e3,
        summary_bytes=nbytes,
        plain_summary_us=time_launches(
            lambda: ct._subset_summary_ref(*ref), reps=10) * 1e3)
    del st, scratch, before
    return out


def gather_cost(arena, gid) -> int:
    """The bytes ``subset_gather`` must move: the union arena's rows it
    reads (once), the lanes' gid, dead and keep, and every lane field
    written."""
    B, Gq = gid.shape
    T, D = arena.A.shape
    Gu, E = arena.ex_compat.shape
    Z, C, P = arena.agz.shape[1], arena.agc.shape[1], arena.admit.shape[1]
    row = 8 * D + T + Z + C + P + 8 * P * D + E   # one group's lane fields
    gather_in = (T * Z * C + Gu * row + 16 * E * D
                 + 4 * B * Gq + B * E + B * T)
    return gather_in + B * (T * Z * C + Gq * row + 16 * E * D)


def gather_times(cap, reps=20):
    """(ms, plain ms, bytes) of ``subset_gather`` on a captured round's
    inputs (``subset_rows_check``'s (arena, tprice, lanes, statics))."""
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    arena, _, t, _ = cap
    args = (arena, t["gid"], t["n"], t["dead"], t["keep"])
    return (time_launches(lambda: cc.subset_gather(*args), reps=reps),
            time_launches(lambda: ct._subset_gather_ref(*args), reps=3),
            gather_cost(arena, t["gid"]))


def k2_cost(inp, c0, g, P, cand, c1=None, take=None):
    """((bytes, ops) of ffd_slot_headroom, (bytes, ops) of
    ffd_group_commit) of one group step from its data, one lane or a
    lane axis (``inp``/``c0`` lane-stacked): the entry carry ``c0``, the
    headroom's candidates ``cand``, and for the commit the exit carry
    ``c1`` and the takes ``take`` (else its cost is None). Each input
    the function needs read once, each output written once. The
    headroom: every row's pool and its candidate row and k written; the
    type rows, zones, capacity types and used of the open rows whose
    pool the group admits (one offering test per (type, zone, capacity
    type) and one 64-bit quotient per (candidate cell, dim)); alive and
    ex_compat of the existing rows, and the used and allocatable rows of
    those that are alive and compatible (their D quotients); the new-node
    table of every pool. The commit: the fill over every row's k and
    pool, the takes written; each touched row's used, zones and capacity
    types read and written and its types written, from its candidate
    row (narrowed) or its pool's table row (opened); the pools' caps and
    budgets."""
    import torch
    T, D = inp.A.shape
    Z, C = inp.agz.shape[-1], inp.agc.shape[-1]
    ZC, TB = Z * C, -(-T // 256)
    E = inp.ex_alloc.shape[-2]
    pool = c0.pool.long()
    B = pool.numel() // pool.shape[-1]
    N = pool.shape[-1]
    adm = (pool >= 0) & torch.gather(inp.admit[..., g, :], -1,
                                     pool.clamp(0, P - 1))
    n_adm = int(adm.sum())
    ex_ok = int((c0.alive[..., :E] & inp.ex_compat[..., g, :]).sum())
    n_cand = int(cand.sum())
    hr_bytes = T * D * 8 + P * T \
        + B * (N * 4 + T + T * ZC + P + D * 8 + Z + C + N * T + N * 8
               + E * 2 + P * (D * 8 + Z + C) + P * T * 9 + P * TB * 8) \
        + n_adm * (T + Z + C + D * 8) + ex_ok * D * 16
    hr_ops = n_cand * D + n_adm * T * ZC + ex_ok * D \
        + B * P * T * (D + ZC)
    if c1 is None:
        return (hr_bytes, hr_ops), None
    opened = (c0.pool < 0) & (c1.pool >= 0)
    n_open = int(opened.sum())
    narrowed = int(((c1.types != c0.types).any(-1) & ~opened).sum())
    touched = int(((c1.types != c0.types).any(-1) | (take > 0)
                   | opened).sum())
    lead = pool.shape[:-1]
    pools = torch.zeros(*lead, P + 1, dtype=torch.bool, device=pool.device)
    pools.scatter_(-1, torch.where(opened, c1.pool.long(), P), True)
    n_pools = int(pools[..., :P].sum())
    cm_bytes = T * D * 8 + B * (N * 8 + N * 4 + N * 4 + 8 + P * TB * 8
                                + 4 * P * D * 8 + D * 8) \
        + touched * (T + 2 * (Z + C) + 2 * D * 8) + narrowed * T \
        + n_pools * T * 9
    cm_ops = (narrowed + n_open) * T * D + B * 4 * N
    return (hr_bytes, hr_ops), (cm_bytes, cm_ops)


def k2_lane_scan(cap, upto=None, at=()):
    """The captured subset round's lanes on the card and its K2 scan by
    the kernels, groups [0, upto) (default all): (state, {g: the entry
    carry of each group g in ``at``})."""
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    arena, _, t, kw = cap
    E, P, N = kw["E"], kw["P"], kw["E"] + kw["n_max"]
    B, Gq = t["gid"].shape
    lanes = cc.subset_gather(arena, t["gid"], t["n"], t["dead"], t["keep"])
    st = fc.ScanState(lanes, ft.carry0(lanes, N, E, lanes=B), E=E, P=P,
                      lanes=B)
    entry = {}
    for g in range(Gq if upto is None else upto):
        if g in at:
            entry[g] = ft.Carry(*[x.clone() for x in st.carry])
        fc.ffd_slot_headroom(st, g)
        fc.ffd_group_commit(st, g)
    return st, entry


def k2_lane_times(cap, groups):
    """Both K2 kernels on the lane axis at a captured subset round's
    shape: each timed at the entry carry of every group in ``groups``
    (the kernels' own scan up to there), beside its plain version (32
    lanes timed, scaled to B) and its bound (``k2_cost``, from these
    groups' data); means over the groups. The commit's shape is the
    rule's for B lanes."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import consolidation_torch as ct
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    arena, _, t, kw = cap
    E, P, N = kw["E"], kw["P"], kw["E"] + kw["n_max"]
    B, Gq = t["gid"].shape
    T, D = arena.A.shape
    Z, C = arena.agz.shape[1], arena.agc.shape[1]
    st, entry = k2_lane_scan(cap, max(groups) + 1, set(groups))
    hr, cm, p_hr, p_cm, hb, cb = [], [], [], [], [], []
    nl = min(32, B)               # plain: nl lanes timed, scaled to B
    for g in groups:
        c0 = entry[g]
        for dst, src in zip(st.carry, c0):
            dst.copy_(src)
        fc.ffd_slot_headroom(st, g)
        cand0, k0 = st.cand.clone(), st.k.clone()
        hr.append(time_launches(lambda: fc.ffd_slot_headroom(st, g),
                                reps=20))

        def restore(c0=c0, cand0=cand0, k0=k0):
            for dst, src in zip(st.carry, c0):
                dst.copy_(src)
            st.cand.copy_(cand0)
            st.k.copy_(k0)
        cm.append(time_launches(lambda: fc.ffd_group_commit(st, g), reps=20,
                                setup=restore))
        restore()
        fc.ffd_group_commit(st, g)
        (hbn, hop), (cbn, cop) = k2_cost(st.inp, c0, g, P, cand0,
                                         st.carry, st.k)
        hb.append(bound_ms(hbn, hop))
        cb.append(bound_ms(cbn, cop))
        sub = [ct.lane_inputs(st.inp, b) for b in range(nl)]
        subc = [ft.Carry(*[x[b] for x in c0]) for b in range(nl)]
        p_hr.append(time_launches(lambda: [ft._slot_headroom_ref(
            sub[b], subc[b], g, E=E, P=P, V=0) for b in range(nl)],
            reps=2) * B / nl)
        p_cm.append(time_launches(lambda: [ft._group_step_ref(
            sub[b], subc[b], g, E=E, P=P, V=0) for b in range(nl)],
            reps=2) * B / nl)
        del sub, subc, cand0, k0, restore
    mean = statistics.fmean
    out = dict(lanes=B, groups=Gq, timed_groups=list(groups), N=N, T=T,
               commit_shape=[getattr(st, "cluster", None),
                             getattr(st, "threads", None)])
    for name, ms, pms, bd in (("ffd_slot_headroom", hr, p_hr, hb),
                              ("ffd_group_commit", cm, p_cm, cb)):
        out[name] = dict(ms=mean(ms), plain_ms=mean(pms),
                         bound_ms=[mean(b[0] for b in bd), bd[0][1]],
                         ms_by_group=ms)
    del st, entry
    return out


def k6_times(c7, launches):
    """The K6 kernels at config 7's shapes, at the states phase 8 kept
    (four steps of each window): each kernel's time beside its plain
    part's, and the bytes and operations of that state's work."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    buf, st, S, states = c7
    T, D, Z, C, G, E, P = (st[k] for k in "T D Z C G E P".split())
    N = E + st["n_max"]
    TB = fc.table_blocks(T)
    inp = ft._packed_inputs_ref(torch.from_numpy(buf).cuda(), T, D, Z, C,
                                G, E, P, 0, 0, 0)
    ps = fc.PrunedState(inp, ft.carry0_pruned(inp, N, E), E=E, P=P, S=S)
    acc = {k: [] for k in ("ffd_pruned_probe", "ffd_pruned_commit")}
    slot = torch.arange(N, device=inp.A.device)
    for g, carry in states:
        def restore(carry=carry):
            for dst, src in zip(ps.carry, carry):
                dst.copy_(src)
        restore()
        sel, cnt, cand_s, k_s, tab = ft._pruned_probe_ref(inp, carry, g, E=E,
                                                          P=P, S=S)
        nxt, take, _ = ft._pruned_commit_ref(
            inp, carry, g, sel, cnt, cand_s, k_s, tab, E=E, P=P, S=S)
        n_sel = int(cnt[0])
        # the rows the screen's type overlap needs: open, admitted, alive,
        # bound-positive, with a zone and a capacity-type overlap
        R = inp.R[g]
        pool = carry.pool.long()
        qb = torch.where(R > 0, torch.div(carry.cap_hint - carry.used,
                                          torch.where(R > 0, R, 1),
                                          rounding_mode="floor"), ft.BIG)
        screened = int(((slot >= E) & carry.alive & (pool >= 0)
                        & inp.admit[g][pool.clamp(0, P - 1)]
                        & (qb.amin(-1) > 0)
                        & (carry.zones & inp.agz[g]).any(1)
                        & (carry.ct & inp.agc[g]).any(1)).sum())
        fc.ffd_pruned_probe(ps, g)
        acc["ffd_pruned_probe"].append((
            time_launches(lambda: fc.ffd_pruned_probe(ps, g)),
            time_launches(lambda: ft._pruned_probe_ref(
                inp, carry, g, E=E, P=P, S=S), reps=10),
            # reads, each once: every slot's pool, alive, cap_hint, used,
            # zones and ct, the screened rows' types, the group's R, agz,
            # agc, admit and F rows; the catalog A and offerings; the pool
            # tables and daemon rows. Writes: sel, cnt, the candidate rows
            # and headrooms, the table (candn, hrn, the partial caps and
            # cap_hint rows)
            2 * N * D * 8 + N * (4 + 1 + Z + C) + screened * T + D * 8 + Z
            + C + P + T + T * D * 8 + T * Z * C + P * (T + Z + C + D * 8)
            + S * 4 + 8 + S * T + S * 8 + P * (9 * T + TB * 8 + TB * D * 8),
            # the bound pass and the screen's overlap, the selected rows'
            # offerings and headroom, the table's candidates and headroom
            N * D + screened * T + int(cand_s.sum()) * D + n_sel * T * Z * C
            + P * T * (2 * D + Z * C)))

        def setup(ps=ps, carry=carry, sel=sel, cnt=cnt, cand_s=cand_s,
                  k_s=k_s, tab=tab):
            for dst, src in zip(ps.carry, carry):
                dst.copy_(src)
            ps.sel.copy_(sel)
            ps.cnt.copy_(cnt)
            ps.cand.copy_(cand_s)
            ps.ks.copy_(k_s)
            for dst, src in zip(ps.table(), tab):
                dst.copy_(src)
        n_take = int((take[E:] > 0).sum())
        opened = (carry.pool == -1) & (nxt.pool >= 0)
        new = int(opened.sum())
        newp = len(set(nxt.pool[opened].tolist()))
        # k (the selection, the existing rows), used (read + write), pool,
        # A for the takers' fit, the takers' candidate rows, the table's
        # caps and cap_hint rows and the opened pools' rows, pool limits
        # and usage, the narrowed and new rows, takes, leftover
        nbytes = (2 * N * 8 + S * 12 + E * D * 8 + 2 * N * D * 8 + N * 4
                  + (T * D * 8 if n_take else 0) + 2 * n_take * T
                  + P * (8 + D * 8) + newp * 9 * T + 3 * P * D * 8
                  + new * (T + Z + C + 2 * D * 8 + 5) + N * 4 + 8)
        ops = n_take * T * D + new * T + 4 * N + P * D
        acc["ffd_pruned_commit"].append((
            time_launches(lambda: fc.ffd_pruned_commit(ps, g), setup=setup),
            time_launches(lambda: ft._pruned_commit_ref(
                inp, carry, g, sel, cnt, cand_s, k_s, tab, E=E, P=P, S=S),
                reps=10),
            nbytes, ops))
    out = []
    for name, rows in acc.items():
        ms, pms, nbytes, ops = (statistics.fmean(r[i] for r in rows)
                                for i in range(4))
        b, by = bound_ms(nbytes, ops)
        out.append(dict(name=name, route="cuda", **KERNELS[name],
                        launches=launches[name], ms=ms, plain_ms=pms,
                        bound_ms=b, bound_by=by, library_ms=None,
                        bytes=nbytes, ops=ops))
    del ps, inp
    torch.cuda.empty_cache()
    return out


def pour_work(carry, r, gx, *, T, D, Z, C, P, N, GZ, EVCAP):
    """(bytes, operations) of one ``topo_pour`` launch,
    counted from the plain pour's result ``r`` at the entry ``carry``
    (``gx``: the group's topology rows). Read: the admissibility inputs
    of every slot (room, zone fix, pool), the hostname counter rows the
    group is constrained by, the zone counters, the candidate and used
    rows of the slots that held nodes before the group and got pods, A
    when a slot narrows, the offerings when a zone was fixed, the pool
    statics when a node was opened, the rows; written: the touched
    slots' type, zone, ct and used rows, the counter entries they add
    to, the new slots' alive and pool, the fixed zones, take, leftover
    and the log row. Rows of cand evaluated and then rejected, and
    counter entries of untouched slots, are not counted. Operations: per
    event the admissibility of every slot against the constraining
    counter rows, per zone fix the fit and offering scan over T, per
    touched slot its narrowing over T."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import topo_torch as tt
    touched = (r.take > 0) & (r.carry.pool >= 0)
    nt = int(touched.sum())
    old = torch.arange(N, device=touched.device) < int(carry.num_nodes[0])
    ne = int((touched & old).sum())
    n_new = int(r.carry.num_nodes[0]) - int(carry.num_nodes[0])
    events = int(r.ev_n)
    kinds = r.ev["kind"][:events]
    n_fix = int((kinds == tt.K_FIX).sum())
    opened = n_new > 0
    h_read = int(((gx.hs_skew < tt.BIG) | gx.ha_any).sum())
    h_write = int(gx.hs_any.sum()) + int(gx.member_h >= 0)
    z_write = int(gx.zs_any.sum()) + int(gx.member_z >= 0)
    nbytes = (N * 16 + h_read * N * 8 + GZ * Z * 8
              + ne * (T + D * 8) + (T * D * 8 if nt else 0)
              + (T * Z * C if n_fix else 0)
              + (P * T * (1 + 8 + Z) + P * Z * 9 + P * 9 if opened else 0)
              + P * D * 16 + D * 8 + 4 * (GZ * 2 + h_read)
              + nt * (T + Z + C + D * 8) + nt * h_write * 8
              + z_write * Z * 8 + n_new * 5 + n_fix * 4
              + N * 4 + 8 + EVCAP * 5 * 8)
    ops = (events * N * max(h_read, 1) + n_fix * T * (D + Z * C)
           + nt * T * D)
    return nbytes, ops


def k9_times(c3, launches):
    """The K9 kernels at config 3's states (every group's entry state from
    phase 11): each kernel's time beside its plain part's, and the bytes
    and operations of that state's work (each input read once, each
    output written once; a pour's operations count its events); the pool
    statics once, as a scan launches them (one chunk of every topology
    group). The pour's record also holds each group's time
    (``group_ms``: group, events, µs) and group 0's apart from the
    others' mean. Also returns the plain groups' ``ffd_group_commit``
    without and with the membership record (``topo_cuda.plain_commit``),
    each from the group's entry state after its headroom: {groups,
    commit_us, commit_record_us}."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import topo_cuda as tc
    from karpenter_provider_aws_tpu_torch.ops import topo_torch as tt
    inp, rows, st, states = c3
    T, D, Z, P, N = st["T"], st["D"], st["Z"], st["P"], st["n_max"]
    C = inp.agc.shape[1]
    GZ, GH, EVCAP = st["GZ"], st["GH"], st["EVCAP"]
    dev = inp.A.device
    ts = tc.topo_state(inp, rows,
                       torch.zeros((GZ, Z), dtype=torch.int64, device=dev),
                       torch.zeros((GH, N), dtype=torch.int64, device=dev),
                       n_max=N, P=P, EVCAP=EVCAP, PMAX=st["PMAX"])
    acc = {k: [] for k in ("topo_pool_statics", "topo_group_start",
                           "topo_pour")}
    commits = []    # a plain group's commit: (without, with the record) ms
    # the statics of chunk 0 (the offering words too), as a scan's first
    # launch: read the arena's type and pool tables, the groups' rows;
    # write the tables and the words. (An older checkout timed by
    # hack/k9_ab.py computes them in each topo_group_start.)
    hoisted = hasattr(tc, "topo_pool_statics")
    n0 = min(ts.chunk, len(ts.topo_groups)) if hoisted else 0
    if not hoisted:
        del acc["topo_pool_statics"]
    if n0:
        acc["topo_pool_statics"].append((
            time_launches(lambda: tc.topo_pool_statics(ts, 0)),
            time_launches(lambda: tt._topo_pool_statics_ref(
                inp, rows, ts.topo_groups[:n0], P=P), reps=5),
            T * D * 8 + T * Z * C + P * (T + Z + C)
            + n0 * (T + D * 8 + Z + C + P + P * D * 8 + 2 * GZ + 4 * GH
                    + 4)
            + n0 * (P * T * (1 + 8 + Z) + P * Z * 9 + P * 9 + 1) + T * 8,
            n0 * P * T * (D + 2 * Z * C)))
        tc.topo_pool_statics(ts, 0)
    slot_ref = getattr(tt, "_topo_slot_start_ref", None)
    groups = []
    for g, carry, cz, ch, zfix, x, r in states:
        def restore(carry=carry, cz=cz, ch=ch, zfix=zfix):
            for dst, src in zip(ts.st.carry, carry):
                dst.copy_(src)
            ts.cz.copy_(cz)
            ts.ch.copy_(ch)
            ts.zfix.copy_(zfix)
        if r is None:               # a group without topology
            def setup(restore=restore, g=g):
                restore()
                fc.ffd_slot_headroom(ts.st, g)
            commits.append((
                time_launches(lambda: fc.ffd_group_commit(ts.st, g),
                              setup=setup),
                time_launches(lambda: tc.plain_commit(ts, g), setup=setup)))
            continue
        gs = x
        n_cand = int(gs.cand.sum())
        # the slots of an admitting pool are the only rows it reads
        na = int((carry.pool >= 0).sum())
        acc["topo_group_start"].append((
            time_launches(lambda: tc.topo_group_start(ts, g), setup=restore),
            time_launches(lambda: slot_ref(inp, carry, g, P=P) if slot_ref
                          else tt._topo_group_start_ref(inp, carry, g, rows,
                                                        P=P), reps=5),
            # read: pool, the admitted slots' types, zones, ct and used, F,
            # admit, offerings, A, R, the group's zone/ct masks; write:
            # cand, rem
            N * 4 + na * (T + Z + C + D * 8) + T + P + T * Z * C
            + T * D * 8 + D * 8 + Z + C + N * T + N * 8,
            n_cand * D + na * T * Z * C))

        def setup_pour(restore=restore, gs=gs, g=g):
            restore()
            ts.st.cand.copy_(gs.cand)
            ts.rem.copy_(gs.rem0)
            if hoisted:
                ts.load_statics(g, gs)
                return
            for f in ("cand_new", "hr_new", "open_ok0", "availz_p",
                      "cap_pz", "cap_any", "zcand_pz"):
                getattr(ts, f).copy_(getattr(gs, f))
            ts.anti_bulk.copy_(gs.anti_bulk.reshape(1))
        nbytes, ops = pour_work(carry, r, tt._row(rows, g), T=T, D=D, Z=Z,
                                C=C, P=P, N=N, GZ=GZ, EVCAP=EVCAP)
        acc["topo_pour"].append((
            time_launches(lambda: tc.topo_pour(ts, g), setup=setup_pour),
            time_launches(lambda: tt._topo_pour_ref(
                inp, carry, cz, ch, zfix, g, rows, gs, P=P, EVCAP=EVCAP,
                PMAX=st["PMAX"]), reps=3),
            nbytes, ops))
        groups.append((g, int(r.ev_n), acc["topo_pour"][-1][0] * 1e3))
    out = []
    for name, rows_ in acc.items():
        if not rows_:
            continue
        ms, pms, nbytes, ops = (statistics.fmean(r[i] for r in rows_)
                                for i in range(4))
        b, by = bound_ms(nbytes, ops)
        out.append(dict(name=name, route="cuda", **KERNELS[name],
                        launches=launches[name], ms=ms, plain_ms=pms,
                        bound_ms=b, bound_by=by, library_ms=None,
                        bytes=nbytes, ops=ops))
        if name == "topo_pour" and groups:
            out[-1].update(
                group_ms=groups, group0_us=groups[0][2],
                others_mean_us=statistics.fmean(x[2] for x in groups[1:])
                if len(groups) > 1 else None)
    log(f"[time] topo_pour by group (group, events, us): {groups}")
    del ts
    folded = dict(groups=len(commits))
    if commits:
        folded.update(
            commit_us=statistics.fmean(c[0] for c in commits) * 1e3,
            commit_record_us=statistics.fmean(c[1] for c in commits) * 1e3)
    return out, folded


def topo_scan_device_ms(c3, evcap=None, reps=10):
    """Mean device ms of the launches of one topology scan of config 3
    (``c3``: phase 11's timing states) at ``evcap`` (the phase's by
    default): the state is made fresh before each scan, its one
    synchronisation outside the events, and a sleep kernel ahead of the
    launches lets the host enqueue them all before the start event fires.
    (A whole ``solve_scan_topo`` call reads ``has_topo`` back first, so
    its events time the host's enqueue.)"""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import topo_cuda as tc
    inp, rows, st, _ = c3
    dev = inp.A.device
    total = 0.0
    for i in range(reps + 1):
        ts = tc.topo_state(
            inp, rows,
            torch.zeros((st["GZ"], st["Z"]), dtype=torch.int64, device=dev),
            torch.zeros((st["GH"], st["n_max"]), dtype=torch.int64,
                        device=dev),
            n_max=st["n_max"], P=st["P"], EVCAP=evcap or st["EVCAP"],
            PMAX=st["PMAX"])
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(20_000_000)
        s.record()
        tc.topo_scan(ts)
        e.record()
        torch.cuda.synchronize()
        if i:                       # the first is a warm-up
            total += s.elapsed_time(e)
        del ts
    return total / reps


def k5_times(states, mix, launches):
    """The K5 kernels at the striped cluster's states (phase 13's kept
    block-start carries: vectorized and sequential blocks). Each kernel's
    time and its bound per branch; a record's figures are the per-branch
    means weighted by the solve's block mix ``mix`` = (vectorized,
    sequential). The plain time beside both is the plain block
    (``_fused_block_ref``: the headroom, the fills and the commit), and
    the plain headroom part alone beside ``ffd_fused_headroom``. Returns
    (records, per-branch figures)."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    inp, st, kept = states
    T, D, Z, C, E, P, Fu = (st[k] for k in "T D Z C E P F".split())
    N = E + st["n_max"]
    fs = fc.FusedState(inp, ft.carry0(inp, N, E), E=E, P=P, Fu=Fu)
    log(f"[time] K5 at the striped cluster's blocks: the commit on a "
        f"cluster of {fs.cluster} CTAs")
    acc = {(k, v): [] for k in ("ffd_fused_headroom", "ffd_fused_commit")
           for v in (True, False)}
    for g0, carry, vec in kept:
        def restore(carry=carry):
            for dst, src in zip(fs.carry, carry):
                dst.copy_(src)
        restore()
        fc.ffd_fused_headroom(fs, g0)
        cand, k = fs.cand.clone(), fs.k.clone()
        tab = ft._fused_table_ref(inp, g0, Fu, P=P)
        nxt, takes, _ = ft._fused_block_ref(inp, carry, g0, Fu, vec, tab,
                                            E=E, P=P)
        pcand, _ = ft._fused_headroom_ref(inp, carry, g0, Fu, E=E, P=P)
        n_cand = int(pcand.sum())
        acc[("ffd_fused_headroom", vec)].append((
            time_launches(lambda: fc.ffd_fused_headroom(fs, g0),
                          setup=restore),
            time_launches(lambda: (ft._fused_headroom_ref(
                inp, carry, g0, Fu, E=E, P=P), ft._fused_table_ref(
                    inp, g0, Fu, P=P)), reps=5),
            *k5_headroom_cost(st, n_cand)))

        def setup(restore=restore, cand=cand, k=k):
            restore()
            fs.cand.copy_(cand)
            fs.k.copy_(k)
        touched = int((nxt.types != carry.types).any(dim=1).sum()) \
            + int((takes > 0).sum())
        opened = (carry.pool == -1) & (nxt.pool >= 0)
        new = int(opened.sum())
        newp = len(set(nxt.pool[opened].tolist()))
        # read: k, the filled rows' candidates, pool, used, A, the
        # tables' caps and the opened pools' rows, pool limits and usage,
        # daemon, R; write: used, the touched type rows, zones/ct, pool,
        # takes, leftover. A sequential block also recomputes groups
        # 1..Fu-1's headroom over N x T (its operations, and F and the
        # offerings; its other reads are the carry's, counted once)
        nbytes = (Fu * N * 8 + touched * T + N * 4 + 2 * N * D * 8
                  + T * D * 8 + 3 * P * D * 8 + Fu * P * 8 + newp * 9 * T
                  + Fu * P * D * 8 + Fu * D * 8 + touched * (T + Z + C)
                  + Fu * N * 4 + Fu * 8
                  + (0 if vec else T * (Fu + Z * C)))
        ops = touched * T * D + new * T + 4 * N * Fu + Fu * P * D
        if not vec:
            ops += (Fu - 1) * (n_cand // Fu * D + N * T * Z * C)
        acc[("ffd_fused_commit", vec)].append((
            time_launches(lambda: fc.ffd_fused_commit(fs, g0), setup=setup),
            time_launches(lambda: ft._fused_block_ref(
                inp, carry, g0, Fu, vec, tab, E=E, P=P), reps=5),
            nbytes, ops))
    out, per_branch = [], {}
    w = {True: mix[0] / (mix[0] + mix[1]), False: mix[1] / (mix[0] + mix[1])}
    for name in ("ffd_fused_headroom", "ffd_fused_commit"):
        fig = {}
        for vec in (True, False):
            rows_ = acc[(name, vec)]
            ms, pms, nbytes, ops = (statistics.fmean(r[i] for r in rows_)
                                    for i in range(4))
            fig[vec] = (ms, pms, nbytes, ops, bound_ms(nbytes, ops)[0])
            per_branch[f"{name} {'vectorized' if vec else 'sequential'}"] \
                = dict(us=ms * 1e3, plain_us=pms * 1e3,
                       bound_us=fig[vec][4] * 1e3, bytes=nbytes, ops=ops,
                       blocks=len(rows_))
        ms, pms, nbytes, ops = (sum(w[v] * fig[v][i] for v in w)
                                for i in range(4))
        b, by = bound_ms(nbytes, ops)
        out.append(dict(name=name, route="cuda", **KERNELS[name],
                        launches=launches[name], ms=ms, plain_ms=pms,
                        bound_ms=b, bound_by=by, library_ms=None,
                        bytes=nbytes, ops=ops))
    del fs
    for B, fig in k5_batch_headroom_times().items():
        per_branch[f"ffd_fused_headroom B={B}"] = fig
    return out, per_branch


def k5_headroom_cost(st, n_cand, lanes=1):
    """Bytes and operations of one ``ffd_fused_headroom`` launch at the
    statics ``st`` (T D Z C E P F n_max) whose block has ``n_cand``
    candidate cells over its groups and lanes: read once, types, used,
    zones, ct, pool, alive, the catalog (A, offerings), each group's F,
    admit, R, zone/ct masks, daemon rows and existing-compat row, the pool
    tables, the existing allocatable; write the Fu candidate rows and
    headrooms and the Fu x P tables (candn, hrn, caps); one quotient per
    (candidate cell, dim), one offering test per (slot, type, zone,
    capacity type) and group, the tables' per (group, pool, type). Each
    lane reads and writes its own."""
    T, D, Z, C, E, P, Fu = (st[k] for k in "T D Z C E P F".split())
    N = E + st["n_max"]
    nbytes = (N * T + N * D * 8 + N * (Z + C + 5) + T * D * 8 + T * Z * C
              + Fu * (T + P + D * 8 + Z + C + E + P * D * 8)
              + P * (T + Z + C) + E * D * 8
              + Fu * N * T + Fu * N * 8 + Fu * P * (9 * T + 8))
    ops = Fu * N * T * Z * C + Fu * P * T * (D + Z * C)
    return lanes * nbytes, n_cand * D + lanes * ops


def k5_batch_headroom_times(sizes=BATCH_SIZES, blocks=4, n_sigs=96):
    """``ffd_fused_headroom`` at the batch cells' shapes (B lanes of
    ``examples.batch_snapshots``: 96 signatures of 4 pods, three pools,
    Gp = 128, F = 4): its time at the first ``blocks`` block starts, each
    from every lane's plain block-start carry (the plain blocks chained
    on the card), beside the plain headroom part over the B lanes and the
    bound (``k5_headroom_cost``). Returns {B: figures}, means over the
    blocks."""
    import numpy as np
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    out = {}
    for B in sizes:
        fenv.reset_pod_counter()
        snaps = examples.batch_snapshots(fenv.Environment(), batch=B,
                                         n_sigs=n_sigs)
        solver = CUDASolver(incremental=False)
        calls = []
        orig = solver._dispatch_many

        def spy(bufs, orig=orig, calls=calls, **statics):
            calls.append((bufs, statics))
            return orig(bufs, **statics)
        solver._dispatch_many = spy
        solver.solve_batch(snaps)
        bufs, st = calls[-1]
        T, D, Z, C, G, E, P, Fu = (st[k] for k in "T D Z C G E P F".split())
        N = E + st["n_max"]
        d_bufs = torch.from_numpy(np.stack(bufs)).to("cuda")
        per = [ft._packed_inputs_ref(d_bufs[b], T, D, Z, C, G, E, P, 0, 0,
                                     0, Fu) for b in range(B)]
        inp = ft.KernelInputs(*[None if f[0] is None else torch.stack(f)
                                for f in zip(*per)])
        carries = [ft.carry0(x, N, E) for x in per]
        indep = [ft.block_indep(x.fuse, Fu).tolist() for x in per]
        fs = fc.FusedState(inp, ft.carry0(inp, N, E, lanes=B), E=E, P=P,
                           Fu=Fu, lanes=B)
        rows = []
        for g0 in range(0, blocks * Fu, Fu):
            entry = [ft.Carry(*[t.clone() for t in c]) for c in carries]

            def restore(entry=entry):
                for b, c in enumerate(entry):
                    for dst, src in zip(fs.carry, c):
                        dst[b].copy_(src)
            n_cand = sum(int(ft._fused_headroom_ref(
                x, c, g0, Fu, E=E, P=P)[0].sum())
                for x, c in zip(per, entry))
            ms = time_launches(lambda: fc.ffd_fused_headroom(fs, g0),
                               setup=restore)
            pms = time_launches(lambda: [(ft._fused_headroom_ref(
                x, c, g0, Fu, E=E, P=P), ft._fused_table_ref(
                    x, g0, Fu, P=P)) for x, c in zip(per, entry)], reps=2)
            rows.append((ms, pms, *k5_headroom_cost(st, n_cand, lanes=B)))
            for b, x in enumerate(per):
                tab = ft._fused_table_ref(x, g0, Fu, P=P)
                carries[b] = ft._fused_block_ref(
                    x, carries[b], g0, Fu, indep[b][g0 // Fu], tab, E=E,
                    P=P)[0]
        ms, pms, nbytes, ops = (statistics.fmean(r[i] for r in rows)
                                for i in range(4))
        out[B] = dict(us=ms * 1e3, plain_us=pms * 1e3,
                      bound_us=bound_ms(nbytes, ops)[0] * 1e3, bytes=nbytes,
                      ops=ops, blocks=blocks, N=N, T=T, P=P)
        del fs
    return out


def k8_time(tables):
    """K8 on one set of its tables, beside the plain version: (ms, plain
    ms, bound ms, bound_by, bytes, ops). Bytes: every input read once,
    the [B] answer written; operations: per lane the refund load (E·D),
    and per group with pods one 64-bit quotient per (compatible node, dim
    with R > 0) plus the prefix and the fill per node."""
    from karpenter_provider_aws_tpu_torch.ops import consolidation_cuda as cc
    from karpenter_provider_aws_tpu_torch.scheduling import preempt_torch as pt
    ex_alloc, ex_used, ex_compat, R, n, freed = tables
    B, E, D = freed.shape
    G = R.shape[0]
    nbytes = (16 * E * D + ex_compat.numel() + 8 * R.numel() + 8 * G
              + 8 * B * E * D + 8 * B)
    per_group = (ex_compat.sum(-1) * (R > 0).sum(-1) + 3 * E) * (n > 0)
    ops = B * (E * D + int(per_group.sum()))
    ms = time_launches(lambda: cc.preempt_absorb(*tables))
    pms = time_launches(lambda: pt._preempt_solve_ref(*tables), reps=10)
    return (ms, pms, *bound_ms(nbytes, ops), nbytes, ops)


def k8_times(tables, wide, launches):
    """K8 at the preemption round's shapes (its own tables) for the
    kernels line, and at each wider wave's (``wide``, {G: tables})."""
    ms, pms, b, by, nbytes, ops = k8_time(tables)
    by_g = [dict(G=tables[3].shape[0], ms=ms, plain_ms=pms, bound_ms=b,
                 bound_by=by)]
    for g, t in sorted(wide.items()):
        gms, gpms, gb, gby, _nb, _ops = k8_time(t)
        by_g.append(dict(G=g, ms=gms, plain_ms=gpms, bound_ms=gb,
                         bound_by=gby))
    return [dict(name="consol_absorb_preempt", route="cuda",
                 **KERNELS["consol_absorb_preempt"],
                 launches=launches["consol_absorb_preempt"], ms=ms,
                 plain_ms=pms, bound_ms=b, bound_by=by, library_ms=None,
                 bytes=nbytes, ops=ops)], by_g


def caps_cost(st):
    """Bytes and operations of ``mesh_new_caps`` on a rank's state: A,
    the offerings, F, the pool types, R, the daemon rows, the group and
    pool narrowings and the minValues pairs read once, the caps (and h1n)
    written once; a test and a quotient a (group, pool, type, dim or
    pair)."""
    inp = st.inp
    Tl, D, G, K, M, V, P = st.T, st.D, st.G, st.K, st.M, st.V, st.P
    Z, C = inp.agz.shape[1], inp.agc.shape[1]
    return (8 * Tl * D + Tl * Z * C + G * Tl + P * Tl + 8 * G * P * D
            + 8 * G * D + (G + P) * (Z + C) + 16 * K * M
            + 8 * G * P * (1 + K * V), G * P * Tl * (D + Z * C))


def k10_cost(st, g, c0, c1, take):
    """Bytes and operations of each K10 kernel on a rank's state ``st``
    at group step g, from its data: the entry carry ``c0``, the headroom's
    candidates ``st.cand``, the fill's takes ``take`` and the commit's
    exit carry ``c1``. Each input a kernel needs read once, each output
    written once. The headroom and the commit count as K2's do
    (``k2_cost`` on the shard, whose existing rows are the fill's: E = 0
    in the kernels): the open rows whose pool the group admits and the
    new-node table of every pool; the rows the commit touches (narrowed
    from their candidate row, opened from their pool's table row), with
    the caps and the take by pool reduced over the shards read in place
    of the table's partial caps, and no fill. The caps: every (group,
    pool, type) test and quotient; the fill: a few per slot and pool."""
    inp = st.inp
    Tl, D, G, Nl, K, M, V, E, P = (st.T, st.D, st.G, st.Nl, st.K, st.M,
                                   st.V, st.E, st.P)
    Z, C = inp.agz.shape[1], inp.agc.shape[1]
    ZC = Z * C
    local = inp._replace(ex_alloc=inp.ex_alloc[:0],
                         ex_compat=inp.ex_compat[:, :0])
    hr, cm = k2_cost(local, c0, g, P, st.cand, c1, take)
    TB = -(-Tl // 256)
    return {
        "mesh_new_caps": caps_cost(st),
        "mesh_slot_headroom": hr,
        "mesh_fill": (
            16 * Nl + 6 * Nl + 16 * min(E, Nl) * D + 8 * (P + 1)
            + 8 * P * D, Nl * (P + 3)),
        "mesh_commit": (cm[0] - 8 * P * TB + 8 * P + 8 * (P + 1),
                        cm[1] - 4 * Nl),
    }


def commit_shape(st):
    """The K10 commit's (CTAs, threads) on a MeshState; None where the
    state has no such shape (one block of 1,024 threads before the
    cluster commit, as ``hack/k10_ab.py`` finds it in an older tree)."""
    return [getattr(st, "cluster", None), getattr(st, "threads", None)]


def k10_times(kept, launches):
    """The K10 kernels at world size 1 (the type mesh, every type and
    slot on one rank) at the last group step of each mesh cell, from the
    kernels' own scan of the earlier steps, beside their plain parts on
    the same CUDA state; bytes and operations by ``k10_cost``. The
    records carry the tp cell; the dp2 cell's times (at its 1,024
    slots) and the fill's three phases are logged beside them."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    from karpenter_provider_aws_tpu_torch.ops.ffd_torch import (Carry,
                                                                KernelInputs)
    from karpenter_provider_aws_tpu_torch.parallel import mesh as pm
    dev = torch.device("cuda")
    cells = {}
    for name, (arrays, stt, n_max) in kept.items():
        E, P, V = stt["E"], stt["P"], stt["V"]
        N = E + n_max
        lay = pm.MeshComm()
        T = arrays["A"].shape[0]
        names = [f for f in pm.FIELDS if arrays.get(f) is not None]
        inp = KernelInputs(**pm._shard_inputs(arrays, lay, names, T, N, None,
                                              V, dev))
        st = mc.MeshState(inp, E=E, P=P, V=V, N=N, slot0=0)
        mc.mesh_new_caps(st)
        g = st.G - 1
        for h in range(g):
            mc.mesh_slot_headroom(st, h)
            mc.mesh_fill(st, h, mc.PHASE_ALL)
            mc.mesh_commit(st, h)

        def snap():
            return {k: t.clone() for k, t in st.buffers().items()}

        def restore(saved):
            for k, t in st.buffers().items():
                t.copy_(saved[k])

        s0 = snap()
        mc.mesh_slot_headroom(st, g)
        s1 = snap()
        phases = {}
        for ph, nm in ((mc.PHASE_A, "a"), (mc.PHASE_B, "b"),
                       (mc.PHASE_C, "c")):
            pre = snap()
            phases[nm] = (time_launches(lambda ph=ph: mc.mesh_fill(st, g, ph),
                                        setup=lambda p=pre: restore(p)),
                          pre)
            restore(pre)
            mc.mesh_fill(st, g, ph)
        restore(s1)
        mc.mesh_fill(st, g, mc.PHASE_ALL)
        s2 = snap()
        take = st.k.clone()
        mc.mesh_commit(st, g)
        c1 = Carry(*[t.clone() for t in st.carry])
        restore(s2)
        cost = k10_cost(st, g, Carry(*[s0[f"carry.{nm}"]
                                       for nm in Carry._fields]), c1, take)
        work = {
            "mesh_new_caps": (
                lambda: mc.mesh_new_caps(st), lambda: mc._new_caps_ref(st),
                s0),
            "mesh_slot_headroom": (
                lambda: mc.mesh_slot_headroom(st, g),
                lambda: mc._slot_headroom_mesh_ref(st, g), s0),
            "mesh_fill": (
                lambda: mc.mesh_fill(st, g, mc.PHASE_ALL),
                lambda: mc._fill_ref(st, g, mc.PHASE_ALL), s1),
            "mesh_commit": (
                lambda: mc.mesh_commit(st, g),
                lambda: mc._commit_mesh_ref(st, g), s2),
        }
        Tl, G, Nl = st.T, st.G, st.Nl
        cells[name] = {}
        for k, (fn, ref, pre) in work.items():
            nbytes, ops = cost[k]
            ms = time_launches(fn, setup=lambda p=pre: restore(p))
            pms = time_launches(ref, reps=10, setup=lambda p=pre: restore(p))
            b, by = bound_ms(nbytes, ops)
            cells[name][k] = dict(ms=ms, plain_ms=pms, bound_ms=b,
                                  bound_by=by, bytes=nbytes, ops=ops)
        cells[name]["fill_phases_ms"] = {nm: v[0] for nm, v in phases.items()}
        cells[name]["shape"] = dict(T=Tl, N=Nl, G=G, P=P, step=g,
                                    commit=commit_shape(st))
    cells["fill_shapes_us"] = fill_shape_times()
    recs = []
    for k in ("mesh_new_caps", "mesh_slot_headroom", "mesh_fill",
              "mesh_commit"):
        r = cells["tp"][k]
        recs.append(dict(name=k, route="cuda", **KERNELS[k],
                         launches=launches[k], library_ms=None, **r))
    return recs, cells


def caps_states(kept, slab, dev):
    """``mesh_new_caps``' states at its main paths' shapes, each a rank's
    ``MeshState`` cut as the dispatch cuts it: the tp cell at world 1 (T
    = 812, G = 4) and its rank 0 on four type shards (Tl = 203), the
    500,000-pod cell's rank 0 on 2 x 2 (Tl = 406), K11's shard (rank 0 of
    2 x 2 cut from host 0's slab of the ceiling: Tl = 406, G = 64) and the
    ceiling at world 1 (T = 812, G = 64). ``kept``: the mesh cells'
    (arrays, statics, n_max) by name; ``slab``: host 0's slab."""
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    from karpenter_provider_aws_tpu_torch.ops.ffd_torch import KernelInputs
    from karpenter_provider_aws_tpu_torch.parallel import distmesh as dm
    from karpenter_provider_aws_tpu_torch.parallel import mesh as pm

    def cut(arrays, stt, n_max, ndp, ntp, slab_rows=False):
        E, P, V = stt["E"], stt["P"], stt.get("V", 0)
        N = E + n_max
        Np = -(-N // ndp) * ndp
        T = arrays["A"].shape[0]
        lay = examples.ShardStub(ndp, 0, [0] * (P + 1), ntp=ntp, tp_idx=0)
        names = [f for f in pm.FIELDS if arrays.get(f) is not None]
        inp = KernelInputs(**pm._shard_inputs(
            arrays, lay, names, -(-T // ntp) * ntp, Np,
            Np if ndp > 1 else None, V, dev))
        return mc.MeshState(inp, E=E, P=P, V=V, N=N, slot0=0)

    whole, wst = dm.tick_arrays(examples.DIST_CEILING_SHAPE,
                                examples.DIST_SEED, 0)
    sl_arrays, sl_st = slab
    out = {"tp": cut(*kept["tp"], 1, 1), "tp_rank": cut(*kept["tp"], 1, 4)}
    if "dp2" in kept:
        out["dp2_rank"] = cut(*kept["dp2"], 2, 2)
    out["k11"] = cut(sl_arrays, sl_st, sl_st["n_max"], 2, 2)
    out["ceiling"] = cut(whole, wst, wst["n_max"], 1, 1)
    return out


def caps_floors_state(ex, dev):
    """``CAPS_CASES``' ``tp_floors`` state of the examples module ``ex``
    (Tl = 203, G = 4, P = 2, K = 3 keys over 5 values: one CTA a (group,
    pool)), seeded as phase 3 seeds it."""
    name, shape, K = next(c for c in ex.CAPS_CASES if c[0] == "tp_floors")
    return ex.caps_state(**shape, seed=len(name), K=K, V=5, device=dev)


def caps_shape_times(states, cmp=None):
    """``mesh_new_caps`` on each of ``states`` (name: ``MeshState``): the
    kernel against its plain part on the same state (through ``cmp`` when
    given), µs a launch (CUDA events), the plain part's, the bound from
    ``caps_cost`` and the CTAs a (group, pool)."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    out = {}
    for name, st in states.items():
        want = st.clone()
        mc._new_caps_ref(want)
        mc.mesh_new_caps(st)
        if cmp is not None:
            cmp("mesh_new_caps", st.caps, want.caps, f"caps at {name}")
        elif not torch.equal(st.caps, want.caps):
            raise AssertionError(f"mesh_new_caps at {name} != plain")
        nbytes, ops = caps_cost(st)
        b, by = bound_ms(nbytes, ops)
        out[name] = dict(
            us=time_launches(lambda: mc.mesh_new_caps(st)) * 1e3,
            plain_us=time_launches(lambda: mc._new_caps_ref(st),
                                   reps=10) * 1e3,
            bound_us=b * 1e3, bound_by=by, bytes=nbytes, T=st.T, G=st.G,
            P=st.P, K=st.K, ctas=mc.caps_cluster(st.T, st.K))
    return out


def pruned_pack_times(c7):
    """The pruned scan's pack at config 7 (one lane, with its bail word):
    one whole pruned dispatch with the pack watched, then ``pack_times``
    on the pack's own inputs."""
    import torch
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    buf, st, S, _ = c7
    _, calls = capture_pack(lambda: fc.solve_scan_packed1_pruned_many_cuda(
        torch.from_numpy(buf).cuda()[None], n_max=st["n_max"], S=S,
        **{k: st[k] for k in "T D Z C G E P".split()}))
    return pack_times(*calls[-1])


def fill_shape_times():
    """``mesh_fill`` at ``examples.FILL_SHAPES`` (the rank's rows of the
    tp cell, the dp2 cell, K11's 2 x 2 shard and the world-1 ceiling, at
    one pool and at eight with limits; K11's first shard with its 128
    existing rows): each phase (a, b, c) and the
    one-launch fill, microseconds a launch from the same entry state
    (``examples.fill_state``, the small earlier-shard prefixes), and the
    CTA's threads (``mesh_cuda.fill_threads``; 1,024 in a checkout
    without the rule)."""
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    out = {}
    for nl, P, E in examples.FILL_SHAPES:
        st, g = examples.fill_state(nl, P, seed=nl + P, before="small", E=E,
                                    device="cuda")
        saved = {k: t.clone() for k, t in st.buffers().items()}

        def restore(st=st, saved=saved):
            for k, t in st.buffers().items():
                t.copy_(saved[k])
        row = {nm: time_launches(lambda ph=ph: mc.mesh_fill(st, g, ph),
                                 setup=restore) * 1e3
               for ph, nm in ((mc.PHASE_A, "a"), (mc.PHASE_B, "b"),
                              (mc.PHASE_C, "c"), (mc.PHASE_ALL, "all"))}
        row["threads"] = mc.fill_threads(nl) \
            if hasattr(mc, "fill_threads") else 1024
        out[f"{nl}x{P}" + (f"e{E}" if E else "")] = row
    return out


def k11_times(kept, launches):
    """K11 at the ceiling: one group step of K10's kernels (the headroom,
    the fill's three phases, the commit) on rank 0's shard of the 2 x 2
    layout, cut from host 0's slab (Nl = 2,112 slots, Tl = 406 types), at
    the last group step, from the kernels' own scan of the earlier steps
    under a ``ShardStub`` (no process group: the type max is the
    identity, the earlier shards' prefixes 0), beside the same step of
    the plain parts on the same CUDA state. Bound: ``k10_cost`` of the
    headroom, the fill (once: the function of its three launches) and
    the commit. ``launches``: the K10 launches of phase 15's main-path
    runs (in this process and on the ranks); the record's times and
    bound are the step's over its five launches, the step's own in the
    returned shape, with each launch's time and the headroom's and the
    commit's bounds."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import mesh_cuda as mc
    from karpenter_provider_aws_tpu_torch.ops.ffd_torch import (Carry,
                                                                KernelInputs)
    from karpenter_provider_aws_tpu_torch.parallel import mesh as pm
    dev = torch.device("cuda")
    arrays, stt = kept
    E, P, n_max = stt["E"], stt["P"], stt["n_max"]
    N = E + n_max
    Np = -(-N // 2) * 2
    lay = examples.ShardStub(2, 0, [0] * (P + 1), ntp=2, tp_idx=0)
    T = arrays["A"].shape[0]
    names = [f for f in pm.FIELDS if arrays.get(f) is not None]
    inp = KernelInputs(**pm._shard_inputs(arrays, lay, names, -(-T // 2) * 2,
                                          Np, Np, 0, dev))
    st = mc.MeshState(inp, E=E, P=P, V=0, N=N, slot0=0)

    def step(g, fns):
        fns["mesh_slot_headroom"](st, g)
        fns["mesh_fill"](st, g, mc.PHASE_A)
        st.before.zero_()
        fns["mesh_fill"](st, g, mc.PHASE_B)
        fns["mesh_fill"](st, g, mc.PHASE_C)
        fns["mesh_commit"](st, g)

    mc.mesh_new_caps(st)
    g = st.G - 1
    for h in range(g):
        step(h, mc.WRAPPERS)
    saved = {k: t.clone() for k, t in st.buffers().items()}

    def restore():
        for k, t in st.buffers().items():
            t.copy_(saved[k])

    # each launch of the step alone, from its own entry state
    pre, each = {}, {}
    for nm, fn in (("mesh_slot_headroom",
                    lambda: mc.mesh_slot_headroom(st, g)),
                   ("mesh_fill_a", lambda: mc.mesh_fill(st, g, mc.PHASE_A)),
                   ("mesh_fill_b", lambda: mc.mesh_fill(st, g, mc.PHASE_B)),
                   ("mesh_fill_c", lambda: mc.mesh_fill(st, g, mc.PHASE_C)),
                   ("mesh_commit", lambda: mc.mesh_commit(st, g))):
        pre[nm] = ({k: t.clone() for k, t in st.buffers().items()}, fn)
        if nm == "mesh_fill_b":
            st.before.zero_()
        fn()
    c1 = Carry(*[t.clone() for t in st.carry])   # the step's exit carry
    for nm, (state, fn) in pre.items():
        def put(state=state):
            for k, t in st.buffers().items():
                t.copy_(state[k])
        each[nm] = time_launches(fn, setup=put) * 1e3
    entry, before_commit = pre["mesh_slot_headroom"][0], pre["mesh_commit"][0]
    restore()
    st.cand.copy_(before_commit["cand"])
    cost = k10_cost(st, g, Carry(*[entry[f"carry.{nm}"]
                                   for nm in Carry._fields]), c1,
                    before_commit["kh"][:st.Nl])
    nbytes = sum(cost[k][0] for k in ("mesh_slot_headroom", "mesh_fill",
                                      "mesh_commit"))
    ops = sum(cost[k][1] for k in ("mesh_slot_headroom", "mesh_fill",
                                   "mesh_commit"))
    ms = time_launches(lambda: step(g, mc.WRAPPERS), setup=restore)
    pms = time_launches(lambda: step(g, mc.PLAIN), reps=10, setup=restore)
    b, by = bound_ms(nbytes, ops)
    # the record is per launch (the step's mean), as its launch count is
    rec = dict(name="dist2_step", route="cuda", **KERNELS["dist2_step"],
               launches=sum(launches.get(k, 0) for k in mc.KERNELS),
               ms=ms / 5, plain_ms=pms / 5, bound_ms=b / 5, bound_by=by,
               library_ms=None, bytes=nbytes / 5, ops=ops / 5)
    restore()
    shape = dict(T=st.T, N=st.Nl, G=st.G, P=P, step=g,
                 ncand=int(before_commit["cand"].sum()),
                 commit=commit_shape(st), step_us=ms * 1e3,
                 plain_step_us=pms * 1e3, bound_step_us=b * 1e3,
                 us_each=each,
                 bound_us_each={k: bound_ms(*cost[k])[0] * 1e3
                                for k in ("mesh_slot_headroom",
                                          "mesh_commit")})
    return [rec], shape


def k1_lane_times(arenas, launches_b):
    """The lane-axis K1 kernels at each batch width, beside the plain
    versions lane by lane."""
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    out = []
    for B, (k1, statics) in arenas.items():
        bufs, n_i64, n_bits, takes, lefts, carry = k1
        words = bufs[:, n_i64:]
        lanes = [ft.Carry(*[f[b] for f in carry]) for b in range(B)]
        pnb, pops = pack_cost((takes, lefts, carry), {})
        recs = {
            f"unpack_bits_lanes_b{B}": (
                time_launches(lambda: fc.unpack_bits_lanes(words, n_bits)),
                time_launches(lambda: [ft._unpack_bits_ref(w, n_bits)
                                       for w in words], reps=5),
                B * (words.shape[1] * 8 + n_bits), 2 * B * n_bits,
                "unpack_bits"),
            f"pack_outputs_lanes_b{B}": (
                time_launches(lambda: fc.pack_outputs_lanes(takes, lefts,
                                                            carry)),
                time_launches(lambda: [ft._pack_outputs_ref(
                    takes[b], lefts[b], lanes[b]) for b in range(B)],
                    reps=5),
                pnb, pops, "pack_outputs"),
        }
        for name, (ms, pms, nbytes, ops, kern) in recs.items():
            b, by = bound_ms(nbytes, ops)
            out.append(dict(name=name, route="cuda", **KERNELS[name],
                            launches=launches_b[B][kern], ms=ms,
                            plain_ms=pms, bound_ms=b, bound_by=by,
                            library_ms=None, bytes=nbytes, ops=ops))
    return out


def solve_device_ms(fn, reps=20):
    """Mean device ms of one whole solve call: a sleep kernel ahead of
    each call lets the host enqueue all of its launches before the start
    event fires, so the events bracket the device work alone."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(20_000_000)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def warm_solve_times(d_buf, st, gl):
    """Device ms of the checkpointed full solve and of the suffix
    re-solves the warm tick runs (every SUF of the live bound), on the
    warm arena."""
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.solver.incremental import \
        suffix_buckets
    ss = examples.solve_statics(st)
    _, bank = ft.solve_scan_packed1_ckpt(d_buf, CK=CK, **ss)
    out = {"full_ckpt": solve_device_ms(
        lambda: ft.solve_scan_packed1_ckpt(d_buf, CK=CK, **ss))}
    for SUF in suffix_buckets(st["G"], CK, GL=gl):
        out[f"suffix@{SUF}"] = solve_device_ms(
            lambda: ft.solve_scan_suffix(d_buf, bank, CK=CK, SUF=SUF,
                                         GL=gl, **ss))
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run phases 3-6, 8, 9 and 11-17 with the "
                         "plain versions at a small size on the CPU (never "
                         "the default)")
    args = ap.parse_args()

    import torch
    sys.path.insert(0, ROOT)
    try:
        import karpenter_provider_aws_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"chip_smoke: the port package is not next to this script ({e})")
        return 2
    if args.cpu_rehearsal:
        return rehearsal(2000, 2)
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this script "
            "needs a CUDA card (or --cpu-rehearsal)")
        return 1

    from karpenter_provider_aws_tpu_torch import device as pdev
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.models.delta import \
        full_existing_encode
    from karpenter_provider_aws_tpu_torch.models.encoding import \
        encode_snapshot
    from karpenter_provider_aws_tpu_torch.ops import ffd_cuda as fc
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.ops import topo_torch as tt
    from karpenter_provider_aws_tpu_torch.ops.hostpack import (
        in_layout_bool, in_layout_i64, layout_sizes, nwords, pack_inputs1)
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    from karpenter_provider_aws_tpu_torch.solver.incremental import \
        live_bound

    t_start = time.perf_counter()
    # ---- phase 1: device ------------------------------------------------
    smi = smi_line()
    dinfo = pdev.describe()
    log(f"[device] {smi} | torch {torch.__version__} | cuda "
        f"{torch.version.cuda} | {dinfo}")
    dev = torch.device("cuda")

    # ---- phase 2: build ---------------------------------------------------
    binfo = fc.build_info()
    log(f"[build] {binfo['seconds']:.2f} s, cached={binfo['cached']}, "
        f"{binfo['path']}")
    for line in binfo["ptxas"].splitlines():
        if any(w in line for w in ("registers", "smem", "spill",
                                   "Compiling entry")):
            log(f"[ptxas] {line.strip()}")

    # the plain scans phase 15 holds the distributed ticks to: on the CPU,
    # in a process of their own (two threads) beside the earlier phases
    import multiprocessing
    plain_pool = multiprocessing.get_context("spawn").Pool(1)
    plain_job = plain_pool.apply_async(plain_fingerprints, (
        (("smoke", examples.DIST_SMOKE_SHAPE),
         ("ceiling", examples.DIST_CEILING_SHAPE)), examples.DIST_SEED, 2))
    plain_pool.close()

    # ---- phase 3: kernels against plain versions --------------------------
    fenv.reset_pod_counter()
    env = fenv.Environment()
    t0 = time.perf_counter()
    snap = config2(fenv, env, PODS)
    log(f"[config2] {PODS} pods built in "
        f"{time.perf_counter() - t0:.2f} s")
    enc = encode_snapshot(snap)
    solver_probe = CUDASolver()
    buf2, st2 = solver_probe.pack(enc, *full_existing_encode(enc, []))
    st2 = dict(st2, n_max=solver_probe._bucket)
    log(f"[config2] statics {st2}, arena {buf2.size} words")
    cmp = Compare()
    cases = [("config2", buf2, st2)]
    for name in examples.CASES:
        arrays, st = examples.example_case(name)
        cases.append((name, pack_inputs1(arrays, *examples.pack_statics(st)),
                      st))
    # a synthetic arena at the catalog's width, with every feature on
    arrays, st = examples.example_case("existing", T=812, G=16, n_max=64,
                                       D=8)
    cases.append(("existing-812", pack_inputs1(
        arrays, *examples.pack_statics(st)), st))
    arrays, st = examples.example_case("min_values", T=812, G=16, n_max=64,
                                       D=8)
    cases.append(("min_values-812", pack_inputs1(
        arrays, *examples.pack_statics(st)), st))
    c2 = None
    for label, buf, st in cases:
        inp, final, tk, lf = check_arena(label, buf, st, cmp, dev)
        if label == "config2":
            c2 = (inp, final, tk, lf)
    # K3 on G=8, CK=2 arenas: every live bound and every SUF it allows
    k3_runs = 0
    for name in ("existing", "min_values"):
        arrays, st = examples.example_case(name, G=8)
        k3_runs += check_k3(f"{name}-G8", pack_inputs1(
            arrays, *examples.pack_statics(st)), st, cmp, dev)
    # K3 on the 50,000-pod warm-cluster arena at the settled slot bucket
    wsnap, _ = examples.warm_cluster(pods=WARM_PODS,
                                     pending_frac=WARM_PENDING)
    wsnap = wsnap()
    wenc = encode_snapshot(wsnap)
    bufw, stw = CUDASolver(incremental=False).pack(
        wenc, *full_existing_encode(wenc, sorted(
            wsnap.existing_nodes, key=lambda n: n.name)))
    stw = dict(stw, n_max=16)
    glw = live_bound(bufw, T=stw["T"], D=stw["D"], G=stw["G"], CK=CK)
    log(f"[warm arena] statics {stw}, live bound {glw}, arena "
        f"{bufw.size} words")
    k3_runs += check_k3("warm50k", bufw, stw, cmp, dev,
                        gls=(glw, stw["G"]))
    # the K2 lane axis with one lane on the main paths' arenas, then K7
    check_lane_one("config2", c2[0], st2, cmp)
    check_lane_one("warm50k", ft._packed_inputs_ref(
        torch.from_numpy(bufw).to(dev), stw["T"], stw["D"], stw["Z"],
        stw["C"], stw["G"], stw["E"], stw["P"], stw["K"], stw["M"],
        stw["Q"]), stw, cmp)
    k7_cases = check_k7_synthetic(cmp, dev)
    k7_cases += check_absorb_forms(cmp, dev)
    k7_cases += check_absorb_edges(cmp, dev)
    k5_cases = check_fused_cases(cmp, dev)
    k1_k10 = check_k1_k10_shapes(cmp, dev)
    torch.cuda.synchronize()
    log(f"[compare] tolerance exact (integer math; any differing word "
        f"fails): {cmp.checks} checks over "
        f"{len(cases)} K1/K2 arenas, {k3_runs} K3 suffix runs, 2 one-lane "
        f"K2 scans, {k7_cases} K7 cases, {k5_cases} K5 arenas and "
        f"{k1_k10} K1 unpack, K1 pack and K10 caps states, max_abs_err "
        f"{cmp.err}")

    # ---- phase 4: the config-2 path -----------------------------------------
    solver = CUDASolver(incremental=False)
    fc.reset_launches()
    times, splits = [], []
    res = None
    for i in range(ROUNDS + 1):
        t0 = time.perf_counter()
        res = solver.solve(snap)
        dt = (time.perf_counter() - t0) * 1e3
        if i:  # round 0 is the warm-up
            times.append(dt)
            splits.append(solver.last_phase_stats)
    launches_c2 = dict(fc.LAUNCHES)
    log(f"[main] launches in the config-2 run ({ROUNDS + 1} solves): "
        f"{launches_c2}; per solve: "
        f"{solver.last_dispatch_stats['launches']}")
    missing = [k for k in ("unpack_bits", "ffd_slot_headroom",
                           "ffd_group_commit", "pack_outputs")
               if launches_c2[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the config-2 "
                             f"path: {missing}")
    want = CUDASolver(device="cpu", incremental=False).solve(snap)
    if res.decision_fingerprint() != want.decision_fingerprint():
        raise AssertionError("CUDA decisions differ from the plain "
                             "versions' decisions")
    placed = sum(len(n.pod_names) for n in res.new_nodes)
    accounted = placed + len(res.existing_assignments) + \
        len(res.unschedulable)
    if accounted != len(snap.pods):
        raise AssertionError(f"{accounted} of {len(snap.pods)} pods placed "
                             "or reported")
    times.sort()
    p50 = statistics.median(times)
    p99 = times[min(len(times) - 1, int(round(0.99 * (len(times) - 1))))]
    split = {k: statistics.median(s[k] for s in splits)
             for k in ("group_ms", "encode_ms", "kernel_ms", "decode_ms")}
    log(f"[main] config2 {PODS} pods: {res.summary()}; solve p50 "
        f"{p50:.3f} ms p99 {p99:.3f} ms over {len(times)} rounds; "
        f"median split {json.dumps(split)}; fingerprint == plain: True")

    # ---- phase 5: the warm-tick path ----------------------------------------
    launches_w, warm = warm_tick_phase()
    per_tick = warm["launches_per_tick"]
    if per_tick["unpack_bits"] != 1 or per_tick["pack_outputs"] != 1 \
            or "ffd_bank_store" in per_tick or "ffd_bank_load" in per_tick:
        raise AssertionError(f"a warm tick's launches {per_tick}: expected 1 "
                             "unpack_bits (loading the resume row), 1 "
                             "pack_outputs (re-stamping the pad rows), no "
                             "ffd_bank_store and no ffd_bank_load")

    # ---- phase 6: the consolidation path -------------------------------------
    launches_k7, c4, caps = consolidation_phase(cmp)
    missing = [k for k in ("consol_absorb_deletions",
                           "consol_absorb_prescreen", "consol_absorb_dense",
                           "subset_gather", "ffd_slot_headroom",
                           "ffd_group_commit")
               if launches_k7.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the consolidation "
                             f"path: {missing}")
    for key in ("fleet", "prefix"):
        per_round = c4[key]["launches_per_round"]
        gq = c4[key]["subset_dispatch"]["groups"]
        one = {k: v for k, v in
               c4[key]["subset_dispatch"]["launches"].items() if v}
        if per_round.get("subset_gather") != 1 or one != dict(
                subset_gather=1, ffd_slot_headroom=gq, ffd_group_commit=gq):
            raise AssertionError(f"{key} subset round launches {one} (a "
                                 f"round: {per_round}) are not 1 gather + "
                                 f"2*{gq} (the last commit writing the "
                                 "summary rows)")
    torch.cuda.synchronize()
    log(f"[compare] after the consolidation phase: {cmp.checks} checks, "
        f"max_abs_err {cmp.err}")

    # ---- phase 8: the G-axis path (config 7 on the pruned kernel) ----------
    launches_c7, c7, c7_states = g_axis_phase(cmp)

    # ---- phase 9: the batch path ---------------------------------------------
    launches_b, batch, batch_arenas = batch_phase(cmp)
    torch.cuda.synchronize()
    log(f"[compare] after the batch phase: {cmp.checks} checks, "
        f"max_abs_err {cmp.err}")

    # ---- phase 11: the topology path (config 3 on the K9 kernels) ----------
    launches_c3, c3, c3_states = topo_phase(cmp)
    missing = [k for k in ("topo_pool_statics", "topo_group_start",
                           "topo_pour", "ffd_slot_headroom",
                           "ffd_group_commit") if launches_c3[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the topology "
                             f"path: {missing}")
    torch.cuda.synchronize()
    log(f"[compare] after the topology phase: {cmp.checks} checks, "
        f"max_abs_err {cmp.err}")

    # ---- phase 16: the preference path (config 6 on the K9 kernels) -------
    launches_c6, c6 = prefs_phase(cmp)
    missing = [k for k in ("topo_pool_statics", "topo_group_start",
                           "topo_pour", "ffd_slot_headroom",
                           "ffd_group_commit") if launches_c6[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the preference "
                             f"path: {missing}")
    # ---- phase 17: the oracle route, then the grouping walk --------------
    launches_o17, o17 = oracle_phase()
    walk = walk_times()
    torch.cuda.synchronize()
    log(f"[compare] after the preference and oracle phases: {cmp.checks} "
        f"checks, max_abs_err {cmp.err}")

    # ---- phase 12: the preemption path (K8) --------------------------------
    launches_p12, p12, p12_tables, p12_wide = preempt_phase(cmp)
    missing = [k for k in ("consol_absorb_preempt", "unpack_bits",
                           "ffd_slot_headroom", "ffd_group_commit",
                           "pack_outputs") if launches_p12[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the preemption "
                             f"path: {missing}")
    torch.cuda.synchronize()
    log(f"[compare] after the preemption phase: {cmp.checks} checks, "
        f"max_abs_err {cmp.err}")
    # ---- phase 13: the fused path (the striped cluster on K5) -------------
    launches_s13, s13, s13_states = fused_phase(cmp)
    missing = [k for k in ("unpack_bits", "ffd_fused_headroom",
                           "ffd_fused_commit", "pack_outputs")
               if launches_s13[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the fused path: "
                             f"{missing}")
    torch.cuda.synchronize()
    log(f"[compare] after the fused phase: {cmp.checks} checks, "
        f"max_abs_err {cmp.err}")
    # ---- phase 14: the mesh path (K10) ---------------------------------
    launches_m14, m14, m14_states = mesh_phase(cmp)
    torch.cuda.synchronize()
    log(f"[compare] after the mesh phase: {cmp.checks} checks, "
        f"max_abs_err {cmp.err}")
    # ---- phase 15: the distributed path (K11) ------------------------------
    launches_d15, launches_d15b, d15, d15_state = dist_phase(
        cmp, plain=plain_job.get(timeout=1200))
    plain_pool.join()
    missing = [k for k in ("mesh_new_caps", "mesh_slot_headroom",
                           "mesh_fill", "mesh_commit")
               if launches_d15[k] <= 0]
    missing += [k for k in ("unpack_bits", "ffd_slot_headroom",
                            "ffd_group_commit", "pack_outputs")
                if launches_d15b.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the distributed "
                             f"path: {missing}")
    torch.cuda.synchronize()
    log(f"[compare] after the distributed phase: {cmp.checks} checks, "
        f"max_abs_err {cmp.err}")
    launches = {k: launches_c2[k] + launches_w[k] + launches_k7.get(k, 0)
                + launches_c7[k] + sum(lb[k] for lb in launches_b.values())
                + launches_c3[k] + launches_c6[k] + launches_o17.get(k, 0)
                + launches_p12[k] + launches_s13[k]
                + launches_m14[k] + launches_d15.get(k, 0)
                + launches_d15b.get(k, 0) for k in launches_c2}

    # ---- phase 10: kernel times --------------------------------------------
    inp, final, tk, lf = c2
    T, D, Z, C, G, E, P = (st2[k] for k in "T D Z C G E P".split())
    n_i64 = layout_sizes(in_layout_i64(T, D, Z, C, G, E, P, 0, 0, 1,
                                       st2["Q"]))
    n_bits = layout_sizes(in_layout_bool(T, D, Z, C, G, E, P, 0, 0, 1,
                                         st2["Q"]))
    d_buf = torch.from_numpy(buf2).to(dev)
    words = d_buf[n_i64:n_i64 + nwords(n_bits)]
    carries = [ft.carry0(inp, E + st2["n_max"], E)]
    for g in range(G - 1):
        carries.append(ft._group_step_ref(inp, carries[-1], g, E=E, P=P,
                                          V=0)[0])
    recs = kernel_times((inp, st2, words, n_bits, carries, tk, lf, final),
                        launches)
    d_bufw = torch.from_numpy(bufw).to(dev)
    folded_w, prologue_w, restamp_w = bank_times(d_bufw, stw, glw)
    per_name = {r["name"]: r for r in recs}
    per_name["ffd_slot_headroom"]["folded_warm"] = folded_w
    per_name["unpack_bits"]["prologue_warm"] = prologue_w
    per_name["pack_outputs"]["restamp_warm"] = restamp_w
    k7_recs, lane, summary = k7_times(caps, launches)
    per_name["ffd_group_commit"]["summary_rounds"] = summary
    log(f"[time] each subset round's last ffd_group_commit without and "
        f"with the summary rows: {json.dumps(summary)}")
    recs += k7_recs
    recs += k6_times(c7_states, launches)
    c7_pack = pruned_pack_times(c7_states)
    log(f"[time] the pruned scan's pack at config 7 (with its bail word): "
        f"{json.dumps(c7_pack)}")
    if c7_pack["kernels"] != 1:
        raise AssertionError(f"the pruned pack issued {c7_pack['kernels']} "
                             "kernels")
    recs += k1_lane_times(batch_arenas, launches_b)
    k9_recs, k9_folded = k9_times(c3_states, launches)
    recs += k9_recs
    log(f"[time] config 3's plain groups: ffd_group_commit without and with "
        f"the membership record, us: {json.dumps(k9_folded)}")
    k8_recs, k8_by_g = k8_times(p12_tables, p12_wide, launches)
    recs += k8_recs
    k5_recs, k5_branch = k5_times(
        s13_states[:3], (s13["fused_blocks"], s13["seq_blocks"]), launches)
    recs += k5_recs
    k10_recs, k10_cells = k10_times(m14_states, launches)
    recs += k10_recs
    caps_st = caps_states(m14_states, d15_state, torch.device("cuda"))
    caps_st["tp_floors"] = caps_floors_state(examples, torch.device("cuda"))
    caps = caps_shape_times(caps_st, cmp)
    log(f"[time] mesh_new_caps at its main paths' shapes and with floors: "
        f"{json.dumps(caps)}")
    k11_recs, k11_shape = k11_times(d15_state, launches_d15)
    recs += k11_recs
    for r in recs:
        r["max_abs_err"] = cmp.err[r["name"]]
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms'] * 1e3:.2f} us"
        k = r["name"].split("_lanes_")[0]
        if k == "dist2_step":   # K11: one step of the K10 kernels
            where = "the distributed path's K10 launches"
        else:
            where = (
                f"config 2: {launches_c2[k]}, warm tick: {launches_w[k]}, "
                f"consolidation: {launches_k7.get(k, 0)}, config 7: "
                f"{launches_c7[k]}, batch: "
                f"{ {b: lb[k] for b, lb in launches_b.items()} }, config "
                f"3: {launches_c3[k]}, config 6: {launches_c6[k]}, the "
                f"tick after the oracle: {launches_o17.get(k, 0)}, "
                f"preemption: {launches_p12[k]}, "
                f"striped: {launches_s13[k]}, mesh: {launches_m14[k]}, "
                f"dist: {launches_d15.get(k, 0) + launches_d15b.get(k, 0)}")
        log(f"[time] {r['name']}: {r['ms'] * 1e3:.2f} us/launch, "
            f"{r['launches']} launches in the main-path runs ({where}), bound "
            f"{r['bound_ms'] * 1e3:.4f} us ({r['bound_by']}, "
            f"{r['bytes']:.0f} B, {r['ops']:.0f} ops), plain "
            f"{r['plain_ms'] * 1e3:.1f} us, library {lib}")
    for key, what in (("fleet", "(a) the whole-fleet round"),
                      ("prefix", "(b) the prefix round")):
        per_r = c4[key]["launches_per_round"]
        n_k2 = per_r.get("ffd_group_commit", 0) * (c4[key]["rounds"] + 1)
        log(f"[time] K2 on the lane axis at {what} ({n_k2:.0f} launches of "
            f"each kernel in its runs; the round's p50 "
            f"{c4[key]['p50_ms']:.3f} ms, median split "
            f"{json.dumps(c4[key].get('median_split_ms'))}): "
            f"{json.dumps(lane[key])}")
    sol = warm_solve_times(d_bufw, stw, glw)
    log(f"[time] warm arena (n_max 16) solve device ms: "
        f"{json.dumps(sol)}")
    per = {r["name"]: r["ms"] for r in recs}
    c7_dev = sum(per[k] * n for k, n in c7["launches_per_solve"].items()
                 if n and k in per)
    log(f"[time] config 7 pruned solve: device ms from the per-launch times "
        f"x launches per solve {c7_dev:.3f} (wall p50 {c7['p50_ms']:.3f}); "
        f"summary {json.dumps(c7)}")
    step = {k: per[k] * 1e3 for k in ("ffd_pruned_probe",
                                      "ffd_pruned_commit")}
    enq = c7["enqueue"]
    pacer = "host" if enq["host_us_per_step"] > sum(step.values()) \
        else "card"
    log(f"[time] config 7 step: {json.dumps(step)} us, "
        f"{sum(step.values()):.2f} us of kernels a step; the host alone "
        f"enqueues a step in {enq['host_us_per_step']:.2f} us, the loop of "
        f"G steps ran at {enq['loop_us_per_step']:.2f} us a step and the "
        f"card spanned {enq['span_us_per_step']:.2f} us a step: paced by "
        f"the {pacer}; before the probe (three launches a step, "
        f"{C7_STEP_BEFORE['source']}): kernels "
        f"{C7_STEP_BEFORE['kernels_us']} us, loop "
        f"{C7_STEP_BEFORE['loop_us']} us, host alone "
        f"{C7_STEP_BEFORE['host_us']} us")
    for B, (k1, statics) in batch_arenas.items():
        dev_ms = solve_device_ms(lambda: ft.solve_scan_packed1_many(
            k1[0], **statics), reps=5)
        log(f"[time] batch B={B}: one solve_scan_packed1_many device ms "
            f"{dev_ms:.3f}; summary {json.dumps(batch[B])}")
        # the same dispatch with the commit's cluster size forced, beside
        # the rule's: the outputs must not move
        want = ft.solve_scan_packed1_many(k1[0], **statics)
        by_cs = {}
        for cs in (1, 2, 4, 8):
            def forced(cs=cs):
                return fc.solve_scan_packed1_many_cuda(k1[0], **statics,
                                                       cluster=cs)
            if not torch.equal(forced(), want):
                raise AssertionError(f"B={B}: cluster {cs} changed the "
                                     "outputs")
            by_cs[cs] = solve_device_ms(forced, reps=5)
        log(f"[time] batch B={B}: device ms by the commit's cluster size "
            f"{json.dumps(by_cs)} (the rule's: {batch[B]['cluster']})")
    c3_dev = sum(per[k] * n for k, n in c3["launches_per_solve"].items()
                 if n and k in per)
    inp3, rows3, st3, _ = c3_states
    c3_scan = solve_device_ms(lambda: tt.solve_scan_topo(
            inp3, rows3,
            torch.zeros((st3["GZ"], st3["Z"]), dtype=torch.int64, device=dev),
            torch.zeros((st3["GH"], st3["n_max"]), dtype=torch.int64,
                        device=dev),
            n_max=st3["n_max"], P=st3["P"], EVCAP=st3["EVCAP"],
            PMAX=st3["PMAX"]), reps=5)
    c3_launch = topo_scan_device_ms(c3_states)
    log(f"[time] config 3 topology solve: device ms from the per-launch "
        f"times x launches per solve {c3_dev:.3f}; one scan's launches, "
        f"device ms {c3_launch:.3f}; one whole solve_scan_topo call (it "
        f"reads has_topo back, so its events time the host's enqueue) "
        f"{c3_scan:.3f} (wall p50 {c3['p50_ms']:.3f}); summary "
        f"{json.dumps(c3)}")
    c6_dev = sum(per[k] * n for rnd in c6["launches_per_solve"]
                 for k, n in rnd.items() if k in per)
    log(f"[time] config 6: device ms from the per-launch times x launches "
        f"per solve {c6_dev:.3f} (wall p50 {c6['p50_ms']:.3f}); summary "
        f"{json.dumps(c6)} | {smi}")
    log(f"[time] the oracle route: {json.dumps(o17)}; the grouping walk, "
        f"group_ms p50 (host): {json.dumps(walk)} | {smi}")
    log(f"[time] K5 by branch at the striped cluster's blocks: "
        f"{json.dumps(k5_branch)}")
    _, st13, _, d13, d13_f1, st13_f1 = s13_states
    s13_dev = {f"F={x['F']}": solve_device_ms(
        lambda b=b, x=x: ft.solve_scan_packed1(
            b, **examples.solve_statics(x)), reps=5)
        for b, x in ((d13, st13), (d13_f1, st13_f1))}
    log(f"[time] striped cluster: one packed solve, device ms "
        f"{json.dumps(s13_dev)} (fused; the same snapshot packed unfused); "
        f"summary {json.dumps(s13)}")
    log(f"[time] K10 at world size 1, the last group step of each mesh "
        f"cell: {json.dumps(k10_cells)}")
    log(f"[time] mesh cells: {json.dumps(m14)}")
    log(f"[time] K11 at the ceiling, one step of rank 0's 2 x 2 shard: "
        f"{json.dumps(k11_shape)}; distributed path: {json.dumps(d15)}")
    log(f"[time] K8 by the wave's signatures G (B = 64, E = "
        f"{P12_NODES}): {json.dumps(k8_by_g)}")
    log(f"[time] preemption: plan p50 {p12['plan']['p50_ms']:.3f} ms, "
        f"reconcile p50 {p12['reconcile_p50_ms']:.3f} ms; summary "
        f"{json.dumps(p12)}")
    log(f"[wall] {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in recs]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def rehearsal(n_pods: int, rounds: int) -> int:
    """Phases 3-6, 8, 9 and 11-17 with the plain versions on the CPU, at
    a small size (config 7 cut to ``n_pods`` pods, one signature per 5;
    config 3, config 6 and the oracle route's snapshots cut to ``n_pods``
    pods; the preemption cluster to 40 nodes;
    the striped cluster to 400 pods over 100 signatures; the mesh cells
    to 400 pods, the dp2 cell with no slot floor; the distributed
    ceiling to 4 groups x 64 types over 256 slots)."""
    import torch
    from karpenter_provider_aws_tpu_torch import examples
    from karpenter_provider_aws_tpu_torch.fake import environment as fenv
    from karpenter_provider_aws_tpu_torch.ops import ffd_torch as ft
    from karpenter_provider_aws_tpu_torch.ops.hostpack import pack_inputs1
    from karpenter_provider_aws_tpu_torch.solver import CUDASolver
    for name in examples.CASES:
        arrays, st = examples.example_case(name)
        buf = pack_inputs1(arrays, *examples.pack_statics(st))
        a = ft.solve_scan_packed1(buf, device="cpu",
                                  **examples.solve_statics(st))
        b = ft.solve_scan_packed1(torch.from_numpy(buf),
                                  **examples.solve_statics(st))
        if not torch.equal(a, b):
            raise AssertionError(name)
    fenv.reset_pod_counter()
    env = fenv.Environment()
    snap = config2(fenv, env, n_pods)
    solver = CUDASolver(device="cpu")
    for _ in range(rounds):
        res = solver.solve(snap)
    placed = sum(len(n.pod_names) for n in res.new_nodes)
    assert placed + len(res.unschedulable) == n_pods
    log(f"[rehearsal] {n_pods} pods: {res.summary()}; "
        f"{solver.last_phase_stats}")
    warm_tick_phase(pods=n_pods, device="cpu")
    cmp = Compare()
    consolidation_phase(cmp, device="cpu", fleet=24, prefix=6, batched=24,
                        rounds=2, dense_rounds=1)
    log(f"[rehearsal] consolidation checks {cmp.checks}")
    g_axis_phase(cmp, device="cpu", n_pods=n_pods, n_sigs=n_pods // 5,
                 rounds=1, max_groups=256)
    batch_phase(cmp, device="cpu", sizes=(3,), rounds=1, n_sigs=64)
    topo_phase(cmp, device="cpu", n_pods=n_pods, rounds=1)
    prefs_phase(cmp, device="cpu", n_pods=n_pods, rounds=1)
    oracle_phase(device="cpu", n_pods=n_pods)
    walk_times(n_pods=n_pods, reps=3)
    preempt_phase(cmp, device="cpu", n_nodes=40, rounds=2, reconciles=2)
    fused_phase(cmp, device="cpu", n_pods=400, n_sigs=100, rounds=1,
                ticks=3, min_vec=1)
    mesh_phase(cmp, device="cpu", cells=(("tp", 400, None),
                                         ("dp2", 400, 0)), rounds=1)
    dist_phase(cmp, device="cpu", ceiling=dict(
        examples.DIST_CEILING_SHAPE, G=4, T=64, n_max=256), rounds=1,
        batches=(5,))
    log(json.dumps({"ok": True, "device": {"platform": "cpu",
                                           "kind": "cpu", "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
