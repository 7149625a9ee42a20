"""Time the pruned scan (K6) of one checkout of the PyTorch port on the card.

Runs ``chip_smoke.py``'s config-7 phase (``g_axis_phase``: the kernels
held against their plain parts, then config 7 solved through
``CUDASolver``) and its per-launch timing of the K6 kernels
(``k6_times``), and prints one line ``AB <tag> {json}``: microseconds a
launch per kernel, the solve's p50 and kernel split in ms, and the host's
enqueue per step. To compare two builds, run it on both checkouts in one
call to the card, in the order A B B A:

    for v in a b b a; do python3 hack/k6_ab.py path/to/$v $v; done
"""
import json
import os
import sys


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    launches, c7, states = cs.g_axis_phase(cs.Compare())
    recs = cs.k6_times(states, launches)
    print("AB", tag, json.dumps(dict(
        us={r["name"]: r["ms"] * 1e3 for r in recs}, p50=c7["p50_ms"],
        kernel=c7["median_split_ms"]["kernel_ms"], enq=c7["enqueue"])),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
