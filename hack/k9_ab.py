"""Time the topology pour (K9) of one checkout of the port on a card.

Runs, with the given checkout's package and this tree's ``chip_smoke.py``
(its phase 11 and its K9 timing call only interfaces both trees have;
a checkout whose plain groups launch their own record kernel, as before
the commit recorded them, needs hack/k3_k9_ab.py):
BASELINE config 3 at 50,000 pods (``chip_smoke.topo_phase``: every
group's K9 kernel against its plain part from the same entry state, 11
solves through ``CUDASolver()`` with their p50 and median split, the host
pour's fingerprint, the EVCAP = 1 bail and its re-dispatch), then each
K9 kernel at every group's entry state (``chip_smoke.k9_times``: each
group's pour, the mean, group 0 apart; the pool statics once), and the
device time of one scan's launches (``chip_smoke.topo_scan_device_ms``)
and of one whole ``solve_scan_topo`` call (which reads ``has_topo`` back,
so its events time the host's enqueue) at EVCAP 128 and at the bail's
re-dispatch capacity (``solver.cuda.safe_evcap``). Prints one line ``AB <tag> {json}``. To
compare two builds, run it on both checkouts in one call to the card, in
the order P N N P:

    for v in p n n p; do python3 hack/k9_ab.py path/to/$v $v; done
"""
import importlib.util
import json
import os
import sys


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    spec = importlib.util.spec_from_file_location(
        "k9_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch
    import karpenter_provider_aws_tpu_torch as pkg
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        raise RuntimeError(f"the package came from {pkg.__file__}, not "
                           f"from {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    from karpenter_provider_aws_tpu_torch.ops import topo_torch as tt
    from karpenter_provider_aws_tpu_torch.solver.cuda import safe_evcap
    out = dict(card=cs.smi_line())
    launches, summary, c3 = cs.topo_phase(cs.Compare())
    out["config3"] = summary
    recs, out["plain_commits"] = cs.k9_times(c3, launches)
    out["k9"] = {r["name"]: {k: r[k] for k in r if k not in
                             ("route", "source", "replaces")}
                 for r in recs}
    inp, rows, st, states = c3
    dev = inp.A.device

    def scan(evcap):
        return cs.solve_device_ms(lambda: tt.solve_scan_topo(
            inp, rows,
            torch.zeros((st["GZ"], st["Z"]), dtype=torch.int64, device=dev),
            torch.zeros((st["GH"], st["n_max"]), dtype=torch.int64,
                        device=dev),
            n_max=st["n_max"], P=st["P"], EVCAP=evcap, PMAX=st["PMAX"]),
            reps=10)
    arrays = {"n": inp.n.cpu().numpy(),
              "pool_types": inp.pool_types.cpu().numpy()}
    ev_safe = safe_evcap(arrays, {"has_topo": rows.has_topo.cpu().numpy()})
    # one scan's launches on the card (the state made before the events)
    # and one whole call (it reads has_topo back: the host's enqueue)
    out["scan_device_ms"] = {
        f"EVCAP={e}": cs.topo_scan_device_ms(c3, e) for e in
        (st["EVCAP"], ev_safe)}
    out["scan_call_ms"] = {f"EVCAP={st['EVCAP']}": scan(st["EVCAP"]),
                           f"EVCAP={ev_safe}": scan(ev_safe)}
    print("AB", tag, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
