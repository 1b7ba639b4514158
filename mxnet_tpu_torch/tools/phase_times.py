"""Run chosen phases of ``chip_smoke.py`` from several checkouts, one fresh
process each, in the order given: two commits compared on one card.

    python3 -m mxnet_tpu_torch.tools.phase_times --phases gluon,ops_rnn \\
        PARENT CHANGE CHANGE PARENT

Each argument is a directory holding a checkout (its ``chip_smoke.py``
and its package). For each in turn a fresh ``python3`` runs there
``chip_smoke.phase_<name>(seed, card)`` for every name given, so each
tree's own code is imported and built. Their output follows a header line
naming the tree and its run. Needs one CUDA card; returns the first
nonzero exit code.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

_RUNNER = ("import chip_smoke as c; smi = c.card(); "
           "[getattr(c, 'phase_' + n)({seed}, smi) for n in {phases!r}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", required=True,
                    help="comma-separated chip_smoke phase names, e.g. "
                         "gluon,ops_rnn")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    code = _RUNNER.format(seed=args.seed, phases=phases)
    rc = 0
    for i, tree in enumerate(args.trees):
        print(f"=== run {i + 1} of {len(args.trees)}: {tree}, phases "
              f"{phases}", flush=True)
        r = subprocess.run([sys.executable, "-u", "-c", code], cwd=tree,
                           timeout=3000)
        print(f"=== run {i + 1} exit {r.returncode}", flush=True)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
