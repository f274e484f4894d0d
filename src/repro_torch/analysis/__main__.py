"""CLI: ``python -m repro_torch.analysis --backend vec``,
``python -m repro_torch.analysis --kernels [--fuzz 50]`` or
``python -m repro_torch.analysis --contracts`` (port of the reference's
``python -m repro.analysis``).

The default mode runs the chosen backend's round programs once each
through the purity, held-state, memory and (on a mesh) collective passes,
then the host-sync probe over one real round, server round and
evaluation.  ``--kernels`` reads every built kernel's resources and, with
``--fuzz N``, holds each kernel family against its plain version on N
draws of the reference's stream.  ``--contracts`` runs the repository
rules on the port's tree.  Everything but ``--contracts`` runs on the card
unless given ``--device cpu`` (``--kernels`` needs the card).  Exits
non-zero on any un-waived error.  The reference's ``--write-bench`` has no
counterpart: the port writes no ``BENCH_*.json``.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="The port's auditors: round programs (purity, held "
                    "state, memory, collectives, host syncs), the CUDA "
                    "kernels (resources and differential fuzzing) and the "
                    "repository's contract rules.")
    ap.add_argument("--kernels", action="store_true",
                    help="audit the built CUDA kernels instead of the "
                         "round programs (needs the card)")
    ap.add_argument("--contracts", action="store_true",
                    help="run the contract rules on the port's tree")
    ap.add_argument("--backend", default="sharded",
                    choices=["seq", "vec", "sharded", "async",
                             "sequential", "vectorized"],
                    help="runtime backend whose round programs to audit")
    ap.add_argument("--model-parallel", type=int, default=1, metavar="K",
                    help="model-axis size for sharded/async (default 1)")
    ap.add_argument("--arch", default="tx", choices=["tx", "cnn"],
                    help="audit model (dense transformer or ResNet18)")
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the host-sync probe over a real round")
    ap.add_argument("--family", action="append", default=[], metavar="FAM",
                    help="with --kernels: restrict to a kernel family "
                         "(flash_attention / hsic_gram / slstm_scan); "
                         "repeatable")
    ap.add_argument("--fuzz", type=int, default=0, metavar="N",
                    help="with --kernels: also fuzz each family with N "
                         "draws against its plain version (forward and "
                         "gradients)")
    ap.add_argument("--fuzz-seed", type=int, default=0, metavar="S",
                    help="base RNG seed of the --fuzz draws (default 0)")
    ap.add_argument("--waive", action="append", default=[], metavar="CHECK",
                    help="downgrade a check (or a whole family such as "
                         "'pallas') to a warning; repeatable")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full report (findings and artifact "
                         "tables) as JSON")
    ap.add_argument("--verbose", action="store_true",
                    help="also print info-level findings")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the card)")
    args = ap.parse_args(argv)

    if args.contracts:
        from repro_torch.analysis import contracts
        return contracts.main([])
    if args.kernels:
        from repro_torch.analysis import kernel_audit
        report = kernel_audit.run_kernel_audits(
            waive=args.waive, families=args.family or None, fuzz=args.fuzz,
            seed=args.fuzz_seed, device=args.device)
        print(kernel_audit.render_tables(report))
    else:
        from repro_torch.analysis.harness import run_audits
        report = run_audits(args.backend,
                            model_parallel=args.model_parallel,
                            arch=args.arch, waive=args.waive,
                            probe=not args.no_probe, device=args.device)
    print(report.render(verbose=args.verbose))
    if args.json:
        report.dump_json(args.json)
        print(f"report written to {args.json}")
    return 0 if report.ok() else 1


if __name__ == "__main__":
    sys.exit(main())
