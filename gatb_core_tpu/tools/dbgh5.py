"""dbgh5-equivalent CLI: full de Bruijn graph build from reads.

Mirrors the reference tool (tools/dbgh5.cpp:34-95) and its flag names
(tools/misc/api/StringsRepository.hpp): -in, -out, -kmer-size,
-abundance-min, -abundance-max, -minimizer-size, -histo-max, -check.

Usage:
  python -m gatb_core_tpu.tools.dbgh5 -in reads.fa -kmer-size 31 \
      -abundance-min 3 -out graph.h5 [-check expected.props]
"""

from __future__ import annotations

import argparse
import sys
import time

from ..debruijn.graph import Graph
from ..misc.properties import Properties


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dbgh5", description=__doc__, prefix_chars="-",
        formatter_class=argparse.RawDescriptionHelpFormatter)
    # single-dash long options like the reference CLI
    p.add_argument("-in", dest="input", required=True,
                   help="reads file (FASTA/FASTQ, .gz, comma list, album)")
    p.add_argument("-out", dest="out", default=None,
                   help="output graph: .h5 (HDF5), or any other path for "
                        "the file backend (<out>_gatb/)")
    p.add_argument("-kmer-size", dest="kmer_size", type=int, default=31)
    p.add_argument("-abundance-min", dest="abundance_min", default="2")
    p.add_argument("-abundance-max", dest="abundance_max", type=int,
                   default=2**31 - 1)
    p.add_argument("-minimizer-size", dest="minimizer_size", type=int,
                   default=10)
    p.add_argument("-histo-max", dest="histo_max", type=int, default=10000)
    p.add_argument("-check", dest="check", default=None,
                   help="compare info against a reference .props file")
    p.add_argument("-check-dump", dest="check_dump", default=None,
                   help="write info in .props format to this file")
    p.add_argument("-kff", dest="kff", action="store_true",
                   help="also output kmers in kff format")
    p.add_argument("-solidity-kind", dest="solidity_kind", default="sum",
                   choices=["sum", "min", "max", "one", "all", "custom"])
    # postsolid stage kinds (reference flag names STR_BLOOM_KIND /
    # STR_DEBLOOM_KIND / STR_MPHF_TYPE; defaults = reference defaults)
    p.add_argument("-bloom", dest="bloom", default="neighbor",
                   choices=["none", "basic", "cache", "neighbor"])
    p.add_argument("-debloom", dest="debloom", default="cascading",
                   choices=["none", "original", "cascading"])
    p.add_argument("-debloom-impl", dest="debloom_impl", default="minimizer",
                   choices=["basic", "minimizer"],
                   help="accepted for reference compat (both impls "
                        "produce the same cFP set here)")
    p.add_argument("-mphf", dest="mphf", default="boophf",
                   choices=["none", "boophf", "emphf"])
    p.add_argument("-branching-nodes", dest="branching", default="stored",
                   choices=["none", "stored"])
    p.add_argument("-verbose", dest="verbose", type=int, default=1)
    # execution-plan flags (ConfigurationAlgorithm inputs,
    # SortingCountAlgorithm.cpp:216-217): -max-memory/-max-disk size the
    # DSK pass loop; -nb-passes forces it directly
    p.add_argument("-max-memory", dest="max_memory", type=int, default=5000,
                   help="max memory in MB for the counting plan")
    p.add_argument("-max-disk", dest="max_disk", type=int, default=0,
                   help="max working volume in MB (0 = auto)")
    p.add_argument("-nb-passes", dest="nb_passes", type=int, default=0,
                   help="force the DSK pass count (0 = from the plan)")
    p.add_argument("-nb-cores", dest="nb_cores", type=int, default=0,
                   help="accepted for reference CLI compat (parallelism "
                        "is the device mesh here)")
    p.add_argument("-email", dest="email", default=None,
                   help="send statistics to the given email address "
                        "(tools/dbgh5.cpp:98-128: pipes the props dump "
                        "through the system `mail` command)")
    p.add_argument("-email-fmt", dest="email_fmt", default="raw",
                   choices=["raw", "xml"],
                   help="format of the statistics email")
    return p


def _send_email(args, props) -> None:
    """sendEmail (tools/dbgh5.cpp:98-128): raw/xml props dump piped to
    the system `mail` command; failures are non-fatal (the reference
    ::system call ignores them too)."""
    import subprocess

    body = props.dump_raw() if args.email_fmt == "raw" else props.dump_xml()
    base = args.input.split(",")[0].rsplit("/", 1)[-1]
    try:
        subprocess.run(["mail", "-s", f"[dbgh5] {base}", args.email],
                       input=body.encode(), timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired) as exc:
        print(f"warning: could not send email: {exc}", file=sys.stderr)


def _plan_nb_passes(args) -> int:
    """Pass-count policy. The reference derives passes from DISK volume
    (ConfigurationAlgorithm.cpp:350) because its passes bound spill
    files; our passes bound HBM-resident distinct tables and every pass
    re-sorts the full window set, so fewer passes are strictly cheaper
    while the tables fit. Default is therefore OPTIMISTIC 1-pass —
    SortingCount.execute transparently re-plans with doubled passes if
    the tables blow the budget mid-run (counting._RePlan). ``-nb-passes``
    still forces the loop (the conformance/stress scenarios use it);
    ``compute_plan`` keeps the reference disk formula for artifact
    parity (and the repartitor's partition count)."""
    if args.nb_passes:
        return args.nb_passes
    return 1


def main(argv=None) -> int:
    from ..system.compile_cache import enable_compile_cache

    enable_compile_cache()
    args = build_parser().parse_args(argv)
    amin = args.abundance_min if args.abundance_min == "auto" \
        else int(args.abundance_min)
    # default output: <input base>.h5, or the numpy-only file backend
    # (<input base>_gatb/) when h5py is not installed
    from ..storage.hdf5 import HAVE_H5PY

    out = args.out or (args.input.split(",")[0].rsplit(".", 1)[0]
                       + (".h5" if HAVE_H5PY else ""))

    # execution plan (ConfigurationAlgorithm, Graph.cpp:366): -max-memory /
    # -max-disk / -nb-passes are contracts — they size the DSK pass loop
    # and the per-dispatch superbatch, exactly like the reference's
    # fillSolidKmers memory guards (SortingCountAlgorithm.cpp:1500-1540)
    nb_passes = _plan_nb_passes(args)
    # bound live extraction rows by the memory budget: a sorted superbatch
    # costs ~16*W B/row (limb planes + sort temporaries). The cap is
    # 1<<25 for every span: a larger cap halves the dispatch count but
    # each fold then merges a 2^27-row window against an oversized
    # accumulator, and a W-scaled smaller cap for k=63 doubles the
    # dispatch and compile count. The value was tuned on an earlier
    # accelerator and is not yet measured on the H100.
    w_limbs = (2 * args.kmer_size + 31) // 32
    superbatch_rows = min(1 << 25,
                          max(1 << 16,
                              args.max_memory * (1 << 20)
                              // (16 * w_limbs)))
    # size the batch row length from the bank's sampled max read length
    # (r4): a short-read bank padded to the default 256 columns wastes
    # ~40% of the sort rows on invalid padding WINDOWS (rows = L-k+1 per
    # read incl. padding) and ~40% of the packed upload; longer reads
    # still split with k-1 overlap, so any L >= 2k is window-exact
    batch_len = 256
    try:
        from ..bank.fasta import open_bank as _ob

        _, _, mx = _ob(args.input).estimate()
        if mx:
            batch_len = max(2 * args.kmer_size,
                            min(256, ((mx + 31) // 32) * 32))
    except (ValueError, OSError):
        pass

    t0 = time.time()
    graph = Graph.create(
        bank=args.input, kmer_size=args.kmer_size, abundance_min=amin,
        abundance_max=args.abundance_max,
        minimizer_size=args.minimizer_size, output=out,
        histo_max=args.histo_max, nb_passes=nb_passes,
        superbatch_rows=superbatch_rows, batch_len=batch_len,
        table_budget_bytes=max(args.max_memory, 64) << 20,
        bloom_kind=args.bloom, debloom_kind=args.debloom,
        mphf_kind=args.mphf,
        build_branching=args.branching != "none")
    elapsed = time.time() - t0

    if args.kff:
        from ..storage.kff import write_kff

        kff_path = args.input.split(",")[0].rsplit("/", 1)[-1] + ".kff"
        write_kff(kff_path, graph.solid_limbs, graph.solid_counts,
                  args.kmer_size)

    props = Properties()
    props.add(0, "dbgh5")
    props.update(graph.get_info(), depth=1)
    props.add(1, "exec_time", f"{elapsed:.3f}")
    props.add(1, "output", out)
    if args.verbose:
        print(props.dump_raw())

    if args.email:
        _send_email(args, props)

    if args.check_dump:
        with open(args.check_dump, "w") as f:
            for k, v in props.as_flat_dict().items():
                f.write(f"{k} {v}\n")

    if args.check:
        expected = Properties.load_props_file(args.check)
        # only compare the reproducible keys (reference does a key subset too)
        keys = {"kmer_size", "kmers_nb_distinct", "kmers_nb_solid",
                "kmers_nb_weak", "kmers_nb_valid", "kmers_nb_invalid",
                "nb_branching", "checksum_branching", "abundance_min",
                "abundance_max"}
        expected = {k: v for k, v in expected.items() if k in keys}
        errors = props.check_against(expected)
        if errors:
            print("CHECK FAILED:", file=sys.stderr)
            for e in errors:
                print("  " + e, file=sys.stderr)
            return 1
        print(f"CHECK OK ({len(expected)} keys)")
    if graph.storage is not None:
        graph.storage.close()
    return 0


from ..misc.algorithm import Tool


class Dbgh5Tool(Tool):
    """dbgh5 on the Tool contract (Tool.hpp:79-251): build_parser() ->
    run via execute() -> props dump. The module-level main() remains the
    plain entry the tests/CLI use; this class makes the graph-build tool
    a first-class `misc.algorithm.Tool` like the reference's."""

    def __init__(self):
        super().__init__("dbgh5")

    def build_parser(self):
        return build_parser()

    def execute(self, argv=None) -> int:
        rc = main(argv)
        self.info["rc"] = rc
        return rc

    def main(self, argv=None) -> int:
        return self.run(argv)


if __name__ == "__main__":
    sys.exit(main())
