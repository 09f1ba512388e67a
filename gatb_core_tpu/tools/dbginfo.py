"""dbginfo-equivalent CLI: dump info from an existing graph .h5 file
(reference tools/dbginfo.cpp).

Usage: python -m gatb_core_tpu.tools.dbginfo -in graph.h5
"""

from __future__ import annotations

import argparse
import sys

from ..storage import hdf5 as storage_mod
from ..storage.filedir import open_storage


STATE_NAMES = [
    ("CONFIGURATION_DONE", storage_mod.STATE_CONFIGURATION_DONE),
    ("SORTING_COUNT_DONE", storage_mod.STATE_SORTING_COUNT_DONE),
    ("BLOOM_DONE", storage_mod.STATE_BLOOM_DONE),
    ("DEBLOOM_DONE", storage_mod.STATE_DEBLOOM_DONE),
    ("BRANCHING_DONE", storage_mod.STATE_BRANCHING_DONE),
    ("MPHF_DONE", storage_mod.STATE_MPHF_DONE),
    ("ADJACENCY_DONE", storage_mod.STATE_ADJACENCY_DONE),
]


def main(argv=None) -> int:
    from ..system.compile_cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(prog="dbginfo")
    p.add_argument("-in", dest="input", required=True, help="graph .h5 file")
    args = p.parse_args(argv)

    with open_storage(args.input, "r") as st:
        print(f"graph        : {args.input}")
        from ..storage.hdf5 import prop_str
        print(f"kmer_size    : {prop_str(st, 'kmer_size')}")
        print(f"nb_solid_kmers : {prop_str(st, 'nb_solid_kmers')}")
        state = st.get_state()
        done = [name for name, bit in STATE_NAMES if state & bit]
        print(f"state        : 0x{state:x} [{' '.join(done)}]")
        if "dsk" in st:
            g = st.group("dsk")
            print(f"dsk/nb_items : {prop_str(g, 'nb_items', 'n/a')}")
        if "histogram" in st:
            cutoff = st.group("histogram").get_dataset("cutoff")
            if cutoff is not None:
                print(f"cutoff       : {int(cutoff[0])}")
        if "branching" in st:
            g = st.group("branching")
            print(f"nb_branching : {prop_str(g, 'nb_branching')}")
            print(f"checksum_branching : {prop_str(g, 'checksum_branching')}")
        if "configuration" in st:
            xml = prop_str(st.group("configuration"), "xml")
            if xml:
                print("configuration:")
                for line in str(xml).splitlines():
                    print("   " + line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
