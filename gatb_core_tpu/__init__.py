"""gatb_core_tpu — a JAX k-mer / de Bruijn graph engine.

A from-scratch JAX/XLA framework with the capabilities of
GATB-core (k-mer counting, Bloom/MPHF membership structures, de Bruijn
graphs, unitig compaction, graph simplification, assembly traversal,
sequence banks, HDF5 storage), designed for accelerators: SPMD sharding over
device meshes, sort/segment-reduce counting kernels, all-to-all minimizer
exchange, pointer-doubling unitig compaction.

Public API highlights:

    from gatb_core_tpu import Graph, count_kmers, open_bank
    graph = Graph.create("reads.fastq.gz", kmer_size=31, abundance_min=3)
    ug = graph.unitig_graph()
    contigs = assemble_contigs(graph)
"""

from .bank.fasta import (  # noqa: F401
    open_bank, BankFasta, BankStrings, BankAlbum, BankComposite,
    BankSplitter, BankFastaWriter, Sequence,
)
from .kmer.counting import (  # noqa: F401
    CountConfig, CountResult, SortingCount, count_kmers,
    count_kmers_multibank, solidity_check,
)
from .kmer.histogram import Histogram  # noqa: F401
from .debruijn.graph import Graph  # noqa: F401
from .debruijn.traversal import assemble_contigs  # noqa: F401
from .collections.bloom import build_bloom, BloomFilter  # noqa: F401
from .storage.hdf5 import Storage  # noqa: F401

__version__ = "0.1.0"
