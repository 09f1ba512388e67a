"""Mesh-sharded postsolid/unitig kernels vs single-device (VERDICT r3
Missing #2): equality on an 8-device CPU mesh for adjacency, debloom cFP,
unitig candidate ranks, list-ranking, and the full Graph build."""

import numpy as np
import jax.numpy as jnp
import pytest

from gatb_core_tpu.bank.fasta import BankStrings
from gatb_core_tpu.kmer.counting import count_kmers
from gatb_core_tpu.parallel.mesh import make_mesh
from gatb_core_tpu.parallel import postsolid as pp


def _solid(seed=11, k=21, n_reads=400, glen=3000):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=glen))
    reads = [genome[s:s + 120]
             for s in rng.integers(0, glen - 120, size=n_reads)]
    res = count_kmers(BankStrings(*reads), kmer_size=k, abundance_min=2)
    return res.solid_kmers, res.solid_counts, reads


@pytest.fixture(scope="module")
def fixture():
    limbs, counts, reads = _solid()
    return limbs, counts, reads, make_mesh(8)


def test_distributed_adjacency_equal(fixture):
    from gatb_core_tpu.debruijn.graph import _adjacency_kernel

    limbs, _, _, mesh = fixture
    k, n = 21, len(limbs)
    tab = jnp.asarray(limbs)
    want = np.asarray(_adjacency_kernel(tab, tab, k, n))
    got = pp.distributed_adjacency(mesh, limbs, k)
    assert got.shape == want.shape and (got == want).all()


def test_distributed_adjacency_overflow_retry(fixture):
    """A send window too small for the routing skew must retry, not drop."""
    from gatb_core_tpu.debruijn.graph import _adjacency_kernel

    limbs, _, _, mesh = fixture
    k, n = 21, len(limbs)
    tab = jnp.asarray(limbs)
    want = np.asarray(_adjacency_kernel(tab, tab, k, n))
    got = pp.distributed_adjacency(mesh, limbs, k, capacity_factor=0.02)
    assert (got == want).all()


def test_distributed_debloom_equal(fixture):
    from gatb_core_tpu.kmer.debloom import build_debloom

    limbs, _, _, mesh = fixture
    k = 21
    deb = build_debloom(limbs, k, cascading=False)
    cfp_d = pp.distributed_debloom_probe(mesh, limbs, k, deb.bloom)
    assert cfp_d.shape == deb.cfp.shape and (cfp_d == deb.cfp).all()
    # the mesh kwarg path through build_debloom
    deb_m = build_debloom(limbs, k, cascading=False, mesh=mesh)
    assert (deb_m.cfp == deb.cfp).all()


def test_distributed_cand_ranks_equal(fixture):
    from gatb_core_tpu.debruijn.unitigs import _cand_kernel

    limbs, _, _, mesh = fixture
    k, n = 21, len(limbs)
    tab = jnp.asarray(limbs)
    r_want, f_want = _cand_kernel(k, n, n)(tab, tab)
    r_got, f_got = pp.distributed_cand_ranks(mesh, limbs, k)
    assert (r_got == np.asarray(r_want)).all()
    assert (f_got == np.asarray(f_want)).all()


def test_distributed_list_ranking_equal(fixture):
    from gatb_core_tpu.debruijn.unitigs import _pointer_double, _cut_cycles

    limbs, _, _, mesh = fixture
    rng = np.random.default_rng(5)
    m = 2 * len(limbs)
    par = np.arange(m)
    perm = rng.permutation(m)
    for i in range(0, m - 1, 3):      # random chains + the odd cycle
        par[perm[i]] = perm[i + 1]
    p1, c1 = _cut_cycles(par.copy())
    p2, c2 = pp.distributed_cut_cycles(mesh, par.copy())
    assert (p1 == p2).all() and (c1 == c2).all()
    r1, k1 = _pointer_double(p1)
    r2, k2 = pp.distributed_pointer_double(mesh, p2)
    assert (r1 == r2).all() and (k1 == k2).all()


def test_full_graph_build_on_mesh(fixture):
    """Graph.create(mesh=...) must produce the same graph artifacts as the
    single-device build: adjacency, branching checksum, cFP, unitig set
    with identical km:f: annotations."""
    from gatb_core_tpu.debruijn.graph import Graph

    _, _, reads, mesh = fixture
    kw = dict(kmer_size=21, abundance_min=2, batch_reads=64,
              batch_len=256, build_branching=True)
    g1 = Graph.create(BankStrings(*reads), **kw)
    g2 = Graph.create(BankStrings(*reads), mesh=mesh, **kw)
    assert (g1.solid_limbs == g2.solid_limbs).all()
    assert (g1.precompute_adjacency() == g2.precompute_adjacency()).all()
    assert g1.checksum_branching() == g2.checksum_branching()
    assert (g1._debloom.cfp == g2._debloom.cfp).all()
    ug1, ug2 = g1.unitig_graph(), g2.unitig_graph()
    s1 = sorted(zip(list(ug1.sequences), ug1.mean_abundance.tolist()))
    s2 = sorted(zip(list(ug2.sequences), ug2.mean_abundance.tolist()))
    assert s1 == s2
    # simplify through the mesh path agrees too
    g1.simplify()
    g2.simplify()
    assert (g1.node_state == g2.node_state).all()


def test_2d_mesh_counting_equals_single_device():
    """(host, chip) mesh: exchange over the intra-host chip axis,
    pass-end cross-host merge over the inter-host axis
    (parallel/superbatch.make_host_merge) — equal to the single-device
    count on a 2x4 mesh, multi-pass."""
    from gatb_core_tpu.bank.fasta import BankStrings
    from gatb_core_tpu.kmer.counting import count_kmers
    from gatb_core_tpu.kmer.model import count_kmers_py
    from gatb_core_tpu.parallel.mesh import make_mesh2d
    from gatb_core_tpu.parallel.superbatch import \
        count_kmers_distributed_superbatch
    from gatb_core_tpu.ops.kmer_ops import kmers_to_py

    rng = np.random.default_rng(23)
    genome = "".join(rng.choice(list("ACGT"), size=1500))
    reads = [genome[s:s + 90] for s in rng.integers(0, 1400, size=160)]
    reads.append("ACGTN" * 18)
    mesh = make_mesh2d(2, 4)
    res = count_kmers_distributed_superbatch(
        BankStrings(*reads), mesh, kmer_size=21, abundance_min=1,
        nb_passes=2, batch_reads_per_device=8, capacity_factor=0.75)
    exp = count_kmers_py(reads, 21, abundance_min=1)
    got = dict(zip(kmers_to_py(res.solid_kmers), res.solid_counts.tolist()))
    assert got == exp, (len(got), len(exp))
