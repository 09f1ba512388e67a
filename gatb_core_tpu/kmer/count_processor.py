"""CountProcessor plugin chain: the SortingCount extension point.

Reference: ICountProcessor (kmer/api/ICountProcessor.hpp:92-200) and its
implementations (CountProcessorHistogram / CountProcessorSolidity* /
CountProcessorDump / CountProcessorChain, kmer/impl/CountProcessor*.hpp).
There, a prototype processor is cloned per thread, each clone receives
one `process(partId, kmer, counts, sum)` call PER KMER of a partition,
and `finishClones` gathers clone state back into the prototype.

Device reshaping: per-kmer callbacks cannot feed a device pipeline,
so a "part" here is one DSK pass's merged distinct table — exactly like
a reference partition, every kmer of a part carries its COMPLETE count
(passes partition kmers by minimizer, SortingCountAlgorithm.cpp:806) —
and clones receive whole tables:

    process_table(part_id, kmers (N, W) uint32, counts (N, B) int32,
                  sums (N,) int64) -> keep mask (N,) bool | None

A chain applies each processor in order and ANDs the keep masks; rows
dropped by one stage are not shown to downstream stages (the reference's
per-kmer bool return). The prototype lifecycle (begin/end, beginPass/
endPass, clone/finishClones, beginPart/endPart) is preserved verbatim so
reference-style custom processors port directly (see
examples/count_processor_common_kmers.py, the kmer12 snippet port).
"""

from __future__ import annotations

import numpy as np

from .histogram import Histogram


class CountProcessor:
    """Base processor (CountProcessorAbstract, CountProcessorAbstract.hpp).

    All lifecycle methods default to no-ops; `clone` returns self (valid
    for stateless processors — stateful ones return a fresh instance and
    gather in finish_clones).
    """

    _name = ""

    # --- prototype-side -------------------------------------------------
    def begin(self, config) -> None:
        """Called before the main loop with the counting configuration."""

    def end(self) -> None:
        """Called after the main loop (all passes done)."""

    def begin_pass(self, pass_id: int) -> None:
        pass

    def end_pass(self, pass_id: int) -> None:
        pass

    def clone(self) -> "CountProcessor":
        return self

    def finish_clones(self, clones: list["CountProcessor"]) -> None:
        pass

    # --- clone-side -----------------------------------------------------
    def begin_part(self, pass_id: int, part_id: int, cache_size: int = 0,
                   name: str = "") -> None:
        pass

    def end_part(self, pass_id: int, part_id: int) -> None:
        pass

    def process_table(self, part_id: int, kmers: np.ndarray,
                      counts: np.ndarray, sums: np.ndarray):
        """Handle one kmer-complete table; return a keep mask or None."""
        return None

    # --- misc -----------------------------------------------------------
    def get_name(self) -> str:
        return self._name or type(self).__name__

    def set_name(self, name: str) -> None:
        self._name = name

    def get_properties(self) -> dict:
        return {}

    def get_instances(self) -> list["CountProcessor"]:
        return [self]

    def get(self, cls):
        """First instance of `cls` within this (possibly composite)
        processor — the reference's template get<T>()."""
        for inst in self.get_instances():
            if isinstance(inst, cls):
                return inst
        return None


class CountProcessorChain(CountProcessor):
    """Linked processors; a row survives while every stage keeps it
    (CountProcessorChain, ICountProcessor.hpp chain contract)."""

    def __init__(self, *items: CountProcessor):
        self.items = list(items)

    def begin(self, config):
        for it in self.items:
            it.begin(config)

    def end(self):
        for it in self.items:
            it.end()

    def begin_pass(self, pass_id):
        for it in self.items:
            it.begin_pass(pass_id)

    def end_pass(self, pass_id):
        for it in self.items:
            it.end_pass(pass_id)

    def clone(self):
        return CountProcessorChain(*[it.clone() for it in self.items])

    def finish_clones(self, clones):
        for i, it in enumerate(self.items):
            it.finish_clones([c.items[i] for c in clones
                              if isinstance(c, CountProcessorChain)])

    def begin_part(self, pass_id, part_id, cache_size=0, name=""):
        for it in self.items:
            it.begin_part(pass_id, part_id, cache_size, name)

    def end_part(self, pass_id, part_id):
        for it in self.items:
            it.end_part(pass_id, part_id)

    def process_table(self, part_id, kmers, counts, sums):
        # keep=None means "all rows": avoids re-materializing full copies
        # of the (N, W) table per chain item when nothing filtered yet
        # (r4: three 360 MB gathers per 30M-row sweep)
        keep = None
        for it in self.items:
            if keep is None:
                mask = it.process_table(part_id, kmers, counts, sums)
                if mask is not None:
                    mask = np.asarray(mask, bool)
                    if not mask.all():
                        keep = mask
            else:
                mask = it.process_table(part_id, kmers[keep], counts[keep],
                                        sums[keep])
                if mask is not None:
                    keep[np.flatnonzero(keep)] = np.asarray(mask, bool)
        return keep if keep is not None else np.ones(len(kmers), bool)

    def get_properties(self):
        props: dict = {}
        for it in self.items:
            props.update(it.get_properties())
        return props

    def get_instances(self):
        out: list[CountProcessor] = [self]
        for it in self.items:
            out.extend(it.get_instances())
        return out


class CountProcessorHistogram(CountProcessor):
    """Abundance histogram collector (CountProcessorHistogram.hpp).

    Gathers the distinct-kmer abundance distribution; with auto cutoff
    the threshold is computed at end() (misc/impl/Histogram.cpp
    compute_threshold port in kmer/histogram.py, bit-exact).
    """

    def __init__(self, histo_max: int = 10000, min_auto_threshold: int = 3):
        self.histogram = Histogram(histo_max)
        self.min_auto_threshold = min_auto_threshold

    def clone(self):
        return CountProcessorHistogram(self.histogram.max_value,
                                       self.min_auto_threshold)

    def finish_clones(self, clones):
        for c in clones:
            if isinstance(c, CountProcessorHistogram) \
                    and c is not self:
                self.histogram.merge(c.histogram)

    def process_table(self, part_id, kmers, counts, sums):
        if len(sums):
            self.histogram.add_counts(np.asarray(sums))
        return None

    def compute_threshold(self) -> int:
        return self.histogram.compute_threshold(self.min_auto_threshold)

    def get_properties(self):
        return {"histogram_entries": int(self.histogram.bins.sum())}


class CountProcessorSolidity(CountProcessor):
    """Solidity filter (CountProcessorSolidity.hpp:177-311 kinds).

    kind: sum/min/max/all/one/custom over per-bank counts; thresholds a
    (min, max) pair or per-bank list. `auto_histogram` (a
    CountProcessorHistogram) switches min to the auto cutoff, resolved
    lazily at the first masking call after histogram completion.
    """

    def __init__(self, kind: str = "sum", thresholds=(2, 2**31 - 1),
                 solid_vec=None, auto_histogram=None):
        self.kind = kind
        self.thresholds = thresholds
        self.solid_vec = solid_vec
        self.auto_histogram = auto_histogram
        self.cutoff: int | None = None
        self.nb_solid = 0

    def clone(self):
        c = CountProcessorSolidity(self.kind, self.thresholds,
                                   self.solid_vec, self.auto_histogram)
        c.cutoff = self.cutoff
        return c

    def finish_clones(self, clones):
        for c in clones:
            if isinstance(c, CountProcessorSolidity) and c is not self:
                self.nb_solid += c.nb_solid

    def resolve_cutoff(self) -> int:
        if self.cutoff is None:
            if self.auto_histogram is not None:
                self.cutoff = self.auto_histogram.compute_threshold()
            else:
                t = self.thresholds
                self.cutoff = int((t[0] if isinstance(t, tuple)
                                   else t[0][0]))
        return self.cutoff

    def process_table(self, part_id, kmers, counts, sums):
        from .counting import solidity_check

        lo = self.resolve_cutoff()
        t = self.thresholds
        hi = int(t[1]) if isinstance(t, tuple) else int(t[0][1])
        if isinstance(t, tuple) or len(t) == 1:
            thresholds = [(lo, hi)]
        else:
            thresholds = [(lo if i == 0 else pair[0], pair[1])
                          for i, pair in enumerate(t)]
        mask = solidity_check(np.asarray(counts), self.kind, thresholds,
                              self.solid_vec)
        self.nb_solid += int(mask.sum())
        return mask

    def get_properties(self):
        return {"solidity_kind": self.kind,
                "kmers_nb_solid_processor": self.nb_solid}


class CountProcessorCollect(CountProcessor):
    """Terminal collector: keeps every row it is shown, in memory
    (CountProcessorDump's role when the storage target is the caller —
    the driver persists the collected table to HDF5/KFF downstream)."""

    def __init__(self):
        self.kmers: list[np.ndarray] = []
        self.counts: list[np.ndarray] = []
        self.sums: list[np.ndarray] = []

    def clone(self):
        return CountProcessorCollect()

    def finish_clones(self, clones):
        for c in clones:
            if isinstance(c, CountProcessorCollect) and c is not self:
                self.kmers.extend(c.kmers)
                self.counts.extend(c.counts)
                self.sums.extend(c.sums)

    def process_table(self, part_id, kmers, counts, sums):
        self.kmers.append(np.asarray(kmers))
        self.counts.append(np.asarray(counts))
        self.sums.append(np.asarray(sums))
        return None

    def result(self, w: int):
        """(kmers (N, W), counts (N, B), sums (N,)) concatenated over
        parts, globally re-sorted by kmer value (parts are disjoint)."""
        if not self.kmers:
            return (np.zeros((0, w), np.uint32), np.zeros((0, 1), np.int32),
                    np.zeros((0,), np.int64))
        kk = np.concatenate(self.kmers)
        cc = np.concatenate(self.counts)
        ss = np.concatenate(self.sums)
        # blocks are each sorted; the concatenation is already globally
        # sorted iff every block boundary is ordered (true for the
        # streamed same-pass chunks — only multi-pass minimizer
        # interleaving needs the 30M-row lexsort, ~6 s at stress scale)
        if len(self.kmers) > 1 and not self._boundaries_sorted():
            order = np.lexsort(tuple(kk[:, j] for j in
                                     range(kk.shape[1] - 1, -1, -1)))
            kk, cc, ss = kk[order], cc[order], ss[order]
        return kk, cc, ss

    def _boundaries_sorted(self) -> bool:
        prev_last = None
        for blk in self.kmers:
            if len(blk) == 0:
                continue
            if prev_last is not None:
                first = blk[0]
                for a, b in zip(prev_last, first):  # big-endian limb lex
                    if a < b:
                        break
                    if a > b:
                        return False
            prev_last = blk[-1]
        return True
