"""Run configuration: penalties, scoring matrix and pipeline options.

The reference wires behaviour through ~40 global function pointers mutated at
flag-parse time (kma.c:217-1248).  Here the same choices are explicit fields
of one config object consumed by the pipeline.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Penalties:
    """Alignment rewards/penalties (reference penalties.h, defaults kma.c:328-337)."""

    M: int = 1        # match
    MM: int = -2      # mismatch (recomputed as avg(Ts,Tv) rounded down, kma.c:1308)
    U: int = -1       # gap extension
    W1: int = -3      # gap open
    Wl: int = -6      # local/chain opening penalty
    Mn: int = 0       # N-match
    PE: int = 7       # pair reward
    Ts: int = -2      # transition
    Tv: int = -2      # transversion

    def score_matrix(self) -> np.ndarray:
        """5x5 nucleotide score matrix `d` (kma.c:1307-1328).

        Rows/cols are 2-bit codes A=0 C=1 G=2 T=3 N=4; transitions are
        A<->G and C<->T (d[i][(i-2)<0 ? i+2 : i-2] = Ts).
        """
        # MM is the average of Ts and Tv rounded down (kma.c:1308); C99
        # division truncates toward zero, mirror that exactly.
        self.MM = int_div_c(self.Ts + self.Tv - 1, 2)
        d = np.empty((5, 5), dtype=np.int32)
        for i in range(4):
            d[i, :4] = self.Tv
            d[i, 4] = self.Mn
            d[i, (i + 2) if (i - 2) < 0 else (i - 2)] = self.Ts
            d[i, i] = self.M
        d[4, :] = self.Mn
        d[4, 4] = 0
        return d


def int_div_c(a: int, b: int) -> int:
    """C99 integer division (truncates toward zero, unlike Python's floor)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


@dataclasses.dataclass
class MapConfig:
    """Options of a `kma` mapping run (defaults kma.c:281-348)."""

    # query/trim (step 1)
    min_phred: int = 20
    hardmask_q: int = 0      # -hq
    min_q: int = 0           # -mq1/-mi trimming quality
    five_clip: int = 0
    three_clip: int = 0
    min_len: int = 16
    max_len: int = 2147483647

    # mapping (step 2)
    one2one: bool = False    # -1t1 -> save_kmers scanner (kma.c:686-688)
    hmm: bool = False        # -hmm -> save_kmers_HMM scanner (kma.c:691-693)
    ck: bool = False         # -ck -> save_kmers_count scanner
    exhaustive: bool = False  # -ex_mode
    pair_mode: str = "u"     # -pm/-apm: u(nion)/p(enalty)/f(orce), step 2
    fpm: str = "u"           # -fpm/-apm: step-3 PE alignment combiner
    deCon: bool = False
    min_frac: float = 1.0    # -proxi (negative = soft)
    lc: bool = False         # -lc score-length anker selection + ConClave
    preset: int = 0          # preset bits: 4 -ont, 8 -ill, 16 -asm
    sparse: bool = False     # -Sparse (sparse.c pipeline)
    ss: str = "q"            # -ss sparse sort key: q(uery)/c(over)/d(epth)

    # alignment (step 3)
    kmersize: int = 0        # 0 -> from DB (.length.b[0], runkma.c:162-164)
    mq: int = 0              # min mapping quality
    score_t: float = 0.5     # -mrs minimum relative alignment score
    mrc: float = 0.0         # -mrc minimum read coverage
    cover_t: float = 0.1     # -mct chain coverage threshold
    ts: int = 0              # -ts seed trim
    circular: bool = False   # -ca
    mem_mode: bool = False
    skip_tail_aln: bool = False  # -ssa

    # ConClave / significance
    conclave: int = 1
    evalue: float = 0.05
    support: float = 0.0        # the `support` VARIABLE (vcf.c FT gates)
    support_static: float = 0.0  # significantAndSupport's static threshold
    max_frag: int = 1000000
    cmp_mode: str = "or"     # -and/-oa -> cmp combinator (stdstat.c:25-35)

    # consensus
    bcd: int = 1             # min depth to call a base
    base_caller: str = "default"  # default|org|ref|nano (assembly.c:162-271)
    significant: str = "mcnemar"  # mcnemar|and90|support (assembly.c:143-160)
    ref_fsa: int = 0
    dense: bool = False
    sasm: bool = False

    # outputs
    ID_t: float = 1.0
    Depth_t: float = 0.0
    nc: int = 0              # 1: no consensus, 2|nc: no aln
    nf: bool = False         # no frag file
    print_matrix: bool = False
    print_all: bool = False
    ef: bool = False
    sam: int = 0
    vcf: int = 0
    xml: int = 0
    tsv: int = 0
    qc_report: int = 0       # -qc count (2nd raises verbosity, kma.c:653)

    # resources
    threads: int = 1
    verbose: int = 0
    boot: bool = False   # -boot: 1024/512 sub-sequence bootstrap (runinput.c:732)
    shm: int = 0         # -shm: prefer tmpfs DB copies (shm.c analog)
    tmp_dir: str = ""    # -tmp: spool/tmp file directory (tmp.c tmpF)
    status: bool = False  # -status: forked-pipe timing lines (kma.c:1056)
    step1: bool = False  # -s1: emit the step-1 wire to stdout (kma.c:1439)
    step2: bool = False  # -s2: stdin step-1 wire -> anker wire on stdout
    mmap: bool = False   # -mmap: demand-page .comp.b (kmmap.c:33)
    # device mapping path: "auto" uses the device scanner on a GPU backend
    # for large inputs; "on" always uses it and fails rather than fall
    # back (tests use this on the CPU backend); "off" disables it.
    device: str = "auto"

    penalties: Penalties = dataclasses.field(default_factory=Penalties)
