"""Device PE probe parity: the fused PE run with device-fed lookups
(mapping/pe_device.py -> krun_map_pe_batch voffs) is byte-identical to
the host-lookup fused run, on the seeded gene panel."""

import numpy as np
import pytest

from kma_tpu.io.seq import parse_fasta

from tests.conftest import run_pair


@pytest.fixture(scope="module")
def db50_index(panel):
    return panel["db"]


@pytest.fixture(scope="module")
def pe_reads(tmp_path_factory, panel):
    rng = np.random.default_rng(13)
    recs = [r for r in parse_fasta(panel["fasta"]) if len(r[1]) > 260]
    comp = np.array([3, 2, 1, 0, 4, 5], dtype=np.uint8)
    d = tmp_path_factory.mktemp("pedev")
    f1 = open(d / "r1.fq", "w")
    f2 = open(d / "r2.fq", "w")
    RL, INS = 100, 205
    for i in range(200):
        _h, codes = recs[rng.integers(len(recs))]
        s = int(rng.integers(0, len(codes) - INS))
        frag = codes[s:s + INS]
        r1 = frag[:RL].copy()
        r2 = comp[frag[-RL:][::-1]].copy()
        for r in (r1, r2):
            ne = rng.binomial(RL, 0.01)
            pos = rng.integers(0, RL, ne)
            r[pos] = (r[pos] + rng.integers(1, 4, ne)) % 4
        if i % 9 == 0:
            r1[int(rng.integers(0, RL))] = 4
        f1.write("@p%d/1\n%s\n+\n%s\n"
                 % (i, "".join("ACGTN"[c] for c in r1), "I" * RL))
        f2.write("@p%d/2\n%s\n+\n%s\n"
                 % (i, "".join("ACGTN"[c] for c in r2), "I" * RL))
    f1.close()
    f2.close()
    return str(d / "r1.fq"), str(d / "r2.fq")


@pytest.mark.parametrize("apm", ["p", "u"])
def test_pe_device_probe_parity(tmp_path, pe_reads, db50_index, apm):
    # -device on engages the PE probe path; the CPU backend runs the
    # same lookup kernel
    r1, r2 = pe_reads
    run_pair(tmp_path, ["-ipe", r1, r2, "-t_db", db50_index, "-apm", apm,
                        "-t", "1"])


def test_pe_device_lookup_parity(db50_index):
    """voff[p] matches the host ok[p] && lookup_voff for every window on
    both strands (positive control: template-derived reads hit)."""
    import numpy as np
    from kma_tpu.index.format import load_index, seq_offsets
    from kma_tpu.io.seq import rc_codes, unpack_2bit
    from kma_tpu.mapping.chain_scan import lookup_voff
    from kma_tpu.mapping.pe_device import make_pe_lookup

    idx = load_index(db50_index)
    dev = make_pe_lookup(idx, block=8)
    assert dev is not None
    k = idx.kmersize
    lens = idx.template_lengths
    offs = seq_offsets(lens)
    reads = []
    with open(db50_index + ".seq.b", "rb") as f:
        for t in (1, 3, 7):
            f.seek(int(offs[t]))
            w = np.fromfile(f, "<u8", (int(lens[t]) >> 5) + 1)
            codes = unpack_2bit(w, int(lens[t]))[:120].copy()
            if t == 3:
                codes[10] = 4  # an N window on the path
            reads.append(codes)
    flat = np.concatenate(reads)
    off = np.zeros(len(reads) + 1, np.int64)
    off[1:] = np.cumsum([len(r) for r in reads])
    vf, vr, _stride = dev.voffs(flat, off)
    assert int((vf >= 0).sum()) > 0
    for i, codes in enumerate(reads):
        for strand, v in ((codes, vf), (rc_codes(codes), vr)):
            W = len(strand) - k + 1
            for p in range(W):
                if (strand[p:p + k] > 3).any():
                    assert int(v[i, p]) == -1
                    continue
                key = 0
                for c in strand[p:p + k]:
                    key = (key << 2) | int(c)
                exp = lookup_voff(idx, key)
                exp = exp if (exp is not None and exp >= 0) else -1
                assert int(v[i, p]) == exp, (i, p)
