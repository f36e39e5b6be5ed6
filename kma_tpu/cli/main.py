"""`kma`-compatible command line interface (reference main.c / kma.c).

Subcommands: (default = map), index, more to come (shm, seq2fasta, dist,
db, merge, cmp, update, trim).
"""

from __future__ import annotations

import sys
from typing import List

from ..config import MapConfig, Penalties


def main(argv: List[str] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "index":
        return index_main(argv[1:])
    if argv and argv[0] in ("seq2fasta", "db", "dist", "merge", "cmp",
                            "shm", "update", "trim"):
        from . import tools
        return tools.dispatch(argv[0], argv[1:])
    if argv and argv[0] == "devserve":
        # persistent device session daemon (the -shm analog)
        from ..devserve import devserve_main
        return devserve_main(argv[1:])
    from ..pipeline import DeviceError
    try:
        return map_main(argv)
    except DeviceError as err:
        print("kma: %s" % err, file=sys.stderr)
        return 1


def index_main(argv: List[str]) -> int:
    """kma index (index.c:78-735), standard, -Sparse, -deCon, -batch and
    -t_db (incremental append) paths."""
    from ..index.build import (build_decon, build_index, build_index_sparse,
                               load_for_append)
    inputs: List[str] = []
    decon_files: List[str] = []
    out = None
    t_db = None
    k = 16
    minlen = 0
    mega = False
    sparse_prefix = None
    m_len = 0
    hc = False
    hq = 1.0
    ht = 1.0
    and_comb = False
    orf = 0
    k_i = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-i":
            i += 1
            while i < len(argv) and not argv[i].startswith("-"):
                inputs.append(argv[i])
                i += 1
            continue
        if a == "-batch":
            # file-of-files input (index.c:351-400): one path per line
            i += 1
            with open(argv[i]) as bf:
                for line in bf:
                    line = line.strip()
                    if line:
                        inputs.append(line)
            i += 1
            continue
        if a == "-t_db":
            i += 1
            t_db = argv[i]
            i += 1
            continue
        if a == "-batchD":
            # file-of-files deCon input (index.c:401-450)
            i += 1
            with open(argv[i]) as bf:
                for line in bf:
                    line = line.strip()
                    if line:
                        decon_files.append(line)
            i += 1
            continue
        if a == "-CS":  # initial hash size hint (index.c:293-310): the
            i += 2      # frozen output is size-independent here
            continue
        if a == "-NI":  # legacy .index.b skip; a no-op upstream too
            i += 1      # (index.c:477)
            continue
        if a == "-nbp":  # suppress bias prints (index.c:479-480)
            i += 1
            continue
        if a == "-v":
            print("KMA_index-1.5.1")
            return 0
        if a == "-deCon":
            i += 1
            while i < len(argv) and not argv[i].startswith("-"):
                decon_files.append(argv[i])
                i += 1
            if not decon_files:
                print("No deCon file specified.", file=sys.stderr)
                return 1
            continue
        if a == "-o":
            i += 1
            out = argv[i]
        elif a == "-k":
            i += 1
            k = int(argv[i])
        elif a == "-ml" or a == "-ML":
            i += 1
            minlen = int(argv[i])
        elif a == "-ME":
            mega = True
        elif a == "-m":
            i += 1
            m_len = min(int(argv[i]), 30)
        elif a == "-hc":
            hc = True
        elif a == "-hq":
            i += 1
            hq = float(argv[i])
            if hq < 0:
                print("Invalid -hq", file=sys.stderr)
                hq = 1.0
        elif a == "-ht":
            i += 1
            ht = float(argv[i])
            if ht < 0:
                print("Invalid -ht", file=sys.stderr)
                ht = 1.0
        elif a == "-and":
            and_comb = True
        elif a == "-c":
            orf = 1
        elif a == "-C":
            orf = 2
        elif a == "-k_t":
            i += 1
            k = max(1, min(int(argv[i]), 31))
        elif a == "-k_i":
            i += 1
            k_i = max(1, min(int(argv[i]), 31))
        elif a == "-Sparse":
            i += 1
            sparse_prefix = argv[i]
        else:
            print(f"# Invalid option:\t{a}", file=sys.stderr)
            return 1
        i += 1
    if not inputs or not out:
        print("Too few arguments handed", file=sys.stderr)
        return 1
    if t_db is not None:
        app = load_for_append(t_db)
        if app["sparse"]:
            build_index_sparse(inputs, out, sparse_prefix or "-",
                               minlen=minlen, hq=hq, ht=ht,
                               and_comb=and_comb, append=app)
        else:
            build_index(inputs, out, minlen=minlen, append=app)
        if decon_files:
            build_decon(out, decon_files)
        return 0
    if sparse_prefix is not None:
        build_index_sparse(inputs, out, sparse_prefix, kmersize=k,
                           minlen=minlen, mega=mega, hq=hq, ht=ht,
                           and_comb=and_comb)
    else:
        build_index(inputs, out, kmersize=k, minlen=minlen, mega=mega,
                    m_len=m_len, hc=hc, orf=orf, kmerindex=k_i)
    if decon_files:
        build_decon(out, decon_files)
    return 0


def _help_message() -> None:
    """Compact -h listing (helpMessage, kma.c:102-215)."""
    print("# KMA-1.5.1 maps and/or aligns raw reads to a template "
          "database (kma_tpu accelerator build).")
    print("# Options are:\t\tDesc:\t\t\t\tDefault:")
    for flag, desc, dflt in (
        ("-i", "Single end input", "STDIN"),
        ("-ipe", "Paired end input (two files)", ""),
        ("-int", "Interleaved input", ""),
        ("-o", "Output prefix", "REQUIRED"),
        ("-t_db", "Template DB", "REQUIRED"),
        ("-k", "k-mer size", "DB"),
        ("-ml", "Minimum alignment length", "16"),
        ("-p", "p-value", "0.05"),
        ("-ConClave", "ConClave version", "1"),
        ("-mem_mode", "Base ConClave on template mappings", "False"),
        ("-proxi", "Proximity scoring (negative for soft)", "False/1.0"),
        ("-ex_mode", "Search k-mers exhaustively", "False"),
        ("-ef", "Extended features (.mapstat)", "False"),
        ("-1t1", "One read to one template", "False"),
        ("-mrs", "Minimum relative alignment score", "0.50"),
        ("-mrc", "Minimum query coverage", "0.0"),
        ("-bcNano", "Altered indel calling for ONT data", "False"),
        ("-bcd", "Minimum depth to call bases", "1"),
        ("-ID", "Minimum identity to output", "1.0"),
        ("-md", "Minimum depth to output", "0.0"),
        ("-dense", "Skip insertions in assembly", "False"),
        ("-matrix", ".mat.gz output", "False"),
        ("-a", ".frag_raw.gz output", "False"),
        ("-mp", "Minimum phred score", "20"),
        ("-mi", "Minimum internal phred score", "0"),
        ("-eq", "Minimum avg. quality score", "0"),
        ("-t", "Threads", "1"),
        ("-sam", "SAM output to stdout", "False"),
        ("-vcf", "VCF output", "False"),
        ("-xml", "XML output", "False"),
        ("-tsv", "TSV output (see -tsvh)", "False"),
        ("-sasm", "Skip alignment", "False"),
        ("-device", "device step-2 scanner (on/off/auto)", "auto"),
        ("-shm", "Use shared DB", "False"),
        ("-mmap", "Memory-map the DB", "False"),
        ("-v", "Version", ""),
        ("-h", "Shows this help message", ""),
    ):
        print("# %16s\t%-32s\t%s" % (flag, desc, dflt))


def map_main(argv: List[str]) -> int:
    """kma mapping run (kma.c:217-1636)."""
    from ..pipeline import run_kma
    cfg = MapConfig()
    inputs: List[str] = []
    pe_inputs: List[str] = []
    int_inputs: List[str] = []
    out = None
    dbs: List[str] = []
    mt1 = 0
    splt_db = False
    mh = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-i":
            i += 1
            while i < len(argv) and (not argv[i].startswith("-")
                                     or argv[i] == "--"):
                inputs.append(argv[i])
                i += 1
            continue
        if a == "-ipe":
            i += 1
            while i < len(argv) and not argv[i].startswith("-"):
                pe_inputs.append(argv[i])
                i += 1
            if len(pe_inputs) % 2:
                print("Uneven number of paired end files.", file=sys.stderr)
                return 1
            continue
        if a == "-int":
            i += 1
            while i < len(argv) and not argv[i].startswith("-"):
                int_inputs.append(argv[i])
                i += 1
            continue
        if a == "-o":
            i += 1
            out = argv[i]
        elif a == "-t_db":
            # multiple values select the spltDB map/reduce flow
            # (kma.c:355-372,1617-1618)
            i += 1
            while i < len(argv) and not argv[i].startswith("-"):
                dbs.append(argv[i])
                i += 1
            continue
        elif a == "-spltDB":
            splt_db = True
        elif a == "-1t1":
            cfg.one2one = True
        elif a == "-hmm":
            cfg.hmm = True
            cfg.one2one = False
        elif a == "-device":
            # kma_tpu extension: auto|on|off device step-2 scanner
            i += 1
            if argv[i] not in ("auto", "on", "off"):
                print("# -device takes auto, on or off", file=sys.stderr)
                return 1
            cfg.device = argv[i]
        elif a == "-ck":
            cfg.ck = True
        elif a == "-ex_mode":
            cfg.exhaustive = True
        elif a == "-k":
            i += 1
            cfg.kmersize = int(argv[i])
        elif a == "-mp":
            i += 1
            cfg.min_phred = int(argv[i])
        elif a == "-mi":
            i += 1
            cfg.hardmask_q = int(argv[i])
        elif a == "-eq":
            i += 1
            cfg.min_q = int(argv[i])
        elif a == "-5p":
            i += 1
            cfg.five_clip = int(argv[i])
        elif a == "-3p":
            i += 1
            cfg.three_clip = int(argv[i])
        elif a == "-xl":
            i += 1
            cfg.max_len = int(argv[i])
        elif a == "-ml":
            i += 1
            cfg.min_len = int(argv[i])
        elif a == "-mrs":
            i += 1
            cfg.score_t = float(argv[i])
        elif a == "-mrc":
            i += 1
            cfg.mrc = float(argv[i])
        elif a == "-mq":
            i += 1
            cfg.mq = int(argv[i])
        elif a == "-bcd":
            i += 1
            cfg.bcd = int(argv[i])
        elif a == "-bc":
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                cfg.support = float(argv[i])
                cfg.support_static = cfg.support
                cfg.significant = "support"
        elif a == "-bc90":
            cfg.significant = "and90"
        elif a == "-bcg":
            cfg.base_caller = "org"
        elif a == "-bcNano":
            if cfg.significant == "mcnemar":
                cfg.significant = "and90"
            cfg.base_caller = "nano"
        elif a == "-ID":
            i += 1
            cfg.ID_t = float(argv[i])
        elif a == "-md":
            i += 1
            cfg.Depth_t = float(argv[i])
        elif a == "-dense":
            cfg.dense = True
        elif a == "-ref_fsa":
            cfg.ref_fsa = 1
        elif a == "-matrix":
            cfg.print_matrix = True
        elif a == "-a":
            cfg.print_all = True
        elif a == "-and":
            cfg.cmp_mode = "and"
        elif a == "-oa":
            cfg.cmp_mode = "true"
            cfg.ID_t = 0.0
            cfg.Depth_t = 0.0
        elif a == "-reward":
            i += 1
            cfg.penalties.M = abs(int(argv[i]))
        elif a == "-penalty":
            i += 1
            v = int(argv[i])
            cfg.penalties.MM = min(-v, v)
        elif a == "-gapopen":
            i += 1
            v = int(argv[i])
            cfg.penalties.W1 = min(-v, v)
        elif a == "-gapextend":
            i += 1
            v = int(argv[i])
            cfg.penalties.U = min(-v, v)
        elif a == "-localopen":
            i += 1
            v = int(argv[i])
            cfg.penalties.Wl = min(-v, v)
        elif a == "-Npenalty":
            i += 1
            v = int(argv[i])
            cfg.penalties.Mn = min(-v, v)
        elif a == "-per":
            i += 1
            cfg.penalties.PE = abs(int(argv[i]))
        elif a == "-transition":
            i += 1
            v = int(argv[i])
            cfg.penalties.Ts = min(-v, v)
        elif a == "-transversion":
            i += 1
            v = int(argv[i])
            cfg.penalties.Tv = min(-v, v)
        elif a == "-cge":
            # kma.c:1024-1030
            cfg.score_t = 0.5
            cfg.penalties.M = 1
            cfg.penalties.MM = -3
            cfg.penalties.W1 = -5
            cfg.penalties.U = -1
            cfg.penalties.PE = 17
        elif a == "-mint2":
            # kma.c:1069-1094: -1t1 -mem_mode -ca -cge(mrs .75) -mq 1
            # -ref_fsa 2 -dense -bcg -bcd 10 -bc 0.9 -vcf -ef
            cfg.one2one = True
            cfg.mem_mode = True
            cfg.circular = True
            cfg.score_t = 0.75
            cfg.penalties.M = 1
            cfg.penalties.MM = -3
            cfg.penalties.W1 = -5
            cfg.penalties.U = -1
            cfg.penalties.PE = 17
            cfg.mq = 1
            cfg.ref_fsa = 2
            cfg.dense = True
            cfg.base_caller = "org"
            cfg.bcd = 10
            cfg.significant = "support"
            cfg.support_static = 0.9  # mint2 leaves the support VAR at 0
            cfg.vcf = 1
            cfg.ef = True
        elif a == "-mint3":
            # kma.c:1095-1114
            cfg.one2one = True
            cfg.mem_mode = True
            cfg.circular = True
            cfg.mq = 1
            cfg.ref_fsa = 2
            cfg.dense = True
            cfg.base_caller = "nano"
            cfg.bcd = 10
            cfg.significant = "support"
            cfg.support_static = 0.7  # mint3 leaves the support VAR at 0
            cfg.vcf = 1
            cfg.ef = True
        elif a == "-proxi":
            # kma.c:702-724: +/-1.0 keeps the exact selectors but still
            # lands in the alignment-stage minFrac
            i += 1
            try:
                v = float(argv[i])
            except ValueError:
                print('Invalid argument at "-proxi".', file=sys.stderr)
                return 1
            if v < -1 or 1 < v:
                print('Invalid argument at "-proxi".', file=sys.stderr)
                return 1
            cfg.min_frac = v
        elif a == "-mct":
            i += 1
            cfg.cover_t = float(argv[i])
        elif a == "-lc":
            cfg.lc = True
        elif a == "-ont":
            # kma.c:1115-1158: -bcNano -bc 0.7 -mct 0.1 -bcd 10 -mrs 0.25
            # -mrc 0.7 -eq 10 -proxi -0.9 -lc -ts 2
            cfg.preset |= 4
            if cfg.significant == "mcnemar":
                cfg.significant = "and90"
            cfg.base_caller = "nano"
            cfg.significant = "support"
            cfg.support = 0.7
            cfg.support_static = 0.7
            cfg.cover_t = 0.1
            cfg.bcd = 10
            cfg.min_frac = -0.9
            cfg.score_t = 0.25
            cfg.mrc = 0.7
            cfg.min_q = 10
            cfg.lc = True
            cfg.ts = 2
        elif a == "-ill":
            # kma.c:1159-1202: -1t1 -mrc 0.1 -lc -proxi -0.98 -bc 0.9
            # -bcd 10
            cfg.preset |= 8
            cfg.one2one = True
            cfg.mrc = 0.1
            cfg.lc = True
            cfg.min_frac = -0.98
            cfg.significant = "support"
            cfg.support = 0.9
            cfg.support_static = 0.9
            cfg.bcd = 10
        elif a == "-asm":
            # kma.c:1203-1233: -bc 0.5 -p 0.5 -mct 0.1 -bcd 1 -mrs 0.25
            # -mrc 0.7 -proxi -0.9 -lc -ts 2; the non-mem alignment stage
            # is forced back to minFrac 1.0 (kma.c:1622)
            cfg.preset |= 16
            cfg.significant = "support"
            cfg.support = 0.5
            cfg.support_static = 0.5
            cfg.evalue = 0.5
            cfg.cover_t = 0.1
            cfg.bcd = 1
            cfg.min_frac = -0.9
            cfg.score_t = 0.25
            cfg.mrc = 0.7
            cfg.lc = True
            cfg.ts = 2
        elif a == "-ca":
            cfg.circular = True
        elif a == "-ts":
            i += 1
            cfg.ts = int(argv[i])
        elif a == "-ssa":
            cfg.skip_tail_aln = True
        elif a == "-nc":
            # kma.c:1018-1021: despite the help text, -nc sets bit 2
            # (which gates the .aln open) and -na sets bit 1; -na alone
            # changes nothing because the nc&2 branch re-opens .fsa
            # (runkma.c:244-256)
            cfg.nc |= 2
        elif a == "-na":
            cfg.nc |= 1
        elif a == "-nf":
            cfg.nf = True
        elif a == "-ef":
            cfg.ef = True
        elif a == "-sam":
            if i + 1 < len(argv) and argv[i + 1].isdigit():
                i += 1
                cfg.sam = int(argv[i])
            else:
                cfg.sam = 1
        elif a == "-vcf":
            if i + 1 < len(argv) and argv[i + 1].isdigit():
                i += 1
                cfg.vcf = int(argv[i])
            else:
                cfg.vcf = 1
        elif a == "-xml":
            if i + 1 < len(argv) and argv[i + 1].isdigit():
                i += 1
                cfg.xml = int(argv[i])
            else:
                cfg.xml = 1
        elif a == "-tsv":
            if i + 1 < len(argv) and argv[i + 1].isdigit():
                i += 1
                cfg.tsv = int(argv[i])
            else:
                cfg.tsv = 0xFFFFFFFFFFFFFFFF
        elif a == "-e" or a == "-p":
            i += 1
            cfg.evalue = float(argv[i])
        elif a == "-t":
            i += 1
            cfg.threads = int(argv[i])
        elif a == "-ConClave":
            i += 1
            cfg.conclave = int(argv[i])
        elif a == "-mf":
            i += 1
            cfg.max_frag = int(argv[i])
        elif a == "-verbose":
            # optional numeric level (kma.c:1058-1067)
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                try:
                    cfg.verbose = int(argv[i])
                except ValueError:
                    print('Invalid argument at "-verbose".', file=sys.stderr)
                    return 1
            else:
                cfg.verbose = 1
        elif a == "-boot":
            cfg.boot = True
        elif a == "-shm":
            # optional numeric level (kma.c:514-525)
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                cfg.shm = int(argv[i])
            else:
                cfg.shm = 1
        elif a == "-mmap" or a == "-swap":  # -swap is an alias (kma.c:526)
            cfg.mmap = True
        elif a == "-sasm":
            # skip assembly (assembly.c:1209 skip_assemble_KMA); the
            # reference also zeroes the identity gate (kma.c:664-666)
            cfg.sasm = True
            cfg.ID_t = 0.0
        elif a == "-tsvh":  # kma.c:975-995
            print("# Tsv flags, add to combine:\n#")
            for b, nm in ((1, "Template_Name"), (2, "Template_Length"),
                          (4, "Template_Identity"),
                          (8, "Template_Coverage"), (16, "Template_Depth"),
                          (32, "Query_Identity"), (64, "Query_Coverage"),
                          (128, "Query_Depth"), (256, "Read_Count_Map"),
                          (512, "Read_Count_Aln"), (1024, "Score"),
                          (2048, "Expected"), (4096, "q_value"),
                          (8192, "p_value"), (16384, "ConClave_Score"),
                          (32768, "ConClave_Quality")):
                print("# %-8s\t%s" % (b, nm))
            print("#")
            return 0
        elif a == "-v":  # kma.c:1234-1239
            print("KMA-1.5.1")
            print('Philip T.L.C. Clausen, Frank M. Aarestrup & Ole Lund, '
                  '"Rapid and precise alignment of raw reads against '
                  'redundant databases with KMA", BMC Bioinformatics, '
                  '2018;19:307.')
            return 0
        elif a == "-h":
            _help_message()
            return 0
        elif a == "-tmp":
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                cfg.tmp_dir = argv[i]
        elif a == "-status":
            cfg.status = True
        elif a == "-s1":
            cfg.step1 = True
        elif a == "-s2":
            cfg.step2 = True
        elif a == "-mh":
            # kma_tpu extension: multi-host run, "coordinator:port,N,pid"
            i += 1
            mh = argv[i]
        elif a == "-mem_mode":
            cfg.mem_mode = True
        elif a == "-pm":
            i += 1
            cfg.pair_mode = argv[i][0]
        elif a == "-fpm":
            i += 1
            cfg.fpm = argv[i][0]
        elif a == "-apm":
            i += 1
            cfg.pair_mode = argv[i][0]
            cfg.fpm = argv[i][0]
        elif a == "-qc":
            cfg.qc_report += 1
        elif a == "-Sparse":
            cfg.sparse = True
        elif a == "-deCon":
            cfg.deCon = True
        elif a == "-Mt1":
            i += 1
            mt1 = int(argv[i])
        elif a == "-ss":
            i += 1
            if argv[i] in ("q", "c", "d"):
                cfg.ss = argv[i]
            else:
                print("Invalid argument parsed to option: \"-ss\", "
                      "using default.", file=sys.stderr)
        else:
            print(f" Invalid option:\t{a}", file=sys.stderr)
            return 1
        i += 1
    if out is None or not dbs:
        print(" Too few arguments handed", file=sys.stderr)
        return 1
    db = dbs[0]
    if (splt_db or len(dbs) > 1) and cfg.min_frac < 0:
        print("spltDB cannot be used in combination with soft proximity "
              "matching, minFrac < 0", file=sys.stderr)
        return 1
    if not inputs and not pe_inputs and not int_inputs:
        inputs = ["--"]
    if splt_db and len(dbs) > 1:
        # -spltDB with several DBs prints the shard map commands and the
        # reduce command instead of running (kma.c:1330-1424)
        base = []
        quote = False
        j = 0
        while j < len(argv):
            if argv[j] == "-t_db":
                j += 1
                while j < len(argv) and not argv[j].startswith("-"):
                    j += 1
                continue
            if argv[j].startswith("-"):
                quote = False
            tok = f'"{argv[j]}"' if quote else argv[j]
            base.append(tok)
            if argv[j].startswith("-i"):
                quote = True
            j += 1
        print("# Map", file=sys.stderr)
        for n, d in enumerate(dbs):
            print(f"kma_tpu map {' '.join(base)} -t_db {d} > {out}.{n} &")
        print("# Reduce:", file=sys.stderr)
        reduce_args = [a for a in argv if a != "-spltDB"]
        print("kma_tpu map " + " ".join(reduce_args))
        return 0
    if len(dbs) > 1:
        from ..pipeline import run_kma_spltdb
        mh_tuple = None
        if mh is not None:
            coord, n, pid = mh.rsplit(",", 2)
            mh_tuple = (coord, int(n), int(pid))
        return run_kma_spltdb(dbs, out, inputs, cfg,
                              exe_cmd=" ".join(["kma"] + argv),
                              pe_files=pe_inputs or None,
                              int_files=int_inputs or None,
                              mh=mh_tuple)
    if mt1:
        from ..pipeline import run_kma_mt1
        return run_kma_mt1(db, out, inputs, cfg, mt1,
                           exe_cmd=" ".join(["kma"] + argv),
                           pe_files=pe_inputs or None)
    if cfg.sparse:
        from ..mapping.sparse import run_sparse
        if pe_inputs:
            inputs += pe_inputs
            print("Paired end information is not considered in Sparse "
                  "mode.", file=sys.stderr)
        if int_inputs:
            inputs += int_inputs
            print("Interleaved information is not considered in Sparse "
                  "mode.", file=sys.stderr)
        return run_sparse(db, inputs, out, id_t=cfg.ID_t,
                          depth_t=cfg.Depth_t, evalue=cfg.evalue, ss=cfg.ss,
                          min_phred=cfg.min_phred, hardmask_q=cfg.hardmask_q,
                          min_q=cfg.min_q, five_clip=cfg.five_clip,
                          three_clip=cfg.three_clip, min_len=cfg.min_len,
                          max_len=cfg.max_len, decon=cfg.deCon,
                          qc_report=cfg.qc_report)
    if cfg.step1:
        from ..pipeline import run_step1
        return run_step1(inputs, cfg, pe_files=pe_inputs or None,
                         int_files=int_inputs or None)
    if cfg.step2:
        from ..pipeline import run_step2
        if not dbs:
            print(" No database specified.", file=sys.stderr)
            return 1
        return run_step2(dbs[0], cfg, input_files=inputs,
                         pe_files=pe_inputs or None,
                         int_files=int_inputs or None)
    if mh is not None:
        from ..parallel.multihost import run_kma_multihost
        coord, n, pid = mh.rsplit(",", 2)
        return run_kma_multihost(db, out, inputs, cfg,
                                 " ".join(["kma"] + argv), coord, int(n),
                                 int(pid), pe_files=pe_inputs or None,
                                 int_files=int_inputs or None)
    return run_kma(db, out, inputs, cfg, exe_cmd=" ".join(["kma"] + argv),
                   pe_files=pe_inputs or None, int_files=int_inputs or None)


if __name__ == "__main__":
    sys.exit(main())
