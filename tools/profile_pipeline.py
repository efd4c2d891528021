"""Stage-level wall-clock profile of the alignment pipeline.

Usage:  python tools/profile_pipeline.py [data_dir]
data_dir holds ref.fa and qry.fa (an index is built beside them on first
use); it defaults to bench.py's 12 Mb pair, .bench/yeast_12mb. Runs on
the default JAX platform; set JAX_PLATFORMS=cpu to profile the host-only
path."""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import sys, time
import numpy as np
import gsalign_tpu
from gsalign_tpu.genome.fasta import read_fasta
from gsalign_tpu.genome.packing import pack_genome, chars_to_codes
from gsalign_tpu.index.io import load_index, save_index, index_loadable
from gsalign_tpu.index.fmindex import build_fmindex
from gsalign_tpu.ops.rank import DeviceFMIndex
from gsalign_tpu.ops.seeding import find_seeds
from gsalign_tpu.config import AlignConfig
from gsalign_tpu.pipeline import chain, blocks as blk_ops
from gsalign_tpu.genome.coords import ChrLocIndex, gen_coordinate_info
from gsalign_tpu.pipeline.generate import generate_alignments
from gsalign_tpu.pipeline import generate as gen_mod
from gsalign_tpu.ops import dp as dp_ops
from gsalign_tpu.pipeline.output import write_maf
from gsalign_tpu.pipeline.variants import VariantCollector, identify_variants, write_vcf

prefix = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    '.bench', 'yeast_12mb')
if index_loadable(f'{prefix}/ref_idx'):
    fm = load_index(f'{prefix}/ref_idx')
else:
    fm = build_fmindex(pack_genome(read_fasta(f'{prefix}/ref.fa')))
    save_index(fm, f'{prefix}/ref_idx')
qry_records = read_fasta(f'{prefix}/qry.fa')
genome = fm.genome
cfg = AlignConfig()
chr_index = ChrLocIndex(genome)
ref_chars = genome.chars_fwd_rc()
dfm = DeviceFMIndex.from_host(fm)

ref_codes = genome.codes_fwd_rc()   # pooled decode, as align.py does


def run(report=False):
    T = {}
    def mark(k, t0):
        T[k] = T.get(k, 0.0) + time.time() - t0
        return time.time()
    collector = VariantCollector()
    first = True
    for name, qry in qry_records:
        t0 = time.time()
        qc = chars_to_codes(qry)
        q_pos, r_pos, length = find_seeds(dfm, qc, min_seed_length=cfg.min_seed_length,
                                          chunk=cfg.seed_exploration_chunk)
        t0 = mark('seed', t0)
        blocks = chain.generate_alignment_blocks(q_pos, r_pos, length, cfg, genome.size)
        t0 = mark('chain', t0)
        for b in blocks: blk_ops.remove_overlaps(b)
        nb = []
        for b in blocks:
            s = blk_ops.check_gaps_between_seeds(b, qry, ref_chars, cfg)
            nb.extend([b] if s is None else s)
        blocks = blk_ops.remove_bad_blocks(nb)
        nb = []
        for b in blocks:
            s = blk_ops.check_span_multiple_chrs(b, chr_index, cfg)
            nb.extend([b] if s is None else s)
        blocks = blk_ops.remove_bad_blocks(nb)
        for b in blocks: b.b_dup = False
        cs = blk_ops.est_chromosome_similarity(blocks, chr_index)
        blocks = blk_ops.remove_redundant_blocks(blocks, cs, chr_index, cfg, 1)
        blocks = blk_ops.remove_redundant_blocks(blocks, cs, chr_index, cfg, 2)
        for b in blocks:
            if b.score > 0: blk_ops.fill_block_gaps(b)
        t0 = mark('blocks', t0)
        jobs, rf, qf = gen_mod.plan_alignments(blocks, qry, ref_chars,
                                               ref_codes=ref_codes,
                                               qry_codes=qc)
        ops_list = []
        if jobs:
            ops_list = dp_ops.align_fragments(rf, qf,
                                              bucket_sizes=cfg.dp_buckets,
                                              batch_cells=cfg.dp_batch_cells)
        gen_mod.finish_alignments(blocks, jobs, ops_list, qry, ref_chars)
        t0 = mark('gen', t0)
        n = 0
        for b in blocks:
            if b.aln_len == 0 or int(100 * (b.score / b.aln_len)) < cfg.min_seq_idy:
                b.score = 0
            else:
                n += 1
                b.coor = gen_coordinate_info(chr_index, int(b.r_pos[0]))
        blocks = blk_ops.remove_bad_blocks(blocks)
        t0 = mark('filter', t0)
        write_maf(f'{prefix}/prof.maf', blocks, name, qry, chr_index, first, True)
        first = False
        t0 = mark('maf', t0)
        identify_variants(blocks, qry, ref_chars, chr_index, collector,
                          ref_codes=ref_codes, qry_codes=qc)
        t0 = mark('vars', t0)
    t0 = time.time()
    write_vcf(f'{prefix}/prof.vcf', collector, genome.names, genome.lengths, 'x')
    T['vcf'] = time.time() - t0
    if report:
        total = sum(T.values())
        print(' '.join(f'{k}={v:.2f}' for k, v in T.items()), f'TOTAL={total:.2f}')

run()          # warmup
for _ in range(int(os.environ.get("PROF_REPS", "2"))):
    run(report=True)
