"""Run configuration.

Every tunable constant of the pipeline lives here, lifted out of the
reference's global variables and #defines (reference defaults:
src/main.cpp:203-215, src/GSAlign.cpp:4-5, src/bwt_search.cpp:3,
src/structure.h:23, src/KmerAnalysis.cpp:5).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    # --- CLI-exposed knobs (reference src/main.cpp:203-215) ---
    thread_num: int = 8                 # -t   (host-side threads only)
    min_seed_length: int = 15           # -slen (10..30)
    min_aln_block_score: int = 200      # -clr  (cluster size floor)
    min_aln_length: int = 200           # -alen
    min_seq_idy: int = 70               # -idy  (percent identity floor)
    max_indel_size: int = 25            # -ind  (10..100)
    output_format: int = 1              # -fmt  1: maf, 2: aln
    sensitive: bool = False             # -sen  (slen->10, clr->50, stride +5)
    one_on_one: bool = False            # -one
    allow_duplication: bool = True      # -unique sets False
    emit_vcf: bool = True               # -no_vcf sets False
    show_plot: bool = False             # -dp
    gnuplot_path: str = ""              # -gp (src/main.cpp:285; "" = whereis)
    # -d / -obr debug affordances. The reference PARSES these
    # (src/main.cpp:288-289) but every use site is commented out
    # (src/GSAlign.cpp:456, src/tools.cpp:79-118 printers); here they are
    # live: -d dumps chained block boundaries + FragPairs in the
    # ShowAlnBlockBoundary/ShowFragPair format, -obr restricts the dump to
    # blocks whose reference span covers the given position.
    debug: bool = False                 # -d / -debug
    obr_pos: int = -1                   # -obr

    # --- pipeline constants (reference #defines) ---
    max_seed_freq: int = 100            # src/bwt_search.cpp:3
    seed_exploration_chunk: int = 10000  # src/GSAlign.cpp:5
    max_seed_gap: int = 5000            # src/structure.h:23
    min_pd_freq: int = 3                # src/GSAlign.cpp:4
    kmer_size: int = 5                  # src/KmerAnalysis.cpp:5
    # chain split thresholds (src/GSAlign.cpp:367, src/ProcessCandidateAlignment.cpp:132)
    chain_pd_break: int = 100
    gap_check_size: int = 300
    # block dedup containment threshold (src/GSAlign.cpp:457-462)
    dup_overlap_frac: float = 0.9

    # --- device execution knobs (new; no reference equivalent) ---
    sa_sample_interval: int = 8         # sampled-SA stride (reference fixes 32)
    seed_lane_chunk: int = 10000        # lane width for batched seeding
    dp_buckets: tuple = (64, 128, 256, 512, 1024, 2048, 5120)
    dp_batch_cells: int = 1 << 26       # target cells per DP kernel launch

    def effective(self) -> "AlignConfig":
        """Apply -sen implications (reference src/main.cpp:272-277,323)."""
        if self.sensitive:
            return dataclasses.replace(
                self, min_seed_length=10, min_aln_block_score=50,
                min_aln_length=200)
        return self

    @property
    def seed_stride_sensitive(self) -> int:
        # sensitive mode advances +5 after a hit (src/GSAlign.cpp:87)
        return 5


DEFAULT_CONFIG = AlignConfig()
