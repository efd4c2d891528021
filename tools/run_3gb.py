"""Execute the 3 Gb config (BASELINE.json config 5, the GRCh38-vs-CHM13
regime) end-to-end: build the ~6.2 G-row WIDE index on the host, then run
the row-sharded-index pipeline over real query slices on an 8-device CPU
mesh — the at-scale demonstration of the reference's 64-bit `bwtint_t`
regime (reference src/BWT_Index/bwt.h:36-40; plan:
docs/SCALING_3GB.md).

Usage:  python tools/run_3gb.py [--len 3100000000] [--out .bench/run3gb]
Writes {out}/result.json (build wall, SA-IS wall, peak RSS, align wall,
ANI, alignments, variant counts, int64-coordinate evidence) and the usual
MAF/VCF outputs. Runtime ~1-2 h, peak RSS ~70-90 GB — run alone.
"""

import argparse
import json
import os
import resource
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--len", type=int, default=3_100_000_000,
                    dest="total_len")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".bench", "run3gb"))
    ap.add_argument("--slice-len", type=int, default=8_000_000)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    import numpy as np

    import jax
    import gsalign_tpu  # noqa: F401  (enables x64)
    from gsalign_tpu.genome.packing import Genome
    from gsalign_tpu.index import fmindex as fmindex_mod
    from gsalign_tpu.index.fmindex import build_fmindex
    from gsalign_tpu.parallel.mesh import make_mesh

    result = {"total_len": args.total_len}
    # two chromosomes so multi-chromosome coordinates are exercised at
    # int64 scale (the RC half of chr2 sits entirely beyond 2^31)
    l1 = args.total_len * 3 // 5
    l2 = args.total_len - l1
    print(f"[3gb] generating {args.total_len} bp over 2 chromosomes "
          f"({l1} + {l2})", flush=True)
    rng = np.random.default_rng(2026)
    codes = rng.integers(0, 4, args.total_len, dtype=np.uint8)
    g = Genome(names=["big1", "big2"],
               lengths=np.asarray([l1, l2], dtype=np.int64),
               offsets=np.asarray([0, l1], dtype=np.int64),
               holes=[], codes_fwd=codes)

    # SA timing via a wrapper INSIDE build_fmindex: holding our own
    # sa_full reference here would defeat the builder's early SA free
    # (fmindex.build_fmindex drops the ~50 GB array before the t3
    # tables allocate — load-bearing for this host's 125 GB).
    orig_bsa = fmindex_mod.build_suffix_array

    def timed_bsa(c, prefer_device=True):
        t = time.time()
        out = orig_bsa(c, prefer_device=False)
        result["sa_wall_s"] = round(time.time() - t, 1)
        result["sa_rss_gb"] = round(rss_gb(), 1)
        print(f"[3gb] SA-IS over {len(c)} rows: {result['sa_wall_s']}s "
              f"(peak RSS {result['sa_rss_gb']} GB)", flush=True)
        return out

    fmindex_mod.build_suffix_array = timed_bsa
    t0 = time.time()
    fm = build_fmindex(g, prefer_device=False)
    fmindex_mod.build_suffix_array = orig_bsa
    t_build = time.time() - t0
    result["build_wall_s"] = round(t_build, 1)
    result["build_rss_gb"] = round(rss_gb(), 1)
    result["wide"] = bool(fm.rank_dtype == np.int64)
    result["sa_intv"] = fm.sa_intv
    print(f"[3gb] index built: {t_build:.0f}s total, wide={result['wide']}, "
          f"sa_intv={fm.sa_intv}, peak RSS {result['build_rss_gb']} GB",
          flush=True)
    assert fm.seq_len == 2 * args.total_len
    if fm.seq_len > (1 << 31):          # the real config; smoke runs are
        assert result["wide"]           # below the wide threshold

    # query slices: mutated forward slices from both chromosomes plus one
    # reverse-complemented slice (RC blocks carry r_pos >= 2^31 here)
    def _mutate(sl, rng, rate=0.005):
        out = sl.copy()
        subs = rng.random(len(out)) < rate
        out[subs] = (out[subs] + rng.integers(1, 4, subs.sum())) % 4
        return out.astype(np.uint8)

    DNA = np.frombuffer(b"ACGT", dtype=np.uint8)
    L = args.slice_len
    qrng = np.random.default_rng(7)
    s1 = l1 // 3
    s2 = l1 + l2 // 2
    s_rc = l1 // 4      # RC locus maps to text pos 2N - s_rc - L: beyond
    sl_rc = _mutate(codes[s_rc:s_rc + L], qrng)     # 2^31 at full scale
    qry_records = [
        ("q_chr1_fwd", DNA[_mutate(codes[s1:s1 + L], qrng)]),
        ("q_chr2_fwd", DNA[_mutate(codes[s2:s2 + L], qrng)]),
        ("q_chr1_rc", DNA[(3 - sl_rc[::-1]).astype(np.uint8)]),
    ]

    from gsalign_tpu.config import AlignConfig
    from gsalign_tpu.index.io import save_index
    from gsalign_tpu.ops.rank import DeviceFMIndex
    from gsalign_tpu.parallel import mesh as mesh_lib
    from gsalign_tpu.pipeline.align import compare_genomes

    # insurance: persist the ~50 GB build so an align-phase failure never
    # costs the 45+ min rebuild
    t1 = time.time()
    save_index(fm, os.path.join(args.out, "idx"))
    result["save_wall_s"] = round(time.time() - t1, 1)
    print(f"[3gb] index saved ({result['save_wall_s']}s)", flush=True)

    # Pre-shard the device index and CACHE the sharded version, then free
    # the host-side rank planes (t3_cp 24.8 GB + t3_packed 6.2 GB + occ /
    # bwt) and the unsharded device copies — on the CPU mesh every
    # "device" buffer is host RAM, so compare_genomes' usual
    # from_host -> shard sequence would hold index tables three times.
    mesh = make_mesh()
    result["mesh_devices"] = len(mesh.devices.flat)
    import gc
    dfm = DeviceFMIndex.from_host(fm)
    fm.t3_cp = fm.t3_packed = fm.occ_cp = fm.bwt_packed = None
    fm.sa_samples = fm.c8 = fm.c12 = None   # host planes: consumed above
    gc.collect()
    fm._device_cache = mesh_lib.shard_index_rows(dfm, mesh)
    del dfm                                 # unsharded device copies
    gc.collect()
    print(f"[3gb] index sharded over {result['mesh_devices']} devices, "
          f"host rank planes freed (RSS now {rss_gb():.1f} GB peak)",
          flush=True)

    t1 = time.time()
    stats, collector, blocks = compare_genomes(
        fm, qry_records, AlignConfig(), mesh=mesh,
        output_prefix=os.path.join(args.out, "out"), verbose=True)
    t_align = time.time() - t1
    result.update({
        "align_wall_s": round(t_align, 1),
        "query_bp": 3 * L,
        "ani_pct": round(stats.ani, 2),
        "alignments": stats.local_alignment_num,
        "aligned_bp": stats.total_alignment_length,
        "snv": collector.n_snv, "ins": collector.n_ins,
        "dele": collector.n_del,
        "peak_rss_gb": round(rss_gb(), 1),
    })
    # int64-coordinate evidence: some RC-strand block beyond 2^31
    max_rpos = 0
    for res in blocks:
        for blk in res.blocks:
            if blk.n:
                max_rpos = max(max_rpos, int(blk.r_pos[-1] + blk.r_len[-1]))
    result["max_text_rpos"] = max_rpos
    result["int64_coords_seen"] = bool(max_rpos >= (1 << 31))

    with open(os.path.join(args.out, "result.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print("[3gb] " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
