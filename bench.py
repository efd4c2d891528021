"""Benchmark driver for one NVIDIA GPU.

Prints one JSON line per genome-pair config, then DP rows, ending with the
headline line (the largest completed config):
    {"metric": "pair_align_wallclock", "value": N, "unit": "seconds", ...}

Each config is a `tests/make_testdata.make_pair` pair at the scale of a
real deployment: 4.6 Mb (E. coli), 12 Mb (S. cerevisiae), and, unless
GSALIGN_BENCH_SMALL=1, 100 Mb (C. elegans) and 250 Mb. The value is the
best warm `compare_genomes` wall-clock with the index loaded (one warm-up
pass first, so compilation is not timed); the index build is timed in a
fresh CPU-only child, since it is host work. Every row names the device it
ran on and the card's name and power limit; without a GPU the bench
refuses to run. GSALIGN_BENCH_ONLY=<tag> runs one config.

Data and indexes are cached under .bench/ in the checkout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.join(REPO, ".bench")
CONFIGS = [("ecoli_4.6mb", 4_600_000), ("yeast_12mb", 12_000_000)]
if not os.environ.get("GSALIGN_BENCH_SMALL"):
    CONFIGS += [("celegans_100mb", 100_000_000),
                ("human_250mb", 250_000_000)]
_only = os.environ.get("GSALIGN_BENCH_ONLY")
if _only:                       # one-config runs for A/B measurements
    CONFIGS = [c for c in CONFIGS if c[0] == _only]
REPS = {"ecoli_4.6mb": 5, "yeast_12mb": 3, "celegans_100mb": 3,
        "human_250mb": 2}


def ensure_data(tag: str, total_len: int):
    d = os.path.join(BENCH_DIR, tag)
    os.makedirs(d, exist_ok=True)
    ref_fa = os.path.join(d, "ref.fa")
    qry_fa = os.path.join(d, "qry.fa")
    if not (os.path.exists(ref_fa) and os.path.exists(qry_fa)):
        from tests.make_testdata import make_pair, write_fasta
        ref, qry = make_pair(total_len=total_len)
        write_fasta(ref_fa, ref)
        write_fasta(qry_fa, qry)
    return d, ref_fa, qry_fa


def build_index(ref_fa: str, idx_prefix: str, marker: str) -> float:
    """Build the index in a fresh child on the CPU (host work; the card
    stays with this process) and return its build seconds."""
    code = (
        # imports before t0: the marker times the build itself
        "import time,json;"
        "from gsalign_tpu.genome.fasta import read_fasta;"
        "from gsalign_tpu.genome.packing import pack_genome;"
        "from gsalign_tpu.index.fmindex import build_fmindex;"
        "from gsalign_tpu.index.io import save_index;"
        "t0=time.time();"
        f"fm=build_fmindex(pack_genome(read_fasta({ref_fa!r})));"
        "dt=round(time.time()-t0,3);"
        f"save_index(fm, {idx_prefix!r});"
        f"json.dump({{'seconds': dt}}, open({marker!r},'w'))")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, JAX_PLATFORMS="cpu",
                            PYTHONPATH=REPO))
    with open(marker) as fh:
        return json.load(fh)["seconds"]


def dp_gcells(L=128, B=2048, iters=4):
    """DP Gcells/s including traceback: `iters` chained device calls timed
    with block_until_ready, best of three."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from gsalign_tpu.ops.dp import dp_align_batch
    rng = np.random.default_rng(0)
    q = rng.integers(0, 4, (B, L)).astype(np.int32)
    t = q.copy()
    m = rng.random((B, L)) < 0.05
    t[m] = (t[m] + rng.integers(1, 4, m.sum())) % 4
    ql = np.full(B, L, np.int32)
    args = (jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql),
            jnp.asarray(ql), L)
    jax.block_until_ready(dp_align_batch(*args))       # warm
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        jax.block_until_ready([dp_align_batch(*args) for _ in range(iters)])
        best = min(best, time.time() - t0)
    return float(B) * L * L * iters / best / 1e9


def main():
    import jax
    dev0 = jax.devices()[0]
    if dev0.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX runs on {dev0.platform}")
    from chip_smoke import card_line
    device = {"platform": dev0.platform, "kind": dev0.device_kind,
              "count": len(jax.devices()),
              "card": "; ".join(sorted(set(card_line().splitlines())))}

    import gsalign_tpu  # noqa: F401
    from gsalign_tpu.config import AlignConfig
    from gsalign_tpu.genome.fasta import read_fasta
    from gsalign_tpu.index.io import index_loadable, load_index
    from gsalign_tpu.pipeline.align import compare_genomes

    headline = None
    for tag, total_len in CONFIGS:
        d, ref_fa, qry_fa = ensure_data(tag, total_len)
        idx_prefix = os.path.join(d, "ref_idx")
        marker = os.path.join(d, "build_seconds.json")
        if index_loadable(idx_prefix) and os.path.exists(marker):
            with open(marker) as fh:
                build_s = json.load(fh)["seconds"]
        else:
            build_s = build_index(ref_fa, idx_prefix, marker)
        fm = load_index(idx_prefix)
        qry_records = read_fasta(qry_fa)
        cfg = AlignConfig()
        out = os.path.join(d, "bench_out")

        stats, _, _ = compare_genomes(fm, qry_records, cfg,
                                      output_prefix=out, verbose=False)
        assert stats.local_alignment_num > 0
        best = float("inf")
        for _ in range(REPS.get(tag, 3)):
            t0 = time.time()
            stats, collector, _ = compare_genomes(
                fm, qry_records, cfg, output_prefix=out, verbose=False)
            best = min(best, time.time() - t0)

        row = {
            "metric": f"{tag}_align_wallclock",
            "value": round(best, 3),
            "unit": "seconds",
            "device": device,
            "aligned_bp_per_s": round(stats.total_alignment_length / best),
            "ani_pct": round(stats.ani, 2),
            "alignments": stats.local_alignment_num,
            "snv": collector.n_snv,
            "ins": collector.n_ins,
            "dele": collector.n_del,
            "index_build_seconds": build_s,
            "stage_seconds": {k: round(v, 3)
                              for k, v in stats.stage_times.items()},
        }
        print(json.dumps(row), flush=True)   # stream rows as they complete
        headline = dict(row, metric="pair_align_wallclock", config=tag)

    # L=128 is the pipeline's median gap bucket
    for metric, L, B in (("dp_scan_gcells_per_s", 128, 2048),
                         ("dp_scan_gcells_per_s_L256", 256, 1024)):
        print(json.dumps({"metric": metric,
                          "value": round(dp_gcells(L=L, B=B), 3),
                          "unit": "Gcells/s", "device": device}),
              flush=True)

    if headline is not None:
        print(json.dumps(headline), flush=True)


if __name__ == "__main__":
    main()
