"""Multi-host (DCN) data parallelism.

The reference is strictly single-node (pthreads + one mutex,
src/GSAlign.cpp:8,492-526); this module supplies the multi-host dimension:
query chromosomes are partitioned round-robin across JAX processes, each
host runs the full per-chromosome pipeline on its own local device mesh
(device parallelism via parallel/mesh.py), and host 0 merges the per-
chromosome output shards deterministically — the merged MAF/ALN/VCF are
byte-identical to a single-host run for any process count.

Shard exchange rides the job's shared filesystem (per-chromosome MAF/ALN
shards plus pickled variant collectors and stats); the barrier between
shard production and the merge is a jax.distributed collective, so no
out-of-band coordination is needed.

Usage (per host):
    jax.distributed.initialize(coordinator, num_processes, process_id)
    run_distributed(fm, query_records, cfg, output_prefix)
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np


def _barrier(name: str) -> None:
    import jax
    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(name)


def run_distributed(fm, query_records: List, cfg, output_prefix: str,
                    verbose: bool = True, mesh=None, dp_fn=None,
                    resume: bool = False):
    """Distributed compare_genomes: returns (stats, collector, results)
    on process 0 and (local stats, None, local results) elsewhere.

    Chromosome ci is processed by process (ci mod process_count); each
    produces `{output_prefix}.part{ci}` shards merged by process 0 in
    chromosome order, reproducing the single-host emission order exactly
    (variant sequence numbers are offset per shard, see
    VariantCollector.merge_from).

    resume=True makes the run restartable (the per-fragment resumability
    the reference lacks — its appended outputs are corrupt after a crash,
    src/tools.cpp:158-163): each chromosome's shard is committed by an
    atomic rename of its .pkl marker AFTER the output shard is complete,
    so a restart recomputes only chromosomes without a marker and the
    final merge is byte-identical to an uninterrupted run.
    """
    import jax
    from gsalign_tpu.pipeline.align import RunStats, compare_genomes
    from gsalign_tpu.pipeline.variants import VariantCollector, write_vcf

    pid = jax.process_index()
    nproc = jax.process_count()
    if mesh is None and len(jax.local_devices()) > 1:
        from gsalign_tpu.parallel import mesh as mesh_lib
        mesh = mesh_lib.make_mesh(jax.local_devices())

    my_results = []
    my_stats = RunStats()
    ext0 = ".maf" if cfg.effective().output_format == 1 else ".aln"
    owned = [ci for ci in range(len(query_records)) if ci % nproc == pid]

    def run_one(ci: int):
        part = f"{output_prefix}.part{ci}"
        if resume and os.path.exists(part + ".pkl"):
            with open(part + ".pkl", "rb") as fh:
                st, _ = pickle.load(fh)
            # the marker commits AFTER the shard: presence of the .pkl
            # guarantees the shard (absent only for 0-alignment chromosomes)
            if os.path.exists(part + ext0) or st.local_alignment_num == 0:
                return st, []
        st, coll, res = compare_genomes(
            fm, [query_records[ci]], cfg, output_prefix=part,
            verbose=verbose, mesh=mesh, dp_fn=dp_fn,
            write_vcf_file=False, plot_prefix=output_prefix)
        with open(part + ".pkl.tmp", "wb") as fh:
            pickle.dump((st, coll), fh)
        os.replace(part + ".pkl.tmp", part + ".pkl")       # commit marker
        return st, res

    # host-side chromosome threading (the reference's -t maps to pthread
    # stage workers, src/GSAlign.cpp:492-526; here threads overlap one
    # chromosome's host stages with another's device stages — device
    # launches serialize on the chip anyway, outputs merge by index)
    n_workers = min(max(1, cfg.effective().thread_num), max(1, len(owned)))
    if n_workers > 1 and len(owned) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(n_workers) as pool:
            outs = list(pool.map(run_one, owned))
    else:
        outs = [run_one(ci) for ci in owned]
    for st, res in outs:
        my_results.extend(res)
        my_stats.local_alignment_num += st.local_alignment_num
        my_stats.total_alignment_length += st.total_alignment_length
        my_stats.total_alignment_matches += st.total_alignment_matches
        my_stats.dup_aln_num += st.dup_aln_num

    _barrier("gsalign-shards-written")
    if pid != 0:
        _barrier("gsalign-merge-done")
        return my_stats, None, my_results

    # ---- process 0: deterministic merge in chromosome order ----
    stats = RunStats()
    collector = VariantCollector()
    ext = ".maf" if cfg.effective().output_format == 1 else ".aln"
    out_path = output_prefix + ext
    with open(out_path, "wb") as out:
        if ext == ".maf":
            out.write(b"##maf version=1\n")
        for ci in range(len(query_records)):
            part = f"{output_prefix}.part{ci}"
            with open(part + ".pkl", "rb") as fh:
                st, coll = pickle.load(fh)
            stats.local_alignment_num += st.local_alignment_num
            stats.total_alignment_length += st.total_alignment_length
            stats.total_alignment_matches += st.total_alignment_matches
            stats.dup_aln_num += st.dup_aln_num
            collector.merge_from(coll)
            if os.path.exists(part + ext):
                with open(part + ext, "rb") as fh:
                    data = fh.read()
                if ext == ".maf" and data.startswith(b"##maf version=1\n"):
                    data = data[len(b"##maf version=1\n"):]
                out.write(data)
            for f in (part + ext, part + ".pkl"):
                if os.path.exists(f):
                    os.remove(f)
    if cfg.effective().emit_vcf:
        write_vcf(f"{output_prefix}.vcf", collector, fm.genome.names,
                  fm.genome.lengths, reference_name=output_prefix)
    _barrier("gsalign-merge-done")
    return stats, collector, my_results
