"""Worker process for the 2-process jax.distributed test (see
test_distributed.py). Usage:
    python dist_worker.py <coordinator> <nproc> <pid> <workdir>
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    coord, nproc, pid, workdir = (sys.argv[1], int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    import jax
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=nproc, process_id=pid)
    import gsalign_tpu  # noqa: F401
    from gsalign_tpu.config import AlignConfig
    from gsalign_tpu.genome.fasta import read_fasta
    from gsalign_tpu.index.io import load_index
    from gsalign_tpu.parallel.distributed import run_distributed

    fm = load_index(os.path.join(workdir, "idx"))
    qry = read_fasta(os.path.join(workdir, "qry.fa"))
    stats, collector, _ = run_distributed(
        fm, qry, AlignConfig(), os.path.join(workdir, "dist_out"),
        verbose=False)
    print(f"worker {pid}/{nproc}: alignments={stats.local_alignment_num}",
          flush=True)


if __name__ == "__main__":
    main()
