"""Smoke run of the aligner on NVIDIA GPUs: the quickest proof that the
main path still starts, compiles and gives the right bytes on the card.

    python chip_smoke.py           one card, phases (a)-(f) below
    python chip_smoke.py --four    four cards: only the multi-card paths on
                                   the 12 Mb pair, each against a one-card run

One-card phases, each a hard failure:
  (a) device     platform, device kind and count; the card's name and power
                 limit from nvidia-smi (read by a child that never imports
                 JAX), printed beside every number that follows
  (b) golden     the CLI on the 100 kb pair, byte-compared with the C
                 reference's goldens (tests/golden; VCF without ##reference)
  (c) dp         dp_align_batch at every bucket width of AlignConfig at
                 dp_batch_cells per call, op codes equal to the scalar ksw2
                 reference (tests/ksw_ref.py) on a sample of problems; at
                 L=256 also equal to the ksw2 oracle goldens
  (d) yeast      `cli index` then `cli -i -q -o` on the 12 Mb pair
                 (BASELINE.json config 2) on the card, cold and warm, with
                 stage times, peak device memory and the DP's share of the
                 align stage; MAF and VCF byte-equal to a run of the same
                 code under JAX_PLATFORMS=cpu in a child process
  (e) dp timing  per-bucket dp_align_batch time with block_until_ready
  (f) gpu tests  `pytest -m gpu`, in this process

The card is used by this process alone. The last line of standard output is
one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
Genomes, indexes and alignments go to .bench/chip_smoke/ (--work); the CLI
logs of phase (d) go to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(REPO, "tests", "golden")
LOG_DIR = os.path.join(REPO, "chiprun_out", "chip_smoke")
GOLDEN_LEN = 100_000        # the pair tests/golden was produced from
YEAST_LEN = 12_000_000      # BASELINE.json config 2: S. cerevisiae pair
# (golden tag, CLI flags, output extensions compared)
GOLDEN_RUNS = (("g_default", (), ("maf", "vcf")),
               ("g_sen", ("-sen",), ("maf", "vcf")),
               ("g_aln", ("-fmt", "2"), ("aln", "vcf")))
# problems per bucket checked against the scalar reference (the smallest
# in the batch by cells: the reference runs at ~2 us per cell)
DP_SAMPLE = {64: 16, 128: 8, 256: 4, 512: 2}


class SmokeError(Exception):
    pass


def card_line() -> str:
    """nvidia-smi's name and power limit of every card, one per line."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise SmokeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def report(card: str, phase: str, **numbers) -> None:
    kv = " ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"[{phase}] {kv} | {card}", flush=True)


def strip_reference_line(text: bytes) -> bytes:
    return b"\n".join(ln for ln in text.split(b"\n")
                      if not ln.startswith(b"##reference="))


def _read(path: str) -> bytes:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        data = fh.read()
    return strip_reference_line(data) if ".vcf" in path else data


def golden_diffs(prefix: str, tag: str, exts) -> list:
    """Names of the outputs `prefix.<ext>` that differ from the golden
    `tests/golden/<tag>.<ext>.gz` (VCFs compared without ##reference)."""
    return [f"{prefix}.{e} != {tag}.{e}" for e in exts
            if _read(f"{prefix}.{e}")
            != _read(os.path.join(GOLDEN_DIR, f"{tag}.{e}.gz"))]


def output_diffs(prefix: str, want: str, exts=("maf", "vcf")) -> list:
    """Names of the outputs of run `prefix` that differ from run `want`."""
    return [f"{prefix}.{e} != {want}.{e}" for e in exts
            if _read(f"{prefix}.{e}") != _read(f"{want}.{e}")]


def run_cli(*args: str) -> str:
    """Run the CLI in this process (so one process holds the card) and
    return what it wrote to stderr."""
    from gsalign_tpu import cli
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        rc = cli.main(["gsalign-tpu", *args])
    if rc != 0:
        raise SmokeError(f"cli {' '.join(args)} exited {rc}:\n"
                         f"{buf.getvalue()[-3000:]}")
    return buf.getvalue()


def stage_seconds(cli_stderr: str) -> dict:
    """Sum the `[stages] name=1.23s ...` reports of every query chromosome
    (thread time: stages of concurrent chromosomes overlap)."""
    out: dict = {}
    for line in cli_stderr.splitlines():
        if "[stages]" in line:
            for name, sec in re.findall(r"(\w+)=([\d.]+)s", line):
                if name != "total":
                    out[name] = round(out.get(name, 0.0) + float(sec), 3)
    return out


def peak_bytes(devices) -> list:
    """Peak device memory in use per device (None where JAX keeps no
    statistics, as on the CPU)."""
    return [(dv.memory_stats() or {}).get("peak_bytes_in_use")
            for dv in devices]


def write_pair(work: str, total_len: int):
    """make_pair(total_len) with its default profile, as FASTA files."""
    from tests.make_testdata import make_pair, write_fasta
    d = os.path.join(work, f"pair_{total_len}")
    os.makedirs(d, exist_ok=True)
    ref, qry = make_pair(total_len=total_len)
    ref_fa, qry_fa = os.path.join(d, "ref.fa"), os.path.join(d, "qry.fa")
    write_fasta(ref_fa, ref)
    write_fasta(qry_fa, qry)
    return d, ref_fa, qry_fa


def index_pair(work: str, card: str, total_len: int, phase: str):
    """Generate the pair and build its index through the CLI."""
    t0 = time.perf_counter()
    d, ref_fa, qry_fa = write_pair(work, total_len)
    t1 = time.perf_counter()
    idx = os.path.join(d, "ref_idx")
    run_cli("index", ref_fa, idx)
    report(card, phase, pair_bp=total_len,
           datagen_s=round(t1 - t0, 3),
           index_build_s=round(time.perf_counter() - t1, 3))
    return d, idx, qry_fa


def phase_golden(work: str, card: str, total_len: int = GOLDEN_LEN) -> None:
    d, idx, qry_fa = index_pair(work, card, total_len, "golden")
    diffs = []
    for tag, flags, exts in GOLDEN_RUNS:
        prefix = os.path.join(d, tag)
        t0 = time.perf_counter()
        run_cli("-i", idx, "-q", qry_fa, "-o", prefix, *flags)
        wall = time.perf_counter() - t0
        bad = golden_diffs(prefix, tag, exts)
        report(card, "golden", mode=tag, wall_s=round(wall, 3),
               identical=not bad)
        diffs += bad
    if diffs:
        raise SmokeError("golden parity: " + "; ".join(diffs))


def dp_batch(L: int, lo: int, B: int, rng):
    """B related problems (substitutions, a deletion and an insertion)
    whose longer side lies in (lo, L], padded to width L like
    dp.FragmentAligner pads a bucket."""
    import numpy as np
    q = np.full((B, L), 4, np.int8)
    t = np.full((B, L), 4, np.int8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for i in range(B):
        n = int(rng.integers(lo + 1, L + 1))
        a = rng.integers(0, 4, n).astype(np.int8)
        b = a.copy()
        sub = rng.random(n) < 0.03
        b[sub] = (b[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        p, k = int(rng.integers(0, n)), int(rng.integers(1, 6))
        b = np.concatenate([b[:p], b[p + k:]])
        p = int(rng.integers(0, len(b) + 1))
        b = np.concatenate([b[:p], rng.integers(0, 4, int(rng.integers(
            1, 6))).astype(np.int8), b[p:]])[:L]
        q[i, :n], ql[i] = a, n
        t[i, :len(b)], tl[i] = b, len(b)
    return q, t, ql, tl


def dp_ops_string(ops_row) -> str:
    import numpy as np
    from gsalign_tpu.ops import dp as dp_ops
    o = np.asarray(ops_row)
    o = o[o != dp_ops.OP_PAD][::-1]
    return "".join("MDI"[c] for c in o)


def dp_batch_size(L: int, batch_cells: int) -> int:
    """Problems per call as dp.FragmentAligner dispatches a full bucket."""
    B = 8
    while B < max(1, batch_cells // (L * L)):
        B *= 2
    return B


def phase_dp(card: str, seed: int = 0) -> dict:
    """Compare the DP on the card with the scalar reference at every bucket
    width; returns the device batches for the timing phase."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from gsalign_tpu.config import AlignConfig
    from gsalign_tpu.ops import dp as dp_ops
    from tests.ksw_ref import ksw_ref_ops
    from tests.test_dp_oracle import load_cases, run_batch

    cfg = AlignConfig()
    rng = np.random.default_rng(seed)
    batches = {}
    lo = 0
    for L in cfg.dp_buckets:
        B = dp_batch_size(L, cfg.dp_batch_cells)
        q, t, ql, tl = dp_batch(L, lo, B, rng)
        args = tuple(jnp.asarray(a) for a in (q, t, ql, tl))
        t0 = time.perf_counter()
        ops = np.asarray(jax.block_until_ready(
            dp_ops.dp_align_batch(*args, L)))
        first_s = time.perf_counter() - t0
        sample = np.argsort(ql.astype(np.int64) * tl)[:DP_SAMPLE.get(L, 1)]
        t0 = time.perf_counter()
        bad = [int(i) for i in sample
               if dp_ops_string(ops[i]) != "".join(ksw_ref_ops(
                   q[i, :ql[i]].tolist(), t[i, :tl[i]].tolist()))]
        report(card, "dp", L=L, B=B, first_call_s=round(first_s, 3),
               checked=len(sample), mismatched=len(bad),
               reference_s=round(time.perf_counter() - t0, 3))
        if bad:
            raise SmokeError(f"DP L={L}: problems {bad} differ from ksw_ref")
        batches[L] = args
        lo = L
    cases, outs = load_cases()
    rows = run_batch(cases, dp_ops.dp_align_batch, 256)
    bad = [i for i, (e, g) in enumerate(zip(outs, rows)) if tuple(e) != g]
    report(card, "dp", L=256, oracle_cases=len(cases), mismatched=len(bad))
    if bad:
        raise SmokeError(f"DP differs from the ksw2 oracle in cases {bad}")
    return batches


def phase_dp_timing(card: str, batches: dict) -> None:
    import jax
    from gsalign_tpu.ops import dp as dp_ops
    for L, args in batches.items():
        B = args[0].shape[0]
        iters = 4 if L <= 512 else 2
        jax.block_until_ready(dp_ops.dp_align_batch(*args, L))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(
                [dp_ops.dp_align_batch(*args, L) for _ in range(iters)])
            best = min(best, (time.perf_counter() - t0) / iters)
        report(card, "dp_timing", L=L, B=B, ms_per_call=best * 1e3,
               gcells_per_s=B * L * L / best / 1e9)


def start_cpu_reference(d: str, idx: str, qry_fa: str):
    """The same CLI run under JAX_PLATFORMS=cpu, in a child that does not
    touch the card; returns (process, output prefix, log file)."""
    prefix = os.path.join(d, "cpu")
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=REPO)
    os.makedirs(LOG_DIR, exist_ok=True)
    log = open(os.path.join(LOG_DIR, "cpu_cli.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gsalign_tpu.cli", "-i", idx, "-q", qry_fa,
         "-o", prefix], env=env, cwd=REPO, stdout=log, stderr=log)
    return proc, prefix, log


def wait_cpu_reference(card: str, cpu, timeout: float) -> str:
    proc, prefix, log = cpu
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    if rc != 0:
        raise SmokeError(f"CPU reference run exited {rc} (see {log.name})")
    report(card, "yeast", cpu_reference_waited_s=round(
        time.perf_counter() - t0, 3))
    return prefix


def phase_yeast(card: str, d: str, idx: str, qry_fa: str,
                cpu_prefix: str) -> None:
    import jax
    from gsalign_tpu.ops import dp as dp_ops

    # cold run: compiles every shape of the run
    t0 = time.perf_counter()
    run_cli("-i", idx, "-q", qry_fa, "-o", os.path.join(d, "gpu_cold"))
    cold_s = time.perf_counter() - t0
    # warm run, recording every DP call to replay it alone afterwards
    calls = []
    orig = dp_ops.dp_align_batch

    def recording(*args):
        calls.append(args)
        return orig(*args)

    dp_ops.dp_align_batch = recording
    try:
        t0 = time.perf_counter()
        err = run_cli("-i", idx, "-q", qry_fa, "-o", os.path.join(d, "gpu"))
        warm_s = time.perf_counter() - t0
    finally:
        dp_ops.dp_align_batch = orig
    os.makedirs(LOG_DIR, exist_ok=True)
    with open(os.path.join(LOG_DIR, "gpu_cli.log"), "w") as fh:
        fh.write(err)
    stages = stage_seconds(err)
    t0 = time.perf_counter()
    jax.block_until_ready([orig(*a) for a in calls])
    dp_s = time.perf_counter() - t0
    # the warm wall outside the stages: index load and device tables
    from gsalign_tpu.index.io import load_index
    from gsalign_tpu.ops.rank import DeviceFMIndex
    t0 = time.perf_counter()
    fm = load_index(idx)
    t1 = time.perf_counter()
    jax.block_until_ready(DeviceFMIndex.from_host(fm))
    t2 = time.perf_counter()
    peak = peak_bytes(jax.devices())[0]
    report(card, "yeast", cold_wall_s=round(cold_s, 3),
           warm_wall_s=round(warm_s, 3),
           stage_thread_s=json.dumps(stages, separators=(",", ":")),
           index_load_s=round(t1 - t0, 3),
           device_index_build_s=round(t2 - t1, 3),
           peak_bytes_in_use=peak)
    report(card, "yeast", dp_calls=len(calls), dp_replay_s=round(dp_s, 4),
           dp_share_of_align=round(dp_s / max(stages.get("align", 0), 1e-9),
                                   4))
    diffs = (output_diffs(os.path.join(d, "gpu"), cpu_prefix)
             + output_diffs(os.path.join(d, "gpu_cold"), cpu_prefix))
    if diffs:
        raise SmokeError("GPU and CPU runs differ: " + "; ".join(diffs))
    report(card, "yeast", gpu_equals_cpu=True)


class _Outcomes:
    """pytest plugin counting test outcomes."""

    def __init__(self):
        self.counts: dict = {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(
                report.outcome, 0) + 1


def phase_gpu_tests(card: str) -> None:
    import pytest
    seen = _Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_gpu.py")],
                     plugins=[seen])
    report(card, "gpu_tests", exit_code=int(rc),
           **{k: v for k, v in sorted(seen.counts.items())})
    if rc != 0 or not seen.counts.get("passed") or set(seen.counts) != {
            "passed"}:
        raise SmokeError(f"pytest -m gpu: exit {rc}, outcomes {seen.counts}")


def phase_four(work: str, card: str, total_len: int = YEAST_LEN) -> None:
    """The CLI over every local card (its default "frag" mesh) and the
    row-sharded index, each byte-compared with a one-card run."""
    import jax
    from gsalign_tpu.config import AlignConfig
    from gsalign_tpu.genome.fasta import read_fasta
    from gsalign_tpu.index.io import load_index
    from gsalign_tpu.parallel.mesh import make_mesh
    from gsalign_tpu.pipeline.align import compare_genomes

    devices = jax.devices()
    d, idx, qry_fa = index_pair(work, card, total_len, "four")
    mesh_prefix = os.path.join(d, "mesh")
    t0 = time.perf_counter()
    err = run_cli("-i", idx, "-q", qry_fa, "-o", mesh_prefix)
    os.makedirs(LOG_DIR, exist_ok=True)
    with open(os.path.join(LOG_DIR, "four_cli.log"), "w") as fh:
        fh.write(err)
    peaks = peak_bytes(devices)
    report(card, "four", cli_mesh_cold_wall_s=round(
        time.perf_counter() - t0, 3), devices=len(devices),
        peak_bytes_in_use=peaks)
    if None not in peaks and min(peaks) * 2 < max(peaks):
        raise SmokeError(f"unbalanced device memory {peaks}: work placed "
                         f"on one device alone")
    fm = load_index(idx)
    records = read_fasta(qry_fa)
    cfg = AlignConfig()
    one_prefix = os.path.join(d, "one")
    t0 = time.perf_counter()
    compare_genomes(fm, records, cfg, output_prefix=one_prefix,
                    verbose=False)
    report(card, "four", one_device_cold_wall_s=round(
        time.perf_counter() - t0, 3))
    rows_prefix = os.path.join(d, "rows")
    t0 = time.perf_counter()
    compare_genomes(fm, records, cfg, output_prefix=rows_prefix,
                    verbose=False, mesh=make_mesh(devices),
                    shard_index_rows=True)
    report(card, "four", row_sharded_cold_wall_s=round(
        time.perf_counter() - t0, 3))
    diffs = (output_diffs(mesh_prefix, one_prefix)
             + output_diffs(rows_prefix, one_prefix))
    if diffs:
        raise SmokeError("multi-card runs differ: " + "; ".join(diffs))
    report(card, "four", mesh_equals_one=True, row_sharded_equals_one=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths")
    ap.add_argument("--work", default=os.path.join(REPO, ".bench",
                                                   "chip_smoke"))
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "gsalign_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    import jax
    import gsalign_tpu  # noqa: F401  (x64, compile cache)
    devices = jax.devices()
    dev = {"platform": devices[0].platform,
           "kind": devices[0].device_kind, "count": len(devices)}
    if dev["platform"] != "gpu":
        print(f"no GPU: JAX runs on {dev['platform']}", file=sys.stderr)
        return 1
    print(f"[device] platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']}", flush=True)
    card = card_line()
    print(card, flush=True)
    card = "; ".join(sorted(set(card.splitlines())))
    if args.four and dev["count"] != 4:
        print(f"--four needs 4 cards, JAX sees {dev['count']}",
              file=sys.stderr)
        return 1
    os.makedirs(args.work, exist_ok=True)
    try:
        if args.four:
            phase_four(args.work, card)
        else:
            d, idx, qry_fa = index_pair(args.work, card, YEAST_LEN,
                                        "yeast")
            cpu = start_cpu_reference(d, idx, qry_fa)
            try:
                phase_golden(args.work, card)
                batches = phase_dp(card)
            except BaseException:
                cpu[0].kill()
                cpu[0].wait()
                cpu[2].close()
                raise
            cpu_prefix = wait_cpu_reference(card, cpu, timeout=900)
            phase_yeast(card, d, idx, qry_fa, cpu_prefix)
            phase_dp_timing(card, batches)
            phase_gpu_tests(card)
    except SmokeError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
