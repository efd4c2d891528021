"""DP parity against the reference ksw2 implementation.

Fixtures were produced by compiling the reference's ksw2_alignment.cpp into
an oracle binary and recording aligned rows for 120 fixed cases (random,
related-with-edits, and N-containing pairs). The device DP must reproduce
every aligned row byte-for-byte — tie-breaking included.
"""

import gzip
import os

import numpy as np
import jax.numpy as jnp
import pytest

from gsalign_tpu.genome.packing import NT4_TABLE
from gsalign_tpu.ops import dp as dp_ops

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def load_cases():
    with gzip.open(os.path.join(GOLDEN_DIR, "ksw_oracle_cases.txt.gz"),
                   "rt") as fh:
        cases = [ln.split() for ln in fh.read().strip().splitlines()]
    with gzip.open(os.path.join(GOLDEN_DIR, "ksw_oracle_out.txt.gz"),
                   "rt") as fh:
        outs = [ln.split() for ln in fh.read().strip().splitlines()]
    return cases, outs


def run_batch(cases, dp_fn, L):
    B = len(cases)
    q = np.full((B, L), 4, np.int32)
    t = np.full((B, L), 4, np.int32)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for i, (s1, s2) in enumerate(cases):
        qc = NT4_TABLE[np.frombuffer(s1.encode(), np.uint8)]
        tc = NT4_TABLE[np.frombuffer(s2.encode(), np.uint8)]
        q[i, :len(qc)] = qc
        t[i, :len(tc)] = tc
        ql[i] = len(qc)
        tl[i] = len(tc)
    ops = np.asarray(dp_fn(jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql),
                           jnp.asarray(tl), L))
    rows = []
    for i, (s1, s2) in enumerate(cases):
        o = ops[i]
        o = o[o != dp_ops.OP_PAD][::-1]
        a1, a2 = dp_ops.ops_to_alignment(
            o, np.frombuffer(s1.encode(), np.uint8),
            np.frombuffer(s2.encode(), np.uint8))
        rows.append((a1.tobytes().decode(), a2.tobytes().decode()))
    return rows


def test_dp_matches_reference_ksw2_oracle():
    cases, outs = load_cases()
    rows = run_batch(cases, dp_ops.dp_align_batch, 256)
    for i, ((e1, e2), (g1, g2)) in enumerate(zip(outs, rows)):
        assert g1 == e1 and g2 == e2, f"case {i}"
