import numpy as np
import jax.numpy as jnp
import pytest

from gsalign_tpu.ops import dp as dp_ops
from tests.ksw_ref import ksw_ref_ops

OPCHAR = {dp_ops.OP_M: "M", dp_ops.OP_D: "D", dp_ops.OP_I: "I"}


def run_device(q_list, t_list, L):
    B = len(q_list)
    q = np.full((B, L), 4, dtype=np.int32)
    t = np.full((B, L), 4, dtype=np.int32)
    ql = np.zeros(B, dtype=np.int32)
    tl = np.zeros(B, dtype=np.int32)
    for i, (qc, tc) in enumerate(zip(q_list, t_list)):
        q[i, :len(qc)] = qc
        t[i, :len(tc)] = tc
        ql[i] = len(qc)
        tl[i] = len(tc)
    ops = np.asarray(dp_ops.dp_align_batch(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql), jnp.asarray(tl), L))
    out = []
    for i in range(B):
        o = ops[i]
        o = o[o != dp_ops.OP_PAD][::-1]
        out.append("".join(OPCHAR[c] for c in o))
    return out


def test_dp_simple_match():
    qc = [0, 1, 2, 3]
    got = run_device([qc], [qc], 8)[0]
    assert got == "MMMM"


def test_dp_single_mismatch():
    qc = [0, 1, 2, 3]
    tc = [0, 1, 0, 3]
    assert run_device([qc], [tc], 8)[0] == "MMMM"


def test_dp_insertion_in_target():
    # target has one extra base -> one D (consumes target)
    qc = [0, 1, 2, 3, 0, 1, 2, 3]
    tc = [0, 1, 2, 3, 2, 0, 1, 2, 3]
    ops = run_device([qc], [tc], 16)[0]
    assert ops.count("D") == 1 and ops.count("M") == 8 and "I" not in ops


def test_dp_deletion_in_target():
    qc = [0, 1, 2, 3, 2, 0, 1, 2, 3]
    tc = [0, 1, 2, 3, 0, 1, 2, 3]
    ops = run_device([qc], [tc], 16)[0]
    assert ops.count("I") == 1 and ops.count("M") == 8 and "D" not in ops


@pytest.mark.parametrize("trial", range(8))
def test_dp_matches_scalar_reference(trial):
    rng = np.random.default_rng(100 + trial)
    ql = int(rng.integers(1, 40))
    tl = int(rng.integers(1, 40))
    qc = rng.integers(0, 4, ql).tolist()
    tc = rng.integers(0, 4, tl).tolist()
    got = run_device([qc], [tc], 64)[0]
    expect = "".join(ksw_ref_ops(qc, tc))
    assert got == expect, f"ql={ql} tl={tl}"


def test_dp_matches_scalar_related_sequences():
    rng = np.random.default_rng(42)
    base = rng.integers(0, 4, 60)
    qs, ts = [], []
    for i in range(6):
        qc = base.copy()
        tc = base.copy()
        # random edits
        for _ in range(4):
            p = int(rng.integers(0, len(tc)))
            op = rng.integers(0, 3)
            if op == 0:
                tc[p] = (tc[p] + 1) % 4
            elif op == 1 and len(tc) > 10:
                tc = np.delete(tc, p)
            else:
                tc = np.insert(tc, p, rng.integers(0, 4))
        qs.append(qc.tolist())
        ts.append(tc.tolist())
    got = run_device(qs, ts, 128)
    for i in range(len(qs)):
        expect = "".join(ksw_ref_ops(qs[i], ts[i]))
        assert got[i] == expect, f"case {i}"


def test_dp_with_wildcards():
    qc = [0, 1, 2, 3, 0, 1]
    tc = [0, 1, 4, 3, 0, 1]   # N in target
    got = run_device([qc], [tc], 8)[0]
    expect = "".join(ksw_ref_ops(qc, tc))
    assert got == expect


def test_ops_to_alignment():
    # M D M I M over ref=ACGT qry=ATCT:
    # M:A/A, D:-/T, M:C/C, I:G/-, M:T/T
    ops = np.asarray([dp_ops.OP_M, dp_ops.OP_D, dp_ops.OP_M, dp_ops.OP_I,
                      dp_ops.OP_M], dtype=np.uint8)
    ref = np.frombuffer(b"ACGT", dtype=np.uint8).copy()
    qry = np.frombuffer(b"ATCT", dtype=np.uint8).copy()
    a1, a2 = dp_ops.ops_to_alignment(ops, ref, qry)
    assert a1.tobytes() == b"A-CGT"
    assert a2.tobytes() == b"ATC-T"


def test_pack2bit_roundtrip():
    rng = np.random.default_rng(0)
    ops = rng.integers(0, 4, (7, 64)).astype(np.uint8)
    packed = np.asarray(dp_ops._pack2bit(jnp.asarray(ops)))
    assert packed.shape == (7, 16)
    assert np.array_equal(dp_ops._unpack2bit_host(packed, 64), ops)


@pytest.mark.parametrize("L", [64, 128, 512])
def test_dp_bucket_width_matches_scalar_reference(L):
    """Related problems filling a bucket of width L (as chip_smoke.py
    checks them on the card) give the scalar reference's op codes."""
    from chip_smoke import dp_batch, dp_ops_string
    q, t, ql, tl = dp_batch(L, L // 2, 2, np.random.default_rng(L))
    ops = np.asarray(dp_ops.dp_align_batch(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql), jnp.asarray(tl), L))
    for i in range(2):
        assert dp_ops_string(ops[i]) == "".join(ksw_ref_ops(
            q[i, :ql[i]].tolist(), t[i, :tl[i]].tolist())), f"problem {i}"
