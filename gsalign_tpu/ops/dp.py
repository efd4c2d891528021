"""Batched global affine-gap alignment with traceback.

Re-implements the semantics of ksw2 `extz2_sse` + `ksw_backtrack`
(reference src/ksw2_alignment.cpp:25-249; scoring: match 1, mismatch -1,
gap open 2, extend 1, full band — src/ksw2_alignment.cpp:9,261) as a batched
anti-diagonal recurrence: one lax.scan step per anti-diagonal r, vectors over
the target axis, vmapped over the problem batch. With the full band the
reference's off/off_end forcing in the backtrack can never trigger, so the
traceback is a pure direction-byte walk, done on device in lockstep over the
batch so only the op codes (not the O(L^2) direction matrix) leave the chip.

The reference's int8 SSE difference recurrence never saturates for this
scoring (that is its design), so int32 arithmetic here reproduces it exactly;
the unsigned max in the reference operates on provably non-negative values.

Conventions follow ksw2: "query" Q = the reference-genome fragment (s1),
"target" T = the query-genome fragment (s2); op codes 0=M, 1=D (consumes T,
gap in Q row), 2=I (consumes Q, gap in T row), 3=pad.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

MATCH = 1
MISMATCH = -1
GAP_OPEN = 2      # q
GAP_EXTEND = 1    # e
QE = GAP_OPEN + GAP_EXTEND
QE2 = 2 * QE
MAX_SC = MATCH + QE2
WILDCARD = 4

OP_M, OP_D, OP_I, OP_PAD = 0, 1, 2, 3


def _dp_forward_batch(q_codes, t_codes, ql, tl, L):
    """Direction bytes for a batch. q/t int32 [B, L] (pad 4), ql/tl [B].

    The score row needs Q[r-t]: rather than gathering a reversed-query slice
    per problem per row (a vmapped dynamic_slice — catastrophically slow as
    an XLA gather), the Q-diagonal vector is carried in the scan state and
    shifted by one each anti-diagonal, inserting Q[:, r] at lane 0. Rows past
    a problem's last real anti-diagonal write garbage into its frozen band;
    nothing reads those cells (traceback stays within r <= ql+tl-2).

    All DP values are provably tiny for this scoring (the same bound the
    reference's int8 SSE kernel relies on): s in {-1,0,1}, z in [5,7],
    u,v in [-3,7], x,y in [0,5] — the carries are int8, quartering the
    loop-carried HBM traffic of the scan (5 planes rewritten per row).
    """
    i32 = jnp.int32
    i8 = jnp.int8
    B = q_codes.shape[0]
    n_rows = 2 * L - 1
    q_pad = jnp.concatenate(
        [q_codes, jnp.full((B, L), WILDCARD, i32)],
        axis=1).astype(i8)                                    # Q[:, r], r<2L
    t8 = t_codes.astype(i8)
    t_idx = jax.lax.broadcasted_iota(i32, (B, L), 1)

    def row(carry, r):
        u, v, x, y, qrr_prev = carry
        r_eff = jnp.minimum(r, ql + tl - 2)                   # [B]
        st0 = jnp.maximum(0, r_eff - ql + 1)
        en0 = jnp.minimum(r_eff, tl - 1)

        # boundary pre-sets at t = r_eff (top DP row), per problem
        in_top = (r_eff <= tl - 1)[:, None]
        at_r = t_idx == r_eff[:, None]
        u = jnp.where(in_top & at_r,
                      jnp.where(r_eff[:, None] > 0, i8(GAP_OPEN), i8(0)), u)
        y = jnp.where(in_top & at_r, i8(0), y)

        # qrr[t] = Q[r-t]: shift previous diagonal, insert Q[:, r] at t=0
        qcol = jax.lax.dynamic_slice_in_dim(q_pad, r, 1, axis=1)   # [B, 1]
        qrr = jnp.concatenate([qcol, qrr_prev[:, :-1]], axis=1)
        is_wild = (t8 >= i8(WILDCARD)) | (qrr >= i8(WILDCARD))
        s = jnp.where(is_wild, i8(0),
                      jnp.where(t8 == qrr, i8(MATCH), i8(MISMATCH)))

        # shifted previous-row values: xt1[t] = x[t-1], vt1[t] = v[t-1]
        x1 = jnp.zeros((B, 1), i8)
        v1 = jnp.where(r_eff[:, None] > 0, i8(GAP_OPEN), i8(0))
        xt1 = jnp.concatenate([x1, x[:, :-1]], axis=1)
        vt1 = jnp.concatenate([v1, v[:, :-1]], axis=1)

        z = s + i8(QE2)
        a = xt1 + vt1
        b = y + u
        d = jnp.where(a > z, jnp.uint8(1), jnp.uint8(0))
        z = jnp.maximum(z, a)
        d = jnp.where(b > z, jnp.uint8(2), d)
        z = jnp.maximum(z, b)
        z = jnp.minimum(z, i8(MAX_SC))
        u_new = z - vt1
        v_new = z - u
        z2 = z - i8(GAP_OPEN)
        a2 = a - z2
        b2 = b - z2
        x_new = jnp.maximum(a2, i8(0))
        y_new = jnp.maximum(b2, i8(0))
        d = d | jnp.where(a2 > i8(0), jnp.uint8(8), jnp.uint8(0))
        d = d | jnp.where(b2 > i8(0), jnp.uint8(0x10), jnp.uint8(0))

        in_band = (t_idx >= st0[:, None]) & (t_idx <= en0[:, None])
        u = jnp.where(in_band, u_new, u)
        v = jnp.where(in_band, v_new, v)
        x = jnp.where(in_band, x_new, x)
        y = jnp.where(in_band, y_new, y)
        d = jnp.where(in_band, d, jnp.uint8(0))
        return (u, v, x, y, qrr), d

    z0 = jnp.zeros((B, L), i8)
    qrr0 = jnp.full((B, L), WILDCARD, i8)
    # unroll: each anti-diagonal is a handful of small fused kernels whose
    # launch overhead dominates at these widths; unrolling amortizes the
    # per-step dispatch across 8 rows
    (_, _, _, _, _), d_rows = jax.lax.scan(
        row, (z0, z0, z0, z0, qrr0), jnp.arange(n_rows, dtype=i32),
        unroll=8)
    return d_rows   # uint8 [2L-1, B, L]


def _dp_forward_single(q_codes, t_codes, ql, tl, L):
    """Single-problem wrapper (kept for tests)."""
    d = _dp_forward_batch(q_codes[None], t_codes[None], ql[None]
                          if hasattr(ql, "shape") else jnp.asarray([ql]),
                          tl[None] if hasattr(tl, "shape")
                          else jnp.asarray([tl]), L)
    return d[:, 0, :]


def _traceback_batch(d_rows, ql, tl, L):
    """ksw_backtrack (src/ksw2_alignment.cpp:25-68), full band: no forcing.

    A reverse lax.scan over anti-diagonals: step r consumes direction row
    d_rows[r] ([B, L], fed as scan xs — no gather at all) and every lane
    whose current cell sits on anti-diagonal r (i + j == r) emits one op
    and steps back (an M consumes two anti-diagonals, so the lane idles
    the next step). Per-lane dynamic indexing into the [2L-1, B, L] cube
    — the previous formulation — made every traceback step re-read the
    WHOLE cube.

    Emits ops from the alignment END backwards with OP_PAD on idle steps;
    the host strips pads and reverses.
    """
    i32 = jnp.int32
    B = ql.shape[0]
    iota = jax.lax.broadcasted_iota(i32, (B, L), 1)

    def step(carry, xs):
        i, j, state = carry
        r, d_row = xs                                         # [], [B, L]
        both = (i >= 0) & (j >= 0)
        act = (i + j == r)
        # one-hot column select (a per-lane take is a scalar gather)
        tmp = jnp.sum(jnp.where(iota == jnp.clip(i, 0, L - 1)[:, None],
                                d_row, jnp.uint8(0)),
                      axis=1, dtype=i32)
        tmp = jnp.where(both, tmp, 0)
        s1 = jnp.where(state == 0, tmp & 7,
                       jnp.where(((tmp >> (state + 2)) & 1) == 0, 0, state))
        s2 = jnp.where(s1 == 0, tmp & 7, s1)
        is_m = s2 == 0
        is_d = (s2 == 1) | (s2 == 3)
        op_main = jnp.where(is_m, OP_M, jnp.where(is_d, OP_D, OP_I))
        op_tail = jnp.where(i >= 0, OP_D, jnp.where(j >= 0, OP_I, OP_PAD))
        op = jnp.where(act, jnp.where(both, op_main, op_tail), OP_PAD)
        di = jnp.where(both, jnp.where(is_m | is_d, 1, 0),
                       jnp.where(i >= 0, 1, 0))
        dj = jnp.where(both, jnp.where(is_m | ~is_d, 1, 0),
                       jnp.where((i < 0) & (j >= 0), 1, 0))
        new_i = jnp.where(act, i - di, i)
        new_j = jnp.where(act, j - dj, j)
        new_state = jnp.where(act & both, s2, state)
        return (new_i, new_j, new_state), op.astype(jnp.uint8)

    # one extra step at r = -1: a leading-gap tail op fires there when the
    # other sequence is already exhausted ((i, j) = (0, -1) or (-1, 0));
    # its d_row is a dummy (tail ops never read direction bytes)
    rs = jnp.arange(2 * L - 2, -2, -1, dtype=i32)
    d_rev = jnp.concatenate([d_rows[::-1], d_rows[:1]], axis=0)
    (_, _, _), ops = jax.lax.scan(
        step, (tl - 1, ql - 1, jnp.zeros(B, i32)),
        (rs, d_rev), unroll=8)
    return ops.T  # uint8 [B, 2L]: reverse-order ops, OP_PAD holes/tail


@partial(jax.jit, static_argnames=("L",))
def dp_align_batch(q_codes: jnp.ndarray,   # int32 [B, L] ref fragments (pad 4)
                   t_codes: jnp.ndarray,   # int32 [B, L] qry fragments (pad 4)
                   ql: jnp.ndarray,        # int32 [B]
                   tl: jnp.ndarray,        # int32 [B]
                   L: int) -> jnp.ndarray:
    """Returns reverse-order op codes uint8 [B, 2L-1] (OP_PAD holes/tail).

    Codes may arrive int8 (align_fragments uploads 1 byte/base and widens
    on device)."""
    q_codes = q_codes.astype(jnp.int32)
    t_codes = t_codes.astype(jnp.int32)
    d_all = _dp_forward_batch(q_codes, t_codes, ql, tl, L)   # [2L-1, B, L]
    return _traceback_batch(d_all, ql, tl, L)


@jax.jit
def _pack2bit(ops: jnp.ndarray) -> jnp.ndarray:
    """Pack op codes (2 bits each: M/D/I/PAD) 4-per-byte on device before
    the host fetch, a quarter of the bytes to move. Width must be a
    multiple of 4 (all bucket widths are)."""
    o = ops.astype(jnp.uint8)
    B, W = o.shape
    o4 = o.reshape(B, W // 4, 4)
    return (o4[:, :, 0] | (o4[:, :, 1] << jnp.uint8(2))
            | (o4[:, :, 2] << jnp.uint8(4)) | (o4[:, :, 3] << jnp.uint8(6)))


def _unpack2bit_host(packed: np.ndarray, width: int) -> np.ndarray:
    """Host-side inverse of _pack2bit: [B, W/4] uint8 -> [B, W] uint8."""
    x = (packed[:, :, None] >> np.asarray([0, 2, 4, 6], np.uint8)) \
        & np.uint8(3)
    return x.reshape(packed.shape[0], width)


class FragmentAligner:
    """Incremental fragment DP: submit per-chromosome fragment batches as
    the host plans them, collect all results with ONE device->host fetch.

    Problems bucket by max(len) into padded batches exactly like the
    one-shot align_fragments; a bucket DISPATCHES (async, sub-ms enqueue)
    as soon as it holds a full batch, so the DP device work and its
    uploads run BEHIND the host's chain stage for the next chromosome
    instead of serializing after it (the reference overlaps these with
    pthreads, src/GSAlign.cpp:492-526). Leftover partial buckets pool
    across submits and dispatch at finish() -- cross-chromosome batch
    packing is preserved for them. Results are independent of packing
    (each DP problem is its own lane), so outputs are byte-identical to
    the one-shot path for any submit() split.
    """

    def __init__(self, bucket_sizes=(64, 128, 256, 512, 1024, 2048, 5120),
                 batch_cells: int = 1 << 26, dp_fn=None, mesh=None):
        self.bucket_sizes = bucket_sizes
        self.batch_cells = batch_cells
        self.dp_fn = dp_align_batch if dp_fn is None else dp_fn
        self.mesh = mesh
        self.frags: list = []          # (rf, qf) by global index
        self.queue: dict = {}          # Lb -> [global index]
        self.pending: list = []        # (part_idxs, device_ops)

    def submit(self, ref_frags, qry_frags) -> int:
        """Queue fragments; returns the base global index of this batch.
        Full buckets dispatch immediately (async)."""
        base = len(self.frags)
        for rf, qf in zip(ref_frags, qry_frags):
            i = len(self.frags)
            self.frags.append((rf, qf))
            m = max(len(rf), len(qf))
            for Lb in self.bucket_sizes:
                if m <= Lb:
                    break
            else:
                Lb = int(np.ceil(m / 1024) * 1024)
            q = self.queue.setdefault(Lb, [])
            q.append(i)
            if len(q) >= max(1, self.batch_cells // (Lb * Lb)):
                self._dispatch(Lb, q)
                self.queue[Lb] = []
        return base

    def _dispatch(self, Lb, part):
        # pad the batch to a power of two so compiled shapes are reused
        B = 8
        while B < len(part):
            B *= 2
        if self.mesh is not None:
            from gsalign_tpu.parallel import mesh as mesh_lib
            B = mesh_lib.pad_to_multiple(B, self.mesh.devices.size)
        # int8 on the wire (the kernels widen on device): 1 byte/base
        q = np.full((B, Lb), WILDCARD, dtype=np.int8)
        t = np.full((B, Lb), WILDCARD, dtype=np.int8)
        ql = np.ones(B, dtype=np.int32)
        tl = np.ones(B, dtype=np.int32)
        for bi, i in enumerate(part):
            rf, qf = self.frags[i]
            q[bi, :len(rf)] = rf
            t[bi, :len(qf)] = qf
            ql[bi] = len(rf)
            tl[bi] = len(qf)
        if self.mesh is not None:
            from gsalign_tpu.parallel import mesh as mesh_lib
            args = (mesh_lib.shard_lanes(q, self.mesh, WILDCARD),
                    mesh_lib.shard_lanes(t, self.mesh, WILDCARD),
                    mesh_lib.shard_lanes(ql, self.mesh, 1),
                    mesh_lib.shard_lanes(tl, self.mesh, 1))
        else:
            args = (jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql),
                    jnp.asarray(tl))
        dev_ops = self.dp_fn(*args, Lb)
        # ship 2-bit-packed to the host
        self.pending.append((list(part), _pack2bit(dev_ops),
                             int(dev_ops.shape[1])))

    def finish(self) -> list:
        """Dispatch leftovers, fetch everything in ONE device->host
        transfer, and return per-pair FORWARD-order op arrays by submit
        order."""
        for Lb, part in sorted(self.queue.items()):
            mb = max(1, self.batch_cells // (Lb * Lb))
            for s in range(0, len(part), mb):
                self._dispatch(Lb, part[s:s + mb])
        self.queue = {}
        import os
        if os.environ.get("GSALIGN_DP_STATS"):
            import collections
            hist = collections.Counter()
            cells = collections.Counter()
            for rf, qf in self.frags:
                m = max(len(rf), len(qf))
                for Lb in self.bucket_sizes:
                    if m <= Lb:
                        break
                else:
                    Lb = int(np.ceil(m / 1024) * 1024)
                hist[Lb] += 1
                cells[Lb] += Lb * Lb
            import sys
            print("[dp_stats] " + " ".join(
                f"L{Lb}:n={hist[Lb]},Mcells={cells[Lb]/1e6:.0f}"
                for Lb in sorted(hist)), file=sys.stderr)
        results: list = [None] * len(self.frags)
        if not self.pending:
            return results
        flat = (jnp.concatenate([d.reshape(-1) for _, d, _ in self.pending])
                if len(self.pending) > 1
                else self.pending[0][1].reshape(-1))
        # queue the host copy behind the compute so np.asarray waits on
        # in-flight data instead of starting its own transfer
        flat.copy_to_host_async()
        flat_h = np.asarray(flat)
        off = 0
        for part, dev_ops, w in self.pending:
            bp = dev_ops.shape[0]
            wp = w // 4
            ops = _unpack2bit_host(
                flat_h[off:off + bp * wp].reshape(bp, wp), w)
            off += bp * wp
            # strip pads + reverse for the whole batch at once (a
            # per-problem python loop was ~40% of finish() at 100 Mb):
            # reversing first keeps the flat extraction in forward order
            rev = ops[:, ::-1]
            keep = rev != OP_PAD
            flat_ops = rev[keep]
            ends = np.cumsum(keep.sum(axis=1))
            lo = 0
            for bi, i in enumerate(part):
                hi = int(ends[bi])
                results[i] = flat_ops[lo:hi]
                lo = hi
        self.pending = []
        return results


def align_fragments(ref_frags, qry_frags, bucket_sizes=(64, 128, 256, 512,
                                                        1024, 2048, 5120),
                    batch_cells: int = 1 << 26,
                    dp_fn=None, mesh=None) -> list:
    """Align a list of (ref_codes, qry_codes) numpy fragment pairs.

    One-shot wrapper over FragmentAligner: buckets problems by max(len)
    into padded batches, runs the device kernel per bucket, returns
    per-pair op lists in FORWARD order (list of numpy uint8 arrays of
    {OP_M, OP_D, OP_I}). With a mesh, each batch's problem axis is
    sharded over the "frag" devices.
    """
    fa = FragmentAligner(bucket_sizes=bucket_sizes, batch_cells=batch_cells,
                         dp_fn=dp_fn, mesh=mesh)
    fa.submit(ref_frags, qry_frags)
    return fa.finish()


def ops_to_alignment(ops: np.ndarray, ref_chars: np.ndarray,
                     qry_chars: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Expand forward-order ops into gapped aligned rows (ASCII uint8).

    Mirrors the gap-insertion loop of ksw2_alignment
    (src/ksw2_alignment.cpp:264-272): OP_D puts '-' in the ref row,
    OP_I puts '-' in the qry row.
    """
    n = len(ops)
    a1 = np.empty(n, dtype=np.uint8)
    a2 = np.empty(n, dtype=np.uint8)
    take_ref = ops != OP_D        # M and I consume ref chars
    take_qry = ops != OP_I        # M and D consume qry chars
    ref_idx = np.cumsum(take_ref) - 1
    qry_idx = np.cumsum(take_qry) - 1
    a1 = np.where(take_ref, ref_chars[np.maximum(ref_idx, 0)], ord("-")).astype(np.uint8)
    a2 = np.where(take_qry, qry_chars[np.maximum(qry_idx, 0)], ord("-")).astype(np.uint8)
    return a1, a2
