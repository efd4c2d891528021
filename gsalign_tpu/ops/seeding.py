"""Batched LMEM seeding.

The reference walks each 10 kb query chunk sequentially, extending an exact
match through the FM-index one base at a time and restarting after each
emitted seed (src/GSAlign.cpp:51-107, src/bwt_search.cpp:141-185). Chunks are
mutually independent (extension is clipped at the chunk boundary:
BWT_Search's `stop`), so chunks become device lanes here: every lane runs the
same one-base state machine per iteration of a lax.while_loop, and a batched
occ4 pair serves all lanes at once.

Lane state machine (exact emulation of IdentifyLocalMEM + BWT_Search):
  INIT: read code[cursor]; ambiguous -> cursor+1; else start extension.
  EXT:  extend by one base; on boundary/ambiguous/dead-end finalize:
        len = ext_pos - ext_start;
        hit iff len >= min_seed_length and 0 < freq <= max_seed_freq;
        hit  -> emit (qPos, len, rank_start, freq); cursor = ext_start +
                (sensitive ? 5 : len+1)
        miss -> cursor = ext_start + 1.
Lane done when cursor >= stop in INIT phase.

Speed (three stacked shortcuts, all exactly seed-set-preserving):
  INIT-8:  the interval of the first EIGHT appended bases is a direct
           c8 table row (rank.DeviceFMIndex.comb_pairs) — zero rank queries;
           an empty row proves the local match is < 8 < MinSeedLength,
           i.e. a miss with the same +1 advance the reference takes.
  Triples: interval steps consume THREE bases per rank query through the
           order-3 table (ops/rank.occ_t3) whenever three unambiguous
           in-chunk bases remain. Single-base steps take over near
           boundaries, at ambiguous bases, and after a triple miss (every
           intermediate interval a triple skips is uniquely determined,
           and the death position is re-found by the single steps).
  Direct:  once the interval is UNIQUE (ik2 == 1; full-SA indexes only),
           the lane resolves its single occurrence (one SA gather) and
           extends by comparing 256 query bases against the packed text
           per iteration — the longest-common-extension of a unique match
           needs no rank machinery at all, and the occurrence position is
           already known, so the hit records a pre-resolved position
           (k0 < 0 encodes it) instead of a rank.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gsalign_tpu.ops import rank as rank_ops
from gsalign_tpu.ops.rank import DeviceFMIndex

PHASE_INIT = 0
PHASE_EXT = 1


POISON_NONE = 0x7FFFFFFF


@jax.jit
def _build_qrows(qcodes: jnp.ndarray) -> jnp.ndarray:
    """Overlapping 512-base query windows at stride 256 for the direct-
    extension comparator: row r = [32 packed 2-bit code words | 32 words of
    the ambiguity plane] covering bases [256r, 256r+512). The ambiguity
    plane mirrors the packing but stores (code >= 4) in each 2-bit field's
    LOW bit, so it ORs straight into the mismatch vector."""
    u32 = jnp.uint32
    L = qcodes.shape[0]
    R = -(-L // 256)
    pad = (R + 1) * 256 - L
    q = jnp.concatenate([qcodes,
                         jnp.full(pad, 4, jnp.uint8)]).astype(u32)
    sh = (15 - jnp.arange(16, dtype=u32)) * u32(2)

    def packw(v):
        return jnp.sum(v.reshape(-1, 16) << sh[None, :], axis=1, dtype=u32)

    pk = packw(jnp.minimum(q, u32(3))).reshape(R + 1, 16)
    am = packw((q >= u32(4)).astype(u32)).reshape(R + 1, 16)
    return jnp.concatenate([pk[:-1], pk[1:], am[:-1], am[1:]], axis=1)


def _roll16(rows: jnp.ndarray, ow: jnp.ndarray) -> jnp.ndarray:
    """Rotate each [B, 32]-word lane LEFT by ow in [0, 16) words. A 4-stage
    barrel shifter of static rolls + selects: pure elementwise work. (The
    obvious take_along_axis with [B, 17] indices lowers to a per-ELEMENT
    gather.)"""
    out = rows
    for bit in (8, 4, 2, 1):
        out = jnp.where((ow[:, None] & bit) > 0,
                        jnp.roll(out, -bit, axis=1), out)
    return out


def _extract256(rows: jnp.ndarray, off: jnp.ndarray) -> jnp.ndarray:
    """Extract 16 aligned words (256 bases) from [B, 32]-word windows
    starting at 2-bit-field offset `off` (0..255): barrel-shift word
    alignment + per-lane bit funnel."""
    i32 = jnp.int32
    u32 = jnp.uint32
    ow = (off >> 4).astype(i32)                              # word offset
    sh = ((off & 15) << 1).astype(u32)                       # bit shift
    w = _roll16(rows, ow)                                    # [B, 32]
    hi = w[:, :16] << sh[:, None]
    lo = jnp.where(sh[:, None] > 0,
                   w[:, 1:17] >> (u32(32) - sh[:, None]), u32(0))
    return hi | lo                                           # [B, 16]


def _meta16(qrow: jnp.ndarray, off: jnp.ndarray):
    """Decode scan metadata for the 16 bases starting at 2-bit-field offset
    `off` (0..255) of [B, 64]-word query windows (pk plane | amb plane):
    returns (cls12, real3, b1ok, real8, amb_word) — amb_word carries the
    raw ambiguity bits so the caller can test any INIT order.

    cls12 is the 12-mer class of bases (p .. p+11): (3 - base) in ASCENDING
    2-bit fields (fmindex._build_c12 key of the RC 12-mer; the shorter
    classes nest as cls8 = cls12 & 0xFFFF, cls3 = cls12 & 63, cls1 =
    cls12 & 3). The packed window stores base j of the window at
    DESCENDING bits (30-2j), so cls12 is a 2-bit-field reversal of the
    complemented word — pure elementwise work, which is the point: it
    replaces a u32-per-position poslut table (400 MB at 100 Mb query
    scale) that every scan iteration gathered from."""
    i32 = jnp.int32
    u32 = jnp.uint32
    ow = (off >> 4).astype(i32)                              # word offset
    sh = ((off & 15) << 1).astype(u32)                       # bit shift
    pk = _roll16(qrow[:, :32], ow)
    am = _roll16(qrow[:, 32:], ow)
    w = (pk[:, 0] << sh) | jnp.where(sh > 0,
                                     pk[:, 1] >> (u32(32) - sh), u32(0))
    a = (am[:, 0] << sh) | jnp.where(sh > 0,
                                     am[:, 1] >> (u32(32) - sh), u32(0))
    v = ~w                                   # 3 - base, per 2-bit field
    r = ((v << u32(2)) & u32(0xCCCCCCCC)) | ((v >> u32(2))
                                             & u32(0x33333333))
    r = ((r << u32(4)) & u32(0xF0F0F0F0)) | ((r >> u32(4))
                                             & u32(0x0F0F0F0F))
    r = ((r << u32(8)) & u32(0xFF00FF00)) | ((r >> u32(8))
                                             & u32(0x00FF00FF))
    r = (r << u32(16)) | (r >> u32(16))
    cls12 = (r & u32(0xFFFFFF)).astype(i32)
    real8 = (a & u32(0xFFFF0000)) == 0
    real3 = (a & u32(0xFC000000)) == 0
    b1ok = (a & u32(0xC0000000)) == 0
    return cls12, real3, b1ok, real8, a


def _seed_scan_impl(dfm: DeviceFMIndex,
               q_rows: jnp.ndarray,      # uint32 [n_qrow, 64] (_build_qrows)
               starts: jnp.ndarray,      # int32 [B]
               emit_stops: jnp.ndarray,  # int32 [B] stop recording starts here
               ext_stops: jnp.ndarray,   # int32 [B] extension clip (may be
                                         # an artificial seg_end+slack bound)
               hard_stops: jnp.ndarray,  # int32 [B] the REAL chunk end
               min_seed_length: int,
               max_seed_freq: int,
               sensitive: bool,
               max_out: int,
               init12: bool = True,
               sa_mode: str = "comb"):
    # sa_mode: how direct-mode lanes resolve their unique occurrence.
    #   "xla"           plain whole-B XLA gather on sa_rows (default)
    #   "xlak"          entry lanes compact into K slots, ONE K-index
    #                   gather on sa_rows (A/B; one-hot cost > savings)
    #   "none"          index is not direct-capable
    B = starts.shape[0]
    i32 = jnp.int32
    u32 = jnp.uint32
    rdt = dfm.rdtype
    assert min_seed_length > 3, "triple-step shortcuts assume min_seed > 3"
    # INIT-8 is only emission-exact when any sub-8 match is a guaranteed
    # miss; direct extension needs a one-gather SA and int32 positions
    use8 = min_seed_length > 8
    order = dfm.init_order            # INIT jump length (10 or 12, static)
    use_init = min_seed_length > order and init12
    direct = dfm.direct_ok
    n_sa = dfm.seq_len + 1 if direct else dfm.sa_samples.shape[0]
    n_qrow = q_rows.shape[0]
    seq_len = dfm.seq_len

    init_state = dict(
        phase=jnp.zeros(B, i32),
        cursor=starts.astype(i32),
        ext_start=jnp.zeros(B, i32),
        ext_pos=jnp.zeros(B, i32),
        ik1=jnp.zeros(B, rdt), ik2=jnp.zeros(B, rdt),
        tri_failed=jnp.zeros(B, jnp.bool_),
        dir_set=jnp.zeros(B, jnp.bool_),
        dir_off=jnp.zeros(B, i32),
        # Emit planes, packed to the fewest bytes that round-trip: EVERY
        # loop-carried byte is rewritten EVERY iteration, so emit cost is
        # proportional to buffer bytes. (qpos_rel | len<<16) in one u32
        # plane, freq in an int8 plane, k0 in an rdtype plane; max_out is
        # capped and overflow poisons the lane for a host re-scan (see
        # find_seeds_all).
        out_meta=jnp.zeros((B, max_out), jnp.uint32),
        out_k0=jnp.zeros((B, max_out), rdt),
        out_fr=jnp.zeros((B, max_out), jnp.int8),
        out_n=jnp.zeros(B, i32),
        poison=jnp.full(B, POISON_NONE, i32),
        finish_iter=jnp.zeros(B, i32),   # diagnostics: lane completion iter
        # scalar live-lane counter (padded lanes are born done)
        n_active=jnp.sum(starts.astype(i32) < emit_stops, dtype=i32),
        n_iter=jnp.zeros((), i32),
    )

    def lane_done(cur_phase, cur_cursor):
        return (cur_phase == PHASE_INIT) & (cur_cursor >= emit_stops)

    def cond(s):
        # scalar counter (maintained in the body, where the reduction fuses
        # with other work) instead of a standalone all-lane reduce kernel
        return s["n_active"] > 0

    def body(s):
        phase, cursor = s["phase"], s["cursor"]
        ext_start, ext_pos = s["ext_start"], s["ext_pos"]
        ik1, ik2 = s["ik1"], s["ik2"]
        tri_failed = s["tri_failed"]
        poison = s["poison"]

        in_init = (phase == PHASE_INIT) & (cursor < emit_stops)
        in_ext = phase == PHASE_EXT
        if direct:
            in_dir = in_ext & (ik2 == 1)
        else:
            in_dir = jnp.zeros(B, jnp.bool_)
        iv_ext = in_ext & ~in_dir

        # one shared metadata fetch: INIT lanes look at `cursor`, EXT at
        # `ext_pos`. The lane's packed query window row is gathered and
        # the 12-mer class decoded elementwise (_meta16) — the direct-
        # extension comparator's query window rides the SAME gather call.
        # The class fields then key ONE gather into the combined pair
        # table with TWO selected indices per lane — a lane is in exactly
        # one of {INIT-12/8/3/1, EXT-triple, EXT-single, DIRECT}, so it
        # needs only ITS class's (lo, sz) pair.
        look = jnp.where(in_ext, ext_pos, cursor)
        look_safe = jnp.clip(look, 0, n_qrow * 256 - 1)
        # the direct comparator reads the row at ext_pos — but every EXT
        # lane (direct included) has look == ext_pos, so the metadata
        # gather's row IS the comparator's row: one B-index gather, not 2B
        q_cmp = look_safe                                # direct compare pos
        qrows1 = q_rows[look_safe >> 8]
        cls12, real3, b1ok, real8, amb_w = _meta16(qrows1,
                                                   look_safe & 255)
        cls_init = cls12 & ((1 << (2 * order)) - 1)
        cls8 = cls12 & 0xFFFF
        cls3 = cls12 & 63       # k-mer class prefixes nest (_meta16)
        cls1 = cls12 & 3
        half = i32(65536 + 136)
        real_init = (amb_w &
                     u32((0xFFFFFFFF << (32 - 2 * order))
                         & 0xFFFFFFFF)) == 0

        # ---- INIT class choice ----
        init_amb = ~b1ok
        # INIT-order/INIT-8: jump `order` (8) bases via the init (c8)
        # table; a dead k-mer can only be a miss (len < k < min_seed),
        # advancing the cursor by one — exactly the single-step outcome.
        # INIT-3 likewise via the C64 range.
        if use_init:
            init_can12 = b1ok & real_init & (cursor + (order - 1)
                                             < ext_stops)
        else:
            init_can12 = jnp.zeros(B, jnp.bool_)
        if use8:
            init_can8 = b1ok & real8 & (cursor + 7 < ext_stops) \
                & ~init_can12
        else:
            init_can8 = jnp.zeros(B, jnp.bool_)
        init_can3 = b1ok & real3 & (cursor + 2 < ext_stops) \
            & ~init_can8 & ~init_can12

        # ---- EXT class choice: triple (3 bases) when possible, else 1 ----
        can3 = iv_ext & (ext_pos + 2 < ext_stops) & real3 & ~tri_failed
        cls = jnp.where(can3, cls3, cls1)

        # class-table row selection; sz semantics: the INIT-order rows
        # carry starts[g+1], so sz is starts[g+1] - starts[g] minus the
        # <= order short-suffix step keys; every other row carries sz
        i3_lo_idx = 65536 + cls3
        i1_lo_idx = 65536 + 64 + (3 - cls1)
        init_lo_idx = jnp.where(
            init_can12, (rank_ops.INIT_OFF_WIDE if dfm.wide
                         else rank_ops.INIT_OFF) + cls_init,
            jnp.where(init_can8, cls8,
                      jnp.where(init_can3, i3_lo_idx, i1_lo_idx)))
        ext_lo_idx = jnp.where(can3, i3_lo_idx, i1_lo_idx)
        idx_a = jnp.where(in_init, init_lo_idx, ext_lo_idx)
        if dfm.wide:
            # flattened lo/sz planes: two selected indices per lane
            init_sz_idx = jnp.where(init_can12, i32(1), half) + init_lo_idx
            idx_b = jnp.where(in_init, init_sz_idx, idx_a)
            vals = dfm.comb_pairs[jnp.concatenate([idx_a, idx_b])]
            sel_a = vals[:B].astype(rdt)
            sel_b = vals[B:].astype(rdt)
        else:
            # packed (lo | sz << 32) rows: ONE gather, ONE index per lane
            v = dfm.comb_pairs[idx_a]
            sel_a = (v & jnp.int64(0xFFFFFFFF)).astype(rdt)
            sel_b = (v >> jnp.int64(32)).astype(rdt)
        corr_n = jnp.sum(cls_init[:, None] == dfm.init_corr[None, :],
                         axis=1, dtype=i32)
        init_sz = jnp.where(init_can12,
                            sel_b - sel_a - corr_n.astype(sel_b.dtype),
                            sel_b)

        # ---- INIT step ----
        init_dead = in_init & (init_can12 | init_can8 | init_can3) \
            & (init_sz == 0)
        start_ext = in_init & b1ok & ~init_dead
        init_jump = jnp.where(init_can12, i32(order),
                              jnp.where(init_can8, i32(8),
                                        jnp.where(init_can3, i32(3),
                                                  i32(1))))

        cnt = rank_ops.occ_t3(
            dfm, jnp.concatenate([ik1, ik1 + ik2]),
            jnp.concatenate([can3, can3]),
            jnp.concatenate([cls, cls]))
        tk, tl = cnt[:B], cnt[B:]
        e_ik1 = sel_a + tk
        e_ik2 = tl - tk

        # interval-path termination (only reachable when can3 is False)
        hit_boundary = ext_pos >= ext_stops
        hit_amb = ~b1ok
        dead_end = (e_ik2 == 0) & ~can3
        fin_iv = iv_ext & (hit_boundary | hit_amb | dead_end)
        tri_miss = iv_ext & can3 & (e_ik2 == 0)
        ext_ok = iv_ext & ~fin_iv & ~tri_miss

        # ---- DIRECT step: unique-interval lanes compare text to query ----
        if direct:
            sl = i32(seq_len)
            need = in_dir & ~s["dir_set"]     # lanes resolving their SA now
            if sa_mode == "xlak":
                # K-compacted plain XLA gather on the standalone SA plane:
                # only the handful of lanes ENTERING direct mode this
                # iteration contribute indices, so the O(n) plane costs
                # K-index latency instead of a 2B-index ride-along sweep.
                # Overflow lanes stall one iteration and retry.
                K = min(_SA_GATHER_K, B)
                posn = jnp.cumsum(need.astype(i32)) - 1          # [B]
                slot = jnp.where(need & (posn < K), posn, -1)
                hotK = slot[:, None] == jnp.arange(K, dtype=i32)[None, :]
                ikc = jnp.clip(ik1, 0, n_sa - 1).astype(i32)
                idxK = jnp.sum(jnp.where(hotK, ikc[:, None], 0),
                               axis=0, dtype=i32)
                resK = dfm.sa_rows[idxK]
                enter = need & (slot >= 0)
                rc_pos = resK[jnp.clip(posn, 0, K - 1)]
            else:                                 # "xla"
                rc_pos = dfm.sa_rows[jnp.clip(ik1, 0, n_sa - 1)
                                     .astype(i32)]
                enter = need
            in_dir_eff = in_dir & (s["dir_set"] | enter)
            dir_off = jnp.where(enter,
                                sl - rc_pos - ext_pos, s["dir_off"])
            p = dir_off + ext_pos                 # text pos of next compare
            q = ext_pos
            p_safe = jnp.clip(p, 0, seq_len - 1)
            q_safe = q_cmp
            # text_rows packs 4 consecutive 512-base windows per table
            # row (contiguous 128-word gather; see rank.from_host) —
            # select this position's 32-word window elementwise
            jrow = p_safe >> 8
            trow4 = dfm.text_rows[jrow >> 2]                  # [B, 128]
            sub = (jrow & 3)[:, None]
            trow = jnp.where(sub == 1, trow4[:, 32:64], trow4[:, 0:32])
            trow = jnp.where(sub == 2, trow4[:, 64:96], trow)
            trow = jnp.where(sub == 3, trow4[:, 96:128], trow)
            qrow = qrows1          # [B, 64] — IS the metadata gather's row
            tw = _extract256(trow, p_safe & 255)
            qw = _extract256(qrow[:, :32], q_safe & 255)
            aw = _extract256(qrow[:, 32:], q_safe & 255)
            x = tw ^ qw
            mm = ((x | (x >> u32(1))) & u32(0x55555555)) | aw  # [B, 16]
            # first mismatch = min over words of 16j + clz/2 (zero words
            # masked out); 256 when the whole window matches. Arithmetic,
            # no argmax + per-lane take (a per-lane scalar gather).
            clzs = jax.lax.clz(mm.astype(i32)) >> 1           # [B, 16]
            j16 = jnp.arange(16, dtype=i32)[None, :] * 16
            cand = jnp.where(mm == 0, 4096, j16 + clzs)
            run = jnp.minimum(jnp.min(cand, axis=1), 256)
            lim_q = ext_stops - q
            lim_t = sl - p
            limit = jnp.minimum(jnp.minimum(lim_q, lim_t), 256)
            adv = jnp.minimum(run, jnp.maximum(limit, 0))
            reach = run >= limit
            # boundary (checked first, like the interval path) > text-end
            # dead-end > plain continue at a full 256-base window
            bound_dir = reach & (lim_q <= jnp.minimum(lim_t, 256))
            tdead_dir = reach & ~bound_dir & (lim_t <= 256)
            cont_dir = reach & ~bound_dir & ~tdead_dir
            fin_dir = in_dir_eff & (~reach | bound_dir | tdead_dir)
            dir_adv = in_dir_eff & cont_dir
            dir_ext_pos = ext_pos + adv
        else:
            dir_off = s["dir_off"]
            in_dir_eff = in_dir
            fin_dir = jnp.zeros(B, jnp.bool_)
            dir_adv = jnp.zeros(B, jnp.bool_)
            bound_dir = jnp.zeros(B, jnp.bool_)
            dir_ext_pos = ext_pos

        # ---- finalize ----
        finalize = fin_iv | fin_dir
        eff_ext_pos = jnp.where(in_dir, dir_ext_pos, ext_pos)
        length = eff_ext_pos - ext_start
        freq = ik2
        is_hit = finalize & (length >= min_seed_length) & (freq > 0) & \
            (freq <= max_seed_freq)
        advance = jnp.where(
            is_hit,
            ext_start + (5 if sensitive else 0) +
            (0 if sensitive else 1) * (length + 1),
            ext_start + 1)
        # an extension clipped by an ARTIFICIAL boundary (speculative
        # segment bound, not the chunk end) poisons the lane, as does a
        # FULL emit buffer: everything from this start position on is
        # unknowable/unrecordable and the lane retires (the host re-scans
        # from the poison position with the real clip / a fresh buffer)
        hb_eff = jnp.where(in_dir, bound_dir, hit_boundary)
        overflow = is_hit & (s["out_n"] >= max_out)
        poisoned_now = (finalize & hb_eff & (ext_stops < hard_stops)) \
            | overflow

        # emit into per-lane buffers with a one-hot select over the packed
        # planes rather than a per-lane scatter.
        slot = jnp.minimum(s["out_n"], max_out - 1)
        do_emit = is_hit & ~overflow
        # direct hits already know their occurrence: k0 < 0 encodes the
        # resolved text position -(r_start+1) instead of a rank
        k0val = ik1
        if direct:
            k0val = jnp.where(in_dir,
                              (-(dir_off + ext_start) - 1).astype(rdt), ik1)
        meta_rec = ((ext_start - starts).astype(u32)
                    | (length.astype(u32) << 16))
        fr_rec = jnp.minimum(freq, max_seed_freq + 1).astype(jnp.int8)
        hot = (jnp.arange(max_out, dtype=i32)[None, :] == slot[:, None]) \
            & do_emit[:, None]                                   # [B, max_out]
        out_meta = jnp.where(hot, meta_rec[:, None], s["out_meta"])
        out_k0 = jnp.where(hot, k0val[:, None], s["out_k0"])
        out_fr = jnp.where(hot, fr_rec[:, None], s["out_fr"])
        out_n = s["out_n"] + do_emit.astype(i32)

        # ---- state updates ----
        step = jnp.where(can3, 3, 1)
        new_phase = jnp.where(start_ext, PHASE_EXT,
                              jnp.where(finalize, PHASE_INIT, phase))
        new_cursor = jnp.where(
            poisoned_now, emit_stops,
            jnp.where((in_init & init_amb) | init_dead,
                      cursor + 1,
                      jnp.where(finalize, advance, cursor)))
        new_poison = jnp.where(poisoned_now & (poison == POISON_NONE),
                               ext_start, poison)
        new_ext_start = jnp.where(start_ext, cursor, ext_start)
        new_ext_pos = jnp.where(
            start_ext, cursor + init_jump,
            jnp.where(ext_ok, ext_pos + step,
                      jnp.where(dir_adv, dir_ext_pos, ext_pos)))
        new_ik1 = jnp.where(start_ext, sel_a,
                            jnp.where(ext_ok, e_ik1, ik1))
        new_ik2 = jnp.where(start_ext, init_sz,
                            jnp.where(ext_ok, e_ik2, ik2))
        new_tf = jnp.where(start_ext | finalize, False,
                           jnp.where(tri_miss, True,
                                     jnp.where(ext_ok, False, tri_failed)))
        new_dir_set = jnp.where(start_ext | finalize, False,
                                in_dir_eff | s["dir_set"])

        was_done = lane_done(phase, cursor)
        now_done = lane_done(new_phase, new_cursor)
        n_active = s["n_active"] - jnp.sum(now_done & ~was_done,
                                           dtype=i32)
        finish_iter = jnp.where(now_done & ~was_done, s["n_iter"] + 1,
                                s["finish_iter"])
        return dict(
            phase=new_phase, cursor=new_cursor,
            ext_start=new_ext_start, ext_pos=new_ext_pos,
            ik1=new_ik1, ik2=new_ik2, tri_failed=new_tf,
            dir_set=new_dir_set, dir_off=dir_off,
            out_meta=out_meta, out_k0=out_k0, out_fr=out_fr,
            out_n=out_n, poison=new_poison,
            finish_iter=finish_iter,
            n_active=n_active, n_iter=s["n_iter"] + 1,
        )

    # ---- phased lane compaction ----
    # Per-iteration cost is dominated by per-lane gather indices, but the
    # loop runs until the SLOWEST lane finishes (counted at 250 Mb:
    # finish_iter mean 273 vs max 477 — the active-lane integral is ~57%
    # of B*max). So the scan runs as a cascade of while_loops of halving
    # width: each phase exits once n_active fits the next width, active
    # lanes compact to the front (stable order), and the final state is
    # re-assembled by one gather per phase. Lanes are independent and a
    # finished lane is inert in the body, so results are bit-identical to
    # the single-loop scan. NOTE: `body`/`cond` read starts/emit_stops/
    # ext_stops/hard_stops/B from the enclosing scope at TRACE time, so
    # rebinding them between while_loop constructions re-parameterizes
    # each phase (deliberate late binding).
    B0 = B
    widths = [B]
    while len(widths) < 5 and widths[-1] % 2 == 0 and widths[-1] >= 512:
        widths.append(widths[-1] // 2)
    per_lane = ("phase", "cursor", "ext_start", "ext_pos", "ik1", "ik2",
                "tri_failed", "dir_set", "dir_off", "out_meta", "out_k0",
                "out_fr", "out_n", "poison", "finish_iter")
    saved = []
    s = init_state
    for p, W in enumerate(widths):
        thresh = widths[p + 1] if p + 1 < len(widths) else 0
        s = jax.lax.while_loop(
            lambda st, th=i32(thresh): st["n_active"] > th, body, s)
        if p + 1 == len(widths):
            break
        W2 = widths[p + 1]
        active = ~lane_done(s["phase"], s["cursor"])
        # stable: actives keep original relative order (reassembly cumsum)
        act_first = jnp.argsort((~active).astype(jnp.int8), stable=True)
        idx2 = act_first[:W2].astype(i32)  # all actives (<= W2) + done pad
        saved.append((s, active))
        s = {**{f: s[f][idx2] for f in per_lane},
             "n_active": s["n_active"], "n_iter": s["n_iter"]}
        starts = starts[idx2]
        emit_stops = emit_stops[idx2]
        ext_stops = ext_stops[idx2]
        hard_stops = hard_stops[idx2]
        B = W2
    fin = s
    for S_p, active in reversed(saved):
        Wp = active.shape[0]
        pos = jnp.cumsum(active.astype(i32), dtype=i32) - 1
        src = jnp.where(active, i32(Wp) + pos,
                        jnp.arange(Wp, dtype=i32))
        fin = {f: jnp.concatenate([S_p[f], fin[f]], axis=0)[src]
               for f in per_lane}
    final = fin
    B = B0
    # Results are fetched together (the launcher issues
    # copy_to_host_async for all of them): per-lane scalars ride one
    # [B, 4] array, (qpos|len, k0) share a u32 [2 or 3, B, max_out] stack
    # (k0 split into lo/hi words on the wide path), and freq stays its own
    # int8 plane. The emit planes are mostly EMPTY (mean fill ~50 of 128
    # slots), so the planes are also COMPACTED on device into flat [cap]
    # arrays laid out at per-lane offsets cumsum(out_n) (a searchsorted +
    # gather, no scatter); the host fetches only the compact pair and
    # falls back to the full planes (still on device, not fetched) iff
    # they overflow cap. Sensitive mode skips compaction (its planes run
    # full).
    meta = jnp.stack([final["out_n"], final["cursor"],
                      final["poison"], final["finish_iter"]],
                     axis=1)                                 # [B, 4] i32
    k0 = final["out_k0"]
    if k0.dtype == jnp.int64:
        k0u = k0.astype(jnp.uint64)
        k0_planes = [(k0u & jnp.uint64(0xFFFFFFFF)).astype(u32),
                     (k0u >> jnp.uint64(32)).astype(u32)]
    else:
        k0_planes = [k0.view(jnp.uint32) if k0.dtype == jnp.int32
                     else k0.astype(u32)]
    mk = jnp.stack([final["out_meta"].astype(u32)] + k0_planes)
    fr = final["out_fr"]
    if sensitive:
        return meta, mk, fr, mk, fr
    cap = B * min(max_out, _COMPACT_SLOTS)
    ends = jnp.cumsum(final["out_n"], dtype=i32)             # [B]
    kk = jnp.arange(cap, dtype=i32)
    lane = jnp.clip(jnp.searchsorted(ends, kk, side="right"),
                    0, B - 1).astype(i32)
    j = kk - (ends[lane] - final["out_n"][lane])
    flat_idx = lane * i32(max_out) + jnp.clip(j, 0, max_out - 1)
    mk_c = mk.reshape(mk.shape[0], B * max_out)[:, flat_idx]
    fr_c = fr.reshape(-1)[flat_idx]
    return meta, mk, fr, mk_c, fr_c


_seed_scan = partial(jax.jit, static_argnames=(
    "min_seed_length", "max_seed_freq", "sensitive", "max_out", "init12",
    "sa_mode"))(_seed_scan_impl)


from functools import lru_cache   # noqa: E402


@lru_cache(maxsize=None)
def _shard_scan(mesh, min_seed_length, max_seed_freq, sensitive, max_out,
                init12, sa_mode):
    """shard_map-wrapped scan: each device runs the while_loop INDEPENDENTLY
    on its lane shard (lanes never interact). Under plain GSPMD the loop
    condition (a global n_active sum) and the emit-compaction cumsum became
    per-iteration cross-device collectives. Inside shard_map every device
    sees only its local lanes and loops for its own trip count."""
    from jax.sharding import PartitionSpec as P
    from gsalign_tpu.parallel.mesh import FRAG_AXIS as F
    fn = partial(_seed_scan_impl, min_seed_length=min_seed_length,
                 max_seed_freq=max_seed_freq, sensitive=sensitive,
                 max_out=max_out, init12=init12, sa_mode=sa_mode)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(), P(), P(F), P(F), P(F), P(F)),
        out_specs=(P(F), P(None, F), P(F), P(None, F), P(F)),
        check_vma=False))


@lru_cache(maxsize=None)
def _rowshard_scan(mesh, meta, shard_fields, min_seed_length, max_seed_freq,
                   sensitive, max_out, init12, sa_mode):
    """Beyond-HBM scan (docs/SCALING_3GB.md item 1): the big tables are
    ROW-sharded over "frag" (mesh.shard_index_rows) and LANES are
    REPLICATED — every device runs the full while_loop and each occ_t3 /
    SA fetch is a local masked gather + psum (rank._t3_row_fetch). Trades
    lane speedup for table capacity; outputs are replicated and identical
    on every device."""
    from jax.sharding import PartitionSpec as P
    from gsalign_tpu.parallel.mesh import FRAG_AXIS as F
    from gsalign_tpu.ops.rank import DFM_DATA_FIELDS, join_dfm

    def fn(arrays, q_rows, st, em, ex, hd):
        dfm = join_dfm(arrays, meta, row_shard=(F, shard_fields))
        return _seed_scan_impl(dfm, q_rows, st, em, ex, hd,
                               min_seed_length=min_seed_length,
                               max_seed_freq=max_seed_freq,
                               sensitive=sensitive, max_out=max_out,
                               init12=init12, sa_mode=sa_mode)

    arr_specs = tuple(P(F) if f in shard_fields else P()
                      for f in DFM_DATA_FIELDS)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(arr_specs, P(), P(), P(), P(), P()),
        out_specs=(P(), P(), P(), P(), P()),
        check_vma=False))


@lru_cache(maxsize=None)
def _rowshard_resolve(mesh, meta, shard_fields):
    """resolve_sa over a row-sharded index (ranks replicated)."""
    from jax.sharding import PartitionSpec as P
    from gsalign_tpu.parallel.mesh import FRAG_AXIS as F
    from gsalign_tpu.ops.rank import DFM_DATA_FIELDS, join_dfm

    def fn(arrays, k):
        dfm = join_dfm(arrays, meta, row_shard=(F, shard_fields))
        return rank_ops.resolve_sa(dfm, k)

    arr_specs = tuple(P(F) if f in shard_fields else P()
                      for f in DFM_DATA_FIELDS)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(arr_specs, P()), out_specs=P(),
        check_vma=False))


def _next_pow2(n: int, floor: int = 64) -> int:
    m = floor
    while m < n:
        m *= 2
    return m


import os

# Lane slab cap per device call. Iteration count follows the longest lane
# trajectory, roughly independent of B, so larger slabs amortize the
# per-iteration cost over more lanes; the cap bounds emit-buffer memory.
# Its best value on the GPU is not measured yet.
MAX_LANES_PER_CALL = int(os.environ.get("GSALIGN_MAX_LANES", 4096))
_SA_GATHER_K = 512          # split-SA compaction slots/iteration (tests
                            # shrink it to exercise the stall-retry path)
_COMPACT_SLOTS = 64         # emit-compaction budget per lane (mean fill is
                            # ~50 of 128 slots; the full planes back it up)
_QROWS_CACHE = {}           # one-slot query-window reuse (find_seeds_all)
_QROWS_CACHE_MAX_BYTES = 512 << 20


def _run_scan(dfm, q_rows, starts, emit_stops, ext_stops, hard_stops,
              min_seed_length, max_seed_freq, sensitive, max_out, mesh=None,
              init12=True):
    """Launch the scan kernel with power-of-two lane padding (stable compiled
    shapes) and minimal device->host transfer (buffers trimmed to the widest
    actually-used slot count). Lane sets beyond MAX_LANES_PER_CALL run as
    independent slabs (lanes don't interact)."""
    B = len(starts)
    # row-sharded (beyond-HBM) runs replicate lanes: outputs are whole
    n_shards = 1 if (mesh is None
                     or getattr(dfm, "_row_shard_fields", None) is not None) \
        else int(mesh.devices.size)
    # dispatch every slab before fetching any result: JAX queues the
    # launches asynchronously (and _launch_scan issues the host copies
    # asynchronously too), so the whole multi-slab run pays ONE fetch
    # round trip
    pending = []
    for s in range(0, B, MAX_LANES_PER_CALL):
        e = min(s + MAX_LANES_PER_CALL, B)
        pending.append((e - s, starts[s:e], _launch_scan(
            dfm, q_rows, starts[s:e], emit_stops[s:e],
            ext_stops[s:e], hard_stops[s:e],
            min_seed_length, max_seed_freq, sensitive, max_out,
            mesh=mesh, init12=init12)))
    # No cross-slab concatenation and no whole-plane int64 widening:
    # both were measured ~1 s each of pure page-faulting allocation at
    # 250 Mb on this host — consumers take per-lane views instead.
    return ScanResults(
        [(st,) + _fetch_scan(n_real, raw, max_out, n_shards)
         for n_real, st, raw in pending])


class ScanResults:
    """Seed-scan outputs held per slab as FLAT per-lane-concatenated
    arrays; .lane(i) returns one lane's decoded views: (qs_abs int64, ls,
    k0, fr, n, exit_pos, poison). .flat() returns the whole result set in
    one vectorized pass (the n_segments == 1 fast path)."""

    def __init__(self, slabs):
        # slab tuple: (starts, qs_rel, ls, k0, fr, n, exits, poison) —
        # qs_rel/ls/k0/fr flat (sum n entries), the rest per-lane [B]
        self.slabs = slabs
        self._bounds = np.cumsum([s[5].shape[0] for s in slabs])
        self._ends = [np.cumsum(s[5].astype(np.int64)) for s in slabs]

    def lane(self, i):
        s = int(np.searchsorted(self._bounds, i, side="right"))
        li = i - (int(self._bounds[s - 1]) if s else 0)
        starts, qs_rel, ls, k0, fr, n, exits, poi = self.slabs[s]
        e = int(self._ends[s][li])
        m = int(n[li])
        b = e - m
        qs = qs_rel[b:e].astype(np.int64) + int(starts[li])
        return (qs, ls[b:e], k0[b:e], fr[b:e], m,
                int(exits[li]), int(poi[li]))

    def flat(self):
        """All hits of all lanes, vectorized: (qs_abs int64, ls, k0, fr,
        lane_global int64) in flat device order, plus per-lane
        (n, exits, poison) arrays concatenated over slabs."""
        qs_p, ls_p, k0_p, fr_p, lane_p = [], [], [], [], []
        base = 0
        for starts, qs_rel, ls, k0, fr, n, exits, poi in self.slabs:
            B = n.shape[0]
            rep = np.repeat(np.arange(B, dtype=np.int64), n.astype(np.int64))
            qs_p.append(qs_rel.astype(np.int64) + starts[rep])
            ls_p.append(ls)
            k0_p.append(k0)
            fr_p.append(fr)
            lane_p.append(rep + base)
            base += B
        cat = np.concatenate
        return (cat(qs_p), cat(ls_p), cat(k0_p), cat(fr_p), cat(lane_p),
                cat([s[5] for s in self.slabs]),
                cat([s[6] for s in self.slabs]),
                cat([s[7] for s in self.slabs]))


def _launch_scan(dfm, q_rows, starts, emit_stops, ext_stops,
                 hard_stops, min_seed_length, max_seed_freq, sensitive,
                 max_out, mesh=None, init12=True):
    """Dispatch one scan slab (async); returns the raw device arrays."""
    B = len(starts)
    # pad lanes to pow2 OR 1.5*pow2 (sqrt(2)-ish steps): every per-lane
    # vector op in the while body scales with Bp, so the pow2-only policy
    # wasted up to 2x (e.g. 1200 lanes -> 2048); the extra shape family
    # stays compile-bounded (two shapes per octave)
    p2 = _next_pow2(B)
    Bp = 3 * p2 // 4 if B <= 3 * p2 // 4 and (3 * p2 // 4) % 64 == 0 else p2
    if mesh is not None:
        from gsalign_tpu.parallel import mesh as mesh_lib
        Bp = mesh_lib.pad_to_multiple(Bp, mesh.devices.size)

    def pad(a):
        out = np.zeros(Bp, dtype=np.int32)
        out[:B] = a
        return out   # padded lanes: start == emit_stop == 0 -> done instantly

    st, em, ex, hd = (pad(starts), pad(emit_stops), pad(ext_stops),
                      pad(hard_stops))
    shard_fields = getattr(dfm, "_row_shard_fields", None)
    if mesh is not None and shard_fields is not None:
        # beyond-HBM row-sharded index: lanes replicated, tables sharded
        arrays, meta_t = rank_ops.split_dfm(dfm)
        scan_fn = _rowshard_scan(mesh, meta_t, shard_fields,
                                 min_seed_length, max_seed_freq,
                                 sensitive, max_out, init12,
                                 _pick_sa_mode(dfm, None))
        meta, mk, fr, mk_c, fr_c = scan_fn(
            arrays, q_rows, jnp.asarray(st), jnp.asarray(em),
            jnp.asarray(ex), jnp.asarray(hd))
        for a in (meta, mk_c, fr_c):
            a.copy_to_host_async()
        return meta, mk, fr, mk_c, fr_c
    if mesh is not None:
        from gsalign_tpu.parallel import mesh as mesh_lib
        dfm = mesh_lib.shard_index(dfm, mesh)
        st = mesh_lib.shard_lanes(st, mesh, 0)
        em = mesh_lib.shard_lanes(em, mesh, 0)
        ex = mesh_lib.shard_lanes(ex, mesh, 0)
        hd = mesh_lib.shard_lanes(hd, mesh, 0)
    else:
        st, em, ex, hd = (jnp.asarray(st), jnp.asarray(em), jnp.asarray(ex),
                          jnp.asarray(hd))
    if mesh is not None:
        scan_fn = _shard_scan(mesh, min_seed_length, max_seed_freq,
                              sensitive, max_out, init12,
                              _pick_sa_mode(dfm, mesh))
        meta, mk, fr, mk_c, fr_c = scan_fn(dfm, q_rows, st, em, ex, hd)
    else:
        meta, mk, fr, mk_c, fr_c = _seed_scan(
            dfm, q_rows, st, em, ex, hd,
            min_seed_length=min_seed_length, max_seed_freq=max_seed_freq,
            sensitive=sensitive, max_out=max_out, init12=init12,
            sa_mode=_pick_sa_mode(dfm, mesh))
    # queue the device->host copies NOW (behind the compute): the later
    # np.asarray calls then wait on data already in flight instead of each
    # starting its own transfer. The FULL planes stay on device — fetched
    # only on compaction overflow.
    for a in (meta, mk_c, fr_c):
        a.copy_to_host_async()
    return meta, mk, fr, mk_c, fr_c


def _pick_sa_mode(dfm, mesh) -> str:
    """Choose the scan's direct-mode SA resolution path (see _seed_scan):
    "xla" (plain whole-B gather on the standalone SA plane) is the
    default; GSALIGN_SA_MODE="xlak" selects the K-compacted one-hot
    variant for A/B runs. Which is faster on the GPU is not measured."""
    if not dfm.direct_ok:
        return "none"
    env = os.environ.get("GSALIGN_SA_MODE")
    if env:
        return env
    return "xla"


def _seg_arange(n):
    """[0..n0), [0..n1), ... as one flat int64 array."""
    n = n.astype(np.int64)
    total = int(n.sum())
    return np.arange(total) - np.repeat(np.cumsum(n) - n, n)


def _fetch_scan(B, raw, max_out, n_shards=1):
    """Bring one slab's results to host (the compact copies are already in
    flight, so the np.asarray calls share one round trip) and unpack the
    (qpos_rel|len, k0, freq) planes as FLAT per-lane-concatenated arrays
    (entries of lane i at [ends[i]-n[i], ends[i]) — exactly the device
    compaction layout, so the common case is a pair of slices with NO
    host reshuffle). The full dense planes are fetched (one extra round
    trip) only when the slab overflowed the compaction budget, then
    flattened. Under shard_map (n_shards > 1) each device compacts its
    OWN lane shard at local cumsum offsets; the per-shard segments are
    stitched (lane order is preserved — shards hold contiguous lane
    stripes). Arrays stay int32/int8 (consumers widen their slices)."""
    meta_d, mk_d, fr_d, mkc_d, frc_d = raw
    Bp = meta_d.shape[0]
    meta_h = np.asarray(meta_d)
    n_all = meta_h[:, 0].astype(np.int64)
    n, exits, poison = meta_h[:B, 0], meta_h[:B, 1], meta_h[:B, 2]
    _fetch_scan.last_finish_iters = meta_h[:B, 3]   # diagnostics hook
    # compact arrays are 2-D [p, cap]; sensitive mode returns the full
    # 3-D planes in their place
    dense = mkc_d.ndim == 3
    if not dense:
        Bl = Bp // n_shards
        cap_l = mkc_d.shape[1] // n_shards
        per_shard = n_all.reshape(n_shards, Bl)
        dense = bool((per_shard.sum(axis=1) > cap_l).any())   # overflow
    if dense:   # sensitive mode / compaction overflow
        phd = np.asarray(mk_d)
        frd = np.asarray(fr_d)
        rep = np.repeat(np.arange(Bp, dtype=np.int64), n_all)
        cols = _seg_arange(n_all)
        ph = phd[:, rep, cols]
        fr = frd[rep, cols]
    else:
        mkc = np.asarray(mkc_d)
        frc = np.asarray(frc_d)
        if n_shards == 1:
            total = int(n_all.sum())
            ph = mkc[:, :total]
            fr = frc[:total]
        else:
            parts = []
            for d in range(n_shards):
                t_d = int(n_all[d * Bl:(d + 1) * Bl].sum())
                parts.append(np.arange(d * cap_l, d * cap_l + t_d,
                                       dtype=np.int64))
            idx = np.concatenate(parts)
            ph = mkc[:, idx]
            fr = frc[idx]
    # padding lanes (>= B) emitted nothing, so the flat tail is empty —
    # the per-lane layout over the REAL lanes is cumsum(n)
    qs_rel = (ph[0] & 0xFFFF).astype(np.int32)   # lane-relative positions
    ls = (ph[0] >> 16).astype(np.int32)
    if ph.shape[0] == 3:     # wide: k0 split into lo/hi words
        k0 = (ph[1].astype(np.uint64)
              | (ph[2].astype(np.uint64) << 32)).view(np.int64)
    else:
        k0 = ph[1].view(np.int32)                # zero-copy
    return (qs_rel, ls, k0, fr, n, exits, poison)


def find_seeds_all(dfm: DeviceFMIndex,
                   codes_list,
                   min_seed_length: int = 15,
                   max_seed_freq: int = 100,
                   sensitive: bool = False,
                   chunk: int = 10000,
                   n_segments: int = 1,
                   slack: int = 600,
                   mesh=None,
                   max_out_cap=None,
                   init12: bool = True):
    """Seed ALL query chromosomes, exactly reproducing the reference's
    per-chunk sequential scan, with speculative segment parallelism.

    Each 10 kb chunk is cut into n_segments segments scanned concurrently
    from their segment starts, with extensions clipped at seg_end + slack
    instead of the chunk end: an extension that would cross the artificial
    bound POISONS its lane from that start position (results beyond it are
    unknowable — a clipped extension can flip hit/miss), and the host
    re-scans from the poison position with the real chunk-end clip. The
    true trajectory's entry into each segment is reconciled on the host: a
    scan position e is "visited" by the speculative lane iff no recorded
    hit jumped over it, in which case the lane's hit suffix from e up to
    its poison IS the true trajectory (trajectories are deterministic
    functions of position). Unsynced or poisoned spans — rare — are
    re-scanned from their exact entry in follow-up device rounds.

    Returns [(q_pos, r_pos, length), ...] per chromosome, each sorted by
    (PosDiff, qPos), identical to the reference scan.
    """
    # --- concatenated lane space ---
    offs = []
    chunk_bounds = []            # (concat_start, concat_stop) per chunk
    off = 0
    for codes in codes_list:
        L = int(codes.shape[0])
        n_chunks = max(1, -(-L // chunk))
        offs.append(off)
        for c in range(n_chunks):
            s = off + c * chunk
            chunk_bounds.append((s, min(s + chunk, off + L)))
        off += n_chunks * chunk
    total = off
    # The packed query windows serve BOTH the per-iteration metadata
    # decode (_meta16) and the direct-extension comparator. Re-uploads of
    # an identical query (warm re-runs) are served from a one-slot device
    # cache, which skips both the upload and the host-side qc concat
    # rebuild. Whether it pays on the GPU is not measured. The guard is
    # OBJECT IDENTITY of every codes array (the cache holds strong refs,
    # so ids cannot be reused while cached): exact by construction.
    # pipeline/align.py memoizes chars_to_codes so identity survives
    # across compare_genomes calls.
    mesh_key = (None if mesh is None
                else tuple(d.id for d in mesh.devices.flat))
    cached = _QROWS_CACHE
    if (cached.get("mesh_key") == mesh_key and cached.get("chunk") == chunk
            and len(cached.get("codes", ())) == len(codes_list)
            and all(a is b for a, b in zip(cached["codes"], codes_list))):
        q_rows = cached["rows"]
    else:
        qc = np.full(total, 4, dtype=np.uint8)
        for codes, o in zip(codes_list, offs):
            qc[o:o + len(codes)] = codes
        q_rows = _build_qrows(jnp.asarray(qc))
        if mesh is not None:
            from gsalign_tpu.parallel import mesh as mesh_lib
            q_rows = jax.device_put(q_rows, mesh_lib.replicated(mesh))
        if qc.nbytes <= _QROWS_CACHE_MAX_BYTES:
            cached.update(mesh_key=mesh_key, chunk=chunk,
                          codes=list(codes_list), rows=q_rows)

    seg_len = max(1, chunk // max(1, n_segments))
    stride = 5 if sensitive else None
    # emit-plane packing: qpos_rel and len ride 16-bit fields
    assert chunk + slack <= 0xFFFF, "seed chunk too large for packed emit"
    # cap the emit buffer: every loop-carried byte is rewritten every
    # iteration, so a worst-case-sized buffer costs far more than the rare
    # overflow->poison->host-re-scan round it avoids
    hard_max = seg_len // (5 if sensitive else (min_seed_length + 1)) + 2
    if max_out_cap is None:
        # emit cost is proportional to the plane width (every loop-carried
        # byte rewrites every iteration); counted fill at 250 Mb:
        # mean 56, p99.9 = 80, max 88 of 128 — 96 keeps headroom and
        # overflow still poisons into a host re-scan
        max_out_cap = 512 if sensitive else 96
    max_out = min(hard_max, max(2, max_out_cap))

    # --- round 1: speculative lanes at every segment start ---
    lane_starts, lane_emit, lane_ext, lane_hard, lane_key = [], [], [], [], []
    for ci, (cs, ce) in enumerate(chunk_bounds):
        k = 0
        p = cs
        while p < ce:
            lane_starts.append(p)
            lane_emit.append(min(p + seg_len, ce))
            lane_ext.append(min(p + seg_len + slack, ce)
                            if n_segments > 1 else ce)
            lane_hard.append(ce)
            lane_key.append((ci, k))
            p += seg_len
            k += 1
    res = _run_scan(
        dfm, q_rows, np.asarray(lane_starts, np.int32),
        np.asarray(lane_emit, np.int32), np.asarray(lane_ext, np.int32),
        np.asarray(lane_hard, np.int32),
        min_seed_length, max_seed_freq, sensitive, max_out, mesh=mesh,
        init12=init12)
    hits_q, hits_l, hits_k0, hits_fr = [], [], [], []
    if n_segments == 1:
        # --- fast path: one lane per chunk, scanned with the real clip —
        # no speculative reconciliation exists, so the result set is the
        # flat device output below each lane's poison (POISON_NONE is
        # int32 max, so the mask is uniform), plus re-scan rounds for the
        # rare emit-buffer-overflow poisons. No per-lane host loop; the
        # final per-chromosome lexsort fixes ordering.
        max_rounds = 2 + -(-chunk // max(1, max_out))
        ce_pend = np.asarray(lane_hard, np.int32)
        for _round in range(max_rounds):
            (qs_f, ls_f, k0_f, fr_f, lane_f,
             n_l, exits_l, poi_l) = res.flat()
            keep = qs_f < poi_l[lane_f].astype(np.int64)
            if keep.all():
                keep = slice(None)
            hits_q.append(qs_f[keep])
            hits_l.append(ls_f[keep])
            hits_k0.append(k0_f[keep])
            hits_fr.append(fr_f[keep])
            pend = np.flatnonzero(poi_l != POISON_NONE)
            if pend.size == 0:
                break
            ce_pend = ce_pend[pend]
            st_pend = poi_l[pend].astype(np.int32)
            res = _run_scan(
                dfm, q_rows, st_pend, ce_pend, ce_pend, ce_pend,
                min_seed_length, max_seed_freq, sensitive, max_out,
                mesh=mesh, init12=init12)
        else:
            raise AssertionError("seed overflow re-scan did not converge")
        q_pos, r_pos, length = _expand_hits(
            dfm,
            np.concatenate(hits_q) if hits_q else np.zeros(0, np.int64),
            np.concatenate(hits_l) if hits_l else np.zeros(0, np.int32),
            np.concatenate(hits_k0) if hits_k0 else np.zeros(0, np.int32),
            np.concatenate(hits_fr) if hits_fr else np.zeros(0, np.int32))
        return _split_per_chromosome(q_pos, r_pos, length, codes_list, offs)

    lanes = {}
    for i, key in enumerate(lane_key):
        starts_i, ls_i, k0_i, fr_i, m, exit_i, poi_i = res.lane(i)
        adv = starts_i + (stride if stride else ls_i + 1)
        lanes[key] = (int(lane_starts[i]), starts_i, ls_i, k0_i,
                      fr_i, adv, exit_i, poi_i)

    # --- reconciliation (+ fixup rounds) ---
    n_chunks = len(chunk_bounds)
    entry = np.asarray([cs for cs, _ in chunk_bounds], dtype=np.int64)
    done = np.zeros(n_chunks, dtype=bool)
    # rounds: n_segments reconciliation passes plus overflow re-scans
    # (each overflow round advances >= max_out hits per affected chunk)
    max_rounds = n_segments + 1 + -(-chunk // max(1, max_out))
    for _round in range(max_rounds):
        fixups = []
        for ci in range(n_chunks):
            if done[ci]:
                continue
            cs, ce = chunk_bounds[ci]
            e = int(entry[ci])
            while e < ce:
                k = (e - cs) // seg_len
                lane = lanes.get((ci, k))
                if lane is not None:
                    lane_start, lane_poison = lane[0], lane[7]
                    if lane_start > e or e >= lane_poison:
                        # stale fixup lane, or entry already in the
                        # poisoned (unknowable) span
                        lane = None
                if lane is None or (lane_start < e and not _visited(lane, e)):
                    fixups.append((ci, k, e,
                                   min(cs + (k + 1) * seg_len, ce), ce))
                    break
                if lane_start == e or _visited(lane, e):
                    starts_i = lane[1]
                    idx = int(np.searchsorted(starts_i, e))
                    if lane_poison != POISON_NONE:
                        j_end = int(np.searchsorted(starts_i, lane_poison))
                        hits_q.append(starts_i[idx:j_end])
                        hits_l.append(lane[2][idx:j_end])
                        hits_k0.append(lane[3][idx:j_end])
                        hits_fr.append(lane[4][idx:j_end])
                        e = lane_poison
                    else:
                        hits_q.append(starts_i[idx:])
                        hits_l.append(lane[2][idx:])
                        hits_k0.append(lane[3][idx:])
                        hits_fr.append(lane[4][idx:])
                        e = lane[6]
            else:
                done[ci] = True
            entry[ci] = e
        if not fixups:
            break
        f_starts = np.asarray([f[2] for f in fixups], np.int32)
        f_emit = np.asarray([f[3] for f in fixups], np.int32)
        f_ext = np.asarray([f[4] for f in fixups], np.int32)
        # fixup lanes run with the REAL chunk-end clip: never poisoned
        res = _run_scan(
            dfm, q_rows, f_starts, f_emit, f_ext, f_ext,
            min_seed_length, max_seed_freq, sensitive, max_out, mesh=mesh,
            init12=init12)
        for i, (ci, k, e, _, _) in enumerate(fixups):
            starts_i, ls_i, k0_i, fr_i, m, exit_i, poi_i = res.lane(i)
            adv = starts_i + (stride if stride else ls_i + 1)
            # fixup lanes run with the real clip so they are never
            # boundary-poisoned, but a full emit buffer still poisons
            lanes[(ci, k)] = (int(e), starts_i, ls_i, k0_i,
                              fr_i, adv, exit_i, poi_i)
    else:
        assert done.all(), "seed reconciliation did not converge"

    q_pos, r_pos, length = _expand_hits(
        dfm,
        np.concatenate(hits_q) if hits_q else np.zeros(0, np.int32),
        np.concatenate(hits_l) if hits_l else np.zeros(0, np.int32),
        np.concatenate(hits_k0) if hits_k0 else np.zeros(0, np.int32),
        np.concatenate(hits_fr) if hits_fr else np.zeros(0, np.int32))
    return _split_per_chromosome(q_pos, r_pos, length, codes_list, offs)


def _split_per_chromosome(q_pos, r_pos, length, codes_list, offs):
    """Split concatenated-coordinate hits per chromosome, sorted by
    (PosDiff, qPos) — identical to the reference scan order."""
    results = []
    for codes, o in zip(codes_list, offs):
        L = int(codes.shape[0])
        m = (q_pos >= o) & (q_pos < o + L)
        qp = q_pos[m] - o
        rp = r_pos[m]
        ln = length[m]
        order = np.lexsort((qp, rp - qp))
        results.append((qp[order], rp[order], ln[order]))
    return results


def _visited(lane, e):
    """Was position e a scan start of this lane's trajectory? True iff no
    recorded hit jumped over it (between hits the scan advances +1)."""
    starts_i, adv = lane[1], lane[5]
    h = int(np.searchsorted(starts_i, e, side="left")) - 1
    if h < 0:
        return True
    if starts_i.shape[0] > h and e == starts_i[h]:
        return True
    return e >= adv[h]


def _expand_hits(dfm, qs, ls, k0, fr):
    """Resolve occurrence positions for flat hit arrays."""
    if qs.size == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z
    fr = fr.astype(np.int64)
    total = int(fr.sum())
    rep = np.repeat(np.arange(qs.shape[0]), fr)
    offset = np.arange(total) - np.repeat(np.cumsum(fr) - fr, fr)
    k0r = k0[rep].astype(np.int64)
    # direct-extension hits carry a pre-resolved occurrence position
    # encoded as k0 = -(r_start+1) (always freq 1); everything else is a
    # rank to resolve through the SA
    pre = k0r < 0
    rdt = np.int64 if dfm.rdtype == jnp.int64 else np.int32
    ranks = np.where(pre, 0, k0r + offset).astype(rdt)
    host_sa = getattr(dfm, "_host_sa", None)
    if host_sa is not None:
        # full-SA index: resolve on HOST (plain numpy gather) — a device
        # resolve_sa here costs a dispatch + fetch round trip for a lookup
        # the host can do in microseconds
        rc_pos = host_sa[ranks].astype(np.int64)
    else:
        want = _next_pow2(total)
        ranks_pad = np.full(want, 1, dtype=rdt)
        ranks_pad[:total] = ranks
        shard_fields = getattr(dfm, "_row_shard_fields", None)
        if shard_fields is not None:
            arrays, meta_t = rank_ops.split_dfm(dfm)
            fn = _rowshard_resolve(dfm._row_shard_mesh, meta_t,
                                   shard_fields)
            rc_pos = np.asarray(
                fn(arrays, jnp.asarray(ranks_pad)))[:total].astype(np.int64)
        else:
            rc_pos = np.asarray(rank_ops.resolve_sa(
                dfm, jnp.asarray(ranks_pad)))[:total].astype(np.int64)
    lens = ls[rep].astype(np.int64)
    # ranks index RC(P) occurrences; the fwd+RC text is its own reverse
    # complement, so P occurs at the mirrored positions.
    r_pos = np.where(pre, -k0r - 1, dfm.seq_len - rc_pos - lens)
    return qs[rep].astype(np.int64), r_pos, lens


def find_seeds(dfm: DeviceFMIndex,
               query_codes: np.ndarray,
               min_seed_length: int = 15,
               max_seed_freq: int = 100,
               sensitive: bool = False,
               chunk: int = 10000,
               n_segments: int = 1,
               slack: int = 600,
               mesh=None,
               max_out_cap=None,
               init12: bool = True,
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Find all LMEM seeds of one query chromosome (see find_seeds_all)."""
    return find_seeds_all(
        dfm, [query_codes], min_seed_length=min_seed_length,
        max_seed_freq=max_seed_freq, sensitive=sensitive, chunk=chunk,
        slack=slack,
        n_segments=n_segments, mesh=mesh, max_out_cap=max_out_cap,
        init12=init12)[0]
