"""Device step-3 pre-pass: batched banded-NW window scoring.

The step-3 candidate scorer's hot loop is the exact-score pre-pass
(score-only banded NW over each candidate's lead/trail windows;
nw.c:892-1188 NW_band_score, SURVEY hard part #1).  With ``-device on``
those windows are exported per batch (native kaln_se_windows, already
content-deduped), staged natively as codes (kaln_se_stage_codes), scored
on the device by ops/nw_kernel.nw_band_score -- through a devserve
session when one is live, in-process otherwise -- and fed back to the
native phase-B scorer as per-candidate score tables
(kaln_set_dev_scores).  The skip rules the scores drive are provably
output-neutral, so byte parity holds by construction; tests force the
path on and assert it.

Under ``-device on`` every exported window is scored on the device and
a device failure ends the run.  ``-device auto`` keeps a byte budget per
batch (KMA_TPU_NW_MAX_MB, default 8) above which the host pre-pass runs.
`predev` in the KMA_ALN_PROF report counts device-fed pre-passes.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from . import native_aln as _nat

B_CHUNK = 1024  # windows per device dispatch (fixed compile shape)
# lead/trail window geometry clamps the span difference to BANDWIDTH,
# so band = |dt-dq| + 64 <= 128 always; 130 band lanes need 256
L_LANES = 256
MAX_BAND = 128

# process-wide counters (tests / diagnostics)
LAST_STATS = {"windows": 0, "dispatches": 0}


def _r_bucket(r: int) -> int:
    b = 128
    while b < r:
        b = -(-b * 3 // 2) // 64 * 64
    return b


class DeviceNWPrepass:
    """Per-run device scorer for the step-3 window pre-pass.

    strict=True (``-device on``) scores every batch on the device;
    otherwise batches past KMA_TPU_NW_MAX_MB of staged codes stay on the
    host."""

    def __init__(self, client=None, strict: bool = True):
        self.client = client          # devserve.DevClient or None
        self.strict = strict
        self.max_bytes = int(os.environ.get("KMA_TPU_NW_MAX_MB", "8")) << 20
        self.windows_scored = 0
        self.dispatches = 0

    def _score_local(self, tl, ql, kf, hb, qext, tcol, rew):
        from ..ops.nw_kernel import nw_band_score
        DMAT = tuple(tuple(int(x) for x in row)
                     for row in np.asarray(rew.d)[:5, :5])
        return np.asarray(nw_band_score(tl, ql, kf, hb, qext, tcol,
                                        DMAT=DMAT, W1=rew.W1, U=rew.U,
                                        MM=rew.MM), np.int64)

    # -- batch entry ----------------------------------------------------------

    def compute(self, handles, tpl_ids, tpl_off, codes_flat, codes_off,
                npos_flat, npos_off, qbounds, arc_flags, rew,
                kmersize: int, mq: int, scoreT: float, crc_flat,
                crc_off):
        """Score this batch's heavy windows on the device; returns the
        (lead, has_lead, trail, has_trail) tables for
        native_aln.set_dev_scores, or None (no window, or over the
        ``-device auto`` budget)."""
        out = _nat.se_windows(handles, tpl_ids, tpl_off, codes_flat,
                              codes_off, npos_flat, npos_off, qbounds,
                              arc_flags, rew, kmersize, mq, scoreT,
                              max_band=MAX_BAND, crc_flat=crc_flat,
                              crc_off=crc_off)
        if out is None:
            return None
        wins, lead_win, trail_win = out
        n_win = len(wins["read"])
        spans = (wins["te"] - wins["ts"]).astype(np.int64)
        est_bytes = int(np.minimum(spans, 1 << 20).sum()) * 2 \
            + n_win * L_LANES
        if not self.strict and est_bytes > self.max_bytes:
            return None

        order = np.argsort(spans, kind="stable")
        scores = np.zeros(n_win, np.int64)
        # stage every chunk first, then PIPELINE the device calls: all
        # requests go out before the first response is awaited, so the
        # daemon round-trip latency is paid once, not per chunk.  Rows
        # pad to the fixed B_CHUNK so each R bucket is ONE compile.
        chunks = []
        for off in range(0, n_win, B_CHUNK):
            sel = order[off: off + B_CHUNK]
            R = _r_bucket(int(spans[sel].max()))
            n = len(sel)
            sel_p = np.zeros(B_CHUNK, np.int64)
            sel_p[:n] = sel
            qc0, tcol, inj, tl, ql, kf, hb = _nat.stage_codes(
                handles, codes_flat, codes_off, crc_flat, crc_off,
                wins, sel_p, R, L_LANES)
            # pad rows: degenerate 1x1 windows with pad codes
            tl[n:] = 1
            ql[n:] = 1
            kf[n:] = 0
            hb[n:] = 32
            qc0[n:, :] = 5
            tcol[:, n:] = 0
            inj[:, n:] = 5
            # qext = reversed inj ++ qc0: query codes over
            # qpos = K-R+1+j (the scorer reads row i at offset R-1-i)
            qext = np.ascontiguousarray(
                np.concatenate([inj.T[:, ::-1], qc0], axis=1))
            chunks.append((sel, n, tl, ql, kf, hb, qext, tcol))
        self.dispatches += len(chunks)
        if self.client is not None:
            for _sel, _n, tl, ql, kf, hb, qext, tcol in chunks:
                self.client.nw_scores_send(
                    tl, ql, kf, hb, qext, tcol,
                    dmat=np.asarray(rew.d)[:5, :5], W1=rew.W1, U=rew.U,
                    MM=rew.MM)
            for sel, n, *_ in chunks:
                got = np.asarray(self.client.nw_scores_recv(), np.int64)
                scores[sel] = got[:n]
        else:
            for sel, n, tl, ql, kf, hb, qext, tcol in chunks:
                scores[sel] = self._score_local(tl, ql, kf, hb, qext, tcol,
                                                rew)[:n]
        self.windows_scored += n_win
        LAST_STATS["windows"] += n_win
        LAST_STATS["dispatches"] += len(chunks)

        total = int(tpl_off[-1])
        lead = np.zeros(total, np.int64)
        trail = np.zeros(total, np.int64)
        has_lead = (lead_win >= 0).astype(np.uint8)
        has_trail = (trail_win >= 0).astype(np.uint8)
        li = lead_win >= 0
        ti = trail_win >= 0
        lead[li] = scores[lead_win[li]]
        trail[ti] = scores[trail_win[ti]]
        return lead, has_lead, trail, has_trail


def make_nw_prepass(client=None, strict: bool = True
                    ) -> Optional[DeviceNWPrepass]:
    """DeviceNWPrepass for a device run (strict under ``-device on``),
    or None when the native aligner that exports the windows is
    unavailable."""
    if _nat.get_lib() is None:
        return None
    return DeviceNWPrepass(client=client, strict=strict)
