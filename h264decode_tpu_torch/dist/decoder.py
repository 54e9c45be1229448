"""Sharded stream decoding: the row-band step of dist/sharded.py driven with
real FrameTensors from the entropy stage.

Counterpart of h264decode_tpu/dist/decoder.py. Residual transforms,
weighted motion compensation and PCM placement are exactly row-parallel for
any stream. Intra prediction and deblocking run band-locally (aligned mode,
exact when encoder slices align to the row bands and deblocking does not
cross them) or through the halo pipeline (exact for any stream, including
single-slice encodes). `ShardedDecoder` picks the mode per frame.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from ..kernels import transform as tr_k
from ..kernels.intra import K_I4, K_I8, K_I16
from ..pipeline.deblock_prep import prepare_deblock
from ..pipeline.decoder import Decoder
from ..pipeline.frame_program import _timer
from ..pipeline.gpu_pipeline import R_W_DEFAULT, _mb_avail_grids, _weight_tables
from ..tensors.frame_tensors import MB_I_16X16, MB_I_NXN
from . import sharded


def oracle_only(ft, sps, slices) -> bool:
    """Frames the sharded step does not run, as in the JAX package: PAFF and
    MBAFF geometry, formats other than 8-bit 4:2:0 and monochrome (which
    rides the 4:2:0 step: no coded chroma, so mid-gray converges exactly),
    SP/SI transform-domain requantization and lossless bypass."""
    return bool(
        slices[0][0].field_pic_flag
        or slices[0][0].mbaff_frame_flag
        or sps.chroma_array_type not in (0, 1)
        or sps.bit_depth_luma != 8
        or any(h.is_sp or h.is_si for h, *_ in slices)
        or (sps.qpprime_y_zero_transform_bypass_flag and (ft.qp == 0).any())
    )


class ShardedDecoder(Decoder):
    """Decodes one stream with the pixel pipeline sharded over the row axis
    of gop slot `slot` of `mesh` (dist/mesh.py). Slice-per-band streams take
    the band-parallel aligned mode; anything else the halo pipeline. `modes`
    counts the frames each mode reconstructed ("aligned", "halo").

    Every frame runs through the band programs of its signature
    (dist/sharded.py), in a ShardSet per frame geometry checked out of the
    process-wide cache (sharded.checkout) and returned by close(): a later
    decoder of the same mesh row and geometry replays what this one
    captured. metrics: `program_keys` (distinct signatures met),
    `graph_captures`, `graph_replays` (one per band program a frame) and
    the `prep` (build_inputs on the host), `graph_capture`, `dispatch` and
    `download` timers."""

    def __init__(self, mesh, apply_deblock: bool = True, metrics=None, slot: int = 0):
        super().__init__(apply_deblock=apply_deblock, metrics=metrics)
        self.mesh = mesh
        self.slot = slot
        self.n_row = mesh.shape["row"]
        self._set: sharded.ShardSet | None = None  # checked out
        self._keys: set = set()
        self._r_w = R_W_DEFAULT
        self.modes: Counter = Counter()

    def close(self):
        """Stop the per-slice entropy executor (multi-slice pictures start
        one) and return the ShardSet."""
        ex = getattr(self, "_slice_exec", None)
        if ex is not None:
            ex.shutdown(wait=True)
            self._slice_exec = None
        if self._set is not None:
            sharded.checkin(self._set)
            self._set = None

    def _aligned(self, ft, slices) -> bool:
        """True when the band-local mode is exact: every band boundary is a
        slice start (no slice straddles a boundary), and, when deblocking is
        on, no slice filters across its boundaries (disable_deblocking_
        filter_idc 1 or 2). Anything else takes the halo pipeline."""
        band_mbs = (ft.mb_h // self.n_row) * ft.mb_w
        starts = {h.first_mb_in_slice for h, *_ in slices}
        if any(s % band_mbs for s in starts):
            return False
        if not set(range(0, ft.n_mbs, band_mbs)) <= starts:
            return False
        if self.apply_deblock and not all(
            h.disable_deblocking_filter_idc in (1, 2) for h, *_ in slices
        ):
            return False
        return True

    def _reconstruct(self, ft, sps, pps, slices, ref_lists, weight_ctx, poc):
        if oracle_only(ft, sps, slices):
            # never mis-decode silently on the sharded path: these run on the
            # numpy oracle
            return super()._reconstruct(ft, sps, pps, slices, ref_lists, weight_ctx, poc)
        mb_h, mb_w = ft.mb_h, ft.mb_w
        assert mb_h % self.n_row == 0, "frame rows must divide by row shards"
        halo = not self._aligned(ft, slices)
        n_refs = max(1, sps.max_num_ref_frames + 1)
        qp_offs = (pps.chroma_qp_index_offset, pps.second_chroma_qp_index_offset)
        has_pcm = bool(ft.pcm_samples)
        devs = self.mesh.row(self.slot)
        if self._set is None or self._set.geom != (mb_h, mb_w):
            if self._set is not None:
                sharded.checkin(self._set)
                self._set = None
            self._set = sharded.checkout(devs, (mb_h, mb_w))
        with _timer(self.metrics, "prep"):
            raw = self.build_inputs(ft, sps, pps, slices, ref_lists, weight_ctx, poc,
                                    n_refs=n_refs, has_pcm=has_pcm)
        key = sharded.signature(raw, devs, mb_h, mb_w, self.apply_deblock, qp_offs, halo,
                                has_pcm)
        if key not in self._keys:
            self._keys.add(key)
            if self.metrics is not None:
                self.metrics.count("program_keys")
        self.modes["halo" if halo else "aligned"] += 1
        return self._set.step(key, raw, mb_h, mb_w, self.apply_deblock, qp_offs, halo, has_pcm,
                              self.metrics)

    def build_inputs(self, ft, sps, pps, slices, ref_lists, weight_ctx, poc, *,
                     n_refs: int, has_pcm: bool) -> dict[str, np.ndarray]:
        """Host-side arrays of one frame of one gop slot: everything the
        sharded step reads, the whole frame (the step cuts the bands)."""
        mb_h, mb_w = ft.mb_h, ft.mb_w
        uid_to_pic = {}
        for l0, l1 in ref_lists:
            for p in l0 + l1:
                uid_to_pic.setdefault(p.uid, p)
        pics = list(uid_to_pic.values())[:n_refs]
        uid_slot = {p.uid: i for i, p in enumerate(pics)}
        H, W = mb_h * 16, mb_w * 16
        ref_y = np.zeros((n_refs, H, W), np.uint8)
        ref_cb = np.zeros((n_refs, H // 2, W // 2), np.uint8)
        ref_cr = np.zeros((n_refs, H // 2, W // 2), np.uint8)
        for p, i in ((p, uid_slot[p.uid]) for p in pics):
            ref_y[i] = np.asarray(p.y)
            ref_cb[i] = np.asarray(p.cb)
            ref_cr[i] = np.asarray(p.cr)

        slot_lut = np.full(self.uid_counter + 2, -1, np.int32)
        for uid, sidx in uid_slot.items():
            slot_lut[uid] = sidx
        rp = ft.ref_pic  # [n, 2, 4] picture uids
        slot_parts = np.where(
            rp >= 0, slot_lut[np.clip(rp, 0, len(slot_lut) - 1)], -1
        ).astype(np.int8)

        kind = np.zeros(ft.n_mbs, np.int32)
        kind[(ft.mb_class == MB_I_NXN) & ~ft.transform_8x8] = K_I4
        kind[(ft.mb_class == MB_I_NXN) & ft.transform_8x8] = K_I8
        kind[ft.mb_class == MB_I_16X16] = K_I16
        avl, avt, avtr, avtl = _mb_avail_grids(ft, pps)

        # per-slice weighted-prediction tables (identity unless weighted),
        # one row for each of the picture's slices
        s_pad = 1 << max(0, len(slices) - 1).bit_length()
        max_list = max(
            [1] + [len(l0) for l0, _ in ref_lists] + [len(l1) for _, l1 in ref_lists]
        )
        while self._r_w < max_list:
            self._r_w *= 2
        wt = _weight_tables(weight_ctx, ref_lists, poc, s_pad, self._r_w)

        s4 = pps.effective_scaling_4x4(sps)
        s8 = pps.effective_scaling_8x8(sps)
        l4, l8t = tr_k.level_scale_tables_4x4, tr_k.level_scale_tables_8x8
        l8 = ft.luma8_ac if ft.luma8_ac is not None else np.zeros((ft.n_mbs, 4, 64), np.int16)
        inp = {
            "luma_ac": ft.luma_ac,
            "luma_dc": ft.luma_dc,
            "luma8_ac": l8,
            "chroma_dc": ft.chroma_dc,
            "chroma_ac": ft.chroma_ac,
            "qp": ft.qp,
            "is_i16": ft.mb_class == MB_I_16X16,
            "is_t8": ft.transform_8x8,
            "is_intra": ft.mb_class < 3,
            "kind": kind,
            "modes4": ft.intra4x4_modes,
            "i16mode": ft.intra16_mode,
            "cmode": ft.chroma_mode,
            "avl": avl.reshape(-1),
            "avt": avt.reshape(-1),
            "avtr": avtr.reshape(-1),
            "avtl": avtl.reshape(-1),
            "slice_mb": ft.slice_id.astype(np.int16),
            "ridx_parts": ft.ref_idx,
            "slot_parts": slot_parts,
            "mv_parts": ft.mv,
            "ref_luma_raw": ref_y,
            "ref_cb_raw": ref_cb,
            "ref_cr_raw": ref_cr,
            "ls4_y": np.stack([l4(s4[0]), l4(s4[3])]),
            "ls8_y": np.stack([l8t(s8[0]), l8t(s8[1])]),
            "ls4_c": np.stack([np.stack([l4(s4[1]), l4(s4[2])]),
                               np.stack([l4(s4[4]), l4(s4[5])])]),
            **wt,
        }
        if has_pcm:
            # monochrome codes no chroma: its PCM MBs take the mid-gray
            # chroma the frame presents, as GpuDecoder places them
            mono = sps.chroma_array_type == 0
            pcm_y = np.zeros((H, W), np.uint8)
            pcm_cb = np.zeros((H // 2, W // 2), np.uint8)
            pcm_cr = np.zeros((H // 2, W // 2), np.uint8)
            for addr, (py, pcb, pcr) in ft.pcm_samples.items():
                mbx, mby = ft.mb_xy(addr)
                pcm_y[mby * 16 : mby * 16 + 16, mbx * 16 : mbx * 16 + 16] = py
                cy, cx = slice(mby * 8, mby * 8 + 8), slice(mbx * 8, mbx * 8 + 8)
                pcm_cb[cy, cx] = 128 if mono else pcb
                pcm_cr[cy, cx] = 128 if mono else pcr
            inp["pcm_y"], inp["pcm_cb"], inp["pcm_cr"] = pcm_y, pcm_cb, pcm_cr
        if self.apply_deblock:
            # over the whole frame: a band's MB row 0 takes its bS and
            # thresholds from the MB row above, in the band above
            for k, v in prepare_deblock(ft, sps, pps).items():
                inp["db_" + k] = v
        return inp
