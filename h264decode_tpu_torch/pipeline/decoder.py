"""Top-level decode orchestration: Annex-B stream -> YUV frames.

Dataflow (SURVEY.md section 7.1 two-phase design):
  bytes -> NAL demux -> SPS/PPS state -> per-picture entropy decode
  (CAVLC/CABAC, host) -> FrameTensors -> pixel reconstruction
  (numpy oracle here; kernels/ TPU path via pipeline/tpu_pipeline.py)
  -> deblocking -> DPB -> POC-ordered output.

Capability superset of the reference's handleConnection dispatch
(/root/reference/h264/server.go:144-165).
"""

from __future__ import annotations


import os
from concurrent.futures import Future, ThreadPoolExecutor
from functools import partial

import numpy as np

from ..bitstream.annexb import iter_nalus, iter_nalus_chunks
from ..entropy import native as native_mod
from ..entropy.cavlc_slice import CavlcSliceDecoder
from ..entropy.direct import DirectContext
from ..entropy.mv_pred import MotionContext
from ..syntax import nal as nal_mod
from ..syntax.fmo import map_unit_to_slice_group_map, mb_to_slice_group_map
from ..syntax.nal import parse_nal_unit
from ..syntax.sei import parse_sei
from ..syntax.pps import PPS, parse_pps
from ..syntax.slice_header import SliceHeader, parse_slice_header
from ..syntax.sps import SPS, parse_sps
from ..tensors.frame_tensors import FrameTensors
from ..utils.metrics import span, timer
from .deblock import deblock_frame
from .dpb import DPB, Picture, POCContext, fill_colocated
from .intra_frame import IntraFrameReconstructor


class DecodedFrame:
    """One output frame. Planes materialize lazily: the TPU pipeline hands
    over device arrays still being computed/downloaded, so the decode loop
    never blocks on the (slow) device link — the download happens on first
    plane access, overlapping later frames' entropy decode and device work."""

    def __init__(self, y, cb, cr, poc=0, frame_num=0, is_idr=False,
                 idr_group=0, sps=None):
        self._raw = [y, cb, cr]
        self._mat: list[np.ndarray | None] = [None, None, None]
        self._sps = sps
        self.poc = poc
        self.frame_num = frame_num
        self.is_idr = is_idr
        self.idr_group = idr_group
        #: recovery-point SEI (Annex D.2.7) attached to this access unit;
        #: decoding may resume here (see pipeline/seek.py)
        self.recovery_point = None

    def _plane(self, i: int) -> np.ndarray:
        if self._mat[i] is None:
            p = self._raw[i]
            if not isinstance(p, np.ndarray):
                p = np.asarray(p)  # device -> host, exactly once
            if self._sps is not None:
                p = crop(p, self._sps, i > 0)
            self._mat[i] = p
            self._raw[i] = None
        return self._mat[i]

    @property
    def y(self) -> np.ndarray:
        return self._plane(0)

    @property
    def cb(self) -> np.ndarray:
        return self._plane(1)

    @property
    def cr(self) -> np.ndarray:
        return self._plane(2)

    def planes(self):
        return self.y, self.cb, self.cr

    def sync(self):
        """Block until this frame's pixels have been COMPUTED, without
        forcing the device->host download. For host-decoded frames this is
        a no-op; for the TPU pipeline it waits for the frame's packed output
        buffer to exist on device (the honest "decode complete" point —
        fetching it is transport, not decoding)."""
        for p in self._raw:
            if p is None:
                continue
            block = getattr(p, "block_until_ready", None)
            if block is not None:
                block()
        return self


def crop(plane: np.ndarray, sps: SPS, chroma: bool) -> np.ndarray:
    """Apply the SPS frame cropping rectangle (spec 7.4.2.1.1)."""
    if not sps.frame_cropping_flag:
        h = sps.height // ((sps.sub_height_c or 1) if chroma else 1)
        w = sps.width // ((sps.sub_width_c or 1) if chroma else 1)
        return plane[:h, :w]
    # mono streams carry no SubWidthC/SubHeightC (spec: undefined); our
    # chroma planes use the conventional 4:2:0 presentation there
    sub_x = (sps.sub_width_c or 2) if chroma else 1
    sub_y = (sps.sub_height_c or 2) if chroma else 1
    unit_x = sps.sub_width_c if sps.chroma_array_type in (1, 2) else 1
    unit_y = (sps.sub_height_c if sps.chroma_array_type in (1, 2) else 1) * (
        2 - int(sps.frame_mbs_only_flag)
    )
    left = sps.frame_crop_left_offset * unit_x // sub_x
    right = sps.frame_crop_right_offset * unit_x // sub_x
    top = sps.frame_crop_top_offset * unit_y // sub_y
    bottom = sps.frame_crop_bottom_offset * unit_y // sub_y
    h, w = plane.shape
    return plane[top : h - bottom, left : w - right]


def _new_picture(prev: SliceHeader, hdr: SliceHeader) -> bool:
    """First-VCL-NAL-of-a-new-picture detection, spec 7.4.1.2.4.

    The reference has no picture assembly at all (it parses slice by slice,
    h264/server.go:157-164); a first_mb_in_slice==0 heuristic would split
    FMO pictures, whose later slice groups can start at MB address 0."""
    if hdr.frame_num != prev.frame_num:
        return True
    if hdr.pic_parameter_set_id != prev.pic_parameter_set_id:
        return True
    if hdr.field_pic_flag != prev.field_pic_flag:
        return True
    if hdr.field_pic_flag and hdr.bottom_field_flag != prev.bottom_field_flag:
        return True
    if (hdr.nal_ref_idc == 0) != (prev.nal_ref_idc == 0):
        return True
    if hdr.idr_pic_flag != prev.idr_pic_flag:
        return True
    if hdr.idr_pic_flag and hdr.idr_pic_id != prev.idr_pic_id:
        return True
    if hdr.pic_order_cnt_lsb != prev.pic_order_cnt_lsb:
        return True
    if hdr.delta_pic_order_cnt_bottom != prev.delta_pic_order_cnt_bottom:
        return True
    if hdr.delta_pic_order_cnt != prev.delta_pic_order_cnt:
        return True
    # same picture only if MB addresses advance (redundant slices aside)
    return hdr.first_mb_in_slice == 0 and prev.first_mb_in_slice == 0


class Decoder:
    """Stateful stream decoder with DPB/POC picture management.

    error_policy: "strict" raises on corrupt data; "skip" degrades
    per-slice/per-picture and keeps decoding (SURVEY.md section 5 — the
    reference is crash-only: panic/recover + os.Exit, h264/server.go:136).
    """

    def __init__(self, apply_deblock: bool = True, error_policy: str = "strict",
                 metrics=None):
        self.sps_map: dict[int, SPS] = {}
        self.pps_map: dict[int, PPS] = {}
        self.apply_deblock = apply_deblock
        self.error_policy = error_policy
        self.metrics = metrics
        self.error_count = 0
        self._cur: list[tuple[SliceHeader, SPS, PPS, object]] = []
        self.poc_ctx: POCContext | None = None
        self.dpb: DPB | None = None
        self.uid_counter = 0
        self.idr_group = -1
        self._pending_recovery = None  # recovery-point SEI awaiting its AU
        self._first_field = None  # PAFF: decoded field awaiting its pair
        self.max_pending = 0  # high-water mark of the output reorder buffer
        # the engine's per-picture host buffers, reused per geometry
        self._frames = native_mod.FramePool()

    def decode_stream(self, data: bytes) -> list[DecodedFrame]:
        return list(self.decode_iter(data))

    def decode_iter(self, data):
        """Incremental decode: yields frames in output order as the DPB bumps
        them (spec C.4.5.3), holding at most max_num_reorder pending frames.

        `data` is either a complete Annex-B byte string or an iterable of
        byte chunks (e.g. a TCP socket reader); in the chunked form nothing
        buffers the whole stream, so memory stays constant for arbitrarily
        long inputs — unlike the reference, whose input buffer grows forever
        (h264/bit_reader.go:27-39) and which never emits pixels at all."""
        if isinstance(data, (bytes, bytearray, memoryview)):
            nalus = iter_nalus(bytes(data))
        else:
            nalus = iter_nalus_chunks(data)
        pending: list[DecodedFrame] = []  # decoded, not yet output (C.4.5)
        self.max_pending = 0

        def bump(frame: DecodedFrame):
            # an IDR starts a new POC sequence: all prior-group pictures are
            # output first (C.4.5.3 with no_output_of_prior_pics handling
            # simplified to "output", the conformant display behaviour)
            if frame.is_idr:
                pending.sort(key=lambda f: f.poc)
                yield from pending
                pending.clear()
            pending.append(frame)
            self.max_pending = max(self.max_pending, len(pending))
            bound = frame._sps.max_num_reorder if frame._sps else 16
            while len(pending) > bound:
                i = min(range(len(pending)), key=lambda k: pending[k].poc)
                yield pending.pop(i)

        # parse: NAL splitting and header parsing on this thread, one call
        # a picture, paused while a picture is finished and its frames are
        # handed to the caller
        parse = span(self.metrics, "parse")
        parse.start()
        for raw in nalus:
            nal = parse_nal_unit(raw)
            if nal.type == nal_mod.NAL_SPS:
                try:
                    s = parse_sps(nal.rbsp)
                except Exception:
                    if self.error_policy == "strict":
                        raise
                    self.error_count += 1
                    continue
                self.sps_map[s.seq_parameter_set_id] = s
            elif nal.type == nal_mod.NAL_PPS:
                try:
                    p = parse_pps(nal.rbsp, self.sps_map)
                except Exception:
                    if self.error_policy == "strict":
                        raise
                    self.error_count += 1
                    continue
                self.pps_map[p.pic_parameter_set_id] = p
            elif nal.type == nal_mod.NAL_SEI:
                try:
                    sei = parse_sei(nal.rbsp)
                except Exception:
                    if self.error_policy == "strict":
                        raise
                    self.error_count += 1
                    continue
                rp = sei.recovery_point()
                if rp is not None:
                    self._pending_recovery = rp
            elif nal.type in (
                nal_mod.NAL_SLICE_PART_B, nal_mod.NAL_SLICE_PART_C
            ):
                # slice_data_partition_b/c_layer (7.3.2.9/.10): slice_id +
                # [redundant_pic_cnt] + category-3/4 slice data. Attach the
                # reader to the pending partition-A slice with this slice_id.
                try:
                    from ..bitstream.bitreader import BitReader

                    r = BitReader(nal.rbsp)
                    sid = r.ue()
                    cat = 3 if nal.type == nal_mod.NAL_SLICE_PART_B else 4
                    owner = None
                    for h, s_, p_, _ in reversed(self._cur):
                        if getattr(h, "dp_slice_id", None) == sid:
                            owner = (h, p_)
                            break
                    if owner is None:
                        raise ValueError(
                            f"partition {'B' if cat == 3 else 'C'} without "
                            f"a matching partition A (slice_id {sid})"
                        )
                    h, p_ = owner
                    if p_.redundant_pic_cnt_present_flag:
                        r.ue()  # redundant_pic_cnt
                    h.dp_readers[cat] = r
                except Exception:
                    if self.error_policy == "strict":
                        raise
                    self.error_count += 1
                    continue
            elif nal.is_vcl:
                try:
                    hdr, sps, pps, r = parse_slice_header(
                        nal.rbsp, nal, self.sps_map, self.pps_map
                    )
                    if nal.type == nal_mod.NAL_SLICE_PART_A:
                        # slice_data_partition_a_layer (7.3.2.8)
                        if pps.entropy_coding_mode_flag:
                            raise NotImplementedError(
                                "CABAC with data partitioning"
                            )
                        hdr.dp_slice_id = r.ue()
                        hdr.dp_readers = {2: r}
                        # slice_data starts after slice_id in partition A:
                        # keep data_bit_offset true for offset-based
                        # consumers (the native engine)
                        hdr.data_bit_offset = r.pos
                except Exception:
                    if self.error_policy == "strict":
                        raise
                    self.error_count += 1
                    continue
                if self._cur and _new_picture(self._cur[-1][0], hdr):
                    parse.end()
                    try:
                        f = self._finish_picture()
                    except Exception:
                        self._frames.forget()
                        if self.error_policy == "strict":
                            raise
                        self.error_count += 1
                        self._cur = []
                    else:
                        if f is not None:  # None = first field of a pair
                            yield from bump(f)
                    parse.start()
                self._cur.append((hdr, sps, pps, r))
        parse.end()
        if self._cur:
            try:
                f = self._finish_picture()
            except Exception:
                self._frames.forget()
                if self.error_policy == "strict":
                    raise
                self.error_count += 1
            else:
                if f is not None:
                    yield from bump(f)
        # surface any deferred reconstruction error (pipelined decoders run
        # pixel reconstruction on a worker thread; see _submit_reconstruct)
        with timer(self.metrics, "recon_drain"):
            self._drain_recon()
        pending.sort(key=lambda f: f.poc)
        yield from pending

    def _submit_entropy(self, task, native: bool) -> None:
        """Entropy dispatch hook. `task` is one picture's entropy decode
        (_decode_entropy with its arguments bound): it sets the result or
        the exception of the picture's `decoded` future and raises what
        failed. The base decoder runs it here, on the decoding thread;
        GpuDecoder overrides this to run the pictures that decode on the
        native engine (`native`) on worker threads, several at once."""
        task()

    def _submit_reconstruct(self, ft, sps, pps, slices, ref_lists,
                            weight_ctx, poc, decoded):
        """Reconstruction dispatch hook. The base decoder reconstructs
        synchronously; TpuDecoder overrides this to run reconstruction on a
        worker thread so the (serial, host-bound) entropy decode of picture
        N+1 overlaps the host prep + device dispatch of picture N — the
        slice-wavefront pipelining of SURVEY.md section 7.3. `decoded` is
        the picture's entropy task (a Future), done here since the base
        decoder runs it inline. Returns (y, cb, cr): numpy arrays or lazy
        plane objects. Here nothing reads `ft` once _reconstruct returns,
        so its buffers go back to the pool."""
        try:
            return self._reconstruct(ft, sps, pps, slices, ref_lists,
                                     weight_ctx, poc)
        finally:
            self._frames.give(ft)

    def _drain_recon(self):
        """Wait for any asynchronous reconstruction work (hook)."""

    def _slice_pool(self) -> ThreadPoolExecutor:
        """The threads that run a multi-slice picture's engine calls, made
        on first use (on the decoding thread). Its tasks are engine calls
        alone, which wait for nothing, so it cannot deadlock however many
        pictures' tasks wait on it."""
        ex = getattr(self, "_slice_exec", None)
        if ex is None:
            ex = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 4),
                thread_name_prefix="h264slice",
            )
            self._slice_exec = ex
        return ex

    def _decode_entropy(self, pic, calls, native_state, slice_exec, colocated,
                        ft, motion) -> None:
        """One picture's entropy decode, the task _submit_entropy runs: once
        the colocated pictures of its B slices are decoded, their colocated
        arrays go to the slices' DirectContexts; then the engine calls (on
        slice_exec, concurrently, when given), the native engine's finish
        and, for a reference picture, its own colocated arrays. Reads no
        decoder state that the decoding thread changes (the DPB, its
        marking): that was all read at set-up. Sets pic.decoded; raises
        what failed."""
        try:
            for ctx, col in colocated:
                if col.decoded is not None:
                    col.decoded.result()  # raises when that picture failed
                ctx.col_mv, ctx.col_ref_idx = col.col_mv, col.col_ref_idx
                ctx.col_ref_uid, ctx.col_mb_field = col.col_ref_uid, col.col_mb_field
                ctx.col_ref_parity = col.col_ref_parity
            with timer(self.metrics, "entropy"):
                if slice_exec is not None:
                    # map() drains the iterator and re-raises the first failure
                    list(slice_exec.map(lambda call: call(), calls))
                else:
                    for call in calls:
                        call()
                if native_state is not None:
                    native_state.finish()
            if pic.col_ref_idx is not None:
                with timer(self.metrics, "colocated"):
                    fill_colocated(pic, ft, motion)
        except BaseException as e:
            pic.decoded.set_exception(e)
            raise
        pic.decoded.set_result(None)

    def _reconstruct(self, ft, sps, pps, slices, ref_lists, weight_ctx, poc):
        """Pixel reconstruction backend (numpy oracle here; TpuDecoder in
        pipeline/tpu_pipeline.py overrides with the jitted XLA pipeline)."""
        hdr0 = slices[0][0]
        parity = int(hdr0.bottom_field_flag) if hdr0.field_pic_flag else -1
        sp_ctx = [
            ("sp", h.sp_for_switch_flag, h.slice_qs(p)) if h.is_sp
            else ("si", True, h.slice_qs(p)) if h.is_si
            else None
            for h, s, p, _ in slices
        ]
        recon = IntraFrameReconstructor(
            ft, sps, pps, ref_lists=ref_lists, weight_ctx=weight_ctx,
            cur_poc=poc, cur_parity=parity, sp_ctx=sp_ctx,
            cur_field_pocs=getattr(ft, "cur_field_pocs", (poc, poc)),
        )
        y, cb, cr = recon.run()
        if sps.chroma_array_type == 0:
            # monochrome (chroma_format_idc 0): no chroma is coded; present
            # the conventional mid-gray fill (what libavcodec emits when a
            # mono stream is viewed as 4:2:0) so refs/MC stay consistent
            mid = 1 << (sps.bit_depth_chroma - 1)
            cb = np.full_like(cb, mid)
            cr = np.full_like(cr, mid)
        if self.apply_deblock:
            y, cb, cr = deblock_frame(ft, sps, pps, y, cb, cr)
        return y, cb, cr

    def _finish_picture(self) -> DecodedFrame | None:
        # picture_setup: entry to the hand-off of the entropy decode
        # (_submit_entropy); picture_finish: from there to the return, the
        # hand-off to _submit_reconstruct left out
        setup = span(self.metrics, "picture_setup")
        setup.start()
        slices = self._cur
        self._cur = []
        hdr0, sps, pps, _ = slices[0]
        field = bool(hdr0.field_pic_flag)  # PAFF field picture
        if self.poc_ctx is None or self.poc_ctx.sps is not sps:
            self.poc_ctx = POCContext(sps)
        if self.dpb is None or self.dpb.sps is not sps:
            self.dpb = DPB(sps)
        if hdr0.idr_pic_flag and not (
            field and self._first_field is not None
        ):
            self.idr_group += 1
        poc = self.poc_ctx.compute(hdr0)
        if not self.dpb.pictures and any(
            h.is_p or h.is_b or h.is_sp for h, *_ in slices
        ):
            # non-IDR entry (seek to a recovery point, broken link): seed a
            # gray placeholder reference so prediction machinery proceeds
            self.dpb.seed_missing_ref(hdr0, poc, self.uid_counter)
            self.uid_counter += 1

        mb_h_pic = (
            sps.pic_height_in_map_units if field else sps.frame_height_in_mbs
        )
        mb_w = sps.pic_width_in_mbs
        cf = sps.chroma_array_type
        cf = cf if cf in (2, 3) else 1
        use_native = native_mod.native_available() and all(
            native_mod.supported(s, p, h) for h, s, p, _ in slices
        )
        if use_native:
            # a clean set of the engine's buffers from the pool
            native_state = self._frames.take(
                mb_h_pic, mb_w, cf, max(sps.bit_depth_luma, sps.bit_depth_chroma),
                metrics=self.metrics,
            )
            ft, motion = native_state.ft, native_state.motion
            intra_mode_grid = native_state.modes
        else:
            native_state = None
            ft = FrameTensors(mb_w=mb_w, mb_h=mb_h_pic, chroma_format=cf)
            intra_mode_grid = np.full((ft.mb_h * 4, ft.mb_w * 4), -1, np.int8)
            motion = MotionContext(ft.mb_w, ft.mb_h, ft.slice_id)
        ft.mbaff = bool(hdr0.mbaff_frame_flag)
        ft.field_pic = field
        ft.cur_field_pocs = self.poc_ctx.last_field_pocs
        ref_lists: list[tuple[list[Picture], list[Picture]]] = []
        weight_ctx: list[tuple[bool, object]] = []
        calls = []  # the picture's engine calls, one a slice, run by its task
        # (DirectContext, colocated picture) of each B slice: the task binds
        # the colocated arrays once that picture's own task has made them
        colocated: list[tuple[DirectContext, Picture]] = []
        for slice_id, (hdr, s_sps, s_pps, r) in enumerate(slices):
            map_units = map_unit_to_slice_group_map(
                s_sps, s_pps, hdr.slice_group_change_cycle
            )
            mb_map = mb_to_slice_group_map(
                s_sps, map_units, hdr.field_pic_flag, hdr.mbaff_frame_flag
            )
            l0: list[Picture] = []
            l1: list[Picture] = []
            direct_ctx = None
            if hdr.is_p or hdr.is_sp:
                l0 = self.dpb.ref_list_p(hdr)
            elif hdr.is_b:
                l0, l1 = self.dpb.ref_lists_b(hdr, poc)
                col = l1[0]
                # the pictures' marking state is read here, before later
                # pictures mark the DPB; the arrays in the task
                direct_ctx = DirectContext(
                    col_mv=None,
                    col_ref_idx=None,
                    col_ref_uid=None,
                    l0_top_pocs=[p.top_poc for p in l0],
                    l0_bottom_pocs=[p.bottom_poc for p in l0],
                    col_is_short_term=not col.long_term,
                    col_poc=col.poc,
                    cur_ft=ft,
                    col_top_poc=col.top_poc,
                    col_bottom_poc=col.bottom_poc,
                    l0_uids=[p.uid for p in l0],
                    l0_pocs=[p.poc for p in l0],
                    l0_long_term=[p.long_term for p in l0],
                    l1_pocs=[p.poc for p in l1],
                    cur_poc=poc,
                    spatial=hdr.direct_spatial_mv_pred_flag,
                    direct_8x8_inference=s_sps.direct_8x8_inference_flag,
                )
                colocated.append((direct_ctx, col))
            ref_lists.append((l0, l1))
            if hdr.is_b:
                wmode = {0: "none", 1: "explicit", 2: "implicit"}[
                    s_pps.weighted_bipred_idc
                ]
            elif (hdr.is_p or hdr.is_sp) and s_pps.weighted_pred_flag:
                wmode = "explicit"
            else:
                wmode = "none"
            weight_ctx.append((wmode, hdr.pred_weight_table))
            if use_native:
                calls.append(partial(
                    native_mod.decode_slice_native,
                    native_state,
                    hdr,
                    s_sps,
                    s_pps,
                    r.data,
                    slice_id,
                    [p.uid for p in l0],
                    [p.uid for p in l1],
                    direct_ctx,
                    mb_map=mb_map,
                    # multi-slice frames decode their slices CONCURRENTLY
                    # (the engine releases the GIL; slices partition the
                    # picture and cross-slice neighbors are masked), each
                    # with a private decode-order buffer merged in order
                    fb=(native_state.parallel_fb()
                        if len(slices) > 1 else None),
                ))
                continue
            from ..entropy.cabac_slice import CabacSliceDecoder

            cls = (
                CabacSliceDecoder
                if s_pps.entropy_coding_mode_flag
                else CavlcSliceDecoder
            )
            calls.append(partial(
                _python_slice,
                cls,
                ft,
                hdr,
                s_sps,
                s_pps,
                r,
                slice_id,
                mb_map,
                intra_mode_grid,
                motion=motion,
                ref_uids_l0=[p.uid for p in l0],
                ref_uids_l1=[p.uid for p in l1],
                direct_ctx=direct_ctx,
            ))
        decoded = Future()
        # colocated motion for later B pictures' direct prediction, read
        # only through a reference picture (RefPicList1[0]): arrays picked
        # here, filled by the picture's task
        col_arrays = (self.dpb.colocated_arrays(motion.ref.shape[1:], decoded)
                      if hdr0.nal_ref_idc else {})
        for _, c in colocated:
            self.dpb.hold_colocated(c, decoded)
        top_poc, bottom_poc = self.poc_ctx.last_field_pocs
        # the planes come from _submit_reconstruct below
        pic = Picture(
            y=None,
            cb=None,
            cr=None,
            frame_num=hdr0.frame_num,
            poc=poc,
            uid=self.uid_counter,
            parity=int(hdr0.bottom_field_flag) if field else -1,
            top_poc=top_poc,
            bottom_poc=bottom_poc,
            decoded=decoded,
            **col_arrays,
        )
        # the slice threads, started here: the task may run on a worker
        slice_exec = self._slice_pool() if use_native and len(calls) > 1 else None
        setup.end()
        self._submit_entropy(
            partial(self._decode_entropy, pic, calls, native_state, slice_exec,
                    colocated, ft, motion),
            use_native,
        )
        finish = span(self.metrics, "picture_finish")
        finish.start()
        if self.metrics is not None:
            self.metrics.count("frames")
            self.metrics.count("mbs", ft.n_mbs)
        # the hand-off: from here the reconstruction owns ft and the rest
        # of the picture's buffers (with GpuDecoder, its recon worker, once
        # the picture's task has decoded them and the wire is built), and
        # returns them to self._frames when it is done; this thread reads
        # none of them after the call
        finish.pause()
        y, cb, cr = self._submit_reconstruct(
            ft, sps, pps, slices, ref_lists, weight_ctx, poc, decoded
        )
        finish.start()
        pic.y, pic.cb, pic.cr = y, cb, cr
        self.uid_counter += 1
        if hdr0.nal_ref_idc:
            self.dpb.mark(pic, hdr0)
        if field:
            # PAFF: hold the first field; weave the complementary pair into
            # one output frame (row-interleaved) when the second arrives
            par = int(hdr0.bottom_field_flag)
            cur = (
                np.asarray(y), np.asarray(cb), np.asarray(cr),
                par, poc, hdr0.idr_pic_flag,
            )
            if self._first_field is None or self._first_field[3] == par:
                self._first_field = cur  # first (or orphaned) field
                finish.end()
                return None
            fy, fcb, fcr, fpar, fpoc, fidr = self._first_field
            self._first_field = None

            def weave(a, b, pa, pb):
                out = np.empty((a.shape[0] * 2, a.shape[1]), a.dtype)
                out[pa::2] = a
                out[pb::2] = b
                return out

            df = DecodedFrame(
                y=weave(fy, cur[0], fpar, par),
                cb=weave(fcb, cur[1], fpar, par),
                cr=weave(fcr, cur[2], fpar, par),
                poc=min(fpoc, poc),
                frame_num=hdr0.frame_num,
                is_idr=fidr or hdr0.idr_pic_flag,
                idr_group=self.idr_group,
                sps=sps,
            )
        else:
            df = DecodedFrame(
                y=y,
                cb=cb,
                cr=cr,
                poc=poc,
                frame_num=hdr0.frame_num,
                is_idr=hdr0.idr_pic_flag,
                idr_group=self.idr_group,
                sps=sps,
            )
        if self._pending_recovery is not None:
            df.recovery_point = self._pending_recovery
            self._pending_recovery = None
        finish.end()
        return df


def _python_slice(cls, *args, **kw) -> None:
    """One slice on the Python engine (CavlcSliceDecoder or
    CabacSliceDecoder)."""
    cls(*args, **kw).decode()


def decode_annexb(data: bytes, apply_deblock: bool = True) -> list[DecodedFrame]:
    return Decoder(apply_deblock=apply_deblock).decode_stream(data)
