"""ctypes binding for the native (C++) entropy engine, native/h264_entropy.cpp.

Drop-in replacement for the Python CavlcSliceDecoder/CabacSliceDecoder on the
hot path: decodes a whole slice's macroblocks directly into the FrameTensors
buffers. Validated bit-exactly against the Python reference by the test
suite. Stream shapes the engine does not support (see `supported`) decode on
the Python engine; a missing or failing build raises instead of falling back.

This package compiles the engine itself, from the C++ sources in the
repository's `native/` directory, into its own build directory
(h264decode_tpu_torch/_build/) at first use, with the flags of
native/Makefile. The library file name carries a hash of the sources and
flags, so an edited source is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from collections import Counter
from ctypes import POINTER, c_int8, c_int16, c_int32, c_int64, c_uint8, c_void_p

import numpy as np

from ..tensors.frame_tensors import MB_B_DIRECT, MB_I_PCM, MB_P, FrameTensors
from ..utils.metrics import timer
from .mv_pred import MotionContext

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(os.path.dirname(_PKG), "native")
_BUILD_DIR = os.path.join(_PKG, "_build")
_SOURCES = ("h264_entropy.cpp", "entropy_cavlc.inc", "entropy_cabac.inc",
            "tables.h")
# native/Makefile:2
_CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-march=native"]

_lib = None
_lock = threading.Lock()

#: slices decoded by the native engine in this process (a run can show
#: that the engine, not the Python fallback, did the entropy decoding)
calls: Counter = Counter()


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(_CXXFLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_SRC_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libh264entropy_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # build into a private name, then rename: concurrent test workers may
    # race to build the same library
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *_CXXFLAGS, os.path.join(_SRC_DIR, "h264_entropy.cpp"),
           "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"building the native entropy engine failed: {' '.join(cmd)}\n"
            f"{res.stderr}"
        )
    os.replace(tmp, path)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.decode_slice.restype = c_int32
        lib.decode_slice.argtypes = [
            POINTER(c_uint8),
            c_int64,
            c_int64,
            c_void_p,
            c_void_p,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    """True unless H264_NATIVE=0 asks for the Python engine. Builds and
    loads the library on first call; a failed build raises."""
    if os.environ.get("H264_NATIVE", "1") == "0":
        return False
    return _load() is not None


class _SliceParams(ctypes.Structure):
    _fields_ = [
        ("cabac", c_int32),
        ("slice_type", c_int32),
        ("slice_qp", c_int32),
        ("cabac_init_idc", c_int32),
        ("first_mb", c_int32),
        ("mb_w", c_int32),
        ("mb_h", c_int32),
        ("n_ref0", c_int32),
        ("n_ref1", c_int32),
        ("transform8x8_mode", c_int32),
        ("constrained_intra", c_int32),
        ("chroma_format", c_int32),
        ("direct_8x8_inference", c_int32),
        ("spatial_direct", c_int32),
        ("disable_deblock", c_int32),
        ("alpha_off", c_int32),
        ("beta_off", c_int32),
        ("slice_id", c_int32),
        ("cur_poc", c_int32),
        ("col_short_term", c_int32),
        ("col_poc", c_int32),
        ("n_col", c_int32),
        ("field_pic", c_int32),
        ("sp_slice", c_int32),
        ("is_si", c_int32),
        ("mbaff", c_int32),
        ("col_top_poc", c_int32),
        ("col_bottom_poc", c_int32),
        ("has_mb_next", c_int32),
        ("has_dp", c_int32),
        ("bit_depth_luma", c_int32),
        ("bit_depth_chroma", c_int32),
        ("ref_uids0", c_void_p),
        ("ref_uids1", c_void_p),
        ("l0_pocs", c_void_p),
        ("l0_lt", c_void_p),
        ("col_mv", c_void_p),
        ("col_ref_idx", c_void_p),
        ("col_ref_uid", c_void_p),
        ("col_mb_field", c_void_p),
        ("mb_next", c_void_p),
        ("part_b", c_void_p),
        ("part_b_len", c_int64),
        ("part_b_bit", c_int64),
        ("part_c", c_void_p),
        ("part_c_len", c_int64),
        ("part_c_bit", c_int64),
        ("col_ref_parity", c_void_p),
        ("l0_top_pocs", c_void_p),
        ("l0_bottom_pocs", c_void_p),
        ("n_l0_field", c_int32),
        ("cur_top_poc", c_int32),
        ("cur_bottom_poc", c_int32),
    ]


_FB_FIELDS = [
    "mb_class", "transform8x8", "qp", "cbp", "intra4x4_modes", "intra16_mode",
    "chroma_mode", "luma_ac", "luma_dc", "luma8_ac", "chroma_dc", "chroma_ac",
    "mv", "ref_idx", "pred_flags", "ref_pic", "slice_id", "disable_deblock",
    "alpha_off", "beta_off", "cbf_dc", "luma_nnz", "chroma_nnz",
    "g_mv", "g_ref", "g_refctx", "g_absmvd", "mode_grid",
    "decode_order", "n_decoded", "pcm_y", "pcm_cb", "pcm_cr",
    "sp_slice_mb", "c444_dc", "c444_ac", "c444_8x8", "c444_nnz",
    "mb_field", "ref_parity",
]


class _FrameBuffers(ctypes.Structure):
    _fields_ = [(name, c_void_p) for name in _FB_FIELDS]


def _ptr(a: np.ndarray) -> c_void_p:
    assert a.flags["C_CONTIGUOUS"], "buffer must be contiguous"
    return c_void_p(a.ctypes.data)


class NativeFrameState:
    """Per-frame buffers shared by the native engine across slices: the
    FrameTensors, motion context and intra mode grid it decodes into, side
    buffers of its own (decode order, PCM samples) and the _FrameBuffers
    struct that points at all of them, built once. reset() makes the
    whole set read as a fresh one, so FramePool reuses it. `metrics` (a
    DecodeMetrics or None) times each engine call as `entropy_native`, on
    the thread that makes it."""

    def __init__(self, ft, motion, intra_mode_grid, bit_depth: int = 8, metrics=None):
        self.ft = ft
        self.metrics = metrics
        self.motion = motion
        self.modes = intra_mode_grid
        n = ft.n_mbs
        ft.ensure_luma8()
        if ft.chroma_format == 3:
            ft.ensure_c444_8x8()
        # PCM chroma extents by format (MbHeightC x chroma MB width)
        self._pcm_ch = ft.ch_mb_h
        self._pcm_cw = 16 if ft.chroma_format == 3 else 8
        self._pcm_dtype = np.uint16 if bit_depth > 8 else np.uint8
        # side buffers the engine writes into; finish() copies the PCM
        # regions out and reset() clears them
        self.decode_order = np.zeros(n, np.int32)
        self.n_decoded = np.zeros(1, np.int32)
        self.pcm_y = np.zeros((ft.mb_h * 16, ft.mb_w * 16), self._pcm_dtype)
        self.pcm_cb = np.zeros((ft.mb_h * self._pcm_ch, ft.mb_w * self._pcm_cw),
                               self._pcm_dtype)
        self.pcm_cr = np.zeros_like(self.pcm_cb)
        fb = _FrameBuffers()
        fb.mb_class = _ptr(ft.mb_class)
        fb.transform8x8 = _ptr(ft.transform_8x8)
        fb.qp = _ptr(ft.qp)
        fb.cbp = _ptr(ft.cbp)
        fb.intra4x4_modes = _ptr(ft.intra4x4_modes)
        fb.intra16_mode = _ptr(ft.intra16_mode)
        fb.chroma_mode = _ptr(ft.chroma_mode)
        fb.luma_ac = _ptr(ft.luma_ac)
        fb.luma_dc = _ptr(ft.luma_dc)
        fb.luma8_ac = _ptr(ft.luma8_ac)
        fb.chroma_dc = _ptr(ft.chroma_dc)
        fb.chroma_ac = _ptr(ft.chroma_ac)
        fb.mv = _ptr(ft.mv)
        fb.ref_idx = _ptr(ft.ref_idx)
        fb.pred_flags = _ptr(ft.pred_flags)
        fb.ref_pic = _ptr(ft.ref_pic)
        fb.slice_id = _ptr(ft.slice_id)
        fb.disable_deblock = _ptr(ft.disable_deblock)
        fb.alpha_off = _ptr(ft.alpha_off)
        fb.beta_off = _ptr(ft.beta_off)
        fb.cbf_dc = _ptr(ft.cbf_dc)
        fb.luma_nnz = _ptr(ft.luma_nnz)
        fb.chroma_nnz = _ptr(ft.chroma_nnz)
        fb.g_mv = _ptr(motion.mv)
        fb.g_ref = _ptr(motion.ref)
        fb.g_refctx = _ptr(motion.refctx)
        fb.g_absmvd = _ptr(motion.absmvd)
        fb.mode_grid = _ptr(self.modes)
        fb.decode_order = _ptr(self.decode_order)
        fb.n_decoded = _ptr(self.n_decoded)
        fb.pcm_y = _ptr(self.pcm_y)
        fb.pcm_cb = _ptr(self.pcm_cb)
        fb.pcm_cr = _ptr(self.pcm_cr)
        fb.sp_slice_mb = _ptr(ft.sp_slice_mb)
        fb.mb_field = _ptr(ft.mb_field)
        fb.ref_parity = _ptr(ft.ref_parity)
        if ft.chroma_format == 3:
            fb.c444_dc = _ptr(ft.c444_dc)
            fb.c444_ac = _ptr(ft.c444_ac)
            fb.c444_8x8 = _ptr(ft.c444_8x8)
            fb.c444_nnz = _ptr(ft.c444_nnz)
        self.fb = fb
        self._keepalive = []
        self._par_orders: list[tuple[np.ndarray, np.ndarray]] = []
        self._mono = False

    def reset(self) -> None:
        """Return every buffer of the set to its fresh value in place (the
        FrameTensors as far as its `coded` rows reach): the engine then
        reads the set as a newly made one."""
        ft, ch, cw = self.ft, self._pcm_ch, self._pcm_cw
        for addr in ft.pcm_samples:  # the regions the engine wrote
            mbx, mby = ft.mb_xy(addr)
            self.pcm_y[mby * 16 : mby * 16 + 16, mbx * 16 : mbx * 16 + 16] = 0
            self.pcm_cb[mby * ch : (mby + 1) * ch, mbx * cw : (mbx + 1) * cw] = 0
            self.pcm_cr[mby * ch : (mby + 1) * ch, mbx * cw : (mbx + 1) * cw] = 0
        self.decode_order[...] = 0
        self.n_decoded[0] = 0
        inter = bool(((ft.mb_class >= MB_P) & (ft.mb_class <= MB_B_DIRECT)).any())
        ft.reset(inter)
        self.motion.reset(inter)
        self.modes[...] = -1
        self._keepalive.clear()
        self._par_orders.clear()
        self._mono = False

    def parallel_fb(self) -> "_FrameBuffers":
        """A per-slice _FrameBuffers clone whose decode_order/n_decoded
        point at PRIVATE buffers: concurrent slice decodes share every
        per-MB output array (disjoint MB rows by construction — slices
        partition the picture, and the engine masks cross-slice neighbor
        reads by the slice_id check, whose -1 init makes the comparison
        value-stable under concurrent aligned int32 writes) but must not
        race the shared decode-order counter. Call in slice order on ONE
        thread; finish() merges the private orders in that order."""
        fb2 = _FrameBuffers()
        ctypes.memmove(
            ctypes.byref(fb2), ctypes.byref(self.fb), ctypes.sizeof(fb2)
        )
        order = np.zeros(self.ft.n_mbs, np.int32)
        cnt = np.zeros(1, np.int32)
        fb2.decode_order = _ptr(order)
        fb2.n_decoded = _ptr(cnt)
        self._par_orders.append((order, cnt))
        self._keepalive.append(fb2)
        return fb2

    def finish(self):
        """Mirror side state back into Python structures."""
        ft = self.ft
        for order, pcnt in self._par_orders:
            ft.decode_order.extend(order[: int(pcnt[0])].tolist())
        self._par_orders.clear()
        cnt = int(self.n_decoded[0])
        ft.decode_order.extend(self.decode_order[:cnt].tolist())
        self.n_decoded[0] = 0
        ch, cw = self._pcm_ch, self._pcm_cw
        mono = np.zeros((8, 8), self._pcm_dtype)
        for addr in np.nonzero(ft.mb_class == MB_I_PCM)[0]:
            mbx, mby = ft.mb_xy(int(addr))
            y = self.pcm_y[mby * 16 : mby * 16 + 16, mbx * 16 : mbx * 16 + 16].copy()
            if self._mono:
                cb, cr = mono, mono
            else:
                cb = self.pcm_cb[mby * ch : (mby + 1) * ch,
                                 mbx * cw : (mbx + 1) * cw].copy()
                cr = self.pcm_cr[mby * ch : (mby + 1) * ch,
                                 mbx * cw : (mbx + 1) * cw].copy()
            ft.pcm_samples[int(addr)] = (y, cb, cr)


class FramePool:
    """A decoder's NativeFrameStates (each with its FrameTensors, motion
    context and mode grid), reused across pictures of one geometry. take()
    hands out an idle state, or a new one when none is idle: the pool grows
    rather than blocks, to as many states as were held at once. give(ft)
    takes back the state of `ft` once nothing reads it any more, resets it
    on the calling thread and keeps it. Only the geometry last taken is
    kept. take() and give() may run on different threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._key = None
        self._idle: list[NativeFrameState] = []
        self._out: dict[int, tuple[tuple, NativeFrameState]] = {}  # id(ft) ->

    def take(self, mb_h: int, mb_w: int, chroma_format: int, bit_depth: int,
             metrics=None) -> NativeFrameState:
        key = (mb_h, mb_w, chroma_format, bit_depth)
        with self._lock:
            if key != self._key:
                self._key = key
                self._idle.clear()
            state = self._idle.pop() if self._idle else None
        if state is None:
            ft = FrameTensors(mb_w=mb_w, mb_h=mb_h, chroma_format=chroma_format)
            state = NativeFrameState(ft, MotionContext(mb_w, mb_h, ft.slice_id),
                                     np.full((mb_h * 4, mb_w * 4), -1, np.int8),
                                     bit_depth=bit_depth)
        state.metrics = metrics
        with self._lock:
            self._out[id(state.ft)] = (key, state)
        return state

    def give(self, ft) -> None:
        """Reset and keep the state of `ft` (a no-op for a FrameTensors
        this pool did not hand out, or forgot)."""
        with self._lock:
            key, state = self._out.pop(id(ft), (None, None))
        if state is None:
            return
        state.reset()
        with self._lock:
            if key == self._key:
                self._idle.append(state)

    def forget(self) -> None:
        """Keep none of the states handed out so far: after a picture
        failed, a slice thread may still write its buffers."""
        with self._lock:
            self._out.clear()


def supported(sps, pps, hdr) -> bool:
    return (
        # PCM buffers are sized by ONE dtype; unequal luma/chroma depths
        # (spec-legal but unseen in practice) route to the Python engine so
        # a hostile depth combination can never out-write the PCM buffers.
        # Depth range itself is validated at SPS parse (8..14).
        (
            sps.chroma_array_type == 0
            or sps.bit_depth_chroma == sps.bit_depth_luma
        )
        # FMO decodes natively through the host-built next-address LUT;
        # FMO + MBAFF (pair-unit maps) stays on the Python engine
        and (pps.num_slice_groups == 1 or not hdr.mbaff_frame_flag)
        # data partitioning decodes natively for CAVLC (Extended profile
        # forbids CABAC+DP; the decoder rejects that combination upstream)
        and not (
            getattr(hdr, "dp_readers", None) and pps.entropy_coding_mode_flag
        )
    )


def decode_slice_native(
    state: NativeFrameState,
    hdr,
    sps,
    pps,
    rbsp: bytes,
    slice_id: int,
    ref_uids_l0,
    ref_uids_l1,
    direct_ctx,
    mb_map=None,
    fb: "_FrameBuffers | None" = None,
) -> None:
    lib = _load()
    p = _SliceParams()
    p.cabac = int(pps.entropy_coding_mode_flag)
    p.slice_type = {0: 0, 1: 1, 2: 2, 3: 0, 4: 2}[hdr.type]
    p.field_pic = int(hdr.field_pic_flag)
    p.sp_slice = int(hdr.is_sp or hdr.is_si)
    p.is_si = int(hdr.is_si)
    p.mbaff = int(hdr.mbaff_frame_flag)
    p.bit_depth_luma = sps.bit_depth_luma
    p.bit_depth_chroma = sps.bit_depth_chroma
    state._mono = sps.chroma_array_type == 0
    ka = state._keepalive
    dp = getattr(hdr, "dp_readers", None)
    if dp is not None:
        p.has_dp = 1
        for cat, (attr_d, attr_l, attr_s) in (
            (3, ("part_b", "part_b_len", "part_b_bit")),
            (4, ("part_c", "part_c_len", "part_c_bit")),
        ):
            rd = dp.get(cat)
            if rd is None:
                continue
            buf = np.frombuffer(rd.data, np.uint8)
            ka.append(buf)
            setattr(p, attr_d, c_void_p(buf.ctypes.data))
            setattr(p, attr_l, len(rd.data))
            setattr(p, attr_s, rd.pos)
    if pps.num_slice_groups > 1 and mb_map is not None:
        # 8.2.2.8 next-address LUT: for each MB, the next MB of its slice
        # group in raster order (n past the end -> walk terminates)
        mm = np.asarray(mb_map, np.int32)
        n = len(mm)
        nxt = np.full(n, n, np.int32)
        for g in np.unique(mm):
            idxs = np.flatnonzero(mm == g)
            nxt[idxs[:-1]] = idxs[1:]
        ka.append(nxt)
        p.mb_next = c_void_p(nxt.ctypes.data)
        p.has_mb_next = 1
    p.slice_qp = hdr.slice_qp(pps)
    p.cabac_init_idc = hdr.cabac_init_idc
    p.first_mb = hdr.first_mb_in_slice
    p.mb_w = state.ft.mb_w
    p.mb_h = state.ft.mb_h
    p.n_ref0 = len(ref_uids_l0)
    p.n_ref1 = len(ref_uids_l1)
    p.transform8x8_mode = int(pps.transform_8x8_mode_flag)
    p.constrained_intra = int(pps.constrained_intra_pred_flag)
    p.chroma_format = sps.chroma_array_type
    p.direct_8x8_inference = int(sps.direct_8x8_inference_flag)
    p.disable_deblock = hdr.disable_deblocking_filter_idc
    p.alpha_off = hdr.slice_alpha_c0_offset_div2 * 2
    p.beta_off = hdr.slice_beta_offset_div2 * 2
    p.slice_id = slice_id

    uids0 = np.asarray(ref_uids_l0 or [0], np.int32)
    uids1 = np.asarray(ref_uids_l1 or [0], np.int32)
    ka += [uids0, uids1]
    p.ref_uids0 = c_void_p(uids0.ctypes.data)
    p.ref_uids1 = c_void_p(uids1.ctypes.data)
    if direct_ctx is not None:
        p.cur_poc = direct_ctx.cur_poc
        p.col_short_term = int(direct_ctx.col_is_short_term)
        p.col_poc = direct_ctx.col_poc
        p.col_top_poc = int(direct_ctx.col_top_poc or 0)
        p.col_bottom_poc = int(direct_ctx.col_bottom_poc or 0)
        p.spatial_direct = int(direct_ctx.spatial)
        # the colocated arrays pass as they are when they already have the
        # engine's dtype and layout (colocated_motion makes them so)
        if direct_ctx.col_mb_field is not None:
            cmf = np.ascontiguousarray(direct_ctx.col_mb_field, np.uint8)
            ka.append(cmf)
            p.col_mb_field = c_void_p(cmf.ctypes.data)
        l0_pocs = np.asarray(direct_ctx.l0_pocs or [0], np.int32)
        l0_lt = np.asarray(
            [1 if x else 0 for x in (direct_ctx.l0_long_term or [0])], np.uint8
        )
        ka += [l0_pocs, l0_lt]
        p.l0_pocs = c_void_p(l0_pocs.ctypes.data)
        p.l0_lt = c_void_p(l0_lt.ctypes.data)
        # MBAFF-field temporal direct: list-0 FIELD order counts + the
        # colocated referenced-field parities (direct.py field variant)
        if direct_ctx.l0_top_pocs is not None:
            l0_tp = np.asarray(direct_ctx.l0_top_pocs or [0], np.int32)
            l0_bp = np.asarray(direct_ctx.l0_bottom_pocs or [0], np.int32)
            ka += [l0_tp, l0_bp]
            p.l0_top_pocs = c_void_p(l0_tp.ctypes.data)
            p.l0_bottom_pocs = c_void_p(l0_bp.ctypes.data)
            p.n_l0_field = min(len(l0_tp), len(l0_bp))
        cf = getattr(direct_ctx.cur_ft, "cur_field_pocs", None)
        if cf is not None:
            p.cur_top_poc = int(cf[0])
            p.cur_bottom_poc = int(cf[1])
        if direct_ctx.col_ref_parity is not None:
            crp = np.ascontiguousarray(direct_ctx.col_ref_parity, np.int8)
            ka.append(crp)
            p.col_ref_parity = c_void_p(crp.ctypes.data)
        if direct_ctx.col_mv is not None:
            col_mv = np.ascontiguousarray(direct_ctx.col_mv, np.int32)
            col_ri = np.ascontiguousarray(direct_ctx.col_ref_idx, np.int8)
            col_ru = np.ascontiguousarray(direct_ctx.col_ref_uid, np.int32)
            ka += [col_mv, col_ri, col_ru]
            p.col_mv = c_void_p(col_mv.ctypes.data)
            p.col_ref_idx = c_void_p(col_ri.ctypes.data)
            p.col_ref_uid = c_void_p(col_ru.ctypes.data)
            p.n_col = 1
        else:
            p.n_col = 0
    else:
        zero = np.zeros(1, np.int32)
        zero8 = np.zeros(1, np.uint8)
        ka += [zero, zero8]
        p.l0_pocs = c_void_p(zero.ctypes.data)
        p.l0_lt = c_void_p(zero8.ctypes.data)
        p.n_col = 0
        p.spatial_direct = 1

    buf = np.frombuffer(rbsp, np.uint8)
    ka.append(buf)
    calls["decode_slice"] += 1
    with timer(state.metrics, "entropy_native"):
        ret = lib.decode_slice(
            buf.ctypes.data_as(POINTER(c_uint8)),
            len(rbsp),
            hdr.data_bit_offset,
            ctypes.byref(p),
            ctypes.byref(state.fb if fb is None else fb),
        )
    if ret == -4:
        raise ValueError("data partition B/C missing but residual coded")
    if ret != 0:
        raise ValueError(f"native slice decode failed: {ret}")
