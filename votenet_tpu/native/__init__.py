"""ctypes bindings for the native host library (see votenet_native.cpp).

The library is built on demand with ``make`` (g++); every entry point has a
pure-Python/numpy fallback so the framework works without a toolchain. Use
:func:`available` to check whether the native path is active.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "build", "libvotenet_native.so")  # gitignored
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO):
        try:
            subprocess.run(
                ["make", "-C", _DIR, "-s"], check=True, capture_output=True, timeout=120
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None

    lib.vn_parse_floats.restype = ctypes.c_int64
    lib.vn_parse_floats.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
    ]
    lib.vn_iou3d_matrix.restype = None
    lib.vn_iou3d_matrix.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.vn_greedy_match.restype = None
    lib.vn_greedy_match.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.vn_nms3d.restype = None
    lib.vn_nms3d.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def parse_floats(text: str) -> np.ndarray:
    """Fast whitespace-float parsing (native) with numpy fallback."""
    lib = _load()
    if lib is None:
        return np.array(text.split(), dtype=np.float64)
    raw = text.encode()
    cap = max(len(raw) // 2 + 16, 16)  # >= one float per 2 bytes is impossible
    out = np.empty(cap, dtype=np.float64)
    n = lib.vn_parse_floats(
        raw, len(raw), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap
    )
    return out[:n].copy()


def iou3d_matrix(dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """(D,8,3) x (G,8,3) -> (D,G) exact oriented 3D IoU on the host."""
    lib = _load()
    dets = np.ascontiguousarray(dets, dtype=np.float32)
    gts = np.ascontiguousarray(gts, dtype=np.float32)
    D, G = len(dets), len(gts)
    if lib is None:
        from votenet_tpu.eval.iou import iou_3d

        out = np.zeros((D, G), np.float32)
        for i in range(D):
            for j in range(G):
                out[i, j] = iou_3d(dets[i], gts[j])
        return out
    out = np.empty((D, G), dtype=np.float32)
    if D and G:
        lib.vn_iou3d_matrix(_fptr(dets), D, _fptr(gts), G, _fptr(out))
    return out


def greedy_match(iou: np.ndarray, ovthresh: float):
    """VOC TP/FP marking for confidence-sorted detections of one image."""
    lib = _load()
    iou = np.ascontiguousarray(iou, dtype=np.float32)
    D, G = iou.shape
    tp = np.zeros(D, dtype=np.uint8)
    fp = np.zeros(D, dtype=np.uint8)
    if lib is None:
        used = np.zeros(G, dtype=bool)
        for d in range(D):
            j = int(np.argmax(iou[d])) if G else -1
            if j >= 0 and iou[d, j] > ovthresh and not used[j]:
                tp[d] = 1
                used[j] = True
            else:
                fp[d] = 1
        return tp, fp
    if D:
        lib.vn_greedy_match(_fptr(iou), D, G, ovthresh, _u8ptr(tp), _u8ptr(fp))
    return tp, fp


def nms3d_host(corners: np.ndarray, scores: np.ndarray, obj: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Host greedy NMS keep-mask for one batch element (n, 8, 3)."""
    lib = _load()
    corners = np.ascontiguousarray(corners, dtype=np.float32)
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    obj = np.ascontiguousarray(obj, dtype=np.float32)
    n = len(scores)
    keep = np.zeros(n, dtype=np.uint8)
    if lib is None:
        order = np.argsort(-scores, kind="stable")
        selected = []
        from votenet_tpu.eval.iou import iou_3d

        for i in order:
            if not (obj[i, 1] > obj[i, 0]):
                continue
            if all(iou_3d(corners[i], corners[j]) <= iou_threshold for j in selected):
                selected.append(i)
                keep[i] = 1
        return keep.astype(bool)
    if n:
        lib.vn_nms3d(_fptr(corners), _fptr(scores), _fptr(obj), n, iou_threshold, _u8ptr(keep))
    return keep.astype(bool)
