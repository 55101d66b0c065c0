"""ctypes binding of the fused host preprocessing library (``csrc/preproc.cc``).

Port of ``rtm3d_tpu/data/native.py``: ``warp_normalize`` (one image),
``warp_normalize_batch`` (a batch on the library's thread pool) and the host
``splat_heatmap``. The library is the port's own copy of
``native/preproc.cc``, built at first use by
``utils/kernel_build.py::build_host`` into ``_build/``; a failed build
raises. There is no path override and no fallback: ``data/fast_preproc.py``
runs only on this library.

Images are uint8 HWC BGR; ``M`` is the forward 2x3 affine (source to
destination, ``cv2.warpAffine``'s convention); the output is float32
normalised ``(bilinear(src) / 255 - mean) / std`` with the border colour
outside the source.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """``csrc/preproc.cc``, built first if needed; raises if it does not build."""
    from rtm3d_tpu_torch.utils import kernel_build

    lib = kernel_build.load_host("preproc")
    lib.rtm3d_warp_normalize.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, _F32P, _F32P, _F32P, ctypes.c_int,
                                         ctypes.c_int, _F32P, _F32P]
    lib.rtm3d_warp_normalize.restype = None
    lib.rtm3d_warp_normalize_batch.argtypes = [ctypes.POINTER(_U8P), _I32P, _I32P, _F32P, _F32P, _F32P,
                                               ctypes.c_int, ctypes.c_int, ctypes.c_int, _F32P, _F32P]
    lib.rtm3d_warp_normalize_batch.restype = None
    lib.rtm3d_splat_heatmap.argtypes = [_F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _I32P, _I32P, _F32P,
                                        _F32P, _U8P, _U8P, ctypes.c_int]
    lib.rtm3d_splat_heatmap.restype = None
    return lib


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _ptr(a: np.ndarray, p):
    return a.ctypes.data_as(p)


def _image(src) -> np.ndarray:
    src = np.ascontiguousarray(src, np.uint8)
    if src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"an image must be (H, W, 3) uint8, got {src.shape}")
    return src


def warp_normalize(src: np.ndarray, M: np.ndarray, out_hw, mean, std, border: Optional[np.ndarray] = None):
    """Fused affine warp + border fill + normalise of one image: float32
    (out_h, out_w, 3). ``border`` (3,) in 0..255, the source's mean colour
    when None."""
    lib = load_library()
    src = _image(src)
    Mf = _f32(M).reshape(6)
    border = _f32(src.reshape(-1, 3).mean(axis=0) if border is None else border).reshape(3)
    mean, std = _f32(mean).reshape(3), _f32(std).reshape(3)
    oh, ow = (int(v) for v in out_hw)
    dst = np.empty((oh, ow, 3), np.float32)
    lib.rtm3d_warp_normalize(_ptr(src, _U8P), src.shape[0], src.shape[1], _ptr(Mf, _F32P), _ptr(border, _F32P),
                             _ptr(dst, _F32P), oh, ow, _ptr(mean, _F32P), _ptr(std, _F32P))
    return dst


def warp_normalize_batch(srcs, Ms, out_hw, mean, std, borders=None) -> np.ndarray:
    """``warp_normalize`` of each source (sizes may differ) on the library's
    thread pool: float32 (n, out_h, out_w, 3)."""
    lib = load_library()
    srcs = [_image(s) for s in srcs]
    n = len(srcs)
    oh, ow = (int(v) for v in out_hw)
    Ms = _f32(Ms).reshape(n, 6)
    if borders is None:
        borders = np.stack([s.reshape(-1, 3).mean(axis=0) for s in srcs])
    borders = _f32(borders).reshape(n, 3)
    mean, std = _f32(mean).reshape(3), _f32(std).reshape(3)
    dst = np.empty((n, oh, ow, 3), np.float32)
    ptrs = (_U8P * n)(*[_ptr(s, _U8P) for s in srcs])
    shs = np.array([s.shape[0] for s in srcs], np.int32)
    sws = np.array([s.shape[1] for s in srcs], np.int32)
    lib.rtm3d_warp_normalize_batch(ptrs, _ptr(shs, _I32P), _ptr(sws, _I32P), _ptr(Ms, _F32P),
                                   _ptr(borders, _F32P), _ptr(dst, _F32P), n, oh, ow, _ptr(mean, _F32P),
                                   _ptr(std, _F32P))
    return dst


def splat_heatmap(hm: np.ndarray, centers, cls, sigma, radius, noise, mask) -> np.ndarray:
    """Gaussian max-splat into ``hm`` (C, H, W) float32 contiguous, in place
    (and returned): per masked slot, ``exp(-d^2 / 2 sigma^2)`` within
    ``int(radius)`` of its integer center, 0.9999 at a noise slot's center."""
    lib = load_library()
    if not (isinstance(hm, np.ndarray) and hm.dtype == np.float32 and hm.ndim == 3 and hm.flags.c_contiguous):
        raise ValueError("splat_heatmap: hm must be a C-contiguous (C, H, W) float32 array, updated in place")
    centers = np.ascontiguousarray(centers, np.int32).reshape(-1, 2)
    n = len(centers)
    cls = np.ascontiguousarray(cls, np.int32).reshape(n)
    sigma, radius = _f32(sigma).reshape(n), _f32(radius).reshape(n)
    noise = np.ascontiguousarray(noise, np.uint8).reshape(n)
    mask = np.ascontiguousarray(mask, np.uint8).reshape(n)
    C, H, W = hm.shape
    lib.rtm3d_splat_heatmap(_ptr(hm, _F32P), C, H, W, _ptr(centers, _I32P), _ptr(cls, _I32P), _ptr(sigma, _F32P),
                            _ptr(radius, _F32P), _ptr(noise, _U8P), _ptr(mask, _U8P), n)
    return hm
