"""KITTI dataset reader with fixed-shape padded label blocks.

Port of ``rtm3d_tpu/data/kitti.py:34-509`` (reference semantics:
datasets/dataset_reader.py:16-126), numpy only, so that the loader's
forked workers never touch torch. On disk: ``ImageSets/{split}.txt``,
``training/{image_2,label_2,calib}`` and the optional annotation caches
``cache/{label,k,shape}_{split}.npy``, read and written in the JAX
package's format (either package reads the other's). Without the caches
a label_2 + calib parser builds them and writes them for next time.

Cache row layout (13 cols): [raw_cls_id, x1, y1, x2, y2, h, w, l, alpha,
ry, x, y, z] (dataset_reader.py:94-103).

Samples are fixed-shape: images padded to the target size with the
per-image mean colour (bbox/K principal point shifted, reference
``_apply_padding`` dataset_reader.py:175-195), label blocks padded to
``MAX_OBJS`` slots with mask 0, empty slots carrying the image K.

The modes, as in the JAX package:
- host: decode, ``transforms.train_augmentation``/``test_transform``,
  pad; uint8 out when ``TPU.NORMALIZE_ON_DEVICE`` (the default);
- raw (``TPU.DEVICE_WARP``, ``_getitem_raw``): the uint8 source on a
  common canvas plus the affine scalars, the photometric parameters and
  the border colour; the step warps on the device (``ops/device_warp.py``);
- device cache (``TPU.DEVICE_DATA_CACHE`` with ``DEVICE_WARP``): as raw,
  with ``image_idx`` in place of the pixels (``canvas_array`` is copied
  to the device once);
- fused (``DATASET.FAST_PREPROC`` True or "auto", without mosaic):
  ``data/fast_preproc.py::FusedPreproc``, one host C++ resample to a
  normalised float32 frame (the port always builds its library, so "auto"
  takes it too, as the JAX reader's does once its library is built, and a
  failed build raises); on an H100's host it is slower than the host mode
  (``PERF.md`` section 5);
- mosaic (``IS_MOSAIC``, training only): the sample's frame and 3 drawn
  from ``rng`` (``rtm3d_tpu/data/kitti.py:442-458``), each through the host
  augmentation, composed 2x2 and warped by ``transforms.RandomAffine2D``;
  it turns the device warp off, and the calib is the first tile's.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from rtm3d_tpu_torch.config import Config
from rtm3d_tpu_torch.data import image_io
from rtm3d_tpu_torch.data.fast_preproc import FusedPreproc, transform_labels_affine
from rtm3d_tpu_torch.data.transforms import Compose, RandomAffine2D, test_transform, train_augmentation
from rtm3d_tpu_torch.geometry.projection import name_2_label
from rtm3d_tpu_torch.ops.device_warp import warp_params_for


def parse_label_file(path: str) -> np.ndarray:
    """Parse a KITTI label_2 txt into the 13-col cache layout."""
    rows = []
    with open(path) as f:
        for line in f.read().splitlines():
            p = line.split()
            if not p:
                continue
            try:
                cls_id = name_2_label(p[0])
            except ValueError:
                continue
            vals = [float(v) for v in p[1:15]]
            # fields: trunc occl alpha x1 y1 x2 y2 h w l x y z ry
            rows.append(
                [cls_id] + vals[3:7] + vals[7:10] + [vals[2]] + [vals[13]] + vals[10:13]
            )
    if not rows:
        return np.zeros((0, 13), np.float32)
    return np.array(rows, np.float32)


def parse_calib_file(path: str) -> np.ndarray:
    """Extract P2 (3x4) -> K (9,) from a KITTI calib txt
    (reference _load_calib_param, dataset_reader.py:133-138)."""
    with open(path) as f:
        for line in f.read().splitlines():
            if line.startswith("P2:"):
                vals = np.array(line.split()[1:], np.float32).reshape(3, 4)
                return vals[:, :3].reshape(9)
    raise ValueError(f"P2 not found in {path}")


class KITTIDataset:
    def __init__(
        self,
        root: str,
        cfg: Config,
        augment: Optional[Compose] = None,
        is_training: bool = True,
        split: str = "train",
    ):
        self._root = root
        self._cfg = cfg
        self._augment = augment
        self.is_training = is_training
        self._split = split
        self._classes = name_2_label(list(cfg.DATASET.OBJs))
        self._relate_classes = name_2_label([list(x) for x in cfg.DATASET.RELATE_OBJs])
        self.max_objs = int(cfg.DATASET.MAX_OBJS)
        self._norm = {
            "mean_rgb": np.array(cfg.DATASET.MEAN, np.float32).reshape(1, 1, 3),
            "std_rgb": np.array(cfg.DATASET.STD, np.float32).reshape(1, 1, 3),
        }

        with open(os.path.join(root, "ImageSets", f"{split}.txt")) as f:
            self._image_files = sorted(f.read().splitlines())
        self._name_to_idx = {n: i for i, n in enumerate(self._image_files)}

        self._img_cache = None
        self._border_cache: Dict[int, np.ndarray] = {}
        self._labels, self._K, self._shapes = self._load_annotations()
        assert len(self._image_files) == len(self._labels) == len(self._K)

        # decoded-image RAM cache: one decode per image per run, shared
        # copy-on-write with the loader's forked workers
        if bool(cfg.DATASET.get("CACHE_IMAGES", False)):
            self._img_cache = [self._imread(n) for n in self._image_files]

        # the Resize transform scales the max side to this value
        self.resize_max_side = int(cfg.INPUT_SIZE[0])
        self.normalize_on_device = bool(cfg.get("TPU", {}).get("NORMALIZE_ON_DEVICE", True))
        self.img_size = [int(cfg.INPUT_SIZE[0])] * 2  # (W, H)
        if cfg.IS_RECT:
            # rectangular-input sizing (dataset_reader.py:55-61): the longest
            # side of the largest frame to INPUT_SIZE[0], each side rounded
            # up to a multiple of 32
            s = self._shapes.astype(np.float64)
            m = s.max(axis=1)
            r = self.img_size[0] / m
            ns = r.reshape(-1, 1) * s
            ns_max = np.ceil(ns.max(axis=0) / 32).astype(np.int64) * 32
            self.img_size = [int(ns_max[0]), int(ns_max[1])]

        # the fused host resample (data/fast_preproc.py)
        self._fast = None
        if cfg.DATASET.get("FAST_PREPROC", False) in (True, "auto") and not cfg.IS_MOSAIC:
            self._fast = FusedPreproc(out_size=tuple(self.img_size), resize_max_side=self.resize_max_side,
                                      mean=cfg.DATASET.MEAN, std=cfg.DATASET.STD, train=is_training)

        self.device_warp = bool(cfg.TPU.get("DEVICE_WARP", False)) and not cfg.IS_MOSAIC
        self.device_cache = bool(cfg.TPU.get("DEVICE_DATA_CACHE", False)) and self.device_warp
        if self.device_warp:
            self._src_hw = (
                int(self._shapes[:, 1].max()),  # H0max
                int(self._shapes[:, 0].max()),  # W0max
            )

    def canvas_array(self) -> np.ndarray:
        """All frames on the common (H0max, W0max) canvas, zero past each
        frame's true size: (N, H0, W0, 3) uint8, the host-side source of
        the device dataset cache (1.4 MB a KITTI frame)."""
        H0, W0 = self._src_hw
        out = np.zeros((len(self), H0, W0, 3), np.uint8)
        for i, name in enumerate(self._image_files):
            img = self._imread(name)
            out[i, : img.shape[0], : img.shape[1]] = img
            if i not in self._border_cache:
                self._border_cache[i] = image_io.mean_color(img).astype(np.float32)
        return out

    # ------------------------------------------------------------------
    def _load_annotations(self):
        cache_dir = os.path.join(self._root, "cache")
        lf = os.path.join(cache_dir, f"label_{self._split}.npy")
        kf = os.path.join(cache_dir, f"k_{self._split}.npy")
        sf = os.path.join(cache_dir, f"shape_{self._split}.npy")
        if all(os.path.exists(p) for p in (lf, kf, sf)):
            # object arrays of per-frame rows, as the JAX package writes them
            labels = np.load(lf, allow_pickle=True)
            Ks = np.load(kf, allow_pickle=True)
            shapes = np.array(np.load(sf, allow_pickle=True)).astype(np.int64)
            return list(labels), list(Ks), shapes

        labels, Ks, shapes = [], [], []
        for name in self._image_files:
            labels.append(parse_label_file(os.path.join(self._root, "training", "label_2", f"{name}.txt")))
            Ks.append(parse_calib_file(os.path.join(self._root, "training", "calib", f"{name}.txt")))
            img = self._imread(name)
            shapes.append([img.shape[1], img.shape[0]])  # (W, H)
        shapes = np.array(shapes, np.int64)
        try:  # write the caches for next time (best effort, as the JAX package)
            os.makedirs(cache_dir, exist_ok=True)
            _save_atomic(lf, np.array(labels, dtype=object))
            _save_atomic(kf, np.array(Ks, dtype=object))
            _save_atomic(sf, shapes)
        except OSError:
            pass
        return labels, Ks, shapes

    def _getitem_raw(self, index, rng):
        """Device-warp mode: the raw uint8 source on a fixed canvas + the
        affine params; labels mapped on the host by the same affine. In
        device-cache mode no pixel is touched (shape and border come from
        the annotation caches and ``canvas_array``).

        The draws, in this order (kitti.py:229-236): rand; uniform, uniform
        when it was < 0.5; rand; uniform when it was < 0.5; randint; rand;
        uniform when it was < 0.5; rand."""
        if self.device_cache and index in self._border_cache:
            img = None
            w0, h0 = (int(v) for v in self._shapes[index])
        else:
            img = self._imread(self._image_files[index])
            h0, w0 = img.shape[:2]
        labels = self._push_calib(self._raw_labels(index), index)

        if self.is_training:
            # photometric parameters only: the step applies them on the device
            alpha = 1.0 + rng.uniform(-0.2, 0.2) if rng.rand() < 0.5 else 1.0
            beta = rng.uniform(-0.2, 0.2) if alpha != 1.0 else 0.0
            std = rng.uniform(10.0, 50.0) ** 0.5 if rng.rand() < 0.5 else 0.0
            photo = np.array([alpha, beta, std, rng.randint(0, 2**31 - 1)], np.float32)
            scale = rng.uniform(1.0, 1.2) if rng.rand() < 0.5 else 1.0
            mirror = bool(rng.rand() < 0.5)
        else:
            photo = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
            scale, mirror = 1.0, False

        params, M = warp_params_for((h0, w0), tuple(self.img_size), self.resize_max_side, scale, mirror)
        labels = transform_labels_affine(labels, M, mirror, tuple(self.img_size))
        labels, calib = self._pop_calib(labels)
        border = self._border_cache[index] if img is None else self._mean_color(index, img)

        if self.device_cache:
            image = {"image_idx": np.int32(index)}  # the pixels live on the device
        else:
            H0, W0 = self._src_hw
            canvas = np.zeros((H0, W0, 3), np.uint8)
            canvas[:h0, :w0] = img
            image = {"image": canvas}
        return {
            **image,
            "warp": np.concatenate([params, [w0, h0]]).astype(np.float32),
            "border": border,
            "photo": photo,
            "calib": calib,
            "labels": self._pad_objs(labels, calib=calib),
            "path": self._path(index),
            "shape": self._shapes[index],
        }

    def _mean_color(self, index: int, img: np.ndarray) -> np.ndarray:
        """Per-image mean colour (border fill), cached: it does not depend
        on the augmentation."""
        b = self._border_cache.get(index)
        if b is None:
            b = image_io.mean_color(img).astype(np.float32)
            self._border_cache[index] = b
        return b

    def _imread(self, name: str) -> np.ndarray:
        if self._img_cache is not None:
            return self._img_cache[self._name_to_idx[name]]
        return image_io.imread(os.path.join(self._root, "training", "image_2", f"{name}.png"))

    def _path(self, index: int) -> str:
        return os.path.join(self._root, "training", "image_2", f"{self._image_files[index]}.png")

    # ------------------------------------------------------------------
    def _transform_obj_label(self, raw_cls):
        """Class remap with related-class duplication
        (dataset_reader.py:197-213): known -> index; related -> duplicated
        with noise_mask=1; unknown -> -1 (masked by the caller)."""
        dst, noise, repeats = [], [], []
        for label in raw_cls:
            label = int(label)
            if label in self._classes:
                dst.append(self._classes.index(label))
                noise.append(0)
                repeats.append(1)
            else:
                hits = [k for k, rel in enumerate(self._relate_classes) if label in rel]
                if hits:
                    dst += hits
                    noise += [1] * len(hits)
                    repeats.append(len(hits))
                else:
                    dst.append(-1)
                    noise.append(0)
                    repeats.append(1)
        return np.array(dst, np.int64), np.array(noise, np.int64), repeats

    def _raw_labels(self, index: int) -> Dict[str, np.ndarray]:
        arr = np.asarray(self._labels[index], np.float32).reshape(-1, 13)
        cls, noise_mask, repeats = self._transform_obj_label(arr[:, 0])
        arr = np.repeat(arr, repeats=repeats, axis=0)
        N = len(cls)
        K = np.repeat(self._K[index].reshape(1, 9).astype(np.float32), N, axis=0)
        return {
            "cls": cls.astype(np.int32),
            "bbox": arr[:, 1:5].copy(),
            "dim": arr[:, 5:8].copy(),
            "alpha": arr[:, 8].copy(),
            "ry": arr[:, 9].copy(),
            "loc": arr[:, 10:13].copy(),
            "K": K,
            "mask": (cls != -1),
            "noise_mask": noise_mask.astype(bool),
        }

    def _apply_mosaic(self, images, labels_list, rng):
        """4-tile mosaic composition + ``RandomAffine2D`` (reference
        dataset_reader.py:140-173; ``rtm3d_tpu/data/kitti.py:335-373``)."""
        sw, sh = self.img_size
        c = images[0].shape[2]
        mean_rgb = np.mean([image_io.mean_color(im) for im in images], axis=0)
        img4 = np.full((sh * 2, sw * 2, c), mean_rgb, dtype=np.uint8)
        offsets = [(0, 0), (sw, 0), (0, sh), (sw, sh)]
        merged = None
        for (ox, oy), im, lab in zip(offsets, images, labels_list):
            h, w = im.shape[:2]
            pad_w = int(sw - w) // 2
            pad_h = int(sh - h) // 2
            y0, x0 = pad_h + oy, pad_w + ox
            img4[y0 : y0 + h, x0 : x0 + w] = im
            lab["bbox"][:, 0::2] = np.clip(lab["bbox"][:, 0::2] + x0, 0, 2 * sw)
            lab["bbox"][:, 1::2] = np.clip(lab["bbox"][:, 1::2] + y0, 0, 2 * sh)
            lab["K"][:, 2] += x0
            lab["K"][:, 5] += y0
            if merged is None:
                merged = {k: v.copy() for k, v in lab.items()}
            else:
                merged = {k: np.concatenate([merged[k], lab[k]], axis=0) for k in merged}
        d = self._cfg.DATASET
        return RandomAffine2D()(img4, merged, rng=rng, degrees=d.aug_degrees, translate=d.aug_translate,
                                scale=d.aug_scale, shear=d.aug_shear, border=(-sh // 2, -sw // 2))

    def _apply_padding(self, img, labels):
        """Mean-colour pad to (W, H) with bbox/K shift (dataset_reader.py:175-195)."""
        sw, sh = self.img_size
        h, w, c = img.shape
        out = np.full((sh, sw, c), image_io.mean_color(img), dtype=img.dtype)
        pad_w = int(sw - w) // 2
        pad_h = int(sh - h) // 2
        out[pad_h : pad_h + h, pad_w : pad_w + w] = img
        labels["bbox"][:, 0::2] += pad_w
        labels["bbox"][:, 1::2] += pad_h
        labels["K"][:, 2] += pad_w
        labels["K"][:, 5] += pad_h
        return out, labels

    def _push_calib(self, labels, index):
        """Append the image-level K as a shadow row of labels['K'] so every
        geometric transform carries it along; ``_pop_calib`` splits it
        back off (the per-image calib of dataset_reader.py:41-54, even for
        images with empty label files)."""
        row = self._K[index].reshape(1, 9).astype(np.float32)
        labels["K"] = np.concatenate([np.asarray(labels["K"], np.float32), row], 0)
        return labels

    @staticmethod
    def _pop_calib(labels):
        calib = labels["K"][-1].copy()
        labels["K"] = labels["K"][:-1]
        return labels, calib

    def _pad_objs(self, labels, calib=None):
        n = len(labels["cls"])
        m = self.max_objs
        out = {}
        for k, v in labels.items():
            v = np.asarray(v)
            if n >= m:
                out[k] = v[:m]  # overflow objects dropped (MAX_OBJS cap)
                continue
            pad_shape = (m - n,) + v.shape[1:]
            if k == "K" and calib is not None:
                # empty slots carry the image calib, never a zero intrinsic
                pad = np.tile(calib.reshape(1, 9), (m - n, 1)).astype(np.float32)
            else:
                pad = np.zeros(pad_shape, v.dtype)
            out[k] = np.concatenate([v, pad], axis=0)
        out["mask"] = out["mask"].astype(bool)
        out["cls"] = np.where(out["mask"], out["cls"], 0).astype(np.int32)
        return out

    # ------------------------------------------------------------------
    def __len__(self):
        return len(self._labels)

    def __getitem__(self, index, rng=None):
        # without an rng (a direct consumer, not the loader) a sample keeps
        # the JAX package's per-index seed, distinct from the loader's
        # per-batch streams
        if rng is None:
            rng = np.random.RandomState((977 + index * 15486277) % (2**31 - 1))
        if self._cfg.IS_MOSAIC and self.is_training:
            # 3 more tiles drawn first (dataset_reader.py:83-85), then each
            # tile's augmentation, then the homography, from one stream
            indices = [index] + [int(rng.randint(0, len(self._labels))) for _ in range(3)]
            images, labs = [], []
            for i in indices:
                im = self._imread(self._image_files[i])
                lab = self._raw_labels(i)
                if self._augment is not None:
                    im, lab = self._augment(im, lab, rng=rng)
                images.append(im)
                labs.append(lab)
            img, labels = self._apply_mosaic(images, labs, rng)
            # 4 cameras in one frame: the first tile's raw calib stands for all
            calib = self._K[index].astype(np.float32).copy()
        elif self.device_warp:
            return self._getitem_raw(index, rng)
        elif self._fast is not None:
            img = self._imread(self._image_files[index])
            labels = self._push_calib(self._raw_labels(index), index)
            img, labels = self._fast(img, labels, rng)
            labels, calib = self._pop_calib(labels)
            return {
                "image": img,  # normalised float32 already
                "labels": self._pad_objs(labels, calib=calib),
                "calib": calib,
                "path": self._path(index),
                "shape": self._shapes[index],
            }
        else:
            img = self._imread(self._image_files[index])
            labels = self._push_calib(self._raw_labels(index), index)
            if self._augment is not None:
                img, labels = self._augment(img, labels, rng=rng)
            img, labels = self._apply_padding(img, labels)
            labels, calib = self._pop_calib(labels)
        if self.normalize_on_device:
            img = img.astype(np.uint8)  # raw bytes; the step normalises
        else:
            img = ((img.astype(np.float32) / 255.0 - self._norm["mean_rgb"]) / self._norm["std_rgb"]).astype(np.float32)
        return {
            "image": img,
            "labels": self._pad_objs(labels, calib=calib),
            "calib": calib,
            "path": self._path(index),
            "shape": self._shapes[index],
        }


def _save_atomic(path: str, arr: np.ndarray) -> None:
    """``np.save`` to ``path`` through a file of this process's own, renamed
    into place: a process that reads the cache (another rank of a
    data-parallel run on the same tree) sees the whole file or none."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.save(f, arr, allow_pickle=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def create_dataset(path, cfg, is_training=True, split="train", augment="auto"):
    """Factory mirroring create_dataloader's dataset construction
    (dataset_reader.py:306-322)."""
    if augment == "auto":
        size = int(cfg.INPUT_SIZE[0])
        augment = train_augmentation(size) if is_training else test_transform(size)
    return KITTIDataset(path, cfg, augment=augment, is_training=is_training, split=split)
