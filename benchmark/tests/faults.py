"""Faults planted under the timed path, for the tests that see ``correct``
come out false. Each wraps the callable a driver times (the ``Detector``
or the train step) and returns the broken one."""

import numpy as np
import torch


def detect_half(det):
    """Half of the batch left out: the first half's answers stand for all."""
    def call(images, K, warp=None, border=None):
        h = max(1, len(images) // 2)
        out = det(images[:h], K[:h], None if warp is None else warp[:h], None if border is None else border[:h])
        return {k: np.concatenate([v] * (len(images) // h))[:len(images)] for k, v in out.items()}
    return call


def detect_altered(det):
    """One answer altered where it is produced: a detection's vertices
    moved by 8 px."""
    def call(*args, **kw):
        out = det(*args, **kw)
        out["v_proj"] = out["v_proj"].copy()
        out["v_proj"][0, 0] += 8.0
        return out
    return call


def detect_nonms(det):
    """The decode's 3x3 peak suppression left out: every pixel is a peak,
    and the top-K fills with the neighbours of the strongest."""
    from rtm3d_tpu_torch.decode import peaks

    peaks.nms_peaks = lambda hm, kernel=3: hm
    return det


def train_unchanged(step):
    """A step that returns its state unchanged."""
    def call(state, batch, cache=None):
        keep = {k: p.detach().clone() for k, p in state.model.named_parameters()}
        ema = {k: v.clone() for k, v in state.ema.items()} if state.ema is not None else None
        state, m = step(state, batch, cache)
        with torch.no_grad():
            for k, p in state.model.named_parameters():
                p.copy_(keep[k])
            if ema is not None:
                for k, v in state.ema.items():
                    v.copy_(ema[k])
        return state, m
    return call


def train_half(step):
    """Half of the batch left out, the mean taken over the rest."""
    def call(state, batch, cache=None):
        h = len(batch["image_idx"]) // 2
        half = {k: ({kk: vv[:h] for kk, vv in v.items()} if isinstance(v, dict) else v[:h]) for k, v in batch.items()}
        return step(state, half, cache)
    return call
