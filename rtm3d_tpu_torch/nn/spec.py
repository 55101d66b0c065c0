"""Backbone -> FPN shape contract (reference: models/nets/ShapeSpec.py:6-20)."""

from typing import NamedTuple, Optional


class ShapeSpec(NamedTuple):
    channels: Optional[int] = None
    height: Optional[int] = None
    width: Optional[int] = None
    stride: Optional[int] = None
