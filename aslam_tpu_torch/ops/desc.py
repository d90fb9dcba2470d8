"""Descriptor family dispatch.

Port of the ORB branch of `aslam_tpu/ops/desc.py::describe`.  The other
families of the reference (BRIEF, FREAK, LATCH, SIFT) are not ported yet and
raise `NotImplementedError`.
"""

from __future__ import annotations

import torch

from aslam_tpu_torch.ops import orb

DESCRIPTOR_ALIASES = {
    "ORB_SLAM2": "ORB",
    "RBRIEF": "ORB",
    "BRISK": "FREAK",
    "SURF": "SIFT",
}
_FAMILIES = ("ORB", "BRIEF", "FREAK", "LATCH", "SIFT")


def canonical(name: str) -> str:
    n = name.upper()
    n = DESCRIPTOR_ALIASES.get(n, n)
    if n not in _FAMILIES:
        raise ValueError(f"unknown descriptor {name!r}; have {_FAMILIES} "
                         f"(+ aliases {sorted(DESCRIPTOR_ALIASES)})")
    return n


def describe(name: str, img_blurred: torch.Tensor, xy: torch.Tensor):
    """-> (desc [K,8] int32, angle [K] float32)."""
    n = canonical(name)
    if n != "ORB":
        raise NotImplementedError(
            f"descriptor family {n} is not ported yet; only ORB is")
    return orb.describe(img_blurred, xy)
