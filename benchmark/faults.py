"""Faults planted under the timed path, for the check of the check.

Each fault wraps the port's ``codec.compress.compress_image`` (which
``api.compress_image`` calls) so that the answers the window gets are
wrong in one way a broken encoder could make them wrong. The correctness
check has to read every one of them as not correct:

- ``stale``: a step that returns its state unchanged: every call returns
  the first answer it ever gave, whatever texture it was given;
- ``half``: half of the batch left out: the second half of each answer's
  blocks is never encoded and comes back as zero bytes, as the chunks
  that a cancelled encode did not start do;
- ``altered``: an answer altered where it is produced: one block of each
  answer (a third of the way in) carries the bytes of another block of the
  same answer (two thirds of the way in).

A cell on one card has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

FAULTS = ("stale", "half", "altered")


def _wrap(kind: str, orig):
    first = []

    def compress_image(*args, **kw):
        out = orig(*args, **kw)
        if kind == "stale":
            if not first:
                first.append(out.copy())
            return first[0].copy()
        out = out.copy()
        n = out.shape[0]
        if kind == "half":
            out[n - n // 2:] = 0
        elif kind == "altered":
            out[n // 3] = out[(2 * n) // 3]
        return out

    return compress_image


@contextlib.contextmanager
def planted(kind: str):
    """The port's encoder with fault ``kind`` planted, inside the block."""
    if kind not in FAULTS:
        raise ValueError(f"unknown fault {kind!r}")
    from astcenc_torch.codec import compress
    orig = compress.compress_image
    compress.compress_image = _wrap(kind, orig)
    try:
        yield
    finally:
        compress.compress_image = orig


def control_config(config: dict) -> dict:
    """The configuration's control: the program run under the other
    profile that the configuration names (``control_profile``), which
    breaks the profile's guarantee."""
    return dict(config, profile=config["control_profile"])

