"""Small shared utilities.

The reference's `utils.py` holds the Rust-FFI object plumbing
(`RustObject`/`rustcall`, reference `utils.py:9-78`); this framework has
no FFI handles — sketches are plain Python + numpy objects — so only
the generic helpers live here."""

from __future__ import annotations


def decode_str(s):
    "Identity passthrough (reference decodes Rust-owned strings here)."
    if isinstance(s, bytes):
        return s.decode("utf-8")
    return s


def encode_str(s):
    if isinstance(s, str):
        return s.encode("utf-8")
    return s


class RustObject:
    """Compatibility stand-in for the reference's FFI handle base class
    (reference utils.py:9-63). This framework keeps sketches as plain
    Python/numpy objects, so the class exists only for API compatibility
    and cannot be instantiated directly."""

    _objptr = None
    _shared = False

    def __init__(self):
        raise TypeError(f"Cannot instantiate {self.__class__.__name__} objects.")
