"""Verbosity-gated output stream (output_stream.hpp:7-23 equivalent)."""
from __future__ import annotations

import sys


class OutputStream:
    """Prints to stdout only when verbose — the reference's entire logging
    system (output_stream.hpp:14-22)."""

    def __init__(self, verbose: bool = False, file=None):
        self.verbose = verbose
        self.file = file if file is not None else sys.stdout

    def write(self, *parts) -> "OutputStream":
        if self.verbose:
            print(*parts, sep="", end="", file=self.file, flush=True)
        return self

    def __lshift__(self, msg) -> "OutputStream":
        return self.write(msg)
