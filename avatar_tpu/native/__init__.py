"""Native (C++) accelerated host-side components with pure-Python fallbacks.

The device compute path is all XLA; these helpers accelerate the *host* side of
the pipeline the way the reference uses C++ for its runtime: file codecs and
dataset prefetch.  Build the extension with ``python -m avatar_tpu.native.build``
(uses the system C++ toolchain); everything works without it.
"""

from avatar_tpu.native import rle  # noqa: F401
