"""The JAX package's native libraries, loaded for the port's tests.

The JAX loaders (``dia_tts_prune_tpu/native/__init__.py``) build into the
package directory in place and remember a failure.  Every pytest worker
imports ``tests/test_native.py`` while it collects, and its ``skipif``
conditions build the same files in every worker at once; a worker that
loads one while another writes it keeps None for the rest of the session
(ROADMAP C).  ``jax_native`` loads them again once that race is over.
"""

import time

from dia_tts_prune_tpu import native as jn


def jax_native(audiodec: bool = False):
    """``dia_tts_prune_tpu.native`` with libaudioproc and libmp3dec (and
    libaudiodec if asked) loaded, or None when they still do not load after
    three tries."""
    for _ in range(3):
        if jn.load() is not None and jn.load_mp3dec() is not None and (
                not audiodec or jn.load_audiodec() is not None):
            return jn
        jn._tried = jn._mp3_tried = jn._adec_tried = False
        time.sleep(2)
    return None
