"""The C++ host runtime (``native/zf_native.cpp``) as one module object.

``module`` is ``_zf_native`` where that extension was built in place and is
importable by name (``python native/setup.py build_ext --inplace``), and
otherwise the port's own g++ build of the same source
(``ops._build.native_module``: built once per checkout under
``build/zigflac_tpu_torch/``, 3-4 s, then loaded from there). Where g++ or
``Python.h`` is missing, importing this module raises ImportError, so that
``native.py`` falls back to hashlib/numpy and ``ogg.flac_to_ogg`` raises as
it would without the extension.
"""

from __future__ import annotations

try:
    import _zf_native as module
except ImportError:
    from .ops._build import native_module

    try:
        module = native_module()
    except (OSError, RuntimeError) as e:  # no g++, or the build failed
        raise ImportError(f"the C++ host runtime could not be built: {e}") from e
