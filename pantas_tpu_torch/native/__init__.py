"""Native (C++) engines, loaded via ctypes.

Built on demand with g++ (no pip deps): the shared libraries are compiled into
``build/native/`` at the root of the checkout on first use and cached there.
"""

from pantas_tpu_torch.native.gafcov import (  # noqa: F401
    NativeCoverage,
    augment_gfa_native,
    build_library,
    clip_sites_native,
    kidx_pack,
    kidx_sort,
    native_available,
)
