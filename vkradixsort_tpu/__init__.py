"""vkradixsort_tpu — a vectorized sort engine in JAX.

A JAX/XLA framework with the capabilities of the Vulkan/GLSL radix sort
reference (MircoWerner/VkRadixSort): stable sorts over 8- to 64-bit integer
and float keys and key-value pairs, extended to multi-device meshes via
splitter-sampled range partitioning and an all-to-all key shuffle.

Public API (analog of the reference's ``SingleRadixSort::execute`` /
``MultiRadixSort::execute``, reference singleradixsort/include/SingleRadixSort.h:21
and multiradixsort/include/MultiRadixSort.h:21, but exposed as proper functions
rather than hard-coded drivers):

    sort(keys)                      -> sorted keys
    sort_pairs(keys, values)        -> (sorted keys, values permuted alongside)
    argsort(keys)                   -> stable argsort indices
    sort_segments(keys2d)           -> every row sorted independently
    sort_sharded(keys, mesh, axis)  -> multi-device distributed sort
                                       (vkradixsort_tpu.parallel.distributed)
"""

from vkradixsort_tpu.ops.dispatch import argsort, sort, sort_pairs, sort_segments
from vkradixsort_tpu.ops.common import (
    decode_keys,
    encode_keys,
    sortable_dtype,
)
from vkradixsort_tpu.engine.context import DeviceContext

__version__ = "0.1.0"

__all__ = [
    "sort",
    "sort_pairs",
    "argsort",
    "sort_segments",
    "encode_keys",
    "decode_keys",
    "sortable_dtype",
    "DeviceContext",
    "__version__",
]
