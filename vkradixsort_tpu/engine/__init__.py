"""Runtime engine: device discovery, meshes and the compile cache.

Analog of the reference's ``engine/`` Vulkan runtime
(reference engine/include/engine/core/*): GPUContext -> DeviceContext.
"""
