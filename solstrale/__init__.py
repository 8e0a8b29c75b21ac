"""solstrale — a differentiable Monte Carlo path tracer in JAX.

A from-scratch JAX/XLA re-design with the capabilities of the
`DanielPettersson/Solstrale-Rust` reference (a multithreaded CPU path tracer):
spheres/quads/triangles/constant-media, Lambertian/Metal/Dielectric/
DiffuseLight/Isotropic/Blend materials, image & solid textures, bump/normal
mapping, NEE mixture-pdf sampling, OBJ+MTL ingest, bloom + denoiser post
processing, progressive rendering with progress/abort — plus what the
reference cannot do: seeded reproducible rendering (the same random
draws per pixel and sample under any sharding), differentiable images
(gradients w.r.t. textures/colors/emission), and rendering sharded over
a mesh of devices. Its accelerator is an NVIDIA GPU; BVH traversal runs in
a Pallas (Triton) kernel there, everything else is plain XLA.
"""
from .geo.transformation import (NopTransformer, RotationX, RotationY,
                                 RotationZ, Scale, Transformations,
                                 Translation)
from .renderer import (EverySample, Interval, OnlyFinal, RenderConfig,
                       Renderer, RenderProgress, ray_trace)
from .renderer.shader import (AlbedoShader, NormalShader, PathTracingShader,
                              SimpleShader)
from .scene import (Blend, Bvh, CameraConfig, ConstantMedium, Dielectric,
                    DiffuseLight, ImageMap, Isotropic, Lambertian, Metal,
                    Quad, Scene, SolidColor, Sphere, Triangle,
                    load_normal_texture, new_box)

__version__ = "0.1.0"
