"""Material descriptors (host side).

Mirrors ``/root/reference/src/material/mod.rs``. At compile time materials
flatten into an SoA table: integer kind tags + parameter columns + texture ids,
dispatched branch-free inside the wavefront kernel (the data-parallel equivalent
of the reference's closed `enum_dispatch` world).
"""
from __future__ import annotations

import numpy as np

from .textures import SolidColor, Texture

# Material kind tags (compiled)
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
DIFFUSE_LIGHT = 3
ISOTROPIC = 4
BLEND = 5


class Material:
    is_light = False


class Lambertian(Material):
    """Cosine-BRDF matte material with NEE mixture sampling
    (material/mod.rs:166-214)."""

    def __init__(self, albedo: Texture, normal: Texture | None = None):
        self.albedo = albedo
        self.normal = normal


class Metal(Material):
    """Mirror reflection with fuzz perturbation (material/mod.rs:217-256)."""

    def __init__(self, albedo: Texture, normal: Texture | None = None, fuzz: float = 0.0):
        self.albedo = albedo
        self.normal = normal
        self.fuzz = float(fuzz)


class Dielectric(Material):
    """Glass with Schlick reflectance (material/mod.rs:259-316)."""

    def __init__(self, albedo: Texture, normal: Texture | None = None,
                 index_of_refraction: float = 1.5):
        self.albedo = albedo
        self.normal = normal
        self.index_of_refraction = float(index_of_refraction)


class DiffuseLight(Material):
    """Emissive material; front-face emission only, optional distance
    attenuation 1/(1+af·len) (material/mod.rs:319-369, 115-132)."""

    is_light = True

    def __init__(self, r, g=None, b=None, attenuation_half_length=None):
        if g is None:
            r, g, b = np.asarray(r, np.float64)
        self.tex = SolidColor(r, g, b)
        self.attenuation_factor = (
            0.0 if attenuation_half_length is None else 1.0 / attenuation_half_length
        )


class Isotropic(Material):
    """Uniform phase function for volumes; used by ConstantMedium
    (material/mod.rs:371-411)."""

    def __init__(self, tex: Texture):
        self.tex = tex


class Blend(Material):
    """Stochastic blend: each scatter / normal lookup independently picks
    material_1 if U > blend_factor else material_2 (material/mod.rs:413-445)."""

    # NOTE: like the reference (Blend keeps the default Material::is_light),
    # a blend is never treated as a light source even if a sub-material is.
    is_light = False

    def __init__(self, material_1: Material, material_2: Material, blend_factor: float):
        self.material_1 = material_1
        self.material_2 = material_2
        self.blend_factor = float(blend_factor)
