"""Material model: probabilistic-lobe single struct (host side).

Reference: struct Material (Source/Main.cpp:51-92) -- albedo, specular in
[0,1], refractivity in [0,1], Beer's-law absorption RGB, ior, emissive x
intensity with an is_light flag.  Diffuse weight = max(0, 1 - specular -
refractivity) (Source/Main.cpp:436).  The device form is the scene
build's `mk_mats` table (models/scene.py).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Material:
    albedo: tuple[float, float, float] = (0.0, 0.0, 0.0)
    specular: float = 0.0
    refractivity: float = 0.0
    absorption: tuple[float, float, float] = (0.0, 0.0, 0.0)
    ior: float = 1.0
    emissive: tuple[float, float, float] = (0.0, 0.0, 0.0)
    intensity: float = 0.0
    is_light: bool = False

    @classmethod
    def diffuse(cls, albedo, specular: float = 0.0) -> "Material":
        """Material(albedo, spec) ctor (Source/Main.cpp:64-65)."""
        return cls(albedo=tuple(albedo), specular=specular)

    @classmethod
    def dielectric(cls, albedo, specular, refractivity, absorption, ior) -> "Material":
        """Material(albedo, spec, refract, absorption, ior) ctor
        (Source/Main.cpp:66-67)."""
        return cls(
            albedo=tuple(albedo),
            specular=specular,
            refractivity=refractivity,
            absorption=tuple(absorption),
            ior=ior,
        )

    @classmethod
    def light(cls, emissive, intensity) -> "Material":
        """Material(emissive, intensity, light) ctor (Source/Main.cpp:68-69)."""
        return cls(emissive=tuple(emissive), intensity=intensity, is_light=True)

    def replace(self, **kwargs) -> "Material":
        return dataclasses.replace(self, **kwargs)
