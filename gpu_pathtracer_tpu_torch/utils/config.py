"""Render configuration.

Mirrors the reference's master-file schema (`src/input/input_param.h:35-123`):
a tab-separated key/value file, plus the extension keys of
`gpu_pathtracer_tpu.utils.config` (ray batch size, sharding axis), of which
this module is the port's own copy.
"""

from __future__ import annotations

import dataclasses
import pathlib


@dataclasses.dataclass
class RenderConfig:
    # paths
    input_folder_path: str = ""
    obj_filename: str = ""
    texture_bg_path: str = ""
    image_output_path: str = "out.ppm"

    # image / mode
    image_width: int = 256
    image_height: int = 256
    render_mode: int = 1  # 1 = path tracing, 2 = SPPM

    # path tracing
    pathtracing_sample_size: int = 16
    pathtracing_level: int = 8
    dof_sample_size: int = 1
    sss_pts_per_object: int = 0
    hittable_pdf_weight: float = 0.0

    # SPPM
    ppm_num_photon_per_pass: int = 100_000
    ppm_num_pass: int = 10
    ppm_max_bounce: int = 16
    ppm_alpha: float = 0.7
    ppm_radius_scaling_factor: float = 1.0
    ppm_image_output_iteration: int = 10

    # camera
    eye_x: float = 0.0
    eye_y: float = 0.0
    eye_z: float = 1.0
    center_x: float = 0.0
    center_y: float = 0.0
    center_z: float = 0.0
    up_x: float = 0.0
    up_y: float = 1.0
    up_z: float = 0.0
    fovy: float = 45.0
    aperture: float = 0.0
    focus_dist: float = 1.0

    # sky
    sky_emission_r: float = 0.0
    sky_emission_g: float = 0.0
    sky_emission_b: float = 0.0

    # --- extensions (no reference counterpart) ---
    seed: int = 1984  # reference cuRAND seed (util/general.h:15)
    max_stack: int = 8  # nested-dielectric stack slots per ray
    shard_rays: bool = False  # shard the pixel axis over the device mesh

    @property
    def eye(self):
        return (self.eye_x, self.eye_y, self.eye_z)

    @property
    def center(self):
        return (self.center_x, self.center_y, self.center_z)

    @property
    def up(self):
        return (self.up_x, self.up_y, self.up_z)

    @property
    def sky_emission(self):
        return (self.sky_emission_r, self.sky_emission_g, self.sky_emission_b)


_INT_FIELDS = {
    f.name for f in dataclasses.fields(RenderConfig) if f.type in ("int", int)
}
_FLOAT_FIELDS = {
    f.name for f in dataclasses.fields(RenderConfig) if f.type in ("float", float)
}
_BOOL_FIELDS = {
    f.name for f in dataclasses.fields(RenderConfig) if f.type in ("bool", bool)
}


def parse_master_file(path: str | pathlib.Path) -> RenderConfig:
    """Parse the tab-separated master file (input_param.h:35-123).

    Unknown keys are ignored, like the reference's if/else chain.
    `dof_sample_size` is forced to 1 when the aperture is 0
    (input_param.h:99-104).
    """
    cfg = RenderConfig()
    text = pathlib.Path(path).read_text()
    pending: dict[str, str] = {}
    for line in text.splitlines():
        line = line.rstrip("\r\n ")
        if not line:
            continue
        chunks = line.split("\t")
        if len(chunks) < 2:
            continue
        key, value = chunks[0], chunks[1]
        pending[key] = value
        if not hasattr(cfg, key):
            continue
        if key in _INT_FIELDS:
            setattr(cfg, key, int(value))
        elif key in _FLOAT_FIELDS:
            setattr(cfg, key, float(value))
        elif key in _BOOL_FIELDS:
            setattr(cfg, key, value.strip().lower() in ("1", "true", "yes"))
        else:
            setattr(cfg, key, value)
    if cfg.aperture <= 0:
        cfg.dof_sample_size = 1
    return cfg


def write_master_file(cfg: RenderConfig, path: str | pathlib.Path) -> None:
    """Serialize a config back to the tab-separated format."""
    lines = []
    for f in dataclasses.fields(RenderConfig):
        v = getattr(cfg, f.name)
        lines.append(f"{f.name}\t{v}")
    pathlib.Path(path).write_text("\n".join(lines) + "\n")
