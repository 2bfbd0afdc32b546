"""The port's own host side (`gpu_pathtracer_tpu_torch.constants`,
`gpu_pathtracer_tpu_torch.utils`) against the modules of the JAX package it
was copied from: the same master file, OBJ/MTL folder, generated scenes and
images give equal configurations, equal `HostScene` arrays and equal files
(exact equality: the same numpy code on the same inputs).  Also the import
guard in a fresh interpreter: the port's renderer, optimizer and
`chip_smoke` load neither jax nor the JAX package.
"""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpu_pathtracer_tpu import constants as jconstants
from gpu_pathtracer_tpu.utils import config as jconfig
from gpu_pathtracer_tpu.utils import image as jimage
from gpu_pathtracer_tpu.utils import obj_io as jobj_io
from gpu_pathtracer_tpu.utils import testscenes as jtestscenes
from gpu_pathtracer_tpu_torch import constants
from gpu_pathtracer_tpu_torch.utils import config, image, native, obj_io, testscenes

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
ASSET = REPO / "tests" / "assets" / "cornell"


def _flat(obj, prefix=""):
    """A HostScene (nested dataclasses of arrays, lists and scalars) as
    {dotted name: value}."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_flat(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


def _assert_same_scene(a, b):
    fa, fb = _flat(a), _flat(b)
    assert list(fa) == list(fb)
    assert sum(isinstance(v, np.ndarray) for v in fa.values()) >= 10
    for name, va in fa.items():
        vb = fb[name]
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, name
            np.testing.assert_array_equal(va, vb, err_msg=name)
        else:
            assert va == vb, name


def test_constants_equal_the_reference():
    names = [n for n in vars(constants) if n.isupper()]
    assert len(names) >= 7
    assert names == [n for n in vars(jconstants) if n.isupper()]
    for n in names:
        assert getattr(constants, n) == getattr(jconstants, n), n


def test_master_file_parses_and_writes_alike(tmp_path):
    cfg, jcfg = config.parse_master_file(ASSET / "master.txt"), jconfig.parse_master_file(
        ASSET / "master.txt")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert [f.name for f in dataclasses.fields(cfg)] == [f.name for f in dataclasses.fields(jcfg)]
    assert (cfg.eye, cfg.center, cfg.up, cfg.sky_emission) == (
        jcfg.eye, jcfg.center, jcfg.up, jcfg.sky_emission)
    cfg.image_width, cfg.seed, cfg.hittable_pdf_weight = 77, 5, 0.25
    config.write_master_file(cfg, tmp_path / "a.txt")
    jconfig.write_master_file(jconfig.RenderConfig(**dataclasses.asdict(cfg)), tmp_path / "b.txt")
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    assert dataclasses.asdict(config.parse_master_file(tmp_path / "a.txt")) == dataclasses.asdict(cfg)


def test_obj_mtl_folder_loads_alike():
    _assert_same_scene(obj_io.load_scene(ASSET, "box.obj"), jobj_io.load_scene(ASSET, "box.obj"))


@pytest.mark.parametrize("kw", [dict(spheres=True, sphere_subdiv=2),
                                dict(spheres=True, glass_priority=True, fog=True)])
def test_generated_cornell_box_alike(tmp_path, kw):
    a, b = tmp_path / "port", tmp_path / "ref"
    testscenes.make_cornell_box(a, **kw)
    jtestscenes.make_cornell_box(b, **kw)
    for name in ("box.obj", "box.mtl"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    ma = testscenes.cornell_master_file(a, width=8, height=8, spp=1, level=2)
    mb = jtestscenes.cornell_master_file(b, width=8, height=8, spp=1, level=2)
    assert (pathlib.Path(ma).read_text().replace(str(a), "X")
            == pathlib.Path(mb).read_text().replace(str(b), "X"))
    _assert_same_scene(obj_io.load_scene(a, "box.obj"), jobj_io.load_scene(b, "box.obj"))


def test_mesh_scene_host_alike():
    a = testscenes.make_mesh_scene_host(subdiv=3)
    _assert_same_scene(a, jtestscenes.make_mesh_scene_host(subdiv=3))
    assert a.tri_p.shape == (20 * 4 ** 3 + 4, 3, 3)


def test_images_write_and_load_alike(tmp_path):
    img = np.random.default_rng(0).uniform(0.0, 1.5, (5, 7, 3)).astype(np.float32)
    image.save_ppm(img, tmp_path / "a.ppm")
    jimage.save_ppm(img, tmp_path / "b.ppm")
    assert (tmp_path / "a.ppm").read_bytes() == (tmp_path / "b.ppm").read_bytes()
    np.testing.assert_array_equal(image.load_ppm(tmp_path / "a.ppm"),
                                  jimage.load_ppm(tmp_path / "b.ppm"))
    np.testing.assert_array_equal(image.tonemap(img), jimage.tonemap(img))
    image.save_png(img, tmp_path / "a.png")
    jimage.save_png(img, tmp_path / "b.png")
    np.testing.assert_array_equal(obj_io._load_image_rgb(tmp_path / "a.png"),
                                  jobj_io._load_image_rgb(tmp_path / "b.png"))


def test_native_paths_and_python_fallbacks_alike(tmp_path, monkeypatch):
    """With and without the native host library the port's loader gives the
    same arrays and the same PPM (where no toolchain built the library,
    both runs take the Python paths)."""
    with_lib = obj_io.load_scene(ASSET, "box.obj")
    img = np.random.default_rng(1).uniform(0.0, 1.2, (4, 4, 3)).astype(np.float32)
    image.save_ppm(img, tmp_path / "native.ppm")
    monkeypatch.setattr(native, "_lib_cache", [None])
    assert native.get_lib() is None
    _assert_same_scene(with_lib, obj_io.load_scene(ASSET, "box.obj"))
    image.save_ppm(img, tmp_path / "python.ppm")
    np.testing.assert_array_equal(image.load_ppm(tmp_path / "native.ppm"),
                                  image.load_ppm(tmp_path / "python.ppm"))


def test_fresh_interpreter_loads_no_jax():
    code = (
        "import sys\n"
        "import gpu_pathtracer_tpu_torch.renderer, gpu_pathtracer_tpu_torch.cli\n"
        "import gpu_pathtracer_tpu_torch.optim, gpu_pathtracer_tpu_torch.models.convert\n"
        "import gpu_pathtracer_tpu_torch.utils.testscenes, chip_smoke\n"
        "import gpu_pathtracer_tpu_torch.render.sppm, gpu_pathtracer_tpu_torch.render.splat\n"
        "import gpu_pathtracer_tpu_torch.ops.anyhit, gpu_pathtracer_tpu_torch.ops.hashgrid\n"
        "import gpu_pathtracer_tpu_torch.ops.bounding_sphere, gpu_pathtracer_tpu_torch.render.sss\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'flax', 'gpu_pathtracer_tpu'))\n"
        "assert 'gpu_pathtracer_tpu_torch.render.integrator' in sys.modules\n"
        "assert 'gpu_pathtracer_tpu_torch.ops.trace' in sys.modules\n"
        "print('LOADED', bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout
