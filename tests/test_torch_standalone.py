"""lvt_tpu_torch stands on its own: it imports neither JAX nor anything of
lvt_tpu, and its copies of lvt_tpu's jax-free modules (the configuration,
the shipped KITTI, TUM and EuRoC configs with EuRoC's timestamp lists, the
EuRoC calibration, the synthetic world) agree with the originals.

Tolerance: none. Config fields are compared as values, rendered frames and
poses bit for bit, and the two ATE functions to the last bit.
"""

import ast
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest

import __graft_entry__
from lvt_tpu import config as jx_config
from lvt_tpu.io import synthetic as jx_synthetic
from lvt_tpu.io import datasets as jx_datasets
from lvt_tpu_torch import config, configs
from lvt_tpu_torch.io import datasets, synthetic

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("lvt_tpu", "__graft_entry__", "jax")


def _port_sources():
    return sorted((ROOT / "lvt_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            # ``from lvt_tpu import x`` names its package in ``module``;
            # ``from . import x`` stays inside the port
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_port_imports_no_jax_and_nothing_of_lvt_tpu():
    sources = _port_sources()
    assert len(sources) > 30
    bad = [(p.relative_to(ROOT).as_posix(), mod)
           for p in sources for mod in _imported_modules(p)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"imports of the JAX package or JAX: {bad}"


def test_sharded_modules_are_scanned_and_their_workers_import_no_jax():
    """The sharded modes' modules are in the scan above, and a rank
    spawned by parallel/dryrun.py, after running a sharded step, has
    imported neither JAX nor anything of lvt_tpu or the tests."""
    from lvt_tpu_torch.parallel import dryrun

    scanned = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    assert {f"lvt_tpu_torch/{m}.py" for m in (
        "ops/collectives", "parallel/mesh", "parallel/ba",
        "parallel/sharded_stream", "parallel/stream_point",
        "parallel/multihost", "parallel/dryrun")} <= scanned
    config, il, ir, _, _ = dryrun._tiny()
    ((_, loaded),) = dryrun.spawn([
        dryrun.job(dryrun.sharded_stream, config, il[:2], ir[:2], chunk=2),
        dryrun.job(dryrun.loaded_modules)], 1)
    assert "lvt_tpu_torch" in loaded and "torch" in loaded
    assert not set(loaded) & {*FORBIDDEN, "tests"}


def test_import_scan_catches_each_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom lvt_tpu.config import X\n"
                   "from __graft_entry__ import y\n"
                   "import importlib\nimportlib.import_module('lvt_tpu.io')\n"
                   "from lvt_tpu_torch import config\n")
    mods = list(_imported_modules(src))
    assert [m for m in mods if m.split(".")[0] in FORBIDDEN] == [
        "jax.numpy", "lvt_tpu.config", "__graft_entry__", "lvt_tpu.io"]


def test_vo_config_has_lvt_tpu_fields_and_defaults():
    ours = {f.name: (f.type, f.default) for f in
            dataclasses.fields(config.VOConfig)}
    theirs = {f.name: (f.type, f.default) for f in
              dataclasses.fields(jx_config.VOConfig)}
    assert ours == theirs
    assert config.MATCHES_WINDOW_INIT == jx_config.MATCHES_WINDOW_INIT
    kw = dict(img_width=1241, img_height=376, detection_cell_size=100)
    a, b = config.VOConfig(**kw), jx_config.VOConfig(**kw)
    assert (a.kp_capacity, a.num_cells) == (b.kp_capacity, b.num_cells)
    assert dataclasses.asdict(a.replace(tracking_radius=9)) == \
        dataclasses.asdict(b.replace(tracking_radius=9))
    for cfg in (config.VOConfig(), config.VOConfig(img_width=8,
                                                   img_height=8,
                                                   tracking_radius=0)):
        with pytest.raises(AssertionError):
            cfg.validate()


def test_copied_yamls_load_as_lvt_tpus():
    jx_dir = ROOT / "lvt_tpu" / "configs" / "kitti"
    for name in ("vo_config.yaml", "00.yaml"):
        assert (Path(configs.KITTI_DIR) / name).read_bytes() == (
            jx_dir / name).read_bytes()
    calib = config.load_kitti_calib(os.path.join(configs.KITTI_DIR, "00.yaml"))
    assert calib == jx_config.load_kitti_calib(str(jx_dir / "00.yaml"))
    ours = config.load_config(
        os.path.join(configs.KITTI_DIR, "vo_config.yaml"), **calib)
    theirs = jx_config.load_config(str(jx_dir / "vo_config.yaml"), **calib)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.local_ba_window == 4
    # the TUM RGB-D YAMLs: equal files, loaded as lvt_tpu's TUM entry
    # point does
    tum_dir = ROOT / "lvt_tpu" / "configs" / "tum_rgbd"
    for n in (1, 2, 3):
        name = f"config_tum{n}.yaml"
        assert (Path(configs.TUM_RGBD_DIR) / name).read_bytes() == (
            tum_dir / name).read_bytes()
        assert dataclasses.asdict(configs.tum_rgbd_config(n)) == \
            dataclasses.asdict(jx_config.load_config(str(tum_dir / name)))
    fr1 = configs.tum_rgbd_config(1)
    assert (fr1.k1, fr1.max_map_points, fr1.kp_capacity,
            fr1.staged_threshold, fr1.local_ba_window) == (
                0.262383, 8192, 1024, 0, 0)
    text = "%YAML:1.0\nm: !!opencv-matrix\n  data: [1, 2]\n"
    assert config.parse_opencv_yaml(text) == jx_config.parse_opencv_yaml(text)


def test_euroc_copies_are_lvt_tpus():
    """The EuRoC YAML and the 11 sequences' timestamp lists are byte-equal
    copies, and every ``EUROC_*`` constant equals lvt_tpu's, value and
    dtype."""
    jx_dir = ROOT / "lvt_tpu" / "configs" / "euroc"
    names = sorted(p.name for p in jx_dir.iterdir())
    assert len([n for n in names if n.endswith(".txt")]) == 11
    assert sorted(p.name for p in Path(configs.EUROC_DIR).iterdir()) == names
    for name in names:
        assert (Path(configs.EUROC_DIR) / name).read_bytes() == (
            jx_dir / name).read_bytes(), name
    theirs = {k: v for k, v in vars(jx_datasets).items()
              if k.startswith("EUROC_")}
    ours = {k: v for k, v in vars(datasets).items() if k.startswith("EUROC_")}
    assert sorted(ours) == sorted(theirs) and len(ours) == 10
    for k, v in theirs.items():
        assert np.asarray(ours[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_euroc_raw_frames_render_as_the_cli_tests():
    """The port's raw EuRoC renderer is tests/test_cli.py's, frame for
    frame, for both cameras."""
    from tests.test_cli import _render_euroc_raw

    rs = np.random.RandomState(5)
    points = np.stack([rs.uniform(-30, 30, 300), rs.uniform(-15, 15, 300),
                       rs.uniform(2.0, 60.0, 300)], -1)
    shade = rs.uniform(60.0, 215.0, 300)
    for right in (False, True):
        t = np.array([0.0, 0.1, 0.5])
        np.testing.assert_array_equal(
            datasets.render_euroc_raw(points, shade, t, right),
            _render_euroc_raw(points, shade, t, right))


def test_shipped_configs():
    assert dataclasses.asdict(configs.kitti_config()) == dataclasses.asdict(
        __graft_entry__._kitti_config())
    path2 = configs.kitti_ba_dense_config()
    jx_dir = ROOT / "lvt_tpu" / "configs" / "kitti"
    want = jx_config.load_config(
        str(jx_dir / "vo_config.yaml"),
        **jx_config.load_kitti_calib(str(jx_dir / "00.yaml")),
        img_width=1241, img_height=376, descriptor_mode="dense")
    assert dataclasses.asdict(path2) == dataclasses.asdict(want)
    assert path2.kp_capacity == configs.kitti_config().kp_capacity == 1536


@pytest.mark.parametrize("world", ["SyntheticWorld", "TexturedWorld"])
def test_synthetic_worlds_render_as_lvt_tpus(world):
    kw = dict(width=96, height=64, fx=60.0, fy=60.0, cx=48.0, cy=32.0)
    if world == "SyntheticWorld":
        kw.update(n_points=300, extent_x=20.0, extent_y=8.0, extent_z=40.0)
    else:
        kw.update(n_occluders=1, stripe_walls=True)
    ours = getattr(synthetic, world)(**kw)
    theirs = getattr(jx_synthetic, world)(**kw)
    for a, b in zip(ours.stereo_sequence(3, speed=0.7),
                    theirs.stereo_sequence(3, speed=0.7)):
        for x, y in zip(a[:2], b[:2]):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a[2][0], b[2][0])
        np.testing.assert_array_equal(a[2][1], b[2][1])
    (img, depth, _), = ours.rgbd_sequence(1)
    (jimg, jdepth, _), = theirs.rgbd_sequence(1)
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(depth, jdepth)


def test_ate_rmse_agrees():
    rs = np.random.RandomState(3)
    est, gt = rs.randn(40, 3), rs.randn(40, 3)
    assert synthetic.ate_rmse(est, gt) == jx_synthetic.ate_rmse(est, gt)
    assert synthetic.ate_rmse(gt, gt) == 0.0


SHELLS = ("cli.py", "bench.py", "capi.py", "observability.py", "viz.py", "viz_html.py",
          "io/trajectory.py", "io/native_loader.py", "io/datasets.py",
          "io/streaming.py", "io/ros2_bridge.py", "__main__.py")


def test_the_shells_are_scanned():
    scanned = {p.relative_to(ROOT / "lvt_tpu_torch").as_posix()
               for p in _port_sources() if "lvt_tpu_torch" in p.parts}
    assert set(SHELLS) <= scanned


def test_shell_copies_are_lvt_tpus():
    """The KITTI calibrations 00-21, the TUM associations, the C header
    and the PNG decoder's source are byte-equal copies; the C ABI's
    source is lvt_tpu's, forwarding to the port's capi module."""
    jx, port = ROOT / "lvt_tpu", ROOT / "lvt_tpu_torch"
    pairs = [(f"configs/kitti/{i:02d}.yaml",) for i in range(22)]
    assoc = sorted((jx / "configs" / "tum_rgbd" / "associations").iterdir())
    assert len(assoc) == 7
    assert sorted(p.name for p in (port / "configs" / "tum_rgbd" /
                                   "associations").iterdir()) == \
        [p.name for p in assoc]
    pairs += [(f"configs/tum_rgbd/associations/{p.name}",) for p in assoc]
    pairs += [("native/lvt_c.h",), ("native/png_loader.cpp",)]
    for (rel,) in pairs:
        assert (port / rel).read_bytes() == (jx / rel).read_bytes(), rel
    for i in range(22):
        name = f"{i:02d}.yaml"
        assert config.load_kitti_calib(os.path.join(configs.KITTI_DIR,
                                                    name)) == \
            jx_config.load_kitti_calib(str(jx / "configs" / "kitti" / name))
    src = (port / "native" / "lvt_c.cpp").read_text()
    assert 'PyImport_ImportModule("lvt_tpu_torch.capi")' in src
    assert "lvt_tpu.capi" not in src
    theirs = (jx / "native" / "lvt_c.cpp").read_text()
    body = lambda s: s[s.index("#define PY_SSIZE_T_CLEAN"):]  # noqa: E731
    assert body(src).replace("lvt_tpu_torch.capi", "lvt_tpu.capi") == \
        body(theirs).replace("(jax, numpy)", "(torch, numpy)")


def test_package_data_ships_every_data_file():
    """pyproject.toml's package-data globs cover every file of the package
    that is not Python (the configs, the CUDA and C++ sources)."""
    import fnmatch
    import tomllib

    globs = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "tool"]["setuptools"]["package-data"]["lvt_tpu_torch"]
    pkg = ROOT / "lvt_tpu_torch"
    data = [p.relative_to(pkg).as_posix() for p in pkg.rglob("*")
            if p.is_file() and p.suffix not in (".py", ".pyc")
            and "__pycache__" not in p.parts]
    assert len(data) > 50
    missing = [f for f in data if not any(fnmatch.fnmatch(f, g)
                                          for g in globs)]
    assert not missing, missing
