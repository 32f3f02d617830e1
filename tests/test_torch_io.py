"""lvt_tpu_torch's I/O shells against lvt_tpu's, on the CPU: trajectory
files and errors, the port's PNG decoder, and the KITTI, EuRoC and TUM
sequence readers.

Tolerances:
  * trajectory files: byte-equal to lvt_tpu's ``dump_kitti`` and
    ``dump_tum`` for the same poses; ATE, RPE and rotation error within
    1e-12 of lvt_tpu's;
  * the decoder: bit-equal to OpenCV's decode (RGB order where OpenCV
    gives BGR) and to lvt_tpu's native loader, on 8-bit and 16-bit gray,
    RGB PNGs written by OpenCV (each of the five filter types forced, and
    libpng's adaptive choice), an 8-bit palette PNG by Pillow, and the files
    of chip_smoke.py's writer. A color PNG's gray is lvt_tpu's luma
    ((299 R + 587 G + 114 B + 500) / 1000), bit-equal to lvt_tpu's native
    loader; OpenCV's fixed-point luma rounds otherwise, so it is held
    within 1 of OpenCV's, as tests/test_native_loader.py holds lvt_tpu's;
  * the sequence readers: every array equal to lvt_tpu's on one tree, the
    EuRoC maps and ``rectify`` bit-equal, the configured VOConfigs equal.
"""

import dataclasses
import os
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lvt_tpu.config import load_config as jx_load_config
from lvt_tpu.geometry.se3 import Pose as JxPose
from lvt_tpu.io import datasets as jx_datasets
from lvt_tpu.io import native_loader as jx_native
from lvt_tpu.io import trajectory as jx_trajectory
from lvt_tpu_torch.config import load_config
from lvt_tpu_torch.geometry.se3 import Pose
from lvt_tpu_torch.io import datasets, native_loader, trajectory

cv2 = pytest.importorskip("cv2")


def _poses(n, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(n, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = (rs.randn(n, 3) * 30).astype(np.float32)
    return ([Pose(torch.from_numpy(a), torch.from_numpy(b))
             for a, b in zip(t, q)],
            [JxPose(jnp.asarray(a), jnp.asarray(b)) for a, b in zip(t, q)])


def test_trajectory_files_are_lvt_tpus(tmp_path):
    ours, theirs = _poses(20)
    stamps = [1403636579.763555584 + 0.05 * i for i in range(20)]
    for name, dump, extra in (("kitti", "dump_kitti", ()),
                              ("tum", "dump_tum", (stamps,))):
        a, b = tmp_path / f"port_{name}.txt", tmp_path / f"jax_{name}.txt"
        getattr(trajectory, dump)(str(a), ours, *extra)
        getattr(jx_trajectory, dump)(str(b), theirs, *extra)
        assert a.read_bytes() == b.read_bytes(), name
    # either package reads both files
    for load, name in (("load_kitti", "kitti"), ("load_tum", "tum")):
        for f in ("port", "jax"):
            path = str(tmp_path / f"{f}_{name}.txt")
            got, want = getattr(trajectory, load)(path), \
                getattr(jx_trajectory, load)(path)
            for g, w in zip(got if name == "tum" else [got],
                            want if name == "tum" else [want]):
                np.testing.assert_array_equal(g, w)
    mats = trajectory.load_kitti(str(tmp_path / "port_kitti.txt"))
    r, t = trajectory.pose_to_rt(ours[3])
    np.testing.assert_allclose(mats[3, :, :3], r, atol=1e-9)
    np.testing.assert_allclose(mats[3, :, 3], t, atol=1e-9)


def test_trajectory_errors_are_lvt_tpus():
    rs = np.random.RandomState(1)
    gt = np.cumsum(rs.randn(60, 3), 0)
    theta = 0.4
    r = np.array([[np.cos(theta), -np.sin(theta), 0],
                  [np.sin(theta), np.cos(theta), 0], [0, 0, 1.0]])
    est = gt @ r.T + [5.0, -3.0, 2.0] + rs.randn(60, 3) * 0.05
    assert abs(trajectory.ate_rmse_aligned(est, gt)
               - jx_trajectory.ate_rmse_aligned(est, gt)) <= 1e-12
    assert trajectory.ate_rmse_aligned(gt @ r.T + 1.0, gt) < 1e-9
    for delta in (1, 3):
        assert abs(trajectory.rpe_rmse(est, gt, delta)
                   - jx_trajectory.rpe_rmse(est, gt, delta)) <= 1e-12
    ours, _ = _poses(60, seed=2)
    est_r = np.stack([trajectory.pose_to_rt(p)[0] for p in ours])
    gt_r = np.stack([trajectory.pose_to_rt(p)[0] for p in _poses(60, 3)[0]])
    assert abs(trajectory.rot_rmse_deg(est_r, gt_r)
               - jx_trajectory.rot_rmse_deg(est_r, gt_r)) <= 1e-12


# ---- the PNG decoder
def _filter_types(path) -> set:
    """The scanline filter types a gray or RGB PNG uses."""
    data = open(path, "rb").read()
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = body
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = int.from_bytes(hdr[:4], "big"), int.from_bytes(hdr[4:8], "big")
    depth, color = hdr[8], hdr[9]
    stride = w * {0: 1, 2: 3, 3: 1}[color] * depth // 8
    raw = zlib.decompress(idat)
    return {raw[y * (stride + 1)] for y in range(h)}


FILTERS = ("NONE", "SUB", "UP", "AVG", "PAETH", "ALL")
KINDS = ("gray8", "gray16", "rgb")


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """name -> (path, the array as stored, RGB order for color): each kind
    written by OpenCV with each of libpng's filter types forced, and with
    libpng's adaptive choice over all of them; a palette PNG from Pillow;
    chip_smoke.py's 8- and 16-bit files."""
    d = tmp_path_factory.mktemp("png")
    rs = np.random.RandomState(7)
    yy, xx = np.mgrid[:90, :130]
    smooth = ((np.sin(xx / 9.0) * 60 + yy * 1.3 + 60)
              + rs.randint(0, 3, (90, 130))).astype(np.uint8)
    arrays = {
        "gray8": smooth,
        "gray16": smooth.astype(np.uint16) * 211
        + rs.randint(0, 7, smooth.shape).astype(np.uint16),
        "rgb": np.stack([smooth, smooth[::-1], 255 - smooth], -1),
    }
    out = {}
    for kind, a in arrays.items():
        for flt in FILTERS:
            path = str(d / f"{kind}_{flt}.png")
            flag = getattr(cv2, "IMWRITE_PNG_ALL_FILTERS" if flt == "ALL"
                           else f"IMWRITE_PNG_FILTER_{flt}")
            cv2.imwrite(path, a[..., ::-1] if a.ndim == 3 else a,
                        [cv2.IMWRITE_PNG_FILTER, flag])
            out[f"{kind}_{flt}"] = (path, a)
    pil = pytest.importorskip("PIL.Image")
    # 256 entries: Pillow writes an 8-bit palette (the decoders' subset)
    idx = rs.randint(0, 256, (50, 70)).astype(np.uint8)
    palette = rs.randint(0, 256, (256, 3), np.uint8)
    img = pil.fromarray(idx, mode="P")
    img.putpalette(palette.reshape(-1).tolist())
    path = str(d / "palette.png")
    img.save(path)
    out["palette"] = (path, palette[idx])
    noise = rs.randint(0, 256, (120, 200), np.uint8)
    for name, a in (("chip8", noise),
                    ("chip16", rs.randint(0, 65536, (90, 130))
                     .astype(np.uint16))):
        path = str(d / f"{name}.png")
        chip_smoke.write_png(path, a)
        out[name] = (path, a)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_opencv_files_use_every_filter(pngs, kind):
    """Each forced filter is the one in the file; the adaptive choice
    mixes several."""
    for i, flt in enumerate(FILTERS[:5]):
        assert _filter_types(pngs[f"{kind}_{flt}"][0]) == {i}, flt
    assert len(_filter_types(pngs[f"{kind}_ALL"][0])) > 1


@pytest.mark.parametrize("name", [f"{k}_{f}" for k in KINDS for f in FILTERS]
                         + ["palette", "chip8", "chip16"])
def test_decoder_equals_opencv_and_lvt_tpus(pngs, name):
    path, want = pngs[name]
    got = datasets.imread_raw(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    cv = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got, cv[..., ::-1] if cv.ndim == 3 else cv)
    np.testing.assert_array_equal(got, jx_native.imread_native(path))
    gray = datasets.imread_gray(path)
    np.testing.assert_array_equal(gray, jx_native.imread_gray_native(path))
    np.testing.assert_array_equal(gray, jx_datasets.imread_gray(path))
    cv_gray = cv2.imread(path, cv2.IMREAD_GRAYSCALE).astype(int)
    if want.ndim == 3:
        assert np.abs(gray.astype(int) - cv_gray).max() <= 1
    elif want.dtype == np.uint8:
        np.testing.assert_array_equal(gray, want)
    assert native_loader.probe(path) == jx_native.probe(path)


def test_decoder_batch_and_failures(pngs, tmp_path):
    path, want = pngs["chip8"]
    batch = native_loader.imread_gray_batch([path] * 4, 200, 120,
                                            n_threads=2)
    assert batch.shape == (4, 120, 200)
    assert all((b == want).all() for b in batch)
    # a PNG the decoder rejects raises; OpenCV is never tried for it
    bad = tmp_path / "bad.png"
    bad.write_bytes(open(path, "rb").read()[:100])
    with pytest.raises(ValueError, match="rejected"):
        datasets.imread_gray(str(bad))
    with pytest.raises(FileNotFoundError):
        datasets.imread_raw(str(tmp_path / "missing.png"))
    with pytest.raises(ValueError):
        native_loader.imread_gray_batch([path, str(bad)], 200, 120)
    # a file that is not a PNG goes to OpenCV
    bmp = str(tmp_path / "frame.bmp")
    cv2.imwrite(bmp, want)
    np.testing.assert_array_equal(datasets.imread_gray(bmp), want)


def test_decoder_builds_in_the_ports_build_dir():
    lib = native_loader.build()
    assert lib.parent == native_loader.BUILD_DIR
    assert lib.parent.parts[-2:] == ("build", "lvt_tpu_torch")
    assert "native" not in lib.parent.parts


# ---- the sequence readers
def _write_kitti(root, n=3):
    from lvt_tpu_torch.io.synthetic import SyntheticWorld

    world = SyntheticWorld(width=320, height=240, fx=260.0, fy=260.0,
                           cx=160.0, cy=120.0, baseline=0.3, n_points=600,
                           extent_x=40.0, extent_y=18.0, extent_z=90.0)
    seq = root / "sequences" / "03"
    for side in ("image_0", "image_1"):
        (seq / side).mkdir(parents=True)
    for i, (l, r, _) in enumerate(world.stereo_sequence(n, speed=0.5)):
        cv2.imwrite(str(seq / "image_0" / f"{i:06d}.png"), l.astype(np.uint8))
        cv2.imwrite(str(seq / "image_1" / f"{i:06d}.png"), r.astype(np.uint8))
    return root / "sequences"


def test_kitti_sequence_is_lvt_tpus(tmp_path):
    seqs = _write_kitti(tmp_path)
    # the default calibration resolves inside the port's configs/
    ours, theirs = datasets.KittiSequence(str(seqs), 3), \
        jx_datasets.KittiSequence(str(seqs), 3)
    assert ours.calib == theirs.calib and len(ours) == len(theirs) == 3
    assert os.path.dirname(os.path.abspath(datasets.CONFIG_DIR)).endswith(
        "lvt_tpu_torch")
    kitti_yaml = os.path.join(datasets.CONFIG_DIR, "kitti", "vo_config.yaml")
    a = ours.configure(load_config(kitti_yaml))
    b = theirs.configure(jx_load_config(kitti_yaml))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.img_width, a.img_height) == (320, 240)
    for (l0, r0), (l1, r1) in zip(ours, theirs):
        np.testing.assert_array_equal(l0, l1)
        np.testing.assert_array_equal(r0, r1)
        assert l0.dtype == np.uint8


def test_euroc_sequence_is_lvt_tpus(tmp_path):
    rs = np.random.RandomState(5)
    points = np.stack([rs.uniform(-15, 15, 400), rs.uniform(-8, 8, 400),
                       rs.uniform(2.0, 30.0, 400)], -1)
    shade = rs.uniform(60.0, 215.0, 400)
    names = [f"{1403636579763555584 + i * 50000000}" for i in range(2)]
    for cam, right in (("cam0", False), ("cam1", True)):
        d = tmp_path / "V9_99" / "mav0" / cam / "data"
        d.mkdir(parents=True)
        for i, name in enumerate(names):
            cv2.imwrite(str(d / f"{name}.png"), datasets.render_euroc_raw(
                points, shade, np.array([0.0, 0.0, 0.2 * i]), right))
    stamps = tmp_path / "stamps.txt"
    stamps.write_text("\n".join(names) + "\n")
    ours = datasets.EurocSequence(str(tmp_path), "V9_99", str(stamps))
    theirs = jx_datasets.EurocSequence(str(tmp_path), "V9_99", str(stamps))
    assert ours.titles == theirs.titles and ours.stamps == theirs.stamps
    np.testing.assert_array_equal(ours.map_l, theirs.map_l)
    np.testing.assert_array_equal(ours.map_r, theirs.map_r)
    euroc_yaml = os.path.join(datasets.CONFIG_DIR, "euroc", "vo_config.yaml")
    assert dataclasses.asdict(ours.configure(load_config(euroc_yaml))) == \
        dataclasses.asdict(theirs.configure(jx_load_config(euroc_yaml)))
    for (l0, r0), (l1, r1) in zip(ours, theirs):
        np.testing.assert_array_equal(l0, l1)
        np.testing.assert_array_equal(r0, r1)
        for got, want in zip(ours.rectify(l0, r0), theirs.rectify(l1, r1)):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the default stamp list resolves inside the port's configs/
    default = datasets.EurocSequence(str(tmp_path), "MH_01_easy")
    assert default.stamps == jx_datasets.EurocSequence(
        str(tmp_path), "MH_01_easy").stamps and len(default) > 3000


def test_euroc_body_pose_is_lvt_tpus():
    """The position bit-equal; the quaternion within 1e-7 (lvt_tpu
    normalizes with ``jnp.linalg.norm``, the port with a dot product
    summed left to right: 3 of 50 poses differ in a last bit)."""
    ours, theirs = _poses(5, seed=4)
    for p, jp in zip(ours, theirs):
        got = datasets.euroc_body_pose(p)
        want = JxPose.from_matrix44(jnp.asarray(
            jx_datasets.EUROC_T_BS @ np.asarray(jp.matrix44()), jnp.float32))
        np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))
        np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q),
                                   atol=1e-7)


def test_tum_sequence_is_lvt_tpus(tmp_path):
    rs = np.random.RandomState(9)
    data = tmp_path / "rgbd_dataset_synthetic"
    (data / "rgb").mkdir(parents=True)
    (data / "depth").mkdir(parents=True)
    lines = ["# timestamp rgb timestamp depth"]
    for i in range(3):
        ts = f"{1000.0 + 0.1 * i:.6f}"
        cv2.imwrite(str(data / "rgb" / f"{ts}.png"),
                    rs.randint(0, 256, (48, 64, 3), np.uint8))
        cv2.imwrite(str(data / "depth" / f"{ts}.png"),
                    rs.randint(0, 40000, (48, 64)).astype(np.uint16))
        lines.append(f"{ts} rgb/{ts}.png {ts} depth/{ts}.png")
    assoc = tmp_path / "assoc.txt"
    assoc.write_text("\n".join(lines) + "\n")
    ours = datasets.TumRgbdSequence(str(data), str(assoc))
    theirs = jx_datasets.TumRgbdSequence(str(data), str(assoc))
    assert ours.stamps == theirs.stamps and len(ours) == 3
    assert datasets.TUM_DEPTH_SCALE == jx_datasets.TUM_DEPTH_SCALE
    for (g0, d0), (g1, d1) in zip(ours, theirs):
        np.testing.assert_array_equal(g0, g1)
        assert d0.dtype == d1.dtype == np.float32
        np.testing.assert_array_equal(d0, d1)
    # the default association resolves inside the port's configs/
    name = "rgbd_dataset_freiburg1_xyz"
    assert datasets.TumRgbdSequence(str(tmp_path / name)).entries == \
        jx_datasets.TumRgbdSequence(str(tmp_path / name)).entries
