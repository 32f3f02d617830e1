"""The port's C ABI (``liblvt_c_torch.so``) end to end on the CPU: the C
program ``lvt_tpu_torch/native/lvt_c_example.c`` (tests/test_c_abi.py's C
driver, the frame size on its command line) is compiled against the
library and run in a subprocess with ``LVT_TPU_TORCH_DEVICE=cpu``, as
tests/test_c_abi.py runs lvt_tpu's with ``JAX_PLATFORMS=cpu``.

Checked: the status machine (1 before the first frame, 2 after each, 1
after ``lvt_reset``); every pose equal, as printed (``%.9g``), to the
port's in-process CPU run over the same frames (the subprocess gets this
process's torch thread count); and the reference's NULL-on-failure
contract when the default device, ``cuda``, is missing.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from lvt_tpu_torch import capi
from lvt_tpu_torch.config import load_config
from lvt_tpu_torch.core.system import VOSystem
from lvt_tpu_torch.io.synthetic import SyntheticWorld
from lvt_tpu_torch.io.trajectory import pose_to_rt

# tests/test_c_abi.py's frames and config
W, H = 320, 240
N_FRAMES = 4
CONFIG_YAML = f"""
fx: 260.0
fy: 260.0
cx: 160.0
cy: 120.0
baseline: 0.3
img_width: {W}
img_height: {H}
near_plane_distance: 0.5
far_plane_distance: 150.0
detection_cell_size: 80
max_keypoints_per_cell: 60
agast_threshold: 15
max_map_points: 1024
max_staged_points: 1024
"""

pytestmark = pytest.mark.skipif(
    not (shutil.which("gcc") and shutil.which("g++")),
    reason="gcc or g++ unavailable")


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
    d = tmp_path_factory.mktemp("c_abi_torch")
    cfg = d / "vo_config.yaml"
    cfg.write_text(CONFIG_YAML)
    world = SyntheticWorld(width=W, height=H, fx=260.0, fy=260.0, cx=160.0,
                           cy=120.0, baseline=0.3, n_points=1500,
                           extent_x=40.0, extent_y=18.0, extent_z=90.0)
    frames = [(l.astype(np.uint8), r.astype(np.uint8))
              for l, r, _ in world.stereo_sequence(N_FRAMES, speed=0.5)]
    for i, (l, r) in enumerate(frames):
        (d / f"left_{i}.raw").write_bytes(l.tobytes())
        (d / f"right_{i}.raw").write_bytes(r.tobytes())
    exe = capi.build_example(d / "lvt_c_example")
    return d, cfg, exe, frames


def _run(driver, device):
    d, cfg, exe, _ = driver
    env = capi.example_env(device)
    env["OMP_NUM_THREADS"] = str(torch.get_num_threads())
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return subprocess.run([str(exe), str(cfg), str(d), str(N_FRAMES),
                           str(H), str(W)], capture_output=True, text=True,
                          timeout=600, env=env)


@pytest.fixture(scope="module")
def run_output(driver):
    proc = _run(driver, "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.splitlines()


def test_library_is_the_ports_own():
    lib = capi.build()
    assert lib.name == "liblvt_c_torch.so"
    assert lib.parent.parts[-2:] == ("build", "lvt_tpu_torch")
    syms = subprocess.run(["nm", "-D", "--defined-only", str(lib)],
                          capture_output=True, text=True).stdout
    for name in ("lvt_create", "lvt_destroy", "lvt_track",
                 "lvt_track_with_external_corners", "lvt_get_status",
                 "lvt_reset"):
        assert f" T {name}\n" in syms, name


def test_status_machine(run_output):
    statuses = [int(l.split()[1]) for l in run_output
                if l.startswith("status")]
    assert statuses == [1] + [2] * N_FRAMES + [1]
    assert run_output[-1] == "done"


def test_poses_equal_the_in_process_run(run_output, driver):
    _, cfg, _, frames = driver
    got = [l for l in run_output if l.startswith("pose")]
    assert len(got) == N_FRAMES
    vo = VOSystem(load_config(str(cfg)), device="cpu")
    for line, (l, r) in zip(got, frames):
        vo.track(l, r)
        rot, t = pose_to_rt(vo.last_pose)
        want = "pose " + " ".join(f"{v:.9g}" for v in
                                  np.concatenate([rot.reshape(-1), t]))
        assert line == want
    assert float(got[-1].split()[-1]) > 1.0   # moved forward along z


def test_create_returns_null_without_the_device(driver, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: lvt_create would succeed")
    proc = _run(driver, "cuda")
    assert proc.returncode == 4, proc.stdout + proc.stderr[-2000:]
    assert "create failed" in proc.stderr
    assert "torch.cuda.is_available() is False" in proc.stderr
