"""Dataset IO of the port against the JAX package
(rover_slam_tpu/utils/dataset.py): tests/test_dataset_native.py's cases,
each through both packages, natively and through the pure-Python readers,
giving equal arrays; the KITTI and TUM-RGBD layouts and the format sniffer;
the announced fallback when the native build is absent; and
write_euroc_sequence writing the JAX package's files byte for byte."""
import filecmp
import os

import numpy as np
import pytest

from rover_slam_tpu.utils import dataset as jds, synthetic as jsyn
from rover_slam_tpu_torch.utils import dataset as tds, synthetic as tsyn

from test_dataset_native import _write_png_gray8, euroc_dir  # noqa: F401  (fixture)


def test_native_builds_into_the_port():
    assert tds.native_available()
    path = tds._lib_path()
    assert os.path.exists(path) and os.sep + "rover_slam_tpu_torch" + os.sep in path
    assert tds._lib.dataset_has_png() == 1


@pytest.mark.parametrize("numeric", [False, True])
def test_read_csv(euroc_dir, numeric):   # noqa: F811
    path = os.path.join(euroc_dir, "imu0" if numeric else "cam0", "data.csv")
    t_t, v_t = tds.read_csv(path, numeric)
    t_j, v_j = jds.read_csv(path, numeric)
    np.testing.assert_array_equal(t_t, t_j)
    if numeric:
        np.testing.assert_array_equal(v_t, v_j)
        assert v_t.shape == (24, 6)
    else:
        assert v_t == v_j and len(v_t) == 6
    t_p, v_p = tds._read_csv_py(path, numeric)
    np.testing.assert_array_equal(t_p, t_j)
    np.testing.assert_array_equal(np.asarray(v_p), np.asarray(v_j))


def test_images_and_prefetcher(euroc_dir, tmp_path):   # noqa: F811
    """PGM frames, plain and filtered PNGs, and a mixed-format prefetch."""
    seq_t, seq_j = tds.load_euroc_sequence(euroc_dir), jds.load_euroc_sequence(euroc_dir)
    assert seq_t["image_paths"] == seq_j["image_paths"]
    for k in ("t_cam", "t_imu", "gyro", "acc"):
        np.testing.assert_array_equal(seq_t[k], seq_j[k])
    rng = np.random.default_rng(5)
    paths = list(seq_t["image_paths"])
    for filt in (False, True):
        p = str(tmp_path / f"f{filt}.png")
        _write_png_gray8(p, rng.integers(0, 255, (48, 64), np.uint8), filters=filt)
        paths.append(p)
    for p in paths:
        img = jds.read_image(p)
        np.testing.assert_array_equal(tds.read_image(p), img)
        np.testing.assert_array_equal(tds._read_image_py(p), img)
    pf = tds.ImagePrefetcher(paths, depth=3)
    try:
        for i, p in enumerate(paths):
            np.testing.assert_array_equal(pf.get(i), jds.read_image(p))
    finally:
        pf.close()


def test_pgm_only_build_prefetches_png(euroc_dir, tmp_path, monkeypatch):   # noqa: F811
    """A native build without libpng (as on a host with no libpng headers)
    announces itself, still prefetches PGM natively, and decodes PNG frames,
    plain and filtered, through the pure-Python reader in read_image and in
    ImagePrefetcher."""
    import ctypes
    import subprocess
    so = str(tmp_path / "libdataset_loader_nopng.so")
    subprocess.run(["g++", *tds.CXX_FLAGS, "-o", so, tds.NATIVE_SRC, "-DDATASET_NO_PNG"],
                   check=True, capture_output=True)
    with pytest.warns(RuntimeWarning, match="ImagePrefetcher"):
        lib = tds.bind(ctypes.CDLL(so))
    assert lib.dataset_has_png() == 0
    monkeypatch.setattr(tds, "_lib", lib)
    rng = np.random.default_rng(6)
    paths = list(tds.load_euroc_sequence(euroc_dir)["image_paths"])
    for i, filt in enumerate((False, True, True)):
        p = str(tmp_path / f"g{i}.png")
        _write_png_gray8(p, rng.integers(0, 255, (48, 64), np.uint8), filters=filt)
        paths.insert(2 * i, p)
    pf = tds.ImagePrefetcher(paths, depth=3)
    try:
        for i, p in enumerate(paths):
            img = jds.read_image(p)
            np.testing.assert_array_equal(pf.get(i), img)
            np.testing.assert_array_equal(tds.read_image(p), img)
    finally:
        pf.close()


def test_foreign_build_is_rebuilt(tmp_path, monkeypatch):
    """A library under the build's name that cannot load here (a build made
    on another host, linked to a libpng this one lacks) is built again."""
    monkeypatch.setattr(tds, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tds, "_lib", None)
    monkeypatch.setattr(tds, "_lib_failed", False)
    with open(tds._lib_path(), "wb") as f:
        f.write(b"not a shared object")
    assert tds.native_available()
    with open(tds._lib_path(), "rb") as f:
        assert f.read(4) == b"\x7fELF"


def test_pure_python_fallback_is_announced(euroc_dir, monkeypatch):   # noqa: F811
    """Without a native build the readers fall back to pure Python, with a
    warning; the prefetcher needs the native runtime."""
    def no_compiler():
        raise RuntimeError("g++ failed for dataset_loader.cc")

    monkeypatch.setattr(tds, "_lib", None)
    monkeypatch.setattr(tds, "_lib_failed", False)
    monkeypatch.setattr(tds, "build_native", no_compiler)
    with pytest.warns(RuntimeWarning, match="pure-Python"):
        assert not tds.native_available()
    seq = tds.load_euroc_sequence(euroc_dir)
    ref = jds.load_euroc_sequence(euroc_dir)
    np.testing.assert_array_equal(seq["acc"], ref["acc"])
    np.testing.assert_array_equal(tds.read_image(seq["image_paths"][2]),
                                  jds.read_image(ref["image_paths"][2]))
    with pytest.raises(RuntimeError, match="native"):
        tds.ImagePrefetcher(seq["image_paths"])


def test_other_layouts(tmp_path):
    """KITTI (times.txt + image_0/ and image_1/) and TUM-RGBD (rgb.txt,
    depth.txt with a dropped depth frame, a gray16 depth PNG) through both
    packages' loaders and the format sniffer."""
    import struct
    import zlib
    kitti = tmp_path / "kitti"
    for d in ("image_0", "image_1"):
        (kitti / d).mkdir(parents=True)
        for i in range(3):
            (kitti / d / f"{i:06d}.png").write_bytes(b"")
    (kitti / "times.txt").write_text("0.0\n0.1\n0.2\n")
    tum = tmp_path / "tum"
    (tum / "depth").mkdir(parents=True)
    (tum / "rgb.txt").write_text("# rgb\n1.00 rgb/a.png\n1.05 rgb/b.png\n1.10 rgb/c.png\n")
    (tum / "depth.txt").write_text("# depth\n1.001 depth/a.png\n1.101 depth/c.png\n")
    (tum / "groundtruth.txt").write_text("1.0 0 0 0 0 0 0 1\n")
    rng = np.random.default_rng(1)
    depth = rng.integers(0, 65535, (6, 5)).astype(np.uint16)
    raw = b"".join(b"\x00" + row.astype(">u2").tobytes() for row in depth)

    def chunk(t, b):
        return struct.pack(">I", len(b)) + t + b + struct.pack(">I", zlib.crc32(t + b))

    (tum / "depth" / "a.png").write_bytes(
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 6, 16, 0, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    for root, fmt in ((str(kitti), "kitti"), (str(tum), "tum-rgbd")):
        assert tds.detect_sequence_format(root) == jds.detect_sequence_format(root) == fmt
        (dt, ft), (dj, fj) = tds.load_sequence(root), jds.load_sequence(root)
        assert ft == fj and dt.keys() == dj.keys()
        for k in dt:
            if isinstance(dt[k], np.ndarray):
                np.testing.assert_array_equal(dt[k], dj[k])
            else:
                assert dt[k] == dj[k], k
    d16 = str(tum / "depth" / "a.png")
    np.testing.assert_array_equal(tds.read_depth16(d16), jds.read_depth16(d16))
    np.testing.assert_array_equal(tds.read_depth16(d16), depth)


def test_write_euroc_sequence(tmp_path):
    """Both writers on the same small photo world and IMU orbit, monocular
    and as a rectified stereo tree (baseline > 0: cam1/ with
    render_photo_stereo's right eye, one CSV per eye): every file equal,
    byte for byte."""
    R, t, times, _, imu = tsyn.orbit_with_imu(n_frames=4, revs=0.05, dt=0.1)
    world = tsyn.make_photo_world(n_sprites=300, patch=11, seed=3, image_hw=(60, 80),
                                  layout="ring", ring_orbit_radius=5.0)
    for name, baseline, n_files in (("mono", 0.0, 4 + 3), ("stereo", 0.11, 2 * 4 + 4)):
        port, jax_ = tmp_path / name / "port", tmp_path / name / "jax"
        tsyn.write_euroc_sequence(str(port), world, R, t, times, baseline=baseline, imu=imu)
        jsyn.write_euroc_sequence(str(jax_), jsyn.PhotoWorld(*world), R, t, times,
                                  baseline=baseline, imu=imu)
        files = []

        def walk(c, rel=""):
            assert not c.left_only and not c.right_only and not c.diff_files, rel
            files.extend(os.path.join(rel, f) for f in c.same_files)
            for sub_name, sub in c.subdirs.items():
                walk(sub, os.path.join(rel, sub_name))

        walk(filecmp.dircmp(str(port), str(jax_)))
        for f in files:   # dircmp compares stat signatures; hold the bytes too
            assert filecmp.cmp(str(port / f), str(jax_ / f), shallow=False)
        # the frames of each eye, a data.csv per eye, imu0/data.csv, gt.txt
        assert len(files) == n_files, files
    seq = tds.load_euroc_sequence(str(tmp_path / "stereo" / "port"))
    assert len(seq["right_image_paths"]) == len(seq["image_paths"]) == 4
    assert not np.array_equal(tds.read_image(seq["image_paths"][1]),
                              tds.read_image(seq["right_image_paths"][1]))
