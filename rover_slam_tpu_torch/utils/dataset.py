"""Dataset IO: EuRoC, KITTI and TUM-RGBD readers backed by a native C++
runtime.

Counterpart of rover_slam_tpu/utils/dataset.py. The host IO path (CSV parse,
image decode, read-ahead) is the port's copy of the C++ loader,
`rover_slam_tpu_torch/native/dataset_loader.cc`, built with g++ at first use
into `rover_slam_tpu_torch/_build/` (named by a hash of the source) and bound
with ctypes. When it cannot be built, the pure-Python CSV / PNG / PGM readers
below take over, and a warning says so; `ImagePrefetcher` needs the native
runtime. A build without libpng (`dataset_has_png()` 0) decodes PGM natively
and sends PNG images, in `read_image` and in `ImagePrefetcher`, to the
pure-Python reader, which a warning announces.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_SRC = os.path.join(_PKG, "native", "dataset_loader.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
_lib = None
_lib_failed = False


def _lib_path() -> str:
    with open(NATIVE_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libdataset_loader-{digest}.so")


def build_native() -> str:
    """Compile the native loader unless a current build exists; returns the
    library path. Links libpng; without it the library decodes PGM only
    (`dataset_has_png()` returns 0). Raises RuntimeError when g++ fails."""
    so = _lib_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    logs = []
    for extra in (("-lpng",), ("-DDATASET_NO_PNG",)):
        p = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, NATIVE_SRC, *extra],
                           capture_output=True, text=True)
        if p.returncode == 0:
            os.replace(tmp, so)
            return so
        logs.append(p.stdout + p.stderr)
    raise RuntimeError("g++ failed for dataset_loader.cc:\n" + "\n".join(logs))


def _load_lib():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        try:
            lib = ctypes.CDLL(build_native())
        except OSError:
            # A build made on another host (linked to a libpng this one
            # lacks) sits under the same name: build again here.
            os.remove(_lib_path())
            lib = ctypes.CDLL(build_native())
    except (OSError, RuntimeError) as e:
        _lib_failed = True
        warnings.warn(f"native dataset loader unavailable ({str(e).splitlines()[0]}); "
                      "using the pure-Python CSV / PNG / PGM readers", RuntimeWarning)
        return None
    _lib = bind(lib)
    return _lib


def bind(lib):
    """Declare the loader's C signatures on a loaded `ctypes.CDLL`."""
    lib.dataset_has_png.restype = ctypes.c_int
    lib.csv_open.restype = ctypes.c_void_p
    lib.csv_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.csv_size.restype = ctypes.c_long
    lib.csv_size.argtypes = [ctypes.c_void_p]
    lib.csv_timestamps.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    lib.csv_values.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    lib.csv_field.restype = ctypes.c_int
    lib.csv_field.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p,
                              ctypes.c_int]
    lib.csv_close.argtypes = [ctypes.c_void_p]
    lib.image_read.restype = ctypes.c_int
    lib.image_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                               ctypes.c_long, ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int)]
    lib.prefetch_open.restype = ctypes.c_void_p
    lib.prefetch_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
                                  ctypes.c_long]
    lib.prefetch_fetch.restype = ctypes.c_int
    lib.prefetch_fetch.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                   ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    lib.prefetch_width.restype = ctypes.c_int
    lib.prefetch_width.argtypes = [ctypes.c_void_p]
    lib.prefetch_height.restype = ctypes.c_int
    lib.prefetch_height.argtypes = [ctypes.c_void_p]
    lib.prefetch_close.argtypes = [ctypes.c_void_p]
    if not lib.dataset_has_png():
        warnings.warn("native dataset loader built without libpng: PNG images "
                      "(read_image and ImagePrefetcher) decode through the slow "
                      "pure-Python reader", RuntimeWarning)
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def read_csv(path: str, numeric: bool):
    """Parse an EuRoC-style CSV. Returns (timestamps_s [N], filenames list) or
    (timestamps_s, values [N,6]) when numeric (IMU)."""
    lib = _load_lib()
    if lib is None:
        return _read_csv_py(path, numeric)
    h = lib.csv_open(path.encode(), 1 if numeric else 0)
    if not h:
        raise FileNotFoundError(path)
    try:
        n = lib.csv_size(h)
        ts = np.zeros(n, np.float64)
        lib.csv_timestamps(h, ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if numeric:
            vals = np.zeros((n, 6), np.float64)
            lib.csv_values(h, vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
            return ts, vals
        buf = ctypes.create_string_buffer(512)
        names = []
        for i in range(n):
            lib.csv_field(h, i, buf, 512)
            names.append(buf.value.decode())
        return ts, names
    finally:
        lib.csv_close(h)


def _is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x89P"


def read_image(path: str) -> np.ndarray:
    """Decode an 8-bit grayscale image (PNG or PGM, dispatched on the file
    magic): the native reader, else the pure-Python one."""
    lib = _load_lib()
    if lib is None or (not lib.dataset_has_png() and _is_png(path)):
        return _read_image_py(path)
    cap = 8192 * 8192
    buf = np.zeros(cap, np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.image_read(path.encode(), buf.ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint8)), cap, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"image_read({path}) -> {rc}")
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()



class ImagePrefetcher:
    """Threaded read-ahead image stream: the native runtime decodes ahead of
    the consumer (in order) while the GPU computes. On a build without libpng
    the native decode of a PNG frame fails and `get` decodes it in pure
    Python instead."""

    def __init__(self, paths, depth: int = 8):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native dataset loader not built")
        self._lib = lib
        self._png_py = not lib.dataset_has_png()
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._h = lib.prefetch_open(arr, len(self._paths), depth)
        self._n = len(paths)

    def __len__(self):
        return self._n

    def get(self, idx: int) -> np.ndarray:
        cap = 8192 * 8192
        buf = np.zeros(cap, np.uint8)
        rc = self._lib.prefetch_fetch(
            self._h, idx, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if rc == -2 and self._png_py and _is_png(self._paths[idx].decode()):
            return _read_image_py(self._paths[idx].decode())
        if rc != 0:
            raise IOError(f"prefetch_fetch({idx}) -> {rc}")
        w = self._lib.prefetch_width(self._h)
        h = self._lib.prefetch_height(self._h)
        return buf[: w * h].reshape(h, w).copy()

    def close(self):
        if self._h:
            self._lib.prefetch_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def load_euroc_sequence(root: str):
    """EuRoC mav0 layout: cam0/data.csv + cam0/data/<ts>.png|pgm,
    optional cam1 (stereo right eye), imu0/data.csv. Returns dict with
    timestamps, image paths (+ right_image_paths when cam1 exists), imu
    arrays."""
    cam_csv = os.path.join(root, "cam0", "data.csv")
    imu_csv = os.path.join(root, "imu0", "data.csv")
    t_cam, names = read_csv(cam_csv, numeric=False)
    img_dir = os.path.join(root, "cam0", "data")
    paths = [os.path.join(img_dir, n) for n in names]
    out = {"t_cam": t_cam, "image_paths": paths}
    cam1_csv = os.path.join(root, "cam1", "data.csv")
    if os.path.exists(cam1_csv):
        _, names_r = read_csv(cam1_csv, numeric=False)
        img_dir_r = os.path.join(root, "cam1", "data")
        out["right_image_paths"] = [os.path.join(img_dir_r, n)
                                    for n in names_r]
    if os.path.exists(imu_csv):
        t_imu, vals = read_csv(imu_csv, numeric=True)
        out["t_imu"] = t_imu
        out["gyro"] = vals[:, 0:3]
        out["acc"] = vals[:, 3:6]
    return out


def load_kitti_sequence(root: str):
    """KITTI odometry layout: times.txt (seconds, one per line) +
    image_0/ left grayscale PNGs (optionally image_1/ right). The reference
    drives this layout through its mono_kitti example binary
    (reference: CMakeLists.txt:163-165, README.md KITTI section)."""
    times_path = os.path.join(root, "times.txt")
    t_cam = np.loadtxt(times_path, dtype=np.float64).reshape(-1)
    img_dir = None
    for cand in ("image_0", "image_2"):   # gray pair first, color pair second
        d = os.path.join(root, cand)
        if os.path.isdir(d):
            img_dir = d
            break
    if img_dir is None:
        raise IOError(f"no image_0/ or image_2/ under {root}")
    names = sorted(n for n in os.listdir(img_dir) if n.endswith(".png"))
    if len(names) != len(t_cam):
        import warnings
        warnings.warn(f"KITTI sequence {root}: {len(names)} images vs "
                      f"{len(t_cam)} timestamps; truncating to the shorter")
    n = min(len(names), len(t_cam))
    names = names[:n]
    out = {"t_cam": t_cam[:n],
           "image_paths": [os.path.join(img_dir, n_) for n_ in names]}
    right_dir = os.path.join(root, {"image_0": "image_1",
                                    "image_2": "image_3"}[
                                        os.path.basename(img_dir)])
    if os.path.isdir(right_dir):
        names_r = sorted(n for n in os.listdir(right_dir)
                         if n.endswith(".png"))
        if len(names_r) == len(names):
            out["right_image_paths"] = [os.path.join(right_dir, n)
                                        for n in names_r]
    return out


def load_tum_rgbd_sequence(root: str, max_dt: float = 0.02):
    """TUM RGB-D layout: rgb.txt / depth.txt index files ('t path' lines,
    '#' comments) + groundtruth.txt. Depth frames are associated to RGB
    frames by NEAREST timestamp within max_dt — note this is not the
    reference evaluation/associate.py policy (greedy one-to-one), so a depth
    frame can serve several RGB frames on dropped-frame sequences. The
    mono_tum example binary reads the same rgb.txt (CMakeLists.txt:153-155)."""
    def read_index(path):
        ts, names = [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                ts.append(float(parts[0]))
                names.append(parts[1])
        return np.asarray(ts, np.float64), names

    t_rgb, rgb_names = read_index(os.path.join(root, "rgb.txt"))
    out = {"t_cam": t_rgb,
           "image_paths": [os.path.join(root, n) for n in rgb_names]}
    depth_index = os.path.join(root, "depth.txt")
    if os.path.exists(depth_index):
        t_d, d_names = read_index(depth_index)
        # nearest-timestamp depth per RGB frame; None = no depth within max_dt
        j = np.searchsorted(t_d, t_rgb)
        j = np.clip(j, 0, len(t_d) - 1)
        jm = np.clip(j - 1, 0, len(t_d) - 1)
        pick = np.where(np.abs(t_d[jm] - t_rgb) <= np.abs(t_d[j] - t_rgb),
                        jm, j)
        ok = np.abs(t_d[pick] - t_rgb) <= max_dt
        out["depth_paths"] = [os.path.join(root, d_names[p]) if k else None
                              for p, k in zip(pick, ok)]
    gt = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt):
        out["gt_path"] = gt
    return out


def detect_sequence_format(root: str) -> str:
    """Sniff the dataset layout: 'euroc' (mav0/cam0 csv), 'kitti'
    (times.txt + image_0|2), or 'tum-rgbd' (rgb.txt)."""
    if os.path.exists(os.path.join(root, "cam0", "data.csv")):
        return "euroc"
    if os.path.exists(os.path.join(root, "mav0", "cam0", "data.csv")):
        return "euroc"
    if os.path.exists(os.path.join(root, "rgb.txt")):
        return "tum-rgbd"
    if os.path.exists(os.path.join(root, "times.txt")) and (
            os.path.isdir(os.path.join(root, "image_0"))
            or os.path.isdir(os.path.join(root, "image_2"))):
        return "kitti"
    raise IOError(f"cannot detect dataset format under {root}")


def load_sequence(root: str, fmt: str = "auto"):
    """Format-dispatched sequence loader. Returns a (data, fmt) TUPLE:
    data is the per-format dict (always with t_cam + image_paths, plus
    format extras), fmt is the detected/selected format string."""
    if fmt == "auto":
        fmt = detect_sequence_format(root)
    if fmt == "euroc":
        if os.path.exists(os.path.join(root, "mav0", "cam0", "data.csv")):
            root = os.path.join(root, "mav0")
        return load_euroc_sequence(root), "euroc"
    if fmt == "kitti":
        return load_kitti_sequence(root), "kitti"
    if fmt == "tum-rgbd":
        return load_tum_rgbd_sequence(root), "tum-rgbd"
    raise ValueError(f"unknown dataset format {fmt!r}")


def read_depth16(path: str) -> np.ndarray:
    """Decode a 16-bit grayscale PNG depth map (TUM RGB-D ships these;
    values are millimeters*5, divided out by RGBD.DepthMapFactor=5000).
    Returns uint16 [H,W]. Pure-Python (depth frames are off the hot path)."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":   # explicit: asserts vanish under -O
        raise IOError(f"{path}: not a PNG")
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        (length,), ctype = struct.unpack(">I", data[pos:pos + 4]), \
            data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        pos += 12 + length
    w, h, depth, color, _, _, interlace = ihdr
    if depth != 16 or color != 0 or interlace != 0:
        raise IOError(f"not a gray16 PNG (depth={depth}, color={color})")
    raw = zlib.decompress(b"".join(idat))
    stride = w * 2          # bytes per row; filters act on raw bytes
    bpp = 2                 # bytes per pixel (the filter left-offset)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        if ftype > 4:
            raise IOError(f"{path}: corrupt PNG (filter type {ftype})")
        row = np.frombuffer(
            raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)],
            np.uint8).astype(np.int32)
        if ftype == 0:
            pass
        elif ftype == 2:   # Up
            row = (row + prev) & 0xFF
        else:              # Sub/Average/Paeth: left-to-right byte scan
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                else:  # 4 Paeth
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else \
                        (b if pb <= pc else c)
                cur[x] = (row[x] + pred) & 0xFF
            row = cur
        out[y] = row.astype(np.uint8)
        prev = row
    # PNG 16-bit samples are big-endian
    return out.reshape(h, w, 2).astype(np.uint16)[:, :, 0] * 256 + \
        out.reshape(h, w, 2).astype(np.uint16)[:, :, 1]


# ---------------------------------------------------------------------------
# Pure-python fallbacks
# ---------------------------------------------------------------------------

def _read_csv_py(path, numeric):
    ts, other = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.strip().split(",")
            ts.append(float(parts[0]) * 1e-9)
            if numeric:
                vals = [float(x) for x in parts[1:7]]
                vals += [0.0] * (6 - len(vals))
                other.append(vals)
            else:
                other.append(parts[1].strip())
    if numeric:
        return np.asarray(ts), np.asarray(other)
    return np.asarray(ts), other


def _read_image_py(path):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x89P":
        return _read_png_py(path)
    return _read_pgm_py(path)


def _read_png_py(path):
    """Minimal grayscale PNG decode: IHDR/IDAT chunks, zlib inflate, per-row
    un-filtering (spec filters 0-4). Color inputs are reduced to luma. Only
    8-bit depth, no interlacing (EuRoC/TUM-VI PNGs are plain gray8)."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":   # explicit: asserts vanish under -O
        raise IOError(f"{path}: not a PNG")
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        (length,), ctype = struct.unpack(">I", data[pos:pos + 4]), \
            data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        pos += 12 + length
    w, h, depth, color, _, _, interlace = ihdr
    if depth != 8 or interlace != 0:
        raise IOError(f"unsupported PNG (depth={depth}, interlace={interlace})")
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    raw = zlib.decompress(b"".join(idat))
    stride = w * nch
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        row = np.frombuffer(
            raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)],
            np.uint8).astype(np.int32)
        if ftype == 0:
            pass
        elif ftype == 2:   # Up
            row = (row + prev) & 0xFF
        else:              # Sub/Average/Paeth need a left-to-right scan
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - nch] if x >= nch else 0
                b = prev[x]
                c = prev[x - nch] if x >= nch else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                else:  # 4 Paeth
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (row[x] + pred) & 0xFF
            row = cur
        out[y] = row.astype(np.uint8)
        prev = row
    img = out.reshape(h, w, nch)
    if color == 2 or color == 6:   # RGB(A) -> luma (BT.601, like OpenCV)
        rgb = img[:, :, :3].astype(np.float32)
        return (rgb @ np.array([0.299, 0.587, 0.114], np.float32)
                ).round().astype(np.uint8)
    return img[:, :, 0].copy()


def _read_pgm_py(path):
    with open(path, "rb") as f:
        data = f.read()
    assert data[:2] == b"P5"
    # Header: magic, width, height, maxval — with '#' comments allowed.
    pos, tokens = 2, []
    while len(tokens) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] != b"\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        tokens.append(int(data[start:pos]))
    pos += 1  # single whitespace after maxval
    w, h = tokens[0], tokens[1]
    return np.frombuffer(data[pos:pos + w * h], np.uint8).reshape(h, w).copy()
