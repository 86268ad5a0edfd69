"""The port's native decoders on the CPU: the libjpeg batch decoder
(``data/jpeg_decode.py``, ``native/jpegpool.cc``) against the JAX package's
build of the same source, bitwise (the same system libjpeg), and the ffmpeg
pipe pool (``data/native_decode.py``, ``native/framepool.cc``) with shell
pipelines in place of ffmpeg, as tests/test_native_decode.py tests the JAX
one. Both build with g++ into ``stcat_tpu_torch/_build/`` under a
source-hashed name; the dataset counts the route that served each clip.
The tests that need a native library skip only where g++ (or, for libjpeg,
/usr/include/jpeglib.h) is absent.
"""

import ctypes
import os
import shutil
import stat

import numpy as np
import pytest

from stcat_tpu.data import jpeg_decode as jjpeg, native_decode as jnative
from test_torch_train import port_cfg
from helpers import tiny_cfg

from stcat_tpu_torch.data import datasets as pds_mod, decode as pdec
from stcat_tpu_torch.data import jpeg_decode, native_decode, synthetic as psyn
from stcat_tpu_torch.kernels import _build

PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + "/stcat_tpu_torch"


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain (g++)")


@pytest.fixture
def libjpeg(gxx):
    if not os.path.exists("/usr/include/jpeglib.h"):
        pytest.skip("no libjpeg headers (/usr/include/jpeglib.h)")


def _jpegs(tmp_path, h, w, n=3):
    from PIL import Image

    paths = []
    for i in range(n):
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        img = np.stack([40 + 3 * xx + i, 200 - yy, 90 + (xx * yy) % 97], -1)
        img = np.clip(img, 0, 255).astype(np.uint8)
        p = str(tmp_path / f"img_{i:05d}.jpg")
        Image.fromarray(img).save(p, quality=90)
        paths.append(p)
    return paths


@pytest.mark.parametrize("h,w", [(37, 53), (240, 320), (1, 7)])
def test_jpeg_batch_decode_matches_jax(tmp_path, libjpeg, h, w):
    """rgb and 4:2:0 decode of the same files, odd sizes included: bitwise
    equal to the JAX package's decoder and the rgb decode to PIL's; the
    library is the hashed one in _build/, next to no source."""
    paths = _jpegs(tmp_path, h, w)
    rgb = jpeg_decode.decode_jpeg_batch(paths, h, w)
    assert rgb is not None and rgb.shape == (3, h, w, 3)
    np.testing.assert_array_equal(rgb, jjpeg.decode_jpeg_batch(paths, h, w))
    np.testing.assert_array_equal(rgb, pdec._pil_rgb(paths))
    y, cbcr = jpeg_decode.decode_jpeg_batch_yuv(paths, h, w)
    jy, jc = jjpeg.decode_jpeg_batch_yuv(paths, h, w)
    assert y.shape == (3, h, w) and cbcr.shape == (3, (h + 1) // 2, (w + 1) // 2, 2)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(cbcr, jc)
    lib = jpeg_decode.LIBRARY.path()
    assert lib.parent == _build.BUILD_DIR and lib.exists()
    assert lib.name.startswith("libjpegpool-") and len(lib.stem) == len("libjpegpool-") + 12
    assert not [f for f in os.listdir(os.path.join(PORT, "native")) if f.endswith(".so")]


def test_jpeg_decode_failures_fall_back_to_pil_and_are_counted(tmp_path, libjpeg):
    """A size other than the files' or an unreadable file: the native
    decoder returns None, load_frame_images decodes through PIL, and the
    routes count native and pil as they were taken."""
    paths = _jpegs(tmp_path, 24, 40)
    assert jpeg_decode.decode_jpeg_batch(paths, 24, 41) is None
    assert jpeg_decode.decode_jpeg_batch_yuv(paths + [str(tmp_path / "absent.jpg")], 24, 40) \
        is None
    routes = pdec.DecodeRoutes()
    root, vid = str(tmp_path.parent), tmp_path.name
    good = pdec.load_frame_images(root, vid, [0, 1, 2], hw=(24, 40), routes=routes)
    bad = pdec.load_frame_images(root, vid, [0, 1, 2], hw=(25, 40), routes=routes)
    y, c = pdec.load_frame_images_yuv(root, vid, [2, 0], hw=(30, 40), routes=routes)
    np.testing.assert_array_equal(good, bad)
    want_y, want_c = pdec.rgb_to_yuv420(good[[2, 0]])
    np.testing.assert_array_equal(y, want_y)
    np.testing.assert_array_equal(c, want_c)
    assert routes.counts() == {"native": 1, "pil": 2, "framepool": 0, "subprocess": 0,
                               "rendered": 0}


def test_dataset_takes_the_native_route(tmp_path, libjpeg):
    """The synthetic dataset over its JPEG corpus decodes every clip, rgb
    and yuv420, through the native decoder; the yuv planes equal the JAX
    dataset's. Without the corpus the frames are rendered, and counted so."""
    from stcat_tpu.config import merge_from_list
    from stcat_tpu.data import synthetic as jsyn

    jcfg = tiny_cfg(["DATA_DIR", str(tmp_path), "INPUT.RESOLUTION", 64,
                     "INPUT.MAX_QUERY_LEN", 12, "TPU.INGEST_LAYOUT", "yuv420"])
    jsyn.write_synthetic_cache(str(tmp_path), "VidSTG", "test", n_items=3, n_frames=10,
                               vary_geometry=True)
    rendered = psyn.SyntheticDataset(port_cfg(jcfg), "test")
    rendered[0]
    assert rendered.decode_routes.counts()["rendered"] == 1
    jsyn.materialize_frame_corpus(str(tmp_path), "VidSTG", "test")
    ds = psyn.SyntheticDataset(port_cfg(jcfg), "test")
    jds = jsyn.SyntheticDataset(jcfg, "test")
    for i in range(3):
        a = ds.__getitem__(i, rng=np.random.default_rng(i))
        b = jds.__getitem__(i, rng=np.random.default_rng(i), raw=True)
        for k in ("frames_y", "frames_cbcr"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    rgb = psyn.SyntheticDataset(port_cfg(merge_from_list(jcfg, ["TPU.INGEST_LAYOUT", "rgb"])),
                                "test")
    for i in range(3):
        rgb[i]
    assert ds.decode_routes.counts()["native"] == rgb.decode_routes.counts()["native"] == 3
    assert ds.decode_routes.counts()["pil"] == rgb.decode_routes.counts()["pil"] == 0


def test_failed_build_is_recorded_and_a_bad_library_raises(tmp_path, gxx, monkeypatch):
    """A g++ build that fails (a library to link that does not exist) makes
    get() return None with the reason recorded, once, without a retry; a
    library file that builds but does not load is an error."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    calls = []
    broken = _build.NativeLibrary("framepool", ["-lno_such_library_here"], calls.append)
    assert broken.get() is None and broken.get() is None
    assert "no_such_library_here" in broken.error and calls == []
    assert not list((tmp_path / "build").glob("*.so"))

    bad = _build.NativeLibrary("framepool", ["-lpthread"], calls.append)
    bad.path().parent.mkdir(parents=True, exist_ok=True)
    bad.path().write_bytes(b"not a shared library")
    with pytest.raises(OSError):
        bad.get()


def test_library_name_follows_the_machines_headers_and_libraries(tmp_path, gxx, monkeypatch):
    """The name hashes the system header the source includes: a library
    built against one header is not found where the header differs, and
    where the header is missing no cached library is loaded; the build
    fails, is recorded, and get() returns None."""
    native, include = tmp_path / "native", tmp_path / "include"
    native.mkdir()
    include.mkdir()
    (native / "probe.cc").write_text(
        '#include <stcat_probe.h>\nextern "C" int probe() { return PROBE; }\n')
    monkeypatch.setattr(_build, "NATIVE", native)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CPATH", str(include))

    def declare(lib):
        lib.probe.restype = ctypes.c_int

    def library(value):
        """The library as a machine whose header defines PROBE as value
        (None: a machine without the header) names it."""
        if value is None:
            (include / "stcat_probe.h").unlink(missing_ok=True)
        else:
            (include / "stcat_probe.h").write_text(f"#define PROBE {value}\n")
        lib = _build.NativeLibrary("probe", ["-lpthread"], declare)
        lib.path()
        return lib

    one = library(1)
    assert one.get().probe() == 1 and one.path().exists()
    two = library(2)
    assert two.path() != one.path() and not two.path().exists()
    assert two.get().probe() == 2 and library(2).path() == two.path()
    missing = library(None)
    assert missing.path() not in (one.path(), two.path())
    assert missing.get() is None and "stcat_probe.h" in missing.error
    assert not missing.path().exists()


def test_framepool_round_trip_and_parallel_jobs(gxx):
    """Shell pipelines in place of ffmpeg: bytes come back as written, 16
    jobs on 4 workers each return their own length, and a pipeline that
    writes nothing raises."""
    assert native_decode.available(), native_decode.LIBRARY.error
    pool = native_decode.FramePool(workers=4)
    try:
        t1 = pool.submit("printf 'abcdef'", 6)
        t2 = pool.submit("head -c 1000 /dev/zero", 1000)
        assert bytes(pool.collect(t1)) == b"abcdef"
        out2 = pool.collect(t2)
        assert out2.size == 1000 and not out2.any()
        tickets = [pool.submit(f"printf '%0{i + 1}d' 7", i + 1) for i in range(16)]
        assert [pool.collect(t).size for t in tickets] == list(range(1, 17))
        with pytest.raises(RuntimeError):
            native_decode.decode_frames_native(pool, "/nonexistent.mp4", [0, 1], 4, 4)
    finally:
        pool.close()
    pool.close()  # a second close is a no-op


def test_ffmpeg_command_matches_jax():
    for path, ids in (("/a b/v.mp4", [3, 1, 1]), ("x.mp4", [0]), ("it's.mp4", [5, 2, 9])):
        assert native_decode.ffmpeg_command(path, ids) == jnative.ffmpeg_command(path, ids)
    cmd = native_decode.ffmpeg_command("/a b/v.mp4", [3, 1, 1])
    assert "'/a b/v.mp4'" in cmd and "eq(n\\,1)+eq(n\\,3)" in cmd and "end_frame=4" in cmd


def test_video_clips_take_the_framepool_then_the_subprocess(tmp_path, gxx, monkeypatch):
    """A video item (no frame directory) with a stand-in ffmpeg on PATH
    that writes a fixed raw clip: the dataset decodes it through the shared
    framepool, and with the pool unavailable through one ffmpeg subprocess;
    the frames are equal and each route is counted."""
    jcfg = tiny_cfg(["DATA_DIR", str(tmp_path / "data"), "INPUT.RESOLUTION", 64,
                     "INPUT.MAX_QUERY_LEN", 12])
    psyn.write_synthetic_cache(str(tmp_path / "data"), "VidSTG", "test", n_items=1,
                               n_frames=6, width=20, height=12)
    ds = pds_mod.VidSTGDataset(port_cfg(jcfg), "test")
    item = dict(ds.items[0], frame_ids=[4, 1, 2])
    clip = np.random.default_rng(0).integers(0, 256, (3, 12, 20, 3), dtype=np.uint8)
    (tmp_path / "clip.raw").write_bytes(clip.tobytes())
    fake = tmp_path / "bin" / "ffmpeg"
    fake.parent.mkdir()
    fake.write_text(f"#!/bin/sh\ncat '{tmp_path / 'clip.raw'}'\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{fake.parent}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(pds_mod.GroundingDataset, "_frame_pool", None)

    pooled = ds.load_frames(item)
    assert isinstance(pds_mod.GroundingDataset._frame_pool, native_decode.FramePool)
    # sorted frame ids 1, 2, 4 came back in that order; the item asks 4, 1, 2
    np.testing.assert_array_equal(pooled, clip[[2, 0, 1]])
    monkeypatch.setattr(pds_mod.GroundingDataset, "_frame_pool", False)
    np.testing.assert_array_equal(ds.load_frames(item), pooled)
    y, c = ds.load_frames_yuv(item)
    np.testing.assert_array_equal(y, pdec.rgb_to_yuv420(pooled)[0])
    assert ds.decode_routes.counts() == {"native": 0, "pil": 0, "framepool": 1,
                                         "subprocess": 2, "rendered": 0}
