"""The port's dataset loader (`aslam_tpu_torch/utils/dataset.py`, `native/`):
the zlib PNG decoder against the native C++ one and against PIL, at 8 and
16 bits and for every PNG filter; the PNG writer; association files; and
`TumSequence` with the native prefetcher, the thread pool and no lookahead.
"""

import os
import struct
import zlib

import numpy as np
import pytest

from aslam_tpu_torch.native import loader as native_loader
from aslam_tpu_torch.utils import dataset as D

PIL_Image = pytest.importorskip("PIL.Image")


def _images():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:96, :128]
    smooth = ((np.sin(xx / 9.0) + np.cos(yy / 7.0)) * 60 + 128).astype(np.uint8)
    return {
        "gray8_smooth": smooth,
        "gray8_noise": rng.integers(0, 256, (96, 128), dtype=np.uint8),
        "gray16_ramp": ((xx * 37 + yy * 91) % 65536).astype(np.uint16),
        "gray16_noise": rng.integers(0, 65536, (33, 17), dtype=np.uint16),
        "rgb8": np.stack([smooth, smooth[::-1], smooth.T[:96, :96].repeat(
            2, 1)[:, :128]], -1),
    }


def _write_with_filter(path, img, ftype):
    """A PNG whose every scanline uses filter `ftype` (an encoder of the
    test's own, by the PNG specification)."""
    if img.dtype == np.uint16:
        rows = img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
        bits, bpp = 16, 2
    else:
        rows = img.reshape(img.shape[0], -1)
        bits, bpp = 8, (1 if img.ndim == 2 else 3)
    rows = rows.astype(np.int32)
    prev = np.zeros_like(rows)
    prev[1:] = rows[:-1]
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    ul = np.zeros_like(rows)
    ul[1:, bpp:] = rows[:-1, :-bpp]
    if ftype == 0:
        pred = 0
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = prev
    elif ftype == 3:
        pred = (left + prev) // 2
    else:
        p = left + prev - ul
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prev, ul))
    filt = ((rows - pred) & 0xFF).astype(np.uint8)
    scan = np.concatenate([np.full((rows.shape[0], 1), ftype, np.uint8), filt],
                          1).tobytes()

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    H, W = img.shape[:2]
    ctype = 2 if img.ndim == 3 else 0
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", W, H, bits, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(scan)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("name", sorted(_images()))
def test_zlib_decoder_equals_native_and_pil(tmp_path, name):
    img = _images()[name]
    path = str(tmp_path / "a.png")
    PIL_Image.fromarray(img).save(path)        # PIL picks filters adaptively
    got = D.decode_png_zlib(path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, np.asarray(PIL_Image.open(path)))
    assert native_loader.available(), native_loader.BUILD_ERROR
    np.testing.assert_array_equal(native_loader.decode_png(path), img)
    np.testing.assert_array_equal(D.decode_png(path), img)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("name", ["gray8_smooth", "gray16_ramp", "rgb8"])
def test_every_png_filter_decodes(tmp_path, name, ftype):
    img = _images()[name]
    path = str(tmp_path / "f.png")
    _write_with_filter(path, img, ftype)
    np.testing.assert_array_equal(np.asarray(PIL_Image.open(path)), img)
    np.testing.assert_array_equal(D.decode_png_zlib(path), img)
    np.testing.assert_array_equal(native_loader.decode_png(path), img)


@pytest.mark.parametrize("name", sorted(_images()))
def test_write_png_is_read_by_every_decoder(tmp_path, name):
    img = _images()[name]
    path = str(tmp_path / "w.png")
    D.write_png(path, img)
    np.testing.assert_array_equal(np.asarray(PIL_Image.open(path)), img)
    np.testing.assert_array_equal(D.decode_png_zlib(path), img)
    np.testing.assert_array_equal(native_loader.decode_png(path), img)


def test_decoder_refuses_what_it_cannot_read(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all")
    with pytest.raises(ValueError, match="not a PNG"):
        D.decode_png_zlib(str(bad))
    pal = str(tmp_path / "p.png")
    PIL_Image.fromarray(_images()["gray8_smooth"]).convert("P").save(pal)
    with pytest.raises(ValueError, match="unsupported PNG"):
        D.decode_png_zlib(pal)
    with pytest.raises(ValueError, match="write_png"):
        D.write_png(str(tmp_path / "x.png"), np.zeros((4, 4), np.float32))


def test_associations_and_associate(tmp_path):
    (tmp_path / "associations.txt").write_text(
        "# comment\n\n1.5 rgb/a.png 1.51 depth/a.png\nshort line\n"
        "2.5 rgb/b.png 2.49 depth/b.png\n")
    a = D.load_associations(str(tmp_path))
    np.testing.assert_array_equal(a.timestamps, [1.5, 2.5])
    assert a.rgb_paths == [os.path.join(str(tmp_path), "rgb/a.png"),
                           os.path.join(str(tmp_path), "rgb/b.png")]
    assert a.depth_paths[1].endswith("depth/b.png")
    rgb = [(0.00, "r0"), (0.10, "r1"), (0.20, "r2"), (0.50, "r3")]
    dep = [(0.005, "d0"), (0.095, "d1"), (0.30, "d2")]
    assert D.associate(rgb, dep) == [(0.00, "r0", "d0"), (0.10, "r1", "d1")]
    from aslam_tpu.utils import dataset as jd

    assert D.associate(rgb, dep, 0.11) == jd.associate(rgb, dep, 0.11)


@pytest.fixture()
def tum_dir(tmp_path):
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (6, 24, 32), dtype=np.uint8)
    deps = rng.integers(0, 40000, (6, 24, 32), dtype=np.uint16)
    ts = [10.0 + 0.033 * i for i in range(6)]
    D.write_tum_sequence(str(tmp_path), imgs, deps, ts)
    return str(tmp_path), imgs, deps, ts


@pytest.mark.parametrize("mode", ["native", "pool", "sync"])
def test_tum_sequence_prefetch_equals_sync(tum_dir, mode, monkeypatch, capsys):
    path, imgs, deps, ts = tum_dir
    if mode == "pool":          # as where the native library cannot be built
        monkeypatch.setattr(native_loader, "_LIB", None)
        monkeypatch.setattr(native_loader, "_LIB_TRIED", True)
        monkeypatch.setattr(native_loader, "BUILD_ERROR", "g++ not found")
    seq = D.TumSequence(path, depth_factor=1 / 5000.0,
                        lookahead=0 if mode == "sync" else 3)
    said = capsys.readouterr().out
    assert "PNG decoder: " + ("zlib (g++ not found)" if mode == "pool"
                              else "native") in said
    assert len(seq) == 6
    assert (seq._native is not None) == (mode == "native")
    assert (seq._pool is not None) == (mode == "pool")
    for i, (t, img, dep) in enumerate(seq):
        assert t == pytest.approx(ts[i], abs=1e-6)
        assert img.dtype == np.float32 and dep.dtype == np.float32
        np.testing.assert_array_equal(img, imgs[i].astype(np.float32))
        np.testing.assert_array_equal(
            dep, deps[i].astype(np.float32) * np.float32(1 / 5000.0))
    t, img, dep = seq[2]                       # random access, backwards
    np.testing.assert_array_equal(img, imgs[2].astype(np.float32))
    seq.close()


def test_rgb_frames_become_gray_as_in_the_reference(tmp_path):
    from aslam_tpu.utils import dataset as jd

    img = _images()["rgb8"]
    path = str(tmp_path / "c.png")
    D.write_png(path, img)
    np.testing.assert_array_equal(D.load_rgb_gray(path), jd.load_rgb_gray(path))
    dpath = str(tmp_path / "d.png")
    D.write_png(dpath, _images()["gray16_ramp"])
    np.testing.assert_array_equal(D.load_depth(dpath), jd.load_depth(dpath))
