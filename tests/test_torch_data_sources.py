"""The port's file data sources against the JAX package on the CPU: its
copy of the pure-Python LMDB reader, the lmdb and folder sources (the
pixels each image index loads, bit for bit), the in-tree PNG decoder
against PIL, and the cubemap projection.

PNGs are written here with a chosen filter type per scanline (0-4 in
turn) for every 8-bit colour type, so each filter of the decoder runs;
PIL's own adaptively filtered PNGs and a JPEG (which only PIL decodes, in
both packages) are mixed in.  Everything is compared exactly."""
import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from helpers.lmdb_writer import write_lmdb  # noqa: E402

from spgan_tpu.config import Config as JConfig  # noqa: E402
from spgan_tpu.data import lmdb_read as jax_lmdb_read  # noqa: E402
from spgan_tpu.data import pano as jax_pano  # noqa: E402
from spgan_tpu.data.pipeline import make_data_source as jax_source  # noqa: E402
from spgan_tpu_torch.config import Config  # noqa: E402
from spgan_tpu_torch.data import lmdb_read, pano  # noqa: E402
from spgan_tpu_torch.data.pipeline import make_data_source  # noqa: E402
from spgan_tpu_torch.utils import png  # noqa: E402

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode(px: np.ndarray, ctype: int, palette=None) -> bytes:
    """An 8-bit PNG of `px` (H, W, channels) whose row r uses filter type
    r % 5; the filters are computed from the known pixels."""
    h, w, ch = px.shape
    rows = px.reshape(h, w * ch).astype(np.int32)
    out = []
    for r in range(h):
        x = rows[r]
        a = np.concatenate([np.zeros(ch, np.int32), x[:-ch]])
        b = rows[r - 1] if r else np.zeros_like(x)
        c = np.concatenate([np.zeros(ch, np.int32), b[:-ch]])
        t = r % 5
        pred = [0, a, b, (a + b) >> 1, _paeth(a, b, c)][t]
        out.append(bytes([t]) + ((x - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if palette is not None:
        body += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    body += chunk(b"IDAT", zlib.compress(b"".join(out)))
    return b"\x89PNG\r\n\x1a\n" + body + chunk(b"IEND", b"")


def _pixels(rng, h, w, ctype):
    """Smooth rows plus noise, so the filters' predictions matter."""
    ch = _CHANNELS[ctype]
    base = np.add.outer(np.arange(h), np.arange(w))[..., None] * 3
    px = (base + rng.randint(0, 40, (h, w, ch))) % 256
    if ctype == 3:
        px = px % 7
    return px.astype(np.uint8)


@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_png_decoder_matches_pil(ctype):
    rng = np.random.RandomState(ctype)
    px = _pixels(rng, 23, 17, ctype)
    palette = rng.randint(0, 256, (7, 3)) if ctype == 3 else None
    data = _encode(px, ctype, palette)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = png.read_png(data)
    assert got.dtype == np.uint8 and got.shape == want.shape == (23, 17, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        png.read_png(data, unfilter_fn=png.unfilter_plain), want)


def test_png_decoder_reads_pil_and_own_pngs(tmp_path):
    """PIL's adaptively filtered RGB/RGBA/L/P files and utils/png.py's own
    writer."""
    rng = np.random.RandomState(0)
    img = _pixels(rng, 40, 64, 6)
    for mode in ("RGB", "RGBA", "L", "P", "LA"):
        buf = io.BytesIO()
        pil = Image.fromarray(img, "RGBA").convert(mode)
        pil.save(buf, format="PNG", optimize=True)
        want = np.asarray(pil.convert("RGB"))
        np.testing.assert_array_equal(png.read_png(buf.getvalue()), want,
                                      err_msg=mode)
    path = str(tmp_path / "own.png")
    png.write_png(path, img[..., :3])
    with open(path, "rb") as f:
        np.testing.assert_array_equal(png.read_png(f.read()), img[..., :3])


def test_unfilter_kernels_agree_and_bad_filter_raises():
    rng = np.random.RandomState(1)
    h, stride, bpp = 9, 4 * 13, 4
    raw = rng.randint(0, 256, (h, stride + 1)).astype(np.uint8)
    raw[:, 0] = np.arange(h) % 5
    np.testing.assert_array_equal(png.unfilter(raw.ravel(), h, stride, bpp),
                                  png.unfilter_plain(raw.ravel(), h, stride,
                                                     bpp))
    raw[4, 0] = 7
    for fn in (png.unfilter, png.unfilter_plain):
        with pytest.raises(ValueError, match="row 4: filter type 7"):
            fn(raw.ravel(), h, stride, bpp)


def _jpeg(rng):
    buf = io.BytesIO()
    Image.fromarray(_pixels(rng, 24, 40, 2)).save(buf, format="JPEG")
    return buf.getvalue()


def test_other_formats_need_pil(monkeypatch):
    """A JPEG or a 16-bit PNG goes through PIL; with PIL absent the
    decoder raises and names it."""
    rng = np.random.RandomState(2)
    jpg = _jpeg(rng)
    buf = io.BytesIO()
    Image.fromarray(_pixels(rng, 8, 8, 0)[..., 0].astype(np.uint16) * 257
                    ).save(buf, format="PNG")
    deep = buf.getvalue()
    for data in (jpg, deep):
        np.testing.assert_array_equal(
            png.decode_image(data),
            np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    monkeypatch.setitem(sys.modules, "PIL", None)
    for data in (jpg, deep):
        with pytest.raises(ImportError, match="PIL"):
            png.decode_image(data)
    px = _pixels(rng, 5, 6, 2)                      # a PNG needs no PIL
    np.testing.assert_array_equal(png.decode_image(_encode(px, 2)), px)


# ----------------------------------------------------------------------
# sources
# ----------------------------------------------------------------------

def _images(n, seed=0):
    """n encoded images: own-filter PNGs of each colour type, a PIL PNG,
    a JPEG, in turn."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        kind = i % 4
        if kind == 0:
            out.append((".png", _encode(_pixels(rng, 30, 48, 2), 2)))
        elif kind == 1:
            out.append((".png", _encode(_pixels(rng, 30, 48, 6), 6)))
        elif kind == 2:
            buf = io.BytesIO()
            Image.fromarray(_pixels(rng, 30, 48, 2)).save(buf, format="PNG")
            out.append((".png", buf.getvalue()))
        else:
            out.append((".jpg", _jpeg(rng)))
    return out


def _configs(**data):
    jcfg, cfg = JConfig(), Config()
    for c in (jcfg, cfg):
        for k, v in data.items():
            setattr(c.data_params, k, v)
    return jcfg, cfg


def _same_pixels(jcfg, cfg, n):
    jn, jload = jax_source(jcfg)
    pn, load = make_data_source(cfg)
    assert pn == jn == n
    for i in range(n + 1):          # the index wraps
        np.testing.assert_array_equal(load(i), jload(i), err_msg=str(i))


def test_folder_source_matches_jax(tmp_path):
    for i, (ext, data) in enumerate(_images(8)):
        (tmp_path / f"img{i:02d}{ext}").write_bytes(data)
    (tmp_path / "notes.txt").write_text("not an image")
    _same_pixels(*_configs(source="folder", folder=str(tmp_path)), 8)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="no images found"):
        make_data_source(_configs(source="folder", folder=str(empty))[1])


def test_lmdb_source_matches_jax_and_its_prefix_rule(tmp_path):
    imgs = _images(6, seed=1)
    one = write_lmdb(str(tmp_path / "one"), {
        **{f"256-{i:08d}".encode(): d for i, (_, d) in enumerate(imgs)},
        b"length": b"6"})
    _same_pixels(*_configs(source="lmdb", folder=one), 6)
    multi = write_lmdb(str(tmp_path / "multi"), {
        **{f"256-{i:08d}".encode(): d for i, (_, d) in enumerate(imgs)},
        **{f"128-{i:08d}".encode(): d for i, (_, d) in enumerate(imgs[:3])}})
    _same_pixels(*_configs(source="lmdb", folder=multi,
                           lmdb_key_prefix="128"), 3)
    for prefix, match in ((None, "multiple resolutions"),
                          ("512", "not in LMDB")):
        jcfg, cfg = _configs(source="lmdb", folder=multi,
                             lmdb_key_prefix=prefix)
        with pytest.raises(ValueError, match=match):
            make_data_source(cfg)
        with pytest.raises(ValueError, match=match):
            jax_source(jcfg)


def test_lmdb_reader_matches_jax(tmp_path):
    """A multi-page tree with overflow values, read through both parsers:
    the same sorted pairs, keys-only walk and point lookups."""
    rng = np.random.RandomState(3)
    items = {f"k{i:05d}".encode(): rng.bytes(int(rng.choice([5, 900, 9000])))
             for i in range(300)}
    d = write_lmdb(str(tmp_path / "db"), items)
    env, jenv = lmdb_read.open(d), jax_lmdb_read.open(d)
    with env.begin() as txn, jenv.begin() as jtxn:
        pairs = list(txn.cursor())
        assert pairs == list(jtxn.cursor()) == sorted(items.items())
        assert list(txn.cursor().iternext(values=False)) == sorted(items)
        for k in (b"k00000", b"k00150", b"k00299", b"missing"):
            assert txn.get(k) == jtxn.get(k) == items.get(k)
    assert env.stat() == jenv.stat()
    with pytest.raises(lmdb_read.LmdbFormatError):
        env.begin(write=True)
    env.close()
    jenv.close()


@pytest.mark.parametrize("bilinear", [True, False])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_cubemap_to_equirect_matches_jax(bilinear, dtype):
    rng = np.random.RandomState(4)
    faces = {k: (rng.rand(16, 16, 3) * 255).astype(dtype)
             for k in pano.FACES}
    assert pano.FACES == jax_pano.FACES
    got = pano.cubemap_to_equirect(faces, 64, 32, bilinear=bilinear)
    want = jax_pano.cubemap_to_equirect(faces, 64, 32, bilinear=bilinear)
    assert got.dtype == want.dtype and got.shape == want.shape == (21, 64, 3)
    np.testing.assert_array_equal(got, want)
